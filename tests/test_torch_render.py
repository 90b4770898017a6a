"""The port's render path against the JAX package's, end to end, on CPU.

``render_accumulate`` of both packages renders the Cornell box (the
port's copy carried over from the JAX scene with ``interop``) at seed 1,
depth 10:

* 128 x 128 at 8 spp: the stationary driver with rotate_k 8, the port's
  fused branch in kernel B's rotated mode (JAX runs its XLA bounce on
  CPU);
* 128 x 128 at 1 spp: rotate_k 1, the port's fused branch (kernel B);
* 130 x 130 at 8 spp: rotate_k 8 on 16900 pixels, so 124 of the 17024
  lanes are padding whose rotated pixel maps clamp to the last pixel, as
  the 600 x 600 render's 64 padding lanes do;
* 32 x 32 at 8 spp: the work-queue driver.

Checks: the image mean within rtol 2e-3; the median pixel equal to f32
rounding; and the share of pixels that differ by more than 1e-5 below
2% at 1 spp.  At 8 spp the bound is 5%: every path of a pixel is a chance
to differ, and ~0.5% of paths resolve a grazing or edge hit differently
because XLA's CPU backend contracts multiply-adds (measured 3.3% of
pixels at 128 px, 3.4% at 32 px; 0.6% at 1 spp).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.interop import (
    fields_to_numpy, scene_from_numpy, scene_to_numpy, settings_from_numpy,
)
from raytrace_tpu_torch.ops.bounce_kernel import bounce_megakernel
from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
from raytrace_tpu_torch.render.render import render_accumulate as trender

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("width,spp,frac_bound", [
    (128, 8, 0.05), (128, 1, 0.02), (130, 8, 0.05), (32, 8, 0.05)])
def test_render_matches_jax(width, spp, frac_bound):
    js, jset = _cornell_scene_and_settings(width, spp, 10)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    tset = settings_from_numpy(d)

    jacc, jn = jrender(js, jset, 1, spp=spp)
    tacc, tn = trender(ts, tset, 1, spp=spp)
    assert tn == jn == spp
    a = np.asarray(jacc) / spp
    b = tacc.numpy() / spp
    assert b.shape == a.shape == (width * width, 3)
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < frac_bound, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_dispatch_mirrors_jax_driver(monkeypatch):
    """rotate_k 1 and 2 both take the fused branch (kernel B's wrapper,
    in its rotated mode at 2), where the JAX driver takes kernel A when
    it rotates; with the fused branch refused the body calls kernel A's
    wrapper.  On CPU tensors the wrappers run the plain versions and
    launch nothing."""
    from raytrace_tpu_torch.render import integrator
    from raytrace_tpu_torch.render.render import rotate_k_for
    assert rotate_k_for(200) == 8 and rotate_k_for(8) == 8
    assert rotate_k_for(1) == 1 and rotate_k_for(11) == 1
    js, jset = _cornell_scene_and_settings(16, 2, 3)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    tset = settings_from_numpy(d)
    calls = []
    for name in ("bounce_megakernel", "fused_iter_fwd_step"):
        real = getattr(integrator, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(integrator, name, spy)
    a0, b0 = bounce_megakernel.launches, iter_megakernel.launches
    key = torch.tensor([0, 1], dtype=torch.int32)
    integrator.trace_wavefront_stationary(ts, tset, key, 256, 2, rotate_k=2)
    assert calls == ["fused_iter_fwd_step"]
    calls.clear()
    integrator.trace_wavefront_stationary(ts, tset, key, 256, 2, rotate_k=1)
    assert calls == ["fused_iter_fwd_step"]
    calls.clear()
    monkeypatch.setattr(integrator, "stationary_fused", lambda *a: False)
    integrator.trace_wavefront_stationary(ts, tset, key, 256, 2, rotate_k=2)
    assert set(calls) == {"bounce_megakernel"}
    assert (bounce_megakernel.launches, iter_megakernel.launches) == (a0, b0)


def test_port_imports_no_jax():
    """``import raytrace_tpu_torch`` pulls in neither JAX nor the JAX
    package, and no module of the port names the JAX package."""
    code = ("import sys, raytrace_tpu_torch, raytrace_tpu_torch.interop, "
            "raytrace_tpu_torch.testing, "
            "raytrace_tpu_torch.render.integrator; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'raytrace_tpu.')) or m == 'raytrace_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    pkg = os.path.join(ROOT, "raytrace_tpu_torch")
    banned = re.compile(r"\b(jax|raytrace_tpu)\b(?!_torch)")
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        assert not banned.search(s), (f, s)
