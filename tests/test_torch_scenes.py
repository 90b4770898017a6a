"""The port's scene drivers (``raytrace_tpu_torch/scenes/``) against the
JAX package's (``scenes/*.py``, imported from ``scenes/`` unchanged) on
the CPU.

* The compiled tables of the 11 drivers that need no reference asset
  equal JAX's ``build``'s row for row, through ``interop.scene_to_numpy``
  (every array exact, every static equal): demo1's 512 rows and 460
  materials included; and the settings field for field (the background
  evaluated on the same directions).  ``engine_report`` names kernel A
  for cornell_box, quad_test, metal_test, readme_example,
  lommel_seeliger_test and demo1 (its 512 rows: kernel A's ceiling), and
  for sphere_uv_test's one pixel (a one-lane work queue, not a multiple
  of 128 lanes) the generic bounce over K8.
* A 16-pixel-wide, 4 spp, depth-4 ``render_accumulate`` of each of the
  seven new scenes at its seed against JAX's, with the bound of
  ``tests/test_torch_render.py``: the median pixel equal within 1e-6,
  the share of pixels more than 1e-5 apart below 5% (XLA's CPU backend
  contracts multiply-adds, so a grazing or edge hit can resolve
  otherwise and move its pixel), and the image mean within rtol 2e-3.
  demo1 (460 small spheres of glass, fuzzy metal and lambertian, and
  defocus) takes ``tests/test_torch_demo2.py``'s per-pixel bound: under
  10% of the pixels more than 1e-4 relative apart.  Its long chains of
  refractions and fuzzy reflections leave many pixels 1e-5 apart by
  rounding alone (measured: 7-12% of the pixels past 1e-5 absolute but
  2.1-4.2% past 1e-4 relative, at 16 and 32 px, 1 and 4 spp, seeds 1234
  and 0); its median and mean bounds are the others'.
* ``scene_main`` renders a scene with ``--cpu`` and writes its PNG;
  without ``--cpu`` and without a CUDA device it raises.  bunny_test and
  pawn_test raise ``FileNotFoundError`` without the reference's .obj,
  as JAX's do.  ``--no-redirect`` drops cornell_box's redirect target.
"""
import importlib
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.interop import fields_to_numpy, scene_to_numpy
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.testing import torch_threads
from raytrace_tpu_torch.utils.engines import engine_report

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
NO_ASSET = ["cornell_box", "cornell_smoke", "cuboid_test", "demo1", "demo2",
            "lommel_seeliger_test", "metal_test", "noise_test", "quad_test",
            "readme_example", "sphere_uv_test"]
NEW = ["cornell_box", "quad_test", "metal_test", "readme_example",
       "lommel_seeliger_test", "sphere_uv_test", "demo1"]
# (width, spp, depth) of the table and render comparisons
SMALL = (16, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _args(width, spp, depth, **kw):
    return types.SimpleNamespace(width=width, spp=spp, depth=depth, **kw)


def jax_build(name, args):
    sys.path.insert(0, SCENES)
    try:
        return importlib.import_module(name).build(args)
    finally:
        sys.path.remove(SCENES)


def port_module(name):
    return importlib.import_module(f"raytrace_tpu_torch.scenes.{name}")


@pytest.fixture(scope="module")
def built():
    """``{name: (jax scene, jax settings, jax seed, port scene, port
    settings, port seed)}`` at :data:`SMALL`."""
    return {name: (jax_build(name, _args(*SMALL))
                   + port_module(name).build(_args(*SMALL, device="cpu")))
            for name in NO_ASSET}


def _assert_same(a, b, path):
    if hasattr(a, "shape") or hasattr(b, "shape"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("name", NO_ASSET)
def test_tables_equal_jax(built, name):
    js, _, jseed, ts, _, tseed = built[name]
    assert jseed == tseed
    assert ts.device == torch.device("cpu")
    _assert_same(scene_to_numpy(ts), scene_to_numpy(js), name)
    if name == "demo1":
        assert ts.prims.kind.shape[0] == 512
        assert ts.materials.kind.shape[0] == 460


@pytest.mark.parametrize("name", NO_ASSET)
def test_settings_equal_jax(built, name):
    _, jset, _, _, tset, _ = built[name]
    a, b = fields_to_numpy(tset), fields_to_numpy(jset)
    assert a.keys() == b.keys()
    for k in a:
        if k == "background":
            d = np.random.default_rng(0).normal(size=(64, 3)).astype(
                np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            o = np.zeros_like(d)
            np.testing.assert_allclose(
                a[k](torch.from_numpy(o), torch.from_numpy(d)).numpy(),
                np.asarray(b[k](jnp.asarray(o), jnp.asarray(d))),
                rtol=1e-6, err_msg=name)
        else:
            _assert_same(a[k], b[k], f"{name}.{k}")


# the stationary scenes fuse their iteration (kernel B, in its rotated
# mode at their sample counts)
ROUTES = {"sphere_uv_test": ("queue", "generic", "K8")}


@pytest.mark.parametrize("name", NEW)
def test_engine_report_at_reference_size(name):
    """Each new scene's route at its driver's own defaults (on the CPU the
    report names the kernels the card launches)."""
    mod = port_module(name)
    scene, s, _ = mod.build(_args(*mod.DEFAULTS, device="cpu"))
    rep = engine_report(scene, s)
    want = ROUTES.get(name, ("stationary", "kernel-B", "in-kernel"))
    assert (rep["driver"], rep["forward"], rep["intersect"]) == want, rep
    assert rep["volumes"] is None


@pytest.mark.parametrize("name", NEW)
def test_render_matches_jax(built, name):
    js, jset, seed, ts, tset, _ = built[name]
    spp = SMALL[1]
    jacc, jn = jrender(js, jset, seed, spp=spp)
    tacc, tn = trender(ts, tset, seed, spp=spp)
    assert tn == jn == spp
    a, b = np.asarray(jacc) / spp, tacc.numpy() / spp
    assert b.shape == a.shape and np.isfinite(b).all()
    assert (a > 0).any()
    diff = np.abs(a - b).max(axis=1)
    if name == "demo1":
        off = (np.abs(a - b) > 1e-4 * (1.0 + np.abs(a))).any(1)
        assert off.mean() < 0.10, off.mean()
    else:
        assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_scene_main_writes_png(tmp_path, capsys):
    from PIL import Image
    out = str(tmp_path / "quad.png")
    img = port_module("quad_test").main(
        ["--cpu", "--width", "16", "--spp", "2", "--depth", "3", "--out",
         out])
    assert tuple(img.shape) == (16, 16, 3) and torch.isfinite(img).all()
    assert Image.open(out).size == (16, 16)
    text = capsys.readouterr().out
    assert "quad_test: " in text and "M primary rays/s" in text


def test_scene_main_needs_cuda_without_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_module("quad_test").main(["--width", "8", "--out",
                                       str(tmp_path / "x.png")])


def test_cornell_no_redirect():
    mod = port_module("cornell_box")
    _, s, _ = mod.build(_args(*SMALL, device="cpu"))
    _, s2, _ = mod.build(_args(*SMALL, device="cpu", no_redirect=True))
    assert s.n_redirect == 1 and s2.n_redirect == 0


@pytest.mark.parametrize("name", ["bunny_test", "pawn_test"])
def test_mesh_scenes_need_reference_obj(monkeypatch, name):
    monkeypatch.delenv("RT_REFERENCE", raising=False)
    with pytest.raises(FileNotFoundError):
        port_module(name).build(_args(*SMALL, device="cpu"))
    sys.path.insert(0, SCENES)
    try:
        ref_images = importlib.import_module("_assets").REF_IMAGES
    finally:
        sys.path.remove(SCENES)
    if not os.path.exists(os.path.join(ref_images,
                                       name.split("_")[0] + ".obj")):
        with pytest.raises(FileNotFoundError):
            jax_build(name, _args(*SMALL))
