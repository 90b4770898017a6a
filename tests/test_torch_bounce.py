"""Kernel A's plain version against the JAX bounce megakernel.

``bounce_plain`` (through ``bounce_mega_soa``, the driver-level call that
adds the background on a miss) and the JAX package's
``bounce_megakernel(..., interpret=True)`` take the same 512 rays,
throughputs, alive flags and uniforms, made with numpy from a seed, on the
same scene (carried over with ``interop.scene_from_numpy``).  Tolerances
are tests/test_bounce_kernel.py's: alive and died equal on every lane,
floats within atol 2e-3 + rtol 1e-3.  The winner index must agree on 99%
of lanes: a ray that meets a shared edge of two rows (the Cornell box's
walls and box faces) can pick either, since XLA contracts the plane test
into fused multiply-adds (1 of 512 lanes here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu_torch.testing import ALL_MATERIAL_TARGETS
from raytrace_tpu.render import integrator as jint
from raytrace_tpu_torch.interop import (
    scene_from_numpy, scene_to_numpy, settings_from_numpy,
)
from raytrace_tpu_torch.ops.bounce_kernel import bounce_megakernel
from raytrace_tpu_torch.render import integrator as tint
from test_bounce_kernel import _scene_all_materials


def _motion_scene():
    m = jrt.lambertian(jrt.constant_texture(0.5))
    return jrt.compile_scene(jrt.group([
        jrt.moving([0, 0, 0], [3, 0, 0],
                   jrt.with_material(m, jrt.sphere([0, 0, -5], 1.0))),
        jrt.with_material(m, jrt.parallelogram([-9, -3, -9], [18, 0, 0],
                                               [0, 0, 18])),
    ]), accel="dense")


def _cases():
    bg = jrt.const_background([0.5, 0.6, 0.7])
    s = jrt.CameraSettings(background=bg)
    return {
        "all_materials": (_scene_all_materials, s, ("const", (0.5, 0.6, 0.7)),
                          (-8.0, 8.0), 0),
        "all_materials_targets": (
            _scene_all_materials,
            jrt.CameraSettings(background=jrt.const_background(0.2))
            .with_redirect_targets(ALL_MATERIAL_TARGETS),
            ("const", (0.2, 0.2, 0.2)), (-8.0, 8.0), 3),
        "motion": (_motion_scene, jrt.CameraSettings(
            background=jrt.const_background(1.0)), ("const", (1.0,) * 3),
            (-8.0, 8.0), 5),
        "cornell": (lambda: _cornell_scene_and_settings(64, 8, 10)[0],
                    _cornell_scene_and_settings(64, 8, 10)[1],
                    ("const", (0.0,) * 3), (0.0, 555.0), 7),
    }


def _settings_np(s, bg):
    from raytrace_tpu_torch.interop import fields_to_numpy
    d = fields_to_numpy(s)
    d["background"] = bg
    return settings_from_numpy(d)


@pytest.mark.parametrize("case", ["all_materials", "all_materials_targets",
                                  "motion", "cornell"])
def test_bounce_plain_matches_jax_kernel(case):
    build, js_set, bg, box, seed = _cases()[case]
    js = build()
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    ts_set = _settings_np(js_set, bg)
    n = 512
    rg = np.random.default_rng(seed)
    o = rg.uniform(box[0], box[1], (3, n)).astype(np.float32)
    d = rg.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tm = rg.uniform(0, 1, n).astype(np.float32)
    thr = rg.uniform(0.2, 1.0, (3, n)).astype(np.float32)
    alive = rg.uniform(0, 1, n) < 0.9
    uni = rg.integers(0, 1 << 16, (8, n)).astype(np.float32) / (1 << 16)
    comps = np.concatenate([o, d, tm[None]])

    jout = jint.bounce_mega_soa(
        js, js_set, tuple(jnp.asarray(c) for c in comps),
        jnp.asarray(uni.T), tuple(jnp.zeros(n) for _ in range(3)),
        tuple(jnp.asarray(t) for t in thr), jnp.asarray(alive),
        interpret=True, with_idx=True)
    a0 = bounce_megakernel.launches
    tout = tint.bounce_mega_soa(
        ts, ts_set, torch.from_numpy(comps), torch.from_numpy(uni),
        torch.zeros(3, n), torch.from_numpy(thr), torch.from_numpy(alive),
        with_idx=True)
    assert bounce_megakernel.launches == a0   # CPU tensors: plain version

    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    assert (tout[5].numpy() == np.asarray(jout[5])).mean() >= 0.99
    for k, name in ((0, "comps"), (1, "radiance"), (2, "throughput")):
        ref = np.stack([np.asarray(x) for x in jout[k]])
        np.testing.assert_allclose(tout[k].numpy(), ref, atol=2e-3,
                                   rtol=1e-3, err_msg=name)


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card raises: no
    silent fallback."""
    m = torch.empty(128, device="meta")
    t = torch.zeros((18, 36))
    with pytest.raises(ValueError, match="unsupported device"):
        bounce_megakernel(t, torch.zeros((2, 12)), torch.zeros((1, 16)),
                          *([m] * 11), torch.empty((8, 128), device="meta"),
                          n_prims=18, n_mats=2, n_targets=0, t_min=1e-3,
                          has_motion=False)
