"""The ray-sorted work-queue driver (``render/integrator.py:
trace_wavefront_sorted``) and the routing to it, on the CPU.

The scene: a ground and a metal sphere under the sky, with a red fog
bounded by a lat-long sphere mesh of 80 triangles (a mesh-scale medium
boundary: kernel K11b's table) around a glass ball.

* The sorted driver traces the same (pixel, sample) paths as the
  pixel-stationary one, so the two images differ only by the order of
  float adds: per pixel within rtol 1e-5 + atol 1e-6 (32 x 32, 4 spp,
  depth 8); a band of pixels at an offset equals the same pixels of the
  whole image.
* Against the JAX package's ``trace_wavefront_sorted`` on the same scene
  (JAX's XLA bounce on the CPU): the bounds of ``tests/test_torch_render.py``
  (mean within rtol 2e-3, median pixel to f32 rounding, under 5% of
  pixels off by more than 1e-5: XLA contracts multiply-adds, and its
  crossing scan may flag a tie between one row's exit and a later row's
  entry differently).
* Routing (JAX ``render.py:_stationary_fn``): a stationary render takes
  the sorted driver for media with 64 boundary rows and more or a surface
  table of 8,192 rows and more, the stationary driver otherwise; a
  table of 8,192 rows renders instead of raising.
"""
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render.integrator import (
    trace_wavefront_sorted as jsorted,
)
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from raytrace_tpu_torch.render import render as trender_mod
from raytrace_tpu_torch.render.integrator import (
    trace_wavefront_sorted, trace_wavefront_stationary,
)
from raytrace_tpu_torch.render.render import uses_sorted
from raytrace_tpu_torch.testing import (
    cornell_smoke_scene, pawn_standin_scene, torch_threads, uv_sphere,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def fog_mesh_world(rt):
    v, f = uv_sphere(6, 8)
    mesh = rt.Mesh(vertices=1.2 * v + np.asarray([0.0, 0.2, 0.0]),
                   uv=np.zeros((0, 2)), faces=f, uv_faces=np.full_like(f, -1))
    return rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture([0.6, 0.6, 0.5])),
                         rt.parallelogram([-6, -1, -6], [12, 0, 0],
                                          [0, 0, 12])),
        rt.with_material(rt.metal(0.1, rt.constant_texture([0.8, 0.7, 0.6])),
                         rt.sphere([2.2, 0.0, -0.5], 1.0)),
        rt.with_material(rt.dielectric(1.5), rt.sphere([0.0, 0.2, 0.0],
                                                       0.5)),
        rt.with_material(rt.isotropic(rt.constant_texture([0.9, 0.2, 0.2])),
                         rt.constant_medium(1.5, rt.triangle_mesh(mesh))),
    ])


def _settings(rt, width=32):
    return rt.CameraSettings(center=np.asarray([0.0, 1.0, 5.0]),
                             look_at=np.asarray([0.0, 0.0, 0.0]),
                             image_width=width, max_depth=8,
                             background=rt.sky)


@pytest.fixture(scope="module")
def fog():
    ts = trt.compile_scene(fog_mesh_world(trt), device="cpu")
    assert ts.volumes.prims.kind.shape[0] == 80 and uses_sorted(ts)
    return ts, _settings(trt)


def test_sorted_matches_stationary(fog):
    ts, s = fog
    key = rng.base_key(3)
    n_pix = 32 * 32
    a = trace_wavefront_stationary(ts, s, key, n_pix, 4)
    b = trace_wavefront_sorted(ts, s, key, n_pix, 4)
    assert torch.isfinite(b).all() and float(b.mean()) > 0.0
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    # a band of rows at an offset: the same pixels
    half = trace_wavefront_sorted(ts, s, key, n_pix // 2, 4,
                                  pixel_offset=n_pix // 2)
    torch.testing.assert_close(half, a[n_pix // 2:], rtol=1e-5, atol=1e-6)


def test_sorted_matches_jax_sorted(fog):
    js = jrt.compile_scene(fog_mesh_world(jrt))
    jset = _settings(jrt)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    _, s = fog
    n_pix = 32 * 32
    a = np.asarray(jsorted(js, jset, jrng.base_key(3), n_pix, 4)) / 4
    b = trace_wavefront_sorted(ts, s, rng.base_key(3), n_pix, 4).numpy() / 4
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_routing_to_the_sorted_driver(fog, monkeypatch):
    ts, s = fog
    smoke, _ = cornell_smoke_scene(16, 1, 4, device="cpu")
    pawn, _ = pawn_standin_scene(16, 1, 4, device="cpu")
    assert uses_sorted(pawn) and not uses_sorted(smoke)
    calls = []
    for name in ("trace_wavefront_sorted", "trace_wavefront_stationary"):
        def spy(scene, settings, key, n_pix, spp, _name=name, **kw):
            calls.append(_name)
            return torch.zeros((n_pix, 3))
        monkeypatch.setattr(trender_mod, name, spy)
    big = s.replace(image_width=128)
    trender_mod.render_accumulate(ts, big, 0, spp=1)
    trender_mod.render_accumulate(smoke, big, 0, spp=1)
    assert calls == ["trace_wavefront_sorted", "trace_wavefront_stationary"]


def test_table_of_8192_rows_renders():
    v, f = uv_sphere(47, 90)
    ts = trt.compile_scene(trt.with_material(
        trt.lambertian(trt.constant_texture([0.6, 0.6, 0.6])),
        trt.triangle_mesh(trt.Mesh(1.5 * v, np.zeros((0, 2)), f,
                                   np.full_like(f, -1)))), device="cpu")
    assert ts.prims.kind.shape[0] >= 8192 and uses_sorted(ts)
    s = trt.CameraSettings(center=[0.0, 1.0, 4.0], look_at=[0.0, 0.0, 0.0],
                           image_width=16, max_depth=2, background=trt.sky)
    acc = trace_wavefront_sorted(ts, s, rng.base_key(0), 256, 1)
    assert acc.shape == (256, 3) and torch.isfinite(acc).all()
    assert float(acc.mean()) > 0.0
