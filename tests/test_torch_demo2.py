"""demo2, the reference's "everything at once" scene
(``scenes/demo2.py``, reference ``test/Main.hs:259-321``), in the port
against the JAX package on the CPU.

``testing.demo2_scene`` rebuilds the world with the port's builder, its
random draws made in the same order from ``np.random.default_rng(1234)``
and the earth from ``scenes/_assets.py``'s procedural fallback.

* Its tables equal those of JAX's ``scenes/demo2.py:build`` row for row:
  the 1,536 kind-segmented primitive rows (1,006 spheres, 400 boxes, the
  light) with their statics, ``sphere_rots`` (the earth's one row: the
  1,000-sphere constant cloud is pruned), the two media's boundary rows,
  densities and materials, and the material and texture tables, image
  atlas included; ``interop`` carries JAX's scene to the same tables.
* ``integrator.trace`` (the split path: K9's BVH walk over the 1,536
  rows, K11's candidate mode for the two media, the shade kernel, the
  earth's image and the marble stripes multiplied in; plain versions on
  the CPU) on 256 camera rays at depth 4 against JAX's ``trace``: the
  radiance within 1e-4 relative on all but 5% of the rays, light on more
  than 10% of them.  About 2% of demo2's paths resolve a hit differently
  (measured on 4,096 paths, against 0.4% of the Cornell box's): XLA's CPU
  backend contracts multiply-adds, and glass, a fuzzy metal and 1,006
  spheres turn an ulp into another path.
* ``render_accumulate`` at 16 x 16, 2 spp, seed 1234 (the work-queue
  driver) against JAX's: the median pixel equal within 1e-6, under 10% of
  the pixels more than 1e-4 relative apart and the image mean within 5%
  relative: a pixel whose path diverges moves by up to 2.4, and 512 paths
  average little of it away (measured on seeds 1234 and 0-3: 3.1-5.5% of
  the pixels past the relative bound, mean differences of 0.07-3.0%).
* ``trace(differentiable=True)`` on 64 rays aimed at the earth and at the
  blue subsurface sphere, depth 4, against ``jax.value_and_grad`` of the
  same mean radiance with respect to the media's densities and the image
  atlas: the loss within 1e-4 relative, each gradient within 1e-3 of
  JAX's in the L2 norm, the fog's and the earth's texels' non-zero.  The
  blue medium's is zero in both: at depth 4 no path that scatters in it
  (mean free path 5 inside a glass sphere of radius 70) reaches the light.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render.camera import camera_frame as jframe
from raytrace_tpu.render.camera import generate_rays as jgen
from raytrace_tpu.render.integrator import trace as jtrace
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import combine, partition
from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.render.camera import camera_frame, generate_rays
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.testing import (
    DEMO2_SEED, demo2_scene, torch_threads,
)

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
PRIM_FIELDS = ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1")
PRIM_STATICS = ("n", "has_motion", "has_box", "kind_segments",
                "kinds_present", "sphere_rots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def pair():
    """``(jax scene, jax settings, port scene, port settings)`` of demo2 at
    16 x 16, 2 spp, depth 4."""
    sys.path.insert(0, SCENES)
    try:
        import demo2
        js, jset, seed = demo2.build(types.SimpleNamespace(width=16, spp=2,
                                                           depth=4))
    finally:
        sys.path.remove(SCENES)
    assert seed == DEMO2_SEED
    ts, tset = demo2_scene(16, 2, 4, device="cpu")
    return js, jset, ts, tset


def _assert_prims_equal(tp, jp):
    for f in PRIM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in PRIM_STATICS:
        assert getattr(tp, f) == getattr(jp, f), f


def _assert_tables_equal(ts, js):
    _assert_prims_equal(ts.prims, js.prims)
    tv, jv = ts.volumes, js.volumes
    assert (tv.starts, tv.counts) == (jv.starts, jv.counts) == ((0, 1),
                                                               (1, 1))
    np.testing.assert_array_equal(tv.density.numpy(), np.asarray(jv.density))
    np.testing.assert_array_equal(tv.mat.numpy(), np.asarray(jv.mat))
    _assert_prims_equal(tv.prims, jv.prims)
    for f in ("kind", "tex", "param"):
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)),
                                      err_msg=f)
    for f in ("kind", "c0", "c1", "v0", "v1", "f0", "f1", "i0", "images",
              "image_hw"):
        np.testing.assert_array_equal(getattr(ts.textures, f).numpy(),
                                      np.asarray(getattr(js.textures, f)),
                                      err_msg=f)
    assert ts.ellipsoids is None and js.ellipsoids is None


def test_demo2_tables_equal_jax(pair):
    js, jset, ts, tset = pair
    assert ts.prims.kind.shape[0] == 1536 and ts.prims.n == 1407
    assert ts.materials.kind.shape[0] == 11
    assert [r for r, _ in ts.prims.sphere_rots] == [713]
    assert int(ts.prims.kind[713]) == 0
    _assert_tables_equal(ts, js)
    _assert_tables_equal(scene_from_numpy(scene_to_numpy(js), device="cpu"),
                         js)
    assert integrator.uses_bvh(ts.prims)
    assert integrator._bounce_step(ts, tset, 256)[0] is \
        integrator.bounce_split_soa
    assert tset.n_redirect == 1


def _rays(js, jset, ts, tset, n, seed):
    rg = np.random.default_rng(seed)
    pix = rg.integers(0, 256, n).astype(np.int32)
    smp = rg.integers(0, 4, n).astype(np.int32)
    jk = jrng.ray_keys_fast(jrng.base_key(seed), jnp.asarray(pix),
                            jnp.asarray(smp))
    tk = rng.ray_keys_fast(rng.base_key(seed), torch.from_numpy(pix),
                           torch.from_numpy(smp))
    jr = jgen(jset, jframe(jset), jnp.asarray(pix), jk)
    tr = generate_rays(tset, camera_frame(tset), torch.from_numpy(pix), tk)
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    return jr, jrng.site(jk, 7), tr, rng.site(tk, 7)


def test_demo2_trace_matches_jax(pair):
    js, jset, ts, tset = pair
    (jo, jd, jt), jk, (o, d, t), tk = _rays(js, jset, ts, tset, 256, 1)
    a = np.asarray(jtrace(js, jset, jo, jd, jt, jk))
    b = integrator.trace(ts, tset, o, d, t, tk).numpy()
    assert np.all(np.isfinite(b))
    off = (np.abs(a - b) > 1e-4 * (1.0 + np.abs(a))).any(1)
    assert off.mean() <= 0.05, off.mean()
    assert (a > 0).any(1).mean() > 0.1


def test_demo2_render_matches_jax(pair):
    js, jset, ts, tset = pair
    jacc, jn = jrender(js, jset, DEMO2_SEED, spp=2)
    tacc, tn = trender(ts, tset, DEMO2_SEED, spp=2)
    assert tn == jn == 2
    a, b = np.asarray(jacc) / 2, tacc.numpy() / 2
    assert b.shape == a.shape == (256, 3) and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    off = (np.abs(a - b) > 1e-4 * (1.0 + np.abs(a))).any(1)
    assert off.mean() < 0.10, off.mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=0.05)


def test_demo2_differentiable_trace_gradients_match_jax(pair):
    js, jset, ts, tset = pair
    n = 64
    rg = np.random.default_rng(0)
    cam = np.asarray([478.0, 278.0, -600.0])
    tgt = np.where((np.arange(n) % 2 == 0)[:, None], [400, 200, 400],
                   [360, 150, 145]) + rg.normal(0, 40, (n, 3))
    o = np.tile(cam, (n, 1)).astype(np.float32)
    d = tgt - cam
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = rg.uniform(0, 1, n).astype(np.float32)
    pix = np.arange(n, dtype=np.int32)
    jk = jrng.ray_keys_fast(jrng.base_key(4), jnp.asarray(pix),
                            jnp.zeros(n, jnp.int32))
    tk = rng.ray_keys_fast(rng.base_key(4), torch.from_numpy(pix),
                           torch.zeros(n, dtype=torch.int32))

    def jloss(dens, images):
        sc = js.replace(volumes=js.volumes.replace(density=dens),
                        textures=js.textures.replace(images=images))
        return jnp.mean(jtrace(sc, jset, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tm), jk, differentiable=True))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1))(js.volumes.density,
                                                       js.textures.images)
    params, statics = partition(ts)
    loss = integrator.trace(combine(params, statics), tset,
                            torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tm), tk,
                            differentiable=True).mean()
    tg = torch.autograd.grad(loss, [params.volumes.density,
                                    params.textures.images])
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    for a, b in zip(jg, tg):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all()
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a)
    dens, img = (np.asarray(x) for x in jg)
    assert dens[0] != 0 and dens[1] == 0 and np.count_nonzero(img) > 0
