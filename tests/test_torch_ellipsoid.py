"""Ellipsoids (spheres under arbitrary affines) in the port, against the
JAX package on the CPU.

* Where an ellipsoid wins the differentiable surface hit, the primitive
  rows get no gradient; where the ray passes it, they do.
* The JAX package's five tests of ``tests/test_ellipsoid.py`` on the
  port: the compiler keeps a non-uniformly scaled sphere as an ellipsoid
  (its forward map diag(2, 1, 0.5)); hits lie on the implicit surface
  (|A^-1 (p - b)| = r within 1e-4), carry ``idx <= -2`` and the normal
  ``normalize(A n_obj)`` within 1e-4; an ellipsoid in front of a quad
  wins the nearest hit and an oblique ray past it hits the quad (t 4.5
  within 1e-3); ``trace(differentiable=True)`` gives a finite radius
  gradient, and d(mean hit t)/d(radius) through the differentiable
  surface hit matches a central difference (rtol 0.02, atol 1e-4); a
  non-uniformly scaled sphere as a medium boundary raises ``ValueError``.
* ``ops/ellipsoid.py:ellipsoid_nearest`` against JAX's, lane for lane,
  on 4,096 random rays and five random affines, still and moving: the
  winner and the front flag equal on every lane, t within 1e-5
  relative, the normal and the uv within 1e-5 (u modulo 1).
* ``integrator.trace(differentiable=True)`` on a scene of two ellipsoids
  (one moving) under a light, 256 rays, depth 3: the radiance within
  1e-4 relative on all but 3% of the rays and the gradient of its mean
  with respect to every ellipsoid leaf (``center``, ``radius``, ``fwd``,
  ``inv``, ``shift``, ``mv0``, ``mv1``) within 1e-3 of JAX's
  ``jax.grad`` in the L2 norm.
* ``interop``: a JAX scene with ellipsoids crosses to the port with its
  ellipsoid leaves equal to the port's own compile, and back; their
  gradients flatten under ``ellipsoids.*``.
* Routing: kernel A, kernel B and the fused differentiable step refuse
  ellipsoids, as the JAX package's checks do; the forward takes the
  split path; ``testing.ellipsoid_scene`` renders at 32 x 32, 4 spp,
  depth 8 like JAX's ``render_accumulate``: the median pixel within 1e-6,
  under 8% of the pixels more than 1e-5 apart and the image mean within
  1e-2 relative.  The bounds are wider than ``tests/test_torch_render.py``'s
  for the Cornell box (5%, 2e-3) because 0.8% of this scene's paths
  resolve a hit differently (XLA's CPU backend contracts multiply-adds;
  measured on 16,384 paths of depth 8, against 0.4% of the Cornell
  box's: the curved surfaces), and a path that ends on the light instead
  moves a pixel by up to 2.7: measured 2.7-5.0% of the pixels and mean
  differences of 0.45-0.75% on seeds 0 and 1 at 32 x 32 x 4 and 64 x 64 x
  8 spp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.ops.ellipsoid import ellipsoid_nearest as jnearest
from raytrace_tpu.render.integrator import bounce_kernel_eligible as jelig
from raytrace_tpu.render.integrator import trace as jtrace
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu.scene.types import Ellipsoids as JEllipsoids
import raytrace_tpu_torch as trt
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.fused_iter import (
    fused_diff_reason, fused_iter_eligible,
)
from raytrace_tpu_torch.diff.gradients import combine, leaves, partition
from raytrace_tpu_torch.interop import (
    fields_to_numpy, grads_to_numpy, scene_from_numpy, scene_to_numpy,
    settings_from_numpy,
)
from raytrace_tpu_torch.ops.ellipsoid import ellipsoid_nearest
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.scene.types import Ellipsoids
from raytrace_tpu_torch.testing import (
    ellipsoid_world, cornell_settings, scale3, torch_threads,
)

ELL_FIELDS = ("center", "radius", "fwd", "inv", "shift", "mv0", "mv1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _ell_world(rt, extra=()):
    m = rt.lambertian(rt.constant_texture(0.5))
    return rt.group([
        rt.transform(rt.compose(rt.translate([0, 0, -5]),
                                scale3(2.0, 1.0, 0.5)),
                     rt.with_material(m, rt.sphere([0, 0, 0], 1.0))),
        *extra,
    ])


def _ell_scene(extra=()):
    return trt.compile_scene(_ell_world(trt, extra), device="cpu")


def _settings(rt, vfov=0.5, spp=1, depth=2, bg=0.0):
    return rt.CameraSettings(center=np.zeros(3),
                             look_at=np.asarray([0.0, 0.0, -5.0]),
                             vfov=vfov, image_width=4, aspect_ratio=1.0,
                             samples_per_pixel=spp, max_depth=depth,
                             background=rt.const_background(bg))


def _hit(scene, s, o, d, time):
    """The forward surface hit of the split path (K8's plain version, the
    ellipsoids merged): ``(t, idx, normal)``."""
    tb = integrator.split_tables(scene, s)
    h = integrator.surface_hit(tb, o.T.contiguous(), d.T.contiguous(), time)
    return h[0], h[1].long(), torch.stack(h[2:5], -1)


def _cone(seed, n, spread):
    g = np.random.default_rng(seed)
    d = np.asarray([0, 0, -5.0]) + spread * g.normal(size=(n, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32))
    return torch.zeros((n, 3)), d, torch.zeros(n)


def test_compile_accepts_nonuniform_sphere():
    scene = _ell_scene()
    assert scene.ellipsoids is not None and scene.ellipsoids.n == 1
    assert scene.prims.n == 0 and not scene.ellipsoids.has_motion
    np.testing.assert_allclose(scene.ellipsoids.fwd[0].numpy(),
                               np.diag([2.0, 1.0, 0.5]), atol=1e-6)


def test_ellipsoid_hit_geometry():
    scene = _ell_scene()
    o, d, time = _cone(0, 64, 0.6)
    t, idx, normal = _hit(scene, _settings(trt), o, d, time)
    hit = torch.isfinite(t).numpy()
    assert hit.sum() > 20
    p = (o + t[:, None] * d).numpy()[hit]
    obj = (p - np.asarray([0, 0, -5.0])) @ np.diag([0.5, 1.0, 2.0]).T
    np.testing.assert_allclose(np.linalg.norm(obj, axis=1), 1.0, atol=1e-4)
    assert (idx.numpy()[hit] <= -2).all()
    nrm = normal.numpy()[hit]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)
    exp = obj @ np.diag([2.0, 1.0, 0.5]).T
    exp /= np.linalg.norm(exp, axis=1, keepdims=True)
    np.testing.assert_allclose(nrm, exp, atol=1e-4)


def test_ellipsoid_nearest_vs_prims():
    m = trt.lambertian(trt.constant_texture(0.5))
    scene = _ell_scene([trt.with_material(m, trt.parallelogram(
        [-5, -5, -8], [10, 0, 0], [0, 10, 0]))])
    d = torch.tensor([[0, 0, -1.0], [0.6, 0.1, -1.0]])
    d = d / d.norm(dim=1, keepdim=True)
    t, idx, _ = _hit(scene, _settings(trt), torch.zeros((2, 3)), d,
                     torch.zeros(2))
    assert int(idx[0]) <= -2 and int(idx[1]) >= 0
    assert abs(float(t[0]) - 4.5) < 1e-3


def test_prim_cotangent_is_zero_where_an_ellipsoid_wins():
    """Through ``surface_hit_diff``, a ray whose ellipsoid hit is nearer
    than a quad behind it gives the quad's row no gradient (its winner
    index is -2, not a clamped row 0), and a ray past the ellipsoid gives
    the quad one."""
    m = trt.lambertian(trt.constant_texture(0.5))
    scene = _ell_scene([trt.with_material(m, trt.parallelogram(
        [-5, -5, -8], [10, 0, 0], [0, 10, 0]))])
    s = _settings(trt)
    tables = integrator.generic_tables(scene, s, diff=True)
    params, statics = partition(scene)
    sc = combine(params, statics)
    for k, (dx, wins) in enumerate(((0.0, True), (0.6, False))):
        d = torch.tensor([[dx, 0.1, -1.0]])
        d = d / d.norm(dim=1, keepdim=True)
        t, idx, *_ = integrator.surface_hit_diff(sc, tables,
                                                 torch.zeros((1, 3)), d,
                                                 torch.zeros(1))
        assert (int(idx[0]) <= -2) == wins
        g_p0, g_c = torch.autograd.grad(t.sum(), [params.prims.p0,
                                                  params.ellipsoids.center],
                                        allow_unused=True)
        g_p0 = torch.zeros(1) if g_p0 is None else g_p0
        g_c = torch.zeros(1) if g_c is None else g_c
        assert bool((g_p0 == 0).all()) == wins
        assert bool((g_c != 0).any()) == wins


def test_ellipsoid_render_and_gradient():
    light = trt.light_source(trt.constant_texture(3.0))
    scene = _ell_scene([trt.with_material(light, trt.parallelogram(
        [-3, 3, -3], [6, 0, 0], [0, 0, -4]))])
    s = _settings(trt, vfov=0.7, spp=2, depth=3, bg=0.2)
    o, d, time = _cone(1, 64, 0.8)
    keys = rng.ray_keys_fast(rng.base_key(0),
                             torch.arange(64, dtype=torch.int32),
                             torch.zeros(64, dtype=torch.int32))
    params, statics = partition(scene)
    img = integrator.trace(combine(params, statics), s, o, d, time, keys,
                           differentiable=True)
    g = torch.autograd.grad(img.mean(), params.ellipsoids.radius)[0]
    assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(g).all())

    tables = integrator.generic_tables(scene, s, diff=True)

    def mean_t(radius):
        ell = dataclasses.replace(scene.ellipsoids, radius=radius)
        sc = dataclasses.replace(scene, ellipsoids=ell)
        t = integrator.surface_hit_diff(sc, tables, o, d, time)[0]
        return torch.mean(torch.where(torch.isfinite(t), t, 0.0))

    r0 = scene.ellipsoids.radius.clone().requires_grad_(True)
    g_t = torch.autograd.grad(mean_t(r0), r0)[0]
    eps = 1e-3
    with torch.no_grad():
        fd = (mean_t(r0 + eps) - mean_t(r0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g_t[0]), float(fd), rtol=0.02,
                               atol=1e-4)


def test_ellipsoid_rejected_as_medium_boundary():
    with pytest.raises(ValueError):
        trt.compile_scene(trt.with_material(
            trt.isotropic(trt.constant_texture(0.5)),
            trt.constant_medium(0.5, trt.transform(
                scale3(2.0, 1.0, 0.5), trt.sphere([0, 0, 0], 1.0)))),
            device="cpu")


@pytest.mark.parametrize("motion", [False, True])
def test_ellipsoid_nearest_matches_jax(motion):
    rg = np.random.default_rng(3 + motion)
    e, r = 5, 4096
    a = rg.normal(size=(e, 3, 3)) + 2.0 * np.eye(3)
    f = dict(center=rg.normal(0, 0.3, (e, 3)), radius=rg.uniform(0.5, 1.5, e),
             fwd=a, inv=np.linalg.inv(a), shift=rg.uniform(-4, 4, (e, 3)),
             mv0=rg.normal(0, 0.5, (e, 3)) * motion,
             mv1=rg.normal(0, 0.5, (e, 3)) * motion)
    f = {k: v.astype(np.float32) for k, v in f.items()}
    mat = np.arange(e, dtype=np.int32)
    je = JEllipsoids(**{k: jnp.asarray(v) for k, v in f.items()},
                     mat=jnp.asarray(mat), n=e, has_motion=motion)
    te = Ellipsoids(**{k: torch.from_numpy(v) for k, v in f.items()},
                    mat=torch.from_numpy(mat), n=e, has_motion=motion)
    o = rg.uniform(-8, 8, (r, 3)).astype(np.float32)
    tgt = f["shift"][rg.integers(0, e, r)] + rg.normal(0, 1.0, (r, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = rg.uniform(0, 1, r).astype(np.float32)
    jo = [np.asarray(x) for x in jnearest(je, jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(tm), 1e-3)]
    to = [x.numpy() for x in ellipsoid_nearest(
        te, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm),
        1e-3)]
    assert np.array_equal(to[1], jo[1])
    h = np.isfinite(jo[0])
    assert np.array_equal(np.isfinite(to[0]), h) and h.mean() > 0.5
    np.testing.assert_allclose(to[0][h], jo[0][h], rtol=1e-5)
    np.testing.assert_allclose(to[2][h], jo[2][h], atol=1e-5)
    assert np.array_equal(to[3][h], jo[3][h])
    du = np.abs(to[4][h] - jo[4][h])
    du[:, 0] = np.minimum(du[:, 0], 1.0 - du[:, 0])
    assert du.max() <= 1e-5


def _light_world(rt):
    light = rt.light_source(rt.constant_texture(3.0))
    m = rt.lambertian(rt.constant_texture([0.7, 0.5, 0.3]))
    return _ell_world(rt, [
        rt.with_material(light, rt.parallelogram([-3, 3, -3], [6, 0, 0],
                                                 [0, 0, -4])),
        rt.moving([0, 0, 0], [0.4, 0.1, 0], rt.transform(
            rt.compose(rt.translate([1.2, -0.6, -4.0]), rt.rotate_y(0.5),
                       scale3(0.6, 0.9, 0.4)),
            rt.with_material(m, rt.sphere([0, 0, 0], 1.0)))),
        rt.with_material(m, rt.parallelogram([-6, -1.5, 0], [12, 0, 0],
                                             [0, 0, -12])),
    ])


def test_trace_gradients_of_every_ellipsoid_leaf_match_jax():
    n = 256
    js = jrt.compile_scene(_light_world(jrt))
    ts = trt.compile_scene(_light_world(trt), device="cpu")
    assert ts.ellipsoids.n == 2 and ts.ellipsoids.has_motion
    jset, tset = (_settings(rt, vfov=0.8, depth=3, bg=0.2)
                  for rt in (jrt, trt))
    g = np.random.default_rng(5)
    d = np.asarray([0, 0, -5.0]) + 0.8 * g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    tm = g.uniform(0, 1, n).astype(np.float32)
    pix = np.arange(n, dtype=np.int32)
    jk = jrng.ray_keys_fast(jrng.base_key(2), jnp.asarray(pix),
                            jnp.zeros(n, jnp.int32))
    tk = rng.ray_keys_fast(rng.base_key(2), torch.from_numpy(pix),
                           torch.zeros(n, dtype=torch.int32))
    jleaves = {k: getattr(js.ellipsoids, k) for k in ELL_FIELDS}

    def jloss(lv):
        sc = js.replace(ellipsoids=js.ellipsoids.replace(**lv))
        img = jtrace(sc, jset, jnp.asarray(o), jnp.asarray(d),
                     jnp.asarray(tm), jk, differentiable=True)
        return jnp.mean(img), img

    (jl, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(jleaves)
    params, statics = partition(ts)
    img = integrator.trace(combine(params, statics), tset,
                           torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tm), tk, differentiable=True)
    tl = img.mean()
    tg = torch.autograd.grad(tl, [getattr(params.ellipsoids, k)
                                  for k in ELL_FIELDS])
    a, b = np.asarray(jimg), img.detach().numpy()
    off = (np.abs(a - b) > 1e-4 * (1.0 + np.abs(a))).any(1)
    assert off.mean() <= 0.03, off.mean()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-3 * abs(float(jl))
    for k, gk in zip(ELL_FIELDS, tg):
        ref = np.asarray(jg[k])
        assert np.isfinite(gk.numpy()).all(), k
        assert np.linalg.norm(ref) > 0, k
        assert np.linalg.norm(gk.numpy() - ref) <= 1e-3 * np.linalg.norm(
            ref), (k, np.linalg.norm(gk.numpy() - ref), np.linalg.norm(ref))


def test_interop_carries_ellipsoids():
    js = jrt.compile_scene(ellipsoid_world(jrt))
    ts = trt.compile_scene(ellipsoid_world(trt), device="cpu")
    ti = scene_from_numpy(scene_to_numpy(js), device="cpu")
    back = scene_from_numpy(scene_to_numpy(ts), device="cpu")
    for sc in (ti, back):
        e, te = sc.ellipsoids, ts.ellipsoids
        assert (e.n, e.has_motion) == (te.n, te.has_motion) == (3, True)
        for f in ELL_FIELDS + ("mat",):
            np.testing.assert_array_equal(getattr(e, f).numpy(),
                                          getattr(te, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(ts.ellipsoids.inv.numpy(),
                                  np.asarray(js.ellipsoids.inv))
    params, _ = partition(ts)
    assert {k for k in leaves(params) if k.startswith("ellipsoids.")} == {
        f"ellipsoids.{f}" for f in ELL_FIELDS}
    flat = grads_to_numpy(params)
    assert {k for k in flat if k.startswith("ellipsoids.")} == {
        f"ellipsoids.{f}" for f in ELL_FIELDS}


def test_kernels_a_and_b_refuse_ellipsoids_and_the_forward_splits():
    js = jrt.compile_scene(ellipsoid_world(jrt))
    jset = cornell_settings(jrt, 16, 1, 4)
    assert not jelig(js, jset, 256)
    ts = trt.compile_scene(_ell_world(trt, [trt.with_material(
        trt.lambertian(trt.constant_texture(0.4)),
        trt.parallelogram([-5, -5, -8], [10, 0, 0], [0, 10, 0]))]),
        device="cpu")
    s = _settings(trt)
    assert not integrator.bounce_kernel_eligible(ts, s, 256)
    assert not fused_iter_eligible(ts, s, 256)
    assert "ellipsoids" in fused_diff_reason(ts, s)
    assert integrator._bounce_step(ts, s, 256)[0] is \
        integrator.bounce_split_soa
    # the merged hit columns are contiguous, as the shade kernel needs
    o, d, time = _cone(2, 256, 0.6)
    hit = integrator.surface_hit(integrator.split_tables(ts, s),
                                 o.T.contiguous(), d.T.contiguous(), time)
    assert (hit[1] <= -2).any() and (hit[1] >= 0).any()
    assert all(x.is_contiguous() and x.dim() == 1 for x in hit)


def test_ellipsoid_scene_render_matches_jax():
    width, spp = 32, 4
    js = jrt.compile_scene(ellipsoid_world(jrt))
    jset = cornell_settings(jrt, width, spp, 8)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    dd = fields_to_numpy(jset)
    dd["background"] = ("const", (0.0, 0.0, 0.0))
    tset = settings_from_numpy(dd)
    jacc, jn = jrender(js, jset, 0, spp=spp)
    tacc, tn = trender(ts, tset, 0, spp=spp)
    assert tn == jn == spp
    a, b = np.asarray(jacc) / spp, tacc.numpy() / spp
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.08, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=1e-2)
