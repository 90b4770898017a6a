"""The BVH accelerator mode against the JAX package, on the CPU.

``compile_scene(accel="bvh")`` keeps the rows in the median-split order,
unsegmented, with the threaded tree in ``Scene.bvh``; on the CPU
``accel="auto"`` picks it past 65,536 surface rows, as the JAX package
does on the CPU (on the card no size picks it).  Scenes:
``testing.mesh_all_kinds_world`` (648 triangles, spheres, parallelograms
and a box: 653 surface rows), still and with moving extras, and the
past-the-cap ``testing.bigmesh_world(rt, 184, 184)`` (67,346 rows).

* Compile: the tables and the tree equal the JAX package's (integer
  columns and the tree's words exactly, floats to rtol 1e-6: both build
  the same f64 formulas); ``bvh_tree`` compiles as ``group``.
* Interop carries BVH-mode scenes both ways and refuses a malformed tree
  with ``ValueError``.
* ``ops/intersect.py:bvh_nearest`` against the JAX package's on 1,024
  camera and random rays: the hit mask exactly, t within rtol 2e-4 +
  atol 3e-5, the winner index exactly.  Both keep the first of equally
  near rows in walk order (strict ``<``), so the index is held exactly,
  tie or not; kernel K9 keeps the lowest row instead, which only a tie
  (measure zero) tells apart.
* A 16 x 16, 2 spp, depth 3 render of the BVH-mode scene (the split path
  over the tree walk in torch, ``surface_engine`` ``torch-bvh``) within
  ``tests/test_torch_render.py``'s bound of the JAX package's (its XLA
  BVH route); ``DiffSurfaceHit`` over the tree walk against
  ``make_diff_surface_hit`` (``tests/test_torch_diff_intersect.py``'s
  tolerances); ``grad_render`` finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops import intersect as jint
from raytrace_tpu.ops.diff_intersect import make_diff_surface_hit
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import grad_render, leaves
from raytrace_tpu_torch.interop import (
    fields_to_numpy, scene_from_numpy, scene_to_numpy, settings_from_numpy,
)
from raytrace_tpu_torch.ops import intersect as tint
from raytrace_tpu_torch.ops.diff_intersect import diff_surface_hit, hit_statics
from raytrace_tpu_torch.ops.intersect_kernel import MAX_DENSE_PRIMS
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.render.render import uses_sorted
from raytrace_tpu_torch.scene.compile import default_dense_threshold
from raytrace_tpu_torch.testing import (
    bigmesh_world, camera_rays, mesh_all_kinds_world, torch_threads,
)

R = 1024
FLOATS = ("p0", "e1", "e2", "uvs", "mv0", "mv1")
PRIM_FIELDS = ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1")
BVH_FIELDS = ("lo", "hi", "start", "count", "skip")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _settings(rt, width=16, spp=2, depth=3):
    """``testing.mesh_all_kinds_scene``'s camera."""
    return rt.CameraSettings(center=np.asarray([0.0, 2.0, 8.0]),
                             look_at=np.asarray([0.0, 0.0, 0.0]),
                             image_width=width, samples_per_pixel=spp,
                             max_depth=depth, background=rt.sky)


def _pair(moving=False, accel="bvh"):
    js = jrt.compile_scene(mesh_all_kinds_world(jrt, 18, moving), accel=accel)
    ts = trt.compile_scene(mesh_all_kinds_world(trt, 18, moving), accel=accel,
                           device="cpu")
    return js, ts


def _assert_same_scene(ts, js):
    """The port's scene ``ts`` has the JAX scene ``js``'s rows and tree."""
    p, jp = ts.prims, js.prims
    assert (p.n, p.kind_segments, p.has_motion, p.has_box,
            p.kinds_present) == (jp.n, jp.kind_segments, jp.has_motion,
                                 jp.has_box, jp.kinds_present)
    for name in PRIM_FIELDS:
        a, b = getattr(p, name).numpy(), np.asarray(getattr(jp, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert (ts.bvh is None) == (js.bvh is None)
    if js.bvh is not None:
        assert ts.bvh.n_nodes == js.bvh.n_nodes
        for name in BVH_FIELDS:
            a, b = getattr(ts.bvh, name).numpy(), np.asarray(
                getattr(js.bvh, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("moving", [False, True])
def test_bvh_mode_compiles_as_jax(moving):
    js, ts = _pair(moving)
    assert ts.prims.kind_segments is None and ts.bvh is not None
    assert ts.prims.kind.shape[0] % 8 == 0       # padded to pad_to only
    _assert_same_scene(ts, js)
    tree = trt.compile_scene(trt.bvh_tree(
        [mesh_all_kinds_world(trt, 18, moving)]), accel="bvh", device="cpu")
    _assert_same_scene(tree, js)
    assert trt.bvh_tree is trt.group


def test_cpu_auto_rule_matches_jax_past_the_cap():
    assert default_dense_threshold("cpu") == MAX_DENSE_PRIMS
    assert default_dense_threshold("cuda") == 1 << 62
    assert default_dense_threshold(torch.device("cuda", 0)) == 1 << 62
    js = jrt.compile_scene(bigmesh_world(jrt, 184, 184))
    ts = trt.compile_scene(bigmesh_world(trt, 184, 184), device="cpu")
    assert ts.prims.n > MAX_DENSE_PRIMS and ts.bvh is not None
    _assert_same_scene(ts, js)
    # the BVH mode keeps the stationary driver and the split path
    assert not uses_sorted(ts)
    assert integrator.surface_engine(ts) == "torch-bvh"
    _, small = _pair(accel="auto")
    assert small.bvh is None and small.prims.kind_segments is not None


def test_interop_carries_bvh_mode_both_ways():
    js, ts = _pair(True)
    d = scene_to_numpy(js)
    assert set(d["bvh"]) == set(BVH_FIELDS) | {"n_nodes"}
    _assert_same_scene(scene_from_numpy(d, device="cpu"), js)
    back = scene_from_numpy(scene_to_numpy(ts), device="cpu")
    _assert_same_scene(back, js)
    bad = [dict(d["bvh"], n_nodes=d["bvh"]["n_nodes"] + 1),
           dict(d["bvh"], lo=d["bvh"]["lo"][:, :2]),
           dict(d["bvh"], skip=np.zeros_like(d["bvh"]["skip"])),
           dict(d["bvh"], start=d["bvh"]["start"] + 10 ** 6),
           dict(d["bvh"], count=d["bvh"]["count"].astype(np.int64)),
           {k: v for k, v in d["bvh"].items() if k != "skip"}]
    for b in bad:
        with pytest.raises(ValueError, match="malformed bvh"):
            scene_from_numpy(dict(d, bvh=b), device="cpu")
    seg = scene_to_numpy(jrt.compile_scene(mesh_all_kinds_world(jrt, 18),
                                           accel="dense"))
    with pytest.raises(ValueError, match="kind-segmented"):
        scene_from_numpy(dict(seg, bvh=d["bvh"]), device="cpu")


def _rays(ts, s, seed):
    cam, _ = camera_rays(ts, s.replace(image_width=48), R // 2, seed)
    rg = np.random.default_rng(seed)
    m = R - R // 2
    o = rg.uniform(-3, 3, (m, 3))
    d = rg.normal(size=(m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rand = np.concatenate([o.T, d.T, rg.uniform(0, 1, (1, m))])
    return torch.cat([cam, torch.from_numpy(rand.astype(np.float32))], 1)


@pytest.mark.parametrize("moving", [False, True])
def test_bvh_nearest_matches_jax(moving):
    js, ts = _pair(moving)
    s = _settings(trt)
    rays = _rays(ts, s, 11 + moving)
    o, d, tm = rays[0:3].T, rays[3:6].T, rays[6]
    tmin, tmax = torch.full((R,), 1e-3), torch.full((R,), float("inf"))
    t, i = tint.nearest_hit_t(ts.prims, ts.bvh, o, d, tm, tmin, tmax)
    jt, ji = jint.nearest_hit_t(js.prims, js.bvh, jnp.asarray(o.numpy()),
                                jnp.asarray(d.numpy()),
                                jnp.asarray(tm.numpy()),
                                jnp.asarray(tmin.numpy()),
                                jnp.asarray(tmax.numpy()))
    t, i, jt, ji = t.numpy(), i.numpy(), np.asarray(jt), np.asarray(ji)
    hit = np.isfinite(jt)
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=2e-4, atol=3e-5)
    # the walk finds the nearest hit of the whole table (the scan computes
    # t in another association: the same tolerance)
    td, idd = tint.dense_nearest(ts.prims, o, d, tm, tmin, tmax)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), hit)
    np.testing.assert_allclose(td.numpy()[hit], t[hit], rtol=2e-4, atol=3e-5)
    assert (idd.numpy() != i).mean() < 0.005


@pytest.mark.parametrize("leaf_size", [8, 16])
def test_bvh_nearest_walks_wide_leaves(leaf_size):
    """A tree of ``compile_scene(accel="bvh", leaf_size=...)`` with
    leaves of more than 4 rows is walked whole: the split path's walk (``integrator.py:
    _tree_hit``) against the scan of the whole table and the JAX
    package's ``bvh_nearest`` given the same leaf size."""
    world = mesh_all_kinds_world(trt, 18, True)
    ts = trt.compile_scene(world, accel="bvh", leaf_size=leaf_size,
                           device="cpu")
    js = jrt.compile_scene(mesh_all_kinds_world(jrt, 18, True), accel="bvh",
                           leaf_size=leaf_size)
    _assert_same_scene(ts, js)
    assert int(ts.bvh.count.max()) > 4
    s = _settings(trt)
    rays = _rays(ts, s, 31)
    o, d, tm = (rays[0:3].T.contiguous(), rays[3:6].T.contiguous(),
                rays[6].contiguous())
    tb = integrator.split_tables(ts, s)
    t, i = integrator._tree_hit(tb, o.T, d.T, tm)[:2]
    t, i = t.numpy(), i.numpy()
    tmin = torch.full((R,), tb.t_min)
    tmax = torch.full((R,), float("inf"))
    td, idd = tint.dense_nearest(ts.prims, o, d, tm, tmin, tmax)
    td, idd = td.numpy(), idd.numpy()
    hit = np.isfinite(td)
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], td[hit], rtol=2e-4, atol=3e-5)
    assert (idd != i).mean() < 0.005
    jt, ji = jint.bvh_nearest(js.prims, js.bvh, *(jnp.asarray(x.numpy())
                              for x in (o, d, tm, tmin, tmax)), leaf_size)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(t[hit], np.asarray(jt)[hit], rtol=2e-4,
                               atol=3e-5)


def test_bvh_mode_render_matches_jax(monkeypatch):
    js, ts = _pair()
    jset = _settings(jrt)
    d = fields_to_numpy(jset)
    d["background"] = "sky"
    tset = settings_from_numpy(d)
    assert integrator.bounce_route(ts, tset, 256) == "split"
    walks = []
    real = integrator.nearest_hit_t
    monkeypatch.setattr(integrator, "nearest_hit_t",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    jacc, _ = jrender(js, jset, 1, spp=2)
    tacc, _ = trender(ts, tset, 1, spp=2)
    assert walks
    a, b = np.asarray(jacc) / 2, tacc.numpy() / 2
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_bvh_mode_diff_surface_hit_matches_jax():
    _, ts = _pair(True)
    p = ts.prims
    s = _settings(trt)
    rays = _rays(ts, s, 21)
    o, d, tm = (rays[0:3].T.contiguous(), rays[3:6].T.contiguous(),
                rays[6].contiguous())
    tb = integrator.split_tables(ts, s)
    assert tb.tree is not None and tb.bvh is None
    st = hit_statics(tb, p, tb.t_min)
    jhit = make_diff_surface_hit(True, tb.t_min, False, has_box=p.has_box,
                                 kind_segments=None)
    jf = tuple(jnp.asarray(getattr(p, f).numpy()) for f in FLOATS)
    ints_f = (jnp.asarray(p.kind.numpy(), jnp.float32),
              jnp.asarray(p.mat.numpy(), jnp.float32))

    def jfn(f, a, b, c):
        out = jhit(f, ints_f, a, b, c)
        return (out[0], out[2], out[4]), out

    _, vjp, jout = jax.vjp(jfn, jf, jnp.asarray(o.numpy()),
                           jnp.asarray(d.numpy()), jnp.asarray(tm.numpy()),
                           has_aux=True)
    lv = [getattr(p, f).clone().requires_grad_(True) for f in FLOATS]
    tin = [x.clone().requires_grad_(True) for x in (o, d, tm)]
    tp = dataclasses.replace(p, **dict(zip(FLOATS, lv)))
    tout = diff_surface_hit(st, tp, *tin)
    jidx = np.asarray(jout[1])
    same = jidx == tout[1].numpy()
    assert same.mean() > 0.995
    hit = same & (jidx >= 0)
    assert hit.sum() > R // 5
    for k in (0, 2, 4):
        a = np.asarray(jout[k])[hit]
        b = tout[k].detach().numpy()[hit]
        close = np.isclose(b, a, rtol=1e-4, atol=1e-4)
        assert close.reshape(close.shape[0], -1).all(1).mean() > 0.995, k
        assert np.abs(a - b).max() < 1e-2, k
    rg = np.random.default_rng(9)
    m = same.astype(np.float32)
    cts = (rg.normal(size=R).astype(np.float32) * m,
           rg.normal(size=(R, 3)).astype(np.float32) * m[:, None],
           rg.normal(size=(R, 2)).astype(np.float32) * m[:, None])
    jf_g, *jr_g = vjp(tuple(jnp.asarray(c) for c in cts))
    tg = torch.autograd.grad((tout[0], tout[2], tout[4]), lv + tin,
                             tuple(torch.from_numpy(c) for c in cts),
                             allow_unused=True)
    for k, (a, b) in enumerate(zip(list(jf_g) + jr_g, tg)):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.all(np.isfinite(b)), k
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(a) + 1e-6, k


def test_bvh_mode_grad_render_is_finite():
    _, ts = _pair()
    s = _settings(trt)
    pix = torch.arange(0, 256, 2, dtype=torch.int32)
    loss, g = grad_render(ts, s, rng.base_key(3), pix,
                          torch.arange(2, dtype=torch.int32),
                          torch.zeros((pix.shape[0], 3)))
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    gl = {k: v for k, v in leaves(g).items() if v is not None}
    assert all(bool(torch.isfinite(v).all()) for v in gl.values())
    assert bool((gl["prims.p0"] != 0).any())
    assert bool((gl["materials.param"] != 0).any()
                or (gl["textures.c0"] != 0).any())
