"""Tables past 65,536 rows against the JAX package, on the CPU.

The scene is ``testing.bigmesh_world(rt, 184, 184)``:
``tools/bench_bigmesh.py``'s world with the smallest uv sphere past the
old cap (67,344 triangles; with the floor and the light 67,346 surface
rows, 67,392 kind-segmented rows).  Both packages compile it with
``accel="dense"`` (the JAX package's TPU order; on the CPU its ``auto``
gives the BVH mode, ``tests/test_torch_bvh_mode.py``).

* The compiled tables are equal: integer columns exactly, floats to rtol
  1e-6 (``tests/test_torch_scene.py``'s tolerance).
* Kernel K9's plain version (``allpairs_nearest_record`` on CPU tensors)
  against the JAX package's XLA oracle (``nearest_hit_t`` and
  ``make_hit_record``) on 512 rays: the hit mask and the winner index
  exactly, t within rtol 2e-4 + atol 3e-5, the normal and uv within atol
  2e-3 + rtol 1e-3, the flags and the material exactly
  (``tests/test_torch_allpairs.py``).
* The JAX package's streamed K9 (``_dyn_kernel`` with ``row_phases(...,
  stream=True)``, in interpret mode, ``MAX_PRIMS`` lowered to 64 as
  ``tests/test_allpairs_intersect.py`` does) against the port's plain K9
  on 512 random rays through 120 spheres and 80 parallelograms: the hit
  mask exactly, t within rtol 5e-4 + atol 5e-5 (that test's tolerance),
  the winner index exactly but on near ties (two rows within that
  tolerance of one t: under 0.5% of the hits), the record within atol
  2e-3 + rtol 1e-3 where the winners agree.
* A 16 x 16, 2 spp, depth 3 render (the work-queue driver: the split
  path, K9 and the shade kernel's plain versions) within
  ``tests/test_torch_render.py``'s bound of the JAX package's.
* ``DiffSurfaceHit``'s value and VJP against ``make_diff_surface_hit``
  (``tests/test_torch_diff_intersect.py``'s tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops import intersect as jint
from raytrace_tpu.ops.diff_intersect import make_diff_surface_hit
from raytrace_tpu.ops.pallas import allpairs_kernel as jak
from raytrace_tpu.ops.pallas import intersect_kernel as jik
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.interop import fields_to_numpy, settings_from_numpy
from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
from raytrace_tpu_torch.ops.diff_intersect import diff_surface_hit, hit_statics
from raytrace_tpu_torch.ops.intersect_kernel import MAX_DENSE_PRIMS, pack_prims
from raytrace_tpu_torch.render.integrator import (
    split_tables, surface_engine, uses_bvh,
)
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.testing import (
    bigmesh_settings, bigmesh_world, camera_rays, torch_threads,
)

N_LAT = 184
R = 512
FLOATS = ("p0", "e1", "e2", "uvs", "mv0", "mv1")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def scenes():
    js = jrt.compile_scene(bigmesh_world(jrt, N_LAT, N_LAT), accel="dense")
    ts = trt.compile_scene(bigmesh_world(trt, N_LAT, N_LAT), accel="dense",
                           device="cpu")
    return js, ts, bigmesh_settings(trt, 16, 2, 3)


def _rays(ts, s, seed):
    """[7, R] rays: half camera rays of a 64 x 64 view, half rays from
    random points around the sphere at random points on it."""
    cam, _ = camera_rays(ts, s.replace(image_width=64), R // 2, seed)
    rg = np.random.default_rng(seed)
    m = R - R // 2
    o = rg.uniform(-4, 4, (m, 3))
    d = rg.normal(size=(m, 3)) * 0.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rand = np.concatenate([o.T, d.T, rg.uniform(0, 1, (1, m))])
    return torch.cat([cam, torch.from_numpy(rand.astype(np.float32))], 1)


def test_tables_past_the_cap_equal_jax_dense(scenes):
    js, ts, _ = scenes
    p = ts.prims
    assert p.n == 2 * N_LAT * (N_LAT - 1) + 2 > MAX_DENSE_PRIMS
    assert ts.bvh is None and js.bvh is None
    assert p.kind_segments == js.prims.kind_segments
    assert p.kinds_present == js.prims.kinds_present
    assert (p.n, p.has_motion, p.has_box) == (
        js.prims.n, js.prims.has_motion, js.prims.has_box)
    for name in ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1"):
        a, b = getattr(p, name).numpy(), np.asarray(getattr(js.prims, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert uses_bvh(p) and surface_engine(ts) == "K9"


def test_plain_k9_matches_jax_oracle(scenes):
    js, ts, s = scenes
    rays = _rays(ts, s, 3)
    t_min = float(np.float32(s.t_min))
    n_prims = ts.prims.kind.shape[0]
    out = [x.numpy() for x in allpairs_nearest_record(
        pack_prims(ts.prims), None, *rays, n_prims=n_prims, t_min=t_min,
        has_motion=False)]
    o, d = jnp.asarray(rays[0:3].T.numpy()), jnp.asarray(rays[3:6].T.numpy())
    tm = jnp.asarray(rays[6].numpy())
    t_j, i_j = jint.nearest_hit_t(js.prims, None, o, d, tm,
                                  jnp.full(R, t_min), jnp.full(R, jnp.inf))
    rec = jint.make_hit_record(js.prims, i_j, o, d, tm,
                               jnp.where(jnp.isfinite(t_j), t_j, 1.0))
    t_j, i_j = np.asarray(t_j), np.asarray(i_j)
    hit = np.isfinite(t_j)
    assert hit.sum() > R // 4
    np.testing.assert_array_equal(np.isfinite(out[0]), hit)
    np.testing.assert_array_equal(out[1], np.where(hit, i_j, -1))
    np.testing.assert_allclose(out[0][hit], t_j[hit], rtol=2e-4, atol=3e-5)
    normal = np.stack(out[2:5], 1)
    np.testing.assert_allclose(normal[hit], np.asarray(rec.normal)[hit],
                               rtol=1e-3, atol=2e-3)
    uv = np.stack(out[6:8], 1)
    np.testing.assert_allclose(uv[hit], np.asarray(rec.uv)[hit], rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(out[5][hit] & 1,
                                  np.asarray(rec.front)[hit].astype(int))
    np.testing.assert_array_equal(out[8][hit], np.asarray(rec.mat)[hit])


def _streamed_world(rt):
    """``tests/test_allpairs_intersect.py:test_streamed_dyn_matches_oracle``'s
    scene: 120 spheres and 80 parallelograms from numpy seed 21."""
    m = rt.lambertian(rt.constant_texture(0.5))
    m2 = rt.metal(0.1, rt.constant_texture(0.9))
    rg = np.random.default_rng(21)
    items = [rt.with_material(m, rt.sphere(rg.uniform(-8, 8, 3),
                                           rg.uniform(0.3, 1.0)))
             for _ in range(120)]
    items += [rt.with_material(m2, rt.parallelogram(
        rg.uniform(-8, 8, 3), rg.uniform(-1.5, 1.5, 3),
        rg.uniform(-1.5, 1.5, 3))) for _ in range(80)]
    return rt.group(items)


def test_streamed_jax_k9_matches_port_plain(monkeypatch):
    monkeypatch.setattr(jak, "MAX_PRIMS", 64)
    js = jrt.compile_scene(_streamed_world(jrt), accel="dense")
    ts = trt.compile_scene(_streamed_world(trt), accel="dense", device="cpu")
    n_prims = ts.prims.kind.shape[0]
    assert n_prims > 64 and ts.prims.kind_segments is not None
    rg = np.random.default_rng(9)
    o = rg.uniform(-6, 6, (R, 3))
    d = rg.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o.T, d.T, rg.uniform(0, 1, (1, R))]).astype(
        np.float32)
    t_min = 1e-3
    ref = [x.numpy() for x in allpairs_nearest_record(
        pack_prims(ts.prims), None, *torch.from_numpy(rays), n_prims=n_prims,
        t_min=t_min, has_motion=False)]
    g = R // 128
    jx = [np.asarray(x).reshape(-1) for x in jak.allpairs_nearest_record(
        jik.pack_prims(js.prims), *(jnp.asarray(x.reshape(g, 128))
                                    for x in rays),
        n_prims=n_prims, t_min=t_min, has_motion=False,
        segments=js.prims.kind_segments, ctbl=jik.pack_clusters(js.prims),
        interpret=True)]
    hit = np.isfinite(ref[0])
    assert hit.sum() > 50
    np.testing.assert_array_equal(np.isfinite(jx[0]), hit)
    np.testing.assert_allclose(jx[0][hit], ref[0][hit], rtol=5e-4, atol=5e-5)
    same = jx[1] == ref[1]
    assert (hit & ~same).mean() < 0.005
    ok = hit & same
    for k in (2, 3, 4, 6, 7):
        np.testing.assert_allclose(ref[k][ok], jx[k][ok], rtol=1e-3,
                                   atol=2e-3, err_msg=str(k))
    for k in (5, 8):
        np.testing.assert_array_equal(ref[k][ok], jx[k][ok], err_msg=str(k))


def test_render_past_the_cap_matches_jax(scenes):
    js, ts, _ = scenes
    jset = bigmesh_settings(jrt, 16, 2, 3)
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.05, 0.05, 0.05))
    tset = settings_from_numpy(d)
    jacc, jn = jrender(js, jset, 1, spp=2)
    tacc, tn = trender(ts, tset, 1, spp=2)
    assert tn == jn == 2
    a = np.asarray(jacc) / 2
    b = tacc.numpy() / 2
    assert b.shape == a.shape == (256, 3) and np.isfinite(b).all()
    # the mesh and the floor are seen: pixels off the 0.05 background
    assert (np.abs(a - 0.05) > 1e-3).any(axis=1).mean() > 0.2
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_diff_surface_hit_past_the_cap_matches_jax(scenes):
    _, ts, s = scenes
    p = ts.prims
    rays = _rays(ts, s, 4)
    o, d, tm = (rays[0:3].T.contiguous(), rays[3:6].T.contiguous(),
                rays[6].contiguous())
    tb = split_tables(ts, s)
    assert tb.bvh is not None
    st = hit_statics(tb, p, tb.t_min)
    jhit = make_diff_surface_hit(False, tb.t_min, False, has_box=p.has_box,
                                 kind_segments=p.kind_segments)
    jf = tuple(jnp.asarray(getattr(p, f).numpy()) for f in FLOATS)
    ints_f = (jnp.asarray(p.kind.numpy(), jnp.float32),
              jnp.asarray(p.mat.numpy(), jnp.float32))

    def jfn(f, a, b, c):
        out = jhit(f, ints_f, a, b, c)
        return (out[0], out[2], out[4]), out

    _, vjp, jout = jax.vjp(jfn, jf, jnp.asarray(o.numpy()),
                           jnp.asarray(d.numpy()), jnp.asarray(tm.numpy()),
                           has_aux=True)
    leaves = [getattr(p, f).clone().requires_grad_(True) for f in FLOATS]
    tin = [x.clone().requires_grad_(True) for x in (o, d, tm)]
    tp = type(p)(**{**{f: getattr(p, f) for f in p.__dataclass_fields__},
                    **dict(zip(FLOATS, leaves))})
    tout = diff_surface_hit(st, tp, *tin)
    jidx = np.asarray(jout[1])
    same = jidx == tout[1].numpy()
    assert same.mean() > 0.995
    hit = same & (jidx >= 0)
    assert hit.sum() > R // 4
    for k in (0, 2, 4):
        a = np.asarray(jout[k])[hit]
        b = tout[k].detach().numpy()[hit]
        close = np.isclose(b, a, rtol=1e-4, atol=1e-4)
        assert close.reshape(close.shape[0], -1).all(1).mean() > 0.995, k
        assert np.abs(a - b).max() < 1e-2, k
    assert np.array_equal(tout[3].numpy()[hit], np.asarray(jout[3])[hit])
    assert np.array_equal(tout[5].numpy()[hit], np.asarray(jout[5])[hit])
    rg = np.random.default_rng(9)
    m = same.astype(np.float32)
    cts = (rg.normal(size=R).astype(np.float32) * m,
           rg.normal(size=(R, 3)).astype(np.float32) * m[:, None],
           rg.normal(size=(R, 2)).astype(np.float32) * m[:, None])
    jf_g, *jr_g = vjp(tuple(jnp.asarray(c) for c in cts))
    tg = torch.autograd.grad((tout[0], tout[2], tout[4]), leaves + tin,
                             tuple(torch.from_numpy(c) for c in cts),
                             allow_unused=True)
    for k, (a, b) in enumerate(zip(list(jf_g) + jr_g, tg)):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.all(np.isfinite(b)), k
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(a) + 1e-6, k
