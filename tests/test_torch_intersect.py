"""The port's differentiable roots and hit records (``ops/intersect.py``)
against the JAX package's ``raytrace_tpu/ops/intersect.py``.

Rows of three tables, carried across as arrays: ``testing.
mesh_all_kinds_world`` (832 rows: spheres, parallelograms, triangles and
boxes; still, and with its extras moving) and ``testing.box_motion_scene``
(boxes, spheres and planes, half of them moving); 512 random rays from a
numpy seed through the tables' box, at random times.

* ``chunk_roots`` [R, C] and ``roots_to_hit_t``, ``dense_nearest``
  (the oracle of the nearest-hit kernels), ``_single_prim_t_rows`` and
  ``make_hit_record_rows`` on each ray's nearest row;
* the VJPs of ``_single_prim_t_rows``, ``chunk_roots`` on each ray's own
  row (the port's ``chunk_roots_rows``) and ``make_hit_record_rows``'
  normal and uv, against ``jax.vjp`` with the same random cotangents, with
  respect to the rows and the rays.

Tolerances: the hit rows (which row, front flags, which roots are
finite) equal on all but 0.5% of the rays (the two packages sum the
three products of a dot product in different orders, which can move a
grazing root across an edge); the finite values within rtol 1e-4, atol
1e-4 of JAX's; each VJP within 1e-4 of its norm in the L2 norm over the
rays whose rows agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu_torch as trt
from raytrace_tpu.ops import intersect as ji
from raytrace_tpu.scene.types import Primitives as JPrims
from raytrace_tpu_torch.ops import intersect as ti
from raytrace_tpu_torch.testing import (
    box_motion_scene, mesh_all_kinds_world, torch_threads,
)

R = 512
T_MIN = 1e-3
FIELDS = ("p0", "e1", "e2", "mv0", "mv1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _prims(name):
    if name == "box_motion":
        return box_motion_scene(device="cpu")[0].prims
    moving = name == "mesh_moving"
    return trt.compile_scene(mesh_all_kinds_world(trt, 18, moving),
                             device="cpu").prims


def _jprims(p):
    a = lambda x: jnp.asarray(x.numpy())
    return JPrims(kind=a(p.kind), p0=a(p.p0), e1=a(p.e1), e2=a(p.e2),
                  uvs=a(p.uvs), mat=a(p.mat), mv0=a(p.mv0), mv1=a(p.mv1),
                  n=p.n, has_motion=p.has_motion, has_box=p.has_box)


def _rays(p, seed):
    rg = np.random.default_rng(seed)
    real = p.kind.numpy() >= 0
    pts = p.p0.numpy()[real]
    lo, hi = pts.min(0) - 2.0, pts.max(0) + 2.0
    o = rg.uniform(lo, hi, (R, 3)).astype(np.float32)
    # aim at a random row's corner, so most rays hit something
    tgt = pts[rg.integers(0, len(pts), R)] + rg.normal(0, 0.5, (R, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rg.uniform(0, 1, R).astype(np.float32)
    return o, d, tm


CASES = ("mesh", "mesh_moving", "box_motion")


@pytest.fixture(scope="module", params=CASES)
def case(request):
    p = _prims(request.param)
    o, d, tm = _rays(p, 3)
    return request.param, p, _jprims(p), o, d, tm


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_chunk_roots_and_dense_nearest_match_jax(case):
    name, p, jp, o, d, tm = case
    args = [getattr(p, f) for f in FIELDS]
    r1, r2 = ti.chunk_roots(p.kind, *args, p.has_motion, _t(o), _t(d),
                            _t(tm), has_box=p.has_box)
    jr1, jr2 = ji.chunk_roots(jp.kind, *(getattr(jp, f) for f in FIELDS),
                              p.has_motion, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tm), has_box=p.has_box)
    for a, b in ((jr1, r1), (jr2, r2)):
        a = np.asarray(a)
        b = b.numpy()
        fin = np.isfinite(a)
        assert (fin != np.isfinite(b)).mean() < 0.005, name
        both = fin & np.isfinite(b)
        assert both.sum() > 50, name
        np.testing.assert_allclose(b[both], a[both], rtol=1e-4, atol=1e-4)
    tmin = np.full(R, T_MIN, np.float32)
    tmax = np.full(R, np.inf, np.float32)
    jt, jidx = ji.dense_nearest(jp, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tm), jnp.asarray(tmin),
                                jnp.asarray(tmax))
    tt, tidx = ti.dense_nearest(p, _t(o), _t(d), _t(tm), _t(tmin),
                                _t(tmax))
    same = np.asarray(jidx) == tidx.numpy()
    assert same.mean() > 0.995, name
    assert (np.asarray(jidx) >= 0).sum() > R // 2, name
    hit = same & (np.asarray(jidx) >= 0)
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-4, atol=1e-4)
    ht = ti.roots_to_hit_t(r1, r2, _t(tmin)[:, None], _t(tmax)[:, None])
    assert torch.equal(ht.amin(1), tt)


def _own_rows(p, jp, o, d, tm):
    """Each ray's nearest row index (by the JAX oracle, -1 on a miss) and
    its row as per-ray rows of both packages."""
    tmin = jnp.full((R,), T_MIN, jnp.float32)
    _, jidx = ji.dense_nearest(jp, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tm), tmin,
                               jnp.full((R,), jnp.inf, jnp.float32))
    idx = np.asarray(jidx)
    rows_t = ti.gather_rows(p, _t(idx))
    rows_j = tuple(jnp.asarray(x.numpy()) for x in rows_t)
    return idx, rows_t, rows_j


def test_row_functions_and_their_vjps_match_jax(case):
    name, p, jp, o, d, tm = case
    idx, rows_t, rows_j = _own_rows(p, jp, o, d, tm)
    hit = idx >= 0
    rg = np.random.default_rng(7)
    ct_t = rg.normal(size=R).astype(np.float32) * hit
    ct_n = rg.normal(size=(R, 3)).astype(np.float32) * hit[:, None]
    ct_uv = rg.normal(size=(R, 2)).astype(np.float32) * hit[:, None]
    tmin = np.full(R, T_MIN, np.float32)
    tmax = np.full(R, np.inf, np.float32)
    kind_j, kind_t = rows_j[0], rows_t[0]
    mat = np.zeros(R, np.int32)

    def jfn(p0, e1, e2, mv0, mv1, uvs, o_, d_, tm_):
        rows = (kind_j, p0, e1, e2, mv0, mv1)
        t = ji._single_prim_t_rows(rows, p.has_motion, o_, d_, tm_,
                                   jnp.asarray(tmin), jnp.asarray(tmax),
                                   has_box=p.has_box)
        t_safe = jnp.where(jnp.isfinite(t), t, 1.0)
        rec = ji.make_hit_record_rows(rows + (uvs,), p.has_motion,
                                      jnp.asarray(mat), jnp.asarray(idx),
                                      o_, d_, tm_, t_safe,
                                      has_box=p.has_box)
        return t_safe, rec.normal, rec.uv

    def tfn(p0, e1, e2, mv0, mv1, uvs, o_, d_, tm_):
        rows = (kind_t, p0, e1, e2, mv0, mv1)
        t = ti.single_prim_t_rows(rows, p.has_motion, o_, d_, tm_,
                                  _t(tmin), _t(tmax), has_box=p.has_box)
        t_safe = torch.where(torch.isfinite(t), t, 1.0)
        rec = ti.make_hit_record_rows(rows + (uvs,), p.has_motion,
                                      _t(mat), _t(idx), o_, d_, tm_, t_safe,
                                      has_box=p.has_box)
        return t_safe, rec.normal, rec.uv

    j_in = rows_j[1:] + (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    j_out, vjp = jax.vjp(jfn, *j_in)
    j_g = vjp((jnp.asarray(ct_t), jnp.asarray(ct_n), jnp.asarray(ct_uv)))
    t_in = [x.clone().requires_grad_(True) for x in rows_t[1:]] + [
        _t(o).requires_grad_(True), _t(d).requires_grad_(True),
        _t(tm).requires_grad_(True)]
    t_out = tfn(*t_in)
    t_g = torch.autograd.grad(t_out, t_in, (_t(ct_t), _t(ct_n), _t(ct_uv)),
                              allow_unused=True)
    for a, b in zip(j_out, t_out):
        np.testing.assert_allclose(b.detach().numpy()[hit],
                                   np.asarray(a)[hit], rtol=1e-4, atol=1e-4)
    for k, (a, b) in enumerate(zip(j_g, t_g)):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = np.linalg.norm(a) + 1e-12
        assert np.linalg.norm(a - b) <= 1e-4 * scale + 1e-6, (name, k)

    # chunk_roots on each ray's own row, and its VJP
    def jroots(p0, e1, e2, o_, d_, tm_):
        f = jax.vmap(lambda k, a, b, c, m0, m1, oo, dd, tt: ji.chunk_roots(
            k[None], a[None], b[None], c[None], m0[None], m1[None],
            p.has_motion, oo[None], dd[None], tt[None],
            has_box=p.has_box))
        r1, r2 = f(kind_j, p0, e1, e2, rows_j[4], rows_j[5], o_, d_, tm_)
        return r1[:, 0, 0], r2[:, 0, 0]

    (jr1, jr2), vjp = jax.vjp(jroots, rows_j[1], rows_j[2], rows_j[3],
                              jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    fin1, fin2 = np.isfinite(np.asarray(jr1)), np.isfinite(np.asarray(jr2))
    c1 = jnp.asarray(np.where(fin1, ct_t, 0.0).astype(np.float32))
    c2 = jnp.asarray(np.where(fin2, ct_t, 0.0).astype(np.float32))
    jg = vjp((c1, c2))
    t_in = [x.clone().requires_grad_(True) for x in rows_t[1:4]] + [
        _t(o).requires_grad_(True), _t(d).requires_grad_(True),
        _t(tm).requires_grad_(True)]
    r1, r2 = ti.chunk_roots_rows(kind_t, *t_in[:3], rows_t[4], rows_t[5],
                                 p.has_motion, *t_in[3:], has_box=p.has_box)
    assert np.array_equal(np.isfinite(r1.detach().numpy()), fin1)
    r1s = torch.where(torch.isfinite(r1), r1, 0.0)
    r2s = torch.where(torch.isfinite(r2), r2, 0.0)
    tg = torch.autograd.grad((r1s, r2s), t_in, (_t(c1), _t(c2)),
                             allow_unused=True)
    for k, (a, b) in enumerate(zip(jg, tg)):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.all(np.isfinite(b)), (name, k)
        scale = np.linalg.norm(a) + 1e-12
        assert np.linalg.norm(a - b) <= 1e-4 * scale + 1e-6, (name, k)
