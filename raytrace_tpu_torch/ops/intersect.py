"""Differentiable ray-primitive roots and hit records
(``raytrace_tpu/ops/intersect.py``).

The kernels (``ops/intersect_kernel.py`` and the others) find each ray's
nearest hit; this module recomputes roots and records in plain torch, in
the JAX package's association, where a gradient has to flow through them:
the winner-only backward of the surface hit (``ops/diff_intersect.py``)
and of the media's boundary crossings (``render/volumes.py``).

* :func:`chunk_roots` — the candidate ray parameters ``(r1, r2)`` of R
  rays against C rows ([R, C]); :func:`chunk_roots_rows` the same for
  each ray against its own row ([R]).  Spheres and boxes give their near
  and far roots, parallelograms and triangles their plane hit (membership
  applied) in ``r1``; ``+inf`` where there is no candidate.
* :func:`roots_to_hit_t` — the nearest root strictly inside the open
  interval, else the far one, else a miss.
* :func:`single_prim_t_rows` and :func:`make_hit_record_rows` — the hit
  parameter and the record (normal facing the ray, front flag, uv) of
  each ray against its own gathered row.
* :func:`apply_sphere_rotations` — the outward normals of rotated sphere
  instances turned into object space, where their uv is evaluated.
* :func:`dense_nearest` — the nearest hit over a whole table in one
  [R, N] tile: the tests' oracle.
* :func:`bvh_nearest` — the nearest hit by a per-ray walk of the BVH
  accelerator mode's threaded tree (``Scene.bvh``), and
  :func:`nearest_hit_t`, which picks it or :func:`dense_nearest`: the
  CPU route of a scene compiled in the BVH mode (on the card the
  nearest-hit kernel K9 walks a tree of its own over the same rows).

Rows come as ``(kind, p0, e1, e2, mv0, mv1)`` (plus ``uvs`` for a
record): ``p0`` is a sphere's center (``e1[..., 0]`` its radius), a
plane's corner, a box's low corner (``e1`` its high one); ``mv0``/``mv1``
the motion displacements at time 0 and 1.  Rotated sphere instances
list their rows' world-to-object rotations in ``sphere_rots``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vecmath import DTYPE, take_rows, vcross
from ..scene.types import (
    PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE,
)

INF = float("inf")
DENOM_EPS = 1e-8   # the plane denominator's guard


class HitRecord(NamedTuple):
    t: torch.Tensor        # [R]
    point: torch.Tensor    # [R, 3]
    normal: torch.Tensor   # [R, 3] unit, facing the ray
    front: torch.Tensor    # bool [R]
    uv: torch.Tensor       # [R, 2]
    mat: torch.Tensor      # [R]
    hit: torch.Tensor      # bool [R]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _plane_frame(e1, e2):
    """``(degen, n_unit, n_s)`` of the planes spanned by ``e1``, ``e2``:
    zero-area rows get a dummy normal (so that ``1 / |cp|^2`` cannot
    overflow into NaN gradients) and are flagged."""
    cp = vcross(e1, e2)
    cp_sq_raw = _dot(cp, cp)
    degen = cp_sq_raw < 1e-24
    cp = torch.where(degen[..., None],
                     torch.tensor([0.0, 0.0, 1.0], dtype=DTYPE,
                                  device=cp.device), cp)
    cp_sq = torch.where(degen, 1.0, cp_sq_raw)
    n_unit = cp * torch.rsqrt(cp_sq)[..., None]
    n_s = cp / cp_sq[..., None]
    return degen, n_unit, n_s


def _safe_inv(x):
    return 1.0 / torch.where(torch.abs(x) < 1e-20,
                             torch.where(x < 0, -1e-20, 1e-20), x)


def _roots(kind, p0, e1, e2, mv0, mv1, has_motion, o, d, tr, has_box):
    """:func:`chunk_roots`' arithmetic on tensors that broadcast: rows
    [..., 3] against rays [..., 3], ``tr`` the rays' time."""
    is_sphere = kind == PRIM_SPHERE
    is_para = kind == PRIM_PARALLELOGRAM
    is_tri = kind == PRIM_TRIANGLE
    if has_motion:
        dmv = mv1 - mv0
    # sphere: the half-b quadratic
    center, radius = p0, e1[..., 0]
    d_dot_c = _dot(d, center)
    o_dot_c = _dot(o, center)
    o_sq = _dot(o, o)
    c_sq = _dot(center, center)
    if has_motion:
        h = (d_dot_c + _dot(d, mv0) + tr * _dot(d, dmv) - _dot(d, o))
        shift_sq = (_dot(mv0, mv0) + 2.0 * tr * _dot(mv0, dmv)
                    + tr * tr * _dot(dmv, dmv))
        c_shift = _dot(center, mv0) + tr * _dot(center, dmv)
        o_shift = _dot(o, mv0) + tr * _dot(o, dmv)
        oc_sq = (c_sq + 2.0 * c_shift + shift_sq - 2.0 * (o_dot_c + o_shift)
                 + o_sq)
    else:
        h = d_dot_c - _dot(d, o)
        oc_sq = c_sq - 2.0 * o_dot_c + o_sq
    disc = h * h - (oc_sq - radius * radius)
    sphere_ok = disc >= 0.0
    # sqrt'(0) = inf would reach the masked branch's gradient: feed it a
    # safe value where there is no root
    sq = torch.sqrt(torch.where(sphere_ok, torch.clamp(disc, min=1e-20), 1.0))
    s_r1 = h - sq
    s_r2 = h + sq

    # planes: a = p_rel . w_a, b = p_rel . w_b
    degen, n_unit, n_s = _plane_frame(e1, e2)
    w_a = vcross(e2, n_s)
    w_b = vcross(n_s, e1)
    denom = _dot(d, n_unit)
    q_dot_n = _dot(p0, n_unit)
    q_dot_wa = _dot(p0, w_a)
    q_dot_wb = _dot(p0, w_b)
    if has_motion:
        q_dot_n = q_dot_n + _dot(n_unit, mv0) + tr * _dot(n_unit, dmv)
        q_dot_wa = q_dot_wa + _dot(w_a, mv0) + tr * _dot(w_a, dmv)
        q_dot_wb = q_dot_wb + _dot(w_b, mv0) + tr * _dot(w_b, dmv)
    den_ok = torch.abs(denom) > DENOM_EPS
    t_plane = (q_dot_n - _dot(o, n_unit)) / torch.where(den_ok, denom, 1.0)
    a = _dot(o, w_a) - q_dot_wa + t_plane * _dot(d, w_a)
    b = _dot(o, w_b) - q_dot_wb + t_plane * _dot(d, w_b)
    member_para = (0.0 <= a) & (a <= 1.0) & (0.0 <= b) & (b <= 1.0)
    member_tri = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    plane_ok = den_ok & ~degen & torch.where(is_para, member_para, member_tri)

    r1 = torch.where(is_sphere, torch.where(sphere_ok, s_r1, INF),
                     torch.where((is_para | is_tri) & plane_ok, t_plane, INF))
    r2 = torch.where(is_sphere & sphere_ok, s_r2, INF)
    if has_box:
        # the slab test: entry and exit play the sphere roots' roles
        tn = tf = None
        for ax in range(3):
            inv = _safe_inv(d[..., ax])
            lo, hi = p0[..., ax], e1[..., ax]
            if has_motion:
                sh = mv0[..., ax] + tr * dmv[..., ax]
                lo, hi = lo + sh, hi + sh
            t0 = (lo - o[..., ax]) * inv
            t1 = (hi - o[..., ax]) * inv
            lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = lo_t if tn is None else torch.maximum(tn, lo_t)
            tf = hi_t if tf is None else torch.minimum(tf, hi_t)
        box_ok = (kind == PRIM_BOX) & (tn <= tf)
        r1 = torch.where(box_ok, tn, r1)
        r2 = torch.where(box_ok, tf, r2)
    return r1, r2


def chunk_roots(kind, p0, e1, e2, mv0, mv1, has_motion, o, d, time,
                has_box: bool = False):
    """Candidate roots ``(r1, r2)`` [R, C] of the rays ``o``, ``d`` [R, 3]
    at ``time`` [R] against the rows ``kind`` [C], ``p0``, ``e1``, ``e2``,
    ``mv0``, ``mv1`` [C, 3].  Interval clipping is the caller's."""
    row = lambda x: x[None]
    return _roots(row(kind), row(p0), row(e1), row(e2), row(mv0), row(mv1),
                  has_motion, o[:, None], d[:, None], time[:, None], has_box)


def chunk_roots_rows(kind, p0, e1, e2, mv0, mv1, has_motion, o, d, time,
                     has_box: bool = False):
    """:func:`chunk_roots` of each ray against its own row (every input
    [R] or [R, 3]): ``(r1, r2)`` [R]."""
    return _roots(kind, p0, e1, e2, mv0, mv1, has_motion, o, d, time,
                  has_box)


def roots_to_hit_t(r1, r2, tmin, tmax):
    """The nearest root strictly inside ``(tmin, tmax)``, else the far
    root, else +inf."""
    ok1 = (tmin < r1) & (r1 < tmax)
    ok2 = (tmin < r2) & (r2 < tmax)
    return torch.where(ok1, r1, torch.where(ok2, r2, INF))


def box_roots_rows(lo, hi, o, d):
    """Slab entry and exit of each ray against its own box (``lo``,
    ``hi`` [R, 3]): ``(tn, tf, tn <= tf)``."""
    t0 = (lo - o) / torch.where(torch.abs(d) < 1e-20,
                                torch.where(d < 0, -1e-20, 1e-20), d)
    t1 = (hi - o) / torch.where(torch.abs(d) < 1e-20,
                                torch.where(d < 0, -1e-20, 1e-20), d)
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tn, tf, tn <= tf


def single_prim_t_rows(rows, has_motion, o, d, time, tmin, tmax,
                       has_box: bool = False):
    """The hit parameter of each ray against its own row ``rows = (kind,
    p0, e1, e2, mv0, mv1)`` within ``(tmin, tmax)`` (+inf on a miss), in
    the association of the JAX package's ``_single_prim_t_rows``."""
    kind, p0, e1, e2, mv0, mv1 = rows
    if has_motion:
        o = o - (mv0 + time[:, None] * (mv1 - mv0))
    is_sphere = kind == PRIM_SPHERE
    oc = p0 - o
    h = _dot(d, oc)
    disc = h * h - (_dot(oc, oc) - e1[:, 0] * e1[:, 0])
    sq = torch.sqrt(torch.where(disc >= 0.0, torch.clamp(disc, min=1e-20),
                                1.0))
    s_r1, s_r2 = h - sq, h + sq
    degen, n_unit, n_s = _plane_frame(e1, e2)
    denom = _dot(n_unit, d)
    den_ok = torch.abs(denom) > DENOM_EPS
    t_plane = _dot(n_unit, p0 - o) / torch.where(den_ok, denom, 1.0)
    p_rel = o + t_plane[:, None] * d - p0
    a = _dot(n_s, vcross(p_rel, e2))
    b = _dot(n_s, vcross(e1, p_rel))
    member = torch.where(kind == PRIM_PARALLELOGRAM,
                         (0.0 <= a) & (a <= 1.0) & (0.0 <= b) & (b <= 1.0),
                         (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0))
    plane_ok = den_ok & ~degen & member
    r1 = torch.where(is_sphere, torch.where(disc >= 0.0, s_r1, INF),
                     torch.where(plane_ok, t_plane, INF))
    r2 = torch.where(is_sphere & (disc >= 0.0), s_r2, INF)
    if has_box:
        tn, tf, ok = box_roots_rows(p0, e1, o, d)
        box_ok = (kind == PRIM_BOX) & ok
        r1 = torch.where(box_ok, tn, r1)
        r2 = torch.where(box_ok, tf, r2)
    return roots_to_hit_t(r1, r2, tmin, tmax)


def apply_sphere_rotations(outward, idx, sphere_rots: tuple):
    """``outward`` [R, 3] with the rows ``idx`` [R] listed in
    ``sphere_rots`` (``((row, 9-float world->object rotation), ...)``,
    the compiler's instancing rotations) rotated into object space: the
    reference evaluates a sphere's uv on the inverse-transformed ray, so a
    rotated image-textured sphere shows a rotated texture.  Rotated
    spheres are rare (demo2 has one), so each listed row is a compare and
    a select, with the rotation's entries as constants; only the uv reads
    the result (shading normals stay in world space)."""
    if not sphere_rots:
        return outward
    x, y, z = outward.unbind(-1)
    out = outward
    for row, r in sphere_rots:
        rot = torch.stack([r[0] * x + r[1] * y + r[2] * z,
                           r[3] * x + r[4] * y + r[5] * z,
                           r[6] * x + r[7] * y + r[8] * z], dim=-1)
        out = torch.where((idx == row)[:, None], rot, out)
    return out


def make_hit_record_rows(rows, has_motion, mat, idx, o, d, time, t,
                         has_box: bool = False,
                         sphere_rots: tuple = ()) -> HitRecord:
    """The hit record of each ray at ``t`` on its own row ``rows = (kind,
    p0, e1, e2, mv0, mv1, uvs)`` (``uvs`` [R, 3, 2]); ``idx`` is the row's
    index (-1 on a miss).  The normal faces the ray; the front flag and
    the box face are piecewise constant, so they carry no gradient.  A
    sphere's uv is evaluated in object space: the rows of ``sphere_rots``
    (:func:`apply_sphere_rotations`) rotate its outward normal first."""
    kind, p0, e1, e2, mv0, mv1, uvs = rows
    if has_motion:
        shift = mv0 + time[:, None] * (mv1 - mv0)
        p0 = p0 + shift
        if has_box:
            e1 = torch.where((kind == PRIM_BOX)[:, None], e1 + shift, e1)
    point = o + t[:, None] * d
    is_sphere = (kind == PRIM_SPHERE)[:, None]

    # sphere: outward normal, polar uv (atan2 fed safe values at the poles)
    radius = torch.where(torch.abs(e1[:, 0]) > 0, e1[:, 0], 1.0)
    outward = (point - p0) / radius[:, None]
    s_front = _dot(d, outward) <= 0.0
    s_normal = torch.where(s_front[:, None], outward, -outward)
    outward_uv = apply_sphere_rotations(outward, idx, sphere_rots)
    xz_ok = outward_uv[:, 0] ** 2 + outward_uv[:, 2] ** 2 > 1e-12
    ox = torch.where(xz_ok, outward_uv[:, 0], 0.0)
    oz = torch.where(xz_ok, outward_uv[:, 2], 1.0)
    s_u = torch.atan2(ox, oz) / (2.0 * torch.pi) + 0.5
    s_v = torch.arccos(torch.clamp(-outward_uv[:, 1], -1.0 + 1e-6,
                                   1.0 - 1e-6)) / torch.pi
    s_uv = torch.stack([s_u, s_v], dim=-1)

    # planes
    degen, n_unit, n_s = _plane_frame(e1, e2)
    p_rel = point - p0
    a = _dot(n_s, vcross(p_rel, e2))
    b = _dot(n_s, vcross(e1, p_rel))
    p_front = _dot(n_unit, d) < 0.0
    p_normal = torch.where(p_front[:, None], n_unit, -n_unit)
    tri_uv = ((1.0 - a - b)[:, None] * uvs[:, 0] + a[:, None] * uvs[:, 1]
              + b[:, None] * uvs[:, 2])
    p_uv = torch.where((kind == PRIM_TRIANGLE)[:, None], tri_uv,
                       torch.stack([a, b], dim=-1))

    normal = torch.where(is_sphere, s_normal, p_normal)
    front = torch.where(is_sphere[:, 0], s_front, p_front)
    uv = torch.where(is_sphere, s_uv, p_uv)

    if has_box:
        # the face of the dominant offset from the center, with the
        # reference cuboid's uv winding per face
        is_box = (kind == PRIM_BOX)[:, None]
        lo, hi = p0, e1
        size = torch.clamp(hi - lo, min=1e-12)
        rel = (point - 0.5 * (lo + hi)) / size
        arel = torch.abs(rel)
        ax_x = (arel[:, 0] >= arel[:, 1]) & (arel[:, 0] >= arel[:, 2])
        ax_y = ~ax_x & (arel[:, 1] >= arel[:, 2])
        ax_z = ~ax_x & ~ax_y
        sgn = torch.sign(torch.where(rel == 0.0, 1.0, rel))
        axes = torch.stack([ax_x, ax_y, ax_z], dim=-1)
        b_out = torch.where(axes, sgn, 0.0)
        b_front = _dot(d, b_out) < 0.0
        b_normal = torch.where(b_front[:, None], b_out, -b_out)
        f = (point - lo) / size
        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        pos = sgn > 0.0
        b_a = torch.where(ax_z, torch.where(pos[:, 2], fx, 1.0 - fx),
                          torch.where(ax_x, torch.where(pos[:, 0], 1.0 - fz,
                                                        fz), fx))
        b_b = torch.where(ax_y, torch.where(pos[:, 1], 1.0 - fz, fz), fy)
        normal = torch.where(is_box, b_normal, normal)
        front = torch.where(is_box[:, 0], b_front, front)
        uv = torch.where(is_box, torch.stack([b_a, b_b], dim=-1), uv)
    return HitRecord(t=t, point=point, normal=normal, front=front, uv=uv,
                     mat=mat, hit=(idx >= 0) & torch.isfinite(t))


def gather_rows(prims, idx, with_uvs: bool = True):
    """The rows ``(kind, p0, e1, e2, mv0, mv1[, uvs])`` of ``prims`` at
    ``max(idx, 0)`` (``core/vecmath.py:take_rows``: its backward adds the
    rows' cotangents into the tables)."""
    pi = torch.clamp(idx, min=0).long()
    rows = (prims.kind[pi],) + tuple(take_rows(x, pi) for x in (
        prims.p0, prims.e1, prims.e2, prims.mv0, prims.mv1))
    return rows + (take_rows(prims.uvs, pi),) if with_uvs else rows


def make_hit_record(prims, idx, o, d, time, t) -> HitRecord:
    """:func:`make_hit_record_rows` of the rows ``idx`` of ``prims``."""
    return make_hit_record_rows(gather_rows(prims, idx), prims.has_motion,
                                prims.mat[torch.clamp(idx, min=0).long()],
                                idx, o, d, time, t, has_box=prims.has_box,
                                sphere_rots=prims.sphere_rots)


def dense_nearest(prims, o, d, time, tmin, tmax):
    """``(t, idx)`` [R]: the nearest hit of each ray over every row of
    ``prims`` in one [R, N] tile, the lowest row winning a tie (idx -1 and
    t +inf on a miss).  The tests' oracle of the nearest-hit kernels."""
    r1, r2 = chunk_roots(prims.kind, prims.p0, prims.e1, prims.e2, prims.mv0,
                         prims.mv1, prims.has_motion, o, d, time,
                         has_box=prims.has_box)
    t = roots_to_hit_t(r1, r2, tmin[:, None], tmax[:, None])
    best = torch.amin(t, dim=1)
    idx = torch.where(torch.isfinite(best), torch.argmin(t, dim=1), -1)
    return best, idx.to(torch.int32)


def bvh_nearest(prims, bvh, o, d, time, tmin, tmax):
    """``(t, idx)`` [R]: the nearest hit of each ray by a walk of the
    threaded tree ``bvh`` (``scene/types.py:BVH``) over the rows of
    ``prims`` in leaf order (the JAX package's ``bvh_nearest``): each ray
    keeps its node cursor and its best t; a node whose box the ray
    crosses within ``[tmin, min(tmax, best t)]`` leads to its first child
    or tests its leaf's rows, any other to its escape index.  A row
    replaces the best hit only if strictly nearer, so of equally near
    rows the first one walked wins.  Rays still walking are compacted
    every step (each ray's result is that of the lock-step walk).  A leaf
    is tested up to the tree's widest leaf, so a tree of any
    ``compile_scene(leaf_size=...)`` is walked whole."""
    n_nodes = bvh.n_nodes
    dev = o.device
    r = o.shape[0]
    n_rows = prims.kind.shape[0]
    best_t = torch.full((r,), INF, dtype=DTYPE, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    lanes = torch.arange(r, device=dev)
    inv_d = 1.0 / d
    lo, hi = bvh.lo.to(dev), bvh.hi.to(dev)
    start, count = bvh.start.to(dev).long(), bvh.count.to(dev).long()
    skip = bvh.skip.to(dev).long()
    leaf_width = int(count.max()) if n_nodes else 0
    while lanes.numel():
        ni = node
        o_l, d_l, inv_l = o[lanes], d[lanes], inv_d[lanes]
        tmin_l, tmax_l = tmin[lanes], tmax[lanes]
        bt = best_t[lanes]
        t0 = (lo[ni] - o_l) * inv_l
        t1 = (hi[ni] - o_l) * inv_l
        t_near = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1),
                               tmin_l)
        t_far = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1),
                              torch.minimum(tmax_l, bt))
        hit_box = t_near <= t_far
        cnt = count[ni]
        is_leaf = cnt > 0
        leaf = hit_box & is_leaf
        if bool(leaf.any()):
            sel = torch.nonzero(leaf).squeeze(1)
            lane_s = lanes[sel]
            st, cn = start[ni[sel]], cnt[sel]
            bts, bis = best_t[lane_s], best_i[lane_s]
            for j in range(leaf_width):
                pi = torch.clamp(st + j, max=n_rows - 1)
                rows = (prims.kind[pi], prims.p0[pi], prims.e1[pi],
                        prims.e2[pi], prims.mv0[pi], prims.mv1[pi])
                t = single_prim_t_rows(rows, prims.has_motion, o[lane_s],
                                       d[lane_s], time[lane_s],
                                       tmin[lane_s],
                                       torch.minimum(tmax[lane_s], bts),
                                       has_box=prims.has_box)
                better = (j < cn) & (t < bts)
                bts = torch.where(better, t, bts)
                bis = torch.where(better, pi.to(torch.int32), bis)
            best_t[lane_s] = bts
            best_i[lane_s] = bis
        nxt = torch.where(hit_box & ~is_leaf, ni + 1, skip[ni])
        going = nxt < n_nodes
        lanes, node = lanes[going], nxt[going]
    return best_t, best_i


def nearest_hit_t(prims, bvh, o, d, time, tmin, tmax):
    """``(t, idx)`` [R]: :func:`bvh_nearest` over the BVH mode's tree
    ``bvh``, or :func:`dense_nearest` where ``bvh`` is None (the JAX
    package's ``nearest_hit_t``)."""
    if bvh is not None:
        return bvh_nearest(prims, bvh, o, d, time, tmin, tmax)
    return dense_nearest(prims, o, d, time, tmin, tmax)
