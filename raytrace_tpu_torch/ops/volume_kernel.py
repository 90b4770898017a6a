"""Boundary crossings of constant-density media
(``raytrace_tpu/ops/pallas/volume_kernel.py``).

For every ray and every medium, the ray's first boundary crossing strictly
beyond ``t_min``, whether that crossing enters (a sphere's or box's near
root, a plane approached from its normal side), and the next crossing
strictly beyond the first (so a shared mesh edge is one crossing).  Rows
fold in table order, each row's entering root before its exit root, with a
strict ``<``: on an exact tie the earlier candidate keeps the front flag.

* :func:`volume_crossings_plain` is the plain PyTorch version of both
  kernels: each medium's rows in the 256-row chunks of
  :func:`_chunk_plans` as ``[rows, lanes]`` tensors, each chunk reduced
  with the tile rules of the TPU's broadcast kernel and merged into the
  carried triple.  It culls nothing (culling only skips work).
* :func:`pallas_volume_crossings` (kernel K11, ``rt_volume_crossings``:
  the whole table staged once per block, a planar instantiation for
  tables of unmoving parallelograms and triangles) and
  :func:`pallas_volume_crossings_bcast` (kernel K11b,
  ``rt_volume_crossings_bvh``, for boundary tables of
  :data:`BCAST_MIN_ROWS` rows and more: a near-child-first walk of one
  binned-SAH tree per medium, :func:`pack_volume_bvh`, that skips every
  node a ray cannot reach before its second crossing) launch
  ``csrc/volume_kernel.cu`` for CUDA tensors and run the plain version
  for CPU tensors.
* Their candidate mode (:func:`pallas_volume_candidates`,
  :func:`pallas_volume_candidates_bcast`; plain version
  :func:`volume_candidates_plain`) folds each medium's scatter candidate
  (:func:`candidate_from_crossings`) into the nearest ``(t_med, vmat)``
  inside the launch, which the bounce then reads.
* Their keyed mode (:func:`pallas_volume_crossings_keyed`,
  :func:`pallas_volume_crossings_bcast_keyed`; plain version
  :func:`volume_crossings_plain` with ``keys=True``) also writes, per
  medium, the keys of the candidates the two crossings come from, which
  the differentiable media path's backward reads
  (``render/volumes.py:DiffCrossings``).
* :func:`prepare_volume_launch` checks a launch's tables once per driver
  call and prebuilds its argument struct (:class:`VolumeLaunch`).

The crossings are the 3V rows ``[t1_0, front1_0, t2_0, t1_1, ...]`` as
[R] f32 tensors (front as 0/1).  Rays are 1-D [R] f32 tensors; the table
is ``pack_prims(volumes.prims)`` ([C, 36], ``ops/intersect_kernel.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import time

import numpy as np
import torch

from ..scene.types import PRIM_TRIANGLE
from ._build import launch
from .allpairs_kernel import (
    N_NODE_COLS, build_tree, bvh_boxes, leaf_rows, pack_nodes,
)
from .bounce_kernel import check_lanes, planar_only
from .intersect_kernel import N_COLS, _safe

BCAST_CHUNK = 256      # rows per chunk of the plain version's plan
BCAST_MIN_ROWS = 64    # boundary tables from this many rows take K11b
# media one launch takes (csrc/volume_kernel.cu); render/volumes.py
# launches once per group of at most this many
MAX_VOLUMES = 16
# boundary rows K11 stages in shared memory (221,184 bytes; the routes
# give it under BCAST_MIN_ROWS)
MAX_STAGED_ROWS = 1536
# (row, lane) pairs per block of the plain version: its ~30 live [rows,
# lanes] f32 tensors stay near 256 MiB
_PAIR_BUDGET = 1 << 21
_INF = float("inf")


def _chunk_plans(slices) -> tuple:
    """Per volume, the ``(start, length)`` chunks covering its slice:
    starts aligned down to 8 rows, lengths up to :data:`BCAST_CHUNK` (the
    JAX package's plan, the plain version's tile order; a chunk's rows
    outside the slice are masked)."""
    plans = []
    for start, count in slices:
        chunks = []
        p = (start // 8) * 8
        end = start + count
        while p < end:
            ln = min(BCAST_CHUNK, -(-(end - p) // 8) * 8)
            chunks.append((p, ln))
            p += ln
        plans.append(tuple(chunks))
    return tuple(plans)


@dataclasses.dataclass(frozen=True)
class VolumeBVH:
    """A forest of binned-SAH trees of two-box nodes, one per medium,
    over the boundary table's rows (``ops/allpairs_kernel.py:DeviceBVH``'s
    layout): ``nodes`` [n_nodes, 16] f32 holds every medium's tree, its
    interior words global node indices and its leaf words positions in
    ``rows``; ``rows`` [n_real, 36] is a copy of the boundary rows in
    leaf order, column ``ORIG_COL`` holding each row's index in the
    packed boundary table (the fold's tie key); ``roots`` the root node
    of each medium; ``tri_only``: every row is an unmoving triangle (the
    walk's triangle-only test); ``depth`` the deepest tree's interior
    nodes on a path (at most ``STACK_SIZE``); ``build_s`` the host build
    time."""
    nodes: torch.Tensor
    rows: torch.Tensor
    roots: tuple
    tri_only: bool
    depth: int
    build_s: float

    def group(self, v0: int, v1: int) -> "VolumeBVH":
        """The forest of media ``[v0, v1)`` (one launch's group): the same
        arrays, their roots."""
        return dataclasses.replace(self, roots=self.roots[v0:v1])


def pack_volume_bvh(prims, vtbl, slices) -> VolumeBVH:
    """Build the forest of :class:`VolumeBVH` for the media ``slices``
    ((start, count) per medium) of the boundary ``prims`` packed as
    ``vtbl``, on the device of ``vtbl``.  Each medium's real rows get one
    ``build_sah_bvh`` tree, boxed and padded as ``pack_bvh`` boxes a
    table (``bvh_boxes``: outward by ``NODE_PAD_*``, swept over the
    motion, rounded outward to f32); raises if a tree is deeper than the
    walk's stack."""
    t0 = time.perf_counter()
    real, lo, hi = bvh_boxes(prims, vtbl.shape[0])
    packed, order, roots = [], [], []
    n_nodes = n_rows = depth = 0
    for start, count in slices:
        sel = np.nonzero((real >= start) & (real < start + count))[0]
        if sel.size == 0:
            raise ValueError(f"pack_volume_bvh: the medium of rows "
                             f"[{start}, {start + count}) has no real row")
        perm, nodes, d = build_tree(lo[sel], hi[sel], "pack_volume_bvh")
        packed.append(pack_nodes(nodes, n_nodes, n_rows))
        order.append(real[sel][perm])
        roots.append(n_nodes)
        n_nodes += packed[-1].shape[0]
        n_rows += sel.size
        depth = max(depth, d)
    nodes = np.concatenate(packed).reshape(-1, N_NODE_COLS)
    rows = leaf_rows(vtbl, np.concatenate(order))
    tri_only = (not prims.has_motion
                and bool((rows[:, 16] == float(PRIM_TRIANGLE)).all()))
    return VolumeBVH(nodes=torch.from_numpy(nodes).to(vtbl.device),
                     rows=rows, roots=tuple(roots), tri_only=tri_only,
                     depth=depth, build_s=time.perf_counter() - t0)


def _crossing_cand(col, ox, oy, oz, dx, dy, dz, tm, inv, tmn: float,
                   has_motion: bool, has_box: bool):
    """``(c1, cf1, c2)`` [L, W] of one chunk of rows (``col(k)``: column
    ``k`` as [L, 1]) against rays [1, W]: the entering or planar root and
    its front flag, and the exit root (the association of the TPU
    kernels' ``_crossing_cand``)."""
    kindc = col(16)
    cx, cy, cz = col(0), col(1), col(2)
    if has_motion:
        sx = col(24) + tm * col(27)
        sy = col(25) + tm * col(28)
        sz = col(26) + tm * col(29)
        cx, cy, cz = cx + sx, cy + sy, cz + sz
    # sphere: both roots
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = ocx * dx + ocy * dy + ocz * dz
    disc = h * h - (ocx * ocx + ocy * ocy + ocz * ocz - col(3))
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ok_s = (disc >= 0.0) & (kindc == 0.0)
    s1 = h - sq
    s2 = h + sq
    # parallelogram / triangle: one root inside the edges
    nx, ny, nz = col(4), col(5), col(6)
    wax, way, waz = col(7), col(8), col(9)
    wbx, wby, wbz = col(10), col(11), col(12)
    qn, qwa, qwb = col(13), col(14), col(15)
    if has_motion:
        qn = qn + sx * nx + sy * ny + sz * nz
        qwa = qwa + sx * wax + sy * way + sz * waz
        qwb = qwb + sx * wbx + sy * wby + sz * wbz
    den = nx * dx + ny * dy + nz * dz
    den_ok = torch.abs(den) > 1e-8
    t_p = (qn - (nx * ox + ny * oy + nz * oz)) / torch.where(den_ok, den, 1.0)
    a = (wax * ox + way * oy + waz * oz) - qwa \
        + t_p * (wax * dx + way * dy + waz * dz)
    b = (wbx * ox + wby * oy + wbz * oz) - qwb \
        + t_p * (wbx * dx + wby * dy + wbz * dz)
    bound = torch.where(kindc == 2.0, a + b, torch.maximum(a, b))
    ok_p = (den_ok & (a >= 0.0) & (b >= 0.0) & (bound <= 1.0)
            & (kindc > 0.5) & (kindc < 2.5))
    c1 = torch.where(kindc == 0.0, torch.where(ok_s & (s1 > tmn), s1, _INF),
                     torch.where(ok_p & (t_p > tmn), t_p, _INF))
    cf1 = torch.where(kindc == 0.0, 1.0,
                      torch.where(den < 0.0, 1.0, 0.0)).expand_as(c1)
    c2 = torch.where(ok_s & (s2 > tmn), s2, _INF)
    if has_box:
        # slab roots: the entry enters, the exit exits
        ivx, ivy, ivz = inv
        hix, hiy, hiz = col(7), col(8), col(9)
        if has_motion:
            hix, hiy, hiz = hix + sx, hiy + sy, hiz + sz
        t0x, t1x = (cx - ox) * ivx, (hix - ox) * ivx
        t0y, t1y = (cy - oy) * ivy, (hiy - oy) * ivy
        t0z, t1z = (cz - oz) * ivz, (hiz - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        is_box = kindc == 3.0
        ok_b = (tn <= tf) & is_box
        c1 = torch.where(is_box, torch.where(ok_b & (tn > tmn), tn, _INF), c1)
        cf1 = torch.where(is_box, 1.0, cf1)
        c2 = torch.where(is_box, torch.where(ok_b & (tf > tmn), tf, _INF), c2)
    return c1, cf1, c2


def _merge_chunk(b1, f1, b2, c1, cf1, c2, piota, keys=None):
    """Fold a chunk's candidates [L, W] into the carried triple [1, W]:
    the chunk's smallest crossing with the flag of its first attainment
    (lowest row; a row's entering root before its exit root) and its
    smallest crossing strictly beyond, merged with a strict ``<``.

    With ``keys`` = the carried ``(k1, k2)`` [1, W] (f32, +inf for none),
    also the key ``2 * row + slot`` of the candidate each crossing comes
    from (slot 0 the entering or planar root, 1 the exit root), the lowest
    key on a tie; returns ``(b1, f1, b2, (k1, k2))`` then."""
    t1t = torch.minimum(c1.amin(0, keepdim=True), c2.amin(0, keepdim=True))
    p1 = torch.where(c1 == t1t, piota, _INF).amin(0, keepdim=True)
    p2 = torch.where(c2 == t1t, piota, _INF).amin(0, keepdim=True)
    fc1 = torch.where((c1 == t1t) & (piota == p1), cf1, 0.0) \
        .amax(0, keepdim=True)
    f1t = torch.where(p1 <= p2, fc1, 0.0)
    t2t = torch.minimum(torch.where(c1 > t1t, c1, _INF).amin(0, keepdim=True),
                        torch.where(c2 > t1t, c2, _INF).amin(0, keepdim=True))
    nb1 = torch.minimum(b1, t1t)
    f1 = torch.where(t1t < b1, f1t, f1)

    def gtv(x):
        return torch.where(x > nb1, x, _INF)
    nb2 = torch.minimum(torch.minimum(gtv(b1), gtv(b2)),
                        torch.minimum(gtv(t1t), gtv(t2t)))
    if keys is None:
        return nb1, f1, nb2
    k1, k2 = keys

    def chunk_key(t):
        # the lowest key of the chunk's candidates equal to t
        return torch.minimum(
            torch.where(c1 == t, 2.0 * piota, _INF).amin(0, keepdim=True),
            torch.where(c2 == t, 2.0 * piota + 1.0, _INF)
            .amin(0, keepdim=True))
    kt1, kt2 = chunk_key(t1t), chunk_key(t2t)
    nk1 = torch.where(t1t < b1, kt1, k1)
    nk2 = torch.full_like(nk1, _INF)
    for x, k in ((b1, k1), (b2, k2), (t1t, kt1), (t2t, kt2)):
        nk2 = torch.where((x > nb1) & (x == nb2), torch.minimum(nk2, k), nk2)
    return nb1, f1, nb2, (nk1, nk2)


def volume_crossings_plain(vtbl, ox, oy, oz, dx, dy, dz, tm, *,
                           slices: tuple, t_min: float, has_motion: bool,
                           has_box: bool, prepared=None, keys: bool = False):
    """Both kernels' function in plain PyTorch, on any device: the 3V
    [R] rows ``[t1, front1, t2]`` per volume of ``slices`` ((start,
    count) per volume).  ``prepared`` (the kernels' prepared launch) is
    accepted and ignored.

    ``keys=True`` (the keyed mode) returns ``(crossings, keys)``: also the
    2V [R] i32 rows ``[k1, k2]`` per volume, the key ``2 * row + slot``
    (``row`` in the packed table; slot 0 the entering or planar root, 1
    the exit root) of the candidate that attains ``t1`` and ``t2``, the
    lowest key on a tie, -1 where the crossing is +inf."""
    tmn = float(torch.tensor(t_min, dtype=torch.float32))
    plans = _chunk_plans(slices)
    r = ox.shape[0]
    outs = [torch.empty(r, dtype=torch.float32, device=ox.device)
            for _ in range(3 * len(slices))]
    kouts = [torch.empty(r, dtype=torch.int32, device=ox.device)
             for _ in range(2 * len(slices) if keys else 0)]
    block = _PAIR_BUDGET // max(min(c, BCAST_CHUNK) for _, c in slices)
    for l0 in range(0, r, block):
        rays = [x[l0:l0 + block][None, :]
                for x in (ox, oy, oz, dx, dy, dz, tm)]
        w = rays[0].shape[1]
        inv = tuple(1.0 / _safe(x) for x in rays[3:6]) if has_box else None
        for v, ((start, count), plan) in enumerate(zip(slices, plans)):
            b1 = torch.full((1, w), _INF, device=ox.device)
            f1 = torch.zeros((1, w), device=ox.device)
            b2 = torch.full((1, w), _INF, device=ox.device)
            kk = (b1, b2) if keys else None
            for p, ln in plan:
                a, b = max(p, start), min(p + ln, start + count)
                rows = vtbl[a:b]
                piota = torch.arange(a, b, device=ox.device,
                                     dtype=torch.float32)[:, None]
                c1, cf1, c2 = _crossing_cand(
                    lambda k: rows[:, k:k + 1], *rays, inv, tmn, has_motion,
                    has_box)
                b1, f1, b2, *kk = _merge_chunk(b1, f1, b2, c1, cf1, c2,
                                               piota, kk)
                kk = kk[0] if keys else None
            for k, x in enumerate((b1, f1, b2)):
                outs[3 * v + k][l0:l0 + w] = x[0]
            if keys:
                for k, (x, key) in enumerate(((b1, kk[0]), (b2, kk[1]))):
                    kouts[2 * v + k][l0:l0 + w] = torch.where(
                        torch.isfinite(x[0]), key[0], -1.0).to(torch.int32)
    return (outs, kouts) if keys else outs


def candidate_from_crossings(density, t1, front1, t2, t_min: float, u):
    """``(t, scatter)``: the scatter candidate of one medium of
    ``density`` (an f32 0-d tensor) from its crossings (``front1`` bool)
    and the draw ``u`` [R]; ``t`` is +inf where the ray does not scatter.
    A draw of exactly 0 never scatters: the JAX package's ``log(max(u,
    1e-38))`` meets a float32 subnormal that its CPU and TPU backends
    flush to 0, so its flight is +inf there."""
    entry = torch.where(front1, t1, t_min)
    exit_t = torch.where(front1, t2, t1)
    has_segment = torch.isfinite(t1) & torch.isfinite(exit_t)
    dist_in = exit_t - entry
    neg_inv_density = -1.0 / density
    hit_dist = torch.where(
        u > 0.0, neg_inv_density * torch.log(torch.where(u > 0.0, u, 1.0)),
        math.inf)
    scatter = has_segment & (hit_dist < dist_in)
    return torch.where(scatter, entry + hit_dist, math.inf), scatter


def volume_candidates_plain(vtbl, ox, oy, oz, dx, dy, dz, tm, *, u, t_med,
                            vmat, density, mats, slices: tuple, t_min: float,
                            has_motion: bool, has_box: bool, prepared=None):
    """The candidate mode of both kernels in plain PyTorch, on any device:
    ``(t_med, vmat)`` [R] after folding, in medium order, each medium's
    scatter candidate (:func:`candidate_from_crossings` of
    :func:`volume_crossings_plain`'s crossings and the draws ``u[v]``)
    into the given ``(t_med, vmat)`` (None: +inf and 0) with a strict
    ``<`` (the first medium wins a tie); ``density`` [V] and ``mats`` (V
    material ids) are the media's.  New tensors: the inputs are not
    changed.  ``prepared`` is accepted and ignored."""
    outs = volume_crossings_plain(vtbl, ox, oy, oz, dx, dy, dz, tm,
                                  slices=slices, t_min=t_min,
                                  has_motion=has_motion, has_box=has_box)
    if t_med is None:
        t_med = torch.full_like(ox, math.inf)
        vmat = torch.zeros_like(ox)
    for v, mat in enumerate(mats):
        tv, _ = candidate_from_crossings(
            density[v], outs[3 * v], outs[3 * v + 1] > 0.5, outs[3 * v + 2],
            t_min, u[v])
        better = tv < t_med
        t_med = torch.where(better, tv, t_med)
        vmat = torch.where(better, mat, vmat)
    return t_med, vmat


class _VolArgs(ctypes.Structure):
    """Mirror of ``VolArgs`` in csrc/volume_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "tbl", "nodes", "rows", "ox", "oy", "oz", "dx", "dy", "dz", "tm",
        "out", "visits", "keys", "u", "density", "t_med", "vmat")]
        + [(f, ctypes.c_int64) for f in ("n_lanes", "u_stride")]
        + [(f, ctypes.c_int) for f in (
            "n_vol", "n_tbl", "has_motion", "has_box", "tri_only", "planar",
            "cand", "keyed")]
        + [("t_min", ctypes.c_float)]
        + [(f, ctypes.c_int * MAX_VOLUMES) for f in ("starts", "counts",
                                                      "roots")]
        + [("mats", ctypes.c_float * MAX_VOLUMES)])


@dataclasses.dataclass(frozen=True)
class VolumeLaunch:
    """The tables of one launch of K11 (``forest`` None) or K11b for a
    group of at most :data:`MAX_VOLUMES` media, checked once by
    :func:`prepare_volume_launch`: the boundary table, the group's forest,
    its slices and flags, its densities ([V] f32 on the device, or None)
    and material ids, whether K11's planar instantiation serves the
    table, and the argument struct with its table part filled in (rays,
    draws, outputs and ``t_min`` are filled per launch)."""
    vtbl: torch.Tensor
    forest: VolumeBVH | None
    slices: tuple
    has_motion: bool
    has_box: bool
    density: torch.Tensor | None
    mats: tuple
    planar: bool
    args: _VolArgs


def check_forest(forest, vtbl, n_vol: int, device) -> None:
    """Raise unless ``forest`` is a :class:`VolumeBVH` on ``device`` of
    ``n_vol`` media over at most the rows of ``vtbl``."""
    if not isinstance(forest, VolumeBVH):
        raise ValueError("K11b needs the boundary's forest (pack_volume_bvh)")
    nd, rw = forest.nodes, forest.rows
    n = nd.shape[0] if nd.dim() == 2 else 0
    if (nd.device != device or nd.dtype != torch.float32 or nd.dim() != 2
            or nd.shape[1] != N_NODE_COLS or not nd.is_contiguous()
            or rw.device != device or rw.dtype != torch.float32
            or rw.dim() != 2 or rw.shape[1] != N_COLS
            or rw.shape[0] > vtbl.shape[0] or not rw.is_contiguous()):
        raise ValueError(f"forest: need contiguous f32 [*, {N_NODE_COLS}] "
                         f"nodes and [<={vtbl.shape[0]}, {N_COLS}] rows on "
                         f"{device}")
    if len(forest.roots) != n_vol or not all(0 <= r < n
                                             for r in forest.roots):
        raise ValueError(f"forest: roots {forest.roots} for {n_vol} media "
                         f"of {n} nodes")


def _check_tables(vtbl, forest, slices, density, mats) -> None:
    """Raise unless K11 (``forest`` None) or K11b takes the boundary table
    ``vtbl``, the media ``slices`` and, where given, their ``density``
    and ``mats``."""
    dev = vtbl.device
    nv = len(slices)
    if not 0 < nv <= MAX_VOLUMES:
        raise ValueError(f"{nv} media: the kernels take 1..{MAX_VOLUMES}")
    n_rows = vtbl.shape[0] if vtbl.dim() == 2 else 0
    if (vtbl.dtype != torch.float32 or vtbl.dim() != 2
            or vtbl.shape[1] != N_COLS or not vtbl.is_contiguous()):
        raise ValueError(f"vtbl: need a contiguous f32 [*, {N_COLS}] tensor")
    if any(s < 0 or c <= 0 or s + c > n_rows for s, c in slices):
        raise ValueError(f"slices {slices} outside the {n_rows}-row table")
    if forest is not None:
        check_forest(forest, vtbl, nv, dev)
    elif n_rows > MAX_STAGED_ROWS:
        raise ValueError(f"K11 stages at most {MAX_STAGED_ROWS} boundary "
                         f"rows, got {n_rows} (K11b takes such tables)")
    if density is not None:
        check_lanes([("density", density)], nv, dev)
        if len(mats) != nv:
            raise ValueError(f"{len(mats)} material ids for {nv} media")


def prepare_volume_launch(vtbl, forest=None, *, slices: tuple,
                          has_motion: bool, has_box: bool, density=None,
                          mats=(), general: bool = False
                          ) -> VolumeLaunch:
    """Check the tables of one launch of K11 (``forest`` None) or K11b
    (as the wrappers do without them), decide whether K11's planar
    instantiation serves them (:func:`~.bounce_kernel.planar_only` over
    the whole table: one host synchronisation; ``general`` forces the
    general one) and prebuild the argument struct's table part.
    ``density`` ([V] f32 on the device) and ``mats`` are the media's, for
    the candidate mode."""
    slices = tuple(slices)
    mats = tuple(float(m) for m in mats)
    _check_tables(vtbl, forest, slices, density, mats)
    planar = (not general and forest is None
              and planar_only(vtbl, vtbl.shape[0], has_motion))
    nv = len(slices)
    pad = [0] * (MAX_VOLUMES - nv)
    roots = forest.roots if forest is not None else (0,) * nv
    args = _VolArgs(
        tbl=vtbl.data_ptr(),
        nodes=None if forest is None else forest.nodes.data_ptr(),
        rows=None if forest is None else forest.rows.data_ptr(),
        density=None if density is None else density.data_ptr(),
        n_vol=nv, n_tbl=vtbl.shape[0],
        has_motion=int(has_motion), has_box=int(has_box),
        tri_only=int(forest is not None and forest.tri_only),
        planar=int(planar),
        starts=(ctypes.c_int * MAX_VOLUMES)(*[s for s, _ in slices], *pad),
        counts=(ctypes.c_int * MAX_VOLUMES)(*[c for _, c in slices], *pad),
        roots=(ctypes.c_int * MAX_VOLUMES)(*roots, *pad),
        mats=(ctypes.c_float * MAX_VOLUMES)(*mats, *[0.0] * (MAX_VOLUMES
                                                            - len(mats))))
    return VolumeLaunch(vtbl=vtbl, forest=forest, slices=slices,
                        has_motion=has_motion, has_box=has_box,
                        density=density, mats=mats, planar=planar,
                        args=args)


def table_args(vtbl, forest, kw, density=None, mats=(),
               prepared: VolumeLaunch | None = None) -> _VolArgs:
    """The table part of the argument struct for ``vtbl``, ``forest``
    (None: K11), the keywords ``kw`` (slices and flags) and, for the
    candidate mode, ``density`` and ``mats``: that of ``prepared``, which
    must have been made for them, or (``prepared`` None) that of a launch
    prepared here with K11's general instantiation."""
    slices = tuple(kw["slices"])
    if prepared is None:
        return prepare_volume_launch(
            vtbl, forest, slices=slices, has_motion=kw["has_motion"],
            has_box=kw["has_box"], density=density, mats=mats,
            general=True).args
    if (prepared.vtbl is not vtbl or prepared.forest is not forest
            or prepared.slices != slices
            or prepared.has_motion != kw["has_motion"]
            or prepared.has_box != kw["has_box"]
            or (density is not None and (prepared.density is not density
                                         or prepared.mats != tuple(mats)))):
        raise ValueError("volume kernels: the prepared tables are not the "
                         "ones given")
    return prepared.args


def vol_args(vtbl, forest, rays, out, visits, *, slices, t_min: float,
             has_motion: bool, has_box: bool, prepared=None,
             cand=None, keys=None) -> _VolArgs:
    """The kernels' argument struct for tensors that outlive it: the table
    part (:func:`table_args`), the rays, ``t_min`` and either the
    crossings mode's ``out`` (and ``visits``, or None; with ``keys``, the
    keyed mode's [2V, R] i32 keys) or, with ``cand`` = ``(u, t_med, vmat,
    density, mats, fresh)``, the candidate mode's draws [V, *]
    (lane-contiguous rows), rows updated in place (written only, with
    ``fresh``) and media."""
    kw = dict(slices=slices, has_motion=has_motion, has_box=has_box)
    density, mats = (None, ()) if cand is None else cand[3:5]
    args = _VolArgs.from_buffer_copy(
        table_args(vtbl, forest, kw, density, mats, prepared))
    (args.ox, args.oy, args.oz, args.dx, args.dy, args.dz, args.tm) = (
        x.data_ptr() for x in rays)
    args.n_lanes = rays[0].shape[0]
    args.t_min = t_min
    if cand is None:
        args.out = out.data_ptr()
        args.visits = None if visits is None else visits.data_ptr()
        if keys is not None:
            args.keyed, args.keys = 1, keys.data_ptr()
    else:
        u, t_med, vmat = cand[:3]
        args.cand = 2 if cand[5] else 1
        args.u, args.u_stride = u.data_ptr(), u.stride(0)
        args.t_med, args.vmat = t_med.data_ptr(), vmat.data_ptr()
    return args


def _launch(entry: str, vtbl, forest, rays, kw, prepared, count_visits=False,
            cand=None, keyed=False):
    """Check what can change between launches (the rays, the draws and
    the candidate rows: count, device, type, contiguity) and launch
    ``entry`` over :func:`table_args`; returns the [3V, R] crossings (and
    the [2, R] i32 box tests and row tests of each ray with
    ``count_visits``, or with ``keyed`` the [2V, R] i32 keys), or in the
    candidate mode ``(t_med, vmat)`` (new rows where ``cand`` gives
    None)."""
    dev = rays[0].device
    r = rays[0].shape[0]
    if vtbl.device != dev:
        raise ValueError(f"vtbl: need a tensor on {dev}")
    check_lanes(zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), rays), r,
                dev)
    out = visits = keys = None
    if cand is None:
        out = torch.empty((3 * len(kw["slices"]), r), dtype=torch.float32,
                          device=dev)
        visits = (torch.zeros((2, r), dtype=torch.int32, device=dev)
                  if count_visits else None)
        keys = (torch.empty((2 * len(kw["slices"]), r), dtype=torch.int32,
                            device=dev) if keyed else None)
    else:
        u, t_med, vmat, density, mats = cand
        if t_med is None:
            t_med, vmat = torch.empty((2, r), dtype=torch.float32,
                                      device=dev).unbind(0)
            cand = (u, t_med, vmat, density, mats, True)
        else:
            check_lanes((("t_med", t_med), ("vmat", vmat)), r, dev)
            cand = (u, t_med, vmat, density, mats, False)
        if (u.device != dev or u.dtype != torch.float32 or u.dim() != 2
                or u.shape[0] < len(kw["slices"]) or u.shape[1] != r
                or u.stride(1) != 1):
            raise ValueError(f"u: need f32 [>={len(kw['slices'])}, {r}] "
                             f"draws with lane-contiguous rows on {dev}")
    launch(entry, vol_args(vtbl, forest, rays, out, visits, prepared=prepared,
                           cand=cand, keys=keys, **kw), dev)
    if cand is not None:
        return cand[1:3]
    return (out, keys) if keyed else (out, visits)


def _count(kernel, prepared, cand, keyed=False) -> None:
    kernel.launches += 1
    if prepared is not None and prepared.planar:
        kernel.planar_launches += 1
    if cand is not None:
        kernel.candidate_launches += 1
    if keyed:
        kernel.keyed_launches += 1


def pallas_volume_crossings(vtbl, ox, oy, oz, dx, dy, dz, tm, *,
                            slices: tuple, t_min: float, has_motion: bool,
                            has_box: bool = False,
                            prepared: VolumeLaunch | None = None):
    """The crossings of every ray with every medium of ``slices`` by a
    scan of the boundary rows (kernel K11; the JAX package's name).
    Returns the 3V [R] rows (see the module docstring).  ``prepared``
    (:func:`prepare_volume_launch` of these tables) skips the tables'
    checks and selects the planar instantiation where it serves them;
    without it the tables are checked and the general one runs.

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings`` (``pallas_volume_crossings.launches`` counts
    the launches of K11 in either mode, ``.planar_launches`` those of its
    planar instantiation, ``.candidate_launches`` those of the candidate
    mode, :func:`pallas_volume_candidates`)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), has_motion=has_motion, has_box=has_box)
    dev = ox.device
    if dev.type == "cpu":
        return volume_crossings_plain(vtbl, *rays, t_min=t_min, **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings: unsupported device {dev}")
    out, _ = _launch("rt_volume_crossings", vtbl, None, rays,
                     dict(kw, t_min=t_min), prepared)
    _count(pallas_volume_crossings, prepared, None)
    return list(out.unbind(0))


pallas_volume_crossings.launches = 0
pallas_volume_crossings.planar_launches = 0
pallas_volume_crossings.candidate_launches = 0
pallas_volume_crossings.keyed_launches = 0


def pallas_volume_crossings_keyed(vtbl, ox, oy, oz, dx, dy, dz, tm, *,
                                  slices: tuple, t_min: float,
                                  has_motion: bool, has_box: bool = False,
                                  prepared: VolumeLaunch | None = None):
    """K11's keyed mode: ``(crossings, keys)``, the 3V [R] crossing rows
    of :func:`pallas_volume_crossings` and the 2V [R] i32 key rows of
    :func:`volume_crossings_plain` with ``keys=True``.  ``prepared`` as
    for :func:`pallas_volume_crossings`.

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings`` (counted as K11's launches, and in
    ``pallas_volume_crossings.keyed_launches``)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), has_motion=has_motion, has_box=has_box)
    dev = ox.device
    if dev.type == "cpu":
        return volume_crossings_plain(vtbl, *rays, t_min=t_min, keys=True,
                                      **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings_keyed: unsupported device "
                         f"{dev}")
    out, keys = _launch("rt_volume_crossings", vtbl, None, rays,
                        dict(kw, t_min=t_min), prepared, keyed=True)
    _count(pallas_volume_crossings, prepared, None, keyed=True)
    return list(out.unbind(0)), list(keys.unbind(0))


def pallas_volume_candidates(vtbl, ox, oy, oz, dx, dy, dz, tm, *, u, t_med,
                             vmat, density, mats, slices: tuple,
                             t_min: float, has_motion: bool,
                             has_box: bool = False,
                             prepared: VolumeLaunch | None = None):
    """K11's candidate mode: :func:`volume_candidates_plain`'s ``(t_med,
    vmat)`` for the draws ``u`` [V, R] (lane-contiguous rows) and the
    media's ``density`` [V] and ``mats``, folded into the given rows or,
    where ``t_med`` and ``vmat`` are None, from none.  ``prepared`` as
    for :func:`pallas_volume_crossings` (made with these ``density`` and
    ``mats``).

    CPU tensors run :func:`volume_candidates_plain` (new tensors); CUDA
    tensors launch ``rt_volume_crossings``, which updates ``t_med`` and
    ``vmat`` in place and returns them, or writes new ones (counted as
    K11's launches)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), t_min=t_min, has_motion=has_motion,
              has_box=has_box)
    dev = ox.device
    if dev.type == "cpu":
        return volume_candidates_plain(vtbl, *rays, u=u, t_med=t_med,
                                       vmat=vmat, density=density, mats=mats,
                                       **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_candidates: unsupported device "
                         f"{dev}")
    cand = (u, t_med, vmat, density, mats)
    out = _launch("rt_volume_crossings", vtbl, None, rays, kw, prepared,
                  cand=cand)
    _count(pallas_volume_crossings, prepared, cand)
    return out


def pallas_volume_crossings_bcast(vtbl, forest, ox, oy, oz, dx, dy, dz, tm,
                                  *, slices: tuple, t_min: float,
                                  has_motion: bool, has_box: bool = False,
                                  count_visits: bool = False,
                                  prepared: VolumeLaunch | None = None):
    """:func:`pallas_volume_crossings`' contract for boundary tables of
    :data:`BCAST_MIN_ROWS` rows and more (kernel K11b; the JAX package's
    name): each ray walks ``forest`` (:func:`pack_volume_bvh`, one tree
    per medium of ``slices``), skipping every node it cannot reach within
    ``[t_min, t2]``.  With ``count_visits`` (CUDA only) also returns an
    [2, R] i32 tensor of the box tests and row tests of each ray.
    ``prepared`` (:func:`prepare_volume_launch` of these tables and this
    ``forest``) skips the tables' checks.

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings_bvh`` (``pallas_volume_crossings_bcast.launches``
    counts the launches of K11b in either mode, ``.candidate_launches``
    those of the candidate mode, :func:`pallas_volume_candidates_bcast`)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), has_motion=has_motion, has_box=has_box)
    dev = ox.device
    if dev.type == "cpu" and not count_visits:
        return volume_crossings_plain(vtbl, *rays, t_min=t_min, **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings_bcast: unsupported device "
                         f"{dev}")
    out, visits = _launch("rt_volume_crossings_bvh", vtbl, forest, rays,
                          dict(kw, t_min=t_min), prepared, count_visits)
    _count(pallas_volume_crossings_bcast, prepared, None)
    res = list(out.unbind(0))
    return (res, visits) if count_visits else res


pallas_volume_crossings_bcast.launches = 0
pallas_volume_crossings_bcast.candidate_launches = 0
pallas_volume_crossings_bcast.keyed_launches = 0


def pallas_volume_crossings_bcast_keyed(vtbl, forest, ox, oy, oz, dx, dy, dz,
                                        tm, *, slices: tuple, t_min: float,
                                        has_motion: bool,
                                        has_box: bool = False,
                                        prepared: VolumeLaunch | None = None):
    """K11b's keyed mode: :func:`pallas_volume_crossings_keyed`' contract
    over the walk of ``forest``.

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings_bvh`` (counted as K11b's launches, and in
    ``pallas_volume_crossings_bcast.keyed_launches``)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), has_motion=has_motion, has_box=has_box)
    dev = ox.device
    if dev.type == "cpu":
        return volume_crossings_plain(vtbl, *rays, t_min=t_min, keys=True,
                                      **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings_bcast_keyed: unsupported "
                         f"device {dev}")
    out, keys = _launch("rt_volume_crossings_bvh", vtbl, forest, rays,
                        dict(kw, t_min=t_min), prepared, keyed=True)
    _count(pallas_volume_crossings_bcast, prepared, None, keyed=True)
    return list(out.unbind(0)), list(keys.unbind(0))


def pallas_volume_candidates_bcast(vtbl, forest, ox, oy, oz, dx, dy, dz, tm,
                                   *, u, t_med, vmat, density, mats,
                                   slices: tuple, t_min: float,
                                   has_motion: bool, has_box: bool = False,
                                   prepared: VolumeLaunch | None = None):
    """K11b's candidate mode: :func:`pallas_volume_candidates`' contract
    over the walk of ``forest``.

    CPU tensors run :func:`volume_candidates_plain` (new tensors); CUDA
    tensors launch ``rt_volume_crossings_bvh``, which updates ``t_med``
    and ``vmat`` in place and returns them (counted as K11b's
    launches)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), t_min=t_min, has_motion=has_motion,
              has_box=has_box)
    dev = ox.device
    if dev.type == "cpu":
        return volume_candidates_plain(vtbl, *rays, u=u, t_med=t_med,
                                       vmat=vmat, density=density, mats=mats,
                                       **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_candidates_bcast: unsupported "
                         f"device {dev}")
    cand = (u, t_med, vmat, density, mats)
    out = _launch("rt_volume_crossings_bvh", vtbl, forest, rays, kw,
                  prepared, cand=cand)
    _count(pallas_volume_crossings_bcast, prepared, cand)
    return out
