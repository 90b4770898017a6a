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
* :func:`pallas_volume_crossings` (kernel K11, ``rt_volume_crossings``)
  and :func:`pallas_volume_crossings_bcast` (kernel K11b,
  ``rt_volume_crossings_bvh``, for boundary tables of
  :data:`BCAST_MIN_ROWS` rows and more: a near-child-first walk of one
  binned-SAH tree per medium, :func:`pack_volume_bvh`, that skips every
  node a ray cannot reach before its second crossing) launch
  ``csrc/volume_kernel.cu`` for CUDA tensors and run the plain version
  for CPU tensors.

Both return the 3V rows ``[t1_0, front1_0, t2_0, t1_1, ...]`` as [R] f32
tensors (front as 0/1).  Rays are 1-D [R] f32 tensors; the table is
``pack_prims(volumes.prims)`` ([C, 36], ``ops/intersect_kernel.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from ..scene.types import PRIM_TRIANGLE
from .allpairs_kernel import (
    N_NODE_COLS, build_tree, bvh_boxes, leaf_rows, pack_nodes,
)
from .intersect_kernel import N_COLS, _safe

BCAST_CHUNK = 256      # rows per chunk of the plain version's plan
BCAST_MIN_ROWS = 64    # boundary tables from this many rows take K11b
# media one launch takes (csrc/volume_kernel.cu); render/volumes.py
# launches once per group of at most this many
MAX_VOLUMES = 16
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


def _merge_chunk(b1, f1, b2, c1, cf1, c2, piota):
    """Fold a chunk's candidates [L, W] into the carried triple [1, W]:
    the chunk's smallest crossing with the flag of its first attainment
    (lowest row; a row's entering root before its exit root) and its
    smallest crossing strictly beyond, merged with a strict ``<``."""
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
    b2 = torch.minimum(torch.minimum(gtv(b1), gtv(b2)),
                       torch.minimum(gtv(t1t), gtv(t2t)))
    return nb1, f1, b2


def volume_crossings_plain(vtbl, ox, oy, oz, dx, dy, dz, tm, *,
                           slices: tuple, t_min: float, has_motion: bool,
                           has_box: bool):
    """Both kernels' function in plain PyTorch, on any device: the 3V
    [R] rows ``[t1, front1, t2]`` per volume of ``slices`` ((start,
    count) per volume)."""
    tmn = float(torch.tensor(t_min, dtype=torch.float32))
    plans = _chunk_plans(slices)
    r = ox.shape[0]
    outs = [torch.empty(r, dtype=torch.float32, device=ox.device)
            for _ in range(3 * len(slices))]
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
            for p, ln in plan:
                a, b = max(p, start), min(p + ln, start + count)
                rows = vtbl[a:b]
                piota = torch.arange(a, b, device=ox.device,
                                     dtype=torch.float32)[:, None]
                c1, cf1, c2 = _crossing_cand(
                    lambda k: rows[:, k:k + 1], *rays, inv, tmn, has_motion,
                    has_box)
                b1, f1, b2 = _merge_chunk(b1, f1, b2, c1, cf1, c2, piota)
            for k, x in enumerate((b1, f1, b2)):
                outs[3 * v + k][l0:l0 + w] = x[0]
    return outs


class _VolArgs(ctypes.Structure):
    """Mirror of ``VolArgs`` in csrc/volume_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "tbl", "nodes", "rows", "ox", "oy", "oz", "dx", "dy", "dz", "tm",
        "out", "visits")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in ("n_vol", "has_motion", "has_box",
                                        "tri_only")]
        + [("t_min", ctypes.c_float)]
        + [(f, ctypes.c_int * MAX_VOLUMES) for f in ("starts", "counts",
                                                      "roots")])


def vol_args(vtbl, forest, rays, out, visits, *, slices, t_min: float,
             has_motion: bool, has_box: bool) -> _VolArgs:
    """The kernels' argument struct for tensors that outlive it
    (``forest`` and ``visits`` may be None: K11)."""
    pad = [0] * (MAX_VOLUMES - len(slices))
    ptr = lambda x: None if x is None else x.data_ptr()
    roots = forest.roots if forest is not None else (0,) * len(slices)
    return _VolArgs(
        *(ptr(x) for x in (vtbl, None if forest is None else forest.nodes,
                           None if forest is None else forest.rows)
          + tuple(rays) + (out, visits)),
        rays[0].shape[0], len(slices), int(has_motion), int(has_box),
        int(forest is not None and forest.tri_only), float(t_min),
        (ctypes.c_int * MAX_VOLUMES)(*[s for s, _ in slices], *pad),
        (ctypes.c_int * MAX_VOLUMES)(*[c for _, c in slices], *pad),
        (ctypes.c_int * MAX_VOLUMES)(*roots, *pad))


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


def _launch(entry: str, vtbl, forest, rays, slices, t_min, has_motion,
            has_box, count_visits: bool):
    """Check the arguments and launch ``entry``; returns the [3V, R]
    output (and the [2, R] i32 box tests and row tests of each ray with
    ``count_visits``)."""
    from ._build import launch
    from .bounce_kernel import check_lanes
    dev = rays[0].device
    r = rays[0].shape[0]
    nv = len(slices)
    if not 0 < nv <= MAX_VOLUMES:
        raise ValueError(f"{nv} media: the kernels take 1..{MAX_VOLUMES}")
    n_rows = vtbl.shape[0] if vtbl.dim() == 2 else 0
    if (vtbl.device != dev or vtbl.dtype != torch.float32 or vtbl.dim() != 2
            or vtbl.shape[1] != N_COLS or not vtbl.is_contiguous()):
        raise ValueError(f"vtbl: need a contiguous f32 [*, {N_COLS}] tensor "
                         f"on {dev}")
    if any(s < 0 or c <= 0 or s + c > n_rows for s, c in slices):
        raise ValueError(f"slices {slices} outside the {n_rows}-row table")
    if forest is not None:
        check_forest(forest, vtbl, nv, dev)
    check_lanes(zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), rays), r,
                dev)
    out = torch.empty((3 * nv, r), dtype=torch.float32, device=dev)
    visits = (torch.zeros((2, r), dtype=torch.int32, device=dev)
              if count_visits else None)
    args = vol_args(vtbl, forest, rays, out, visits, slices=slices,
                    t_min=t_min, has_motion=has_motion, has_box=has_box)
    launch(entry, args, dev)
    return out, visits


def pallas_volume_crossings(vtbl, ox, oy, oz, dx, dy, dz, tm, *,
                            slices: tuple, t_min: float, has_motion: bool,
                            has_box: bool = False):
    """The crossings of every ray with every medium of ``slices`` by a
    scan of the boundary rows (kernel K11; the JAX package's name).
    Returns the 3V [R] rows (see the module docstring).

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings`` (``pallas_volume_crossings.launches`` counts
    the launches)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    kw = dict(slices=tuple(slices), t_min=t_min, has_motion=has_motion,
              has_box=has_box)
    dev = ox.device
    if dev.type == "cpu":
        return volume_crossings_plain(vtbl, *rays, **kw)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings: unsupported device {dev}")
    out, _ = _launch("rt_volume_crossings", vtbl, None, rays, kw["slices"],
                     t_min, has_motion, has_box, False)
    pallas_volume_crossings.launches += 1
    return list(out.unbind(0))


pallas_volume_crossings.launches = 0


def pallas_volume_crossings_bcast(vtbl, forest, ox, oy, oz, dx, dy, dz, tm,
                                  *, slices: tuple, t_min: float,
                                  has_motion: bool, has_box: bool = False,
                                  count_visits: bool = False):
    """:func:`pallas_volume_crossings`' contract for boundary tables of
    :data:`BCAST_MIN_ROWS` rows and more (kernel K11b; the JAX package's
    name): each ray walks ``forest`` (:func:`pack_volume_bvh`, one tree
    per medium of ``slices``), skipping every node it cannot reach within
    ``[t_min, t2]``.  With ``count_visits`` (CUDA only) also returns an
    [2, R] i32 tensor of the box tests and row tests of each ray.

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings_bvh``
    (``pallas_volume_crossings_bcast.launches`` counts the launches)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    slices = tuple(slices)
    dev = ox.device
    if dev.type == "cpu" and not count_visits:
        return volume_crossings_plain(vtbl, *rays, slices=slices,
                                      t_min=t_min, has_motion=has_motion,
                                      has_box=has_box)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings_bcast: unsupported device "
                         f"{dev}")
    out, visits = _launch("rt_volume_crossings_bvh", vtbl, forest, rays,
                          slices, t_min, has_motion, has_box, count_visits)
    pallas_volume_crossings_bcast.launches += 1
    res = list(out.unbind(0))
    return (res, visits) if count_visits else res


pallas_volume_crossings_bcast.launches = 0
