"""The nearest hit record over a mesh-scale table
(``raytrace_tpu/ops/pallas/allpairs_kernel.py``: ``allpairs_nearest_record``).

The TPU kernel sweeps every (row chunk, ray row) pair as a broadcast and
culls with chunk and sub-cluster boxes.  On the card the same function,
the nearest hit with the lowest row winning ties, is a per-ray walk of a
BVH (``csrc/nearest_kernel.cu`` over ``csrc/bvh_nearest.cuh``):

* :func:`pack_bvh` builds the device BVH on the host (``scene/bvh.py:
  build_sah_bvh``, a binned-SAH tree of two-box nodes) over the rows of
  the packed table in their final order, with a copy of those rows in
  leaf order;
* :func:`allpairs_nearest_plain` is the plain PyTorch version: the
  all-pairs broadcast over row chunks, with exactly the per-row
  arithmetic of ``intersect_kernel.prim_loop_plain``;
* :func:`allpairs_nearest_record` launches the kernel for CUDA tensors
  and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from ..scene.bvh import build_sah_bvh, prim_aabbs
from ..scene.types import PRIM_PAD, PRIM_TRIANGLE
from .intersect_kernel import N_COLS, _box_attrs, _record_contract, _safe

N_NODE_COLS = 16
LEAF_SIZE = 4
SAH_BINS = 16
# the walk's fixed stack of far children (kStack of csrc/bvh_nearest.cuh):
# pack_bvh refuses a deeper tree
STACK_SIZE = 32
# the table column of the leaf-ordered rows that holds each row's index in
# the packed table (the packed table leaves it 0)
ORIG_COL = 35
# the walk carries a row's index as f32 (ORIG_COL, the record's winner),
# exact below 2^24: the largest table the kernel takes.  Its other
# offsets are 64-bit (rows) or far from overflow at this size (a node's
# 4 float4 at 4 x its index; a stack entry holds word << 3 | count).
MAX_BVH_ROWS = 1 << 24
# the split path's nearest hit of a kind-segmented table of at least this
# many scanned rows walks its BVH; smaller or unsegmented tables take the
# flat scan (the JAX package's MIN_PRIMS)
MIN_PRIMS = 192
# outward padding of every BVH box: the per-row tests accept hits a
# rounding error outside a primitive's exact bounds (planar rows carry
# bvh.PLANE_PAD already; spheres and boxes none), so the walk pads every
# box by an absolute floor plus a share of the scene's largest coordinate
NODE_PAD_ABS = 1e-4
NODE_PAD_REL = 1e-5
# (row, lane) pairs per chunk of the plain version: ~30 live [chunk,
# lanes] f32 tiles of 32 MB stay under about 1 GiB
_PAIR_BUDGET = 1 << 23

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    """A binned-SAH BVH of two-box nodes over the rows of a packed table.

    ``nodes`` is [n_nodes, 16] f32, breadth-first from the root: the left
    child's box lo (3), hi (3), the right child's lo (3), hi (3), then four
    int32 words stored bit for bit: the two children's words and counts.
    A child of count 0 is the interior node of that index (an empty leaf
    where the whole table is one leaf); a leaf's word is its first row of
    ``rows`` and its count its number of rows.  ``rows`` [n_real, 36] is a
    copy of the table's real rows in leaf order, column ``ORIG_COL``
    holding each row's index in the packed table (ties and outputs use
    it).  ``tri_only``: every row is an unmoving triangle (the walk's
    triangle-only test); ``depth``: the most interior nodes on a path
    (at most ``STACK_SIZE``); ``build_s``: the host build time."""
    nodes: torch.Tensor
    rows: torch.Tensor
    tri_only: bool
    depth: int
    build_s: float

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])


def bvh_boxes(prims, n_prims: int):
    """``(real, lo, hi)``: the real (non-pad) rows among ``[0, n_prims)``
    and their boxes (f64 [n, 3]), padded outward as the BVH's are."""
    f64 = lambda x: x[:n_prims].detach().cpu().numpy().astype(np.float64)
    kind = prims.kind[:n_prims].cpu().numpy()
    real = np.nonzero(kind != PRIM_PAD)[0]
    if real.size == 0:
        raise ValueError("pack_bvh: the table has no primitive rows")
    lo, hi = prim_aabbs(kind[real], f64(prims.p0)[real], f64(prims.e1)[real],
                        f64(prims.e2)[real], f64(prims.mv0)[real],
                        f64(prims.mv1)[real])
    pad = NODE_PAD_ABS + NODE_PAD_REL * max(1.0, float(np.abs(lo).max()),
                                            float(np.abs(hi).max()))
    return real, lo - pad, hi + pad


def build_tree(lo, hi, who: str):
    """``(perm, nodes, depth)``: :func:`build_sah_bvh` over the padded
    boxes ``lo``/``hi`` with the walks' leaf size and bins; raise if the
    tree is deeper than the walks' stack."""
    perm, nodes, depth = build_sah_bvh(lo, hi, leaf_size=LEAF_SIZE,
                                       n_bins=SAH_BINS)
    if depth > STACK_SIZE:
        raise ValueError(f"{who}: a tree of depth {depth} overflows the "
                         f"walk's stack of {STACK_SIZE}")
    return perm, nodes, depth


def pack_nodes(nodes, node_base: int = 0, row_base: int = 0) -> np.ndarray:
    """[n, 16] f32 two-box nodes of :func:`build_sah_bvh`'s ``nodes``: the
    boxes rounded outward to f32 by one more ulp, then the words and
    counts as int32 bits; interior words offset by ``node_base`` and
    leaf words by ``row_base`` (for trees packed into one array)."""
    n = nodes["child"].shape[0]
    out = np.zeros((n, N_NODE_COLS), np.float32)
    box = lambda b, to: np.nextafter(b.astype(np.float32), np.float32(to))
    lo32, hi32 = box(nodes["lo"], -np.inf), box(nodes["hi"], np.inf)
    out[:, 0:3], out[:, 3:6] = lo32[:, 0], hi32[:, 0]
    out[:, 6:9], out[:, 9:12] = lo32[:, 1], hi32[:, 1]
    words = out.view(np.int32)
    count = nodes["count"]
    words[:, 12:14] = nodes["child"] + np.where(count == 0, node_base,
                                                row_base)
    words[:, 14:16] = count
    return out


def leaf_rows(tbl, order: np.ndarray) -> torch.Tensor:
    """The rows ``order`` of the packed table ``tbl``, copied in that
    order, column ``ORIG_COL`` holding each row's index in ``tbl``."""
    idx = torch.from_numpy(order).to(tbl.device)
    rows = tbl[idx].contiguous()
    rows[:, ORIG_COL] = idx.to(torch.float32)
    return rows


def pack_bvh(prims, tbl, n_prims: int) -> DeviceBVH:
    """Build the device BVH of rows ``[0, n_prims)`` of the packed table
    ``tbl`` of ``prims`` (after kind segmentation and padding; pad rows
    left out), on the device of ``tbl``."""
    t0 = time.perf_counter()
    real, lo, hi = bvh_boxes(prims, n_prims)
    perm, nodes, depth = build_tree(lo, hi, "pack_bvh")
    dev = tbl.device
    rows = leaf_rows(tbl, real[perm])
    tri_only = (not prims.has_motion
                and bool((rows[:, 16] == float(PRIM_TRIANGLE)).all()))
    return DeviceBVH(nodes=torch.from_numpy(pack_nodes(nodes)).to(dev),
                     rows=rows, tri_only=tri_only, depth=depth,
                     build_s=time.perf_counter() - t0)


def _kind_groups(kinds, c0: int, c1: int):
    """``{kind: row indices in [c0, c1)}`` of the rows that can be hit."""
    groups: dict[int, list] = {}
    for i in range(c0, c1):
        k = kinds[i]
        if k in (0.0, 1.0, 2.0, 3.0):
            groups.setdefault(0 if k == 0.0 else 3 if k == 3.0 else 1,
                              []).append(i)
    return groups


def _candidates(kind, blk, ox, oy, oz, dx, dy, dz, inv, tm, t_min,
                has_motion):
    """[rows, lanes] candidate t of the rows ``blk`` ([rows, 36], one
    kind group: 0 sphere, 1 planar, 3 box) against every lane: the
    arithmetic of ``prim_loop_plain`` per (row, lane) pair."""
    col = lambda j: blk[:, j:j + 1]
    ox, oy, oz, dx, dy, dz = (x[None] for x in (ox, oy, oz, dx, dy, dz))
    px, py, pz = col(0), col(1), col(2)
    if has_motion:
        tm = tm[None]
        sx = col(24) + tm * col(27)
        sy = col(25) + tm * col(28)
        sz = col(26) + tm * col(29)
        px = px + sx
        py = py + sy
        pz = pz + sz
    if kind == 0:
        r2 = col(3)
        ocx = px - ox
        ocy = py - oy
        ocz = pz - oz
        h = dx * ocx + dy * ocy + dz * ocz
        cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = h * h - cterm
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = h - sq
        rr2 = h + sq
        cand = torch.where(r1 > t_min, r1,
                           torch.where(rr2 > t_min, rr2, _INF))
        return torch.where(disc >= 0.0, cand, _INF)
    if kind == 1:
        nxs, nys, nzs = col(4), col(5), col(6)
        den = dx * nxs + dy * nys + dz * nzs
        den_ok = torch.abs(den) > 1e-8
        den_safe = torch.where(den_ok, den, 1.0)
        on = ox * nxs + oy * nys + oz * nzs
        qn, qwa, qwb = col(13), col(14), col(15)
        wax, way, waz = col(7), col(8), col(9)
        wbx, wby, wbz = col(10), col(11), col(12)
        if has_motion:
            qn = qn + sx * nxs + sy * nys + sz * nzs
            qwa = qwa + sx * wax + sy * way + sz * waz
            qwb = qwb + sx * wbx + sy * wby + sz * wbz
        t_p = (qn - on) / den_safe
        owa = ox * wax + oy * way + oz * waz
        dwa = dx * wax + dy * way + dz * waz
        owb = ox * wbx + oy * wby + oz * wbz
        dwb = dx * wbx + dy * wby + dz * wbz
        a = owa - qwa + t_p * dwa
        b = owb - qwb + t_p * dwb
        bound = torch.where(col(16) == 2.0, a + b, torch.maximum(a, b))
        ok = den_ok & (a >= 0.0) & (b >= 0.0) & (bound <= 1.0) \
            & (t_p > t_min)
        return torch.where(ok, t_p, _INF)
    hix, hiy, hiz = col(7), col(8), col(9)
    if has_motion:
        hix = hix + sx
        hiy = hiy + sy
        hiz = hiz + sz
    inv_dx, inv_dy, inv_dz = (x[None] for x in inv)
    bx0 = (px - ox) * inv_dx
    bx1 = (hix - ox) * inv_dx
    by0 = (py - oy) * inv_dy
    by1 = (hiy - oy) * inv_dy
    bz0 = (pz - oz) * inv_dz
    bz1 = (hiz - oz) * inv_dz
    btn = torch.maximum(torch.maximum(torch.minimum(bx0, bx1),
                                      torch.minimum(by0, by1)),
                        torch.minimum(bz0, bz1))
    btf = torch.minimum(torch.minimum(torch.maximum(bx0, bx1),
                                      torch.maximum(by0, by1)),
                        torch.maximum(bz0, bz1))
    cand = torch.where(btn > t_min, btn, torch.where(btf > t_min, btf, _INF))
    return torch.where(btn <= btf, cand, _INF)


def _winner_record(w, bt, hit, ox, oy, oz, dx, dy, dz, inv, tm, t_min,
                   has_motion):
    """The record of each lane's winning row ``w`` ([lanes, 36]) at its t
    ``bt``: the arithmetic of ``prim_loop_plain`` on that row, so the
    record equals the flat scan's.  Returns (nx, ny, nz, front, u, v,
    sphere) before the flip."""
    c = lambda j: w[:, j]
    kind = c(16)
    px, py, pz = c(0), c(1), c(2)
    if has_motion:
        sx = c(24) + tm * c(27)
        sy = c(25) + tm * c(28)
        sz = c(26) + tm * c(29)
        px = px + sx
        py = py + sy
        pz = pz + sz
    z = torch.zeros_like(bt)
    one = torch.ones_like(bt)
    cand = bt

    # sphere
    r2 = c(3)
    ocx = px - ox
    ocy = py - oy
    ocz = pz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    inv_r = 1.0 / torch.sqrt(torch.clamp(r2, min=1e-30)) * torch.sign(c(30))
    s_rec = ((ox + cand * dx - px) * inv_r, (oy + cand * dy - py) * inv_r,
             (oz + cand * dz - pz) * inv_r, torch.where(cand <= h, 1.0, 0.0),
             z, z)

    # parallelogram / triangle
    nxs, nys, nzs = c(4), c(5), c(6)
    den = dx * nxs + dy * nys + dz * nzs
    den_ok = torch.abs(den) > 1e-8
    den_safe = torch.where(den_ok, den, 1.0)
    on = ox * nxs + oy * nys + oz * nzs
    qn, qwa, qwb = c(13), c(14), c(15)
    wax, way, waz = c(7), c(8), c(9)
    wbx, wby, wbz = c(10), c(11), c(12)
    if has_motion:
        qn = qn + sx * nxs + sy * nys + sz * nzs
        qwa = qwa + sx * wax + sy * way + sz * waz
        qwb = qwb + sx * wbx + sy * wby + sz * wbz
    t_p = (qn - on) / den_safe
    a = ox * wax + oy * way + oz * waz - qwa + t_p * (
        dx * wax + dy * way + dz * waz)
    b = ox * wbx + oy * wby + oz * wbz - qwb + t_p * (
        dx * wbx + dy * wby + dz * wbz)
    w0 = 1.0 - a - b
    is_tri = kind == 2.0
    p_rec = (nxs, nys, nzs, torch.where(den < 0.0, 1.0, 0.0),
             torch.where(is_tri, w0 * c(18) + a * c(20) + b * c(22), a),
             torch.where(is_tri, w0 * c(19) + a * c(21) + b * c(23), b))

    # box
    hix, hiy, hiz = c(7), c(8), c(9)
    if has_motion:
        hix = hix + sx
        hiy = hiy + sy
        hiz = hiz + sz
    t_hit = torch.where(cand < _INF, cand, 1.0)
    b_rec = _box_attrs(px, py, pz, hix, hiy, hiz, ox + t_hit * dx,
                       oy + t_hit * dy, oz + t_hit * dz, dx, dy, dz)

    is_s = hit & (kind == 0.0)
    is_p = hit & ((kind == 1.0) | is_tri)
    is_b = hit & (kind == 3.0)
    miss = (z, z, one, z, z, z)
    rec = tuple(torch.where(is_s, sv, torch.where(
        is_p, pv, torch.where(is_b, bv, mv)))
        for sv, pv, bv, mv in zip(s_rec, p_rec, b_rec, miss))
    return rec + (torch.where(is_s | ~hit, 1.0, 0.0),)


def nearest_hit_plain(tbl, ox, oy, oz, dx, dy, dz, tm, *, n_prims: int,
                      t_min: float, has_motion: bool,
                      with_albedo: bool = False):
    """Nearest hit of every lane over rows ``[0, n_prims)``, in the output
    format of ``prim_loop_plain`` (which it equals lane for lane): the
    candidate t of every (row, lane) pair in chunks of rows, the minimum
    with the lowest row winning ties, then the winner's record."""
    t_min = float(np.float32(t_min))
    n = ox.shape[0]
    dev = ox.device
    kinds = tbl[:n_prims, 16].tolist()
    inv = (1.0 / _safe(dx), 1.0 / _safe(dy), 1.0 / _safe(dz))
    bt = torch.full_like(ox, _INF)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    step = max(1, _PAIR_BUDGET // max(n, 1))
    for c0 in range(0, n_prims, step):
        c1 = min(c0 + step, n_prims)
        groups = _kind_groups(kinds, c0, c1)
        if not groups:
            continue
        cand = torch.full((c1 - c0, n), _INF, dtype=ox.dtype, device=dev)
        for kind, rows in groups.items():
            ridx = torch.tensor(rows, dtype=torch.int64, device=dev)
            cand[ridx - c0] = _candidates(kind, tbl[ridx], ox, oy, oz, dx,
                                          dy, dz, inv, tm, t_min, has_motion)
        m = cand.min(0).values
        row_id = torch.arange(c0, c1, device=dev)[:, None]
        first = torch.where(cand == m[None], row_id, n_prims).min(0).values
        better = m < bt
        bt = torch.where(better, m, bt)
        bi = torch.where(better, first, bi)

    hit = bi >= 0
    w = tbl[torch.clamp(bi, min=0)]
    nx, ny, nz, fr, uu, vv, sph = _winner_record(
        w, bt, hit, ox, oy, oz, dx, dy, dz, inv, tm, t_min, has_motion)
    flip = torch.where(fr > 0.5, 1.0, -1.0)
    mat = torch.where(hit, w[:, 17], 0.0)
    out = (bt, torch.where(hit, bi.to(ox.dtype), -1.0), nx * flip,
           ny * flip, nz * flip, fr, uu, vv, mat, sph)
    if with_albedo:
        out = out + tuple(torch.where(hit, w[:, 31 + k], 0.0)
                          for k in range(4))
    return out


def allpairs_nearest_plain(tbl, ox, oy, oz, dx, dy, dz, tm, *, n_prims: int,
                           t_min: float, has_motion: bool):
    """:func:`allpairs_nearest_record` in plain PyTorch, on any device."""
    return _record_contract(nearest_hit_plain(
        tbl, ox, oy, oz, dx, dy, dz, tm, n_prims=n_prims, t_min=t_min,
        has_motion=has_motion))


class _NearestArgs(ctypes.Structure):
    """Mirror of ``NearestArgs`` in csrc/nearest_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "nodes", "rows", "ox", "oy", "oz", "dx", "dy", "dz", "tm", "outf",
        "outi", "visits", "seen")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in ("n_nodes", "has_motion",
                                       "tri_only")]
        + [("t_min", ctypes.c_float)])


def nearest_args(bvh: DeviceBVH, rays, outf, outi, visits, *,
                 has_motion: bool, t_min: float,
                 seen=None) -> _NearestArgs:
    """The kernel's argument struct for tensors that outlive it."""
    return _NearestArgs(
        *(x.data_ptr() for x in (bvh.nodes, bvh.rows) + tuple(rays)
          + (outf, outi)),
        None if visits is None else visits.data_ptr(),
        None if seen is None else seen.data_ptr(),
        rays[0].shape[0], bvh.n_nodes, int(has_motion), int(bvh.tri_only),
        float(t_min))


def check_bvh(bvh: DeviceBVH, n_prims: int, device) -> None:
    """Raise unless ``bvh`` is a packed BVH on ``device`` of at most
    ``n_prims`` rows, ``n_prims`` at most :data:`MAX_BVH_ROWS`."""
    if bvh is None:
        raise ValueError("the mesh kernels need the table's BVH (pack_bvh)")
    nd, rw = bvh.nodes, bvh.rows
    if (nd.device != device or nd.dtype != torch.float32 or nd.dim() != 2
            or nd.shape[1] != N_NODE_COLS or not nd.is_contiguous()
            or rw.device != device or rw.dtype != torch.float32
            or rw.dim() != 2 or rw.shape[1] != N_COLS
            or not rw.is_contiguous() or rw.shape[0] > n_prims):
        raise ValueError(f"bvh: need contiguous f32 [*, {N_NODE_COLS}] nodes "
                         f"and [<={n_prims}, {N_COLS}] rows on {device}")
    if not 0 < n_prims <= MAX_BVH_ROWS or nd.shape[0] > 2 * MAX_BVH_ROWS:
        raise ValueError(f"n_prims={n_prims} outside 1..{MAX_BVH_ROWS} or "
                         f"{nd.shape[0]} nodes over {2 * MAX_BVH_ROWS}: the "
                         "walk's row indices are f32")


def allpairs_nearest_record(tbl, bvh: DeviceBVH | None, ox, oy, oz, dx, dy,
                            dz, tm, *, n_prims: int, t_min: float,
                            has_motion: bool, count_visits: bool = False,
                            seen=None):
    """Nearest hit of every ray over rows ``[0, n_prims)`` of the packed
    table, of any size up to :data:`MAX_BVH_ROWS` (the counterpart of the
    TPU kernel's streamed mode past 65,536 rows: the same nearest hit, by
    the walk).  Rays are 1-D [R] f32 tensors.  Returns the 9 [R] outputs of
    :func:`_record_contract`; with ``count_visits`` (CUDA only) also an
    [2, R] i32 tensor of the box tests and row tests of each ray, and
    where ``seen`` is a zeroed u8 [n_nodes + rows] tensor, 1 set in it at
    each node and leaf row that a ray reads (nodes first): what the walk
    must move, for its bound.

    CPU tensors run :func:`allpairs_nearest_plain` (``bvh`` unused); CUDA
    tensors launch ``csrc/nearest_kernel.cu`` over ``bvh``
    (``allpairs_nearest_record.launches`` counts the launches)."""
    from .bounce_kernel import check_lanes
    rays = (ox, oy, oz, dx, dy, dz, tm)
    dev = ox.device
    if dev.type == "cpu" and not count_visits:
        return allpairs_nearest_plain(tbl, *rays, n_prims=n_prims,
                                      t_min=t_min, has_motion=has_motion)
    if dev.type != "cuda":
        raise ValueError(f"allpairs_nearest_record: unsupported device {dev}")
    r = ox.shape[0]
    if (tbl.device != dev or tbl.dtype != torch.float32 or tbl.dim() != 2
            or tbl.shape[1] != N_COLS or tbl.shape[0] < n_prims
            or not tbl.is_contiguous()):
        raise ValueError(f"tbl: need a contiguous f32 [>={n_prims}, "
                         f"{N_COLS}] tensor on {dev}")
    check_bvh(bvh, n_prims, dev)
    check_lanes(zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), rays), r,
                dev)
    from ._build import launch
    outf = torch.empty((6, r), dtype=torch.float32, device=dev)
    outi = torch.empty((3, r), dtype=torch.int32, device=dev)
    visits = (torch.empty((2, r), dtype=torch.int32, device=dev)
              if count_visits else None)
    if seen is not None and (
            not count_visits or seen.device != dev
            or seen.dtype != torch.uint8 or not seen.is_contiguous()
            or seen.shape != (bvh.n_nodes + bvh.rows.shape[0],)):
        raise ValueError("seen: need count_visits and a contiguous u8 "
                         "[n_nodes + rows] tensor on the rays' device")
    args = nearest_args(bvh, rays, outf, outi, visits,
                        has_motion=has_motion, t_min=t_min, seen=seen)
    launch("rt_nearest", args, dev)
    allpairs_nearest_record.launches += 1
    out = (outf[0], outi[0], outf[1], outf[2], outf[3], outi[1], outf[4],
           outf[5], outi[2])
    return (out, visits) if count_visits else out


allpairs_nearest_record.launches = 0
