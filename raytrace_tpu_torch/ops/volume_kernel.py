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
  ``rt_volume_crossings_chunked``, for boundary tables of
  :data:`BCAST_MIN_ROWS` rows and more, skipping the 256-row chunks whose
  box (:func:`pack_chunk_boxes`) a ray cannot reach before its second
  crossing) launch ``csrc/volume_kernel.cu`` for CUDA tensors and run the
  plain version for CPU tensors.

Both return the 3V rows ``[t1_0, front1_0, t2_0, t1_1, ...]`` as [R] f32
tensors (front as 0/1).  Rays are 1-D [R] f32 tensors; the table is
``pack_prims(volumes.prims)`` ([C, 36], ``ops/intersect_kernel.py``).
"""
from __future__ import annotations

import ctypes

import torch

from ..scene.types import PRIM_BOX, PRIM_PAD, PRIM_SPHERE
from .intersect_kernel import N_COLS, _safe

BCAST_CHUNK = 256      # rows per chunk of the plan and of a chunk box
BCAST_MIN_ROWS = 64    # boundary tables from this many rows take K11b
# media one launch takes (csrc/volume_kernel.cu); render/volumes.py
# launches once per group of at most this many
MAX_VOLUMES = 16
N_BOX_COLS = 8         # chunk box: lo (3), hi (3), 2 unused
# (row, lane) pairs per block of the plain version: its ~30 live [rows,
# lanes] f32 tensors stay near 256 MiB
_PAIR_BUDGET = 1 << 21
_INF = float("inf")


def _chunk_plans(slices) -> tuple:
    """Per volume, the ``(start, length)`` chunks covering its slice:
    starts aligned down to 8 rows, lengths up to :data:`BCAST_CHUNK` (the
    JAX package's plan, shared by the kernel and :func:`pack_chunk_boxes`;
    a chunk's rows outside the slice are masked)."""
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


def _prim_lo_hi(prims):
    """Per-row boxes: a sphere's center +- radius, a planar row's four
    corners padded by 1e-4, a box row's own corners, swept over the
    motion; pad rows get inverted boxes."""
    kind = prims.kind
    p0, e1, e2 = prims.p0, prims.e1, prims.e2
    is_sphere = (kind == PRIM_SPHERE)[:, None]
    r = torch.abs(e1[:, 0:1])
    c1, c2, c3 = p0 + e1, p0 + e2, p0 + e1 + e2
    plo = torch.minimum(torch.minimum(p0, c1), torch.minimum(c2, c3)) - 1e-4
    phi = torch.maximum(torch.maximum(p0, c1), torch.maximum(c2, c3)) + 1e-4
    lo = torch.where(is_sphere, p0 - r, plo)
    hi = torch.where(is_sphere, p0 + r, phi)
    if prims.has_box:
        is_box = (kind == PRIM_BOX)[:, None]
        lo = torch.where(is_box, p0, lo)
        hi = torch.where(is_box, e1, hi)
    if prims.has_motion:
        lo = torch.minimum(lo + prims.mv0, lo + prims.mv1)
        hi = torch.maximum(hi + prims.mv0, hi + prims.mv1)
    pad = (kind == PRIM_PAD)[:, None]
    return (torch.where(pad, _INF, lo), torch.where(pad, -_INF, hi))


def pack_chunk_boxes(prims, slices) -> torch.Tensor:
    """[n_chunks, 8] f32: the box of each chunk of :func:`_chunk_plans`
    (volumes in order) over its rows inside the slice; a chunk with none
    gets an inverted box."""
    lo, hi = _prim_lo_hi(prims)
    n = prims.kind.shape[0]
    rows = []
    for (start, count), plan in zip(slices, _chunk_plans(slices)):
        for p, ln in plan:
            a, b = max(p, start), min(p + ln, start + count, n)
            box = torch.zeros(N_BOX_COLS, dtype=torch.float32,
                              device=lo.device)
            if b <= a:
                box[0:3] = _INF
                box[3:6] = -_INF
            else:
                box[0:3] = lo[a:b].amin(0)
                box[3:6] = hi[a:b].amax(0)
            rows.append(box)
    return torch.stack(rows)


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
        "tbl", "cbox", "ox", "oy", "oz", "dx", "dy", "dz", "tm", "out",
        "rows_tested")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in ("n_vol", "has_motion", "has_box")]
        + [("t_min", ctypes.c_float)]
        + [(f, ctypes.c_int * MAX_VOLUMES) for f in ("starts", "counts")])


def _launch(entry: str, vtbl, cbox, rays, slices, t_min, has_motion,
            has_box, count_rows: bool):
    """Check the arguments and launch ``entry``; returns the [3V, R]
    output (and the [R] i32 rows each ray tested with ``count_rows``)."""
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
    check_lanes(zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), rays), r,
                dev)
    out = torch.empty((3 * nv, r), dtype=torch.float32, device=dev)
    counts = (torch.zeros(r, dtype=torch.int32, device=dev) if count_rows
              else None)
    pad = [0] * (MAX_VOLUMES - nv)
    ptr = lambda x: None if x is None else x.data_ptr()
    args = _VolArgs(
        *(ptr(x) for x in (vtbl, cbox) + tuple(rays) + (out, counts)),
        r, nv, int(has_motion), int(has_box), float(t_min),
        (ctypes.c_int * MAX_VOLUMES)(*[s for s, _ in slices], *pad),
        (ctypes.c_int * MAX_VOLUMES)(*[c for _, c in slices], *pad))
    launch(entry, args, dev)
    return out, counts


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


def pallas_volume_crossings_bcast(vtbl, cbox, ox, oy, oz, dx, dy, dz, tm, *,
                                  slices: tuple, t_min: float,
                                  has_motion: bool, has_box: bool = False,
                                  count_rows: bool = False):
    """:func:`pallas_volume_crossings`' contract for boundary tables of
    :data:`BCAST_MIN_ROWS` rows and more (kernel K11b; the JAX package's
    name): each ray skips the chunks whose box ``cbox``
    (:func:`pack_chunk_boxes`) it cannot reach within ``[t_min, t2]``.
    With ``count_rows`` (CUDA only) also returns an [R] i32 tensor of
    the rows each ray tested.

    CPU tensors run :func:`volume_crossings_plain`; CUDA tensors launch
    ``rt_volume_crossings_chunked``
    (``pallas_volume_crossings_bcast.launches`` counts the launches)."""
    rays = (ox, oy, oz, dx, dy, dz, tm)
    slices = tuple(slices)
    dev = ox.device
    if dev.type == "cpu" and not count_rows:
        return volume_crossings_plain(vtbl, *rays, slices=slices,
                                      t_min=t_min, has_motion=has_motion,
                                      has_box=has_box)
    if dev.type != "cuda":
        raise ValueError(f"pallas_volume_crossings_bcast: unsupported device "
                         f"{dev}")
    n_chunks = sum(len(p) for p in _chunk_plans(slices))
    if (cbox.device != dev or cbox.dtype != torch.float32
            or tuple(cbox.shape) != (n_chunks, N_BOX_COLS)
            or not cbox.is_contiguous()):
        raise ValueError(f"cbox: need a contiguous f32 [{n_chunks}, "
                         f"{N_BOX_COLS}] tensor on {dev}")
    out, counts = _launch("rt_volume_crossings_chunked", vtbl, cbox, rays,
                          slices, t_min, has_motion, has_box, count_rows)
    pallas_volume_crossings_bcast.launches += 1
    res = list(out.unbind(0))
    return (res, counts) if count_rows else res


pallas_volume_crossings_bcast.launches = 0
