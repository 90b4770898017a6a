"""The winner-row table and the row-gradient reduction of the backward
kernels K5 and K7 (``csrc/row_reduce.cuh``).

Each lane of the backward kernels reads its winner's row of
:class:`RowTables` (:func:`row_tables`: per prim the columns lane_math
reads of it, with the prim's material and texture row) by index, and the
lanes' row gradients (winner rows p0 e1 e2 [mv0 mv1], c0, c1, param:
``n_row + 7`` columns) are summed inside the kernel.
:func:`row_buffers` allocates what a reduced launch writes and picks its
mode (:func:`row_mode`): the table staged in shared memory with
per-block partials summed in a fixed order, or read from device memory
with atomic sums.  :func:`reduce_rows_plain` is the plain version of the
reduction: an ``index_add_`` over the lanes onto the prims, then one over
the prims onto the materials and textures.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import torch

PER_LANE, STAGED, GLOBAL = 0, 1, 2   # csrc/row_reduce.cuh:RowMode
GATH_EXTRA = 18     # table columns after the winner rows: c0 (3), c1 (3),
                    # param, kind_p, kind_m, texkind, f0, f1, uvs (6)
ROW_WARPS = 4       # per-warp accumulators of a staged block
STAGE_BYTES = 40 * 1024   # csrc/row_reduce.cuh:kStageBytes
# partial slabs a staged launch may write, per streaming multiprocessor:
# the kernel runs as many blocks as the card holds at once, capped by this
PART_PER_SM = 8


@dataclasses.dataclass(frozen=True)
class RowTables:
    """What the reduced backward kernels read per prim: ``cols`` the [P,
    n_row + 18] f32 column table, ``mat`` and ``tex`` each prim's
    material and texture row (i32 [P]); ``n_mats`` and ``n_tex`` the
    sizes of the material and texture tables."""
    cols: torch.Tensor
    mat: torch.Tensor
    tex: torch.Tensor
    n_mats: int
    n_tex: int

    @property
    def n_prims(self) -> int:
        return self.cols.shape[0]


def row_tables(scene, n_row: int) -> RowTables:
    """:class:`RowTables` of a (detached) scene: per prim its rows p0 e1
    e2 [mv0 mv1], its texture's c0 and c1, its material's param, its
    kind, its material's and texture's kinds, its texture's checker
    counts f0 and f1 and its triangle corner uvs (6)."""
    p, m, tx = scene.prims, scene.materials, scene.textures
    mat = p.mat.long()
    tex = m.tex[mat].long()
    parts = [p.p0, p.e1, p.e2] + ([p.mv0, p.mv1] if n_row == 15 else [])
    f = lambda x: x.to(torch.float32)[:, None]
    cols = torch.cat(parts + [tx.c0[tex], tx.c1[tex], f(m.param[mat]),
                              f(p.kind), f(m.kind[mat]), f(tx.kind[tex]),
                              f(tx.f0[tex]), f(tx.f1[tex]),
                              p.uvs.reshape(-1, 6)], dim=1)
    return RowTables(cols=cols.contiguous(), mat=mat.to(torch.int32),
                     tex=tex.to(torch.int32), n_mats=m.param.shape[0],
                     n_tex=tx.c0.shape[0])


class RowGrads(typing.NamedTuple):
    """The reduced row gradients: ``g_ptab`` [P, n_row] (p0 e1 e2 [mv0
    mv1]), ``g_mparam`` [n_mats], ``g_tc0`` and ``g_tc1`` [n_tex, 3]."""
    g_ptab: torch.Tensor
    g_mparam: torch.Tensor
    g_tc0: torch.Tensor
    g_tc1: torch.Tensor


def row_mode(n_prims: int, n_row: int) -> int:
    """STAGED when the table and the per-warp accumulators fit the
    kernels' shared memory, else GLOBAL."""
    n = 4 * n_prims * ((n_row + GATH_EXTRA) + ROW_WARPS * (n_row + 7))
    return STAGED if n <= STAGE_BYTES else GLOBAL


def reduce_rows_plain(tables: RowTables, rows_g, bi, n_row: int) -> RowGrads:
    """The reduction's plain version: the per-lane row gradients
    ``rows_g`` (``n_row + 7`` [R] columns) of the lanes whose winner index
    is ``bi`` (f32, -1 on a miss: such a lane counts for row 0, as in the
    kernels) summed onto their prims, then the prim sums mapped onto the
    materials (param) and textures (c0, c1), as the finishing launch
    does."""
    rows = torch.stack(tuple(rows_g), dim=1)
    dt, dev = rows.dtype, rows.device
    sums = torch.zeros((tables.n_prims, n_row + 7), dtype=dt,
                       device=dev).index_add_(
        0, torch.clamp(bi, min=0).long(), rows)
    g_mparam = torch.zeros(tables.n_mats, dtype=dt, device=dev).index_add_(
        0, tables.mat.long(), sums[:, n_row + 6])
    g_tex = torch.zeros((tables.n_tex, 6), dtype=dt, device=dev).index_add_(
        0, tables.tex.long(), sums[:, n_row:n_row + 6])
    return RowGrads(sums[:, :n_row], g_mparam, g_tex[:, :3], g_tex[:, 3:])


def winner_rows(tables: RowTables, bi):
    """The ``n_row + 18`` table columns gathered per lane by the winner
    index ``bi`` (the per-lane kernels' and plain versions' input), as
    rows of one [n_row + 18, R] tensor."""
    pi = torch.clamp(bi, min=0).long()
    return tuple(tables.cols[pi].T.contiguous().unbind(0))


class _RowArgs(ctypes.Structure):
    """Mirror of ``RowArgs`` in csrc/row_reduce.cuh."""
    _fields_ = [("cols", ctypes.c_void_p), ("mat", ctypes.c_void_p),
                ("tex", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("sums", ctypes.c_void_p), ("g_mparam", ctypes.c_void_p),
                ("g_tex", ctypes.c_void_p), ("n_part", ctypes.c_int64),
                ("n_prims", ctypes.c_int), ("n_mats", ctypes.c_int),
                ("n_tex", ctypes.c_int), ("mode", ctypes.c_int)]


def per_lane_args(gath, n_lanes: int, dev):
    """``(args, cols)``: the per-lane mode's :class:`_RowArgs` over the
    ``gath`` columns as one [n_row + 18, R] tensor ``cols`` (keep it alive
    over the launch): ``gath`` itself when its columns are the rows of one
    (:func:`winner_rows`'), else stacked."""
    for k, x in enumerate(gath):
        if (x.device != dev or x.dtype != torch.float32 or x.dim() != 1
                or x.shape[0] != n_lanes):
            raise ValueError(f"gath[{k}]: need an f32 [{n_lanes}] tensor on "
                             f"{dev}")
    base = gath[0].data_ptr()
    if all(x.is_contiguous() and x.data_ptr() == base + 4 * k * n_lanes
           for k, x in enumerate(gath)):
        cols = gath[0]
    else:
        cols = torch.stack(tuple(gath))
        base = cols.data_ptr()
    return _RowArgs(base, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, PER_LANE), cols


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_buffers(tables: RowTables, n_row: int, dev):
    """``(args, grads)`` of a reduced launch on ``dev``: the
    :class:`_RowArgs` and the :class:`RowGrads` the finishing launches
    fill (views of one buffer, which also holds the scratch), in
    :func:`row_mode`'s mode."""
    t = tables
    p, nc = t.n_prims, n_row + 7
    if (t.cols.device != dev or t.cols.dtype != torch.float32
            or tuple(t.cols.shape) != (p, n_row + GATH_EXTRA)
            or not t.cols.is_contiguous()):
        raise ValueError(f"row tables: need a contiguous f32 [P, {n_row} + "
                         f"18] table on {dev}")
    for name, x in (("mat", t.mat), ("tex", t.tex)):
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != (p,) or not x.is_contiguous()):
            raise ValueError(f"row tables: {name}: need a contiguous i32 "
                             f"[{p}] tensor on {dev}")
    mode = row_mode(p, n_row)
    n_part = PART_PER_SM * _n_sm(dev.index or 0) if mode == STAGED else 0
    buf = torch.empty(p * nc + t.n_mats + 6 * t.n_tex + n_part * p * nc,
                      dtype=torch.float32, device=dev)
    sums = buf[:p * nc].view(p, nc)
    g_mparam = buf[p * nc:p * nc + t.n_mats]
    g_tex = buf[p * nc + t.n_mats:p * nc + t.n_mats + 6 * t.n_tex].view(
        t.n_tex, 6)
    part = buf[p * nc + t.n_mats + 6 * t.n_tex:]
    args = _RowArgs(t.cols.data_ptr(), t.mat.data_ptr(), t.tex.data_ptr(),
                    part.data_ptr() if n_part else 0, sums.data_ptr(),
                    g_mparam.data_ptr(), g_tex.data_ptr(), n_part, p,
                    t.n_mats, t.n_tex, mode)
    grads = RowGrads(sums[:, :n_row], g_mparam, g_tex[:, :3], g_tex[:, 3:])
    return args, grads
