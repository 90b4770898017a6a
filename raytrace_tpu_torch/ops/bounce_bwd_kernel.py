"""Kernel K7: the backward of one unfused bounce
(``raytrace_tpu/ops/pallas/bounce_bwd_kernel.py``: ``bounce_bwd_megakernel``).

The unfused differentiable step (``diff/mega_bounce.py``) saves its
bounce's inputs; its backward (``diff/lane_replay.py:replay_bwd_soa``)
replays and transposes :func:`lane_replay.lane_math` here, with no
regeneration stage, no parking of dead lanes and no background term (the
caller adds the background's VJP, so any background callable works).

Two modes over one CUDA kernel (``rt_bounce_bwd_replay`` of
``csrc/bounce_bwd_kernel.cu``: the hand-derived adjoint of
``csrc/lane_adjoint.cuh``, shared with K5):
:func:`bounce_bwd_megakernel_reduced`, the fwd+bwd's, reads each lane's
winner row of the per-prim table by index and sums the row gradients onto
the scene's tables in the launch (``csrc/row_reduce.cuh``; plain version
:func:`bounce_bwd_megakernel_reduced_plain`), and
:func:`bounce_bwd_megakernel`, the per-lane mode for checks, takes the
rows gathered per lane and returns every lane's row gradients (plain
version :func:`bounce_bwd_megakernel_plain`, under torch autograd).  CUDA
tensors launch the kernel, CPU tensors run the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..diff.lane_replay import lane_math, tgt_from_table
from .bounce_kernel import N_TCOLS, N_U, check_lanes
from .row_reduce import (
    GATH_EXTRA as N_GATH_EXTRA, RowTables, _RowArgs, per_lane_args,
    reduce_rows_plain, row_buffers, winner_rows,
)

N_LANE = 10         # o (3), d (3), time, thr (3)
N_CT = 12           # o2 (3), d2 (3), radiance contribution (3), thr2 (3)
N_LANE_OUT = 11     # lane (10), miss
N_OUT_EXTRA = 18    # c0 (3), c1 (3), param, lane (10), miss


def bounce_bwd_megakernel_plain(ttbl, gath, bi, lane, u_cols, al, cts, *,
                                n_targets: int, has_motion: bool,
                                has_box: bool, t_min: float, n_row: int):
    """K7 under torch autograd over ``lane_math(exact_trig=False)``, as the
    JAX package's kernel body calls ``jax.vjp(lane_math)``: the same
    arguments and outputs as :func:`bounce_bwd_megakernel`, on any
    device."""
    tgt = tgt_from_table(ttbl, n_targets)
    det = (tuple(gath[n_row + 7:n_row + 18]) + tuple(u_cols)
           + (al, torch.where(bi >= 0.0, 1.0, 0.0)))
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True)
              for x in tuple(gath[:n_row + 7]) + tuple(lane)]
        outs = lane_math(tuple(xs), det, tgt, has_motion=has_motion,
                         has_box=has_box, t_min=t_min, n_targets=n_targets)
        keep = [k for k in range(N_CT) if outs[k].requires_grad]
        gs = torch.autograd.grad([outs[k] for k in keep], xs,
                                 grad_outputs=[cts[k] for k in keep],
                                 allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return tuple(gs) + (outs[12].detach(),)


class _ReplayArgs(ctypes.Structure):
    """Mirror of ``ReplayArgs`` in csrc/bounce_bwd_kernel.cu."""
    _fields_ = ([("ttbl", ctypes.c_void_p), ("bi", ctypes.c_void_p),
                 ("lane", ctypes.c_void_p * N_LANE),
                 ("u", ctypes.c_void_p * N_U), ("al", ctypes.c_void_p),
                 ("cts", ctypes.c_void_p * N_CT), ("out", ctypes.c_void_p),
                 ("rows", _RowArgs), ("n_lanes", ctypes.c_int64)]
                + [(f, ctypes.c_int) for f in (
                    "n_targets", "has_motion", "has_box", "n_row")]
                + [("t_min", ctypes.c_float)])


def replay_args(ttbl, rows: _RowArgs, bi, lane, u_cols, al, cts, out, *,
                n_targets: int, has_motion: bool, has_box: bool,
                t_min: float, n_row: int) -> _ReplayArgs:
    """The kernel's argument struct for tensors that outlive it."""
    ptrs = lambda xs, n: (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs))
    return _ReplayArgs(
        ttbl.data_ptr(), bi.data_ptr(), ptrs(lane, N_LANE),
        ptrs(u_cols, N_U), al.data_ptr(), ptrs(cts, N_CT), out.data_ptr(),
        rows, al.shape[0], n_targets, int(has_motion), int(has_box), n_row,
        float(t_min))


def _check(name, ttbl, bi, lane, u_cols, al, cts, *, n_targets: int,
           has_motion: bool, n_row: int, **_):
    """The checks of a CUDA launch of either mode."""
    dev = al.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if n_row != (15 if has_motion else 9):
        raise ValueError(f"n_row={n_row} with has_motion={has_motion}")
    if len(lane) != N_LANE or len(u_cols) != N_U or len(cts) != N_CT:
        raise ValueError(f"{name}: wrong column counts")
    check_lanes([("bi", bi), ("al", al)]
                + [(f"lane[{k}]", x) for k, x in enumerate(lane)]
                + [(f"u_cols[{k}]", x) for k, x in enumerate(u_cols)]
                + [(f"cts[{k}]", x) for k, x in enumerate(cts)],
                al.shape[0], dev)
    if (ttbl.device != dev or ttbl.dtype != torch.float32 or ttbl.dim() != 2
            or ttbl.shape[1] != N_TCOLS or not ttbl.is_contiguous()
            or not 0 <= n_targets <= ttbl.shape[0]):
        raise ValueError("ttbl: need a contiguous f32 [>=n_targets, 16] "
                         f"tensor on {dev}")


def bounce_bwd_megakernel(ttbl, gath, bi, lane, u_cols, al, cts, *,
                          n_targets: int, has_motion: bool, has_box: bool,
                          t_min: float, n_row: int):
    """Backward of one unfused bounce for every lane, per lane.

    ``gath``: the ``n_row + 18`` gathered columns (winner rows p0 e1 e2
    [mv0 mv1], c0, c1, param, kind_p, kind_m, texkind, f0, f1, uvs (6));
    ``bi`` the winner index as f32 (-1 on a miss); ``lane`` the bounce's
    10 inputs o (3), d (3), time, thr (3) (dead lanes not parked);
    ``u_cols`` its 8 uniform columns; ``al`` 0/1; ``cts`` the 12
    cotangents o2 (3), d2 (3), radiance contribution (3), thr2 (3).  All
    [R] (``u_cols`` may be an [8, R] tensor).  ``ttbl`` is the [T, 16]
    target table.

    Returns the ``n_row + 18`` [R] outputs: the gradients of the winner
    rows (n_row), c0 (3), c1 (3), param, the 7 ray components and the 3
    throughputs, then the miss flag.

    CPU tensors run :func:`bounce_bwd_megakernel_plain`; CUDA tensors
    launch the kernel's per-lane mode (``bounce_bwd_megakernel.launches``
    counts the launches)."""
    kw = dict(n_targets=n_targets, has_motion=has_motion, has_box=has_box,
              t_min=t_min, n_row=n_row)
    dev = al.device
    if dev.type == "cpu":
        return bounce_bwd_megakernel_plain(ttbl, gath, bi, lane, u_cols, al,
                                           cts, **kw)
    u_cols = tuple(u_cols)
    _check("bounce_bwd_megakernel", ttbl, bi, lane, u_cols, al, cts, **kw)
    if len(gath) != n_row + N_GATH_EXTRA:
        raise ValueError("bounce_bwd_megakernel: wrong column counts")
    from ._build import launch
    r = al.shape[0]
    rows, cols = per_lane_args(gath, r, dev)
    out = torch.empty((n_row + N_OUT_EXTRA, r), dtype=torch.float32,
                      device=dev)
    launch("rt_bounce_bwd_replay",
           replay_args(ttbl, rows, bi, lane, u_cols, al, cts, out, **kw), dev)
    bounce_bwd_megakernel.launches += 1
    return tuple(out.unbind(0))


bounce_bwd_megakernel.launches = 0


def bounce_bwd_megakernel_reduced_plain(ttbl, tables: RowTables, bi, lane,
                                        u_cols, al, cts, **kw):
    """The reduced K7's plain version: the winner rows gathered per lane,
    :func:`bounce_bwd_megakernel_plain`, then the plain reduction
    (``row_reduce.reduce_rows_plain``)."""
    g = bounce_bwd_megakernel_plain(ttbl, winner_rows(tables, bi), bi, lane,
                                    u_cols, al, cts, **kw)
    n = kw["n_row"] + 7
    return g[n:], reduce_rows_plain(tables, g[:n], bi, kw["n_row"])


def bounce_bwd_megakernel_reduced(ttbl, tables: RowTables, bi, lane, u_cols,
                                  al, cts, *, n_targets: int,
                                  has_motion: bool, has_box: bool,
                                  t_min: float, n_row: int):
    """Backward of one unfused bounce, its row gradients reduced onto the
    scene's tables.

    The arguments are :func:`bounce_bwd_megakernel`'s, with ``tables``
    (``row_reduce.RowTables``) in place of the gathered columns.  Returns
    ``(lane, rows)``: the 11 [R] lane outputs (the gradients of the 7 ray
    components and the 3 throughputs, the miss flag) and the
    ``row_reduce.RowGrads`` of the winner rows, the material params and
    the texture colours.

    CPU tensors run :func:`bounce_bwd_megakernel_reduced_plain`; CUDA
    tensors launch the kernel, which reads the rows by index and sums
    their gradients in the launch (``bounce_bwd_megakernel_reduced.
    launches`` counts the launches)."""
    kw = dict(n_targets=n_targets, has_motion=has_motion, has_box=has_box,
              t_min=t_min, n_row=n_row)
    dev = al.device
    if dev.type == "cpu":
        return bounce_bwd_megakernel_reduced_plain(ttbl, tables, bi, lane,
                                                   u_cols, al, cts, **kw)
    u_cols = tuple(u_cols)
    _check("bounce_bwd_megakernel_reduced", ttbl, bi, lane, u_cols, al, cts,
           **kw)
    from ._build import launch
    rows, grads = row_buffers(tables, n_row, dev)
    out = torch.empty((N_LANE_OUT, al.shape[0]), dtype=torch.float32,
                      device=dev)
    launch("rt_bounce_bwd_replay",
           replay_args(ttbl, rows, bi, lane, u_cols, al, cts, out, **kw), dev)
    bounce_bwd_megakernel_reduced.launches += 1
    return tuple(out.unbind(0)), grads


bounce_bwd_megakernel_reduced.launches = 0
