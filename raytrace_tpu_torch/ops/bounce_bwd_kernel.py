"""Kernel K7: the backward of one unfused bounce
(``raytrace_tpu/ops/pallas/bounce_bwd_kernel.py``: ``bounce_bwd_megakernel``).

The unfused differentiable step (``diff/mega_bounce.py``) saves its
bounce's inputs; its backward gathers each lane's winner, material and
texture rows by index (``diff/lane_replay.py:replay_bwd_soa``) and replays
and transposes :func:`lane_replay.lane_math` here, with no regeneration
stage, no parking of dead lanes and no background term (the caller adds
the background's VJP, so any background callable works).

:func:`bounce_bwd_megakernel` launches ``rt_bounce_bwd_replay`` of
``csrc/bounce_bwd_kernel.cu`` for CUDA tensors (the hand-derived adjoint of
``csrc/lane_adjoint.cuh``, shared with K5) and runs
:func:`bounce_bwd_megakernel_plain`, the same function under torch
autograd, for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ..diff.lane_replay import lane_math, tgt_from_table
from .bounce_bwd_gather_kernel import MAX_ROW, N_GATH_EXTRA
from .bounce_kernel import N_TCOLS, N_U, check_lanes

N_LANE = 10         # o (3), d (3), time, thr (3)
N_CT = 12           # o2 (3), d2 (3), radiance contribution (3), thr2 (3)
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
    _fields_ = ([("ttbl", ctypes.c_void_p),
                 ("gath", ctypes.c_void_p * (MAX_ROW + N_GATH_EXTRA)),
                 ("bi", ctypes.c_void_p), ("lane", ctypes.c_void_p * N_LANE),
                 ("u", ctypes.c_void_p * N_U), ("al", ctypes.c_void_p),
                 ("cts", ctypes.c_void_p * N_CT), ("out", ctypes.c_void_p),
                 ("n_lanes", ctypes.c_int64)]
                + [(f, ctypes.c_int) for f in (
                    "n_targets", "has_motion", "has_box", "n_row")]
                + [("t_min", ctypes.c_float)])


def replay_args(ttbl, gath, bi, lane, u_cols, al, cts, out, *,
                n_targets: int, has_motion: bool, has_box: bool,
                t_min: float, n_row: int) -> _ReplayArgs:
    """The kernel's argument struct for tensors that outlive it."""
    ptrs = lambda xs, n: (ctypes.c_void_p * n)(
        *([x.data_ptr() for x in xs] + [0] * (n - len(xs))))
    return _ReplayArgs(
        ttbl.data_ptr(), ptrs(gath, MAX_ROW + N_GATH_EXTRA), bi.data_ptr(),
        ptrs(lane, N_LANE), ptrs(u_cols, N_U), al.data_ptr(),
        ptrs(cts, N_CT), out.data_ptr(), al.shape[0], n_targets,
        int(has_motion), int(has_box), n_row, float(t_min))


def bounce_bwd_megakernel(ttbl, gath, bi, lane, u_cols, al, cts, *,
                          n_targets: int, has_motion: bool, has_box: bool,
                          t_min: float, n_row: int):
    """Backward of one unfused bounce for every lane.

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
    launch the kernel (``bounce_bwd_megakernel.launches`` counts the
    launches)."""
    kw = dict(n_targets=n_targets, has_motion=has_motion, has_box=has_box,
              t_min=t_min, n_row=n_row)
    dev = al.device
    if dev.type == "cpu":
        return bounce_bwd_megakernel_plain(ttbl, gath, bi, lane, u_cols, al,
                                           cts, **kw)
    if dev.type != "cuda":
        raise ValueError(f"bounce_bwd_megakernel: unsupported device {dev}")
    if n_row != (15 if has_motion else 9):
        raise ValueError(f"n_row={n_row} with has_motion={has_motion}")
    u_cols = tuple(u_cols)
    if (len(gath) != n_row + N_GATH_EXTRA or len(lane) != N_LANE
            or len(u_cols) != N_U or len(cts) != N_CT):
        raise ValueError("bounce_bwd_megakernel: wrong column counts")
    r = al.shape[0]
    check_lanes([(f"gath[{k}]", x) for k, x in enumerate(gath)]
                + [("bi", bi), ("al", al)]
                + [(f"lane[{k}]", x) for k, x in enumerate(lane)]
                + [(f"u_cols[{k}]", x) for k, x in enumerate(u_cols)]
                + [(f"cts[{k}]", x) for k, x in enumerate(cts)], r, dev)
    if (ttbl.device != dev or ttbl.dtype != torch.float32 or ttbl.dim() != 2
            or ttbl.shape[1] != N_TCOLS or not ttbl.is_contiguous()
            or not 0 <= n_targets <= ttbl.shape[0]):
        raise ValueError("ttbl: need a contiguous f32 [>=n_targets, 16] "
                         f"tensor on {dev}")
    from ._build import launch
    out = torch.empty((n_row + N_OUT_EXTRA, r), dtype=torch.float32,
                      device=dev)
    launch("rt_bounce_bwd_replay",
           replay_args(ttbl, gath, bi, lane, u_cols, al, cts, out, **kw),
           dev)
    bounce_bwd_megakernel.launches += 1
    return tuple(out.unbind(0))


bounce_bwd_megakernel.launches = 0
