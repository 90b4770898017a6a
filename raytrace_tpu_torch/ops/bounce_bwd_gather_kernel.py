"""Kernel K5: the backward of one fused wavefront iteration
(``raytrace_tpu/ops/pallas/bounce_bwd_gather_kernel.py``:
``bounce_bwd_regen_pre_megakernel``).

The detached regeneration stage (counter hash, thin-lens camera) is
rebuilt from the saved (pixel, sample, depth), and the bounce is replayed
and transposed: :func:`lane_replay.lane_math` with the regeneration
selects, the far parking of dead lanes and the background term around it.

Two modes over one CUDA kernel (``rt_bounce_bwd`` of
``csrc/bounce_bwd_kernel.cu``, a hand-derived adjoint,
``csrc/lane_adjoint.cuh``):

* :func:`bounce_bwd_regen_pre_reduced`, the fwd+bwd's: each lane reads
  its winner's row of the per-prim table by index and the row gradients
  are summed onto the scene's tables inside the launch
  (``csrc/row_reduce.cuh``); per lane only the 13 gradients autograd
  needs come back.  Plain version :func:`bounce_bwd_regen_pre_reduced_plain`.
* :func:`bounce_bwd_regen_pre_megakernel`, the per-lane mode that checks
  the adjoint lane by lane: the rows arrive gathered per lane and every
  lane's row gradients come back.  Plain version
  :func:`bounce_bwd_regen_pre_plain`, under torch autograd.

CUDA tensors launch the kernel, CPU tensors run the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import rng
from ..diff.lane_replay import lane_math, tgt_from_table
from ..render.camera import rays_from_table
from .bounce_kernel import N_U, N_TCOLS, check_lanes
from .iter_kernel import BG_GRAY, BG_SKY, N_CAM, N_KT
from .row_reduce import (
    GATH_EXTRA as N_GATH_EXTRA, RowTables, _RowArgs,
    per_lane_args, reduce_rows_plain, row_buffers, winner_rows,
)

N_CTS = 13          # o2 (3), d2 (3), time, rad2 (3), thr2 (3)
N_LANE_OUT = 13     # comps (7), rad (3), thr (3)
N_OUT_EXTRA = 20    # c0 (3), c1 (3), param, comps (7), rad (3), thr (3)
# dead lanes' origin in the replay: far outside the scene, but small
# enough that the record math stays finite (the forward parks at 3e18)
FAR = 3e9


def regen_stage(kt, cam, pix, smp, dep, alive, n_u: int, width: int):
    """The detached regeneration of kernel B for the saved lane
    coordinates: ``(can_f, alive_pre_f, us, new7)`` with ``us`` the
    ``n_u + 6`` uniform columns and ``new7`` the regenerated ray
    (origin, direction, time) of every lane."""
    can = ~alive & (smp < int(kt[2]))
    can_f = torch.where(can, 1.0, 0.0)
    smp2 = torch.where(can, smp + 1, smp)
    dep_pre = torch.where(can, 0, dep)
    alive_pre_f = torch.where(alive | can, 1.0, 0.0)
    keys = rng.mix_depth(rng.ray_keys_fast(kt[:2].to(pix.device), pix, smp2),
                         dep_pre)
    us = rng.uniform_cols(keys, n_u + 6)
    new7 = rays_from_table(cam.tolist(), width, pix, us[n_u:n_u + 5])
    return can_f, alive_pre_f, us, tuple(new7.unbind(0))


def bounce_bwd_regen_pre_plain(ttbl, kt, cam, gath, bi, ints, al, comps_in,
                               thr_in, scale, cts, *, n_targets: int,
                               has_motion: bool, has_box: bool, t_min: float,
                               n_row: int, n_u: int, width: int,
                               bg_kind: int):
    """K5 under torch autograd: the same arguments and outputs as
    :func:`bounce_bwd_regen_pre_megakernel`, on any device."""
    pix, smp, dep = ints
    can_f, alive_pre_f, us, new7 = regen_stage(
        kt, cam, pix, smp, dep, al > 0.5, n_u, width)
    c = cam.tolist()
    tgt = tgt_from_table(ttbl, n_targets)
    det = (tuple(gath[n_row + 7:n_row + 18]) + tuple(us[:N_U])
           + (alive_pre_f, torch.where(bi >= 0.0, 1.0, 0.0)))
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in
              tuple(comps_in) + tuple(thr_in) + tuple(gath[:n_row + 7])]
        ci, ti = xs[:7], xs[7:10]
        rows, c0, c1, par = (xs[10:10 + n_row], xs[10 + n_row:13 + n_row],
                             xs[13 + n_row:16 + n_row], xs[16 + n_row])
        pre = [can_f * n + (1.0 - can_f) * x for n, x in zip(new7, ci)]
        o_n = [alive_pre_f * p + (1.0 - alive_pre_f) * FAR for p in pre[:3]]
        thr_pre = [can_f + (1.0 - can_f) * t for t in ti]
        outs = lane_math(tuple(rows) + tuple(c0) + tuple(c1) + (par,)
                         + tuple(o_n) + tuple(pre[3:7]) + tuple(thr_pre),
                         det, tgt, has_motion=has_motion, has_box=has_box,
                         t_min=t_min, n_targets=n_targets)
        if bg_kind == BG_SKY:
            a_sky = 0.5 * (pre[4] + 1.0)
            bgc = ((1.0 - a_sky) + a_sky * 0.5, (1.0 - a_sky) + a_sky * 0.7,
                   (1.0 - a_sky) + a_sky * 1.0)
        elif bg_kind == BG_GRAY:
            t_g = (pre[4] + 1.0) * 0.5
            bgc = (t_g, t_g, t_g)
        else:
            bgc = (c[20], c[21], c[22])
        rad = [outs[6 + k] + outs[12] * tp * bgc[k]
               for k, tp in enumerate(thr_pre)]
        ys = list(outs[:6]) + rad + list(outs[9:12]) + [pre[6]]
        ct = list(cts)
        gys = ct[0:6] + ct[7:10] + [x * scale for x in ct[10:13]] + [ct[6]]
        keep = [k for k, y in enumerate(ys) if y.requires_grad]
        gs = torch.autograd.grad([ys[k] for k in keep], xs,
                                 grad_outputs=[gys[k] for k in keep],
                                 allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    keep_f = 1.0 - can_f
    return (tuple(gs[10:17 + n_row]) + tuple(gs[0:7])
            + tuple(ct[7 + k] * keep_f for k in range(3)) + tuple(gs[7:10]))


class _BwdArgs(ctypes.Structure):
    """Mirror of ``BwdArgs`` in csrc/bounce_bwd_kernel.cu."""
    _fields_ = ([("ttbl", ctypes.c_void_p), ("cam", ctypes.c_void_p),
                 ("kt", ctypes.c_void_p), ("bi", ctypes.c_void_p),
                 ("pix", ctypes.c_void_p), ("smp", ctypes.c_void_p),
                 ("dep", ctypes.c_void_p), ("al", ctypes.c_void_p),
                 ("comps", ctypes.c_void_p * 7), ("thr", ctypes.c_void_p * 3),
                 ("scale", ctypes.c_void_p),
                 ("cts", ctypes.c_void_p * N_CTS), ("out", ctypes.c_void_p),
                 ("rows", _RowArgs), ("n_lanes", ctypes.c_int64)]
                + [(f, ctypes.c_int) for f in (
                    "n_targets", "has_motion", "has_box", "n_row", "width",
                    "bg_kind")]
                + [("t_min", ctypes.c_float)])


def bwd_args(ttbl, kt, cam, rows: _RowArgs, bi, ints, al, comps_in, thr_in,
             scale, cts, out, *, n_targets: int, has_motion: bool,
             has_box: bool, t_min: float, n_row: int, n_u: int, width: int,
             bg_kind: int) -> _BwdArgs:
    """The kernel's argument struct for tensors that outlive it."""
    ptrs = lambda xs, n: (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs))
    return _BwdArgs(
        ttbl.data_ptr(), cam.data_ptr(), kt.data_ptr(), bi.data_ptr(),
        *(x.data_ptr() for x in ints), al.data_ptr(), ptrs(comps_in, 7),
        ptrs(thr_in, 3), scale.data_ptr(), ptrs(cts, N_CTS), out.data_ptr(),
        rows, al.shape[0], n_targets, int(has_motion), int(has_box), n_row,
        width, bg_kind, float(t_min))


def _check(name, kt, cam, ttbl, bi, ints, al, comps_in, thr_in, scale, cts,
           *, n_targets: int, has_motion: bool, n_row: int, n_u: int, **_):
    """The checks of a CUDA launch of either mode."""
    dev = al.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if n_u != N_U:
        raise ValueError(f"n_u={n_u}: the kernel draws {N_U} bounce "
                         "uniforms (media, whose columns follow, take the "
                         "generic bounce)")
    if n_row != (15 if has_motion else 9):
        raise ValueError(f"n_row={n_row} with has_motion={has_motion}")
    if (len(ints) != 3 or len(comps_in) != 7 or len(thr_in) != 3
            or len(cts) != N_CTS):
        raise ValueError(f"{name}: wrong column counts")
    r = al.shape[0]
    check_lanes(zip(("pix", "smp", "dep"), ints), r, dev, torch.int32)
    check_lanes([("bi", bi), ("al", al), ("scale", scale)]
                + [(f"comps_in[{k}]", x) for k, x in enumerate(comps_in)]
                + [(f"thr_in[{k}]", x) for k, x in enumerate(thr_in)]
                + [(f"cts[{k}]", x) for k, x in enumerate(cts)], r, dev)
    check_lanes([("cam", cam)], N_CAM, dev)
    check_lanes([("kt", kt)], N_KT, dev, torch.int32)
    if (ttbl.device != dev or ttbl.dtype != torch.float32 or ttbl.dim() != 2
            or ttbl.shape[1] != N_TCOLS or not ttbl.is_contiguous()
            or not 0 <= n_targets <= ttbl.shape[0]):
        raise ValueError("ttbl: need a contiguous f32 [>=n_targets, 16] "
                         f"tensor on {dev}")


def bounce_bwd_regen_pre_megakernel(ttbl, kt, cam, gath, bi, ints, al,
                                    comps_in, thr_in, scale, cts, *,
                                    n_targets: int, has_motion: bool,
                                    has_box: bool, t_min: float, n_row: int,
                                    n_u: int, width: int, bg_kind: int):
    """Backward of one fused iteration for every lane, per lane.

    ``gath``: the ``n_row + 18`` gathered columns (winner rows p0 e1 e2
    [mv0 mv1], c0, c1, param, kind_p, kind_m, texkind, f0, f1, uvs (6));
    ``bi`` the winner index as f32 (-1 on a miss); ``ints`` = (pix, smp,
    dep) i32; ``al`` 0/1; ``comps_in`` (7) and ``thr_in`` (3) the
    iteration's inputs; ``scale`` its RR factor; ``cts`` the 13
    cotangents o2 (3), d2 (3), time, rad2 (3), thr2 (3).  All [R].
    ``ttbl`` is the [T, 16] target table, ``cam`` the [24] table of
    ``iter_kernel.pack_cam``, ``kt`` the [4] i32 table of ``pack_kt``.

    Returns the ``n_row + 20`` [R] gradients: winner rows (n_row), c0
    (3), c1 (3), param, comps_in (7), rad_in (3), thr_in (3).

    CPU tensors run :func:`bounce_bwd_regen_pre_plain`; CUDA tensors
    launch the kernel's per-lane mode
    (``bounce_bwd_regen_pre_megakernel.launches`` counts the launches)."""
    kw = dict(n_targets=n_targets, has_motion=has_motion, has_box=has_box,
              t_min=t_min, n_row=n_row, n_u=n_u, width=width,
              bg_kind=bg_kind)
    dev = al.device
    if dev.type == "cpu":
        return bounce_bwd_regen_pre_plain(ttbl, kt, cam, gath, bi, ints, al,
                                          comps_in, thr_in, scale, cts, **kw)
    _check("bounce_bwd_regen_pre_megakernel", kt, cam, ttbl, bi, ints, al,
           comps_in, thr_in, scale, cts, **kw)
    if len(gath) != n_row + N_GATH_EXTRA:
        raise ValueError("bounce_bwd_regen_pre_megakernel: wrong column "
                         "counts")
    from ._build import launch
    r = al.shape[0]
    rows, cols = per_lane_args(gath, r, dev)
    out = torch.empty((n_row + N_OUT_EXTRA, r), dtype=torch.float32,
                      device=dev)
    launch("rt_bounce_bwd", bwd_args(ttbl, kt, cam, rows, bi, ints, al,
                                     comps_in, thr_in, scale, cts, out,
                                     **kw), dev)
    bounce_bwd_regen_pre_megakernel.launches += 1
    return tuple(out.unbind(0))


bounce_bwd_regen_pre_megakernel.launches = 0


def bounce_bwd_regen_pre_reduced_plain(ttbl, kt, cam, tables: RowTables, bi,
                                       ints, al, comps_in, thr_in, scale,
                                       cts, **kw):
    """The reduced K5's plain version: the winner rows gathered per lane,
    :func:`bounce_bwd_regen_pre_plain`, then the plain reduction
    (``row_reduce.reduce_rows_plain``)."""
    g = bounce_bwd_regen_pre_plain(ttbl, kt, cam, winner_rows(tables, bi),
                                   bi, ints, al, comps_in, thr_in, scale,
                                   cts, **kw)
    n = kw["n_row"] + 7
    return g[n:], reduce_rows_plain(tables, g[:n], bi, kw["n_row"])


def bounce_bwd_regen_pre_reduced(ttbl, kt, cam, tables: RowTables, bi, ints,
                                 al, comps_in, thr_in, scale, cts, *,
                                 n_targets: int, has_motion: bool,
                                 has_box: bool, t_min: float, n_row: int,
                                 n_u: int, width: int, bg_kind: int):
    """Backward of one fused iteration, its row gradients reduced onto
    the scene's tables.

    The arguments are :func:`bounce_bwd_regen_pre_megakernel`'s, with
    ``tables`` (``row_reduce.RowTables``: the per-prim column table and
    each prim's material and texture row) in place of the gathered
    columns.  Returns ``(lane, rows)``: the 13 [R] lane gradients
    comps_in (7), rad_in (3), thr_in (3), and the ``row_reduce.RowGrads``
    of the winner rows, the material params and the texture colours.

    CPU tensors run :func:`bounce_bwd_regen_pre_reduced_plain`; CUDA
    tensors launch the kernel, which reads the rows by index and sums
    their gradients in the launch
    (``bounce_bwd_regen_pre_reduced.launches`` counts the launches)."""
    kw = dict(n_targets=n_targets, has_motion=has_motion, has_box=has_box,
              t_min=t_min, n_row=n_row, n_u=n_u, width=width,
              bg_kind=bg_kind)
    dev = al.device
    if dev.type == "cpu":
        return bounce_bwd_regen_pre_reduced_plain(
            ttbl, kt, cam, tables, bi, ints, al, comps_in, thr_in, scale, cts,
            **kw)
    _check("bounce_bwd_regen_pre_reduced", kt, cam, ttbl, bi, ints, al,
           comps_in, thr_in, scale, cts, **kw)
    from ._build import launch
    rows, grads = row_buffers(tables, n_row, dev)
    out = torch.empty((N_LANE_OUT, al.shape[0]), dtype=torch.float32,
                      device=dev)
    launch("rt_bounce_bwd", bwd_args(ttbl, kt, cam, rows, bi, ints, al,
                                     comps_in, thr_in, scale, cts, out,
                                     **kw), dev)
    bounce_bwd_regen_pre_reduced.launches += 1
    return tuple(out.unbind(0)), grads


bounce_bwd_regen_pre_reduced.launches = 0
