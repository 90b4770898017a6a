"""The marble texture's stripe for the lanes that sample a marble texture
(``raytrace_tpu/ops/pallas/texture_kernel.py``: ``marble_stripe_pallas``,
kernel K12).

The stripe is ``0.5 + 0.5 sin(f (d . p) + 10 turb7(0.25 f p + s))``
(``Texture.hs:72-79``): a 7-octave turbulence, 56 hash-gradient corners a
lane.  Only the lanes whose texture is a marble row need it.  The TPU
kernel loops over the scene's marble rows and skips a block of lanes with
no such lane; on the card each thread takes one lane and computes the
turbulence only for the row its texture id names
(``csrc/texture_kernel.cu`` over ``csrc/noise.cuh``).

* :func:`marble_table` packs the per-row scalars, [M, 8] f32: row id,
  frequency, direction (3), shift (3);
* :func:`marble_stripe_values` is the stripe's arithmetic on tensors (or
  per-row scalars), shared by the plain version and ``eval_texture``;
* :func:`marble_stripe_plain` is the plain PyTorch version;
* :func:`marble_stripe_pallas` launches the kernel for CUDA tensors and
  runs the plain version for CPU tensors.  Lanes that do not sample a
  marble row come back exactly 0.
"""
from __future__ import annotations

import ctypes

import torch

from ..textures.noise import turbulence_soa

N_MCOLS = 8
MAX_MARBLE = 32     # marble rows the kernel stages in shared memory


def marble_stripe_values(freq, dx, dy, dz, sx, sy, sz, px, py, pz):
    """The stripe at points (px, py, pz) of a marble texture with
    frequency ``freq``, direction (dx, dy, dz) and shift (sx, sy, sz):
    per-lane tensors or per-row scalars, as the kernel rounds it."""
    q = 0.25 * freq
    nz = 10.0 * turbulence_soa(7, q * px + sx, q * py + sy, q * pz + sz)
    sin_arg = freq * (dx * px + dy * py + dz * pz)
    return 0.5 + 0.5 * torch.sin(sin_arg + nz)


def marble_table(table) -> torch.Tensor:
    """[M, 8] f32 table of the marble rows of the texture table ``table``
    (``table.marble_rows``), on its device: row id, frequency, direction,
    shift."""
    rows = torch.tensor(table.marble_rows, dtype=torch.long,
                        device=table.f0.device)
    return torch.cat([rows.to(torch.float32)[:, None], table.f0[rows, None],
                      table.v0[rows], table.v1[rows]], dim=1).contiguous()


def marble_stripe_plain(table, tex_ids, points, mtbl=None):
    """:func:`marble_stripe_pallas` in plain PyTorch, on any device."""
    mtbl = marble_table(table) if mtbl is None else mtbl
    tid = tex_ids.to(torch.float32)
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    acc = torch.zeros_like(px)
    for m in range(mtbl.shape[0]):
        r = mtbl[m]
        stripe = marble_stripe_values(r[1], r[2], r[3], r[4], r[5], r[6],
                                      r[7], px, py, pz)
        acc = torch.where(tid == r[0], stripe, acc)
    return acc


class _MarbleArgs(ctypes.Structure):
    """Mirror of ``MarbleArgs`` in csrc/texture_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("mtbl", "tid", "pts", "out")]
                + [("n_lanes", ctypes.c_int64), ("n_marble", ctypes.c_int)])


def marble_stripe_pallas(table, tex_ids, points, mtbl=None):
    """Marble stripe [R] of every lane whose texture id ``tex_ids[R]`` is
    a marble row of ``table`` (0 elsewhere), at ``points[R, 3]``.
    ``mtbl`` is :func:`marble_table`'s table, built here if not given.

    CPU tensors run :func:`marble_stripe_plain`; CUDA tensors launch
    ``csrc/texture_kernel.cu`` (``marble_stripe_pallas.launches`` counts
    the launches)."""
    from .bounce_kernel import check_lanes
    dev = points.device
    if dev.type == "cpu":
        return marble_stripe_plain(table, tex_ids, points, mtbl)
    if dev.type != "cuda":
        raise ValueError(f"marble_stripe_pallas: unsupported device {dev}")
    mtbl = marble_table(table) if mtbl is None else mtbl
    m = mtbl.shape[0]
    if not 0 < m <= MAX_MARBLE or mtbl.shape[1] != N_MCOLS \
            or mtbl.dtype != torch.float32 or mtbl.device != dev \
            or not mtbl.is_contiguous():
        raise ValueError(f"mtbl: need a contiguous f32 [1..{MAX_MARBLE}, "
                         f"{N_MCOLS}] tensor on {dev}")
    r = points.shape[0]
    if (points.dim() != 2 or points.shape[1] != 3
            or points.dtype != torch.float32 or not points.is_contiguous()):
        raise ValueError("points: need a contiguous f32 [R, 3] tensor")
    tid = tex_ids.to(torch.int32).contiguous()
    check_lanes([("tex_ids", tid)], r, dev, torch.int32)
    from ._build import launch
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    args = _MarbleArgs(mtbl.data_ptr(), tid.data_ptr(), points.data_ptr(),
                       out.data_ptr(), r, m)
    launch("rt_marble", args, dev)
    marble_stripe_pallas.launches += 1
    return out


marble_stripe_pallas.launches = 0
