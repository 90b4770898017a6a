"""Constant-density media on the forward path
(``raytrace_tpu/render/volumes.py``).

Each medium gives every ray an independent scatter candidate: from the
ray's first two boundary crossings beyond ``t_min`` (kernels K11 and K11b,
``ops/volume_kernel.py``), the entry is the first crossing if it enters,
else ``t_min`` (the ray starts inside), the exit is the next crossing, and
the ray scatters at ``entry - log(u) / density`` if that lies before the
exit.  The bounce then takes the nearest of the surface hit and the
candidates.

The differentiable path (the score-function density weight of the JAX
package's generic bounce) is not ported (ROADMAP M4, M10).
"""
from __future__ import annotations

import math

import torch

from ..ops.intersect_kernel import pack_prims
from ..ops.volume_kernel import (
    BCAST_MIN_ROWS, MAX_VOLUMES, pack_volume_bvh, pallas_volume_crossings,
    pallas_volume_crossings_bcast,
)
from ..scene.types import Volumes


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


def uses_bcast(volumes: Volumes) -> bool:
    """Does this boundary table take kernel K11b (the BVH walk of
    mesh-scale boundaries) rather than K11?  The JAX package's rule: a
    table of ``BCAST_MIN_ROWS`` (64) rows and more."""
    return volumes.prims.kind.shape[0] >= BCAST_MIN_ROWS


def crossing_kw(volumes: Volumes, t_min: float) -> dict:
    """The keyword arguments of the crossing kernels for ``volumes``, with
    ``t_min`` rounded to float32 as the kernels compare it."""
    return dict(slices=tuple(zip(volumes.starts, volumes.counts)),
                t_min=float(torch.tensor(t_min, dtype=torch.float32)),
                has_motion=volumes.prims.has_motion,
                has_box=volumes.prims.has_box)


def volume_tables(volumes: Volumes):
    """``(vtbl, forest)``: the packed boundary table and, for a boundary
    that takes K11b (:func:`uses_bcast`), its per-medium BVH forest
    (``ops/volume_kernel.py:pack_volume_bvh``; else None).  The drivers
    build them once per call."""
    slices = tuple(zip(volumes.starts, volumes.counts))
    vtbl = pack_prims(volumes.prims).contiguous()
    forest = (pack_volume_bvh(volumes.prims, vtbl, slices)
              if uses_bcast(volumes) else None)
    return vtbl, forest


def volume_crossings(volumes: Volumes, rays, t_min: float, tables=None):
    """The 3V crossing rows ``[t1, front1, t2]`` of every medium for the
    rays ``rays`` (7 [R] tensors): one launch of kernel K11b (a boundary
    table of ``BCAST_MIN_ROWS`` rows and more) or K11 per group of at most
    ``MAX_VOLUMES`` media, the groups' rows concatenated in medium order
    (each medium's crossings depend on its own rows only).  ``tables`` is
    :func:`volume_tables`' result, packed here if not given."""
    vtbl, forest = volume_tables(volumes) if tables is None else tables
    kw = crossing_kw(volumes, t_min)
    slices = kw["slices"]
    outs = []
    for g0 in range(0, len(slices), MAX_VOLUMES):
        g1 = min(g0 + MAX_VOLUMES, len(slices))
        gkw = dict(kw, slices=slices[g0:g1])
        if forest is None:
            outs += pallas_volume_crossings(vtbl, *rays, **gkw)
        else:
            outs += pallas_volume_crossings_bcast(
                vtbl, forest.group(g0, g1), *rays, **gkw)
    return outs


def volume_candidates_kernel(volumes: Volumes, o, d, time, t_min: float,
                             u_scatter, tables=None):
    """Scatter candidate of every medium for the rays ``o``, ``d`` [3, R]
    at ``time`` [R], with the draws ``u_scatter`` [V, R]: a list of V [R]
    tensors, +inf where the ray does not scatter.  The crossings come from
    :func:`volume_crossings` (the JAX package's
    ``volume_candidates_pallas``, without its opt-in second culling
    level); ``tables`` is :func:`volume_tables`' result, packed here if not
    given."""
    outs = volume_crossings(volumes, (o[0], o[1], o[2], d[0], d[1], d[2],
                                      time), t_min, tables)
    cands = []
    for v in range(volumes.n_volumes):
        t, _ = candidate_from_crossings(
            volumes.density[v], outs[3 * v], outs[3 * v + 1] > 0.5,
            outs[3 * v + 2], t_min, u_scatter[v])
        cands.append(t)
    return cands
