"""Constant-density media on the forward path
(``raytrace_tpu/render/volumes.py``).

Each medium gives every ray an independent scatter candidate: from the
ray's first two boundary crossings beyond ``t_min`` (kernels K11 and K11b,
``ops/volume_kernel.py``), the entry is the first crossing if it enters,
else ``t_min`` (the ray starts inside), the exit is the next crossing, and
the ray scatters at ``entry - log(u) / density`` if that lies before the
exit.  The bounce then takes the nearest of the surface hit and the
candidates (:func:`medium_hit`: on the card the kernels' candidate mode
folds the candidates inside each launch).

The differentiable path (the score-function density weight of the JAX
package's generic bounce) is not ported (ROADMAP M4, M10).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.intersect_kernel import pack_prims
from ..ops.volume_kernel import (
    BCAST_MIN_ROWS, MAX_VOLUMES, VolumeBVH, candidate_from_crossings,
    pack_volume_bvh, pallas_volume_candidates, pallas_volume_candidates_bcast,
    pallas_volume_crossings, pallas_volume_crossings_bcast,
    prepare_volume_launch,
)
from ..scene.types import Volumes

def uses_bcast(volumes: Volumes) -> bool:
    """Does this boundary table take kernel K11b (the BVH walk of
    mesh-scale boundaries) rather than K11?  The JAX package's rule: a
    table of ``BCAST_MIN_ROWS`` (64) rows and more."""
    return volumes.prims.kind.shape[0] >= BCAST_MIN_ROWS


def crossing_kw(volumes: Volumes, t_min: float) -> dict:
    """The keyword arguments of the crossing kernels for ``volumes``, with
    ``t_min`` rounded to float32 as the kernels compare it."""
    return dict(slices=tuple(zip(volumes.starts, volumes.counts)),
                t_min=float(np.float32(t_min)),
                has_motion=volumes.prims.has_motion,
                has_box=volumes.prims.has_box)


@dataclasses.dataclass(frozen=True)
class VolumeTables:
    """:func:`volume_tables`' result: the packed boundary table, its BVH
    forest (K11b; else None) and one prepared launch
    (``ops/volume_kernel.py:VolumeLaunch``) per group of at most
    ``MAX_VOLUMES`` media, in medium order."""
    vtbl: torch.Tensor
    forest: VolumeBVH | None
    launches: tuple


def volume_tables(volumes: Volumes) -> VolumeTables:
    """The packed boundary table, for a boundary that takes K11b
    (:func:`uses_bcast`) its per-medium BVH forest
    (``ops/volume_kernel.py:pack_volume_bvh``), and each group's launch
    prepared with the media's densities and material ids (K11's planar
    instantiation decided: one host synchronisation, as is reading the
    material ids).  The drivers build them once per call."""
    slices = tuple(zip(volumes.starts, volumes.counts))
    vtbl = pack_prims(volumes.prims).contiguous()
    forest = (pack_volume_bvh(volumes.prims, vtbl, slices)
              if uses_bcast(volumes) else None)
    mats = volumes.mat.tolist()
    launches = []
    for g0 in range(0, len(slices), MAX_VOLUMES):
        g1 = min(g0 + MAX_VOLUMES, len(slices))
        launches.append(prepare_volume_launch(
            vtbl, None if forest is None else forest.group(g0, g1),
            slices=slices[g0:g1], has_motion=volumes.prims.has_motion,
            has_box=volumes.prims.has_box,
            density=volumes.density[g0:g1].contiguous(),
            mats=mats[g0:g1]))
    return VolumeTables(vtbl=vtbl, forest=forest, launches=tuple(launches))


def _groups(volumes: Volumes, t_min: float, tables):
    """``(g0, g1, launch, kw)`` of each launch group."""
    tables = volume_tables(volumes) if tables is None else tables
    kw = crossing_kw(volumes, t_min)
    g0 = 0
    for launch in tables.launches:
        g1 = g0 + len(launch.slices)
        yield g0, g1, launch, dict(kw, slices=launch.slices)
        g0 = g1


def volume_crossings(volumes: Volumes, rays, t_min: float, tables=None):
    """The 3V crossing rows ``[t1, front1, t2]`` of every medium for the
    rays ``rays`` (7 [R] tensors): one launch of kernel K11b (a boundary
    table of ``BCAST_MIN_ROWS`` rows and more) or K11 per group of at most
    ``MAX_VOLUMES`` media, the groups' rows concatenated in medium order
    (each medium's crossings depend on its own rows only).  ``tables`` is
    :func:`volume_tables`' result, packed here if not given."""
    outs = []
    for _, _, launch, kw in _groups(volumes, t_min, tables):
        if launch.forest is None:
            outs += pallas_volume_crossings(launch.vtbl, *rays, **kw,
                                            prepared=launch)
        else:
            outs += pallas_volume_crossings_bcast(
                launch.vtbl, launch.forest, *rays, **kw, prepared=launch)
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


def medium_hit(volumes: Volumes, rays, t_min: float, u_scatter,
               tables=None):
    """``(t_med, vmat)`` [R]: the nearest scatter candidate of the media
    for the rays ``rays`` (7 [R] tensors) with the draws ``u_scatter``
    [V, R] (+inf where no medium scatters the ray) and its medium's
    material id (0 there), the first medium winning a tie, as
    ``bounce_split_soa`` folds them.  One launch of K11 or K11b in the
    candidate mode per group of at most ``MAX_VOLUMES`` media, the first
    starting the fold, each later one folding its media into the rows the
    previous one left; on the CPU their plain version (the crossings,
    :func:`candidate_from_crossings`, the fold).  ``tables`` as for
    :func:`volume_crossings`."""
    t_med = vmat = None
    for g0, g1, launch, kw in _groups(volumes, t_min, tables):
        cand = dict(u=u_scatter[g0:g1], t_med=t_med, vmat=vmat,
                    density=launch.density, mats=launch.mats,
                    prepared=launch, **kw)
        if launch.forest is None:
            t_med, vmat = pallas_volume_candidates(launch.vtbl, *rays, **cand)
        else:
            t_med, vmat = pallas_volume_candidates_bcast(
                launch.vtbl, launch.forest, *rays, **cand)
    return t_med, vmat
