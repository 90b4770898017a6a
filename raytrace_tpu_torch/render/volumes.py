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

The differentiable path (the JAX package's ``volume_candidates(...,
with_segments=True)``, which the generic bounce's ``diff=True`` reads) is
:func:`volume_candidates_diff`: the crossings of the kernels' keyed mode
through :class:`DiffCrossings`, whose backward recomputes, winner only,
the one root each crossing came from.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.vecmath import take_rows
from ..ops.intersect import chunk_roots_rows
from ..ops.intersect_kernel import pack_prims
from ..ops.volume_kernel import (
    BCAST_MIN_ROWS, MAX_VOLUMES, VolumeBVH, candidate_from_crossings,
    pack_volume_bvh, pallas_volume_candidates, pallas_volume_candidates_bcast,
    pallas_volume_crossings, pallas_volume_crossings_bcast,
    pallas_volume_crossings_bcast_keyed, pallas_volume_crossings_keyed,
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


def volume_crossings_keyed(volumes: Volumes, rays, t_min: float,
                           tables=None):
    """:func:`volume_crossings` in the kernels' keyed mode:
    ``(crossings, keys)``, the 3V crossing rows and the 2V [R] i32 key
    rows ``[k1, k2]`` per medium (``ops/volume_kernel.py:
    volume_crossings_plain``), one launch of K11 or K11b per group."""
    outs, keys = [], []
    for _, _, launch, kw in _groups(volumes, t_min, tables):
        if launch.forest is None:
            o, k = pallas_volume_crossings_keyed(launch.vtbl, *rays, **kw,
                                                 prepared=launch)
        else:
            o, k = pallas_volume_crossings_bcast_keyed(
                launch.vtbl, launch.forest, *rays, **kw, prepared=launch)
        outs += o
        keys += k
    return outs, keys


@dataclasses.dataclass(frozen=True)
class CrossingStatics:
    """What :class:`DiffCrossings` needs besides its tensors: the media of
    the detached scene, their :func:`volume_tables` and ``t_min``."""
    volumes: Volumes
    tables: VolumeTables
    t_min: float


def crossing_statics(volumes: Volumes, t_min: float) -> CrossingStatics:
    """:class:`CrossingStatics` of ``volumes`` (detached here), built once
    per driver call."""
    det = dataclasses.replace(
        volumes, prims=dataclasses.replace(
            volumes.prims, **{k: getattr(volumes.prims, k).detach()
                              for k in ("p0", "e1", "e2", "uvs", "mv0",
                                        "mv1")}),
        density=volumes.density.detach())
    return CrossingStatics(volumes=det, tables=volume_tables(det),
                           t_min=float(np.float32(t_min)))


class DiffCrossings(torch.autograd.Function):
    """Inputs ``(st, o [R, 3], d [R, 3], time [R], p0, e1, e2, mv0, mv1)``
    (the boundary table's float columns); outputs ``(t1, front1, t2)``
    [V, R] (front1 bool): each medium's first crossing beyond ``t_min``,
    whether it enters, and the next crossing beyond it, from the kernels'
    keyed mode.

    The backward gathers the row of each crossing's key and recomputes
    that one root (``ops/intersect.py:chunk_roots_rows``, slot 0 the
    entering or planar root, 1 the exit root) under autograd, sending the
    crossing's cotangent to the boundary rows and to ``o``, ``d`` and
    ``time``.  The tie rule: a crossing that several candidates attain
    gives all of its cotangent to the lowest key, where the JAX package's
    ``min`` splits it equally among them; ties have measure zero for rays
    in general position."""

    @staticmethod
    def forward(ctx, st, o, d, time, *floats):
        rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
            d[:, k].contiguous() for k in range(3)) + (time.contiguous(),)
        outs, keys = volume_crossings_keyed(st.volumes, rays, st.t_min,
                                            st.tables)
        t1, t2 = torch.stack(outs[0::3]), torch.stack(outs[2::3])
        front1 = torch.stack(outs[1::3]) > 0.5
        ctx.save_for_backward(o, d, time, torch.stack(keys), *floats)
        ctx.st = st
        ctx.mark_non_differentiable(front1)
        return t1, front1, t2

    @staticmethod
    def backward(ctx, g_t1, _g_front1, g_t2):
        o, d, time, keys, *floats = ctx.saved_tensors
        st = ctx.st
        needs = ctx.needs_input_grad[1:]
        r = o.shape[0]
        # keys [2V, R] are [k1, k2] per medium, as the stacked cotangents
        ct = torch.stack([g_t1, g_t2], dim=1).reshape(-1)
        key = keys.reshape(-1).long()
        sel = torch.nonzero((key >= 0) & torch.isfinite(ct) & (ct != 0))[:, 0]
        key, ct, lane = key[sel], ct[sel], sel % r
        row = torch.div(key, 2, rounding_mode="floor")
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n)
                   for x, n in zip((o, d, time, *floats), needs)]
            p0, e1, e2, mv0, mv1 = ins[3:]
            vp = st.volumes.prims
            r1, r2 = chunk_roots_rows(
                vp.kind[row], *(take_rows(x, row) for x in (p0, e1, e2, mv0,
                                                            mv1)),
                vp.has_motion, *(take_rows(x, lane) for x in ins[:3]),
                has_box=vp.has_box)
            t = torch.where(key % 2 == 1, r2, r1)
            wrt = [x for x, n in zip(ins, needs) if n]
            gs = iter(torch.autograd.grad(t, wrt, ct, allow_unused=True))
        grads = [next(gs) if n else None for n in needs]
        grads = [torch.zeros_like(x) if n and g is None else g
                 for x, n, g in zip(ins, needs, grads)]
        return (None, *grads)


def volume_candidates_diff(volumes: Volumes, st: CrossingStatics, o, d, time,
                           u_scatter):
    """The differentiable scatter candidates of the media (the JAX
    package's ``volume_candidates(..., with_segments=True)``) for the rays
    ``o``, ``d`` [R, 3] at ``time`` [R] with the draws ``u_scatter`` [V,
    R]: ``(t_cand, entry, exit, has_segment)``, each a list of V [R]
    tensors.  The crossings come from :class:`DiffCrossings` over the
    float columns of ``volumes.prims``; the density is detached in the
    candidate (its gradient is the bounce's score-function weight's, so
    the flight distance must not carry it too)."""
    vp = volumes.prims
    t1, front1, t2 = DiffCrossings.apply(st, o, d, time, vp.p0, vp.e1, vp.e2,
                                         vp.mv0, vp.mv1)
    cands, entries, exits, has = [], [], [], []
    for v in range(volumes.n_volumes):
        c, _ = candidate_from_crossings(volumes.density[v].detach(), t1[v],
                                        front1[v], t2[v], st.t_min,
                                        u_scatter[v])
        entry = torch.where(front1[v], t1[v], st.t_min)
        exit_t = torch.where(front1[v], t2[v], t1[v])
        cands.append(c)
        entries.append(entry)
        exits.append(exit_t)
        has.append(torch.isfinite(t1[v]) & torch.isfinite(exit_t))
    return cands, entries, exits, has
