"""The differentiable nearest surface hit, winner only
(``raytrace_tpu/ops/diff_intersect.py``).

Which row a ray hits is piecewise constant in the scene's parameters, and
the rows it does not hit do not touch its outputs.  So the forward runs a
nearest-hit kernel (``render/integrator.py:surface_hit``: kernel K8's flat
scan, or K9's BVH walk for kind-segmented tables of 192 rows and more) and
saves each ray's winner index; the backward gathers the winner rows by
index and differentiates their recomputed hit (``ops/intersect.py``: the
hit parameter, the record's normal and uv, a rotated sphere's uv in
object space) with torch autograd, which adds the rows' cotangents into
the tables (the backward of the gather).  Ellipsoids are merged after
this function, in differentiable torch (``ops/ellipsoid.py``).  The JAX
package's one-hot gather is a TPU workaround and is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import take_rows
from .intersect import INF, make_hit_record_rows, single_prim_t_rows


@dataclasses.dataclass(frozen=True)
class HitStatics:
    """What the differentiable hit needs besides its tensors: the split
    path's tables of the detached scene (``render/integrator.py:
    SplitTables``: the packed table and its BVH) and the integer columns
    and flags of the primitive table, with its rotated spheres'
    world-to-object rotations."""
    tables: object
    kind: torch.Tensor
    mat: torch.Tensor
    has_motion: bool
    has_box: bool
    t_min: float
    sphere_rots: tuple = ()


def winner_outputs(st: HitStatics, floats, o, d, time, idx):
    """``(t_safe, normal, uv)`` of each ray recomputed on its winner row
    ``idx`` (``floats = (p0, e1, e2, uvs, mv0, mv1)``): ``t_safe`` is 1.0
    where the ray misses, so no gradient there is NaN."""
    p0, e1, e2, uvs, mv0, mv1 = floats
    pi = torch.clamp(idx, min=0).long()
    rows = (st.kind[pi],) + tuple(take_rows(x, pi)
                                  for x in (p0, e1, e2, mv0, mv1, uvs))
    t = single_prim_t_rows(rows[:6], st.has_motion, o, d, time,
                           torch.full_like(time, st.t_min),
                           torch.full_like(time, INF), has_box=st.has_box)
    valid = (idx >= 0) & torch.isfinite(t)
    t_safe = torch.where(valid, t, 1.0)
    rec = make_hit_record_rows(rows, st.has_motion, st.mat[pi], idx, o, d,
                               time, t_safe, has_box=st.has_box,
                               sphere_rots=st.sphere_rots)
    return t_safe, rec.normal, rec.uv


class DiffSurfaceHit(torch.autograd.Function):
    """Inputs ``(st, o [R, 3], d [R, 3], time [R], p0, e1, e2, uvs, mv0,
    mv1)``; outputs ``(t [R] (+inf on a miss), idx (i32, -1 on a miss),
    normal [R, 3], front (bool), uv [R, 2], mat (i64))``, the surface-hit
    contract of the JAX package's ``_surface_hit``."""

    @staticmethod
    def forward(ctx, st, o, d, time, *floats):
        from ..render import integrator
        hit = integrator.surface_hit(st.tables, o.T.contiguous(),
                                     d.T.contiguous(), time.contiguous(),
                                     ellipsoids=False)
        t, idx = hit[0], hit[1].to(torch.int32)
        normal = torch.stack(hit[2:5], dim=-1)
        front = hit[5] > 0.5
        uv = torch.stack(hit[6:8], dim=-1)
        mat = hit[8].long()
        ctx.save_for_backward(o, d, time, idx, *floats)
        ctx.st = st
        ctx.mark_non_differentiable(idx, front, mat)
        return t, idx, normal, front, uv, mat

    @staticmethod
    def backward(ctx, g_t, _g_idx, g_normal, _g_front, g_uv, _g_mat):
        o, d, time, idx, *floats = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n)
                   for x, n in zip((o, d, time, *floats), needs)]
            outs = winner_outputs(ctx.st, ins[3:], *ins[:3], idx)
            cts = (torch.where(torch.isfinite(g_t), g_t, 0.0), g_normal, g_uv)
            keep = [(y, c) for y, c in zip(outs, cts) if c is not None]
            wrt = [x for x, n in zip(ins, needs) if n]
            gs = iter(torch.autograd.grad(
                [y for y, _ in keep], wrt, [c for _, c in keep],
                allow_unused=True)) if wrt else iter(())
        grads = [next(gs) if n else None for n in needs]
        grads = [torch.zeros_like(x) if n and g is None else g
                 for x, n, g in zip(ins, needs, grads)]
        return (None, *grads)


def hit_statics(tables, prims, t_min: float) -> HitStatics:
    """:class:`HitStatics` of the split path's ``tables`` of a scene whose
    primitive table is ``prims``."""
    return HitStatics(tables=tables, kind=prims.kind, mat=prims.mat,
                      has_motion=prims.has_motion, has_box=prims.has_box,
                      t_min=t_min, sphere_rots=prims.sphere_rots)


def diff_surface_hit(st: HitStatics, prims, o, d, time):
    """The differentiable nearest hit of the rays ``o``, ``d`` [R, 3] at
    ``time`` [R] on the table ``prims`` (whose float fields take the
    gradients): :class:`DiffSurfaceHit`'s outputs."""
    return DiffSurfaceHit.apply(st, o, d, time, prims.p0, prims.e1, prims.e2,
                                prims.uvs, prims.mv0, prims.mv1)

