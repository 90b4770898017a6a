"""Ellipsoids (spheres under arbitrary affines): their nearest hit and its
merge into the surface hit (``raytrace_tpu/ops/ellipsoid.py``).

The ray is taken into object space, the origin by the full affine inverse
and the direction by the linear inverse without renormalizing, so the
object-space hit parameter is the world-space one.  The sphere's two
roots are taken against the same open interval; the normal is the
object-space one mapped by the forward linear part A and normalized (the
reference's Euclidean-only caveat), and the uv is the object-space polar
map.  E is tiny (ellipsoids are rare), so this is plain torch over [R, E]
tiles, differentiable in every ellipsoid leaf; the JAX package computes it
in XLA, not in a kernel, and so does the port.  The guards (a safe square
root on the lanes without a root, safe atan2 inputs at the poles) keep
autograd's backward finite on the lanes a select discards.
"""
from __future__ import annotations

import math

import torch

from ..core.vecmath import take_rows
from ..scene.types import Ellipsoids

INF = float("inf")


def ellipsoid_nearest(ells: Ellipsoids, o, d, time, t_min: float):
    """The nearest ellipsoid hit of each ray (``o``, ``d`` [R, 3], ``time``
    [R]): ``(t, e_idx, normal, front, uv)``, ``t`` +inf on a miss,
    ``e_idx`` the winning ellipsoid (-1 on a miss, the lowest on a tie),
    ``normal`` the unit world normal facing the ray, ``uv`` the
    object-space polar uv."""
    # the origin relative to the instance (motion shifts it in world space)
    rel = o[:, None, :] - ells.shift[None, :, :]                # [R, E, 3]
    if ells.has_motion:
        rel = rel - (ells.mv0[None, :, :] + time[:, None, None]
                     * (ells.mv1 - ells.mv0)[None, :, :])
    # the object-space ray (the direction not renormalized: t stays world
    # t), as the JAX package's einsums: a ray that grazes turns an ulp of
    # these products into 1e-5 of t, so other sums drift from its lanes
    op = torch.einsum("rek,eik->rei", rel, ells.inv)
    dp = torch.einsum("rk,eik->rei", d, ells.inv)

    oc = ells.center[None, :, :] - op
    a = torch.sum(dp * dp, -1)
    h = torch.sum(dp * oc, -1)
    c = torch.sum(oc * oc, -1) - (ells.radius * ells.radius)[None, :]
    disc = h * h - a * c
    ok = disc >= 0.0
    a_safe = torch.clamp(a, min=1e-30)
    sq = torch.sqrt(torch.where(ok, torch.clamp(disc, min=1e-30), 1.0))
    r1 = (h - sq) / a_safe
    r2 = (h + sq) / a_safe
    t_cand = torch.where(r1 > t_min, r1, torch.where(r2 > t_min, r2, INF))
    t_cand = torch.where(ok, t_cand, INF)                       # [R, E]

    best_t, arg = torch.min(t_cand, dim=1)
    found = torch.isfinite(best_t)
    e_idx = torch.where(found, arg, -1)
    ei = torch.clamp(e_idx, min=0)

    # the winner's attributes (its rows gathered by index_select, whose
    # backward is an index_add_, not advanced indexing's serial walk)
    t_safe = torch.where(found, best_t, 1.0)
    pick = ei[:, None, None].expand(-1, 1, 3)
    op_w = torch.gather(op, 1, pick)[:, 0]
    dp_w = torch.gather(dp, 1, pick)[:, 0]
    center_w = take_rows(ells.center, ei)
    rad = take_rows(ells.radius, ei)
    radius_w = torch.where(torch.abs(rad) > 0, rad, 1.0)
    hit_obj = op_w + t_safe[:, None] * dp_w
    outward_obj = (hit_obj - center_w) / radius_w[:, None]
    front = torch.sum(dp_w * outward_obj, -1) <= 0.0

    # the world normal: the forward linear map, normalized
    n_world = torch.einsum("rik,rk->ri", take_rows(ells.fwd, ei),
                           outward_obj)
    n_norm = torch.sqrt(torch.clamp(torch.sum(n_world * n_world, -1),
                                    min=1e-30))
    n_world = n_world / n_norm[:, None]
    normal = torch.where(front[:, None], n_world, -n_world)

    # the object-space polar uv
    xz_ok = outward_obj[:, 0] ** 2 + outward_obj[:, 2] ** 2 > 1e-12
    ox = torch.where(xz_ok, outward_obj[:, 0], 0.0)
    oz = torch.where(xz_ok, outward_obj[:, 2], 1.0)
    u = torch.atan2(ox, oz) / (2.0 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(-outward_obj[:, 1], -1.0 + 1e-6,
                                 1.0 - 1e-6)) / math.pi
    return best_t, e_idx, normal, front, torch.stack([u, v], dim=-1)


def merge_ellipsoid_hits(ells: Ellipsoids, o, d, time, t_min: float,
                         t_srf, idx, normal, front, uv, mat_id):
    """The surface hit ``(t_srf, idx, normal, front, uv, mat_id)`` ([R],
    [R], [R, 3], [R], [R, 2], [R]) with the nearest ellipsoid hit merged
    in where it is nearer: there ``idx`` is ``-2 - e`` (no primitive row,
    and not -1: a miss is told by ``t``'s finiteness), and the other
    outputs are the ellipsoid's, so the surface's carry no gradient
    there."""
    t_e, e_idx, n_e, fr_e, uv_e = ellipsoid_nearest(ells, o, d, time, t_min)
    win = t_e < t_srf
    t_out = torch.where(win, t_e, t_srf)
    idx_out = torch.where(win, (-2 - e_idx).to(idx.dtype), idx)
    normal_out = torch.where(win[:, None], n_e, normal)
    front_out = torch.where(win, fr_e, front)
    uv_out = torch.where(win[:, None], uv_e, uv)
    e_mat = ells.mat[torch.clamp(e_idx, min=0)].to(mat_id.dtype)
    mat_out = torch.where(win, e_mat, mat_id)
    return t_out, idx_out, normal_out, front_out, uv_out, mat_out
