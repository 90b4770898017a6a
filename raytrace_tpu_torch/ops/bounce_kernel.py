"""Kernel A: one full path-tracing bounce per lane
(``raytrace_tpu/ops/pallas/bounce_kernel.py``: ``bounce_megakernel``).

Nearest hit over the packed primitive table, material resolution over the
material (or behaviour) rows, constant/checker texture, emission,
specular scatter (mirror/metal/dielectric/transparent), cosine and
uniform-sphere sampling, CDF redirect choice and the MIS mixture pdf.
The RNG, regeneration and background-on-miss stay with the caller
(``render/integrator.py:bounce_mega_soa``), so any background works.

:func:`bounce_megakernel` launches ``csrc/bounce_kernel.cu`` for CUDA
tensors and runs :func:`bounce_plain`, the same function in plain
PyTorch, for CPU tensors.  Sphere uv uses the TPU kernel's polynomial
arctangent (|err| ~1e-5 rad) in both, so kernel and plain version agree.
:func:`prepare_bounce` checks a scene's tables once and prebuilds the
table part of the kernel's argument struct (:class:`BounceLaunch`); a
driver passes it to every launch, and it selects the kernel's planar
instantiation for tables of unmoving parallelograms and triangles
(:func:`planar_only`).

:func:`shade_megakernel` (``bounce_kernel.py:shade_megakernel``) is the
shade stage alone, fed a precomputed hit record and optional medium
events: it launches ``csrc/shade_kernel.cu`` for CUDA tensors and runs
:func:`shade_plain` for CPU tensors.  Its ``sphere_rots`` (the compiler's
``((row, r9), ...)``) turn the outward normal of the listed sphere rows
into object space before the in-kernel sphere uv; the kernel reads them
from a small device table (:func:`sphere_rot_table`).  The drivers
precompute the exact uv and pass sphere flag 0, as the JAX package's do,
so no route passes rotations.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.vecmath import vcross
from ..materials.materials import (
    MAT_ANISOTROPIC, MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_LIGHT, MAT_LOMMEL,
    MAT_METAL, MAT_MIRROR, MAT_PITCH_BLACK, MAT_TRANSPARENT, MaterialTable,
)
from ..scene.types import PRIM_PARALLELOGRAM, PRIM_TRIANGLE
from ..textures.textures import TEX_CHECKER, TEX_CONSTANT, TextureTable
from .intersect_kernel import MAX_SMEM_PRIMS, N_COLS, prim_loop_plain

N_MCOLS = 12
N_TCOLS = 16
MAX_MAT_ROWS = 16
MAX_SHADE_MATS = 24      # material rows of the shade kernel (split path)
MAX_TARGETS = 8

# uniform columns of one bounce
_U_SPEC0 = 0       # metal fuzz unit vector (z)
_U_SPEC1 = 1       # metal fuzz unit vector (phi)
_U_DIELECTRIC = 2
_U_DIR0 = 3        # diffuse unit vector (z)
_U_DIR1 = 4        # diffuse unit vector (phi)
_U_CHOICE = 5      # redirect target CDF draw
_U_TGT_I = 6
_U_TGT_J = 7
N_U = 8
N_OUT = 15

_F = np.float32
_INF = float("inf")


def _material_rows(materials: MaterialTable, textures: TextureTable, rows):
    tex = materials.tex[rows].long()
    tbl = torch.zeros((rows.shape[0], N_MCOLS), dtype=torch.float32,
                      device=tex.device)
    tbl[:, 0] = materials.kind[rows].to(torch.float32)
    tbl[:, 1] = materials.param[rows]
    tbl[:, 2] = textures.kind[tex].to(torch.float32)
    tbl[:, 3:6] = textures.c0[tex]
    tbl[:, 6:9] = textures.c1[tex]
    tbl[:, 9] = textures.f0[tex]
    tbl[:, 10] = textures.f1[tex]
    return tbl


def pack_materials(materials: MaterialTable, textures: TextureTable):
    """[M, 12] f32 table: kind, param, tex_kind, c0(3), c1(3), f0, f1."""
    rows = torch.arange(materials.kind.shape[0],
                        device=materials.kind.device)
    return _material_rows(materials, textures, rows)


def pack_behaviors(materials: MaterialTable, textures: TextureTable):
    """[B, 12] behaviour-row table (the layout of :func:`pack_materials`,
    one row per behaviour representative); the per-material color and
    param ride in prim columns 31-34 instead (column 1 is unused)."""
    return _material_rows(materials, textures,
                          materials.behavior_rep.to(torch.long))


def pack_targets(prob, q, u, v):
    """[T, 16] f32 table: q(3) u(3) v(3) cross(u, v)(3) prob cdf."""
    t = q.shape[0]
    if t == 0:
        return torch.zeros((1, N_TCOLS), dtype=torch.float32)
    cp = vcross(u, v)
    tbl = torch.zeros((t, N_TCOLS), dtype=torch.float32, device=q.device)
    tbl[:, 0:3] = q
    tbl[:, 3:6] = u
    tbl[:, 6:9] = v
    tbl[:, 9:12] = cp
    tbl[:, 12] = prob
    tbl[:, 13] = torch.cumsum(prob, 0)
    return tbl


def _poly_atan(t):
    """arctan on [0, 1], |err| ~ 1e-5 rad (minimax polynomial)."""
    z = t * t
    return t * (0.9998660 + z * (-0.3302995 + z * (0.1801410
                + z * (-0.0851330 + z * 0.0208351))))


def _atan2(y, x):
    ax = torch.abs(x)
    ay = torch.abs(y)
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    a = _poly_atan(t)
    a = torch.where(ay > ax, (math.pi / 2) - a, a)
    a = torch.where(x < 0.0, math.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def _acos(x):
    return _atan2(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)), x)


def _rsqrt3(x, y, z):
    return 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))


def _unit_from_uniforms(u, v):
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * v
    return r * torch.cos(phi), r * torch.sin(phi), z


def _target_consts(trow):
    """Per-target scalars of the MIS pdf, in f32 as the kernels compute
    them: unit normal, q.n, w_a = cross(v, n_s), w_b = cross(n_s, u)."""
    r = [_F(x) for x in trow]
    cpx, cpy, cpz = r[9], r[10], r[11]
    inv_cp = _F(1.0) / np.maximum(cpx * cpx + cpy * cpy + cpz * cpz,
                                  _F(1e-30))
    s = np.sqrt(inv_cp)
    nxs, nys, nzs = cpx * s, cpy * s, cpz * s
    qn = r[0] * nxs + r[1] * nys + r[2] * nzs
    nsx, nsy, nsz = cpx * inv_cp, cpy * inv_cp, cpz * inv_cp
    ux, uy, uz = r[3], r[4], r[5]
    vx, vy, vz = r[6], r[7], r[8]
    wa = (vy * nsz - vz * nsy, vz * nsx - vx * nsz, vx * nsy - vy * nsx)
    wb = (nsy * uz - nsz * uy, nsz * ux - nsx * uz, nsx * uy - nsy * ux)
    return [float(x) for x in (nxs, nys, nzs, qn) + wa + wb]


def shade_values(hit_res, mtbl, ttbl, ox, oy, oz, dx, dy, dz, tr, tg, tb,
                 alive, u_all, *, n_mats: int, n_targets: int,
                 use_prim_albedo: bool = False, with_uv: bool = False,
                 tmed=None, vmat=None, sphere_rots: tuple = ()):
    """Material, texture, emission, scatter and MIS stage after the
    nearest hit (``hit_res`` from :func:`prim_loop_plain`).  ``alive`` is
    a bool lane tensor, ``u_all`` the 8 bounce uniform columns.  Returns
    the 15 outputs: o' (3), d' (3), throughput' (3), emitted radiance
    (3), alive' (0/1), miss (0/1), winner index (-1 on a miss); with
    ``with_uv`` also the winner's (u, v).  ``tmed``/``vmat``: each lane's
    nearest medium event and its material; one nearer than the surface
    replaces the record (normal against the ray, front, uv 0).
    ``sphere_rots``: ``((row, r9), ...)``; a winner index equal to a
    listed row has its outward normal rotated by that row's r9 (row-major
    world->object) before the sphere uv, by a compare and select per
    listed row."""
    t, bi, nx, ny, nz, fr_f, uu, vv, mat_f, sph_f = hit_res[:10]
    if tmed is not None:
        in_med = tmed < t
        t = torch.where(in_med, tmed, t)
        mat_f = torch.where(in_med, vmat, mat_f)
        nx = torch.where(in_med, -dx, nx)
        ny = torch.where(in_med, -dy, ny)
        nz = torch.where(in_med, -dz, nz)
        fr_f = torch.where(in_med, 1.0, fr_f)
        uu = torch.where(in_med, 0.0, uu)
        vv = torch.where(in_med, 0.0, vv)
        sph_f = torch.where(in_med, 0.0, sph_f)
    mrows = mtbl[:n_mats].tolist()
    trows = ttbl[:n_targets].tolist()

    hit = t < _INF
    t_safe = torch.where(hit, t, 1.0)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz
    front = fr_f > 0.5
    is_sphere = sph_f > 0.5

    # sphere uv from the outward normal, polynomial atan2; instanced
    # spheres rotate the outward normal into object space first
    flip = torch.where(front, 1.0, -1.0)
    owx, owy, owz = nx * flip, ny * flip, nz * flip
    for row, r in sphere_rots:
        sel = bi == float(row)
        rx = r[0] * owx + r[1] * owy + r[2] * owz
        ry = r[3] * owx + r[4] * owy + r[5] * owz
        rz = r[6] * owx + r[7] * owy + r[8] * owz
        owx = torch.where(sel, rx, owx)
        owy = torch.where(sel, ry, owy)
        owz = torch.where(sel, rz, owz)
    su = _atan2(owx, owz) * (0.5 / math.pi) + 0.5
    sv = _acos(torch.clamp(-owy, -1.0, 1.0)) * (1.0 / math.pi)
    uu = torch.where(is_sphere, su, uu)
    vv = torch.where(is_sphere, sv, vv)

    # material + texture resolution over the material (behaviour) rows
    z = torch.zeros_like(t)
    kind, param, ar, ag, ab = z, z, z, z, z
    for mi, m in enumerate(mrows):
        sel = mat_f == float(mi)
        kind = torch.where(sel, m[0], kind)
        if not use_prim_albedo:
            param = torch.where(sel, m[1], param)
        tex_kind = m[2]
        even = torch.remainder(torch.floor(uu * m[9])
                               + torch.floor(vv * m[10]), 2.0) == 0.0
        use_c1 = (~even) if tex_kind == TEX_CHECKER else torch.zeros_like(sel)
        cr = torch.where(use_c1, m[6], m[3])
        cg = torch.where(use_c1, m[7], m[4])
        cb = torch.where(use_c1, m[8], m[5])
        if use_prim_albedo:
            cf = 1.0 if tex_kind == TEX_CONSTANT else 0.0
            cr = cf * hit_res[10] + (1.0 - cf) * cr
            cg = cf * hit_res[11] + (1.0 - cf) * cg
            cb = cf * hit_res[12] + (1.0 - cf) * cb
        if tex_kind not in (TEX_CONSTANT, TEX_CHECKER):
            # rich textures are deferred to the caller: albedo 1.0 here
            cr = cg = cb = torch.ones_like(t)
        ar = torch.where(sel, cr, ar)
        ag = torch.where(sel, cg, ag)
        ab = torch.where(sel, cb, ab)
    if use_prim_albedo:
        param = hit_res[13]

    live_hit = alive & hit

    # emission
    emit = torch.where(live_hit & (kind == MAT_LIGHT), 1.0, 0.0)
    emit_r = tr * ar * emit
    emit_g = tg * ag * emit
    emit_b = tb * ab * emit

    is_absorb = (kind == MAT_LIGHT) | (kind == MAT_PITCH_BLACK)
    is_hemi = (kind == MAT_LAMBERTIAN) | (kind == MAT_LOMMEL)
    is_spec = ((kind == MAT_MIRROR) | (kind == MAT_METAL)
               | (kind == MAT_DIELECTRIC) | (kind == MAT_TRANSPARENT))

    # specular family
    ddn = dx * nx + dy * ny + dz * nz
    rfx = dx - 2.0 * ddn * nx
    rfy = dy - 2.0 * ddn * ny
    rfz = dz - 2.0 * ddn * nz
    fx, fy, fz = _unit_from_uniforms(u_all[_U_SPEC0], u_all[_U_SPEC1])
    mx = rfx + param * fx
    my = rfy + param * fy
    mz = rfz + param * fz
    metal_ok = (mx * nx + my * ny + mz * nz) > 0.0
    inv = _rsqrt3(mx, my, mz)
    mx, my, mz = mx * inv, my * inv, mz * inv

    ior = torch.clamp(param, min=1e-6)
    ior_ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-ddn, max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ior_ratio * sin_t > 1.0
    r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
    r0 = r0 * r0
    one_c = 1.0 - cos_t
    oc2 = one_c * one_c
    schlick = r0 + (1.0 - r0) * (oc2 * oc2 * one_c)
    di_reflect = cannot | (u_all[_U_DIELECTRIC] < schlick)
    qx = ior_ratio * (dx + cos_t * nx)
    qy = ior_ratio * (dy + cos_t * ny)
    qz = ior_ratio * (dz + cos_t * nz)
    par = torch.sqrt(torch.clamp(
        torch.abs(1.0 - (qx * qx + qy * qy + qz * qz)), min=1e-12))
    di_r = torch.where(di_reflect, 1.0, 0.0)
    dix = di_r * rfx + (1.0 - di_r) * (qx - par * nx)
    diy = di_r * rfy + (1.0 - di_r) * (qy - par * ny)
    diz = di_r * rfz + (1.0 - di_r) * (qz - par * nz)

    is_metal = kind == MAT_METAL
    is_diel = kind == MAT_DIELECTRIC
    is_mirror = kind == MAT_MIRROR
    sx = torch.where(is_diel, dix, torch.where(
        is_metal, mx, torch.where(is_mirror, rfx, dx)))
    sy = torch.where(is_diel, diy, torch.where(
        is_metal, my, torch.where(is_mirror, rfy, dy)))
    sz = torch.where(is_diel, diz, torch.where(
        is_metal, mz, torch.where(is_mirror, rfz, dz)))
    s_ar = torch.where(is_diel, 1.0, ar)
    s_ag = torch.where(is_diel, 1.0, ag)
    s_ab = torch.where(is_diel, 1.0, ab)
    spec_dead = is_metal & ~metal_ok

    # diffuse family + redirection
    ux, uy, uz = _unit_from_uniforms(u_all[_U_DIR0], u_all[_U_DIR1])
    cdx = nx + ux
    cdy = ny + uy
    cdz = nz + uz
    inv = _rsqrt3(cdx, cdy, cdz)
    hemi_f = torch.where(is_hemi, 1.0, 0.0)
    bx = hemi_f * (cdx * inv) + (1.0 - hemi_f) * ux
    by = hemi_f * (cdy * inv) + (1.0 - hemi_f) * uy
    bz = hemi_f * (cdz * inv) + (1.0 - hemi_f) * uz

    if n_targets > 0:
        cdf_last = trows[-1][13]
        x_t = u_all[_U_CHOICE]
        use_t = x_t < cdf_last
        # the first target with x < cdf
        lq = [z, z, z, z, z, z, z, z, z]
        chosen = torch.zeros_like(hit)
        for trow in trows:
            pick = (x_t < trow[13]) & ~chosen
            chosen = chosen | pick
            lq = [torch.where(pick, trow[k], lq[k]) for k in range(9)]
        ti_u = u_all[_U_TGT_I]
        tj_u = u_all[_U_TGT_J]
        tgx = lq[0] + ti_u * lq[3] + tj_u * lq[6] - px
        tgy = lq[1] + ti_u * lq[4] + tj_u * lq[7] - py
        tgz = lq[2] + ti_u * lq[5] + tj_u * lq[8] - pz
        inv = _rsqrt3(tgx, tgy, tgz)
        use_f = torch.where(use_t, 1.0, 0.0)
        bx = use_f * (tgx * inv) + (1.0 - use_f) * bx
        by = use_f * (tgy * inv) + (1.0 - use_f) * by
        bz = use_f * (tgz * inv) + (1.0 - use_f) * bz

    mu1 = bx * nx + by * ny + bz * nz
    pdf_base = torch.where(is_hemi, mu1 * (1.0 / math.pi), 0.25 / math.pi)
    hemi_dead = is_hemi & (pdf_base <= 0.0)

    if n_targets > 0:
        pdf_sum = float(_F(1.0) - _F(cdf_last)) * pdf_base
        for trow in trows:
            (nxs, nys, nzs, qn, wax, way, waz, wbx, wby, wbz) = \
                _target_consts(trow)
            den = bx * nxs + by * nys + bz * nzs
            den_ok = torch.abs(den) > 1e-8
            den_s = torch.where(den_ok, den, 1.0)
            tt = (qn - (px * nxs + py * nys + pz * nzs)) / den_s
            rx = px + tt * bx - trow[0]
            ry = py + tt * by - trow[1]
            rz = pz + tt * bz - trow[2]
            aa = rx * wax + ry * way + rz * waz
            bb = rx * wbx + ry * wby + rz * wbz
            hit_t = (den_ok & (tt > 0.0) & (aa >= 0.0) & (aa <= 1.0)
                     & (bb >= 0.0) & (bb <= 1.0))
            cross_dot = torch.abs(bx * trow[9] + by * trow[10]
                                  + bz * trow[11])
            pdf_i = torch.where(hit_t, tt * tt / torch.clamp(cross_dot,
                                                             min=1e-12), 0.0)
            pdf_sum = pdf_sum + trow[12] * pdf_i
        pdf_mix = torch.clamp(pdf_sum, min=1e-12)
    else:
        pdf_mix = torch.clamp(pdf_base, min=1e-12)

    mu0 = -ddn
    lommel = 0.25 / torch.clamp(mu0 + mu1, min=1e-8)
    # Henyey-Greenstein: (1-g^2) / (1+g^2-2g mu)^1.5
    g = param
    hg_mu = dx * bx + dy * by + dz * bz
    hg_den = torch.clamp(1.0 + g * g - 2.0 * g * hg_mu, min=1e-12)
    hg = (1.0 - g * g) / (hg_den * torch.sqrt(hg_den))
    brdf = torch.where(kind == MAT_ANISOTROPIC, hg,
                       torch.where(kind == MAT_LOMMEL, lommel, 1.0))
    dw = brdf * pdf_base / pdf_mix

    spec_f = torch.where(is_spec, 1.0, 0.0)
    ndx = spec_f * sx + (1.0 - spec_f) * bx
    ndy = spec_f * sy + (1.0 - spec_f) * by
    ndz = spec_f * sz + (1.0 - spec_f) * bz
    w_r = torch.where(is_spec, s_ar, ar * dw)
    w_g = torch.where(is_spec, s_ag, ag * dw)
    w_b = torch.where(is_spec, s_ab, ab * dw)
    next_alive = live_hit & ~is_absorb & ~spec_dead & ~hemi_dead

    out = (torch.where(next_alive, px, ox),
           torch.where(next_alive, py, oy),
           torch.where(next_alive, pz, oz),
           torch.where(next_alive, ndx, dx),
           torch.where(next_alive, ndy, dy),
           torch.where(next_alive, ndz, dz),
           torch.where(next_alive, tr * w_r, tr),
           torch.where(next_alive, tg * w_g, tg),
           torch.where(next_alive, tb * w_b, tb),
           emit_r, emit_g, emit_b,
           torch.where(next_alive, 1.0, 0.0),
           torch.where(alive & ~hit, 1.0, 0.0), bi)
    return out + (uu, vv) if with_uv else out


def bounce_plain(ptbl, mtbl, ttbl, ox, oy, oz, dx, dy, dz, tm, tr, tg, tb,
                 al, uniforms, *, n_prims: int, n_mats: int, n_targets: int,
                 t_min: float, has_motion: bool,
                 use_prim_albedo: bool = False, prepared=None):
    """Kernel A in plain PyTorch: the same inputs and 15 outputs as
    :func:`bounce_megakernel`, on any device (``prepared`` is accepted
    so that both take the same arguments, and unused)."""
    hit = prim_loop_plain(ptbl, ox, oy, oz, dx, dy, dz, tm,
                          n_prims=n_prims, t_min=t_min,
                          has_motion=has_motion, with_albedo=use_prim_albedo)
    return shade_values(hit, mtbl, ttbl, ox, oy, oz, dx, dy, dz, tr, tg, tb,
                        al > 0.5, uniforms, n_mats=n_mats,
                        n_targets=n_targets, use_prim_albedo=use_prim_albedo)


class _BounceArgs(ctypes.Structure):
    """Mirror of ``BounceArgs`` in csrc/bounce_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "ptbl", "mtbl", "ttbl", "ox", "oy", "oz", "dx", "dy", "dz", "tm",
        "tr", "tg", "tb", "al", "uni", "out")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "n_prims", "n_mats", "n_targets", "has_motion",
            "use_prim_albedo", "planar")]
        + [("t_min", ctypes.c_float)])


_LANE_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "tr", "tg", "tb",
               "al")


def planar_only(ptbl, n_prims: int, has_motion: bool) -> bool:
    """Is every row of ``[0, n_prims)`` an unmoving parallelogram or
    triangle?  Then kernel A scans the table with its planar
    instantiation.  Reads the kinds to the host (a synchronisation)."""
    if has_motion or n_prims == 0:
        return False
    kind = ptbl[:n_prims, 16]
    return bool(((kind == float(PRIM_PARALLELOGRAM))
                 | (kind == float(PRIM_TRIANGLE))).all())


@dataclasses.dataclass(frozen=True)
class BounceLaunch:
    """Kernel A's tables for one scene and camera, checked once by
    :func:`prepare_bounce`: the tables, their keyword parameters
    (:func:`bounce_megakernel`'s), whether the planar instantiation
    serves them, and the argument struct with its table part filled in
    (the lanes are filled per launch)."""
    ptbl: torch.Tensor
    mtbl: torch.Tensor
    ttbl: torch.Tensor
    kw: dict
    planar: bool
    args: _BounceArgs


def prepare_bounce(ptbl, mtbl, ttbl, *, n_prims: int, n_mats: int,
                   n_targets: int, t_min: float, has_motion: bool,
                   use_prim_albedo: bool = False) -> BounceLaunch:
    """Check kernel A's tables (as :func:`bounce_megakernel` does without
    them) and prebuild its argument struct's table part."""
    kw = dict(n_prims=n_prims, n_mats=n_mats, n_targets=n_targets,
              t_min=t_min, has_motion=has_motion,
              use_prim_albedo=use_prim_albedo)
    check_tables(ptbl, mtbl, ttbl, n_prims, n_mats, n_targets, ptbl.device)
    planar = planar_only(ptbl, n_prims, has_motion)
    return BounceLaunch(ptbl=ptbl, mtbl=mtbl, ttbl=ttbl, kw=kw,
                        planar=planar,
                        args=_table_args(ptbl, mtbl, ttbl, kw, planar))


def lane_args(table_args: _BounceArgs, lanes, uniforms, out) -> _BounceArgs:
    """A copy of ``table_args`` with the lane part filled in, for tensors
    that outlive it."""
    args = _BounceArgs.from_buffer_copy(table_args)
    (args.ox, args.oy, args.oz, args.dx, args.dy, args.dz, args.tm, args.tr,
     args.tg, args.tb, args.al, args.uni, args.out) = (
        x.data_ptr() for x in tuple(lanes) + (uniforms, out))
    args.n_lanes = out.shape[1]
    return args


def _table_args(ptbl, mtbl, ttbl, kw, planar: bool) -> _BounceArgs:
    """Kernel A's argument struct with the table part filled in."""
    return _BounceArgs(
        ptbl=ptbl.data_ptr(), mtbl=mtbl.data_ptr(), ttbl=ttbl.data_ptr(),
        n_prims=kw["n_prims"], n_mats=kw["n_mats"],
        n_targets=kw["n_targets"], has_motion=int(kw["has_motion"]),
        use_prim_albedo=int(kw["use_prim_albedo"]), planar=int(planar),
        t_min=float(kw["t_min"]))


def shade_plain(mtbl, ttbl, hit, medium, lanes, uniforms, *, n_mats: int,
                n_targets: int, has_medium: bool, sphere_rots: tuple = ()):
    """:func:`shade_megakernel` in plain PyTorch, on any device."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, al = lanes
    tmed, vmat = medium if has_medium else (None, None)
    return shade_values(tuple(hit), mtbl, ttbl, ox, oy, oz, dx, dy, dz, tr,
                        tg, tb, al > 0.5, uniforms, n_mats=n_mats,
                        n_targets=n_targets, tmed=tmed, vmat=vmat,
                        sphere_rots=sphere_rots)


N_ROT_COLS = 10     # a sphere rotation row: winner index, then r9


@functools.lru_cache(maxsize=64)
def sphere_rot_table(sphere_rots: tuple, device) -> torch.Tensor:
    """The shade kernel's rotation table of ``sphere_rots`` on ``device``:
    [K, 10] f32 rows (the row index as a float, then its row-major
    world->object rotation), made once per rotation list and device."""
    rows = [[float(row)] + [float(x) for x in r9] for row, r9 in sphere_rots]
    return torch.tensor(np.asarray(rows, np.float32).reshape(-1, N_ROT_COLS),
                        device=device)


class _ShadeArgs(ctypes.Structure):
    """Mirror of ``ShadeArgs`` in csrc/shade_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "mtbl", "ttbl", "t", "bi", "nx", "ny", "nz", "fr", "uu", "vv", "mat",
        "sph", "tmed", "vmat", "ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg",
        "tb", "al", "uni", "rots", "out")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in ("n_mats", "n_targets",
                                        "has_medium", "n_rots")])


_HIT_NAMES = ("t", "bi", "nx", "ny", "nz", "fr", "uu", "vv", "mat", "sph")
_SHADE_LANE_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb",
                     "al")


def shade_megakernel(mtbl, ttbl, hit, medium, lanes, uniforms, *,
                     n_mats: int, n_targets: int, has_medium: bool,
                     sphere_rots: tuple = ()):
    """The shade stage of one bounce from a precomputed hit record.

    ``hit``: 10 [R] f32 tensors (t, winner index, nx, ny, nz with the
    normal facing the ray, front 0/1, u, v, material id, sphere 0/1; pass
    sphere 0 to keep the given uv); ``medium``: (t_med, medium material
    id) or None; ``lanes``: (ox, oy, oz, dx, dy, dz, tr, tg, tb, alive
    0/1); ``uniforms``: [N_U, R].  ``mtbl`` holds material rows (not
    behaviours), at most :data:`MAX_SHADE_MATS`.  ``sphere_rots``:
    ``((row, r9), ...)``, the rotations of the sphere rows whose uv the
    kernel evaluates in object space (lanes with sphere flag 1).  Returns
    the 15 bounce outputs of :func:`shade_values`.

    CPU tensors run :func:`shade_plain`; CUDA tensors launch
    ``csrc/shade_kernel.cu`` (``shade_megakernel.launches`` counts the
    launches, ``.rot_launches`` those with a rotation table)."""
    dev = hit[0].device
    kw = dict(n_mats=n_mats, n_targets=n_targets, has_medium=has_medium,
              sphere_rots=tuple(sphere_rots))
    if dev.type == "cpu":
        return shade_plain(mtbl, ttbl, hit, medium, lanes, uniforms, **kw)
    if dev.type != "cuda":
        raise ValueError(f"shade_megakernel: unsupported device {dev}")
    r = hit[0].shape[0]
    if len(hit) != 10 or len(lanes) != 10 \
            or (has_medium and (medium is None or len(medium) != 2)):
        raise ValueError("shade_megakernel: need 10 hit tensors, 10 lane "
                         "tensors and, with has_medium, 2 medium tensors")
    check_table("mtbl", mtbl, N_MCOLS, dev)
    check_table("ttbl", ttbl, N_TCOLS, dev)
    check_targets(ttbl, n_targets)
    if not 0 < n_mats <= min(mtbl.shape[0], MAX_SHADE_MATS):
        raise ValueError(f"n_mats={n_mats} outside 1..{MAX_SHADE_MATS}")
    check_lanes(zip(_HIT_NAMES, hit), r, dev)
    check_lanes(zip(_SHADE_LANE_NAMES, lanes), r, dev)
    med = tuple(medium) if has_medium else (None, None)
    if has_medium:
        check_lanes(zip(("tmed", "vmat"), med), r, dev)
    if (uniforms.device != dev or uniforms.dtype != torch.float32
            or uniforms.dim() != 2 or uniforms.shape[0] < N_U
            or uniforms.shape[1] != r or not uniforms.is_contiguous()):
        raise ValueError(f"uniforms: need a contiguous f32 [>={N_U}, {r}] "
                         f"tensor on {dev}")
    from ._build import launch
    rots = (sphere_rot_table(kw["sphere_rots"], dev) if sphere_rots
            else None)
    out = torch.empty((N_OUT, r), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    args = _ShadeArgs(
        *(ptr(x) for x in (mtbl, ttbl) + tuple(hit) + med + tuple(lanes)
          + (uniforms, rots, out)),
        r, n_mats, n_targets, int(has_medium), len(kw["sphere_rots"]))
    launch("rt_shade", args, dev)
    shade_megakernel.launches += 1
    shade_megakernel.rot_launches += bool(sphere_rots)
    return tuple(out.unbind(0))


shade_megakernel.launches = 0
shade_megakernel.rot_launches = 0


def check_table(name, x, cols, device):
    if (x.device != device or x.dtype != torch.float32 or x.dim() != 2
            or x.shape[1] != cols or not x.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous f32 [*, {cols}] "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def check_targets(ttbl, n_targets):
    if not (0 <= n_targets <= MAX_TARGETS
            and (n_targets == 0 or n_targets <= ttbl.shape[0])):
        raise ValueError(f"n_targets={n_targets} outside 0..{MAX_TARGETS}")


def check_tables(ptbl, mtbl, ttbl, n_prims, n_mats, n_targets, device,
                 max_prims: int = MAX_SMEM_PRIMS):
    """Raise unless the tables are contiguous f32 on ``device`` and the
    row counts fit the kernels: at most ``max_prims`` rows (what a kernel
    block stages in shared memory, unless the caller walks a BVH)."""
    for name, x, cols in (("ptbl", ptbl, N_COLS), ("mtbl", mtbl, N_MCOLS),
                          ("ttbl", ttbl, N_TCOLS)):
        check_table(name, x, cols, device)
    if not (0 <= n_prims <= min(ptbl.shape[0], max_prims)):
        raise ValueError(f"n_prims={n_prims}: the kernel takes at most "
                         f"{max_prims} rows here")
    if not (0 < n_mats <= min(mtbl.shape[0], MAX_MAT_ROWS)):
        raise ValueError(f"n_mats={n_mats} outside 1..{MAX_MAT_ROWS}")
    check_targets(ttbl, n_targets)


def check_lanes(named, n, device, dtype=torch.float32):
    for name, x in named:
        if (x.device != device or x.dtype != dtype or x.dim() != 1
                or x.shape[0] != n or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dtype} [{n}] "
                             f"tensor on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def bounce_megakernel(ptbl, mtbl, ttbl, ox, oy, oz, dx, dy, dz, tm, tr, tg,
                      tb, al, uniforms, *, n_prims: int, n_mats: int,
                      n_targets: int, t_min: float, has_motion: bool,
                      use_prim_albedo: bool = False,
                      prepared: BounceLaunch | None = None):
    """One bounce of every lane.  Lanes are 1-D [R] f32 tensors (``al`` is
    0/1), ``uniforms`` is [N_U, R] (at least N_U rows, lane-contiguous).
    Returns the 15 [R] f32 outputs of :func:`shade_values`.
    ``prepared`` (:func:`prepare_bounce` of these tables and parameters)
    skips the tables' checks and selects the planar instantiation where
    it serves them; without it the tables are checked and the general
    instantiation runs.

    CPU tensors run :func:`bounce_plain`; CUDA tensors launch the kernel
    (``bounce_megakernel.launches`` counts the launches)."""
    lanes = (ox, oy, oz, dx, dy, dz, tm, tr, tg, tb, al)
    kw = dict(n_prims=n_prims, n_mats=n_mats, n_targets=n_targets,
              t_min=t_min, has_motion=has_motion,
              use_prim_albedo=use_prim_albedo)
    dev = ox.device
    if dev.type == "cpu":
        return bounce_plain(ptbl, mtbl, ttbl, *lanes, uniforms, **kw)
    if dev.type != "cuda":
        raise ValueError(f"bounce_megakernel: unsupported device {dev}")
    r = ox.shape[0]
    if prepared is None:
        check_tables(ptbl, mtbl, ttbl, n_prims, n_mats, n_targets, dev)
        table_args = _table_args(ptbl, mtbl, ttbl, kw, False)
    elif (prepared.ptbl is not ptbl or prepared.mtbl is not mtbl
          or prepared.ttbl is not ttbl or prepared.kw != kw):
        raise ValueError("bounce_megakernel: the prepared tables are not "
                         "the ones given")
    else:
        table_args = prepared.args
    check_lanes(zip(_LANE_NAMES, lanes), r, dev)
    if (uniforms.device != dev or uniforms.dtype != torch.float32
            or uniforms.dim() != 2 or uniforms.shape[0] < N_U
            or uniforms.shape[1] != r or not uniforms.is_contiguous()):
        raise ValueError(f"uniforms: need a contiguous f32 [>={N_U}, {r}] "
                         f"tensor on {dev}")
    from ._build import launch
    out = torch.empty((N_OUT, r), dtype=torch.float32, device=dev)
    launch("rt_bounce", lane_args(table_args, lanes, uniforms, out), dev)
    bounce_megakernel.launches += 1
    return tuple(out.unbind(0))


bounce_megakernel.launches = 0
