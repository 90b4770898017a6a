"""One bounce from a known winner index as plain per-lane tensor math
(``raytrace_tpu/diff/lane_replay.py``).

:func:`lane_math` is the complete bounce given the winner row, written on
1-D [R] tensors in the JAX package's SoA argument order.  Under torch
autograd it is the plain version of the backward kernel K5
(``ops/bounce_bwd_gather_kernel.py``), whose CUDA body
(``csrc/lane_adjoint.cuh``) is its hand-derived adjoint.  The gradient
discipline is the JAX package's:

* ``torch.where`` sends the cotangent only to the taken branch, and
  ``torch.maximum``/``torch.minimum`` split it half and half on a tie, as
  ``jnp.where``/``jnp.maximum``/``jnp.minimum`` do (``torch.clamp`` would
  not split, so a clamp against a constant is written as a maximum);
* the sampled direction and the MIS mixture pdf are detached, like the
  JAX package's ``stop_gradient``;
* the surface (u, v) feeds only the checker's ``floor``, whose derivative
  is zero: it is detached there, the symbolic zero JAX's ``floor`` gives.

Redirect targets arrive as Python floats and their derived constants are
computed in float32 (:func:`target_consts`), as the kernels compute them;
the plane normal takes 1/sqrt where the JAX package takes rsqrt, as the
forward kernels do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..materials.materials import (
    MAT_ANISOTROPIC, MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_LIGHT, MAT_LOMMEL,
    MAT_METAL, MAT_MIRROR, MAT_PITCH_BLACK, MAT_TRANSPARENT,
)
from ..scene.types import PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE, \
    PRIM_TRIANGLE
from ..textures.textures import TEX_CHECKER, is_rich
from .gradients import map_scene

INF = float("inf")
DENOM_EPS = 1e-8    # plane denominator guard (ops/intersect.py)

# table caps of the pre-gathered backward: material and texture rows
MAX_REPLAY_MATS = 64
MAX_REPLAY_TEX = 64

N_DIFF_BASE = 26   # p0(3) e1(3) e2(3) c0(3) c1(3) param o(3) d(3) time thr(3)
N_DIFF_MOTION = 32  # + mv0(3) mv1(3)
N_DET = 21         # kindp kindm texkind f0 f1 uv(6) u(8) alive valid0
N_OUT = 13         # o2(3) d2(3) rad(3) thr2(3) miss

_F = np.float32


def replay_eligible(scene) -> bool:
    """Can the replay backward serve this scene (the JAX package's
    ``replay_pre_eligible`` with ``defer_rich=True``)?  Image, noise,
    marble and custom textures are shaded at albedo 1.0 here and
    multiplied in after the step (``fused_iter.apply_rich``), but light
    emission is in-kernel, so lights keep constant and checker textures.
    The row cap is the fused diff driver's (``MEGA_MAX_PRIMS``): the
    backward sees per-lane gathered rows, so it does not depend on the
    table's size."""
    from ..render.integrator import MEGA_MAX_PRIMS
    return (scene.prims.kind.shape[0] <= MEGA_MAX_PRIMS
            and scene.materials.kind.shape[0] <= MAX_REPLAY_MATS
            and scene.textures.kind.shape[0] <= MAX_REPLAY_TEX
            and not is_rich(scene.materials.light_tex_kinds))


# the pre-gathered backward of the fused iteration takes the same scenes
replay_pre_eligible = replay_eligible


def _mx(x, c: float):
    """``jnp.maximum(x, c)``: the cotangent splits half and half on a
    tie."""
    return torch.maximum(x, x.new_full((), c))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _norm3(x, y, z, eps=1e-12):
    inv = 1.0 / torch.sqrt(_mx(x * x + y * y + z * z, eps))
    return x * inv, y * inv, z * inv


def _poly_atan(t):
    z = t * t
    return t * (0.9998660 + z * (-0.3302995 + z * (0.1801410
                + z * (-0.0851330 + z * 0.0208351))))


def _atan2_poly(y, x):
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / _mx(hi, 1e-30)
    a = _poly_atan(t)
    a = torch.where(ay > ax, (math.pi / 2) - a, a)
    a = torch.where(x < 0.0, math.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def _acos_poly(x):
    return _atan2_poly(torch.sqrt(_mx(1.0 - x * x, 0.0)), x)


def target_consts(tgt, n_targets: int):
    """Float32 constants of the redirect targets ``tgt = (qs, us, vs,
    probs)`` (Python floats): per target ``(cdf, q, u, v, prob, cp, nt,
    qn, wa, wb)`` with ``cp = u x v``, ``nt`` its unit vector, ``qn =
    q.nt`` and ``w_a = v x n_s``, ``w_b = n_s x u`` (``n_s = cp/|cp|^2``),
    each entry a Python float holding a float32 value."""
    qs, us, vs, probs = tgt
    out = []
    acc = _F(0.0)
    for ti in range(n_targets):
        q = [_F(x) for x in qs[ti]]
        u = [_F(x) for x in us[ti]]
        v = [_F(x) for x in vs[ti]]
        pr = _F(probs[ti])
        acc = acc + pr
        cp = (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
              u[0] * v[1] - u[1] * v[0])
        cp2 = np.maximum(cp[0] * cp[0] + cp[1] * cp[1] + cp[2] * cp[2],
                         _F(1e-30))
        inv = _F(1.0) / np.sqrt(cp2)
        nt = (cp[0] * inv, cp[1] * inv, cp[2] * inv)
        qn = q[0] * nt[0] + q[1] * nt[1] + q[2] * nt[2]
        ns = (cp[0] / cp2, cp[1] / cp2, cp[2] / cp2)
        wa = (v[1] * ns[2] - v[2] * ns[1], v[2] * ns[0] - v[0] * ns[2],
              v[0] * ns[1] - v[1] * ns[0])
        wb = (ns[1] * u[2] - ns[2] * u[1], ns[2] * u[0] - ns[0] * u[2],
              ns[0] * u[1] - ns[1] * u[0])
        fl = lambda xs: tuple(float(x) for x in xs)
        out.append(dict(cdf=float(acc), q=fl(q), u=fl(u), v=fl(v),
                        prob=float(pr), cp=fl(cp), nt=fl(nt), qn=float(qn),
                        wa=fl(wa), wb=fl(wb)))
    return out


def tgt_from_table(ttbl, n_targets: int):
    """``(qs, us, vs, probs)`` from a packed [T, 16] target table."""
    rows = ttbl[:n_targets].tolist() if n_targets else []
    return ([r[0:3] for r in rows], [r[3:6] for r in rows],
            [r[6:9] for r in rows], [r[12] for r in rows])


def lane_math(diff, det, tgt, *, has_motion: bool, has_box: bool,
              t_min: float, n_targets: int, exact_trig: bool = False):
    """One bounce from the saved winner index, per lane.

    ``diff``: winner-row p0/e1/e2 (9), [mv0/mv1 (6) with motion], texture
    c0/c1 (6), material param, ray o/d (6), time, throughput (3).
    ``det``: winner prim kind, material kind, texture kind, checker
    f0/f1, triangle corner uvs (6), the 8 bounce uniforms, alive flag,
    idx>=0 flag, all f32.  ``tgt``: redirect targets ``(qs, us, vs,
    probs)`` as Python floats.  Returns the 13 outputs o2 (3), d2 (3),
    emitted radiance without the background term (3), thr2 (3), miss."""
    if (len(diff) != (N_DIFF_MOTION if has_motion else N_DIFF_BASE)
            or len(det) != N_DET):
        raise ValueError(f"lane_math: {len(diff)} differentiable and "
                         f"{len(det)} detached columns")
    if has_motion:
        (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z,
         mv0x, mv0y, mv0z, mv1x, mv1y, mv1z,
         c0r, c0g, c0b, c1r, c1g, c1b, param,
         ox, oy, oz, dx, dy, dz, time, thr_r, thr_g, thr_b) = diff
    else:
        (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z,
         c0r, c0g, c0b, c1r, c1g, c1b, param,
         ox, oy, oz, dx, dy, dz, time, thr_r, thr_g, thr_b) = diff
    (kind_p, kind_m, texkind, f0l, f1l, uv0u, uv0v, uv1u, uv1v, uv2u,
     uv2v, u0, u1, u2, u3, u4, u5, u6, u7, alive_f, idxv_f) = det

    alive = alive_f > 0.5
    atan2 = torch.atan2 if exact_trig else _atan2_poly
    acos = torch.acos if exact_trig else _acos_poly

    if has_motion:
        mt = 1.0 - time
        shx = mv0x * mt + time * mv1x
        shy = mv0y * mt + time * mv1y
        shz = mv0z * mt + time * mv1z
        osx, osy, osz = ox - shx, oy - shy, oz - shz
    else:
        osx, osy, osz = ox, oy, oz

    is_sphere = kind_p == float(PRIM_SPHERE)
    is_par = kind_p == float(PRIM_PARALLELOGRAM)
    is_tri = kind_p == float(PRIM_TRIANGLE)
    is_boxk = kind_p == float(PRIM_BOX)

    # ---- hit t ----
    ocx, ocy, ocz = p0x - osx, p0y - osy, p0z - osz
    h = _dot3(dx, dy, dz, ocx, ocy, ocz)
    cc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - e1x * e1x
    disc = h * h - cc
    sq = torch.sqrt(torch.where(disc >= 0.0, _mx(disc, 1e-20), 1.0))
    s_r1 = h - sq
    s_r2 = h + sq

    cpx, cpy, cpz = _cross3(e1x, e1y, e1z, e2x, e2y, e2z)
    cp_sq_raw = _dot3(cpx, cpy, cpz, cpx, cpy, cpz)
    degen = cp_sq_raw < 1e-24
    cpx = torch.where(degen, 0.0, cpx)
    cpy = torch.where(degen, 0.0, cpy)
    cpz = torch.where(degen, 1.0, cpz)
    cp_sq = torch.where(degen, 1.0, cp_sq_raw)
    inv_cp = 1.0 / torch.sqrt(cp_sq)
    nux, nuy, nuz = cpx * inv_cp, cpy * inv_cp, cpz * inv_cp
    denom = _dot3(nux, nuy, nuz, dx, dy, dz)
    denom_ok = torch.abs(denom) > DENOM_EPS
    denom_safe = torch.where(denom_ok, denom, 1.0)
    t_plane = _dot3(nux, nuy, nuz, p0x - osx, p0y - osy, p0z - osz) \
        / denom_safe
    prx = osx + t_plane * dx - p0x
    pry = osy + t_plane * dy - p0y
    prz = osz + t_plane * dz - p0z
    nsx, nsy, nsz = cpx / cp_sq, cpy / cp_sq, cpz / cp_sq
    c1x, c1y, c1z = _cross3(prx, pry, prz, e2x, e2y, e2z)
    c2x, c2y, c2z = _cross3(e1x, e1y, e1z, prx, pry, prz)
    a = _dot3(nsx, nsy, nsz, c1x, c1y, c1z)
    b = _dot3(nsx, nsy, nsz, c2x, c2y, c2z)
    member_par = (0.0 <= a) & (a <= 1.0) & (0.0 <= b) & (b <= 1.0)
    member_tri = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    member = torch.where(is_par, member_par, member_tri)
    plane_ok = denom_ok & ~degen & member

    r1 = torch.where(is_sphere, torch.where(disc >= 0.0, s_r1, INF),
                     torch.where(plane_ok, t_plane, INF))
    r2 = torch.where(is_sphere & (disc >= 0.0), s_r2, INF)
    if has_box:
        # slab test: p0 = lo, e1 = hi
        tn = torch.full_like(r1, -INF)
        tf = torch.full_like(r1, INF)
        for lo_c, hi_c, o_c, d_c in ((p0x, e1x, osx, dx),
                                     (p0y, e1y, osy, dy),
                                     (p0z, e1z, osz, dz)):
            d_sf = torch.where(torch.abs(d_c) < 1e-20,
                               torch.where(d_c < 0, -1e-20, 1e-20), d_c)
            t0 = (lo_c - o_c) / d_sf
            t1 = (hi_c - o_c) / d_sf
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        box_ok = is_boxk & (tn <= tf)
        r1 = torch.where(box_ok, tn, r1)
        r2 = torch.where(box_ok, tf, r2)
    # nearest root strictly inside the open interval
    ok1 = (t_min < r1) & (r1 < INF)
    ok2 = (t_min < r2) & (r2 < INF)
    t_roots = torch.where(ok1, r1, torch.where(ok2, r2, INF))

    valid = (idxv_f > 0.5) & (t_roots < INF)
    t_safe = torch.where(valid, t_roots, 1.0)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz

    # ---- hit record ----
    radius = torch.where(torch.abs(e1x) > 0, e1x, 1.0)
    inv_r = 1.0 / radius
    rx = osx + t_safe * dx - p0x
    ry = osy + t_safe * dy - p0y
    rz = osz + t_safe * dz - p0z
    owx, owy, owz = rx * inv_r, ry * inv_r, rz * inv_r
    s_front = _dot3(dx, dy, dz, owx, owy, owz) <= 0.0
    sgn_s = torch.where(s_front, 1.0, -1.0)
    s_nx, s_ny, s_nz = owx * sgn_s, owy * sgn_s, owz * sgn_s

    p_front = denom < 0.0
    sgn_p = torch.where(p_front, 1.0, -1.0)
    p_nx, p_ny, p_nz = nux * sgn_p, nuy * sgn_p, nuz * sgn_p

    nx = torch.where(is_sphere, s_nx, p_nx)
    ny = torch.where(is_sphere, s_ny, p_ny)
    nz = torch.where(is_sphere, s_nz, p_nz)
    front = torch.where(is_sphere, s_front, p_front)

    # the surface (u, v) only picks a checker cell: no gradient
    with torch.no_grad():
        xz_ok = owx * owx + owz * owz > 1e-12
        sxu = torch.where(xz_ok, owx, 0.0)
        szu = torch.where(xz_ok, owz, 1.0)
        s_u = atan2(sxu, szu) * (0.5 / math.pi) + 0.5
        s_v = acos(torch.clip(-owy, -1.0 + 1e-6, 1.0 - 1e-6)) \
            * (1.0 / math.pi)
        c1x, c1y, c1z = _cross3(rx, ry, rz, e2x, e2y, e2z)
        c2x, c2y, c2z = _cross3(e1x, e1y, e1z, rx, ry, rz)
        ra = _dot3(nsx, nsy, nsz, c1x, c1y, c1z)
        rb = _dot3(nsx, nsy, nsz, c2x, c2y, c2z)
        w0 = 1.0 - ra - rb
        tri_u = w0 * uv0u + ra * uv1u + rb * uv2u
        tri_v = w0 * uv0v + ra * uv1v + rb * uv2v
        p_u = torch.where(is_tri, tri_u, ra)
        p_v = torch.where(is_tri, tri_v, rb)
        uu = torch.where(is_sphere, s_u, p_u)
        vv = torch.where(is_sphere, s_v, p_v)

    if has_box:
        # the box normal is an axis (no gradient); its face (a, b) only
        # picks a checker cell
        with torch.no_grad():
            szx = _mx(e1x - p0x, 1e-12)
            szy = _mx(e1y - p0y, 1e-12)
            szz = _mx(e1z - p0z, 1e-12)
            relx = rx / szx - 0.5
            rely = ry / szy - 0.5
            relz = rz / szz - 0.5
            arx, ary, arz = torch.abs(relx), torch.abs(rely), torch.abs(relz)
            ax_x = (arx >= ary) & (arx >= arz)
            ax_y = ~ax_x & (ary >= arz)
            ax_z = ~ax_x & ~ax_y
            sgx = torch.where(relx >= 0.0, 1.0, -1.0)
            sgy = torch.where(rely >= 0.0, 1.0, -1.0)
            sgz = torch.where(relz >= 0.0, 1.0, -1.0)
            bowx = torch.where(ax_x, sgx, 0.0)
            bowy = torch.where(ax_y, sgy, 0.0)
            bowz = torch.where(ax_z, sgz, 0.0)
            b_front = _dot3(dx, dy, dz, bowx, bowy, bowz) < 0.0
            sgn_b = torch.where(b_front, 1.0, -1.0)
            fx_ = rx / szx
            fy_ = ry / szy
            fz_ = rz / szz
            # face -> (a, b) per the reference cuboid winding
            b_a = torch.where(
                ax_z, torch.where(sgz > 0.0, fx_, 1.0 - fx_),
                torch.where(ax_x, torch.where(sgx > 0.0, 1.0 - fz_, fz_),
                            fx_))
            b_b = torch.where(ax_y, torch.where(sgy > 0.0, 1.0 - fz_, fz_),
                              fy_)
            uu = torch.where(is_boxk, b_a, uu)
            vv = torch.where(is_boxk, b_b, vv)
        nx = torch.where(is_boxk, bowx * sgn_b, nx)
        ny = torch.where(is_boxk, bowy * sgn_b, ny)
        nz = torch.where(is_boxk, bowz * sgn_b, nz)
        front = torch.where(is_boxk, b_front, front)

    # ---- texture: constant or checker ----
    i_f = torch.floor(uu * f0l)
    j_f = torch.floor(vv * f1l)
    odd = torch.remainder(i_f + j_f, 2.0) != 0.0
    use_c1 = (texkind == float(TEX_CHECKER)) & odd
    alr = torch.where(use_c1, c1r, c0r)
    alg = torch.where(use_c1, c1g, c0g)
    alb = torch.where(use_c1, c1b, c0b)
    rich_tex = texkind > float(TEX_CHECKER)
    alr = torch.where(rich_tex, 1.0, alr)
    alg = torch.where(rich_tex, 1.0, alg)
    alb = torch.where(rich_tex, 1.0, alb)

    live_hit = alive & valid
    miss_f = torch.where(alive & ~valid, 1.0, 0.0)

    # ---- emission; the background is added by the caller ----
    emit_f = torch.where(live_hit & (kind_m == float(MAT_LIGHT)), 1.0, 0.0)
    rad_r = thr_r * alr * emit_f
    rad_g = thr_g * alg * emit_f
    rad_b = thr_b * alb * emit_f

    # ---- behaviour classes ----
    is_absorb = (kind_m == float(MAT_LIGHT)) | \
        (kind_m == float(MAT_PITCH_BLACK))
    is_hemi = (kind_m == float(MAT_LAMBERTIAN)) | \
        (kind_m == float(MAT_LOMMEL))
    is_metal = kind_m == float(MAT_METAL)
    is_diel = kind_m == float(MAT_DIELECTRIC)
    is_mirror = kind_m == float(MAT_MIRROR)
    is_spec = is_mirror | is_metal | is_diel | \
        (kind_m == float(MAT_TRANSPARENT))

    # ---- specular family ----
    ddn = _dot3(dx, dy, dz, nx, ny, nz)
    rfx = dx - 2.0 * ddn * nx
    rfy = dy - 2.0 * ddn * ny
    rfz = dz - 2.0 * ddn * nz
    zf = 1.0 - 2.0 * u0
    rf = torch.sqrt(_mx(1.0 - zf * zf, 0.0))
    phf = (2.0 * math.pi) * u1
    fux, fuy, fuz = rf * torch.cos(phf), rf * torch.sin(phf), zf
    mxx = rfx + param * fux
    mxy = rfy + param * fuy
    mxz = rfz + param * fuz
    metal_ok = _dot3(mxx, mxy, mxz, nx, ny, nz) > 0.0
    mxx, mxy, mxz = _norm3(mxx, mxy, mxz)

    ior = _mx(param, 1e-6)
    ior_ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.minimum(_dot3(nx, ny, nz, -dx, -dy, -dz),
                          nx.new_full((), 1.0))
    sin_t = torch.sqrt(_mx(1.0 - cos_t * cos_t, 0.0))
    cannot = ior_ratio * sin_t > 1.0
    r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
    r0 = r0 * r0
    one_c = 1.0 - cos_t
    oc2 = one_c * one_c
    schlick = r0 + (1.0 - r0) * (oc2 * oc2 * one_c)
    di_reflect = cannot | (u2 < schlick)
    qx = ior_ratio * (dx + cos_t * nx)
    qy = ior_ratio * (dy + cos_t * ny)
    qz = ior_ratio * (dz + cos_t * nz)
    rem = _mx(torch.abs(1.0 - (qx * qx + qy * qy + qz * qz)), 1e-12)
    par = torch.sqrt(rem)
    fx2, fy2, fz2 = qx - par * nx, qy - par * ny, qz - par * nz
    dix = torch.where(di_reflect, rfx, fx2)
    diy = torch.where(di_reflect, rfy, fy2)
    diz = torch.where(di_reflect, rfz, fz2)

    spx = torch.where(is_mirror, rfx, dx)
    spy = torch.where(is_mirror, rfy, dy)
    spz = torch.where(is_mirror, rfz, dz)
    spx = torch.where(is_metal, mxx, spx)
    spy = torch.where(is_metal, mxy, spy)
    spz = torch.where(is_metal, mxz, spz)
    spx = torch.where(is_diel, dix, spx)
    spy = torch.where(is_diel, diy, spy)
    spz = torch.where(is_diel, diz, spz)
    s_ar = torch.where(is_diel, 1.0, alr)
    s_ag = torch.where(is_diel, 1.0, alg)
    s_ab = torch.where(is_diel, 1.0, alb)
    spec_dead = is_metal & ~metal_ok

    # ---- diffuse family with redirection (sampled direction detached) --
    with torch.no_grad():
        zu = 1.0 - 2.0 * u3
        ru = torch.sqrt(_mx(1.0 - zu * zu, 0.0))
        phu = (2.0 * math.pi) * u4
        uux, uuy, uuz = ru * torch.cos(phu), ru * torch.sin(phu), zu
        cdx, cdy, cdz = _norm3(nx + uux, ny + uuy, nz + uuz)
        bx = torch.where(is_hemi, cdx, uux)
        by = torch.where(is_hemi, cdy, uuy)
        bz = torch.where(is_hemi, cdz, uuz)
        tcs = target_consts(tgt, n_targets)
        if n_targets > 0:
            use_t = u5 < tcs[-1]["cdf"]
            lq = [torch.zeros_like(u5) for _ in range(9)]
            chosen = torch.zeros_like(use_t)
            for tc in tcs:
                pick = (u5 < tc["cdf"]) & ~chosen
                chosen = chosen | pick
                vals = tc["q"] + tc["u"] + tc["v"]
                lq = [torch.where(pick, vals[k], lq[k]) for k in range(9)]
            tgx = lq[0] + u6 * lq[3] + u7 * lq[6] - px
            tgy = lq[1] + u6 * lq[4] + u7 * lq[7] - py
            tgz = lq[2] + u6 * lq[5] + u7 * lq[8] - pz
            tgx, tgy, tgz = _norm3(tgx, tgy, tgz)
            bx = torch.where(use_t, tgx, bx)
            by = torch.where(use_t, tgy, by)
            bz = torch.where(use_t, tgz, bz)

    mu1 = _dot3(bx, by, bz, nx, ny, nz)
    pdf_base = torch.where(is_hemi, mu1 * (1.0 / math.pi), 0.25 / math.pi)
    hemi_dead = is_hemi & (pdf_base <= 0.0)

    # the MIS mixture pdf (detached)
    with torch.no_grad():
        if n_targets > 0:
            pdf_sum = float(_F(1.0) - _F(tcs[-1]["cdf"])) * pdf_base
            for tc in tcs:
                (ntx, nty, ntz), qn = tc["nt"], tc["qn"]
                den = bx * ntx + by * nty + bz * ntz
                den_ok = torch.abs(den) > 1e-8
                den_s = torch.where(den_ok, den, 1.0)
                tt = (qn - (px * ntx + py * nty + pz * ntz)) / den_s
                hx = px + tt * bx - tc["q"][0]
                hy = py + tt * by - tc["q"][1]
                hz = pz + tt * bz - tc["q"][2]
                aa = _dot3(hx, hy, hz, *tc["wa"])
                bb = _dot3(hx, hy, hz, *tc["wb"])
                hit_t = (den_ok & (tt > 0.0) & (0.0 <= aa) & (aa <= 1.0)
                         & (0.0 <= bb) & (bb <= 1.0))
                cross_dot = torch.abs(bx * tc["cp"][0] + by * tc["cp"][1]
                                      + bz * tc["cp"][2])
                pdf_i = torch.where(
                    hit_t, tt * tt / _mx(cross_dot, 1e-12), 0.0)
                pdf_sum = pdf_sum + tc["prob"] * pdf_i
            pdf_mix = pdf_sum
        else:
            pdf_mix = pdf_base
        pdf_mix = _mx(pdf_mix, 1e-12)

    mu0 = -ddn
    lommel = 0.25 / _mx(mu0 + mu1, 1e-8)
    g_hg = param
    hg_mu = _dot3(dx, dy, dz, bx, by, bz)
    hg_den = _mx(1.0 + g_hg * g_hg - 2.0 * g_hg * hg_mu, 1e-12)
    hg = (1.0 - g_hg * g_hg) / (hg_den * torch.sqrt(hg_den))
    brdf = torch.where(kind_m == float(MAT_LOMMEL), lommel, 1.0)
    brdf = torch.where(kind_m == float(MAT_ANISOTROPIC), hg, brdf)
    dw = brdf * pdf_base / pdf_mix
    d_ar = alr * dw
    d_ag = alg * dw
    d_ab = alb * dw

    # ---- combine ----
    ndx = torch.where(is_spec, spx, bx)
    ndy = torch.where(is_spec, spy, by)
    ndz = torch.where(is_spec, spz, bz)
    w_r = torch.where(is_spec, s_ar, d_ar)
    w_g = torch.where(is_spec, s_ag, d_ag)
    w_b = torch.where(is_spec, s_ab, d_ab)
    next_alive = live_hit & ~is_absorb & ~spec_dead & ~hemi_dead

    thr2r = torch.where(next_alive, thr_r * w_r, thr_r)
    thr2g = torch.where(next_alive, thr_g * w_g, thr_g)
    thr2b = torch.where(next_alive, thr_b * w_b, thr_b)
    o2x = torch.where(next_alive, px, ox)
    o2y = torch.where(next_alive, py, oy)
    o2z = torch.where(next_alive, pz, oz)
    d2x = torch.where(next_alive, ndx, dx)
    d2y = torch.where(next_alive, ndy, dy)
    d2z = torch.where(next_alive, ndz, dz)
    return (o2x, o2y, o2z, d2x, d2y, d2z, rad_r, rad_g, rad_b,
            thr2r, thr2g, thr2b, miss_f)


def scene_row_grads(scene, g, n_row: int):
    """The scene-shaped gradient (:func:`assemble_scene_grads`) of the
    reduced row gradients ``g`` (``ops/row_reduce.RowGrads``)."""
    p = g.g_ptab
    motion = n_row == 15
    return assemble_scene_grads(
        scene, p[:, 0:3], p[:, 3:6], p[:, 6:9],
        p[:, 9:12] if motion else None, p[:, 12:15] if motion else None,
        g.g_mparam, g.g_tc0, g.g_tc1)


def replay_bwd_soa(scene, s, comps, u_cols, thr, alive, idx, ct12, *,
                   has_motion: bool, t_min: float, rows=None, ttbl=None):
    """VJP of one kernel-A bounce through kernel K7
    (``ops/bounce_bwd_kernel.py``), the JAX package's ``replay_bwd_soa``.

    ``comps`` [7, R] and ``thr`` [3, R] are the bounce's inputs (dead
    lanes not parked), ``u_cols`` its 8 uniform columns ([8, R]),
    ``alive`` bool [R], ``idx`` the winner row (i32, -1 on a miss),
    ``ct12`` the cotangents of (o2 (3), d2 (3), radiance contribution
    (3), thr2 (3)) as [12, R].  ``rows`` is ``ops/row_reduce.row_tables``'
    result and ``ttbl`` the packed target table, both made here if not
    given.

    K7 reads each lane's winner, material and texture columns by index
    and reduces the row gradients onto the tables itself
    (``bounce_bwd_megakernel_reduced``); the background term ``thr *
    background(o, d) * miss`` is differentiated outside the kernel by
    torch autograd over ``s.background``, so any background callable
    works.  Returns ``(g_scene, g_comps [7, R], g_thr [3, R])`` with
    ``g_scene`` scene-shaped (:func:`assemble_scene_grads`)."""
    from ..ops.bounce_bwd_kernel import bounce_bwd_megakernel_reduced
    from ..ops.bounce_kernel import pack_targets
    from ..ops.row_reduce import row_tables
    dev = comps.device
    n_row = 15 if has_motion else 9
    tables = row_tables(scene, n_row) if rows is None else rows
    if ttbl is None:
        ttbl = pack_targets(s.redirect_prob, s.redirect_q, s.redirect_u,
                            s.redirect_v).to(dev).contiguous()
    g, rg = bounce_bwd_megakernel_reduced(
        ttbl, tables, idx.to(torch.float32),
        tuple(comps.unbind(0)) + tuple(thr.unbind(0)), u_cols,
        torch.where(alive, 1.0, 0.0), tuple(ct12.unbind(0)),
        n_targets=s.n_redirect, has_motion=has_motion,
        has_box=scene.prims.has_box, t_min=t_min, n_row=n_row)
    g_scene = scene_row_grads(scene, rg, n_row)
    g_comps = torch.stack(g[0:7])
    g_thr = torch.stack(g[7:10])
    miss_f = g[10]

    # the background term on a miss, outside the kernel
    with torch.enable_grad():
        o3 = comps[0:3].T.detach().requires_grad_(True)
        d3 = comps[3:6].T.detach().requires_grad_(True)
        t3 = thr.T.detach().requires_grad_(True)
        term = t3 * s.background(o3, d3).to(torch.float32) * miss_f[:, None]
        go, gd, gt = torch.autograd.grad(term, (o3, d3, t3),
                                         grad_outputs=ct12[6:9].T,
                                         allow_unused=True)
    for sl, gb in ((slice(0, 3), go), (slice(3, 6), gd)):
        if gb is not None:
            g_comps[sl] += gb.T
    g_thr += gt.T
    return g_scene, g_comps, g_thr


def assemble_scene_grads(scene, g_p0, g_e1, g_e2, g_mv0, g_mv1, g_mparam,
                         g_tc0, g_tc1):
    """Scene-shaped gradient (the ``partition`` params structure): the
    computed leaves in place (``g_mv0``/``g_mv1`` None without motion),
    zeros for the other float leaves, None for the integer tables."""
    g = map_scene(lambda x: torch.zeros_like(x)
                  if x.is_floating_point() else None, scene)
    rep = dataclasses.replace
    mv = {k: v for k, v in (("mv0", g_mv0), ("mv1", g_mv1)) if v is not None}
    return rep(g,
               prims=rep(g.prims, p0=g_p0, e1=g_e1, e2=g_e2, **mv),
               materials=rep(g.materials, param=g_mparam),
               textures=rep(g.textures, c0=g_tc0, c1=g_tc1))
