"""A plain path tracer: each (pixel, sample) path traced on its own, one
bounce at a time, in torch with no kernel and no lane pool.

The estimator, as the renderer specifies it: a camera ray from the
sample's key at depth 0 (thin lens, jitter inside the pixel); at each
depth the nearest hit over every row (ties to the lowest row); a light
adds its colour times the throughput and ends the path; a miss adds the
background and ends it; lambertian surfaces scatter to a cosine
direction or, with the redirect targets' probability, toward a point on
a target, weighted by the cosine pdf over the mixture pdf; mirror, metal
(fuzz) and dielectric (Schlick) scatter specularly; the path ends at
``max_depth`` segments; Russian roulette from ``rr_depth`` keeps a path
with probability ``clamp(max(throughput), rr_min, 1)`` and divides its
throughput by it.  Draw columns of depth ``k``: 0-1 fuzz, 2 Schlick, 3-4
diffuse, 5 target choice, 6-7 target point, ``n_u`` .. ``n_u + 4`` the
camera, ``n_u + 5`` the roulette.

The arithmetic is written in the float32 association the specification
fixes, so that the same path meets the same surfaces.  With ``diff``
the hits and shading carry gradients to the rows' ``p0``, ``e1``,
``e2`` and the materials' colours: the sampled directions, the mixture
pdf and the roulette's probability are sampling decisions and carry
none; the hit distance and the sphere normal take their values from the
nearest-hit test and their gradients from the winner row's own
equations.  ``dtype`` sets the precision of every float (the control
runs it below float32).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import rng
from .scene import (
    DIELECTRIC, LAMBERTIAN, LIGHT, METAL, MIRROR, PARALLELOGRAM, SPHERE,
    View, World,
)

INF = float("inf")
N_U = 8


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _rows(x):
    """[R, 3] -> three [R] columns."""
    return x[:, 0], x[:, 1], x[:, 2]


@dataclasses.dataclass
class Tables:
    """The world's rows with the plane constants of the nearest-hit test
    (unit normal, the edge duals ``w_a``, ``w_b`` and the corner's
    projections), the material of each row, on one device and in one
    dtype.  ``p0``, ``e1``, ``e2`` and ``c0`` are the leaves gradients
    reach."""
    kind: torch.Tensor
    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    c0: torch.Tensor
    mat: torch.Tensor
    mkind: torch.Tensor
    param: torch.Tensor
    n: tuple
    wa: tuple
    wb: tuple
    qn: torch.Tensor
    qwa: torch.Tensor
    qwb: torch.Tensor
    r2: torch.Tensor
    inv_r: torch.Tensor


def tables(world: World, device, dtype=torch.float32, leaves=None) -> Tables:
    """``leaves``: ``(p0, e1, e2, c0)`` to use in place of the world's
    (tensors that carry gradients, or an optimizer's parameters)."""
    cast = lambda x: x.to(device=device, dtype=dtype)
    p0, e1, e2, c0 = leaves if leaves is not None else (
        cast(world.p0), cast(world.e1), cast(world.e2), cast(world.c0))
    with torch.no_grad():
        a, b, c = _rows(e1), _rows(e2), _rows(p0)
        cp = _cross(a, b)
        cp_sq = _dot(cp, cp)
        degen = cp_sq < 1e-24
        one = torch.ones_like(cp_sq)
        cp = (torch.where(degen, 0.0 * one, cp[0]),
              torch.where(degen, 0.0 * one, cp[1]),
              torch.where(degen, one, cp[2]))
        cp_sq = torch.where(degen, one, cp_sq)
        inv = 1.0 / torch.sqrt(cp_sq)
        n = tuple(x * inv for x in cp)
        ns = tuple(x / cp_sq for x in cp)
        wa, wb = _cross(b, ns), _cross(ns, a)
        r2 = e1[:, 0] * e1[:, 0]
        inv_r = (1.0 / torch.sqrt(torch.clamp(r2, min=1e-30))
                 * torch.sign(e1[:, 0]))
        qn, qwa, qwb = _dot(c, n), _dot(c, wa), _dot(c, wb)
    return Tables(kind=world.kind.to(device), p0=p0, e1=e1, e2=e2, c0=c0,
                  mat=world.mat.to(device), mkind=world.mkind.to(device),
                  param=cast(world.param), n=n, wa=wa, wb=wb, qn=qn,
                  qwa=qwa, qwb=qwb, r2=r2, inv_r=inv_r)


def _nearest(tb: Tables, o, d, t_min: float):
    """Nearest hit of each ray over every row: ``(t, row)``, ``t`` inf
    on a miss.  Rows broadcast along dim 1."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    sph = tb.kind == SPHERE
    par = tb.kind == PARALLELOGRAM
    # planes
    nx, ny, nz = tb.n
    den = dx * nx + dy * ny + dz * nz
    den_ok = torch.abs(den) > 1e-8
    den_s = torch.where(den_ok, den, 1.0)
    on = ox * nx + oy * ny + oz * nz
    t_p = (tb.qn - on) / den_s
    a = ox * tb.wa[0] + oy * tb.wa[1] + oz * tb.wa[2] - tb.qwa \
        + t_p * (dx * tb.wa[0] + dy * tb.wa[1] + dz * tb.wa[2])
    b = ox * tb.wb[0] + oy * tb.wb[1] + oz * tb.wb[2] - tb.qwb \
        + t_p * (dx * tb.wb[0] + dy * tb.wb[1] + dz * tb.wb[2])
    ok = den_ok & (a >= 0.0) & (b >= 0.0) & (torch.maximum(a, b) <= 1.0) \
        & (t_p > t_min) & par
    cand = torch.where(ok, t_p, INF)
    # spheres
    px, py, pz = _rows(tb.p0.detach())
    ocx, ocy, ocz = px - ox, py - oy, pz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    disc = h * h - (ocx * ocx + ocy * ocy + ocz * ocz - tb.r2)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1, rr2 = h - sq, h + sq
    cs = torch.where(r1 > t_min, r1, torch.where(rr2 > t_min, rr2, INF))
    cs = torch.where((disc >= 0.0) & sph, cs, INF)
    cand = torch.where(sph, cs, cand)
    t, row = torch.min(cand, dim=1)
    return t, row


def _nearest_blocked(tb: Tables, o, d, t_min: float, block: int):
    if o[0].shape[0] <= block:
        return _nearest(tb, o, d, t_min)
    outs = [_nearest(tb, tuple(x[i:i + block] for x in o),
                     tuple(x[i:i + block] for x in d), t_min)
            for i in range(0, o[0].shape[0], block)]
    return torch.cat([x[0] for x in outs]), torch.cat([x[1] for x in outs])


def _unit(u, v):
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * v
    return r * torch.cos(phi), r * torch.sin(phi), z


def _rsqrt3(x, y, z):
    return 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))


def _target_consts(t):
    """Per-target float32 scalars of the mixture pdf: unit normal, q.n,
    the edge duals."""
    prob, q, u, v, cdf = t
    f = np.float32
    cp = (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
          u[0] * v[1] - u[1] * v[0])
    inv_cp = f(1.0) / np.maximum(cp[0] * cp[0] + cp[1] * cp[1]
                                 + cp[2] * cp[2], f(1e-30))
    s = np.sqrt(inv_cp)
    nt = (cp[0] * s, cp[1] * s, cp[2] * s)
    qn = q[0] * nt[0] + q[1] * nt[1] + q[2] * nt[2]
    ns = (cp[0] * inv_cp, cp[1] * inv_cp, cp[2] * inv_cp)
    wa = (v[1] * ns[2] - v[2] * ns[1], v[2] * ns[0] - v[0] * ns[2],
          v[0] * ns[1] - v[1] * ns[0])
    wb = (ns[1] * u[2] - ns[2] * u[1], ns[2] * u[0] - ns[0] * u[2],
          ns[0] * u[1] - ns[1] * u[0])
    fl = lambda xs: tuple(float(x) for x in xs)
    return dict(prob=float(prob), q=fl(q), u=fl(u), v=fl(v), cdf=float(cdf),
                cp=fl(cp), nt=fl(nt), qn=float(qn), wa=fl(wa), wb=fl(wb))


def camera_rays(view: View, pix, u5):
    """Primary rays of pixels ``pix`` from the camera draws ``u5``."""
    c = view.cam
    i = (pix % view.width).to(u5.dtype)
    j = torch.div(pix, view.width, rounding_mode="floor").to(u5.dtype)
    r = torch.sqrt(u5[0])
    th = (2.0 * math.pi) * u5[1]
    da = r * torch.cos(th) * c[18]
    db = r * torch.sin(th) * c[18]
    ii, jj = i + u5[2], j + u5[3]
    o, d = [], []
    for k in range(3):
        ok = c[k] + da * c[12 + k] + db * c[15 + k]
        o.append(ok)
        d.append(c[3 + k] + ii * c[6 + k] + jj * c[9 + k] - ok)
    inv = 1.0 / torch.sqrt(torch.clamp(d[0] * d[0] + d[1] * d[1]
                                       + d[2] * d[2], min=1e-24))
    return tuple(o), (d[0] * inv, d[1] * inv, d[2] * inv)


def _plane_normal(e1c, e2c):
    """Unit normal ``e1 x e2`` (a fixed unit vector where the edges are
    degenerate, as sphere rows are)."""
    cp = _cross(e1c, e2c)
    cp_sq = _dot(cp, cp)
    degen = cp_sq < 1e-24
    cp = (torch.where(degen, 0.0, cp[0]), torch.where(degen, 0.0, cp[1]),
          torch.where(degen, 1.0, cp[2]))
    inv = 1.0 / torch.sqrt(torch.where(degen, 1.0, cp_sq))
    return tuple(x * inv for x in cp)


def _winner_hit(tb: Tables, o, d, t, row, diff: bool):
    """Hit point, normal facing the ray, front flag of each ray's winner
    row; with ``diff`` they carry gradients to the row (and to ``o``).
    ``t`` is the nearest-hit test's distance (finite)."""
    p0 = tb.p0.index_select(0, row)
    e1 = tb.e1.index_select(0, row)
    e2 = tb.e2.index_select(0, row)
    sph = tb.kind.index_select(0, row) == SPHERE
    p0c, e1c, e2c = _rows(p0), _rows(e1), _rows(e2)
    if diff:
        # the winner's own equations, their values replaced by the test's
        nu = _plane_normal(e1c, e2c)
        den = _dot(nu, d)
        den_s = torch.where(torch.abs(den) > 1e-8, den, 1.0)
        rel = tuple(p - x for p, x in zip(p0c, o))
        t_pl = _dot(nu, rel) / den_s
        h = _dot(d, rel)
        disc = h * h - (_dot(rel, rel) - e1c[0] * e1c[0])
        sq = torch.sqrt(torch.where(disc >= 0.0,
                                    torch.clamp(disc, min=1e-20), 1.0))
        t_sp = torch.where(t <= h, h - sq, h + sq)
        t_d = torch.where(sph, t_sp, t_pl)
        t = t_d + (t - t_d).detach()
    p = tuple(x + t * y for x, y in zip(o, d))
    # sphere: outward normal from the centre; plane: the unit normal
    with torch.no_grad():
        inv_r = tb.inv_r.index_select(0, row)
        n_sph = tuple((x - c) * inv_r for x, c in zip(p, p0c))
        n_pl = tuple(tb.n[k].index_select(0, row) for k in range(3))
        h0 = _dot(d, tuple(c - x for c, x in zip(p0c, o)))
        front = torch.where(sph, t <= h0, _dot(d, n_pl) < 0.0)
    if diff:
        radius = torch.where(torch.abs(e1c[0]) > 0, e1c[0], 1.0)
        n_sph_d = tuple((x - c) / radius for x, c in zip(p, p0c))
        n_out = tuple(torch.where(sph, a + (b - a).detach(), c)
                      for a, b, c in zip(n_sph_d, n_sph, nu))
    else:
        n_out = tuple(torch.where(sph, a, b) for a, b in zip(n_sph, n_pl))
    flip = torch.where(front, 1.0, -1.0).to(t.dtype)
    return p, tuple(x * flip for x in n_out), front


def trace(tb: Tables, view: View, key, pix, smp, *, diff: bool = False,
          dtype=torch.float32, block: int = 1 << 15):
    """Trace the paths ``(pix[N], smp[N])`` under the base key ``key``
    (two int32 words).  Returns ``(radiance [N, 3], segments [N])``:
    each path's radiance and its count of segments (bounces, the last
    one included)."""
    dev = pix.device
    n = pix.shape[0]
    keys = rng.ray_keys(key.to(dev), pix, smp)
    rad = torch.zeros((n, 3), dtype=dtype, device=dev)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    tcs = [_target_consts(t) for t in view.targets]
    cdf_last = tcs[-1]["cdf"] if tcs else 0.0
    o = d = thr = None
    for depth in range(view.max_depth):
        if live.numel() == 0:
            break
        us = rng.uniform_cols(rng.mix_depth(keys[live], depth),
                              N_U + 6).to(dtype)
        if depth == 0:
            o, d = camera_rays(view, pix, us[N_U:N_U + 5])
            thr = tuple(torch.ones((n,), dtype=dtype, device=dev)
                        for _ in range(3))
        segs = segs.index_add(0, live, torch.ones_like(live))
        with torch.no_grad():
            t, row = _nearest_blocked(tb, tuple(x.detach() for x in o),
                                      tuple(x.detach() for x in d),
                                      view.t_min, block)
        hit = t < INF
        # misses: the background, then the path ends
        miss = ~hit
        if view.sky:
            a_s = 0.5 * (d[1] + 1.0)
            bg = ((1.0 - a_s) * 1.0 + a_s * 0.5, (1.0 - a_s) * 1.0 + a_s * 0.7,
                  (1.0 - a_s) * 1.0 + a_s * 1.0)
        else:
            bg = view.bg
        mf = torch.where(miss, 1.0, 0.0).to(dtype)
        # hits
        row = torch.where(hit, row, 0)
        t = torch.where(hit, t, 1.0)
        p, nrm, front = _winner_hit(tb, o, d, t, row, diff)
        mat = tb.mat.index_select(0, row)
        kind = tb.mkind.index_select(0, mat)
        param = tb.param.index_select(0, mat)
        alb = tb.c0.index_select(0, mat)
        alb = (alb[:, 0], alb[:, 1], alb[:, 2])
        ef = torch.where(hit & (kind == LIGHT), 1.0, 0.0).to(dtype)
        emit = tuple(tr * a * ef for tr, a in zip(thr, alb))
        add = tuple(e + mf * tr * b for e, tr, b in zip(emit, thr, bg))
        rad = rad.index_add(0, live, torch.stack(add, dim=1))

        # specular family
        nx, ny, nz = nrm
        dx, dy, dz = d
        ddn = dx * nx + dy * ny + dz * nz
        rf = (dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, dz - 2.0 * ddn * nz)
        fz = _unit(us[0], us[1])
        m = tuple(r + param * f for r, f in zip(rf, fz))
        metal_ok = (m[0] * nx + m[1] * ny + m[2] * nz) > 0.0
        inv = _rsqrt3(*m)
        m = tuple(x * inv for x in m)
        ior = torch.clamp(param, min=1e-6)
        ir = torch.where(front, 1.0 / ior, ior)
        cos_t = torch.clamp(-ddn, max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot = ir * sin_t > 1.0
        r0 = (1.0 - ir) / (1.0 + ir)
        r0 = r0 * r0
        one_c = 1.0 - cos_t
        oc2 = one_c * one_c
        schlick = r0 + (1.0 - r0) * (oc2 * oc2 * one_c)
        refl = cannot | (us[2] < schlick)
        q = (ir * (dx + cos_t * nx), ir * (dy + cos_t * ny),
             ir * (dz + cos_t * nz))
        par = torch.sqrt(torch.clamp(torch.abs(
            1.0 - (q[0] * q[0] + q[1] * q[1] + q[2] * q[2])), min=1e-12))
        di_r = torch.where(refl, 1.0, 0.0).to(dtype)
        di = tuple(di_r * r + (1.0 - di_r) * (qq - par * nn)
                   for r, qq, nn in zip(rf, q, nrm))
        is_metal, is_diel = kind == METAL, kind == DIELECTRIC
        is_mirror, is_hemi = kind == MIRROR, kind == LAMBERTIAN
        spec = tuple(torch.where(is_diel, a, torch.where(
            is_metal, b, torch.where(is_mirror, c, e)))
            for a, b, c, e in zip(di, m, rf, d))
        s_alb = tuple(torch.where(is_diel, 1.0, a) for a in alb)

        # lambertian: cosine or target direction, sampled without
        # gradient; the cosine pdf over the mixture pdf
        with torch.no_grad():
            nd = tuple(x.detach() for x in nrm)
            pd = tuple(x.detach() for x in p)
            ux = _unit(us[3], us[4])
            cd = tuple(a + b for a, b in zip(nd, ux))
            inv = _rsqrt3(*cd)
            bdir = tuple(x * inv for x in cd)
            if tcs:
                use_t = us[5] < cdf_last
                lq = [torch.zeros_like(us[5]) for _ in range(9)]
                chosen = torch.zeros_like(use_t)
                for tc in tcs:
                    pick = (us[5] < tc["cdf"]) & ~chosen
                    chosen = chosen | pick
                    vals = tc["q"] + tc["u"] + tc["v"]
                    lq = [torch.where(pick, vals[k], lq[k]) for k in range(9)]
                tg = tuple(lq[k] + us[6] * lq[3 + k] + us[7] * lq[6 + k]
                           - pd[k] for k in range(3))
                inv = _rsqrt3(*tg)
                use_f = torch.where(use_t, 1.0, 0.0).to(dtype)
                bdir = tuple(use_f * (g * inv) + (1.0 - use_f) * b
                             for g, b in zip(tg, bdir))
        mu1 = bdir[0] * nx + bdir[1] * ny + bdir[2] * nz
        pdf_base = mu1 * (1.0 / math.pi)
        with torch.no_grad():
            pb = pdf_base.detach()
            if tcs:
                pdf_sum = float(np.float32(1.0) - np.float32(cdf_last)) * pb
                for tc in tcs:
                    nt, qn = tc["nt"], tc["qn"]
                    den = bdir[0] * nt[0] + bdir[1] * nt[1] + bdir[2] * nt[2]
                    den_ok = torch.abs(den) > 1e-8
                    den_s = torch.where(den_ok, den, 1.0)
                    tt = (qn - (pd[0] * nt[0] + pd[1] * nt[1]
                                + pd[2] * nt[2])) / den_s
                    hr = tuple(pd[k] + tt * bdir[k] - tc["q"][k]
                               for k in range(3))
                    aa = hr[0] * tc["wa"][0] + hr[1] * tc["wa"][1] \
                        + hr[2] * tc["wa"][2]
                    bb = hr[0] * tc["wb"][0] + hr[1] * tc["wb"][1] \
                        + hr[2] * tc["wb"][2]
                    ht = (den_ok & (tt > 0.0) & (aa >= 0.0) & (aa <= 1.0)
                          & (bb >= 0.0) & (bb <= 1.0))
                    cross = torch.abs(bdir[0] * tc["cp"][0]
                                      + bdir[1] * tc["cp"][1]
                                      + bdir[2] * tc["cp"][2])
                    pdf_i = torch.where(
                        ht, tt * tt / torch.clamp(cross, min=1e-12), 0.0)
                    pdf_sum = pdf_sum + tc["prob"] * pdf_i
                pdf_mix = torch.clamp(pdf_sum, min=1e-12)
            else:
                pdf_mix = torch.clamp(pb, min=1e-12)
        dw = pdf_base / pdf_mix
        w = tuple(torch.where(is_hemi, a * dw, s) for a, s in zip(alb, s_alb))
        new_d = tuple(torch.where(is_hemi, b, s) for b, s in zip(bdir, spec))
        alive = hit & (kind != LIGHT) & ~(is_metal & ~metal_ok) \
            & ~(is_hemi & (pb <= 0.0))
        thr = tuple(tr * x for tr, x in zip(thr, w))
        if depth + 1 >= view.max_depth:
            break
        if view.rr_depth is not None and depth + 1 >= view.rr_depth:
            with torch.no_grad():
                tmax = torch.maximum(thr[0], torch.maximum(thr[1], thr[2]))
                p_srv = torch.clamp(tmax.detach(), min=view.rr_min, max=1.0)
                kill = us[N_U + 5] >= p_srv
                scale = torch.where(kill, 1.0, 1.0 / p_srv)
            thr = tuple(x * scale for x in thr)
            alive = alive & ~kill
        keep = torch.nonzero(alive).squeeze(1)
        live = live.index_select(0, keep)
        o = tuple(x.index_select(0, keep) for x in p)
        d = tuple(x.index_select(0, keep) for x in new_d)
        thr = tuple(x.index_select(0, keep) for x in thr)
    return rad, segs
