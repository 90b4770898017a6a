"""Packed primitive table and the flat nearest-hit scan
(``raytrace_tpu/ops/pallas/intersect_kernel.py``: ``pack_prims``,
``_prim_loop_flat``, ``pallas_nearest_record``).

:func:`prim_loop_plain` is the plain PyTorch version of the scan; its
device counterpart is ``csrc/prim_loop.cuh``, which the render kernels
include.  The TPU kernel's clustered, segmented and two-level loops
(block-consensus AABB skipping) have no counterpart: a thread walks every
row of the table and a pad row is skipped by its kind.  Mesh-scale tables
take a BVH walk instead (``ops/allpairs_kernel.py``), over the same
per-row test.  :func:`pallas_nearest_record` (kernel K8,
``csrc/nearest_flat_kernel.cu``) is the scan on its own: the nearest hit
record of the split path for small and unsegmented tables.

Table columns ([C, 36] f32):

  0-2   p0 (sphere center / plane corner q / box lo)
  3     sphere radius^2 (signed radius in col 30)
  4-6   unit plane normal n
  7-9   w_a = cross(v, n_s) (box rows: the hi corner)
  10-12 w_b = cross(n_s, u)
  13-15 q.n, q.w_a, q.w_b
  16    kind (-1 pad / 0 sphere / 1 parallelogram / 2 triangle / 3 box)
  17    material (or behaviour) id
  18-23 triangle corner uvs
  24-26 motion displacement at time 0
  27-29 motion delta (mv1 - mv0)
  30    sphere radius (signed)
  31-33 per-prim albedo, 34 per-prim param (behaviour-collapsed packing)
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.vecmath import vcross
from ..scene.types import PRIM_BOX, PRIM_SPHERE, Primitives

N_COLS = 36
MAX_SMEM_PRIMS = 512      # rows a kernel block stages in shared memory
MAX_DENSE_PRIMS = 65536

_F = np.float32
_INF = float("inf")


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def pack_prims(prims: Primitives, mat_override=None, albedo=None,
               param=None) -> torch.Tensor:
    """[C, 36] f32 table (see the module docstring).  ``mat_override``,
    ``albedo`` and ``param`` fill the behaviour-collapsed material columns."""
    kind = prims.kind
    p0, e1, e2 = prims.p0, prims.e1, prims.e2
    c = kind.shape[0]
    dev = p0.device

    cp = vcross(e1, e2)
    cp_sq_raw = _dot(cp, cp)
    degen = cp_sq_raw < 1e-24
    cp = torch.where(degen[:, None],
                     torch.tensor([0.0, 0.0, 1.0], device=dev), cp)
    cp_sq = torch.where(degen, 1.0, cp_sq_raw)
    n_unit = cp * (1.0 / torch.sqrt(cp_sq))[:, None]
    n_s = cp / cp_sq[:, None]
    w_a = vcross(e2, n_s)
    w_b = vcross(n_s, e1)
    # degenerate planes can never hit: encode as pad (boxes and spheres
    # have e2 = 0 by construction and are exempt)
    is_box = kind == PRIM_BOX
    kind_f = torch.where(degen & (kind != PRIM_SPHERE) & ~is_box,
                         -1.0, kind.to(torch.float32))

    tbl = torch.zeros((c, N_COLS), dtype=torch.float32, device=dev)
    tbl[:, 0:3] = p0
    tbl[:, 3] = e1[:, 0] * e1[:, 0]
    tbl[:, 4:7] = n_unit
    tbl[:, 7:10] = torch.where(is_box[:, None], e1, w_a)
    tbl[:, 10:13] = w_b
    tbl[:, 13] = _dot(p0, n_unit)
    tbl[:, 14] = _dot(p0, w_a)
    tbl[:, 15] = _dot(p0, w_b)
    tbl[:, 16] = kind_f
    mat = prims.mat if mat_override is None else mat_override
    tbl[:, 17] = mat.to(torch.float32)
    tbl[:, 18:24] = prims.uvs.reshape(c, 6)
    tbl[:, 24:27] = prims.mv0
    tbl[:, 27:30] = prims.mv1 - prims.mv0
    tbl[:, 30] = e1[:, 0]
    if albedo is not None:
        tbl[:, 31:34] = albedo
    if param is not None:
        tbl[:, 34] = param
    return tbl


def _safe(d):
    """Directions with |d| < 1e-20 pushed to +-1e-20 (slab reciprocals)."""
    return torch.where(torch.abs(d) < 1e-20,
                       torch.where(d < 0, -1e-20, 1e-20), d)


def _box_attrs(lox, loy, loz, hix, hiy, hiz, hx, hy, hz, dx, dy, dz):
    """Box record from the hit point: outward-face normal, front flag and
    the per-face uv of the six-parallelogram lowering."""
    szx = torch.clamp(hix - lox, min=1e-12)
    szy = torch.clamp(hiy - loy, min=1e-12)
    szz = torch.clamp(hiz - loz, min=1e-12)
    relx = (hx - 0.5 * (lox + hix)) / szx
    rely = (hy - 0.5 * (loy + hiy)) / szy
    relz = (hz - 0.5 * (loz + hiz)) / szz
    ax, ay, az = torch.abs(relx), torch.abs(rely), torch.abs(relz)
    on_x = (ax >= ay) & (ax >= az)
    on_y = ~on_x & (ay >= az)
    on_z = ~on_x & ~on_y
    sgn = lambda r: torch.where(r >= 0.0, 1.0, -1.0)
    nx = torch.where(on_x, sgn(relx), 0.0)
    ny = torch.where(on_y, sgn(rely), 0.0)
    nz = torch.where(on_z, sgn(relz), 0.0)
    front = torch.where(dx * nx + dy * ny + dz * nz < 0.0, 1.0, 0.0)
    fx = (hx - lox) / szx
    fy = (hy - loy) / szy
    fz = (hz - loz) / szz
    uu = torch.where(on_z, torch.where(relz >= 0.0, fx, 1.0 - fx),
                     torch.where(on_x, torch.where(relx >= 0.0, 1.0 - fz, fz),
                                 fx))
    vv = torch.where(on_y, torch.where(rely >= 0.0, 1.0 - fz, fz), fy)
    return nx, ny, nz, front, uu, vv


def _lane_tensor(x, like):
    """A per-row scalar, or a lane tensor when motion made it per lane."""
    return x if isinstance(x, torch.Tensor) else torch.full_like(like, x)


def prim_loop_plain(tbl: torch.Tensor, ox, oy, oz, dx, dy, dz, tm, *,
                    n_prims: int, t_min: float, has_motion: bool,
                    with_albedo: bool = False):
    """Nearest hit of every lane over rows ``[0, n_prims)`` of the packed
    table.  Returns ``(t, idx, nx, ny, nz, front, u, v, mat, sphere)`` as
    f32 lane tensors (+ the winner's albedo r, g, b and param with
    ``with_albedo``): the normal faces the ray, ``idx`` is -1 on a miss,
    sphere uv is not computed yet.  Ties go to the lowest row.

    Each row runs only the branch of its kind (the kind is uniform over
    the lanes); a row of any other kind would give +inf there, so this is
    the TPU kernel's branchless min over all branches."""
    rows = tbl[:n_prims].tolist()
    t_min = float(_F(t_min))
    z = torch.zeros_like(ox)
    bt = torch.full_like(ox, _INF)
    bi = torch.full_like(ox, -1.0)
    cnx, cny, cnz = z, z, torch.ones_like(ox)
    cfr, cu, cv, cm = z, z, z, z
    csp = torch.ones_like(ox)
    alb = [z, z, z, z]
    if any(r[16] == PRIM_BOX for r in rows):
        inv_dx, inv_dy, inv_dz = 1.0 / _safe(dx), 1.0 / _safe(dy), \
            1.0 / _safe(dz)

    for ci, row in enumerate(rows):
        kind = int(row[16])
        if kind not in (0, 1, 2, 3):
            continue
        px, py, pz = row[0], row[1], row[2]
        if has_motion:
            sx = row[24] + tm * row[27]
            sy = row[25] + tm * row[28]
            sz = row[26] + tm * row[29]
            px = px + sx
            py = py + sy
            pz = pz + sz
        if kind == 0:
            # sphere: two roots against the open interval
            r2 = row[3]
            ocx = px - ox
            ocy = py - oy
            ocz = pz - oz
            h = dx * ocx + dy * ocy + dz * ocz
            cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2
            disc = h * h - cterm
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            r1 = h - sq
            rr2 = h + sq
            cand = torch.where(r1 > t_min, r1,
                               torch.where(rr2 > t_min, rr2, _INF))
            cand = torch.where(disc >= 0.0, cand, _INF)
            inv_r = float(_F(1.0) / np.sqrt(np.maximum(_F(r2), _F(1e-30)))
                          * np.sign(_F(row[30])))
            nx_c = (ox + cand * dx - px) * inv_r
            ny_c = (oy + cand * dy - py) * inv_r
            nz_c = (oz + cand * dz - pz) * inv_r
            fr_c = torch.where(cand <= h, 1.0, 0.0)
            uu = vv = z
        elif kind in (1, 2):
            # parallelogram / triangle: scalar triple products
            nxs, nys, nzs = row[4], row[5], row[6]
            den = dx * nxs + dy * nys + dz * nzs
            den_ok = torch.abs(den) > 1e-8
            den_safe = torch.where(den_ok, den, 1.0)
            on = ox * nxs + oy * nys + oz * nzs
            qn, qwa, qwb = row[13], row[14], row[15]
            wax, way, waz = row[7], row[8], row[9]
            wbx, wby, wbz = row[10], row[11], row[12]
            if has_motion:
                qn = qn + sx * nxs + sy * nys + sz * nzs
                qwa = qwa + sx * wax + sy * way + sz * waz
                qwb = qwb + sx * wbx + sy * wby + sz * wbz
            t_p = (qn - on) / den_safe
            owa = ox * wax + oy * way + oz * waz
            dwa = dx * wax + dy * way + dz * waz
            owb = ox * wbx + oy * wby + oz * wbz
            dwb = dx * wbx + dy * wby + dz * wbz
            a = owa - qwa + t_p * dwa
            b = owb - qwb + t_p * dwb
            bound = a + b if kind == 2 else torch.maximum(a, b)
            ok = den_ok & (a >= 0.0) & (b >= 0.0) & (bound <= 1.0) \
                & (t_p > t_min)
            cand = torch.where(ok, t_p, _INF)
            nx_c, ny_c, nz_c = (_lane_tensor(nxs, ox), _lane_tensor(nys, ox),
                                _lane_tensor(nzs, ox))
            fr_c = torch.where(den < 0.0, 1.0, 0.0)
            if kind == 2:
                w0 = 1.0 - a - b
                uu = w0 * row[18] + a * row[20] + b * row[22]
                vv = w0 * row[19] + a * row[21] + b * row[23]
            else:
                uu, vv = a, b
        else:
            # axis-aligned box: slab test
            hix, hiy, hiz = row[7], row[8], row[9]
            if has_motion:
                hix = hix + sx
                hiy = hiy + sy
                hiz = hiz + sz
            bx0 = (px - ox) * inv_dx
            bx1 = (hix - ox) * inv_dx
            by0 = (py - oy) * inv_dy
            by1 = (hiy - oy) * inv_dy
            bz0 = (pz - oz) * inv_dz
            bz1 = (hiz - oz) * inv_dz
            btn = torch.maximum(torch.maximum(torch.minimum(bx0, bx1),
                                              torch.minimum(by0, by1)),
                                torch.minimum(bz0, bz1))
            btf = torch.minimum(torch.minimum(torch.maximum(bx0, bx1),
                                              torch.maximum(by0, by1)),
                                torch.maximum(bz0, bz1))
            cand = torch.where(btn > t_min, btn,
                               torch.where(btf > t_min, btf, _INF))
            cand = torch.where(btn <= btf, cand, _INF)
            t_hit = torch.where(cand < _INF, cand, 1.0)
            nx_c, ny_c, nz_c, fr_c, uu, vv = _box_attrs(
                _lane_tensor(px, ox), _lane_tensor(py, ox),
                _lane_tensor(pz, ox), _lane_tensor(hix, ox),
                _lane_tensor(hiy, ox), _lane_tensor(hiz, ox),
                ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz,
                dx, dy, dz)

        better = cand < bt
        bt = torch.where(better, cand, bt)
        bi = torch.where(better, float(ci), bi)
        cnx = torch.where(better, nx_c, cnx)
        cny = torch.where(better, ny_c, cny)
        cnz = torch.where(better, nz_c, cnz)
        cfr = torch.where(better, fr_c, cfr)
        cu = torch.where(better, uu, cu)
        cv = torch.where(better, vv, cv)
        cm = torch.where(better, row[17], cm)
        csp = torch.where(better, 1.0 if kind == 0 else 0.0, csp)
        if with_albedo:
            alb = [torch.where(better, row[31 + k], alb[k])
                   for k in range(4)]

    flip = torch.where(cfr > 0.5, 1.0, -1.0)
    out = (bt, bi, cnx * flip, cny * flip, cnz * flip, cfr, cu, cv, cm, csp)
    return out + tuple(alb) if with_albedo else out


def _record_contract(hit):
    """The 9 outputs of the TPU nearest-hit kernels from a
    ``prim_loop_plain``-format record: t, idx (i32, -1 on a miss), nx, ny,
    nz (hit side), front | sphere << 1 (i32), u, v, mat (i32)."""
    t, bi, nx, ny, nz, fr, uu, vv, mat, sph = hit[:10]
    flags = (fr > 0.5).to(torch.int32) + 2 * (sph > 0.5).to(torch.int32)
    return (t, bi.to(torch.int32), nx, ny, nz, flags, uu, vv,
            mat.to(torch.int32))


def pallas_nearest_plain(tbl, ox, oy, oz, dx, dy, dz, tm, *, n_prims: int,
                         t_min: float, has_motion: bool):
    """:func:`pallas_nearest_record` in plain PyTorch, on any device."""
    return _record_contract(prim_loop_plain(
        tbl, ox, oy, oz, dx, dy, dz, tm, n_prims=n_prims, t_min=t_min,
        has_motion=has_motion))


class _FlatArgs(ctypes.Structure):
    """Mirror of ``FlatArgs`` in csrc/nearest_flat_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "tbl", "ox", "oy", "oz", "dx", "dy", "dz", "tm", "outf", "outi")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in ("n_prims", "has_motion")]
        + [("t_min", ctypes.c_float)])


def pallas_nearest_record(tbl, ox, oy, oz, dx, dy, dz, tm, *, n_prims: int,
                          t_min: float, has_motion: bool):
    """Nearest hit of every ray over rows ``[0, n_prims)`` of the packed
    table by a flat scan (kernel K8; the JAX package's name).  Rays are
    1-D [R] f32 tensors.  Returns the 9 [R] outputs of
    :func:`_record_contract`, as ``allpairs_nearest_record`` does.

    CPU tensors run :func:`pallas_nearest_plain`; CUDA tensors launch
    ``csrc/nearest_flat_kernel.cu`` (``pallas_nearest_record.launches``
    counts the launches)."""
    from .bounce_kernel import check_lanes
    rays = (ox, oy, oz, dx, dy, dz, tm)
    dev = ox.device
    if dev.type == "cpu":
        return pallas_nearest_plain(tbl, *rays, n_prims=n_prims,
                                    t_min=t_min, has_motion=has_motion)
    if dev.type != "cuda":
        raise ValueError(f"pallas_nearest_record: unsupported device {dev}")
    r = ox.shape[0]
    if (tbl.device != dev or tbl.dtype != torch.float32 or tbl.dim() != 2
            or tbl.shape[1] != N_COLS or tbl.shape[0] < n_prims
            or not tbl.is_contiguous()):
        raise ValueError(f"tbl: need a contiguous f32 [>={n_prims}, "
                         f"{N_COLS}] tensor on {dev}")
    if not 0 < n_prims <= MAX_DENSE_PRIMS:
        raise ValueError(f"n_prims={n_prims} outside 1..{MAX_DENSE_PRIMS}")
    check_lanes(zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), rays), r,
                dev)
    from ._build import launch
    outf = torch.empty((6, r), dtype=torch.float32, device=dev)
    outi = torch.empty((3, r), dtype=torch.int32, device=dev)
    args = _FlatArgs(*(x.data_ptr() for x in (tbl,) + rays + (outf, outi)),
                     r, n_prims, int(has_motion), float(t_min))
    launch("rt_nearest_flat", args, dev)
    pallas_nearest_record.launches += 1
    return (outf[0], outi[0], outf[1], outf[2], outf[3], outi[1], outf[4],
            outf[5], outi[2])


pallas_nearest_record.launches = 0
