"""The plain reference of a configuration of triangle meshes and
constant-density media (``configs/pawn.json``): each (pixel, sample) path
traced on its own, one segment at a time, in torch with no kernel, no
acceleration structure and no lane pool.  Nothing of the renderer is
imported; the tables' plane constants, the camera and the random stream
come from this package's ``scene``, ``tracer`` and ``rng``.

At each depth, for the path's ray:

* the surface: the nearest triangle over every row by a brute-force scan
  beyond ``t_min`` (ties to the lowest row, rows in the configuration's
  face order), its unit plane normal turned to face the ray;
* each medium: its boundary's first two crossings beyond ``t_min`` (the
  smallest crossing, and the smallest strictly beyond it, over every
  boundary row); the entry is the first crossing where it enters (the
  ray against the outward normal; on a tie the lowest row's flag), else
  ``t_min`` (the ray starts inside), the exit the crossing after the
  entry; the flight is ``-(1 / density) * log(u)`` with the medium's
  draw ``u`` (never a scatter at ``u`` = 0), a scatter where it ends
  before the exit;
* the event is the nearest of the surface and the media's scatters (a
  scatter only where strictly nearer than the surface; the first medium
  on a tie); a miss adds the throughput times the gray fade
  ``(d_y + 1) / 2`` and ends the path;
* a dielectric scatters by Schlick's choice between reflection and
  refraction (as ``tracer.trace``); an isotropic medium scatters into a
  uniform direction on the sphere and multiplies the throughput by its
  colour.

Draw columns of depth ``k``: 0-1 (fuzz, unused here), 2 Schlick, 3-4 the
sphere direction, 5-7 (targets, unused), ``8 + v`` medium ``v``'s flight;
then, at ``n_u = 8 + V``, the camera (``n_u .. n_u + 4``) and the
roulette (unused: no Russian roulette).  The path ends after
``max_depth`` segments.

Departures from the upstream (``Geometry.hs:298-330``, SURVEY C19, C26):
the upstream finds a medium's entry and exit by two successive hits of
its boundary; this reference takes the first two crossings beyond
``t_min`` as above, as the renderer specifies, which agrees with it for
a ray that starts outside and enters.  ``t_min`` is the renderer's
1e-3, where the upstream's is 1e-4.  The upstream's random generator and
draw order are its own; these are the renderer's (``rng``).  Only what
the configurations use is here: triangle meshes, dielectric surfaces,
isotropic media, the gray fade, a pinhole or thin-lens camera.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng, tracer
from . import scene as ref_scene
from .scene import World

INF = float("inf")
TRIANGLE = 2
N_BASE_U = 8
_BACKGROUNDS = ("gray_fade",)


def _triangle_rows(mesh: dict):
    """``(p0, e1, e2)`` [F, 3] float64 of a mesh's faces in face order:
    the first vertex and the edges to the other two."""
    v = np.asarray(mesh["vertices"], np.float64)
    p = v[np.asarray(mesh["faces"], np.int64)]
    return p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]


def _rows_world(rows, mats: list, mkind: list, param: list) -> World:
    """A :class:`scene.World` of triangle rows, for ``tracer.tables``'
    plane constants; ``mats`` one material index a row."""
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    p0, e1, e2 = (np.concatenate([r[k] for r in rows]) for k in range(3))
    return World(kind=torch.full((p0.shape[0],), TRIANGLE, dtype=torch.int32),
                 p0=f32(p0), e1=f32(e1), e2=f32(e2),
                 mat=torch.tensor(mats, dtype=torch.int64),
                 mkind=torch.tensor(mkind, dtype=torch.int32),
                 param=f32(param), c0=f32(np.ones((len(mkind), 3))))


@dataclasses.dataclass
class MediaWorld:
    """The surface rows (a :class:`scene.World`, dielectric materials
    only) and each medium's boundary rows, density and colour."""
    surface: World
    boundaries: list
    density: list
    colour: list


def build_world(config: dict) -> MediaWorld:
    meshes = {k: _triangle_rows(m) for k, m in config["meshes"].items()}
    mats = config["materials"]
    names = [n for n in mats if mats[n]["kind"] != "isotropic"]
    for n in names:
        if mats[n]["kind"] != "dielectric":
            raise ValueError(f"reference: surface material {n!r} of kind "
                             f"{mats[n]['kind']!r} is not in the "
                             "configurations")
    rows, row_mat, bounds, dens, cols = [], [], [], [], []
    for obj in config["objects"]:
        m = mats[obj["material"]]
        if "mesh" in obj:
            r = meshes[obj["mesh"]]
            rows.append(r)
            row_mat += [names.index(obj["material"])] * r[0].shape[0]
        elif "medium" in obj:
            if m["kind"] != "isotropic":
                raise ValueError("reference: only isotropic media")
            r = meshes[obj["medium"]["mesh"]]
            bounds.append(_rows_world([r], [0] * r[0].shape[0], [0], [0.0]))
            dens.append(float(obj["medium"]["density"]))
            cols.append([float(x) for x in np.broadcast_to(
                np.asarray(m["color"], np.float64), 3)])
        else:
            raise ValueError(f"reference: unknown object {sorted(obj)}")
    surface = _rows_world(rows, row_mat, [tracer.DIELECTRIC] * len(names),
                          [mats[n]["ior"] for n in names])
    return MediaWorld(surface=surface, boundaries=bounds, density=dens,
                      colour=cols)


def build_view(config: dict):
    """``scene.build_view`` of the configuration's camera; the background
    (the gray fade, the one this module knows) is this module's."""
    cam = config["camera"]
    if cam["background"] not in _BACKGROUNDS:
        raise ValueError(f"reference: background {cam['background']!r}")
    return ref_scene.build_view(dict(config, camera=dict(
        cam, background="sky")))


@dataclasses.dataclass
class Tables:
    """The surface's and each medium's ``tracer.Tables`` on one device in
    one dtype, the media's ``-1 / density`` and colours."""
    surface: tracer.Tables
    media: list
    neg_inv_density: list
    colour: list


def tables(world: MediaWorld, device, dtype=torch.float32) -> Tables:
    return Tables(
        surface=tracer.tables(world.surface, device, dtype),
        media=[tracer.tables(b, device, dtype) for b in world.boundaries],
        neg_inv_density=[-1.0 / torch.tensor(x, dtype=dtype, device=device)
                         for x in world.density],
        colour=[torch.tensor(c, dtype=dtype, device=device)
                for c in world.colour])


def _triangle_t(tb: tracer.Tables, o, d, t_min: float):
    """``(t [N, F], den [N, F])``: each row's crossing beyond ``t_min``
    (+inf where the ray misses the triangle) and ``d . n``; the
    association of the renderer's triangle test."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
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
    ok = den_ok & (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0) & (t_p > t_min)
    return torch.where(ok, t_p, INF), den


def nearest(tb: tracer.Tables, o, d, t_min: float):
    """Nearest triangle of each ray: ``(t, row)``, ``t`` +inf on a
    miss, ties to the lowest row."""
    t, _ = _triangle_t(tb, o, d, t_min)
    return torch.min(t, dim=1)


def crossings(tb: tracer.Tables, o, d, t_min: float):
    """A closed mesh's first two crossings beyond ``t_min``: ``(t1,
    front1, t2)``, ``front1`` whether the ray enters at ``t1`` (the
    lowest row attaining it), ``t2`` the smallest crossing strictly
    beyond ``t1``; +inf where there is none."""
    t, den = _triangle_t(tb, o, d, t_min)
    t1, row = torch.min(t, dim=1)
    front1 = torch.gather(den, 1, row[:, None])[:, 0] < 0.0
    t2 = torch.where(t > t1[:, None], t, INF).amin(1)
    return t1, front1, t2


def flight(neg_inv_density, t1, front1, t2, t_min: float, u):
    """The medium's scatter candidate (+inf where the ray passes
    through or misses it)."""
    entry = torch.where(front1, t1, t_min)
    exit_t = torch.where(front1, t2, t1)
    has = torch.isfinite(t1) & torch.isfinite(exit_t)
    dist = torch.where(u > 0.0, neg_inv_density * torch.log(
        torch.where(u > 0.0, u, 1.0)), INF)
    return torch.where(has & (dist < exit_t - entry), entry + dist, INF)


def _event(tb: Tables, o, d, us, t_min: float):
    """``(t, row, t_med, medium)`` of one segment: the nearest surface
    (row) and the nearest medium scatter (its index, -1 for none)."""
    t, row = nearest(tb.surface, o, d, t_min)
    t_med = torch.full_like(t, INF)
    med = torch.full_like(row, -1)
    for v, mt in enumerate(tb.media):
        c = flight(tb.neg_inv_density[v], *crossings(mt, o, d, t_min),
                   t_min, us[N_BASE_U + v])
        better = c < t_med
        t_med = torch.where(better, c, t_med)
        med = torch.where(better, v, med)
    return t, row, t_med, med


def _event_blocked(tb: Tables, o, d, us, t_min: float, block: int):
    """:func:`_event` over blocks of ``block`` rays."""
    n = o[0].shape[0]
    outs = [_event(tb, tuple(x[i:i + block] for x in o),
                   tuple(x[i:i + block] for x in d), us[:, i:i + block],
                   t_min) for i in range(0, n, block)]
    return tuple(torch.cat([x[k] for x in outs]) for k in range(4))


def trace(tb: Tables, view, key, pix, smp, *, dtype=torch.float32,
          block: int = 1 << 14):
    """Trace the paths ``(pix[N], smp[N])`` under the base key ``key``.
    Returns ``(radiance [N, 3], segments [N], medium [N])``: each path's
    radiance, its count of segments and of those whose event was a
    scatter in a medium."""
    dev = pix.device
    n = pix.shape[0]
    n_u = N_BASE_U + len(tb.media)
    keys = rng.ray_keys(key.to(dev), pix, smp)
    rad = torch.zeros((n, 3), dtype=dtype, device=dev)
    segs = torch.zeros((n,), dtype=torch.int64, device=dev)
    meds = torch.zeros((n,), dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    s = tb.surface
    o = d = thr = None
    for depth in range(view.max_depth):
        if live.numel() == 0:
            break
        us = rng.uniform_cols(rng.mix_depth(keys[live], depth),
                              n_u + 6).to(dtype)
        if depth == 0:
            o, d = tracer.camera_rays(view, pix, us[n_u:n_u + 5])
            thr = tuple(torch.ones((n,), dtype=dtype, device=dev)
                        for _ in range(3))
        segs = segs.index_add(0, live, torch.ones_like(live))
        t, row, t_med, med = _event_blocked(tb, o, d, us, view.t_min, block)
        in_med = t_med < t
        meds = meds.index_add(0, live, in_med.to(torch.int64))
        t_ev = torch.where(in_med, t_med, t)
        hit = t_ev < INF
        # a miss: the gray fade, then the path ends
        bg = (d[1] + 1.0) * 0.5
        mf = torch.where(hit, 0.0, 1.0).to(dtype)
        rad = rad.index_add(0, live, torch.stack(
            [mf * tr * bg for tr in thr], dim=1))
        t_safe = torch.where(hit, t_ev, 1.0)
        p = tuple(x + t_safe * y for x, y in zip(o, d))
        # the surface's normal facing the ray (the medium's: -d)
        row = torch.where(torch.isfinite(t), row, 0)
        n_pl = tuple(s.n[k].index_select(0, row) for k in range(3))
        front = (d[0] * n_pl[0] + d[1] * n_pl[1] + d[2] * n_pl[2]) < 0.0
        flip = torch.where(front, 1.0, -1.0).to(dtype)
        nrm = tuple(torch.where(in_med, -y, x * flip) for x, y in zip(n_pl, d))
        front = front | in_med
        # the dielectric (as tracer.trace)
        param = s.param.index_select(0, s.mat.index_select(0, row))
        nx, ny, nz = nrm
        dx, dy, dz = d
        ddn = dx * nx + dy * ny + dz * nz
        rf = (dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, dz - 2.0 * ddn * nz)
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
        # the isotropic medium: a uniform direction, the colour
        iso = tracer._unit(us[3], us[4])
        new_d = tuple(torch.where(in_med, a, b) for a, b in zip(iso, di))
        alb = torch.ones((o[0].shape[0], 3), dtype=dtype, device=dev)
        for v, c in enumerate(tb.colour):
            alb = torch.where((in_med & (med == v))[:, None], c, alb)
        thr = tuple(tr * alb[:, k] for k, tr in enumerate(thr))
        if depth + 1 >= view.max_depth:
            break
        keep = torch.nonzero(hit).squeeze(1)
        live = live.index_select(0, keep)
        o = tuple(x.index_select(0, keep) for x in p)
        d = tuple(x.index_select(0, keep) for x in new_d)
        thr = tuple(x.index_select(0, keep) for x in thr)
    return rad, segs, meds
