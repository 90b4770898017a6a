"""The plain reference of demo2's semantics (``configs/demo2.json``):
each (pixel, sample) path traced on its own, one segment at a time, in
torch with no kernel, no acceleration structure and no lane pool.
Nothing of the renderer is imported; the camera, the redirect targets'
constants and the random stream come from this package's ``scene``,
``tracer`` and ``rng``, a medium's flight from ``media``.

The world, from the configuration's data: the cuboids as axis-aligned
boxes (low and high corner), spheres (the cloud's centres through its
transform, baked in float64 as the scene API composes it and rounded to
float32), the light's parallelogram, the earth's sphere with its
world-to-object rotation, each medium's bounding sphere, density and
colour.  At each depth, for the path's ray at its time (the camera's
fifth draw, kept along the path):

* the surface: the nearest row beyond ``t_min`` by a brute-force scan
  of every sphere (the moving one at its centre lerped by the time),
  the light and every box (the slab test; a root at or below ``t_min``
  gives way to the far one), spheres before the light before the boxes
  on a tie; its normal turned to face the ray (a box's the axis of the
  largest relative offset of the hit from the box's centre);
* each medium: its sphere's first two crossings beyond ``t_min`` (the
  near root entering, the far one leaving); the entry is the near root,
  or ``t_min`` where only the far one lies beyond it (the ray starts
  inside: the camera in the fog, a refracted ray in the blue medium),
  the exit the crossing after; the flight ``-(1 / density) log(u)``
  with the medium's draw (never a scatter at ``u`` = 0), a scatter
  where it ends before the exit; the first medium wins a tie;
* the event is the nearest of the surface and the scatters (a scatter
  only where strictly nearer); a miss adds nothing (the black
  background) and ends the path;
* the light adds its colour times the throughput and ends the path;
  lambertian surfaces and the isotropic media scatter to a cosine (a
  uniform sphere) direction or, with the target's probability 0.25,
  toward a point on the light, weighted by the cosine (uniform) pdf over
  the mixture pdf; metal (fuzz 1) reflects and dies below the horizon;
  dielectric by Schlick's choice; a medium event's normal faces the ray;
* the earth's and the marble's albedo multiply the throughput after the
  scatter: the earth's texel at ``i = floor(u w) mod w``, ``j =
  floor((1 - v) h) mod h`` of the sphere uv taken in object space (the
  outward normal through the instance's rotation), the image computed
  from the configuration's formula; the marble's stripe ``0.5 + 0.5
  sin(f (d . p) + 10 turb7(0.25 f p))``.

Draw columns of depth ``k``: 0-1 fuzz, 2 Schlick, 3-4 the diffuse and
isotropic direction, 5 the target choice, 6-7 the target point, ``8 +
v`` medium ``v``'s flight; then at ``n_u = 8 + V`` the camera (its
fifth, ``n_u + 4``, the time) and the roulette (unused).  The path ends
after ``max_depth`` segments.  The float32 association of every test and
of the shading is the one the renderer specifies, so that the same path
meets the same surfaces.

Departures from the upstream (``test/Main.hs:259-321``, SURVEY C19,
C26), and rules taken from the renderer:

* the marble's Perlin turbulence hashes its lattice with the renderer's
  32-bit arithmetic hash (a murmur avalanche of each lattice coordinate
  and of the XOR of three, mapped to a uniform unit gradient), written
  out here; the upstream indexes its fixed permutation tables;
* a medium's entry and exit are its first two crossings beyond
  ``t_min``, where the upstream takes two successive hits of its
  boundary (the same for a ray that starts outside and enters);
* a medium scatter's normal faces the ray, its uv is 0, and it samples
  the redirect mixture as a surface does; the upstream's isotropic
  scatter takes no mixture;
* the sphere uv is ``atan2(x, z) / 2 pi + 0.5`` and ``acos(-y) / pi``
  of the outward (object-space) normal, ``y`` clamped to ``1 - 1e-6``;
* ``t_min`` is the renderer's 1e-3 (the upstream's 1e-4); the random
  generator and draw order are the renderer's (``rng``); the earth is
  the configuration's procedural image, not ``earthmap.jpg``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import media, rng, tracer
from . import scene as ref_scene

INF = float("inf")
N_BASE_U = 8
LIGHT, LAMBERTIAN, METAL, DIELECTRIC, ISOTROPIC = 0, 2, 5, 6, 8
_KINDS = {"light": LIGHT, "lambertian": LAMBERTIAN, "metal": METAL,
          "dielectric": DIELECTRIC, "isotropic": ISOTROPIC}
CONSTANT, IMAGE, MARBLE = 0, 1, 2
_M32 = 0xFFFFFFFF
# the lattice hash's per-axis multipliers
_AXIS_MUL = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)


def earth_image(spec: dict) -> np.ndarray:
    """The configuration's image by its formula, float32 [h, w, 3]."""
    h, w = int(spec["height"]), int(spec["width"])
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    land = (np.sin(u * spec["u_freq"]) * np.cos(v * spec["v_freq"])
            > spec["threshold"]).astype(float)
    return np.stack([b + dl * land for b, dl in zip(spec["base"],
                                                    spec["land_delta"])],
                    axis=-1).astype(np.float32)


@dataclasses.dataclass
class Demo2World:
    """Rows of three kinds in float32 on the CPU, each with a material
    index: spheres (centre, radius; ``moving`` the one moving row and
    its displacement at times 0 and 1; ``rotated`` the rotated row and
    its world-to-object rotation, nine floats), the light (corner,
    edges) and boxes (low, high corners); the materials (kind, param,
    colour, texture: constant, image or marble with its frequency and
    direction), the image; each medium's sphere, density and material."""
    centre: torch.Tensor
    radius: torch.Tensor
    sphere_mat: list
    moving: tuple | None
    rotated: tuple | None
    planes: ref_scene.World
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    box_mat: list
    mkind: list
    param: list
    colour: list
    texture: list
    marble: dict
    image: torch.Tensor
    media: list


def build_world(config: dict) -> Demo2World:
    """The configuration's rows and materials; each object's material a
    row of its own, as the scene script makes them."""
    mats, images = config["materials"], config.get("images", {})
    mkind, param, colour, texture = [], [], [], []
    marble, image = {}, None
    centre, radius, smat, boxes, bmat, planes, med = [], [], [], [], [], [], []
    moving = rotated = None
    for obj in config["objects"]:
        m = mats[obj["material"]]
        mi = len(mkind)
        mkind.append(_KINDS[m["kind"]])
        param.append(m.get("fuzz", m.get("ior", 0.0)))
        c = m.get("color", 1.0)
        colour.append([float(x) for x in np.broadcast_to(
            np.asarray(c, np.float64), 3)])
        if "image" in m:
            texture.append(IMAGE)
            image = earth_image(images[m["image"]])
        elif "marble" in m:
            texture.append(MARBLE)
            marble = m["marble"]
        else:
            texture.append(CONSTANT)
        steps = obj.get("transform", [])
        mtx = ref_scene._matrix(steps)
        a, b = mtx[:3, :3], mtx[:3, 3]
        if "cuboids" in obj:
            c0 = np.asarray(obj["cuboids"]["corner0"], np.float64)
            c1 = np.asarray(obj["cuboids"]["corner1"], np.float64)
            if steps:
                raise ValueError("reference: only axis-aligned cuboids")
            boxes.append((np.minimum(c0, c1), np.maximum(c0, c1)))
            bmat += [mi] * c0.shape[0]
            continue
        if "parallelogram" in obj:
            q, u, v = (np.asarray(x, np.float64) for x in obj["parallelogram"])
            planes.append((q @ a.T + b, u @ a.T, v @ a.T, mi))
            continue
        if "medium" in obj:
            (cm, rm), dens = obj["medium"]["sphere"], obj["medium"]["density"]
            med.append(dict(centre=np.asarray(cm, np.float32),
                            radius=np.float32(rm), density=float(dens),
                            material=mi))
            continue
        if "spheres" in obj:
            cs = np.asarray(obj["spheres"]["centers"], np.float64)
            rs = np.full(cs.shape[0], float(obj["spheres"]["radius"]))
        else:
            cs = np.asarray([obj["sphere"][0]], np.float64)
            rs = np.asarray([float(obj["sphere"][1])])
        # the scene API's bake of a similarity: centres through the
        # affine, radii by its scale, the rotation back to object space
        s2 = np.trace(a.T @ a) / 3.0
        row0 = len(radius)
        centre += list(cs @ a.T + b)
        radius += list(rs * np.sqrt(s2))
        smat += [mi] * cs.shape[0]
        if obj.get("moving"):
            if cs.shape[0] != 1 or moving is not None:
                raise ValueError("reference: one moving sphere")
            moving = (row0, np.asarray(obj["moving"][0], np.float32),
                      np.asarray(obj["moving"][1], np.float32))
        if steps and texture[-1] == IMAGE:
            rotated = (row0, tuple(np.asarray((a.T / np.sqrt(s2)).ravel(),
                                              np.float32).tolist()))
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    (q, u, v, lm), = planes
    light = ref_scene.World(
        kind=torch.tensor([1], dtype=torch.int32), p0=f32([q]),
        e1=f32([u]), e2=f32([v]), mat=torch.tensor([lm]),
        mkind=torch.tensor(mkind, dtype=torch.int32), param=f32(param),
        c0=f32(colour))
    lo = np.concatenate([x[0] for x in boxes])
    hi = np.concatenate([x[1] for x in boxes])
    return Demo2World(
        centre=f32(centre), radius=f32(radius), sphere_mat=smat,
        moving=moving, rotated=rotated, planes=light, box_lo=f32(lo),
        box_hi=f32(hi), box_mat=bmat, mkind=mkind, param=param,
        colour=colour, texture=texture, marble=marble,
        image=f32(image if image is not None else np.zeros((1, 1, 3))),
        media=med)


def build_view(config: dict):
    return ref_scene.build_view(config)


@dataclasses.dataclass
class Tables:
    """The world on one device in one dtype: per sphere its centre
    columns, ``r^2``, ``1 / r`` signed, the motion columns (0 but the
    moving row's); the light's ``tracer.Tables``; the boxes' corner
    columns; each row's material, each material's columns; the image;
    each medium's centre, ``r^2``, ``-1 / density`` and material."""
    sc: tuple
    r2: torch.Tensor
    inv_r: torch.Tensor
    mv0: tuple
    dmv: tuple
    light: tracer.Tables
    lo: tuple
    hi: tuple
    row_mat: torch.Tensor
    mkind: torch.Tensor
    param: torch.Tensor
    colour: torch.Tensor
    texture: torch.Tensor
    image: torch.Tensor
    marble: dict
    rotated: tuple | None
    media: list
    n_sph: int


def tables(world: Demo2World, device, dtype=torch.float32) -> Tables:
    cast = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    cols = lambda x: tuple(cast(x[:, k]) for k in range(3))
    n = world.centre.shape[0]
    e1x = cast(world.radius)
    r2 = e1x * e1x
    inv_r = 1.0 / torch.sqrt(torch.clamp(r2, min=1e-30)) * torch.sign(e1x)
    mv0 = torch.zeros((n, 3))
    dmv = torch.zeros((n, 3))
    if world.moving is not None:
        row, a, b = world.moving
        mv0[row] = torch.from_numpy(a)
        dmv[row] = torch.from_numpy(b) - torch.from_numpy(a)
    row_mat = torch.tensor(world.sphere_mat + [int(world.planes.mat[0])]
                           + world.box_mat, dtype=torch.int64, device=device)
    media_t = []
    for m in world.media:
        r = cast(m["radius"])
        media_t.append(dict(
            centre=tuple(cast(x) for x in m["centre"]), r2=r * r,
            neg_inv_density=-1.0 / torch.tensor(m["density"], dtype=dtype,
                                                device=device),
            material=m["material"]))
    return Tables(
        sc=cols(world.centre), r2=r2, inv_r=inv_r, mv0=cols(mv0),
        dmv=cols(dmv), light=tracer.tables(world.planes, device, dtype),
        lo=cols(world.box_lo), hi=cols(world.box_hi), row_mat=row_mat,
        mkind=torch.tensor(world.mkind, dtype=torch.int32, device=device),
        param=cast(world.param), colour=cast(world.colour),
        texture=torch.tensor(world.texture, dtype=torch.int32,
                             device=device),
        image=cast(world.image), marble=world.marble,
        rotated=world.rotated, media=media_t, n_sph=n)


def _safe(d):
    """Directions with |d| < 1e-20 pushed to +-1e-20 (the slabs'
    reciprocals)."""
    tiny = torch.where(d < 0, -1e-20, 1e-20).to(d.dtype)
    return torch.where(torch.abs(d) < 1e-20, tiny, d)


def _sphere_centres(tb: Tables, tm):
    """Each sphere's centre at each ray's time, [N, S] per axis."""
    return tuple(c[None] + (m[None] + tm[:, None] * v[None])
                 for c, m, v in zip(tb.sc, tb.mv0, tb.dmv))


def _nearest(tb: Tables, o, d, tm, t_min: float):
    """``(t, row)`` of each ray's nearest row (spheres, then the light,
    then the boxes), ``t`` +inf on a miss."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    px, py, pz = _sphere_centres(tb, tm)
    ocx, ocy, ocz = px - ox, py - oy, pz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    cterm = ocx * ocx + ocy * ocy + ocz * ocz - tb.r2
    disc = h * h - cterm
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1, rr2 = h - sq, h + sq
    cs = torch.where(r1 > t_min, r1, torch.where(rr2 > t_min, rr2, INF))
    cs = torch.where(disc >= 0.0, cs, INF)
    t, row = torch.min(cs, dim=1)
    # the light: media.py's plane test with the parallelogram's bound
    lt = tb.light
    nx, ny, nz = lt.n
    den = dx * nx + dy * ny + dz * nz
    den_ok = torch.abs(den) > 1e-8
    den_s = torch.where(den_ok, den, 1.0)
    on = ox * nx + oy * ny + oz * nz
    t_p = (lt.qn - on) / den_s
    a = ox * lt.wa[0] + oy * lt.wa[1] + oz * lt.wa[2] - lt.qwa \
        + t_p * (dx * lt.wa[0] + dy * lt.wa[1] + dz * lt.wa[2])
    b = ox * lt.wb[0] + oy * lt.wb[1] + oz * lt.wb[2] - lt.qwb \
        + t_p * (dx * lt.wb[0] + dy * lt.wb[1] + dz * lt.wb[2])
    ok = den_ok & (a >= 0.0) & (b >= 0.0) & (torch.maximum(a, b) <= 1.0) \
        & (t_p > t_min)
    tl = torch.where(ok, t_p, INF)[:, 0]
    better = tl < t
    t = torch.where(better, tl, t)
    row = torch.where(better, tb.n_sph, row)
    # the boxes' slabs
    inv = [1.0 / _safe(x) for x in (dx, dy, dz)]
    b0 = [(lo[None] - oo) * iv for lo, oo, iv in zip(tb.lo, (ox, oy, oz),
                                                      inv)]
    b1 = [(hi[None] - oo) * iv for hi, oo, iv in zip(tb.hi, (ox, oy, oz),
                                                      inv)]
    btn = torch.maximum(torch.maximum(torch.minimum(b0[0], b1[0]),
                                      torch.minimum(b0[1], b1[1])),
                        torch.minimum(b0[2], b1[2]))
    btf = torch.minimum(torch.minimum(torch.maximum(b0[0], b1[0]),
                                      torch.maximum(b0[1], b1[1])),
                        torch.maximum(b0[2], b1[2]))
    cb = torch.where(btn > t_min, btn, torch.where(btf > t_min, btf, INF))
    cb = torch.where(btn <= btf, cb, INF)
    tbx, rbx = torch.min(cb, dim=1)
    better = tbx < t
    t = torch.where(better, tbx, t)
    row = torch.where(better, tb.n_sph + 1 + rbx, row)
    return t, row


def _nearest_blocked(tb: Tables, o, d, tm, t_min: float, block: int):
    n = o[0].shape[0]
    outs = [_nearest(tb, tuple(x[i:i + block] for x in o),
                     tuple(x[i:i + block] for x in d), tm[i:i + block],
                     t_min) for i in range(0, n, block)]
    return torch.cat([x[0] for x in outs]), torch.cat([x[1] for x in outs])


def _record(tb: Tables, o, d, tm, t, row):
    """Normal facing the ray, front flag and outward normal of each
    ray's nearest row (``t`` finite where it hit)."""
    ns = tb.n_sph
    ox, oy, oz = o
    dx, dy, dz = d
    srow = torch.clamp(row, max=ns - 1)
    px, py, pz = (c.index_select(0, srow) + (m.index_select(0, srow)
                  + tm * v.index_select(0, srow))
                  for c, m, v in zip(tb.sc, tb.mv0, tb.dmv))
    h = dx * (px - ox) + dy * (py - oy) + dz * (pz - oz)
    inv_r = tb.inv_r.index_select(0, srow)
    s_n = ((ox + t * dx - px) * inv_r, (oy + t * dy - py) * inv_r,
           (oz + t * dz - pz) * inv_r)
    s_front = t <= h
    # the light
    l_n = tb.light.n
    l_front = (dx * l_n[0] + dy * l_n[1] + dz * l_n[2]) < 0.0
    # a box: the face of the largest relative offset from its centre
    brow = torch.clamp(row - ns - 1, min=0)
    lo = tuple(x.index_select(0, brow) for x in tb.lo)
    hi = tuple(x.index_select(0, brow) for x in tb.hi)
    t_hit = torch.where(t < INF, t, 1.0)
    hp = (ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz)
    rel = [(hp[k] - 0.5 * (lo[k] + hi[k])) / torch.clamp(hi[k] - lo[k],
                                                          min=1e-12)
           for k in range(3)]
    ax, ay, az = (torch.abs(r) for r in rel)
    on_x = (ax >= ay) & (ax >= az)
    on_y = ~on_x & (ay >= az)
    on_z = ~on_x & ~on_y
    sgn = lambda r: torch.where(r >= 0.0, 1.0, -1.0).to(t.dtype)
    zero = torch.zeros_like(t)
    b_n = (torch.where(on_x, sgn(rel[0]), zero),
           torch.where(on_y, sgn(rel[1]), zero),
           torch.where(on_z, sgn(rel[2]), zero))
    b_front = (dx * b_n[0] + dy * b_n[1] + dz * b_n[2]) < 0.0
    is_s, is_l = row < ns, row == ns
    n = tuple(torch.where(is_s, a, torch.where(is_l, b, c))
              for a, b, c in zip(s_n, l_n, b_n))
    front = torch.where(is_s, s_front, torch.where(is_l, l_front, b_front))
    flip = torch.where(front, 1.0, -1.0).to(t.dtype)
    facing = tuple(x * flip for x in n)
    outward = tuple(x * flip for x in facing)
    return facing, front, outward


def _sphere_uv(tb: Tables, outward, row):
    """The sphere uv of the outward normal, the rotated row's turned into
    its object space first."""
    owx, owy, owz = outward
    if tb.rotated is not None:
        r_row, r = tb.rotated
        sel = row == r_row
        rx = r[0] * owx + r[1] * owy + r[2] * owz
        ry = r[3] * owx + r[4] * owy + r[5] * owz
        rz = r[6] * owx + r[7] * owy + r[8] * owz
        owx = torch.where(sel, rx, owx)
        owy = torch.where(sel, ry, owy)
        owz = torch.where(sel, rz, owz)
    xz_ok = owx ** 2 + owz ** 2 > 1e-12
    sx = torch.where(xz_ok, owx, 0.0)
    sz = torch.where(xz_ok, owz, 1.0)
    su = torch.atan2(sx, sz) / (2.0 * math.pi) + 0.5
    sv = torch.arccos(torch.clamp(-owy, -1.0 + 1e-6, 1.0 - 1e-6)) / math.pi
    return su, sv


def _avalanche(c, mul: int):
    """The 32-bit avalanche of lattice coordinate ``c`` mod 256 (int64
    holding an unsigned 32-bit value)."""
    u = ((c & 255).to(torch.int64) * mul) & _M32
    u = ((u ^ (u >> 4)) * 0x21F0AAAD) & _M32
    return u ^ (u >> 15)


def _gradient(h, dtype):
    """The unit gradient of corner hash ``h``: two 16-bit uniforms of its
    avalanche through the (z, phi) map."""
    u = ((h ^ (h >> 4)) * 0x21F0AAAD) & _M32
    u = u ^ (u >> 15)
    u = (u * 0x735A2D97) & _M32
    u = u ^ (u >> 13)
    u1 = (u & 0xFFFF).to(dtype) * (1.0 / 65536.0)
    u2 = (u >> 16).to(dtype) * (1.0 / 65536.0)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


def _perlin(px, py, pz):
    ip = [torch.floor(x) for x in (px, py, pz)]
    f = [x - i for x, i in zip((px, py, pz), ip)]
    hs = [(_avalanche(i.to(torch.int32), m),
           _avalanche(i.to(torch.int32) + 1, m))
          for i, m in zip(ip, _AXIS_MUL)]
    s = [x * x * (3.0 - 2.0 * x) for x in f]
    total = torch.zeros_like(px)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                gx, gy, gz = _gradient(hs[0][i] ^ hs[1][j] ^ hs[2][k],
                                       px.dtype)
                dot = gx * (f[0] - i) + gy * (f[1] - j) + gz * (f[2] - k)
                coef = ((s[0] if i else (1.0 - s[0]))
                        * (s[1] if j else (1.0 - s[1]))
                        * (s[2] if k else (1.0 - s[2])))
                total = total + coef * dot
    return total


def marble_stripe(spec: dict, px, py, pz):
    """``0.5 + 0.5 sin(f (d . p) + 10 turb7(0.25 f p))``."""
    f = float(np.float32(spec["freq"]))
    dx, dy, dz = (float(np.float32(x)) for x in spec["direction"])
    q = 0.25 * f
    x, y, z = q * px, q * py, q * pz
    total = torch.zeros_like(px)
    coef = 1.0
    for _ in range(7):
        total = total + coef * _perlin(x, y, z)
        coef *= 0.5
        x, y, z = x * 2.0, y * 2.0, z * 2.0
    nz = 10.0 * torch.abs(total)
    return 0.5 + 0.5 * torch.sin(f * (dx * px + dy * py + dz * pz) + nz)


def _texture_albedo(tb: Tables, tex, p, uv):
    """The albedo of the image- and marble-textured lanes (1 elsewhere)."""
    alb = torch.ones((p[0].shape[0], 3), dtype=p[0].dtype,
                     device=p[0].device)
    img = tex == IMAGE
    if bool(img.any()):
        h, w = tb.image.shape[0], tb.image.shape[1]
        i = torch.remainder(torch.floor(uv[0] * w).to(torch.int32), w)
        j = torch.remainder(torch.floor((1.0 - uv[1]) * h).to(torch.int32),
                            h)
        alb = torch.where(img[:, None], tb.image[j.long(), i.long()], alb)
    mar = tex == MARBLE
    if bool(mar.any()):
        st = marble_stripe(tb.marble, *p)
        alb = torch.where(mar[:, None], st[:, None], alb)
    return alb


def _media_event(tb: Tables, o, d, us, t_min: float):
    """``(t_med, medium)``: the nearest medium scatter (+inf, -1 for
    none), the first medium winning a tie."""
    t_med = torch.full_like(o[0], INF)
    med = torch.full(o[0].shape, -1, dtype=torch.int64, device=o[0].device)
    for v, m in enumerate(tb.media):
        ocx, ocy, ocz = (c - x for c, x in zip(m["centre"], o))
        h = ocx * d[0] + ocy * d[1] + ocz * d[2]
        disc = h * h - (ocx * ocx + ocy * ocy + ocz * ocz - m["r2"])
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        ok = disc >= 0.0
        c1 = torch.where(ok & (h - sq > t_min), h - sq, INF)
        c2 = torch.where(ok & (h + sq > t_min), h + sq, INF)
        near = torch.isfinite(c1)
        t1 = torch.where(near, c1, c2)
        t2 = torch.where(near & (c2 > c1), c2, INF)
        c = media.flight(m["neg_inv_density"], t1, near, t2, t_min,
                         us[N_BASE_U + v])
        better = c < t_med
        t_med = torch.where(better, c, t_med)
        med = torch.where(better, v, med)
    return t_med, med


def trace(tb: Tables, view, key, pix, smp, *, dtype=torch.float32,
          block: int = 1 << 12):
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
    tcs = [tracer._target_consts(t) for t in view.targets]
    cdf_last = tcs[-1]["cdf"] if tcs else 0.0
    med_mat = torch.tensor([m["material"] for m in tb.media] or [0],
                           dtype=torch.int64, device=dev)
    o = d = thr = tm = None
    for depth in range(view.max_depth):
        if live.numel() == 0:
            break
        us = rng.uniform_cols(rng.mix_depth(keys[live], depth),
                              n_u + 6).to(dtype)
        if depth == 0:
            o, d = tracer.camera_rays(view, pix, us[n_u:n_u + 5])
            tm = us[n_u + 4]
            thr = tuple(torch.ones((n,), dtype=dtype, device=dev)
                        for _ in range(3))
        segs = segs.index_add(0, live, torch.ones_like(live))
        t, row = _nearest_blocked(tb, o, d, tm, view.t_min, block)
        t_med, med = _media_event(tb, o, d, us, view.t_min)
        in_med = t_med < t
        meds = meds.index_add(0, live, in_med.to(torch.int64))
        hit_s = torch.isfinite(t)
        row = torch.where(hit_s, row, 0)
        facing, front, outward = _record(tb, o, d, tm, t, row)
        su, sv = _sphere_uv(tb, outward, row)
        t_ev = torch.where(in_med, t_med, t)
        hit = t_ev < INF
        t_safe = torch.where(hit, t_ev, 1.0)
        p = tuple(x + t_safe * y for x, y in zip(o, d))
        # a medium event: its material, the normal against the ray
        mat = torch.where(in_med, med_mat[torch.clamp(med, min=0)],
                          tb.row_mat[row])
        nrm = tuple(torch.where(in_med, -y, x) for x, y in zip(facing, d))
        front = front | in_med
        kind = tb.mkind[mat]
        param = tb.param[mat]
        tex = torch.where(in_med, CONSTANT, tb.texture[mat])
        alb = tb.colour[mat]
        alb = tuple(torch.where(tex == CONSTANT, alb[:, k], 1.0)
                    for k in range(3))
        ef = torch.where(hit & (kind == LIGHT), 1.0, 0.0).to(dtype)
        rad = rad.index_add(0, live, torch.stack(
            [tr * a * ef for tr, a in zip(thr, alb)], dim=1))

        nx, ny, nz = nrm
        dx, dy, dz = d
        ddn = dx * nx + dy * ny + dz * nz
        rf = (dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, dz - 2.0 * ddn * nz)
        fz = tracer._unit(us[0], us[1])
        m = tuple(r + param * f for r, f in zip(rf, fz))
        metal_ok = (m[0] * nx + m[1] * ny + m[2] * nz) > 0.0
        inv = tracer._rsqrt3(*m)
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
        is_hemi, is_spec = kind == LAMBERTIAN, is_metal | is_diel
        spec = tuple(torch.where(is_diel, a, torch.where(is_metal, b, c))
                     for a, b, c in zip(di, m, d))
        s_alb = tuple(torch.where(is_diel, 1.0, a) for a in alb)

        # the diffuse family and the isotropic scatter, with the target
        ux = tracer._unit(us[3], us[4])
        cd = tuple(a + b for a, b in zip(nrm, ux))
        inv = tracer._rsqrt3(*cd)
        hemi_f = torch.where(is_hemi, 1.0, 0.0).to(dtype)
        bdir = tuple(hemi_f * (c * inv) + (1.0 - hemi_f) * u
                     for c, u in zip(cd, ux))
        if tcs:
            use_t = us[5] < cdf_last
            lq = [torch.zeros_like(us[5]) for _ in range(9)]
            chosen = torch.zeros_like(use_t)
            for tc in tcs:
                pick = (us[5] < tc["cdf"]) & ~chosen
                chosen = chosen | pick
                vals = tc["q"] + tc["u"] + tc["v"]
                lq = [torch.where(pick, vals[k], lq[k]) for k in range(9)]
            tg = tuple(lq[k] + us[6] * lq[3 + k] + us[7] * lq[6 + k] - p[k]
                       for k in range(3))
            inv = tracer._rsqrt3(*tg)
            use_f = torch.where(use_t, 1.0, 0.0).to(dtype)
            bdir = tuple(use_f * (g * inv) + (1.0 - use_f) * b
                         for g, b in zip(tg, bdir))
        mu1 = bdir[0] * nx + bdir[1] * ny + bdir[2] * nz
        pdf_base = torch.where(is_hemi, mu1 * (1.0 / math.pi),
                               0.25 / math.pi)
        hemi_dead = is_hemi & (pdf_base <= 0.0)
        if tcs:
            pdf_sum = float(np.float32(1.0) - np.float32(cdf_last)) \
                * pdf_base
            for tc in tcs:
                nt, qn = tc["nt"], tc["qn"]
                den = bdir[0] * nt[0] + bdir[1] * nt[1] + bdir[2] * nt[2]
                den_ok = torch.abs(den) > 1e-8
                den_s = torch.where(den_ok, den, 1.0)
                tt = (qn - (p[0] * nt[0] + p[1] * nt[1] + p[2] * nt[2])) \
                    / den_s
                hr = tuple(p[k] + tt * bdir[k] - tc["q"][k]
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
            pdf_mix = torch.clamp(pdf_base, min=1e-12)
        dw = pdf_base / pdf_mix
        spec_f = torch.where(is_spec, 1.0, 0.0).to(dtype)
        new_d = tuple(spec_f * s + (1.0 - spec_f) * b
                      for s, b in zip(spec, bdir))
        w = tuple(torch.where(is_spec, s, a * dw) for s, a in zip(s_alb, alb))
        alive = hit & (kind != LIGHT) & ~(is_metal & ~metal_ok) & ~hemi_dead
        thr = tuple(torch.where(alive, tr * x, tr) for tr, x in zip(thr, w))
        # the image and the marble, multiplied in after the scatter
        rich = alive & (tex != CONSTANT)
        if bool(rich.any()):
            ta = _texture_albedo(tb, torch.where(rich, tex, CONSTANT), p,
                                 (su, sv))
            thr = tuple(torch.where(rich, tr * ta[:, k], tr)
                        for k, tr in enumerate(thr))
        if depth + 1 >= view.max_depth:
            break
        keep = torch.nonzero(alive).squeeze(1)
        live = live.index_select(0, keep)
        o = tuple(x.index_select(0, keep) for x in p)
        d = tuple(x.index_select(0, keep) for x in new_d)
        tm = tm.index_select(0, keep)
        thr = tuple(x.index_select(0, keep) for x in thr)
    return rad, segs, meds
