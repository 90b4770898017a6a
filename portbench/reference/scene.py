"""The reference's own tables, worked out from a configuration's world
data (``configs/<name>.json``), with numpy and plain torch.

Objects bake their transforms in float64 (right-to-left composition, as
the scene API defines it) and round to float32; a rotated cuboid lowers
to its six faces with outward winding.  Each named material is one
material with one constant texture.  Only what the configurations use is
here: spheres, parallelograms, rotated cuboids; lambertian, metal,
dielectric, mirror and light materials; a constant or sky background;
thin-lens cameras with optional redirect targets.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SPHERE, PARALLELOGRAM = 0, 1
LIGHT, LAMBERTIAN, MIRROR, METAL, DIELECTRIC = 0, 2, 4, 5, 6
_KINDS = {"light": LIGHT, "lambertian": LAMBERTIAN, "mirror": MIRROR,
          "metal": METAL, "dielectric": DIELECTRIC}


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = np.asarray(v, np.float64)
    return m


def _rotate_y(deg):
    a = deg * math.pi / 180.0
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


_TRANSFORMS = {"translate": _translate, "rotate_y_deg": _rotate_y}


def _matrix(steps) -> np.ndarray:
    out = np.eye(4)
    for name, arg in steps:
        out = out @ _TRANSFORMS[name](arg)
    return np.eye(4) @ out


def _box_faces(lo, hi):
    dx, dy, dz = (np.zeros(3) for _ in range(3))
    dx[0], dy[1], dz[2] = hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]
    qs = [lo + dz, lo + dx, lo, lo + dx + dz, lo + dy + dz, lo]
    us = [dx, -dx, dz, -dz, dx, dx]
    vs = [dy, dy, dy, dy, -dz, dz]
    return list(zip(qs, us, vs))


@dataclasses.dataclass
class World:
    """Rows (``kind``, ``p0``, ``e1``, ``e2`` float32, ``mat``), the
    materials (``mkind``, ``param``) and their colours (``c0``, one
    texture a material), on the CPU."""
    kind: torch.Tensor
    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    mat: torch.Tensor
    mkind: torch.Tensor
    param: torch.Tensor
    c0: torch.Tensor


def build_world(config: dict) -> World:
    names = list(config["materials"])
    index = {n: i for i, n in enumerate(names)}
    mkind, param, c0 = [], [], []
    for n in names:
        m = config["materials"][n]
        mkind.append(_KINDS[m["kind"]])
        param.append(m.get("fuzz", m.get("ior", 0.0)))
        c0.append(m.get("color", [1.0, 1.0, 1.0]))
    kind, p0, e1, e2, mat = [], [], [], [], []

    def add(k, a, b, c, m):
        kind.append(k)
        p0.append(a)
        e1.append(b)
        e2.append(c)
        mat.append(index[m])

    for obj in config["objects"]:
        mtx = _matrix(obj.get("transform", []))
        a, b = mtx[:3, :3], mtx[:3, 3]
        if "sphere" in obj:
            center, radius = obj["sphere"]
            if obj.get("transform"):
                raise ValueError("reference: transformed spheres are not "
                                 "in the configurations")
            add(SPHERE, np.asarray(center, np.float64),
                np.asarray([radius, 0.0, 0.0]), np.zeros(3), obj["material"])
        elif "parallelogram" in obj:
            q, u, v = (np.asarray(x, np.float64) for x in obj["parallelogram"])
            add(PARALLELOGRAM, q @ a.T + b, u @ a.T, v @ a.T, obj["material"])
        elif "cuboid" in obj:
            c0_, c1_ = (np.asarray(x, np.float64) for x in obj["cuboid"])
            if np.allclose(a, a[0, 0] * np.eye(3)):
                raise ValueError("reference: an axis-aligned cuboid is one "
                                 "box row in the program; only rotated "
                                 "cuboids are in the configurations")
            for q, u, v in _box_faces(np.minimum(c0_, c1_),
                                      np.maximum(c0_, c1_)):
                add(PARALLELOGRAM, q @ a.T + b, u @ a.T, v @ a.T,
                    obj["material"])
        else:
            raise ValueError(f"reference: unknown object {sorted(obj)}")
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    return World(kind=torch.tensor(kind, dtype=torch.int32), p0=f32(p0),
                 e1=f32(e1), e2=f32(e2),
                 mat=torch.tensor(mat, dtype=torch.int64),
                 mkind=torch.tensor(mkind, dtype=torch.int32),
                 param=f32(param), c0=f32(c0))


@dataclasses.dataclass
class View:
    """The camera as 19 float32 values (center, top-left, pixel steps,
    lens axes, defocus radius), the image size, the background, the
    redirect targets (float32 rows) and the estimator's settings."""
    cam: list
    width: int
    height: int
    sky: bool
    bg: tuple
    targets: list
    max_depth: int
    rr_depth: int | None
    rr_min: float
    t_min: float


def _normalize(a):
    q = torch.sum(a * a, dim=-1, keepdim=True)
    return a * (1.0 / torch.sqrt(torch.clamp(q, min=1e-12)))


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def build_view(config: dict) -> View:
    """The camera frame in float32 on the CPU: viewport from the
    vertical field of view and focus distance, an orthonormal basis from
    center, look-at and up, the thin lens's radius from the defocus
    angle."""
    c = config["camera"]
    r = config["render"]
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    v3 = lambda x: torch.from_numpy(np.asarray(x, np.float32).reshape(3))
    width = int(c["image_width"])
    height = max(1, round(width / c["aspect_ratio"]))
    center, look_at = v3(c["center"]), v3(c["look_at"])
    up = v3(c.get("up", [0.0, 1.0, 0.0]))
    focus = f(c.get("focus_dist", 10.0))
    vfov = c["vfov_deg"] * math.pi / 180.0
    viewport_h = focus * torch.tan(f(vfov) / 2.0) * 2.0
    viewport_w = viewport_h * (width / height)
    wv = _normalize(center - look_at)
    uv = _normalize(_cross(up, wv))
    vv = _cross(wv, uv)
    across = viewport_w * uv
    down = -(viewport_h * vv)
    top_left = center - wv * focus - across / 2.0 - down / 2.0
    defocus = c.get("defocus_angle_deg", 0.0) * math.pi / 180.0
    radius = focus * torch.tan(f(defocus) / 2.0)
    cam = (torch.cat([center, top_left, across / width, down / height, uv,
                      vv]).tolist() + [float(radius)])
    bg = c["background"]
    targets = []
    if c.get("redirect"):
        cdf = 0.0
        for prob, q, u, v in c["redirect"]:
            cdf = float(np.float32(cdf) + np.float32(prob))
            targets.append((np.float32(prob), np.asarray(q, np.float32),
                            np.asarray(u, np.float32),
                            np.asarray(v, np.float32), np.float32(cdf)))
    return View(cam=cam, width=width, height=height, sky=bg == "sky",
                bg=(0.0, 0.0, 0.0) if bg == "sky" else
                tuple(float(np.float32(x)) for x in np.broadcast_to(
                    np.asarray(bg["constant"], np.float64), 3)),
                targets=targets, max_depth=int(r["max_depth"]),
                rr_depth=r.get("rr_depth"),
                rr_min=float(np.float32(r.get("rr_min", 0.05))),
                t_min=float(np.float32(r.get("t_min", 1e-3))))
