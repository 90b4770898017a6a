"""Camera model and primary-ray generation (``raytrace_tpu/render/camera.py``).

Orthonormal basis from center/look_at/up, viewport sized by vfov x
focus_dist, per-sample pixel jitter, thin-lens origin on the defocus disk
and a per-sample time.  ``background`` is a callable ``(o[..., 3],
d[..., 3]) -> color[..., 3]``; the three shipped ones (constant, sky,
gray fade) are the ones the iteration kernel evaluates in-kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..core import rng
from ..core.vecmath import DTYPE, normalize, vcross


@dataclasses.dataclass(frozen=True)
class ConstBackground:
    """A constant background color."""
    color: tuple

    def __call__(self, o, d):
        c = torch.tensor(self.color, dtype=DTYPE, device=d.device)
        return torch.broadcast_to(c, d.shape)


def const_background(color) -> ConstBackground:
    c = np.asarray(color, np.float32) * np.ones(3, np.float32)
    return ConstBackground(tuple(float(x) for x in c))


def sky(o, d):
    """Blue-white vertical gradient."""
    a = 0.5 * (d[..., 1:2] + 1.0)
    white = torch.tensor([1.0, 1.0, 1.0], dtype=DTYPE, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=DTYPE, device=d.device)
    return (1.0 - a) * white + a * blue


def gray_fade(o, d):
    """Gray vertical gradient."""
    t = (d[..., 1:2] + 1.0) * 0.5
    return torch.broadcast_to(t, d.shape).to(DTYPE) \
        * torch.ones(3, dtype=DTYPE, device=d.device)


def _vec3(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32).reshape(3))


@dataclasses.dataclass(frozen=True)
class CameraSettings:
    """The camera's twelve fields.  Vectors are f32 CPU tensors; the render
    drivers move what they need to the scene's device."""
    center: torch.Tensor = dataclasses.field(
        default_factory=lambda: _vec3([0.0, 0.0, 0.0]))
    look_at: torch.Tensor = dataclasses.field(
        default_factory=lambda: _vec3([0.0, 0.0, -1.0]))
    up: torch.Tensor = dataclasses.field(
        default_factory=lambda: _vec3([0.0, 1.0, 0.0]))
    vfov: float = math.pi / 2
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    # redirect targets: probabilities should sum to < 1
    redirect_prob: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0,), dtype=DTYPE))
    redirect_q: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 3), dtype=DTYPE))
    redirect_u: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 3), dtype=DTYPE))
    redirect_v: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 3), dtype=DTYPE))
    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10
    background: Callable = dataclasses.field(
        default_factory=lambda: const_background(1.0))
    t_min: float = 1e-3
    # Russian roulette (not in the reference estimator; opt-in): from
    # bounce depth >= rr_depth a path survives with probability
    # clamp(max(throughput), rr_min, 1).  None = the exact estimator.
    rr_depth: int | None = None
    rr_min: float = 0.05

    def __post_init__(self):
        for name in ("center", "look_at", "up"):
            object.__setattr__(self, name, _vec3(getattr(self, name)))

    @property
    def image_height(self) -> int:
        return max(1, round(self.image_width / self.aspect_ratio))

    @property
    def n_redirect(self) -> int:
        return self.redirect_q.shape[0]

    def replace(self, **changes) -> "CameraSettings":
        return dataclasses.replace(self, **changes)

    def with_redirect_targets(self, targets) -> "CameraSettings":
        """targets: iterable of (prob, corner, edge_u, edge_v)."""
        targets = list(targets)
        if not targets:
            return self
        f = lambda i: torch.as_tensor(
            np.asarray([t[i] for t in targets], np.float32))
        return self.replace(redirect_prob=f(0), redirect_q=f(1).reshape(-1, 3),
                            redirect_u=f(2).reshape(-1, 3),
                            redirect_v=f(3).reshape(-1, 3))


def camera_frame(s: CameraSettings):
    """The viewport frame, computed in f32 on the CPU."""
    f = lambda x: torch.tensor(x, dtype=DTYPE)
    h = s.image_height
    w = s.image_width
    focus = f(s.focus_dist)
    viewport_h = focus * torch.tan(f(s.vfov) / 2.0) * 2.0
    viewport_w = viewport_h * (w / h)
    wv = normalize(s.center - s.look_at)
    uv = normalize(vcross(s.up, wv))
    vv = vcross(wv, uv)
    across = viewport_w * uv
    down = -(viewport_h * vv)
    top_left = s.center - wv * focus - across / 2.0 - down / 2.0
    defocus_radius = focus * torch.tan(f(s.defocus_angle) / 2.0)
    return dict(u=uv, v=vv, top_left=top_left, pixel_u=across / w,
                pixel_v=down / h, defocus_radius=defocus_radius)


def camera_table(s: CameraSettings, frame) -> list:
    """The 19 f32 camera values, in the order of the iteration kernel's
    camera table: center, top_left, pixel_u, pixel_v, u, v (3 each) and
    the defocus radius."""
    vals = [s.center] + [frame[k] for k in ("top_left", "pixel_u",
                                             "pixel_v", "u", "v")]
    return (torch.cat([v.reshape(3) for v in vals]).tolist()
            + [float(frame["defocus_radius"])])


def rays_from_table(cam, width: int, pixel_ids, u5):
    """Primary rays for flat pixel indices ``pixel_ids[R]`` from the
    camera values ``cam`` (:func:`camera_table`) and the five uniform
    columns ``u5`` ([5, R]: disk radius, disk angle, pixel jitter x2,
    time).  Returns a [7, R] tensor: origin (3), unit direction (3),
    time."""
    i = (pixel_ids % width).to(DTYPE)
    j = torch.div(pixel_ids, width, rounding_mode="floor").to(DTYPE)
    r = torch.sqrt(u5[0])
    th = (2.0 * math.pi) * u5[1]
    da = r * torch.cos(th) * cam[18]
    db = r * torch.sin(th) * cam[18]
    ii = i + u5[2]
    jj = j + u5[3]
    out_o = []
    out_d = []
    for k in range(3):
        ok = cam[k] + da * cam[12 + k] + db * cam[15 + k]
        tk = cam[3 + k] + ii * cam[6 + k] + jj * cam[9 + k]
        out_o.append(ok)
        out_d.append(tk - ok)
    inv = 1.0 / torch.sqrt(torch.clamp(
        out_d[0] * out_d[0] + out_d[1] * out_d[1] + out_d[2] * out_d[2],
        min=1e-24))
    return torch.stack(out_o + [out_d[0] * inv, out_d[1] * inv,
                                out_d[2] * inv, u5[4]])


def generate_ray_components(s: CameraSettings, frame, pixel_ids, u5):
    """Primary rays of camera ``s`` (see :func:`rays_from_table`)."""
    return rays_from_table(camera_table(s, frame), s.image_width, pixel_ids,
                           u5)


def generate_rays_from_uniforms(s: CameraSettings, frame, pixel_ids, u5):
    """Primary rays for flat pixel indices ``pixel_ids[R]`` from an [R, 5]
    uniform block (disk x2, pixel jitter x2, time), in the JAX package's
    ``[R, 3]`` form and association: the thin-lens origin on the defocus
    disk, the jittered target inside the pixel, the unit direction and the
    sample's time.  Returns ``(origin [R, 3], direction [R, 3], time
    [R])``."""
    dev = u5.device
    fr = {k: torch.as_tensor(v, dtype=DTYPE).to(dev) for k, v in frame.items()}
    w = s.image_width
    i = (pixel_ids % w).to(DTYPE)
    j = torch.div(pixel_ids, w, rounding_mode="floor").to(DTYPE)
    disk = rng.disk_from_uniforms(u5[:, 0], u5[:, 1])
    rad = fr["defocus_radius"]
    origin = (s.center.to(dev) + disk[:, 0:1] * (rad * fr["u"])
              + disk[:, 1:2] * (rad * fr["v"]))
    target = (fr["top_left"] + (i + u5[:, 2])[:, None] * fr["pixel_u"]
              + (j + u5[:, 3])[:, None] * fr["pixel_v"])
    return origin, normalize(target - origin), u5[:, 4]


def generate_rays(s: CameraSettings, frame, pixel_ids, keys):
    """Primary rays from per-ray keys: one 5-column uniform block of each
    key's draw site 0 (:func:`generate_rays_from_uniforms`)."""
    u5 = rng.uniform_block(rng.site(keys, 0), 5)
    return generate_rays_from_uniforms(s, frame, pixel_ids, u5)
