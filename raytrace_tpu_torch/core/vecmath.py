"""Vector helpers over a trailing 3-axis (``raytrace_tpu/core/vecmath.py``).

Every helper takes tensors whose *last* axis is the 3-vector axis, so one
ray or a million rays go through the same code.  The one-hot row gathers
of the JAX package (``onehot_rows``/``gather_rows``) existed because TPU
gathers were slow; the port indexes tables directly.
"""
from __future__ import annotations

import math

import torch

DTYPE = torch.float32


def degrees(x):
    """Degrees to radians."""
    return x * math.pi / 180.0


def vdot(a, b):
    """Dot product over the trailing 3-axis, keeping the axis ([..., 1])."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def vdot0(a, b):
    """Dot product over the trailing 3-axis, dropping the axis ([...])."""
    return torch.sum(a * b, dim=-1)


def quadrance(a):
    return torch.sum(a * a, dim=-1)


def vnorm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a, eps: float = 1e-12):
    """Unit-length vectors along the last axis, safe at zero length."""
    q = torch.sum(a * a, dim=-1, keepdim=True)
    return a * (1.0 / torch.sqrt(torch.clamp(q, min=eps)))


def vcross(a, b):
    """Cross product over the trailing 3-axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def reflect(normal, v):
    """Mirror ``v`` about the plane with unit normal ``normal``."""
    return v - 2.0 * vdot(normal, v) * normal


def refract(ior_ratio, cos_theta, normal, u):
    """Snell refraction of unit vector ``u`` about unit ``normal``;
    ``ior_ratio`` is eta_in/eta_out and ``cos_theta`` = dot(normal, -u)."""
    ior_ratio = torch.as_tensor(ior_ratio, dtype=u.dtype,
                                device=u.device)[..., None]
    cos_theta = torch.as_tensor(cos_theta, dtype=u.dtype,
                                device=u.device)[..., None]
    perp = ior_ratio * (u + cos_theta * normal)
    rem = torch.clamp(torch.abs(1.0 - torch.sum(perp * perp, dim=-1,
                                                keepdim=True)), min=1e-12)
    return perp - torch.sqrt(rem) * normal


def take_rows(table, idx):
    """``table[idx]`` for an integer index tensor of any shape, through
    ``index_select``: its backward adds the rows' cotangents with
    ``index_add_`` (atomic adds on the card), where the backward of
    advanced indexing sorts the indices and walks each run of a repeated
    one serially (on an H100, 15 ms for 2^18 lanes into a table of a few
    rows)."""
    flat = torch.index_select(table, 0, idx.reshape(-1).long())
    return flat.reshape(idx.shape + table.shape[1:])
