"""3-D Perlin gradient noise (``raytrace_tpu/textures/noise.py``).

The reference algorithm (``Graphics/Ray/Noise.hs:15-92``): a period-256
lattice, a smoothstep-weighted trilinear blend of the eight corner
gradient dot products, octaves summed with halving weights.  The JAX
package hashes the lattice with pure 32-bit unsigned arithmetic (a murmur
avalanche of each lattice coordinate, ``_ava``, and of the XOR of three,
``_hash_gradient``, mapped to a uniform unit vector); the reference's
permutation tables stay available with ``use_tables=True``.  This module
computes the same bits.

torch's CPU ``uint32`` has no right shift, so the hash runs in int64
holding 32-bit unsigned values: each product of such a value and a 32-bit
constant stays below 2^63 and is masked back to 32 bits, which is
uint32 arithmetic exactly.  ``csrc/noise.cuh`` is the device version of
:func:`perlin_noise_soa` (the marble kernel, ``ops/texture_kernel.py``),
built to round as this module does.
"""
from __future__ import annotations

import math

import torch

from ..core.vecmath import DTYPE
from ._perlin_tables import PERMX, PERMY, PERMZ

_M32 = 0xFFFFFFFF
# per-axis multipliers of the lattice-coordinate avalanche
_AXIS_MUL = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)


def _ava(c, mul: int):
    """Murmur avalanche of the period-256 lattice coordinate ``c`` (i32):
    a 32-bit unsigned value held in int64."""
    u = ((c & 255).to(torch.int64) * mul) & _M32
    u = ((u ^ (u >> 4)) * 0x21F0AAAD) & _M32
    return u ^ (u >> 15)


def gradient_hash(h):
    """The 32-bit avalanche of the corner hash ``h`` (int64 holding a
    32-bit unsigned value) that :func:`_hash_gradient` maps to a unit
    vector."""
    u = ((h ^ (h >> 4)) * 0x21F0AAAD) & _M32
    u = u ^ (u >> 15)
    u = (u * 0x735A2D97) & _M32
    return u ^ (u >> 13)


def _hash_gradient(h):
    """Uniform unit vector (gx, gy, gz) from the corner hash ``h``: two
    16-bit uniforms through the (z, phi) map."""
    u = gradient_hash(h)
    u1 = (u & 0xFFFF).to(DTYPE) * (1.0 / 65536.0)
    u2 = (u >> 16).to(DTYPE) * (1.0 / 65536.0)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


def _smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


def _blend_corners(hx, hy, hz, fx, fy, fz):
    """Smoothstep-weighted trilinear blend of the 8 corner gradient dots;
    ``hx``/``hy``/``hz`` are per-axis (h(c), h(c + 1)) pairs."""
    total = torch.zeros_like(fx)
    sx, sy, sz = _smoothstep(fx), _smoothstep(fy), _smoothstep(fz)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                gx, gy, gz = _hash_gradient(hx[i] ^ hy[j] ^ hz[k])
                dot = gx * (fx - i) + gy * (fy - j) + gz * (fz - k)
                coef = ((sx if i else (1.0 - sx))
                        * (sy if j else (1.0 - sy))
                        * (sz if k else (1.0 - sz)))
                total = total + coef * dot
    return total


def lattice_hashes(ipx, ipy, ipz):
    """Per-axis (h(c), h(c + 1)) avalanche pairs of the floored
    coordinates (f32; converted to i32, the lattice coordinate)."""
    hs = []
    for c, mul in zip((ipx, ipy, ipz), _AXIS_MUL):
        c = c.to(torch.int32)
        hs.append((_ava(c, mul), _ava(c + 1, mul)))
    return hs


def perlin_noise_soa(px, py, pz):
    """Arithmetic-hash Perlin noise on the components of the points."""
    ipx, ipy, ipz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - ipx, py - ipy, pz - ipz
    hs = lattice_hashes(ipx, ipy, ipz)
    return _blend_corners(hs[0], hs[1], hs[2], fx, fy, fz)


def fractal_noise_soa(depth: int, px, py, pz):
    """Sum of ``depth`` octaves of :func:`perlin_noise_soa`: the weight
    halves and the frequency doubles per octave."""
    total = torch.zeros_like(px)
    coef = 1.0
    for _ in range(depth):
        total = total + coef * perlin_noise_soa(px, py, pz)
        coef *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return total


def turbulence_soa(depth: int, px, py, pz):
    """Absolute value of :func:`fractal_noise_soa`."""
    return torch.abs(fractal_noise_soa(depth, px, py, pz))


def _perm_pair(perm: torch.Tensor, idx):
    """(perm[idx & 255], perm[(idx + 1) & 255]) as int64, by indexing."""
    return perm[(idx & 255).long()], perm[((idx + 1) & 255).long()]


def perlin_noise(p, use_tables: bool = False):
    """Perlin noise of points ``p`` [..., 3] -> [...], in
    [-sqrt(3)/2, sqrt(3)/2].  ``use_tables`` hashes the lattice with the
    reference's permutation tables instead of the arithmetic hash."""
    p = torch.as_tensor(p, dtype=DTYPE)
    if not use_tables:
        return perlin_noise_soa(p[..., 0], p[..., 1], p[..., 2])
    ip = torch.floor(p)
    f = p - ip
    ip = ip.to(torch.int32)
    hs = [_perm_pair(torch.tensor(t, dtype=torch.int64, device=p.device),
                     ip[..., a]) for a, t in enumerate((PERMX, PERMY, PERMZ))]
    return _blend_corners(hs[0], hs[1], hs[2], f[..., 0], f[..., 1],
                          f[..., 2])


def fractal_noise(depth: int, p, use_tables: bool = False):
    """Sum of ``depth`` octaves (``depth`` static)."""
    p = torch.as_tensor(p, dtype=DTYPE)
    total = torch.zeros(p.shape[:-1], dtype=DTYPE, device=p.device)
    coef = 1.0
    for _ in range(depth):
        total = total + coef * perlin_noise(p, use_tables=use_tables)
        coef *= 0.5
        p = p * 2.0
    return total


def turbulence(depth: int, p, use_tables: bool = False):
    """Absolute value of :func:`fractal_noise`."""
    return torch.abs(fractal_noise(depth, p, use_tables=use_tables))
