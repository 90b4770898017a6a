"""Counter-hash RNG of the port, bit-identical to ``raytrace_tpu/core/rng.py``.

Every random draw is a pure function of (seed, pixel, sample, depth,
column): a lane's key is built from its logical coordinates by odd-constant
multiplies (:func:`ray_keys_fast`), mixed with the bounce depth
(:func:`mix_depth`), and each column of a uniform block is one
full-avalanche hash of (key, column) (:func:`uniform_block`).  The port
does not use ``torch.Generator`` or Philox: the same stream as the JAX
package is what lets the tests compare the two lane by lane.

Keys are int32 tensors ``[..., 2]`` holding the two 32-bit key words (the
JAX package's ``key_data`` bit pattern).  The hash runs on int32: wrapping
multiply, xor and add are sign-agnostic mod 2^32, and the logical right
shift is an arithmetic shift with the sign bits masked off (torch has no
right shift for uint32 on the CPU).
"""
from __future__ import annotations

import math

import torch

_PHI = 0x9E3779B9


def _i32(x: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 ``h`` by ``k`` (0 < k < 32)."""
    return (h >> k) & ((1 << (32 - k)) - 1)


def base_key(seed: int, device=None) -> torch.Tensor:
    """Key words ``(0, seed mod 2^32)`` — the words of
    ``jax.random.key(seed)`` for the default threefry implementation."""
    return torch.tensor([0, _i32(int(seed))], dtype=torch.int32,
                        device=device)


def ray_keys_fast(key: torch.Tensor, pixel_ids: torch.Tensor,
                  sample_ids: torch.Tensor) -> torch.Tensor:
    """One key per ray from absolute (pixel, sample) coordinates."""
    p = pixel_ids.to(torch.int32)
    s = sample_ids.to(torch.int32)
    k0 = key[0] ^ (p * _i32(0x9E3779B1)) ^ (s * _i32(0x632BE5AB))
    k1 = key[1] ^ (s * _i32(0x85EBCA77)) ^ (p * _i32(0xB5297A4D))
    return torch.stack([k0, k1], dim=-1)


def mix_depth(keys: torch.Tensor, depth) -> torch.Tensor:
    """Per-bounce key derivation."""
    dep = torch.as_tensor(depth, dtype=torch.int32, device=keys.device)
    dep = torch.broadcast_to(dep, keys.shape[:-1])
    k0 = keys[..., 0] + dep * _i32(0xC2B2AE3D)
    k1 = keys[..., 1] ^ (dep * _i32(0x27D4EB2F))
    return torch.stack([k0, k1], dim=-1)


def _finalize2(h: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """Two-round full-avalanche 32-bit mixer keyed by ``k1``."""
    h = h ^ _shr(h, 16)
    h = h * _i32(0x21F0AAAD)
    h = h ^ _shr(h, 15)
    h = h * _i32(0x735A2D97)
    h = h ^ _shr(h, 15)
    h = h ^ k1
    h = h ^ _shr(h, 16)
    h = h * _i32(0xD35A2D97)
    h = h ^ _shr(h, 15)
    return h


def uniform_cols(keys: torch.Tensor, n: int,
                 pair16: bool = True) -> torch.Tensor:
    """The uniform block column-major: ``[n, ...]`` f32, column ``c`` of
    lane key (k0, k1) being ``finalize2(k0 + c*phi, k1)``.

    ``pair16`` (the JAX package's default) takes two 16-bit uniforms per
    hash word: columns ``[0, m)`` are the low half-words of hashes
    ``0..m-1`` and ``[m, 2m)`` the high ones, ``m = ceil(n/2)`` — a
    concatenation, not an interleave.  A draw can be exactly 0.0.
    Otherwise each column is one hash with a 24-bit mantissa."""
    k0 = keys[..., 0]
    k1 = keys[..., 1]
    if pair16:
        m = (n + 1) // 2
        hs = [_finalize2(k0 + _i32(c * _PHI), k1) for c in range(m)]
        cols = [h & 0xFFFF for h in hs] + [_shr(h, 16) for h in hs]
        return torch.stack(cols[:n]).to(torch.float32) * (1.0 / (1 << 16))
    hs = [_finalize2(k0 + _i32(c * _PHI), k1) for c in range(n)]
    return torch.stack([_shr(h, 8) for h in hs]).to(torch.float32) \
        * (1.0 / (1 << 24))


def uniform_block(keys: torch.Tensor, n: int,
                  pair16: bool = True) -> torch.Tensor:
    """``[..., n]`` uniforms (the JAX package's layout); see
    :func:`uniform_cols`."""
    return torch.movedim(uniform_cols(keys, n, pair16), 0, -1)


def unit_vector_from_uniforms(u: torch.Tensor, v: torch.Tensor):
    """Uniform unit vectors from two U[0,1) draws: z = 1-2u is uniform in
    [-1, 1], azimuth 2 pi v."""
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * v
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def disk_from_uniforms(u: torch.Tensor, v: torch.Tensor):
    """Uniform points in the unit disk from two U[0,1) draws."""
    r = torch.sqrt(u)
    theta = (2.0 * math.pi) * v
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


# threefry2x32's rotation schedule and key-schedule parity constant
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _words(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of an integer tensor as int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _rotl(v: torch.Tensor, d: int) -> torch.Tensor:
    return ((v << d) | (v >> (32 - d))) & _M32


def threefry_2x32(k0, k1, x0, x1):
    """The threefry2x32 block function (20 rounds, Random123; the one
    ``jax.random``'s default implementation applies) of the key words
    ``(k0, k1)`` on the counter words ``(x0, x1)``, every word an int64
    tensor in [0, 2^32) (broadcast together).  Returns the two output
    words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of the keys ``keys`` [..., 2] (int32 words)
    with the data ``data`` (an int or an integer tensor broadcast against
    the keys' lanes, taken mod 2^32): ``threefry_2x32(key, (0, data))``.
    Returns keys [..., 2] (int32 words)."""
    d = torch.as_tensor(data, device=keys.device)
    d = torch.broadcast_to(_words(d), keys.shape[:-1])
    y0, y1 = threefry_2x32(_words(keys[..., 0]), _words(keys[..., 1]),
                           torch.zeros_like(d), d)
    y = torch.stack([y0, y1], dim=-1)
    return torch.where(y >= (1 << 31), y - (1 << 32), y).to(torch.int32)


def ray_keys(key: torch.Tensor, pixel_ids, sample_ids) -> torch.Tensor:
    """One key per ray from absolute (pixel, sample) coordinates: the
    base key folded with the pixel, then with the sample (two threefry
    passes; the hot paths take :func:`ray_keys_fast`)."""
    k = fold_in(torch.broadcast_to(key, pixel_ids.shape + (2,)), pixel_ids)
    return fold_in(k, sample_ids)


def fold_depth(keys: torch.Tensor, depth: int) -> torch.Tensor:
    """The per-bounce key of each per-ray key (a threefry ``fold_in``)."""
    return fold_in(keys, depth)


def site(keys: torch.Tensor, i: int) -> torch.Tensor:
    """The key of draw site ``i`` within a bounce (a threefry
    ``fold_in``)."""
    return fold_in(keys, i)
