"""The counter-hash random stream the renderer is specified to draw from.

Every draw is a pure function of (key, pixel, sample, depth, column):
a path's key comes from its (pixel, sample) by odd-constant multiplies,
is mixed with the bounce depth, and each uniform column is one
full-avalanche hash of (key, column), two 16-bit uniforms a hash word.
Written out here from that specification so that the reference draws
the same numbers as the program without importing it.  Keys are int32
tensors ``[..., 2]``; the hash runs on int32 (wrapping multiply, xor and
add are sign-agnostic mod 2^32; a logical right shift is an arithmetic
shift with the sign bits masked off).
"""
from __future__ import annotations

import torch

_PHI = 0x9E3779B9


def i32(x: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    return (h >> k) & ((1 << (32 - k)) - 1)


def key_words(word0: int, word1: int, device=None) -> torch.Tensor:
    """A base key from two words, each taken mod 2^32."""
    return torch.tensor([i32(word0), i32(word1)], dtype=torch.int32,
                        device=device)


def ray_keys(key: torch.Tensor, pixel: torch.Tensor,
             sample: torch.Tensor) -> torch.Tensor:
    p = pixel.to(torch.int32)
    s = sample.to(torch.int32)
    k0 = key[0] ^ (p * i32(0x9E3779B1)) ^ (s * i32(0x632BE5AB))
    k1 = key[1] ^ (s * i32(0x85EBCA77)) ^ (p * i32(0xB5297A4D))
    return torch.stack([k0, k1], dim=-1)


def mix_depth(keys: torch.Tensor, depth: int) -> torch.Tensor:
    k0 = keys[..., 0] + i32(depth * 0xC2B2AE3D)
    k1 = keys[..., 1] ^ i32(depth * 0x27D4EB2F)
    return torch.stack([k0, k1], dim=-1)


def _finalize2(h: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 16)
    h = h * i32(0x21F0AAAD)
    h = h ^ _shr(h, 15)
    h = h * i32(0x735A2D97)
    h = h ^ _shr(h, 15)
    h = h ^ k1
    h = h ^ _shr(h, 16)
    h = h * i32(0xD35A2D97)
    h = h ^ _shr(h, 15)
    return h


def uniform_cols(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, N]`` float32 uniforms in [0, 1): column ``c`` (``c < m =
    ceil(n/2)``) is the low half-word of hash ``c``, column ``m + c`` its
    high half-word."""
    k0, k1 = keys[..., 0], keys[..., 1]
    m = (n + 1) // 2
    hs = [_finalize2(k0 + i32(c * _PHI), k1) for c in range(m)]
    cols = [h & 0xFFFF for h in hs] + [_shr(h, 16) for h in hs]
    return torch.stack(cols[:n]).to(torch.float32) * (1.0 / (1 << 16))
