"""Texture descriptors, their compiled table and their batched evaluation
(``raytrace_tpu/textures/textures.py``).

Every texture of a scene is interned into a struct-of-arrays table, one
row per texture.  :func:`eval_texture` evaluates the six kinds for a
batch of lanes (only the kinds present in the scene, combined with
``where``); custom textures are torch callables ``fn(points [R, 3],
uvs [R, 2]) -> colors``.  Parameters are gathered by direct indexing
(the JAX package's ``onehot=`` one-hot matmuls are a TPU workaround and
are not ported).  Image texels go through :func:`_image_gather`, whose
backward is the atlas-gradient kernel (``ops/image_grad_kernel.py``);
marble stripes can go to the marble kernel (``ops/texture_kernel.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.vecmath import DTYPE
from ..ops.image_grad_kernel import image_grad_pallas
from ..ops.texture_kernel import marble_stripe_pallas, marble_stripe_values
from .noise import fractal_noise

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3
TEX_MARBLE = 4
TEX_CUSTOM = 5
# the kinds the render kernels shade themselves; the others are rich
BASE_KINDS = frozenset({TEX_CONSTANT, TEX_CHECKER})


def is_rich(kinds) -> bool:
    """Do texture ``kinds`` include one the kernels shade at albedo 1.0
    and leave to the caller (image, noise, marble, custom)?"""
    return not set(kinds) <= BASE_KINDS


@dataclasses.dataclass(frozen=True, eq=False)
class Texture:
    """A texture descriptor: ``c0``/``c1`` colors, ``v0``/``v1`` vector
    params, ``f0``/``f1`` scalar params, ``i0`` an integer param (octave
    count), ``image`` an [H, W, 3] array, ``fn`` a custom closure.
    Compared and hashed by identity, as scene interning expects."""
    kind: int
    c0: Any = (0.0, 0.0, 0.0)
    c1: Any = (0.0, 0.0, 0.0)
    v0: Any = (0.0, 0.0, 0.0)
    v1: Any = (0.0, 0.0, 0.0)
    f0: Any = 0.0
    f1: Any = 0.0
    i0: int = 0
    image: Any = None
    fn: Callable | None = None


def constant_texture(color) -> Texture:
    """Same color everywhere."""
    return Texture(TEX_CONSTANT, c0=_c3(color))


def checker_texture(n_u: int, n_v: int, c0, c1) -> Texture:
    """UV checkerboard with ``n_u`` x ``n_v`` cells."""
    return Texture(TEX_CHECKER, c0=_c3(c0), c1=_c3(c1), f0=float(n_u),
                   f1=float(n_v))


def image_texture(image) -> Texture:
    """Image lookup, nearest sample with wrap-around; ``image`` is an
    [H, W, 3] linear-RGB array."""
    return Texture(TEX_IMAGE, image=np.asarray(image, np.float32))


def noise_texture(k: int, freq: float, shift, color0, color1) -> Texture:
    """Fractal-noise lerp between two colors."""
    return Texture(TEX_NOISE, c0=_c3(color0), c1=_c3(color1), v0=_c3(shift),
                   f0=float(freq), i0=int(k))


def marble_texture(direction, freq: float, shift=(0.0, 0.0, 0.0)) -> Texture:
    """Noisy sine stripes along ``direction``."""
    return Texture(TEX_MARBLE, v0=_c3(direction), v1=_c3(shift),
                   f0=float(freq))


def custom_texture(fn: Callable) -> Texture:
    """Arbitrary ``fn(points[..., 3], uvs[..., 2]) -> colors[..., 3]``."""
    return Texture(TEX_CUSTOM, fn=fn)


def solid_texture(fn: Callable) -> Texture:
    """Point-dependent color."""
    return custom_texture(lambda p, uv: fn(p))


def uv_texture(fn: Callable) -> Texture:
    """UV-dependent color."""
    return custom_texture(lambda p, uv: fn(uv))


def _c3(x):
    x = np.asarray(x, np.float64)
    if x.ndim == 0:
        x = np.full((3,), float(x))
    return tuple(float(v) for v in x)


@dataclasses.dataclass(frozen=True)
class TextureTable:
    kind: torch.Tensor       # i32[T]
    c0: torch.Tensor         # f32[T, 3]
    c1: torch.Tensor         # f32[T, 3]
    v0: torch.Tensor         # f32[T, 3]
    v1: torch.Tensor         # f32[T, 3]
    f0: torch.Tensor         # f32[T]
    f1: torch.Tensor         # f32[T]
    i0: torch.Tensor         # i32[T]
    images: torch.Tensor     # f32[I, H, W, 3] atlas (I >= 1; dummy if unused)
    image_hw: torch.Tensor   # i32[I, 2] true (h, w) per image
    kinds_present: tuple = ()
    noise_octaves: tuple = ()
    custom_fns: tuple = ()
    marble_rows: tuple = ()

    def to(self, device) -> "TextureTable":
        return _tensors_to(self, device)


def _tensors_to(obj, device):
    """``obj`` with every tensor field moved to ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def compile_textures(textures: Sequence[Texture]) -> TextureTable:
    """Intern a list of descriptors; the index in the list is the texture
    id the material table refers to."""
    n = max(len(textures), 1)
    kind = np.zeros(n, np.int32)
    c0 = np.zeros((n, 3), np.float32)
    c1 = np.zeros((n, 3), np.float32)
    v0 = np.zeros((n, 3), np.float32)
    v1 = np.zeros((n, 3), np.float32)
    f0 = np.zeros(n, np.float32)
    f1 = np.zeros(n, np.float32)
    i0 = np.zeros(n, np.int32)
    images: list[np.ndarray] = []
    custom_fns: list[Callable] = []
    octaves: set[int] = set()

    for t_idx, t in enumerate(textures):
        kind[t_idx] = t.kind
        c0[t_idx] = t.c0
        c1[t_idx] = t.c1
        v0[t_idx] = t.v0
        v1[t_idx] = t.v1
        f0[t_idx] = t.f0
        f1[t_idx] = t.f1
        if t.kind == TEX_IMAGE:
            i0[t_idx] = len(images)
            images.append(np.asarray(t.image, np.float32))
        elif t.kind == TEX_CUSTOM:
            i0[t_idx] = len(custom_fns)
            custom_fns.append(t.fn)
        else:
            i0[t_idx] = t.i0
            if t.kind == TEX_NOISE:
                octaves.add(int(t.i0))

    if images:
        max_h = max(im.shape[0] for im in images)
        max_w = max(im.shape[1] for im in images)
        atlas = np.zeros((len(images), max_h, max_w, 3), np.float32)
        hw = np.zeros((len(images), 2), np.int32)
        for idx, im in enumerate(images):
            atlas[idx, : im.shape[0], : im.shape[1]] = im
            hw[idx] = im.shape[:2]
    else:
        atlas = np.zeros((1, 1, 1, 3), np.float32)
        hw = np.ones((1, 2), np.int32)

    t = torch.from_numpy
    return TextureTable(
        kind=t(kind), c0=t(c0), c1=t(c1), v0=t(v0), v1=t(v1), f0=t(f0),
        f1=t(f1), i0=t(i0), images=t(atlas), image_hw=t(hw),
        kinds_present=tuple(sorted(set(int(k)
                                       for k in kind[: len(textures)]))),
        noise_octaves=tuple(sorted(octaves)), custom_fns=tuple(custom_fns),
        marble_rows=tuple(i for i, tx in enumerate(textures)
                          if tx.kind == TEX_MARBLE),
    )


class _ImageGather(torch.autograd.Function):
    """``images[img_id, j, i]`` over flat lanes; the backward scatters the
    texel cotangents into the atlas with :func:`image_grad_pallas` (the
    atlas-gradient kernel on the card, its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, images, img_id, j, i):
        ctx.save_for_backward(img_id, j, i)
        ctx.atlas = tuple(images.shape[:3])
        return images[img_id, j, i]

    @staticmethod
    def backward(ctx, g):
        img_id, j, i = ctx.saved_tensors
        n_img, h, w = ctx.atlas
        g_img = image_grad_pallas(img_id, j, i, g.contiguous(), n_img=n_img,
                                  h=h, w=w)
        return g_img, None, None, None


def _image_gather(images, img_id, j, i):
    """Atlas texels ``images[img_id, j, i]`` ([..., 3]) for integer index
    tensors of any (common) shape; differentiable in ``images``."""
    shape = img_id.shape
    flat = lambda x: x.reshape(-1).long()
    out = _ImageGather.apply(images, flat(img_id), flat(j), flat(i))
    return out.reshape(shape + (3,))


def eval_texture(table: TextureTable, tex_ids, points, uvs,
                 marble_kernel: bool = False):
    """Evaluate texture ``tex_ids[...]`` at ``points[..., 3]`` and
    ``uvs[..., 2]``: colors [..., 3].  Branchless over the lanes; only
    the kinds present in the scene are computed.  ``uvs`` only feeds
    ``floor`` lookups, so it receives no gradient.

    ``marble_kernel=True`` (the forward render) sends marble stripes to
    :func:`marble_stripe_pallas` (flat [R, 3] points; the kernel on the
    card, not differentiable); otherwise they are plain torch, as the
    differentiable path needs.  It is the JAX package's
    ``marble_pallas=``."""
    tex_ids = tex_ids.long()
    kind = table.kind[tex_ids]
    c0 = table.c0[tex_ids]
    out = c0
    present = table.kinds_present
    if TEX_CHECKER in present:
        # floor(u * n_u) + floor(v * n_v) parity
        i = torch.floor(uvs[..., 0] * table.f0[tex_ids]).to(torch.int32)
        j = torch.floor(uvs[..., 1] * table.f1[tex_ids]).to(torch.int32)
        even = ((i + j) & 1) == 0
        checker = torch.where(even[..., None], c0, table.c1[tex_ids])
        out = torch.where((kind == TEX_CHECKER)[..., None], checker, out)
    if TEX_IMAGE in present:
        # i = floor(u w) mod w, j = floor((1 - v) h) mod h: (u, v) = (0, 0)
        # is the bottom-left corner, nearest texel, wrap-around
        # other kinds' i0 is no image id: they look up image 0
        img_id = torch.where(kind == TEX_IMAGE, table.i0[tex_ids], 0)
        hw = table.image_hw[img_id.long()]
        h, w = hw[..., 0], hw[..., 1]
        i = torch.remainder(torch.floor(uvs[..., 0] * w).to(torch.int32),
                            torch.clamp(w, min=1))
        j = torch.remainder(
            torch.floor((1.0 - uvs[..., 1]) * h).to(torch.int32),
            torch.clamp(h, min=1))
        texel = _image_gather(table.images, img_id, j, i)
        out = torch.where((kind == TEX_IMAGE)[..., None], texel, out)
    if TEX_NOISE in present:
        q = points * table.f0[tex_ids][..., None] + table.v0[tex_ids]
        n = torch.zeros(points.shape[:-1], dtype=DTYPE, device=points.device)
        octaves = table.i0[tex_ids]
        for k in table.noise_octaves:
            n = torch.where(octaves == k, fractal_noise(k, q), n)
        val = (n * (0.5 / 0.8) + 0.5)[..., None]
        noise_col = c0 + (table.c1[tex_ids] - c0) * val
        out = torch.where((kind == TEX_NOISE)[..., None], noise_col, out)
    if TEX_MARBLE in present:
        if marble_kernel:
            stripe = marble_stripe_pallas(table, tex_ids, points)
        else:
            d, sh = table.v0[tex_ids], table.v1[tex_ids]
            stripe = marble_stripe_values(
                table.f0[tex_ids], d[..., 0], d[..., 1], d[..., 2],
                sh[..., 0], sh[..., 1], sh[..., 2], points[..., 0],
                points[..., 1], points[..., 2])
        out = torch.where((kind == TEX_MARBLE)[..., None], stripe[..., None],
                          out)
    if TEX_CUSTOM in present:
        for fn_idx, fn in enumerate(table.custom_fns):
            val = torch.broadcast_to(
                torch.as_tensor(fn(points, uvs), dtype=DTYPE,
                                device=points.device), points.shape)
            sel = (kind == TEX_CUSTOM) & (table.i0[tex_ids] == fn_idx)
            out = torch.where(sel[..., None], val, out)
    return out
