"""The image atlas's gradient: a scatter-add of per-lane texel cotangents
(``raytrace_tpu/ops/pallas/image_grad_kernel.py``: ``image_grad_pallas``,
kernel K13).

The backward of the texel gather ``images[img_id, j, i]`` adds each
lane's [3] cotangent into the [I, H, W, 3] atlas.  The TPU kernel turns
the scatter into row x column one-hot matrix products, because a TPU
scatter is slow; on the card the scatter is the simple form: one thread
per lane, an ``atomicAdd`` per channel (``csrc/image_grad_kernel.cu``).
Lanes whose cotangent is zero in all three channels write nothing, as
the TPU kernel's zero skip does: the image-only deferred multiply sends
every lane that does not sample the atlas to texel (0, 0) with a zero
cotangent, and most of the lanes would otherwise queue on one address.

* :func:`image_grad_plain` is the plain PyTorch version
  (``index_put_(accumulate=True)``);
* :func:`image_grad_pallas` launches the kernel for CUDA tensors and runs
  the plain version for CPU tensors.

Float atomics add in an order that varies from run to run, so the kernel
and the plain version agree to the rounding of each texel's sum, not bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch


def image_grad_plain(img_id, j, i, g, *, n_img: int, h: int, w: int):
    """Atlas cotangent [I, H, W, 3]: ``g[R, 3]`` added at
    ``(img_id, j, i)`` (1-D integer lanes)."""
    out = torch.zeros((n_img, h, w, 3), dtype=g.dtype, device=g.device)
    return out.index_put_((img_id.long(), j.long(), i.long()), g,
                          accumulate=True)


class _ImageGradArgs(ctypes.Structure):
    """Mirror of ``ImageGradArgs`` in csrc/image_grad_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("img", "j", "i", "g", "out")]
                + [("n_lanes", ctypes.c_int64)]
                + [(f, ctypes.c_int) for f in ("n_img", "h", "w")])


def image_grad_pallas(img_id, j, i, g, *, n_img: int, h: int, w: int):
    """Atlas cotangent [I, H, W, 3] from the 1-D lane indices ``img_id``,
    ``j``, ``i`` (any integer type; each within the atlas) and the texel
    cotangent ``g`` [R, 3] f32.

    CPU tensors run :func:`image_grad_plain`; CUDA tensors launch
    ``csrc/image_grad_kernel.cu`` (``image_grad_pallas.launches`` counts
    the launches)."""
    from .bounce_kernel import check_lanes
    dev = g.device
    if dev.type == "cpu":
        return image_grad_plain(img_id, j, i, g, n_img=n_img, h=h, w=w)
    if dev.type != "cuda":
        raise ValueError(f"image_grad_pallas: unsupported device {dev}")
    r = g.shape[0]
    if (g.dim() != 2 or g.shape[1] != 3 or g.dtype != torch.float32
            or not g.is_contiguous()):
        raise ValueError("g: need a contiguous f32 [R, 3] tensor")
    idx = [x.to(torch.int32).contiguous() for x in (img_id, j, i)]
    check_lanes(zip(("img_id", "j", "i"), idx), r, dev, torch.int32)
    from ._build import launch
    out = torch.zeros((n_img, h, w, 3), dtype=torch.float32, device=dev)
    args = _ImageGradArgs(*(x.data_ptr() for x in idx + [g, out]), r, n_img,
                          h, w)
    launch("rt_image_grad", args, dev)
    image_grad_pallas.launches += 1
    return out


image_grad_pallas.launches = 0
