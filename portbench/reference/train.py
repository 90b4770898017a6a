"""The reference of an inverse-rendering train step: the mean squared
error of a fixed-budget render against a target, its gradient with
respect to the scene's rows and colours, and Adam.

A lane traces the samples ``0 .. spp - 1`` of its pixel one after
another, one segment an iteration, for ``n_iters`` iterations: sample
``k`` is complete when the segments of samples ``0 .. k`` add up to at
most ``n_iters``.  A lane's value is the mean radiance of its complete
samples (0 where none is), and the loss the mean of ``(value -
target)^2`` over lanes and channels.  Lanes that share a pixel trace
the same paths, so each pixel is traced once.  The gradient is worked
out a block of pixels at a time.  Adam is written out (betas 0.9,
0.999, eps 1e-8, bias-corrected).
"""
from __future__ import annotations

import dataclasses

import torch

from . import tracer
from .scene import View, World

LEAVES = ("prims.p0", "prims.e1", "prims.e2", "textures.c0")


@dataclasses.dataclass
class StepOut:
    loss: float
    frac_done: float
    grads: dict


def loss_and_grads(world: World, view: View, leaves: tuple, key,
                   lane_pix: torch.Tensor, target: torch.Tensor, spp: int,
                   n_iters: int, *, dtype=torch.float32,
                   block_pixels: int = 1 << 15) -> StepOut:
    """``leaves``: ``(p0, e1, e2, c0)`` tensors with ``requires_grad``.
    ``lane_pix[L]`` the lanes' pixels, ``target[L, 3]``."""
    dev = lane_pix.device
    n_lanes = lane_pix.shape[0]
    tb = tracer.tables(world, dev, dtype, leaves=leaves)
    pix_all = torch.unique(lane_pix)
    # each lane's place among the traced pixels
    where = torch.searchsorted(pix_all, lane_pix)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    done_sum = 0
    grads = [torch.zeros_like(x) for x in leaves]
    scale = 1.0 / (n_lanes * 3)
    for b0 in range(0, pix_all.shape[0], block_pixels):
        pix = pix_all[b0:b0 + block_pixels]
        n = pix.shape[0]
        p_all = pix.repeat(spp).to(torch.int32)
        s_all = torch.arange(spp, device=dev, dtype=torch.int32)\
            .repeat_interleave(n)
        rad, segs = tracer.trace(tb, view, key, p_all, s_all, diff=True,
                                 dtype=dtype)
        segs = segs.reshape(spp, n)
        complete = (torch.cumsum(segs, 0) <= n_iters).to(dtype)
        done = complete.sum(0)
        acc = (rad.reshape(spp, n, 3) * complete[..., None]).sum(0)
        img = acc / torch.clamp(done, min=1.0)[:, None]
        sel = (where >= b0) & (where < b0 + n)
        lanes_img = img.index_select(0, where[sel] - b0)
        part = torch.sum((lanes_img - target[sel].to(dtype)) ** 2) * scale
        gs = torch.autograd.grad(part, leaves, allow_unused=True)
        for g_acc, g in zip(grads, gs):
            if g is not None:
                g_acc += g
        loss += part.detach().to(torch.float64)
        # lanes of this block: each counts its pixel's complete samples
        done_sum += int(done.index_select(0, where[sel] - b0).sum())
    return StepOut(loss=float(loss), frac_done=done_sum / (n_lanes * spp),
                   grads=dict(zip(LEAVES, grads)))


class Adam:
    """``torch.optim.Adam``'s update at its defaults, written out."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))


def steps(world: World, view: View, keys: list, lane_pix, target, spp: int,
          n_iters: int, lr: float, *, dtype=torch.float32, device=None):
    """Adam over the keys in turn from the world's parameters.  Returns
    ``(outs, first_grads, change)``: each step's :class:`StepOut`, the
    first step's gradient by leaf, and each leaf's change over the steps."""
    dev = device or lane_pix.device
    leaves = [x.to(device=dev, dtype=dtype).clone().requires_grad_(True)
              for x in (world.p0, world.e1, world.e2, world.c0)]
    start = [x.detach().clone() for x in leaves]
    opt = Adam(leaves, lr)
    outs = []
    for key in keys:
        out = loss_and_grads(world, view, tuple(leaves), key, lane_pix,
                             target, spp, n_iters, dtype=dtype)
        outs.append(out)
        opt.step([out.grads[k] for k in LEAVES])
    change = {k: (x.detach() - s) for k, x, s in zip(LEAVES, leaves, start)}
    return outs, outs[0].grads, change
