"""Differentiable rendering utilities (``raytrace_tpu/diff/gradients.py``).

* :func:`partition` / :func:`combine` split a :class:`Scene` into its
  float tensors (the differentiable parameters, leaf tensors with
  ``requires_grad``) and its integer tables, and join them again.  Both
  halves keep the Scene's shape, with None where the other half holds
  the field.
* :func:`render_loss_wavefront` is the mean squared error of a render
  through the differentiable wavefront against a target, and
  :func:`loss_and_grads` its value and gradient in the ``partition``
  structure: zeros for float leaves the backward does not reach.
* :func:`finite_difference` is the central-difference harness of the
  gradient checks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

_TABLES = ("prims", "materials", "textures")


def map_scene(fn, *scenes):
    """A Scene whose every tensor field is ``fn`` of the same field of
    ``scenes`` (None fields stay None); static fields come from the
    first scene."""
    out = {}
    for name in _TABLES:
        tabs = [getattr(s, name) for s in scenes]
        kw = {}
        for f in dataclasses.fields(tabs[0]):
            vals = [getattr(t, f.name) for t in tabs]
            if any(isinstance(v, torch.Tensor) for v in vals):
                kw[f.name] = fn(*vals)
        out[name] = dataclasses.replace(tabs[0], **kw)
    return dataclasses.replace(scenes[0], **out)


def partition(scene):
    """``(params, statics)``: ``params`` holds the float tensors of the
    scene as leaf tensors with ``requires_grad`` (None for the integer
    tables), ``statics`` the integer tables (None for the floats)."""
    params = map_scene(lambda x: x.detach().requires_grad_(True)
                       if x.is_floating_point() else None, scene)
    statics = map_scene(lambda x: None if x.is_floating_point() else x,
                        scene)
    return params, statics


def combine(params, statics):
    """Inverse of :func:`partition`."""
    return map_scene(lambda p, s: s if p is None else p, params, statics)


def leaves(tree) -> dict:
    """``{"prims.p0": tensor, ...}``: the tensor fields of a Scene-shaped
    tree, in field order."""
    out = {}
    for name in _TABLES:
        tab = getattr(tree, name)
        for f in dataclasses.fields(tab):
            v = getattr(tab, f.name)
            if isinstance(v, torch.Tensor):
                out[f"{name}.{f.name}"] = v
    return out


def render_loss_wavefront(scene_params, scene_statics, settings, key,
                          pixel_ids, target, spp: int,
                          n_iters: int | None = None, remat: bool = True,
                          rotate_k: int = 1, skip_done: bool = False,
                          skip_chunk: int = 16, pixel_cost=None,
                          schedule: tuple | None = None):
    """MSE loss of the differentiable regenerative wavefront
    (``render/integrator.py:trace_wavefront_diff``, which routes each case
    to the fused or the unfused driver) against ``target[P, 3]``.
    Returns ``(loss, frac_done)``: the fraction of the requested samples
    completed within the iteration budget."""
    from ..render.integrator import trace_wavefront_diff
    from .fused_iter import MEDIA_GRADIENTS

    scene = combine(scene_params, scene_statics)
    if scene.volumes is not None:
        raise NotImplementedError(f"render_loss_wavefront: {MEDIA_GRADIENTS}")
    img, done = trace_wavefront_diff(scene, settings, key, pixel_ids, spp,
                                     n_iters=n_iters, remat=remat,
                                     rotate_k=rotate_k, skip_done=skip_done,
                                     skip_chunk=skip_chunk,
                                     pixel_cost=pixel_cost,
                                     schedule=schedule)
    loss = torch.mean((img - target) ** 2)
    return loss, torch.mean(done / spp)


def loss_and_grads(scene_params, scene_statics, *args, **kw):
    """``((loss, frac_done), grads)`` of :func:`render_loss_wavefront`;
    ``grads`` has the shape of ``scene_params``, zeros where the
    gradient does not reach."""
    loss, frac = render_loss_wavefront(scene_params, scene_statics, *args,
                                       **kw)
    named = {k: v for k, v in leaves(scene_params).items()
             if v.requires_grad}
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    by_id = {id(v): (torch.zeros_like(v) if g is None else g)
             for v, g in zip(named.values(), gs)}
    grads = map_scene(lambda x: by_id.get(id(x)), scene_params)
    return (loss.detach(), frac), grads


def finite_difference(f: Callable[[torch.Tensor], torch.Tensor], x,
                      eps: float = 1e-3):
    """Central finite differences of scalar ``f`` at 1-D ``x``."""
    x = torch.as_tensor(x)
    grads = []
    for i in range(x.numel()):
        dx = torch.zeros_like(x)
        dx[i] = eps
        grads.append((f(x + dx) - f(x - dx)) / (2 * eps))
    return torch.stack(grads)
