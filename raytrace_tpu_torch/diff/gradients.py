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
* :func:`render_tile`, :func:`render_loss` and :func:`grad_render` are
  the bounded-depth path (``render/integrator.py:trace``): a tile's
  radiance averaged over samples, its loss against a target, and that
  loss's gradient.
* :func:`finite_difference` is the central-difference harness of the
  gradient checks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils import profiling

_TABLES = ("prims", "materials", "textures")


def _map_table(fn, tabs):
    """``tabs[0]`` with each tensor field ``fn`` of that field of
    ``tabs``."""
    kw = {}
    for f in dataclasses.fields(tabs[0]):
        vals = [getattr(t, f.name) for t in tabs]
        if any(isinstance(v, torch.Tensor) for v in vals):
            kw[f.name] = fn(*vals)
    return dataclasses.replace(tabs[0], **kw)


def _tables(tree):
    """``(path, table)`` of every table of a Scene-shaped tree: the three
    tables, then for a scene with media ``volumes`` (its density and
    material ids) and ``volumes.prims`` (its boundary rows), and for a
    scene with ellipsoids ``ellipsoids``."""
    out = [(name, getattr(tree, name)) for name in _TABLES]
    if tree.volumes is not None:
        out += [("volumes", tree.volumes), ("volumes.prims",
                                            tree.volumes.prims)]
    if tree.ellipsoids is not None:
        out.append(("ellipsoids", tree.ellipsoids))
    return out


def map_scene(fn, *scenes):
    """A Scene whose every tensor field is ``fn`` of the same field of
    ``scenes`` (None fields stay None), the media's and the ellipsoids'
    included; static fields come from the first scene."""
    out = {name: _map_table(fn, [getattr(s, name) for s in scenes])
           for name in _TABLES}
    vols = [s.volumes for s in scenes]
    if vols[0] is not None:
        out["volumes"] = dataclasses.replace(
            _map_table(fn, vols),
            prims=_map_table(fn, [v.prims for v in vols]))
    if scenes[0].ellipsoids is not None:
        out["ellipsoids"] = _map_table(fn, [s.ellipsoids for s in scenes])
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
    """``{"prims.p0": tensor, ..., "volumes.density": ...,
    "volumes.prims.p0": ..., "ellipsoids.radius": ...}``: the tensor
    fields of a Scene-shaped tree, in field order."""
    out = {}
    for name, tab in _tables(tree):
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

    scene = combine(scene_params, scene_statics)
    img, done = trace_wavefront_diff(scene, settings, key, pixel_ids, spp,
                                     n_iters=n_iters, remat=remat,
                                     rotate_k=rotate_k, skip_done=skip_done,
                                     skip_chunk=skip_chunk,
                                     pixel_cost=pixel_cost,
                                     schedule=schedule)
    loss = torch.mean((img - target) ** 2)
    return loss, torch.mean(done / spp)


def _grads(loss, scene_params):
    """The gradient of ``loss`` in the shape of ``scene_params``: zeros
    where it does not reach, None for the integer tables.  The backward
    runs under the span ``step.backward``."""
    named = {k: v for k, v in leaves(scene_params).items()
             if v.requires_grad}
    with profiling.span("step.backward"):
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
    by_id = {id(v): (torch.zeros_like(v) if g is None else g)
             for v, g in zip(named.values(), gs)}
    return map_scene(lambda x: by_id.get(id(x)), scene_params)


def loss_and_grads(scene_params, scene_statics, *args, **kw):
    """``((loss, frac_done), grads)`` of :func:`render_loss_wavefront`;
    ``grads`` has the shape of ``scene_params``, zeros where the
    gradient does not reach."""
    loss, frac = render_loss_wavefront(scene_params, scene_statics, *args,
                                       **kw)
    return (loss.detach(), frac), _grads(loss, scene_params)


def render_tile(scene, settings, key, pixel_ids, sample_ids,
                differentiable: bool = False):
    """Radiance [P, 3] of the pixels ``pixel_ids[P]`` averaged over the
    samples ``sample_ids[S]`` (the JAX package's ``render_tile``, which
    vmaps the samples): the P x S rays are traced as one batch by
    ``render/integrator.py:trace``, sample-major, each with the key of
    its (pixel, sample) and the camera's ray from that key's draw site 0,
    its bounces from draw site 7."""
    from ..core import rng
    from ..render.camera import camera_frame, generate_rays
    from ..render.integrator import trace
    dev = scene.device
    pix = pixel_ids.to(device=dev, dtype=torch.int32)
    smp = torch.as_tensor(sample_ids, dtype=torch.int32).to(dev)
    n_s, n_p = smp.shape[0], pix.shape[0]
    pix_all = pix.repeat(n_s)
    smp_all = smp.repeat_interleave(n_p)
    keys = rng.ray_keys_fast(key.to(dev), pix_all, smp_all)
    o, d, time = generate_rays(settings, camera_frame(settings), pix_all,
                               keys)
    rad = trace(scene, settings, o, d, time, rng.site(keys, 7),
                differentiable=differentiable)
    return rad.reshape(n_s, n_p, 3).mean(0)


def render_loss(scene_params, scene_statics, settings, key, pixel_ids,
                sample_ids, target):
    """The mean squared error of :func:`render_tile` (differentiable)
    against ``target[P, 3]``."""
    scene = combine(scene_params, scene_statics)
    img = render_tile(scene, settings, key, pixel_ids, sample_ids,
                      differentiable=True)
    return torch.mean((img - target.to(img.device)) ** 2)


def grad_render(scene, settings, key, pixel_ids, sample_ids, target):
    """``(loss, grads)``: :func:`render_loss` and its gradient in the
    shape of :func:`partition`'s params (zeros where it does not reach,
    None for the integer tables)."""
    params, statics = partition(scene)
    loss = render_loss(params, statics, settings, key, pixel_ids, sample_ids,
                       target)
    return loss.detach(), _grads(loss, params)


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
