"""Scene and camera parameters carried across from plain data.

:func:`scene_from_numpy` and :func:`settings_from_numpy` take dicts of
numpy arrays and static Python values — what one extracts field by field
from another implementation's compiled scene and camera — and return the
port's objects, so two implementations can be fed the same scene.
:func:`grads_to_numpy` flattens a Scene-shaped gradient of either
implementation, so two can be compared leaf by leaf.

Image textures cross with the scene: the texture table's ``images`` atlas
and ``image_hw`` are arrays like the rest.  Custom textures do not: they
are closures of the other implementation (jnp functions), so a scene
with any raises; build it with the port's ``custom_texture`` instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .materials.materials import MaterialTable
from .render.camera import CameraSettings, const_background, gray_fade, sky
from .scene.types import Primitives, Scene
from .textures.textures import TextureTable


def fields_to_numpy(obj) -> dict:
    """The fields of a dataclass-like object: arrays (anything with a
    ``shape``) as numpy, everything else as it is."""
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def scene_to_numpy(scene) -> dict:
    """The input of :func:`scene_from_numpy` from a compiled scene whose
    ``prims``, ``materials`` and ``textures`` are dataclasses of arrays."""
    d = {k: fields_to_numpy(getattr(scene, k))
         for k in ("prims", "materials", "textures")}
    for extra in ("bvh", "volumes", "ellipsoids"):
        d[extra] = getattr(scene, extra, None)
    return d


def grads_to_numpy(grad_tree) -> dict:
    """``{"prims.p0": array, "materials.param": ..., "textures.c0": ...}``:
    the floating leaves of a Scene-shaped gradient tree whose ``prims``,
    ``materials`` and ``textures`` are dataclasses (None and integer
    fields skipped), keyed by the field paths of :func:`scene_to_numpy`."""
    out = {}
    for name in ("prims", "materials", "textures"):
        tab = getattr(grad_tree, name)
        for f in dataclasses.fields(tab):
            v = getattr(tab, f.name)
            if not hasattr(v, "shape"):
                continue
            a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            if np.issubdtype(a.dtype, np.floating):
                out[f"{name}.{f.name}"] = a
    return out


def _build(cls, d: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.array(v)).to(device)
        kw[f.name] = v
    return cls(**kw)


def scene_from_numpy(d: dict, device="cuda") -> Scene:
    """``d`` = {"prims": {...}, "materials": {...}, "textures": {...}},
    each keyed by the field names of :class:`Primitives`,
    :class:`MaterialTable` and :class:`TextureTable` (arrays as numpy,
    static fields as Python values).  The scene lands on the card unless
    ``device`` says otherwise.  Custom textures cannot cross (see the
    module docstring)."""
    if d["textures"].get("custom_fns"):
        raise ValueError(
            "scene_from_numpy: custom textures are closures of the other "
            "implementation and cannot cross; build the scene with "
            "raytrace_tpu_torch.custom_texture")
    for extra in ("bvh", "volumes", "ellipsoids"):
        if d.get(extra) is not None:
            raise NotImplementedError(
                f"scene_from_numpy: {extra} are not ported yet "
                "(ROADMAP M8, M10, M11)")
    return Scene(prims=_build(Primitives, d["prims"], device),
                 materials=_build(MaterialTable, d["materials"], device),
                 textures=_build(TextureTable, d["textures"], device))


def _background(bg):
    if callable(bg) and not isinstance(bg, (str, tuple)):
        return bg
    if bg == "sky":
        return sky
    if bg == "gray_fade":
        return gray_fade
    if isinstance(bg, tuple) and len(bg) == 2 and bg[0] == "const":
        return const_background(bg[1])
    raise ValueError(f"settings_from_numpy: unknown background {bg!r}")


def settings_from_numpy(d: dict) -> CameraSettings:
    """``d`` is keyed by the field names of :class:`CameraSettings`;
    ``background`` is "sky", "gray_fade", ("const", color) or a callable
    of the port."""
    kw = {}
    for f in dataclasses.fields(CameraSettings):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "background":
            v = _background(v)
        elif isinstance(v, np.ndarray):
            v = torch.from_numpy(np.asarray(v, np.float32).copy())
        kw[f.name] = v
    return CameraSettings(**kw)
