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
from .scene.types import BVH, Ellipsoids, Primitives, Scene, Volumes
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
    ``prims``, ``materials`` and ``textures`` (and ``volumes``,
    ``ellipsoids`` and the BVH mode's ``bvh``, if any) are dataclasses of
    arrays."""
    d = {k: fields_to_numpy(getattr(scene, k))
         for k in ("prims", "materials", "textures")}
    vol = getattr(scene, "volumes", None)
    if vol is not None:
        vol = dict(fields_to_numpy(vol), prims=fields_to_numpy(vol.prims))
    d["volumes"] = vol
    ell = getattr(scene, "ellipsoids", None)
    d["ellipsoids"] = None if ell is None else fields_to_numpy(ell)
    bvh = getattr(scene, "bvh", None)
    d["bvh"] = None if bvh is None else fields_to_numpy(bvh)
    return d


def grads_to_numpy(grad_tree) -> dict:
    """``{"prims.p0": array, "materials.param": ..., "textures.c0": ...,
    "volumes.density": ..., "volumes.prims.p0": ...}``: the floating
    leaves of a Scene-shaped gradient tree whose ``prims``, ``materials``,
    ``textures`` (and ``volumes``, if any, with its ``prims``, and
    ``ellipsoids``, if any) are dataclasses (None and integer fields
    skipped), keyed by their field paths."""
    out = {}
    tabs = [(name, getattr(grad_tree, name))
            for name in ("prims", "materials", "textures")]
    vol = getattr(grad_tree, "volumes", None)
    if vol is not None:
        tabs += [("volumes", vol), ("volumes.prims", vol.prims)]
    ell = getattr(grad_tree, "ellipsoids", None)
    if ell is not None:
        tabs.append(("ellipsoids", ell))
    for name, tab in tabs:
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
    static fields as Python values), and optionally "volumes": {"prims":
    {...}, "density", "mat", "starts", "counts"} and "ellipsoids", keyed
    by the field names of :class:`Ellipsoids`, and "bvh", keyed by those
    of :class:`BVH` (a scene of the BVH accelerator mode; a malformed one
    raises ``ValueError``).  The scene lands on the card unless
    ``device`` says otherwise.  Custom textures cannot cross (see the
    module docstring)."""
    if d["textures"].get("custom_fns"):
        raise ValueError(
            "scene_from_numpy: custom textures are closures of the other "
            "implementation and cannot cross; build the scene with "
            "raytrace_tpu_torch.custom_texture")
    vol = d.get("volumes")
    if vol is not None:
        vol = _build(Volumes, dict(
            vol, prims=_build(Primitives, vol["prims"], device),
            starts=tuple(int(x) for x in vol["starts"]),
            counts=tuple(int(x) for x in vol["counts"])), device)
    ell = d.get("ellipsoids")
    if ell is not None:
        ell = _build(Ellipsoids, dict(ell, n=int(ell["n"]),
                                      has_motion=bool(ell["has_motion"])),
                     device)
    prims = _build(Primitives, d["prims"], device)
    bvh = d.get("bvh")
    if bvh is not None:
        bvh = _build(BVH, _bvh_fields(bvh, prims), device)
    return Scene(prims=prims,
                 materials=_build(MaterialTable, d["materials"], device),
                 textures=_build(TextureTable, d["textures"], device),
                 volumes=vol, ellipsoids=ell, bvh=bvh)


def _bvh_fields(d: dict, prims: Primitives) -> dict:
    """The fields of a :class:`BVH` from ``d``, checked: f32 [K, 3] boxes,
    i32 [K] start, count and skip, ``n_nodes == K``, leaves within the
    table's rows, escape indices in ``(i, K]``, and an unsegmented
    table (the BVH mode's rows are in leaf order)."""
    try:
        out = {k: np.asarray(d[k]) for k in ("lo", "hi", "start", "count",
                                              "skip")}
        k = int(d["n_nodes"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"scene_from_numpy: malformed bvh ({e!r})") from None
    shapes_ok = (all(out[f].shape == (k, 3) and out[f].dtype == np.float32
                     for f in ("lo", "hi"))
                 and all(out[f].shape == (k,) and out[f].dtype == np.int32
                         for f in ("start", "count", "skip")))
    if not shapes_ok or k < 1:
        raise ValueError("scene_from_numpy: malformed bvh: need f32 [K, 3] "
                         "lo and hi, i32 [K] start, count and skip, and "
                         "n_nodes == K >= 1")
    start, count, skip = out["start"], out["count"], out["skip"]
    n_rows = int(prims.kind.shape[0])
    leaf = count > 0
    if (prims.kind_segments is not None or (count < 0).any()
            or (leaf & ((start < 0) | (start + count > n_rows))).any()
            or (skip <= np.arange(k)).any() or (skip > k).any()):
        raise ValueError("scene_from_numpy: malformed bvh: leaves outside "
                         "the table's rows, escape indices outside (i, "
                         "n_nodes], or a kind-segmented table")
    out["n_nodes"] = k
    return out


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
