"""A configuration of triangle meshes and constant-density media
(``configs/pawn.json``) built through the renderer's public scene API:
each mesh of ``meshes`` (vertices and faces, frozen as data) becomes one
``Mesh``; an object names a mesh as a surface, or a ``medium`` of
``density`` bounded by a mesh, under a named material.  The camera is
``world.py``'s, on the background the configuration names.
"""
from __future__ import annotations

import numpy as np

from . import world as W


def _mesh(rt, m: dict):
    f = np.asarray(m["faces"], np.int64)
    return rt.triangle_mesh(rt.Mesh(
        vertices=np.asarray(m["vertices"], np.float64),
        uv=np.zeros((0, 2)), faces=f, uv_faces=np.full_like(f, -1)))


def _material(rt, m: dict):
    if m["kind"] == "isotropic":
        return rt.isotropic(rt.constant_texture(m["color"]))
    return W._material(rt, m)


def world(rt, config: dict):
    """The configuration's scene graph."""
    mats = {n: _material(rt, m) for n, m in config["materials"].items()}
    items = []
    for obj in config["objects"]:
        if "mesh" in obj:
            geom = _mesh(rt, config["meshes"][obj["mesh"]])
        elif "medium" in obj:
            med = obj["medium"]
            geom = rt.constant_medium(
                med["density"], _mesh(rt, config["meshes"][med["mesh"]]))
        else:
            raise ValueError(f"unknown object {sorted(obj)}")
        items.append(rt.with_material(mats[obj["material"]], geom))
    return rt.group(items)


def settings(rt, config: dict, **render):
    """``world.settings`` (``render`` overrides as there) on the
    configuration's named background (``gray_fade``)."""
    cam = config["camera"]
    s = W.settings(rt, dict(config, camera=dict(cam, background="sky")),
                   **render)
    return s.replace(background={"gray_fade": rt.gray_fade}[cam["background"]])


def scene(rt, config: dict, device):
    return rt.compile_scene(world(rt, config), accel=config["accel"],
                            device=device)
