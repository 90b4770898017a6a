"""A configuration of spheres, boxes, a light, textured and moving
spheres and sphere-bounded media (``configs/demo2.json``) built through
the renderer's public scene API, as ``scenes/demo2.py`` builds it.

An object is one of ``cuboids`` (two corner arrays, frozen as data),
``spheres`` (centres, one radius), ``sphere``, ``parallelogram`` or a
``medium`` of ``density`` bounded by a sphere, under a named material;
``moving`` displaces it by a vector at time 0 and another at time 1,
``transform`` bakes ``world.py``'s steps into it.  A material is
``world.py``'s, or lambertian over an ``image`` of ``images``
(:func:`image`) or a ``marble`` texture, or ``isotropic`` with a
constant colour; each object gets a material object of its own, as the
scene script makes one for each (two objects that name ``glass`` are
two material rows).  The camera is ``world.py``'s.
"""
from __future__ import annotations

import numpy as np

from . import world as W


def image(spec: dict) -> np.ndarray:
    """The [height, width, 3] image of ``spec`` by its formula: ``base +
    land_delta * land``, ``land`` 1 where ``sin(u_freq u) cos(v_freq v)
    > threshold``, ``u`` running 0 to 1 along a row and ``v`` down the
    rows, in float64."""
    h, w = int(spec["height"]), int(spec["width"])
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    land = (np.sin(u * spec["u_freq"]) * np.cos(v * spec["v_freq"])
            > spec["threshold"]).astype(float)
    return np.stack([b + dl * land for b, dl in zip(spec["base"],
                                                    spec["land_delta"])],
                    axis=-1)


def _material(rt, m: dict, images: dict):
    if "image" in m:
        return rt.lambertian(rt.image_texture(image(images[m["image"]])))
    if "marble" in m:
        mb = m["marble"]
        return rt.lambertian(rt.marble_texture(mb["direction"], mb["freq"]))
    if m["kind"] == "isotropic":
        return rt.isotropic(rt.constant_texture(m["color"]))
    return W._material(rt, m)


def _geometry(rt, obj: dict):
    if "cuboids" in obj:
        c = obj["cuboids"]
        return rt.cuboids(np.asarray(c["corner0"], np.float64),
                          np.asarray(c["corner1"], np.float64))
    if "spheres" in obj:
        c = np.asarray(obj["spheres"]["centers"], np.float64)
        return rt.spheres(c, np.full(c.shape[0], obj["spheres"]["radius"]))
    if "sphere" in obj:
        return rt.sphere(*obj["sphere"])
    if "parallelogram" in obj:
        return rt.parallelogram(*obj["parallelogram"])
    if "medium" in obj:
        med = obj["medium"]
        return rt.constant_medium(med["density"], rt.sphere(*med["sphere"]))
    raise ValueError(f"unknown object {sorted(obj)}")


def world(rt, config: dict):
    """The configuration's scene graph."""
    images = config.get("images", {})
    items = []
    for obj in config["objects"]:
        mat = _material(rt, config["materials"][obj["material"]], images)
        geom = rt.with_material(mat, _geometry(rt, obj))
        if obj.get("moving"):
            geom = rt.moving(*obj["moving"], geom)
        if obj.get("transform"):
            geom = rt.transform(W._matrix(rt, obj["transform"]), geom)
        items.append(geom)
    return rt.group(items)


def settings(rt, config: dict, **render):
    """``world.settings`` (``render`` overrides as there)."""
    return W.settings(rt, config, **render)


def scene(rt, config: dict, device):
    return rt.compile_scene(world(rt, config), accel=config["accel"],
                            device=device)
