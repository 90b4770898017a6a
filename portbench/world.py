"""A configuration's world and camera built through the renderer's public
scene API (``raytrace_tpu_torch``: builder, materials, camera settings),
the system under test's own way in.

Each named material is one material object with one constant texture,
shared by every object that names it, as a scene script shares it.
"""
from __future__ import annotations

import numpy as np

_TRANSFORMS = ("translate", "rotate_y_deg")


def _material(rt, m: dict):
    kind = m["kind"]
    if kind == "dielectric":
        return rt.dielectric(m["ior"])
    tex = rt.constant_texture(m["color"])
    if kind == "lambertian":
        return rt.lambertian(tex)
    if kind == "light":
        return rt.light_source(tex)
    if kind == "mirror":
        return rt.mirror(tex)
    if kind == "metal":
        return rt.metal(m["fuzz"], tex)
    raise ValueError(f"unknown material kind {kind!r}")


def _matrix(rt, steps):
    mats = []
    for name, arg in steps:
        if name not in _TRANSFORMS:
            raise ValueError(f"unknown transform {name!r}")
        mats.append(rt.translate(arg) if name == "translate"
                    else rt.rotate_y(rt.degrees(arg)))
    return rt.compose(*mats)


def world(rt, config: dict):
    """The configuration's scene graph."""
    mats = {n: _material(rt, m) for n, m in config["materials"].items()}
    items = []
    for obj in config["objects"]:
        if "sphere" in obj:
            geom = rt.sphere(*obj["sphere"])
        elif "parallelogram" in obj:
            geom = rt.parallelogram(*obj["parallelogram"])
        elif "cuboid" in obj:
            geom = rt.cuboid(*obj["cuboid"])
        else:
            raise ValueError(f"unknown object {sorted(obj)}")
        geom = rt.with_material(mats[obj["material"]], geom)
        if obj.get("transform"):
            geom = rt.transform(_matrix(rt, obj["transform"]), geom)
        items.append(geom)
    return rt.group(items)


def settings(rt, config: dict, **render):
    """The camera settings; ``render`` overrides the configuration's
    ``render`` keys (``samples_per_pixel``, ``max_depth``, ``rr_depth``)
    and ``image_width``."""
    c = config["camera"]
    r = dict(config["render"])
    width = render.pop("image_width", c["image_width"])
    r.update(render)
    bg = c["background"]
    s = rt.CameraSettings(
        center=np.asarray(c["center"], np.float64),
        look_at=np.asarray(c["look_at"], np.float64),
        up=np.asarray(c.get("up", [0.0, 1.0, 0.0]), np.float64),
        vfov=rt.degrees(c["vfov_deg"]), aspect_ratio=c["aspect_ratio"],
        image_width=width, samples_per_pixel=r["samples_per_pixel"],
        max_depth=r["max_depth"],
        defocus_angle=rt.degrees(c.get("defocus_angle_deg", 0.0)),
        focus_dist=c.get("focus_dist", 10.0),
        background=rt.sky if bg == "sky"
        else rt.const_background(bg["constant"]),
        rr_depth=r.get("rr_depth"))
    if c.get("redirect"):
        s = s.with_redirect_targets([tuple(t) for t in c["redirect"]])
    return s


def scene(rt, config: dict, device):
    return rt.compile_scene(world(rt, config), accel=config["accel"],
                            device=device)
