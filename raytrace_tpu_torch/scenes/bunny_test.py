"""bunnyTest (``scenes/bunny_test.py``, reference ``test/Main.hs:362-378``):
the Stanford bunny (4,968 triangles from the reference's ``bunny.obj``),
centred by its bounding box, blue lambertian, on the gray fade.  600 px,
100 spp, depth 10, seed 55, written linear.  Raises
``FileNotFoundError`` without the reference's mesh
(``testing.bunny_standin_scene`` is a procedural stand-in)."""
from __future__ import annotations

import numpy as np

from ._assets import obj_path
from ._common import scene_main

NAME = "bunny_test"
SEED = 55
DEFAULTS = (600, 100, 10)
WRITER = "linear"


def world(rt, mesh):
    lo, hi = mesh.bounding_box()
    center = 0.5 * (lo + hi)
    mesh = mesh.transform_vertices(rt.compose(
        rt.rotate_y(rt.degrees(30)), rt.scale(12), rt.translate(-center)))
    return rt.with_material(
        rt.lambertian(rt.constant_texture([0.3, 0.3, 1.0])),
        rt.triangle_mesh(mesh))


def settings(rt, width: int = 600, spp: int = 100, depth: int = 10):
    return rt.CameraSettings(
        center=np.asarray([0.0, 0.5, 2.0]),
        look_at=np.asarray([0.0, 0.0, 0.0]),
        image_width=width, samples_per_pixel=spp, max_depth=depth,
        background=rt.gray_fade)


def build(args):
    import raytrace_tpu_torch as rt
    mesh = rt.read_obj(obj_path("bunny.obj"))
    return (rt.compile_scene(world(rt, mesh), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, writer=WRITER, argv=argv)


if __name__ == "__main__":
    main()
