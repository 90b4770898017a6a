"""pawnTest (``scenes/pawn_test.py``, reference ``test/Main.hs:323-344``):
the reference's ``pawn.obj`` as a glass shell over a red subsurface
medium bounded by the same mesh, on the gray fade.  500 px, 400 spp,
depth 20, seed 55, written linear.  Raises ``FileNotFoundError`` without
the reference's mesh (``testing.pawn_standin_scene`` is a procedural
stand-in)."""
from __future__ import annotations

import numpy as np

from ._assets import obj_path
from ._common import scene_main

NAME = "pawn_test"
SEED = 55
DEFAULTS = (500, 400, 20)
WRITER = "linear"


def world(rt, mesh):
    mesh = mesh.transform_vertices(rt.scale(100))
    return rt.group([
        rt.with_material(rt.dielectric(1.5), rt.triangle_mesh(mesh)),
        rt.with_material(rt.isotropic(rt.constant_texture([1.0, 0.0, 0.0])),
                         rt.constant_medium(5.0, rt.triangle_mesh(mesh))),
    ])


def settings(rt, width: int = 500, spp: int = 400, depth: int = 20):
    return rt.CameraSettings(
        center=np.asarray([0.0, 3.75, 5.0]),
        look_at=np.asarray([0.0, 2.75, 0.0]),
        image_width=width, vfov=rt.degrees(80), samples_per_pixel=spp,
        max_depth=depth, background=rt.gray_fade)


def build(args):
    import raytrace_tpu_torch as rt
    mesh = rt.read_obj(obj_path("pawn.obj"))
    return (rt.compile_scene(world(rt, mesh), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, writer=WRITER, argv=argv)


if __name__ == "__main__":
    main()
