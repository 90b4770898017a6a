"""Cornell box (``scenes/cornell_box.py``, reference
``test/Main.hs:188-218``): 600 px, 200 spp, depth 50, seed 234, with MIS
redirection toward the light quad.  ``--no-redirect`` disables the
redirection (the reference's timing comparison,
``test/Main.hs:381-383``).  18 parallelogram rows: kernel A's planar
scan."""
from __future__ import annotations

import numpy as np

from ._common import scene_main

NAME = "cornell_box"
SEED = 234
DEFAULTS = (600, 200, 50)
LIGHT = ([343, 554, 332], [-130, 0, 0], [0, 0, -105])


def world(rt):
    """6 walls + 2 rotated boxes (18 parallelograms)."""
    degrees = rt.degrees
    red = rt.lambertian(rt.constant_texture([0.65, 0.05, 0.05]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    green = rt.lambertian(rt.constant_texture([0.12, 0.45, 0.15]))
    light = rt.light_source(rt.constant_texture([15.0, 15.0, 15.0]))
    return rt.group([
        rt.with_material(green, rt.parallelogram([555, 0, 0], [0, 555, 0],
                                                 [0, 0, 555])),
        rt.with_material(red, rt.parallelogram([0, 0, 0], [0, 555, 0],
                                               [0, 0, 555])),
        rt.with_material(light, rt.parallelogram(*LIGHT)),
        rt.with_material(white, rt.parallelogram([0, 0, 0], [555, 0, 0],
                                                 [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([555, 555, 555],
                                                 [-555, 0, 0], [0, 0, -555])),
        rt.with_material(white, rt.parallelogram([0, 0, 555], [555, 0, 0],
                                                 [0, 555, 0])),
        rt.transform(rt.compose(rt.translate([265, 0, 295]),
                                rt.rotate_y(degrees(15))),
                     rt.with_material(white, rt.cuboid([0, 0, 0],
                                                       [165, 330, 165]))),
        rt.transform(rt.compose(rt.translate([130, 0, 65]),
                                rt.rotate_y(degrees(-18))),
                     rt.with_material(white, rt.cuboid([0, 0, 0],
                                                       [165, 165, 165]))),
    ])


def settings(rt, width: int = 600, spp: int = 200, depth: int = 50,
             redirect: bool = True):
    """The Cornell view, black background; one redirect target on the
    light (probability 0.25) unless ``redirect`` is False."""
    s = rt.CameraSettings(
        center=np.asarray([278.0, 278.0, -800.0]),
        look_at=np.asarray([278.0, 278.0, 0.0]),
        vfov=rt.degrees(40), aspect_ratio=1.0, image_width=width,
        samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.0))
    return s.with_redirect_targets([(0.25,) + LIGHT]) if redirect else s


def scene(width: int = 600, spp: int = 200, depth: int = 50, device="cuda",
          redirect: bool = True):
    """``(scene, settings)`` built with the port."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=device),
            settings(rt, width, spp, depth, redirect=redirect))


def build(args):
    return scene(args.width, args.spp, args.depth, args.device,
                 redirect=not getattr(args, "no_redirect", False)) + (SEED,)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, argv=argv, flags=(
        ("--no-redirect", dict(action="store_true",
                               help="render without MIS redirection")),))


if __name__ == "__main__":
    main()
