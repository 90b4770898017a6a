"""cornellSmoke (``scenes/cornell_smoke.py``, reference
``test/Main.hs:220-257``): the Cornell box with two constant-medium
blocks (absorbing black and scattering white).  600 px, 200 spp, depth
50, seed 0; 6 surface rows (a flat scan, K8) and two media of 6 boundary
rows each (K11)."""
from __future__ import annotations

import numpy as np

from ._common import scene_main

NAME = "cornell_smoke"
SEED = 0
DEFAULTS = (600, 200, 50)
LIGHT = ([113, 554, 127], [330, 0, 0], [0, 0, 305])


def world(rt):
    """The Cornell box's six walls (a larger, dimmer light) and, in place
    of its two boxes, a black smoke block and a white fog block of density
    0.01 (each rotated box lowers to six parallelograms).  ``rt`` is the
    builder module (this package or the JAX one)."""
    red = rt.lambertian(rt.constant_texture([0.65, 0.05, 0.05]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    green = rt.lambertian(rt.constant_texture([0.12, 0.45, 0.15]))
    light = rt.light_source(rt.constant_texture([7.0, 7.0, 7.0]))
    surfaces = [
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
    ]
    cube1 = rt.transform(
        rt.compose(rt.translate([265, 0, 295]), rt.rotate_y(rt.degrees(15))),
        rt.cuboid([0, 0, 0], [165, 330, 165]))
    cube2 = rt.transform(
        rt.compose(rt.translate([130, 0, 65]), rt.rotate_y(rt.degrees(-18))),
        rt.cuboid([0, 0, 0], [165, 165, 165]))
    return rt.group(surfaces + [
        rt.with_material(rt.pitch_black(), rt.constant_medium(0.01, cube1)),
        rt.with_material(rt.isotropic(rt.constant_texture(1.0)),
                         rt.constant_medium(0.01, cube2)),
    ])


def settings(rt, width: int = 600, spp: int = 200, depth: int = 50):
    """The Cornell view, black background, one redirect target on the
    light."""
    return rt.CameraSettings(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.const_background(0.0),
        vfov=rt.degrees(40), center=np.asarray([278.0, 278.0, -800.0]),
        look_at=np.asarray([278.0, 278.0, 0.0]),
    ).with_redirect_targets([(0.25,) + LIGHT])


def scene(width: int = 600, spp: int = 200, depth: int = 50, device="cuda"):
    """``(scene, settings)`` built with the port."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=device),
            settings(rt, width, spp, depth))


def build(args):
    return scene(args.width, args.spp, args.depth, args.device) + (SEED,)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, argv=argv)


if __name__ == "__main__":
    main()
