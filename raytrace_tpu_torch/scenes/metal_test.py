"""metalTest (``scenes/metal_test.py``, reference ``test/Main.hs:30-61``):
lambertian ground and centre, a dielectric sphere with a hollow-glass
bubble (ior 1/1.5), fuzzy metal, thin-lens defocus, the sky.  400 px,
100 spp, depth 50, seed 0; kernel A."""
from __future__ import annotations

import numpy as np

from ._common import scene_main

NAME = "metal_test"
SEED = 0
DEFAULTS = (400, 100, 50)


def world(rt):
    ground = rt.lambertian(rt.constant_texture([0.8, 0.8, 0.0]))
    center = rt.lambertian(rt.constant_texture([0.1, 0.2, 0.5]))
    left = rt.dielectric(1.5)
    bubble = rt.dielectric(1 / 1.5)
    right = rt.metal(1.0, rt.constant_texture([0.8, 0.6, 0.2]))
    return rt.group([
        rt.with_material(ground, rt.sphere([0, -100.5, -1], 100)),
        rt.with_material(center, rt.sphere([0, 0, -1.2], 0.5)),
        rt.with_material(left, rt.sphere([-1, 0, -1], 0.5)),
        rt.with_material(bubble, rt.sphere([-1, 0, -1], 0.4)),
        rt.with_material(right, rt.sphere([1, 0, -1], 0.5)),
    ])


def settings(rt, width: int = 400, spp: int = 100, depth: int = 50):
    return rt.CameraSettings(
        aspect_ratio=16 / 9, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.sky,
        center=np.asarray([-2.0, 2.0, 1.0]),
        look_at=np.asarray([0.0, 0.0, -1.0]),
        vfov=rt.degrees(20), defocus_angle=rt.degrees(10), focus_dist=3.4)


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, argv=argv)


if __name__ == "__main__":
    main()
