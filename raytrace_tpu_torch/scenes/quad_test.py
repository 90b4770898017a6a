"""quadTest (``scenes/quad_test.py``, reference ``test/Main.hs:88-117``):
five coloured parallelograms under the sky.  400 px, 100 spp, depth 50,
seed 0; kernel A."""
from __future__ import annotations

import numpy as np

from ._common import scene_main

NAME = "quad_test"
SEED = 0
DEFAULTS = (400, 100, 50)


def world(rt):
    def lam(c):
        return rt.lambertian(rt.constant_texture(c))

    return rt.group([
        rt.with_material(lam([1.0, 0.2, 0.2]),
                         rt.parallelogram([-3, -2, 5], [0, 0, -4], [0, 4, 0])),
        rt.with_material(lam([0.2, 1.0, 0.2]),
                         rt.parallelogram([-2, -2, 0], [4, 0, 0], [0, 4, 0])),
        rt.with_material(lam([0.2, 0.2, 1.0]),
                         rt.parallelogram([3, -2, 1], [0, 0, 4], [0, 4, 0])),
        rt.with_material(lam([1.0, 0.5, 0.0]),
                         rt.parallelogram([-2, 3, 1], [4, 0, 0], [0, 0, 4])),
        rt.with_material(lam([0.2, 0.8, 0.8]),
                         rt.parallelogram([-2, -3, 5], [4, 0, 0], [0, 0, -4])),
    ])


def settings(rt, width: int = 400, spp: int = 100, depth: int = 50):
    return rt.CameraSettings(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.sky, vfov=rt.degrees(80),
        center=np.asarray([0.0, 0.0, 9.0]),
        look_at=np.asarray([0.0, 0.0, 0.0]))


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, argv=argv)


if __name__ == "__main__":
    main()
