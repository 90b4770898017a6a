"""The reference README's example (``scenes/readme_example.py``, reference
``README.md:33-61``): a checker sphere, a blue ground sphere, a tilted
mirror parallelogram, white background.  600 px 16:9, 50 spp, depth 10,
seed 100, written linear (sRGB); kernel A."""
from __future__ import annotations

import numpy as np

from ._common import scene_main

NAME = "readme_example"
SEED = 100
DEFAULTS = (600, 50, 10)
WRITER = "linear"


def world(rt):
    return rt.group([
        rt.with_material(rt.lambertian(rt.checker_texture(20, 10, 0.2, 0.8)),
                         rt.sphere([0, 0, 0], 1)),
        rt.with_material(rt.lambertian(rt.constant_texture([0, 0.2, 0.5])),
                         rt.sphere([0, -1000, 0], 999)),
        rt.with_material(rt.mirror(rt.constant_texture(0.8)),
                         rt.parallelogram([-3.25, -1, -0.75],
                                          [1.25, 0, -1.25], [0, 2, 0])),
    ])


def settings(rt, width: int = 600, spp: int = 50, depth: int = 10):
    return rt.CameraSettings(
        center=np.asarray([-0.75, 0.0, 2.0]),
        look_at=np.asarray([0.0, 0.0, -1.0]),
        aspect_ratio=16 / 9, image_width=width, samples_per_pixel=spp,
        max_depth=depth)


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, writer=WRITER, argv=argv)


if __name__ == "__main__":
    main()
