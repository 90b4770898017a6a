"""noiseTest (``scenes/noise_test.py``, reference ``test/Main.hs:63-86``):
a fractal-noise ground sphere (2 octaves) and a marble ball under the
sky.  400 px, 100 spp, depth 50, seed 0; 2 rows, the split path (K8,
K10, the marble stripes through K12)."""
from __future__ import annotations

from ._common import scene_main

NAME = "noise_test"
SEED = 0
DEFAULTS = (400, 100, 50)


def world(rt):
    """``rt`` is the builder module (this package or the JAX one)."""
    ground = rt.lambertian(rt.noise_texture(2, 2.0, [10, 0, 0], 0.0, 1.0))
    ball = rt.lambertian(rt.marble_texture([0, 0, 1], 4.0))
    return rt.group([rt.with_material(ground, rt.sphere([0, -1000, 0], 1000)),
                     rt.with_material(ball, rt.sphere([0, 2, 0], 2))])


def settings(rt, width: int = 400, spp: int = 100, depth: int = 50):
    """16:9, vfov 20 degrees from (13, 2, 3) to the origin, under the
    sky."""
    return rt.CameraSettings(
        aspect_ratio=16 / 9, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.sky, vfov=rt.degrees(20),
        center=[13.0, 2.0, 3.0], look_at=[0.0, 0.0, 0.0])


def scene(width: int = 400, spp: int = 100, depth: int = 50, device="cuda"):
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
