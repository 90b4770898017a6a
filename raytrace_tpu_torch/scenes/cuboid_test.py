"""cuboidTest (``scenes/cuboid_test.py``, reference
``test/Main.hs:119-126``): an earth-textured cuboid, rotated 60 degrees
about x and moved to z = -3.  300 px, 10 spp, depth 10, seed 0, written
linear; the image texture takes the split path (K8, K10)."""
from __future__ import annotations

from ._assets import earthmap
from ._common import scene_main

NAME = "cuboid_test"
SEED = 0
DEFAULTS = (300, 10, 10)
WRITER = "linear"


def world(rt):
    """``rt`` is the builder module (this package or the JAX one)."""
    globe = rt.lambertian(rt.image_texture(earthmap()))
    return rt.transform(
        rt.compose(rt.translate([0, 0, -3]), rt.rotate_x(rt.degrees(60))),
        rt.with_material(globe, rt.cuboid([-1, -2, -0.5], [1, 2, 0.5])))


def settings(rt, width: int = 300, spp: int = 10, depth: int = 10):
    return rt.CameraSettings(image_width=width, samples_per_pixel=spp,
                             max_depth=depth)


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, writer=WRITER, argv=argv)


if __name__ == "__main__":
    main()
