"""sphereUVTest (``scenes/sphere_uv_test.py``, reference
``test/Main.hs:128-134``): a 1 x 1 pixel, narrow-fov probe of the sphere
uv mapping, two earth-textured spheres in a row.  1 px, 1 spp, depth 10,
seed 12, written linear.  Its one pixel is a one-lane work queue, not a
multiple of 128 lanes, so it takes the generic bounce (the surface hit
through K8, the shading in torch), as the JAX package's does."""
from __future__ import annotations

from ._assets import earthmap
from ._common import scene_main

NAME = "sphere_uv_test"
SEED = 12
DEFAULTS = (1, 1, 10)
WRITER = "linear"


def world(rt):
    globe = rt.lambertian(rt.image_texture(earthmap()))
    return rt.with_material(globe, rt.group([
        rt.sphere([0, 0, -2], 0.4), rt.sphere([0, 0, -1], 0.4)]))


def settings(rt, width: int = 1, spp: int = 1, depth: int = 10):
    return rt.CameraSettings(image_width=width, samples_per_pixel=spp,
                             max_depth=depth, vfov=0.0001)


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, writer=WRITER, argv=argv)


if __name__ == "__main__":
    main()
