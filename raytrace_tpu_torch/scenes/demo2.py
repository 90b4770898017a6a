"""demo2 (``scenes/demo2.py``, reference ``test/Main.hs:259-321``):
everything at once.  400 px, 250 spp, depth 4, seed 1234; 1,407 surface
rows (1,006 spheres, 400 boxes, the light) in 1,536 kind-segmented rows
(the BVH walk K9), two sphere-bounded media (K11), the earth's image and
the marble sphere's stripes (K12), one rotated uv-textured sphere."""
from __future__ import annotations

import numpy as np

from ._assets import earthmap
from ._common import scene_main

NAME = "demo2"
SEED = 1234
DEFAULTS = (400, 250, 4)
# the light: corner and edges (the redirect target's too)
LIGHT = ([123, 554, 147], [300, 0, 0], [0, 0, 265])


def world(rt):
    """Its draws made in the JAX driver's order from
    ``np.random.default_rng(1234)``: 400 ground cuboids of random heights,
    a cloud of 1,000 white spheres rotated 15 degrees about y, a light
    with a redirect target, a moving sphere, two glass spheres (one the
    boundary of a blue subsurface medium), a metal sphere, the earth
    (:func:`._assets.earthmap`) on a sphere rotated a quarter turn about
    y (its uv in object space), a marble sphere, and a thin fog of radius
    5,000 around everything.  ``rt`` is the builder module (this package
    or the JAX one)."""
    ground = rt.lambertian(rt.constant_texture([0.48, 0.83, 0.53]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    rg = np.random.default_rng(1234)
    i, j = np.meshgrid(np.arange(20), np.arange(20), indexing="ij")
    x0 = (-1000 + i * 100).ravel()
    z0 = (-1000 + j * 100).ravel()
    y1 = rg.uniform(1, 101, 400)
    c0 = np.stack([x0, np.zeros(400), z0], -1)
    c1 = np.stack([x0 + 100, y1, z0 + 100], -1)
    boxes = rt.with_material(ground, rt.cuboids(c0, c1))
    centers = rg.uniform(0, 165, (1000, 3))
    balls = rt.transform(
        rt.compose(rt.translate([-100, 270, 395]),
                   rt.rotate_y(rt.degrees(15))),
        rt.with_material(white, rt.spheres(centers, np.full(1000, 10.0))))
    return rt.group([
        boxes, balls,
        rt.with_material(rt.light_source(rt.constant_texture([7.0, 7.0,
                                                              7.0])),
                         rt.parallelogram(*LIGHT)),
        rt.with_material(rt.lambertian(rt.constant_texture([0.7, 0.3, 0.1])),
                         rt.moving([0, 0, 0], [30, 0, 0],
                                   rt.sphere([400, 400, 200], 50))),
        rt.with_material(rt.dielectric(1.5), rt.sphere([260, 150, 45], 50)),
        rt.with_material(rt.dielectric(1.5), rt.sphere([360, 150, 145], 70)),
        rt.with_material(rt.metal(1.0, rt.constant_texture([0.8, 0.8, 0.9])),
                         rt.sphere([0, 150, 145], 50)),
        rt.transform(
            rt.compose(rt.translate([400, 0, 400]), rt.rotate_y(np.pi / 2)),
            rt.with_material(rt.lambertian(rt.image_texture(earthmap())),
                             rt.sphere([0, 200, 0], 100))),
        rt.with_material(rt.lambertian(rt.marble_texture([0, 0, 0.05], 4.0)),
                         rt.sphere([220, 280, 300], 80)),
        rt.with_material(rt.isotropic(rt.constant_texture(1.0)),
                         rt.constant_medium(0.0001,
                                            rt.sphere([0, 0, 0], 5000))),
        rt.with_material(rt.isotropic(rt.constant_texture([0.2, 0.4, 0.9])),
                         rt.constant_medium(0.2,
                                            rt.sphere([360, 150, 145], 70))),
    ])


def settings(rt, width: int = 400, spp: int = 250, depth: int = 4):
    """Black background, one redirect target on the light."""
    return rt.CameraSettings(
        center=np.asarray([478.0, 278.0, -600.0]),
        look_at=np.asarray([278.0, 278.0, 0.0]),
        vfov=rt.degrees(40), aspect_ratio=1.0, image_width=width,
        samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.0),
    ).with_redirect_targets([(0.25,) + LIGHT])


def scene(width: int = 400, spp: int = 250, depth: int = 4, device="cuda"):
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
