"""demo1 (``scenes/demo1.py``, reference ``test/Main.hs:136-186``): the
RTIOW hero scene, 460 random small spheres (diffuse, metal, glass), three
big spheres and a mirror, thin-lens defocus, the sky.  1200 px, 500 spp,
depth 50, seed 1234.

The small spheres come from ``np.random.default_rng(1234)`` drawn in the
JAX driver's order, the lambertian ones appended after the loop and the
metal ones after them, so the compiled table equals the JAX package's row
for row: 512 dense rows, kernel A's ceiling (``MAX_SMEM_PRIMS``), scanned
in full by its general instantiation for every ray."""
from __future__ import annotations

import numpy as np

from ._common import scene_main

NAME = "demo1"
SEED = 1234
DEFAULTS = (1200, 500, 50)


def world(rt):
    ground = rt.lambertian(rt.constant_texture([0.5, 0.5, 0.5]))
    glass = rt.dielectric(1.5)
    diffuse = rt.lambertian(rt.constant_texture([0.4, 0.2, 0.1]))
    mirror_m = rt.mirror(rt.constant_texture([0.7, 0.6, 0.5]))
    items = [
        rt.with_material(ground, rt.sphere([0, -1000, 0], 1000)),
        rt.with_material(glass, rt.sphere([0, 1, 0], 1)),
        rt.with_material(diffuse, rt.sphere([-4, 1, 0], 1)),
        rt.with_material(mirror_m, rt.sphere([4, 1, 0], 1)),
    ]
    rg = np.random.default_rng(1234)
    lamb_centers, lamb_colors = [], []
    metal_items = []
    for a in range(-11, 11):
        for b in range(-11, 11):
            center = np.array([a + rg.uniform(0, 0.9), 0.2,
                               b + rg.uniform(0, 0.9)])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            choose = rg.uniform()
            if choose < 0.8:
                color = rg.uniform(0, 1, 3) * rg.uniform(0, 1, 3)
                lamb_centers.append(center)
                lamb_colors.append(color)
            elif choose < 0.95:
                fuzz = rg.uniform(0, 0.5)
                color = rg.uniform(0.5, 1, 3)
                metal_items.append(rt.with_material(
                    rt.metal(fuzz, rt.constant_texture(color)),
                    rt.sphere(center, 0.2)))
            else:
                items.append(rt.with_material(glass, rt.sphere(center, 0.2)))
    for c, col in zip(lamb_centers, lamb_colors):
        items.append(rt.with_material(
            rt.lambertian(rt.constant_texture(col)), rt.sphere(c, 0.2)))
    items.extend(metal_items)
    return rt.group(items)


def settings(rt, width: int = 1200, spp: int = 500, depth: int = 50):
    return rt.CameraSettings(
        aspect_ratio=16 / 9, image_width=width, samples_per_pixel=spp,
        max_depth=depth, vfov=rt.degrees(20),
        center=np.asarray([13.0, 2.0, 3.0]),
        look_at=np.asarray([0.0, 0.0, 0.0]),
        defocus_angle=rt.degrees(0.6), focus_dist=10.0, background=rt.sky)


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), accel="dense", device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, argv=argv)


if __name__ == "__main__":
    main()
