"""Scenes, lane states and kernel-versus-plain comparisons shared by
``chip_smoke.py`` and the tests.

* :func:`cornell_scene_and_settings` and :func:`all_materials_scene` build,
  with the port's own builder, the Cornell box of
  ``__graft_entry__._cornell_scene_and_settings`` and the scene of
  ``tests/test_bounce_kernel.py``; :func:`box_motion_scene` adds
  axis-aligned boxes (``PRIM_BOX`` rows), motion and the isotropic and
  anisotropic materials.
* Meshes: :func:`bunny_standin_scene`, a procedural stand-in of the
  Stanford bunny's size (4,968 triangles, 4,992 rows) with the bunny
  scene's material and camera; :func:`mesh_all_kinds_scene`, a height
  field of triangles with sphere, box and parallelogram rows of several
  materials (the scene of ``tests/test_lane_replay.py:_scene_mesh`` plus
  a box), optionally with the extras moving; :func:`uv_sphere`.  The
  ``*_world`` builders take the builder module as an argument, so the
  tests build the same scene with the JAX package.
* Rich textures: :func:`noise_test_scene` (``scenes/noise_test.py``: a
  noise-textured ground and a marble ball under the sky),
  :func:`image_grad_scene` (``tools/prof_texture_grad.py``'s
  image-textured scene), :func:`bunny_tex_scene` (``tools/prof_bunny_tex.py``
  with the stand-in mesh) and :func:`cuboid_test_world`
  (``scenes/cuboid_test.py``'s earth-textured cuboid, with
  :func:`earthmap`, the procedural earth of ``scenes/_assets.py``).
* Media: :func:`cornell_smoke_scene` (``scenes/cornell_smoke.py``: two
  smoke boxes in the Cornell box), :func:`pawn_standin_scene`
  (``scenes/pawn_test.py`` with a procedural pawn of about its size, one
  1,200-triangle mesh used as a glass shell and as the boundary of a red
  medium) and :func:`volume_test_world` (``tests/test_volume_kernel.py``'s
  sphere and box media); :func:`volume_rays` and
  :func:`pawn_inside_rays` make rays for the crossing kernels, and
  :func:`media_bounce_rays` the camera rays of a media scene with their
  second bounce.
* :data:`FWD_BWD` is the fwd+bwd configuration of ``bench.py`` and
  :func:`fwd_bwd_pixels` its lanes; :data:`MESH_FWD_BWD` the mesh
  configuration of ``tools/prof_bunny_grad.py``;
  :data:`IMAGE_GRAD_FWD_BWD` that of ``tools/prof_texture_grad.py``.
* :func:`bounce_inputs`, :func:`primary_bounce_inputs`,
  :func:`next_bounce_inputs`, :func:`iter_state` and :func:`fresh_carry`
  make lane inputs for the kernels: random ones from a numpy seed, or the
  ones the stationary driver gives them.
* :func:`compare_bounce`, :func:`compare_iter`, :func:`compare_bwd`,
  :func:`compare_nearest`, :func:`compare_nearest_flat`,
  :func:`compare_shade`, :func:`compare_marble`,
  :func:`compare_image_grad`, :func:`compare_crossings` and
  :func:`checked_launches` hold each kernel against its plain version on
  the same inputs; :func:`bwd_inputs` and :func:`k7_inputs` make K5's
  and K7's per-lane arguments from a real mid-render state,
  :func:`reduced_args` the reduced modes' from them,
  :func:`compare_reduced` holds a reduced mode against its plain version
  and against the kernel's per-lane mode, :func:`plain_backward` forces
  the fused iteration's backward onto the plain versions of K5 and of the
  atlas gradient, :func:`plain_kernels` forward and backward onto the
  plain versions, and :func:`per_lane_backward` the backward onto the
  per-lane modes of K5 and K7 with torch's gather and ``index_add_``
  around them (the backward before the reduction moved into the kernels).

Tolerances: alive/miss/winner index (and sample/depth/died for kernel B,
winner index, flags and material for the nearest kernel, the front flags
of the crossing kernels) equal on every lane; floats within ``ATOL +
RTOL * |plain|``
(``tests/test_bounce_kernel.py``).  K5 and K7 against their plain
versions: every per-lane gradient within ``BWD_RTOL * (|plain| +
max|plain| over its output + max|plain| over its lane)``.  The forward replay rounds alike
(``--fmad=false``, same association), but the hand-derived adjoint sums
the chain-rule terms in another order than torch autograd, so a gradient
that is a sum of terms of both signs keeps an error of a few ulps of its
largest term, not of its value; the largest gradients of the output and
of the lane bound those terms.  The atlas gradient against its plain
version: each texel within ``n * 2^-23 * sum |g|`` over its ``n``
contributions ``g`` (:func:`image_grad_errs`), the largest difference
two summation orders of the same terms can have; float atomics add in
an order that changes from run to run.  The reduced row gradients of K5
and K7 (each entry a sum over the ``n`` lanes whose winner, material or
texture it is) within the same ``n * 2^-23 * sum |g|`` of a float64 sum
of the per-lane row gradients that went into them
(:func:`row_grads_errs`); against the plain version, whose per-lane
gradients differ by the tolerance above, within that plus the sum of the
per-lane tolerances.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# kernel vs plain: the tolerance of tests/test_bounce_kernel.py
ATOL, RTOL = 2e-3, 1e-3
# 30-iteration agreement: the statistics of tests/test_fused_iter.py
FRAC_LANES, MEAN_RTOL = 0.02, 2e-3
# outputs compared exactly: kernel A's alive, miss, winner index; kernel
# B's alive, sample, depth, died, winner index
BOUNCE_INT_ROWS = (12, 13, 14)
ITER_INT_ROWS = (13, 14, 15, 16, 17)
# the nearest kernel's winner index, front | sphere << 1 and material
NEAREST_INT_ROWS = (1, 5, 8)

# K5 vs its plain version (see above)
BWD_RTOL = 1e-4
# the atlas gradient vs a sum of the same terms in another order: per
# contribution to a texel, this share of the texel's sum of |terms|
SCATTER_RTOL = 2.0 ** -23

ALL_MATERIAL_TARGETS = [(0.25, [-1, 9, -1], [2, 0, 0], [0, 0, 2]),
                        (0.15, [5, 9, 5], [1, 0, 0], [0, 0, 1])]

# bench.py's fwd+bwd on the Cornell box at 600 x 600, depth 50: RR from
# depth 2, 2^18 lanes x 64 spp, 205 iterations then 25 at 2^14 and 100 at
# 2^12 lanes
FWD_BWD = dict(rr_depth=2, lanes=1 << 18, spp=64, n_iters=205,
               schedule=((25, 1 << 14), (100, 1 << 12)))
# the unfused fwd+bwd on the same Cornell box, lanes and target, as the
# JAX package's tools run it: route 8, tools/prof_diff_rot.py, rotate_k 8
# for 195 iterations without remat; route 9, tools/prof_completion.py,
# rotate_k 4 balanced by lane_cost_estimate(spp_est=4) for 184 iterations
FWD_BWD_ROT8 = dict(rr_depth=2, lanes=1 << 18, spp=64, n_iters=195,
                    rotate_k=8)
FWD_BWD_BAL4 = dict(rr_depth=2, lanes=1 << 18, spp=64, n_iters=184,
                    rotate_k=4, spp_est=4)


def cornell_scene_and_settings(width=16, spp=4, depth=6, device="cuda"):
    """The Cornell box of ``__graft_entry__._cornell_scene_and_settings``,
    built with the port: 6 walls + 2 rotated boxes (18 parallelograms),
    one MIS redirect target on the light, black background."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch import degrees

    red = rt.lambertian(rt.constant_texture([0.65, 0.05, 0.05]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    green = rt.lambertian(rt.constant_texture([0.12, 0.45, 0.15]))
    light = rt.light_source(rt.constant_texture([15.0, 15.0, 15.0]))
    world = rt.group([
        rt.with_material(green, rt.parallelogram([555, 0, 0], [0, 555, 0],
                                                 [0, 0, 555])),
        rt.with_material(red, rt.parallelogram([0, 0, 0], [0, 555, 0],
                                               [0, 0, 555])),
        rt.with_material(light, rt.parallelogram([343, 554, 332],
                                                 [-130, 0, 0], [0, 0, -105])),
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
    scene = rt.compile_scene(world, device=device)
    settings = rt.CameraSettings(
        center=[278.0, 278.0, -800.0], look_at=[278.0, 278.0, 0.0],
        vfov=degrees(40), aspect_ratio=1.0, image_width=width,
        samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.0),
    ).with_redirect_targets([(0.25, [343, 554, 332], [-130, 0, 0],
                              [0, 0, -105])])
    return scene, settings


def all_materials_scene(device="cuda"):
    """The scene of tests/test_bounce_kernel.py: eight materials on
    spheres and parallelograms, plus a triangle."""
    import raytrace_tpu_torch as rt
    mats = [
        rt.lambertian(rt.checker_texture(4, 4, [0.2, 0.4, 0.6],
                                         [0.9, 0.8, 0.1])),
        rt.mirror(rt.constant_texture([0.9, 0.8, 0.7])),
        rt.metal(0.3, rt.constant_texture([0.8, 0.6, 0.2])),
        rt.dielectric(1.5),
        rt.light_source(rt.constant_texture([5.0, 4.0, 3.0])),
        rt.transparent(rt.constant_texture([0.5, 0.9, 0.5])),
        rt.lommel_seeliger(rt.constant_texture(0.8)),
        rt.pitch_black(),
    ]
    geoms = []
    rg = np.random.default_rng(0)
    for i, m in enumerate(mats):
        geoms.append(rt.with_material(m, rt.sphere(rg.uniform(-6, 6, 3),
                                                   1.2)))
        geoms.append(rt.with_material(
            mats[(i + 3) % len(mats)],
            rt.parallelogram(rg.uniform(-6, 6, 3), [2, 0, 0], [0, 2, 0.3])))
    geoms.append(rt.with_material(mats[0], rt.triangle(
        [-8, -2, -3], [-5, -2, -3], [-6.5, 1, -3])))
    return rt.compile_scene(rt.group(geoms), accel="dense", device=device)


def box_motion_scene(device="cuda"):
    """``(scene, settings)``: axis-aligned boxes (one row each), moving
    boxes and spheres, with the isotropic and anisotropic materials and a
    checker box (the ``PRIM_BOX`` and motion branches of the bounce),
    under the sky, seen by a 64-pixel camera."""
    import raytrace_tpu_torch as rt
    checker = rt.checker_texture(3, 2, [0.8, 0.2, 0.1], [0.1, 0.3, 0.8])
    mats = [rt.lambertian(checker),
            rt.isotropic(rt.constant_texture([0.5, 0.6, 0.7])),
            rt.anisotropic(0.4, rt.constant_texture([0.6, 0.4, 0.5])),
            rt.metal(0.2, rt.constant_texture([0.9, 0.8, 0.6])),
            rt.dielectric(1.4),
            rt.lommel_seeliger(rt.constant_texture([0.4, 0.6, 0.2])),
            rt.light_source(rt.constant_texture([4.0, 3.0, 2.0]))]
    rg = np.random.default_rng(3)
    geoms = []
    for i, m in enumerate(mats):
        c = rg.uniform(-5, 5, 3)
        box = rt.cuboid(c, c + rg.uniform(0.8, 2.0, 3))
        if i % 2:
            box = rt.moving([0, 0, 0], rg.uniform(-0.5, 0.5, 3), box)
        geoms.append(rt.with_material(m, box))
        sph = rt.sphere(rg.uniform(-5, 5, 3), 0.9)
        if i % 3 == 0:
            sph = rt.moving(rg.uniform(-0.3, 0.3, 3),
                            rg.uniform(-0.3, 0.3, 3), sph)
        geoms.append(rt.with_material(mats[(i + 2) % len(mats)], sph))
    geoms.append(rt.with_material(mats[0], rt.parallelogram(
        [-8, -6, -8], [16, 0, 0], [0, 0, 16])))
    geoms.append(rt.with_material(mats[5], rt.triangle(
        [-8, -2, -3], [-5, -2, -3], [-6.5, 1, -3])))
    s = rt.CameraSettings(center=[0.0, 3.0, 16.0], look_at=[0.0, 0.0, 0.0],
                          vfov=0.9, image_width=64, max_depth=10,
                          background=rt.sky)
    return rt.compile_scene(rt.group(geoms), accel="dense",
                            device=device), s


# tools/prof_texture_grad.py's textured fwd+bwd: 2^17 lanes (pixels
# 0 .. 2^17 modulo the 512 x 512 image) x 16 spp, 80 iterations, no remat
IMAGE_GRAD_FWD_BWD = dict(lanes=1 << 17, spp=16, n_iters=80)


def noise_test_world(rt):
    """``scenes/noise_test.py``'s world: a fractal-noise ground sphere
    (2 octaves) and a marble ball.  ``rt`` is the builder module (this
    package or the JAX one)."""
    ground = rt.lambertian(rt.noise_texture(2, 2.0, [10, 0, 0], 0.0, 1.0))
    ball = rt.lambertian(rt.marble_texture([0, 0, 1], 4.0))
    return rt.group([rt.with_material(ground, rt.sphere([0, -1000, 0], 1000)),
                     rt.with_material(ball, rt.sphere([0, 2, 0], 2))])


def noise_test_settings(rt, width: int = 400, spp: int = 100,
                        depth: int = 50):
    """``scenes/noise_test.py``'s camera: 16:9, vfov 20 degrees from
    (13, 2, 3) to the origin, under the sky."""
    return rt.CameraSettings(
        aspect_ratio=16 / 9, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.sky, vfov=rt.degrees(20),
        center=[13.0, 2.0, 3.0], look_at=[0.0, 0.0, 0.0])


def noise_test_scene(width: int = 400, spp: int = 100, depth: int = 50,
                     device="cuda"):
    """``(scene, settings)`` of ``scenes/noise_test.py`` (rendered there at
    400 px wide, 100 spp, depth 50, seed 0): 2 rows, a flat scan."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(noise_test_world(rt), device=device),
            noise_test_settings(rt, width, spp, depth))


def image_grad_world(rt):
    """``tools/prof_texture_grad.py``'s textured world: a sphere with a
    128 x 256 linspace image, a gray ground sphere and a light."""
    img = np.linspace(0, 1, 256 * 128 * 3).reshape(128, 256, 3)
    return rt.group([
        rt.with_material(rt.lambertian(rt.image_texture(img)),
                         rt.sphere([0, 0, -3], 1.0)),
        rt.with_material(rt.lambertian(rt.constant_texture(0.6)),
                         rt.sphere([0, -101, -3], 100.0)),
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-2, 4, -5], [4, 0, 0], [0, 0, 4])),
    ])


def image_grad_scene(width: int = 512, device="cuda"):
    """``(scene, settings)`` of ``tools/prof_texture_grad.py``: 512 x 512,
    16 spp, depth 8, RR from depth 2, constant background 0.1."""
    import raytrace_tpu_torch as rt
    scene = rt.compile_scene(image_grad_world(rt), device=device)
    settings = rt.CameraSettings(
        image_width=width, aspect_ratio=1.0, samples_per_pixel=16,
        max_depth=8, rr_depth=2, background=rt.const_background(0.1))
    return scene, settings


def earthmap():
    """The procedural earth of ``scenes/_assets.py:earthmap`` (its
    fallback when the reference image is absent): [256, 512, 3], blue with
    lighter land blobs."""
    h, w = 256, 512
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    land = (np.sin(u * 14) * np.cos(v * 9) > 0.3).astype(float)
    return np.stack([0.1 + 0.4 * land, 0.2 + 0.5 * land, 0.6 - 0.4 * land],
                    axis=-1)


def cuboid_test_world(rt):
    """``scenes/cuboid_test.py``'s world: an earth-textured cuboid, rotated
    60 degrees about x and moved to z = -3."""
    globe = rt.lambertian(rt.image_texture(earthmap()))
    return rt.transform(
        rt.compose(rt.translate([0, 0, -3]), rt.rotate_x(np.pi / 3)),
        rt.with_material(globe, rt.cuboid([-1, -2, -0.5], [1, 2, 0.5])))


# tools/prof_bunny_grad.py's fwd+bwd on the bunny (here its stand-in) at
# 600 x 600, depth 10: RR from depth 2, 2^17 lanes (pixels 0 .. 2^17
# modulo the image) x 16 spp, 30 iterations then 12 at 2^15 and 30 at
# 2^13 lanes
MESH_FWD_BWD = dict(rr_depth=2, lanes=1 << 17, spp=16, n_iters=30,
                    schedule=((12, 1 << 15), (30, 1 << 13)))


def uv_sphere(n_lat: int, n_lon: int):
    """Lat-lon unit sphere: vertices [V, 3] and 2 * n_lon * (n_lat - 1)
    triangles [F, 3] (the pole quads collapse into single triangles), as
    ``tools/bench_bigmesh.py:uv_sphere``."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")        # [n_lat+1, n_lon]
    v = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                  np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    vid = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
    f = []
    for i in range(n_lat):
        a = vid[i]
        b = vid[i + 1]
        an = np.roll(a, -1)
        bn = np.roll(b, -1)
        if i > 0:
            f.append(np.stack([a, b, an], -1))
        if i < n_lat - 1:
            f.append(np.stack([an, b, bn], -1))
    return v, np.concatenate(f).astype(np.int64)


def bunny_standin_world(rt, texture=None):
    """The bunny scene's world with a procedural mesh of the bunny's size:
    ``uv_sphere(47, 54)`` (4,968 triangles) with each vertex moved to
    radius 0.9 * (1 + 0.15 sin(5 theta) cos(4 phi)), a non-convex lobed
    surface that shades itself; no uv; a lambertian of ``texture`` (the
    bunny's blue by default).  ``rt`` is the builder module (this package
    or the JAX one)."""
    v, f = uv_sphere(47, 54)
    th = np.linspace(0, np.pi, 48)
    ph = np.linspace(0, 2 * np.pi, 54, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = (0.9 * (1.0 + 0.15 * np.sin(5.0 * tt) * np.cos(4.0 * pp))).ravel()
    mesh = rt.Mesh(vertices=v * r[:, None], uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full_like(f, -1))
    if texture is None:
        texture = rt.constant_texture([0.3, 0.3, 1.0])
    return rt.with_material(rt.lambertian(texture), rt.triangle_mesh(mesh))


def bunny_standin_scene(width: int = 600, spp: int = 16, depth: int = 10,
                        device="cuda"):
    """``(scene, settings)``: the stand-in mesh (4,992 rows) under the
    camera of ``scenes/bunny_test.py`` (center (0, 0.5, 2), looking at the
    origin, gray fade, depth 10)."""
    import raytrace_tpu_torch as rt
    scene = rt.compile_scene(bunny_standin_world(rt), device=device)
    settings = rt.CameraSettings(
        center=[0.0, 0.5, 2.0], look_at=[0.0, 0.0, 0.0], image_width=width,
        samples_per_pixel=spp, max_depth=depth, background=rt.gray_fade)
    return scene, settings


def bunny_tex_scene(width: int = 600, device="cuda"):
    """``(scene, settings)`` of ``tools/prof_bunny_tex.py`` with the
    stand-in mesh: its ``uniform(0.1, 0.9, (128, 256, 3))`` image (numpy
    seed 0) on the mesh, the bunny's camera, gray fade, 16 spp, depth 10,
    RR from depth 2."""
    import raytrace_tpu_torch as rt
    img = np.random.RandomState(0).uniform(0.1, 0.9, (128, 256, 3))
    scene = rt.compile_scene(bunny_standin_world(
        rt, rt.image_texture(img.astype(np.float32))), device=device)
    settings = rt.CameraSettings(
        center=[0.0, 0.5, 2.0], look_at=[0.0, 0.0, 0.0], image_width=width,
        samples_per_pixel=16, max_depth=10, rr_depth=2,
        background=rt.gray_fade)
    return scene, settings


def mesh_all_kinds_world(rt, n_grid: int = 18, moving: bool = False):
    """A height field of ``2 n_grid^2`` triangles plus a metal sphere, a
    checker parallelogram, a light, a dielectric sphere and a box (the
    scene of ``tests/test_lane_replay.py:_scene_mesh`` plus the box); with
    ``moving`` the extras sit in a ``moving`` block.  ``rt`` is the
    builder module (this package or the JAX one)."""
    xs = np.linspace(-3, 3, n_grid + 1)
    zs = np.linspace(-3, 3, n_grid + 1)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = 0.4 * np.sin(xx * 1.3) * np.cos(zz * 1.1)
    v = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    vid = np.arange((n_grid + 1) ** 2).reshape(n_grid + 1, n_grid + 1)
    f = []
    for i in range(n_grid):
        for j in range(n_grid):
            a, b = vid[i, j], vid[i + 1, j]
            c, d = vid[i, j + 1], vid[i + 1, j + 1]
            f += [[a, b, c], [b, d, c]]
    mesh = rt.Mesh(vertices=v, uv=np.zeros((0, 2)),
                   faces=np.asarray(f, np.int64),
                   uv_faces=np.full((len(f), 3), -1, np.int64))
    tex_checker = rt.checker_texture(3.0, 4.0, [0.8, 0.2, 0.1],
                                     [0.1, 0.2, 0.8])
    extras = [
        rt.with_material(rt.metal(0.2, rt.constant_texture([0.8, 0.6, 0.4])),
                         rt.sphere([0.0, 1.5, 0.0], 0.7)),
        rt.with_material(rt.lambertian(tex_checker),
                         rt.parallelogram([-4, -2, -4], [8, 0, 0],
                                          [0, 0, 8])),
        rt.with_material(rt.light_source(rt.constant_texture([4.0, 3.0, 2.0])),
                         rt.parallelogram([-1, 4, -1], [2, 0, 0],
                                          [0, 0, 2])),
        rt.with_material(rt.dielectric(1.5),
                         rt.sphere([1.5, 0.8, 1.0], 0.5)),
        rt.with_material(rt.lambertian(rt.constant_texture([0.3, 0.7, 0.4])),
                         rt.cuboid([-2.2, -0.3, 1.2], [-1.2, 0.9, 2.2])),
    ]
    extras = rt.group(extras)
    if moving:
        extras = rt.moving([0.0, 0.0, 0.0], [0.3, 0.2, -0.25], extras)
    return rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture([0.7, 0.5, 0.3])),
                         rt.triangle_mesh(mesh)), extras])


def mesh_all_kinds_scene(n_grid: int = 18, moving: bool = False,
                         width: int = 32, device="cuda"):
    """``(scene, settings)``: :func:`mesh_all_kinds_world` (n_grid 18:
    648 triangles, over 512 rows) seen from (0, 2, 8) under the sky,
    depth 6."""
    import raytrace_tpu_torch as rt
    scene = rt.compile_scene(mesh_all_kinds_world(rt, n_grid, moving),
                             device=device)
    settings = rt.CameraSettings(
        center=[0.0, 2.0, 8.0], look_at=[0.0, 0.0, 0.0], image_width=width,
        max_depth=6, background=rt.sky)
    return scene, settings


def cornell_smoke_world(rt):
    """``scenes/cornell_smoke.py``'s world: the Cornell box's six walls
    (a larger, dimmer light) and, in place of its two boxes, a black
    smoke block and a white fog block of density 0.01 (each rotated box
    lowers to six parallelograms).  ``rt`` is the builder module (this
    package or the JAX one)."""
    red = rt.lambertian(rt.constant_texture([0.65, 0.05, 0.05]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    green = rt.lambertian(rt.constant_texture([0.12, 0.45, 0.15]))
    light = rt.light_source(rt.constant_texture([7.0, 7.0, 7.0]))
    surfaces = [
        rt.with_material(green, rt.parallelogram([555, 0, 0], [0, 555, 0],
                                                 [0, 0, 555])),
        rt.with_material(red, rt.parallelogram([0, 0, 0], [0, 555, 0],
                                               [0, 0, 555])),
        rt.with_material(light, rt.parallelogram([113, 554, 127],
                                                 [330, 0, 0], [0, 0, 305])),
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


def cornell_smoke_settings(rt, width: int = 600, spp: int = 200,
                           depth: int = 50):
    """``scenes/cornell_smoke.py``'s camera: the Cornell view, black
    background, one redirect target on the light."""
    return rt.CameraSettings(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.const_background(0.0),
        vfov=rt.degrees(40), center=np.asarray([278.0, 278.0, -800.0]),
        look_at=np.asarray([278.0, 278.0, 0.0]),
    ).with_redirect_targets([(0.25, [113, 554, 127], [330, 0, 0],
                              [0, 0, 305])])


def cornell_smoke_scene(width: int = 600, spp: int = 200, depth: int = 50,
                        device="cuda"):
    """``(scene, settings)`` of ``scenes/cornell_smoke.py`` (rendered there
    at 600 x 600, 200 spp, depth 50, seed 0): 6 surface rows (a flat
    scan) and two media of 6 boundary rows each (kernel K11)."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(cornell_smoke_world(rt), device=device),
            cornell_smoke_settings(rt, width, spp, depth))


# the stand-in pawn's profile: (radius, height) from the bottom pole to
# the top one -- base, waist, collar, head
PAWN_PROFILE = ((0.0, 0.0), (1.55, 0.0), (1.55, 0.3), (1.3, 0.45),
                (1.15, 0.7), (0.85, 1.0), (0.62, 1.5), (0.52, 2.2),
                (0.5, 2.8), (0.9, 3.05), (0.9, 3.25), (0.5, 3.4),
                (0.62, 3.75), (0.88, 4.2), (0.92, 4.65), (0.7, 5.15),
                (0.0, 5.5))
PAWN_AROUND = 40


def pawn_standin_mesh():
    """``(vertices [V, 3], faces [F, 3])``: :data:`PAWN_PROFILE` revolved
    about the y axis in :data:`PAWN_AROUND` steps, a closed, non-convex
    surface 5.5 units tall standing on y = 0, of 1,200 triangles wound
    outward (fans at the poles, two triangles per quad between rings)."""
    ang = np.linspace(0.0, 2.0 * np.pi, PAWN_AROUND, endpoint=False)
    rings = PAWN_PROFILE[1:-1]
    verts = [[0.0, PAWN_PROFILE[0][1], 0.0]]
    for r, y in rings:
        verts += [[r * np.cos(a), y, r * np.sin(a)] for a in ang]
    verts.append([0.0, PAWN_PROFILE[-1][1], 0.0])
    top = len(verts) - 1
    ring = lambda k, j: 1 + k * PAWN_AROUND + j % PAWN_AROUND
    faces = [[0, ring(0, j), ring(0, j + 1)] for j in range(PAWN_AROUND)]
    for k in range(len(rings) - 1):
        for j in range(PAWN_AROUND):
            a0, a1 = ring(k, j), ring(k, j + 1)
            b0, b1 = ring(k + 1, j), ring(k + 1, j + 1)
            faces += [[a0, b0, a1], [a1, b0, b1]]
    k = len(rings) - 1
    faces += [[top, ring(k, j + 1), ring(k, j)] for j in range(PAWN_AROUND)]
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    p = v[f]
    vol = np.einsum("ij,ij->i", p[:, 0], np.cross(p[:, 1], p[:, 2])).sum()
    if vol < 0.0:                       # wind the normals outward
        f = f[:, ::-1].copy()
    return v, f


def pawn_standin_world(rt):
    """``scenes/pawn_test.py``'s world with ``pawn.obj`` replaced by
    :func:`pawn_standin_mesh`: the mesh as a glass shell (dielectric 1.5)
    and as the boundary of a red isotropic medium of density 5.  ``rt``
    is the builder module (this package or the JAX one)."""
    v, f = pawn_standin_mesh()
    mesh = rt.Mesh(vertices=v, uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full_like(f, -1))
    return rt.group([
        rt.with_material(rt.dielectric(1.5), rt.triangle_mesh(mesh)),
        rt.with_material(rt.isotropic(rt.constant_texture([1.0, 0.0, 0.0])),
                         rt.constant_medium(5.0, rt.triangle_mesh(mesh))),
    ])


def pawn_standin_settings(rt, width: int = 500, spp: int = 400,
                          depth: int = 20):
    """``scenes/pawn_test.py``'s camera: from (0, 3.75, 5) to (0, 2.75,
    0), vfov 80 degrees, gray fade."""
    return rt.CameraSettings(
        center=np.asarray([0.0, 3.75, 5.0]),
        look_at=np.asarray([0.0, 2.75, 0.0]), image_width=width,
        vfov=rt.degrees(80), samples_per_pixel=spp, max_depth=depth,
        background=rt.gray_fade)


def pawn_standin_scene(width: int = 500, spp: int = 400, depth: int = 20,
                       device="cuda"):
    """``(scene, settings)`` of ``scenes/pawn_test.py`` (500 x 500, 400
    spp, depth 20 there) with the stand-in pawn: a 1,216-row
    kind-segmented shell (the BVH walk, K9) and a 1,200-row medium
    boundary (kernel K11b), rendered by the sorted driver."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(pawn_standin_world(rt), device=device),
            pawn_standin_settings(rt, width, spp, depth))


def volume_test_world(rt, moving: bool = False):
    """``tests/test_volume_kernel.py``'s media: a fog ball (sphere row)
    and a smoke box (one ``PRIM_BOX`` row) over a ground parallelogram;
    with ``moving`` both media move."""
    ball = rt.with_material(rt.isotropic(rt.constant_texture(0.8)),
                            rt.constant_medium(0.7, rt.sphere([0, 0, -3],
                                                              1.5)))
    box = rt.with_material(rt.anisotropic(0.4, rt.constant_texture(0.9)),
                           rt.constant_medium(1.2, rt.cuboid(
                               [2, -1, -5], [4.5, 1.5, -2])))
    media = rt.group([ball, box])
    if moving:
        media = rt.moving([0, 0, 0], [0.6, 0.3, -0.4], media)
    return rt.group([media, rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)),
        rt.parallelogram([-20, -2, -20], [40, 0, 0], [0, 0, 40]))])


def many_media_world(rt, n: int = 17, rotated: bool = False):
    """``n`` media in a grid of six columns over a lambertian ground under
    a light: fog balls and (every fourth) axis-aligned fog boxes of
    densities 0.3 up by 0.1, isotropic, anisotropic or pitch black in
    turn; with ``rotated`` every medium a box turned about y, six
    parallelogram rows each (so 17 of them make a boundary table of 102
    rows, which takes kernel K11b).  With 17, more media than one launch
    of the crossing kernels takes (16).  ``rt`` is the builder module
    (this package or the JAX one)."""
    media = []
    for i in range(n):
        c = np.asarray([-5.0 + 2.0 * (i % 6), 0.0, -2.0 - 2.0 * (i // 6)])
        mat = (rt.isotropic(rt.constant_texture([0.8, 0.6, 0.4])),
               rt.anisotropic(0.3, rt.constant_texture(0.7)),
               rt.pitch_black())[i % 3]
        if rotated:
            shape = rt.transform(rt.compose(rt.translate(c),
                                            rt.rotate_y(0.2 + 0.1 * i)),
                                 rt.cuboid([-0.6, -0.6, -0.6],
                                           [0.6, 0.6, 0.6]))
        elif i % 4 == 3:
            shape = rt.cuboid(c - 0.6, c + 0.6)
        else:
            shape = rt.sphere(c, 0.8)
        media.append(rt.with_material(mat, rt.constant_medium(0.3 + 0.1 * i,
                                                              shape)))
    return rt.group(media + [
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                         rt.parallelogram([-20, -1, -20], [40, 0, 0],
                                          [0, 0, 40])),
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-3, 5, -6], [6, 0, 0],
                                          [0, 0, 4]))])


def many_media_settings(rt, width: int = 32, spp: int = 8, depth: int = 10):
    """The camera of :func:`many_media_world`: from (0, 3, 8) towards (0,
    0, -3), under the sky."""
    return rt.CameraSettings(
        center=np.asarray([0.0, 3.0, 8.0]),
        look_at=np.asarray([0.0, 0.0, -3.0]), image_width=width,
        samples_per_pixel=spp, max_depth=depth, background=rt.sky)


def volume_rays(n: int, seed: int, box=(-6.0, 6.0), inside=(), device="cpu"):
    """``[7, n]`` random rays from a numpy seed: origins uniform in
    ``box``, unit directions, times in [0, 1); successive groups of 32
    lanes start at the points ``inside``, and the last lane is parked at
    3e18 as the drivers park dead lanes."""
    rg = np.random.default_rng(seed)
    o = rg.uniform(box[0], box[1], (n, 3))
    for k, pt in enumerate(inside):
        o[32 * k:32 * (k + 1)] = pt
    o[-1] = 3e18
    d = rg.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rg.uniform(0, 1, (n, 1))
    return _tensor(np.concatenate([o, d, tm], 1).T.astype(np.float32),
                   device)


def pawn_inside_rays(n: int, seed: int, device="cpu"):
    """``[7, n]`` rays from random points inside the stand-in pawn (within
    0.3 of its axis, at heights 0.5-5.0, where its radius is at least
    0.5) in random directions, at time 0."""
    rg = np.random.default_rng(seed)
    r = 0.3 * np.sqrt(rg.uniform(size=n))
    a = rg.uniform(0, 2 * np.pi, n)
    o = np.stack([r * np.cos(a), rg.uniform(0.5, 5.0, n), r * np.sin(a)], 1)
    d = rg.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _tensor(np.concatenate([o, d, np.zeros((n, 1))], 1).T
                   .astype(np.float32), device)


def media_bounce_rays(scene, s, seed: int, pixels=None):
    """``[(comps [7, R], alive [R]), ...]`` for the crossing kernels: the
    camera rays of sample 0 of the lanes of the stationary driver (or of
    ``pixels``) and, after one bounce of the split path with its media,
    the scattered rays of the surviving lanes (dead ones parked at
    3e18)."""
    from .core import rng
    from .render.camera import camera_frame, generate_ray_components
    from .render.integrator import (
        bounce_split_soa, n_bounce_uniforms, split_tables,
    )
    dev = scene.device
    if pixels is None:
        pixels = torch.from_numpy(stationary_lanes(s)[2])
    pix = pixels.to(dev, torch.int32)
    n = pix.shape[0]
    n_u = n_bounce_uniforms(scene)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    keys = rng.ray_keys_fast(rng.base_key(seed, dev), pix, zeros)
    uni = rng.uniform_cols(rng.mix_depth(keys, zeros), n_u + 6)
    comps = generate_ray_components(s, camera_frame(s), pix,
                                    uni[n_u:n_u + 5]).contiguous()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ones = torch.ones((3, n), device=dev)
    nxt, _, _, alive2, _ = bounce_split_soa(
        scene, s, comps, uni, torch.zeros((3, n), device=dev), ones, alive,
        tables=split_tables(scene, s))
    nxt = torch.cat([torch.where(alive2, nxt[0:3], 3e18), nxt[3:7]])
    return [(comps, alive), (nxt.contiguous(), alive2)]


def fwd_bwd_pixels(n_pix: int, lanes: int):
    """bench.py's lanes (its first call): pixels ``0 .. lanes`` modulo the
    image."""
    return (torch.arange(lanes) % n_pix).to(torch.int32)


def _tensor(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def bounce_inputs(scene, n: int, seed: int, box):
    """Random lanes for kernel A: origins uniform in ``box`` (lo, hi),
    unit directions, throughput, 90% alive, uniforms from the port's
    counter hash.  Returns the positional lane arguments after the
    tables."""
    from .core import rng
    dev = scene.device
    rg = np.random.default_rng(seed)
    o = rg.uniform(box[0], box[1], (3, n)).astype(np.float32)
    d = rg.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tm = rg.uniform(0, 1, n).astype(np.float32)
    thr = rg.uniform(0.2, 1.0, (3, n)).astype(np.float32)
    al = (rg.uniform(0, 1, n) < 0.9).astype(np.float32)
    keys = rng.ray_keys_fast(rng.base_key(seed, dev),
                             torch.arange(n, device=dev),
                             torch.zeros(n, dtype=torch.int32, device=dev))
    uni = rng.uniform_cols(keys, 8).contiguous()
    return (*[_tensor(x, dev) for x in o], *[_tensor(x, dev) for x in d],
            _tensor(tm, dev), *[_tensor(x, dev) for x in thr],
            _tensor(al, dev), uni)


def stationary_lanes(s):
    """``(n_pix, lanes, lane_pix)`` of the stationary driver for one
    image: lanes rounded up to 128, padding lanes clamped to the last
    pixel (``render/integrator.py``)."""
    from .render.integrator import LANE_ALIGN
    n_pix = s.image_width * s.image_height
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    return n_pix, lanes, np.minimum(np.arange(lanes), n_pix - 1)


def primary_bounce_inputs(scene, s, seed: int):
    """Kernel A's lane arguments for the first bounce of sample 0 of every
    pixel, at the shapes the stationary driver gives it: camera rays
    through each lane's pixel, unit throughput, every lane alive."""
    from .core import rng
    from .render.camera import camera_frame, generate_ray_components
    dev = scene.device
    _, lanes, lane_pix = stationary_lanes(s)
    pix = _tensor(lane_pix.astype(np.int32), dev)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
    keys = rng.mix_depth(rng.ray_keys_fast(rng.base_key(seed, dev), pix,
                                           zeros), zeros)
    uni = rng.uniform_cols(keys, 14)
    comps = generate_ray_components(s, camera_frame(s), pix, uni[8:13])
    ones = torch.ones(lanes, device=dev)
    return (*comps.unbind(0), ones, ones, ones, ones,
            uni[:8].contiguous())


def next_bounce_inputs(lanes, out, seed: int, depth: int):
    """Kernel A's lane arguments for the next bounce, from the outputs
    ``out`` of the bounce that took ``lanes``: the scattered rays, their
    throughput and alive flags, dead lanes parked far away as the driver
    parks them, and fresh uniforms for ``depth``."""
    from .core import rng
    dev = out[0].device
    n = out[0].shape[0]
    alive = out[12] > 0.5
    o = [torch.where(alive, x, 3e18) for x in out[0:3]]
    keys = rng.mix_depth(
        rng.ray_keys_fast(rng.base_key(seed, dev),
                          torch.arange(n, dtype=torch.int32, device=dev),
                          torch.zeros(n, dtype=torch.int32, device=dev)),
        torch.full((n,), depth, dtype=torch.int32, device=dev))
    uni = rng.uniform_cols(keys, 8).contiguous()
    return (*o, *out[3:6], lanes[6], *out[6:9], out[12], uni)


def max_errs(ref, out, int_rows):
    """``(lanes that differ in the exact rows, max abs float error, worst
    excess over ATOL + RTOL * |ref|)`` between two output tuples."""
    n_int = sum(int((ref[k] != out[k]).sum()) for k in int_rows)
    err = 0.0
    excess = -float("inf")
    for k in range(len(ref)):
        if k in int_rows:
            continue
        a = ref[k].to(torch.float64)
        b = out[k].to(torch.float64)
        diff = (a - b).abs()
        # equal values (infinities too) and NaN in both are agreement;
        # NaN in one is an infinite error
        diff = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0,
                           torch.nan_to_num(diff, nan=float("inf")))
        err = max(err, float(diff.max()))
        excess = max(excess, float((diff - (ATOL + RTOL * a.abs())).max()))
    return n_int, err, excess


def compare_bounce(tables, lanes):
    """Kernel A and ``bounce_plain`` on the same lane arguments: returns
    ``(max_errs(...), kernel outputs)``."""
    from .ops.bounce_kernel import bounce_megakernel, bounce_plain
    tb = tables
    ref = bounce_plain(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw)
    out = bounce_megakernel(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw)
    return max_errs(ref, out, BOUNCE_INT_ROWS), out


def iter_state(n: int, n_pix: int, seed: int, device, box=(0.0, 555.0)):
    """A random mid-render lane state for kernel B: lane ``l`` serves pixel
    ``min(l, n_pix - 1)`` as in the stationary driver, plus a random
    carry with origins uniform in ``box`` (lo, hi)."""
    rg = np.random.default_rng(seed)
    pix = np.minimum(np.arange(n), n_pix - 1).astype(np.int32)
    smp = rg.integers(-1, 7, n).astype(np.int32)
    dep = rg.integers(0, 9, n).astype(np.int32)
    al = (rg.uniform(size=n) < 0.5).astype(np.float32)
    o = rg.uniform(box[0], box[1], (3, n)).astype(np.float32)
    d = rg.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    tm = np.zeros(n, np.float32)
    rad = rg.uniform(0, 1, (3, n)).astype(np.float32)
    thr = rg.uniform(0, 1, (3, n)).astype(np.float32)
    t = lambda x: _tensor(x, device)
    carry = (t(smp), t(dep), t(al), *[t(x) for x in o],
             *[t(x) for x in d], t(tm), *[t(x) for x in rad],
             *[t(x) for x in thr])
    return t(pix), carry


def fresh_carry(n: int, device):
    """Kernel B's carry before the first sample: every lane idle."""
    z = torch.zeros(n, device=device)
    o = torch.ones(n, device=device)
    zi = torch.zeros(n, dtype=torch.int32, device=device)
    return (zi - 1, zi.clone(), z, z, z, z, z, z, o, z, z, z, z, o, o, o)


def compare_iter(scene, s, n: int, seed: int, n_iters: int = 30,
                 box=(0.0, 555.0)):
    """Kernel B (or, for a mesh-scale table, its mesh variant) against
    ``iter_plain`` on ``n`` lanes of the image of ``s``: one iteration
    from a random state (origins in ``box``), with the winner's uv
    (``max_errs``), then ``n_iters`` from a fresh state (fraction of lanes
    whose summed radiance differs by more than 1e-5, relative mean
    difference)."""
    from .core import rng
    from .diff.fused_iter import iter_kernel_args
    from .ops.iter_kernel import iter_megakernel, iter_plain
    dev = scene.device
    tables, kw = iter_kernel_args(scene, s, rng.base_key(seed, dev), 7)
    n_pix = s.image_width * s.image_height
    pix, carry = iter_state(n, n_pix, seed, dev, box)
    lane_in = (pix,) + carry
    kw_uv = dict(kw, with_uv=True)
    ref = iter_plain(*tables, lane_in, **kw_uv)
    out = iter_megakernel(*tables, lane_in, **kw_uv)
    one = max_errs(ref, out, ITER_INT_ROWS)

    acc = []
    for fn in (iter_plain, iter_megakernel):
        c = fresh_carry(n, dev)
        a = torch.zeros((3, n), device=dev)
        for _ in range(n_iters):
            o = fn(*tables, (pix,) + c, **kw)
            c = (o[14], o[15], o[13]) + tuple(o[0:13])
            a += torch.stack(o[7:10]) * o[16]
        acc.append(a)
    frac = float(((acc[0] - acc[1]).abs().amax(0) > 1e-5).float().mean())
    mean_rel = abs(float(acc[1].mean()) / float(acc[0].mean()) - 1.0)
    return one, frac, mean_rel


def camera_rays(scene, s, n: int, seed: int, pixels=None):
    """``(comps [7, n], uniforms [8, n])``: camera rays of sample 0 of
    ``n`` pixels (``pixels``, by default spread evenly over the image of
    ``s``) and their bounce uniforms at depth 0, as the drivers draw
    them."""
    from .core import rng
    from .render.camera import camera_frame, generate_ray_components
    dev = scene.device
    n_pix = s.image_width * s.image_height
    pix = (torch.arange(n, dtype=torch.int64) * n_pix // n
           if pixels is None else pixels).to(dev, torch.int32)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    keys = rng.mix_depth(rng.ray_keys_fast(rng.base_key(seed, dev), pix,
                                           zeros), zeros)
    uni = rng.uniform_cols(keys, 14)
    comps = generate_ray_components(s, camera_frame(s), pix, uni[8:13])
    return comps.contiguous(), uni[:8].contiguous()


def compare_nearest(tb, comps):
    """The nearest kernel and ``allpairs_nearest_plain`` on the rays
    ``comps`` [7, R] over the split tables ``tb``: ``(max_errs(...),
    kernel outputs)``."""
    from .ops.allpairs_kernel import (
        allpairs_nearest_plain, allpairs_nearest_record,
    )
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    rays = tuple(comps.unbind(0))
    ref = allpairs_nearest_plain(tb.ptbl, *rays, **kw)
    out = allpairs_nearest_record(tb.ptbl, tb.bvh, *rays, **kw)
    return max_errs(ref, out, NEAREST_INT_ROWS), out


def compare_nearest_flat(tb, comps):
    """Kernel K8 (the flat scan) and ``pallas_nearest_plain`` on the rays
    ``comps`` [7, R] over the split tables ``tb``: ``(max_errs(...),
    kernel outputs)``."""
    from .ops.intersect_kernel import (
        pallas_nearest_plain, pallas_nearest_record,
    )
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    rays = tuple(comps.unbind(0))
    ref = pallas_nearest_plain(tb.ptbl, *rays, **kw)
    out = pallas_nearest_record(tb.ptbl, *rays, **kw)
    return max_errs(ref, out, NEAREST_INT_ROWS), out


def surface_points(tb, comps):
    """``(points [R, 3], hit)``: the hit points ``o + t_safe * d`` of the
    rays ``comps`` [7, R] over the split tables ``tb`` and their hit
    record (:func:`render.integrator.surface_hit`)."""
    from .render.integrator import surface_hit
    hit = surface_hit(tb, comps[0:3], comps[3:6], comps[6])
    t_safe = torch.where(torch.isfinite(hit[0]), hit[0], 1.0)
    return (comps[0:3] + t_safe * comps[3:6]).T.contiguous(), hit


def compare_marble(table, tex_ids, points):
    """Kernel K12 and ``marble_stripe_plain`` on the same lanes:
    ``(max_errs(...), kernel output)``; the caller holds the error to
    0."""
    from .ops.texture_kernel import marble_stripe_pallas, marble_stripe_plain
    ref = marble_stripe_plain(table, tex_ids, points)
    out = marble_stripe_pallas(table, tex_ids, points)
    return max_errs((ref,), (out,), ()), out


def compare_crossings(volumes, comps, t_min: float = 1e-3, tables=None):
    """The crossing kernel of ``volumes`` (K11b for a mesh-scale boundary,
    else K11) and ``volume_crossings_plain`` on the rays ``comps`` [7, R]:
    ``(max_errs(...) with the front flags as exact rows, kernel
    outputs)``."""
    from .ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
        volume_crossings_plain,
    )
    from .render.volumes import crossing_kw, volume_tables
    vtbl, cbox = volume_tables(volumes) if tables is None else tables
    kw = crossing_kw(volumes, t_min)
    rays = tuple(comps.unbind(0))
    ref = volume_crossings_plain(vtbl, *rays, **kw)
    if cbox is None:
        out = pallas_volume_crossings(vtbl, *rays, **kw)
    else:
        out = pallas_volume_crossings_bcast(vtbl, cbox, *rays, **kw)
    return max_errs(ref, out, tuple(range(1, len(ref), 3))), out


def image_grad_errs(img_id, j, i, g, ref, out):
    """``(0, max abs error, worst excess)`` of an atlas gradient ``out``
    against ``ref`` (either the plain version or an exact sum), for the
    contributions ``g`` [R, 3] at ``(img_id, j, i)``: each texel within
    ``SCATTER_RTOL * n * sum |g|`` over its ``n`` contributions."""
    from .ops.image_grad_kernel import image_grad_plain
    shape = dict(n_img=ref.shape[0], h=ref.shape[1], w=ref.shape[2])
    ones = torch.ones_like(g)
    count = image_grad_plain(img_id, j, i, ones, **shape)
    mag = image_grad_plain(img_id, j, i, g.abs(), **shape)
    diff = (ref.to(torch.float64) - out.to(torch.float64)).abs()
    diff = torch.nan_to_num(diff, nan=float("inf"))
    bound = SCATTER_RTOL * count.to(torch.float64) * mag.to(torch.float64)
    return 0, float(diff.max()), float((diff - bound).max())


def compare_image_grad(img_id, j, i, g, n_img: int, h: int, w: int):
    """Kernel K13 against ``image_grad_plain`` and against a float64
    reduction of the same terms: ``(errs vs plain, errs vs float64,
    kernel output)``, each as :func:`image_grad_errs`."""
    from .ops.image_grad_kernel import image_grad_pallas, image_grad_plain
    kw = dict(n_img=n_img, h=h, w=w)
    ref = image_grad_plain(img_id, j, i, g, **kw)
    out = image_grad_pallas(img_id, j, i, g, **kw)
    exact = image_grad_plain(img_id, j, i, g.to(torch.float64), **kw)
    return (image_grad_errs(img_id, j, i, g, ref, out),
            image_grad_errs(img_id, j, i, g, exact, out), out)


def synthetic_medium(t, n_mats: int, seed: int):
    """``(t_med, vmat)``: a medium event nearer than the surface on about
    a third of the lanes (at 20-100% of the surface distance, or at
    distance 0.5-3 where the ray misses), none elsewhere; material ids
    drawn from ``n_mats``."""
    rg = np.random.default_rng(seed)
    n = t.shape[0]
    dev = t.device
    u = _tensor(rg.uniform(size=n).astype(np.float32), dev)
    frac = _tensor(rg.uniform(0.2, 1.0, n).astype(np.float32), dev)
    far = _tensor(rg.uniform(0.5, 3.0, n).astype(np.float32), dev)
    t_med = torch.where(u < 0.35, torch.where(torch.isfinite(t), t * frac,
                                              far), float("inf"))
    vmat = _tensor(rg.integers(0, n_mats, n).astype(np.float32), dev)
    return t_med, vmat


def compare_shade(tb, comps, uniforms, thr, alive, medium=None,
                  hit=None):
    """The shade kernel and ``shade_plain`` on the hit record of the rays
    ``comps`` over the split tables ``tb`` (the nearest kernel's, with
    the exact sphere uv, unless ``hit`` is given), throughput ``thr``
    [3, R] and ``alive`` (bool [R]), with the medium events ``medium``
    or none: ``(max_errs(...), kernel outputs, hit)``.  Dead lanes are
    parked far away, as the drivers park them."""
    from .ops.bounce_kernel import shade_megakernel, shade_plain
    from .render.integrator import surface_hit
    o = torch.where(alive, comps[0:3], 3e18)
    if hit is None:
        hit = surface_hit(tb, o, comps[3:6], comps[6])
    lanes = (o[0], o[1], o[2], comps[3], comps[4], comps[5], thr[0], thr[1],
             thr[2], alive.to(torch.float32))
    kw = dict(n_mats=tb.n_mats, n_targets=tb.n_targets,
              has_medium=medium is not None)
    ref = shade_plain(tb.mtbl, tb.ttbl, hit, medium, lanes, uniforms, **kw)
    out = shade_megakernel(tb.mtbl, tb.ttbl, hit, medium, lanes, uniforms,
                           **kw)
    return max_errs(ref, out, BOUNCE_INT_ROWS), out, hit


def next_split_rays(comps, out, seed: int, depth: int):
    """The rays, throughput, alive flags and fresh uniforms (depth
    ``depth``) of the next bounce after the shade outputs ``out`` of the
    rays ``comps``."""
    from .core import rng
    dev = comps.device
    n = comps.shape[1]
    alive = out[12] > 0.5
    nxt = torch.stack(tuple(out[0:6]) + (comps[6],)).contiguous()
    keys = rng.mix_depth(
        rng.ray_keys_fast(rng.base_key(seed, dev),
                          torch.arange(n, dtype=torch.int32, device=dev),
                          torch.zeros(n, dtype=torch.int32, device=dev)),
        torch.full((n,), depth, dtype=torch.int32, device=dev))
    uni = rng.uniform_cols(keys, 8).contiguous()
    return nxt, uni, torch.stack(out[6:9]), alive


@contextlib.contextmanager
def checked_launches():
    """Inside the block, every kernel A launch of the render drivers,
    every nearest-hit (BVH walk and flat scan), medium crossing (K11,
    K11b), shade and marble kernel launch of the split path, every kernel
    B launch of the fused step and every atlas-gradient launch of its
    backward is followed by its plain version on the same inputs.  Yields ``{kernel name: stats}`` with
    ``launches`` (checked), ``n_int`` (differing exact-row lanes, summed),
    ``err`` (max abs float error) and ``excess`` (worst tolerance
    excess; the atlas gradient's is :func:`image_grad_errs`')."""
    from .diff import fused_iter
    from .ops.allpairs_kernel import allpairs_nearest_plain
    from .ops.bounce_kernel import bounce_plain, shade_plain
    from .ops.image_grad_kernel import image_grad_plain
    from .ops.intersect_kernel import pallas_nearest_plain
    from .ops.iter_kernel import iter_plain
    from .ops.texture_kernel import marble_stripe_plain
    from .ops.volume_kernel import volume_crossings_plain
    from .render import integrator, volumes
    from .textures import textures
    stats = {}

    def nearest_plain(tbl, bvh, *rays, **kw):
        return allpairs_nearest_plain(tbl, *rays, **kw)

    def crossings_bcast_plain(vtbl, cbox, *rays, **kw):
        return volume_crossings_plain(vtbl, *rays, **kw)

    def crossing_check(args, ref, out):
        return max_errs(ref, out, tuple(range(1, len(ref), 3)))

    def rows(int_rows):
        return lambda args, ref, out: max_errs(ref, out, int_rows)

    def image_grad_check(args, ref, out):
        return image_grad_errs(*args[:4], ref, out)

    def spy(module, name, plain, compare):
        kernel = getattr(module, name)
        st = stats[name] = dict(launches=0, n_int=0, err=0.0,
                                excess=-float("inf"))

        def checked(*args, **kw):
            out = kernel(*args, **kw)
            n_int, err, excess = compare(args, plain(*args, **kw), out)
            st["launches"] += 1
            st["n_int"] += n_int
            st["err"] = max(st["err"], err)
            st["excess"] = max(st["excess"], excess)
            return out
        return kernel, checked

    patched = [(integrator, "bounce_megakernel", bounce_plain,
                rows(BOUNCE_INT_ROWS)),
               (integrator, "allpairs_nearest_record", nearest_plain,
                rows(NEAREST_INT_ROWS)),
               (integrator, "pallas_nearest_record", pallas_nearest_plain,
                rows(NEAREST_INT_ROWS)),
               (integrator, "shade_megakernel", shade_plain,
                rows(BOUNCE_INT_ROWS)),
               (textures, "marble_stripe_pallas",
                lambda *a, **k: (marble_stripe_plain(*a, **k),),
                lambda args, ref, out: max_errs(ref, (out,), ())),
               (fused_iter, "iter_megakernel", iter_plain,
                rows(ITER_INT_ROWS)),
               (textures, "image_grad_pallas", image_grad_plain,
                image_grad_check),
               (volumes, "pallas_volume_crossings", volume_crossings_plain,
                crossing_check),
               (volumes, "pallas_volume_crossings_bcast",
                crossings_bcast_plain, crossing_check)]
    originals = []
    for module, name, plain, rows in patched:
        kernel, checked = spy(module, name, plain, rows)
        originals.append((module, name, kernel))
        setattr(module, name, checked)
    try:
        yield stats
    finally:
        for module, name, kernel in originals:
            setattr(module, name, kernel)


def bwd_inputs(scene, s, lanes: int, seed: int, n_iters: int = 3,
               spp: int = 8, pixels=None):
    """K5's arguments for a real mid-render state: kernel B (its plain
    version on the CPU) takes ``n_iters`` steps from a fresh carry on
    ``lanes`` lanes of the image of ``s`` (pixels ``pixels``, by default
    spread evenly over the image); the inputs, winner index and RR scale
    of one more step are K5's inputs, with random normal cotangents drawn
    from a ``torch.Generator`` seeded with ``seed``.  Returns ``(args,
    kw)`` for :func:`bounce_bwd_regen_pre_megakernel`."""
    from .core import rng
    from .diff.fused_iter import iter_kernel_args
    from .ops.iter_kernel import iter_megakernel
    from .ops.row_reduce import row_tables, winner_rows
    dev = scene.device
    tables, kw = iter_kernel_args(scene, s, rng.base_key(seed, dev),
                                  spp - 1)
    n_pix = s.image_width * s.image_height
    pix = (torch.arange(lanes) * n_pix // lanes if pixels is None
           else pixels).to(dev, torch.int32)
    carry = fresh_carry(lanes, dev)
    for _ in range(n_iters + 1):
        lane_in = (pix,) + tuple(carry)
        outs = iter_megakernel(*tables, lane_in, **kw)
        carry = (outs[14], outs[15], outs[13]) + tuple(outs[0:13])
    n_row = 15 if scene.prims.has_motion else 9
    idx = outs[17]
    gath = winner_rows(row_tables(scene, n_row), idx)
    gen = torch.Generator().manual_seed(seed)
    cts = torch.randn((13, lanes), generator=gen).to(dev).unbind(0)
    _, _, ttbl, cam, kt = tables
    args = (ttbl, kt, cam, gath, idx, lane_in[0:3], lane_in[3],
            lane_in[4:11], lane_in[14:17], outs[18], cts)
    kw5 = dict(n_targets=kw["n_targets"], has_motion=kw["has_motion"],
               has_box=scene.prims.has_box, t_min=kw["t_min"], n_row=n_row,
               n_u=kw["n_u"], width=kw["width"], bg_kind=kw["bg_kind"])
    return args, kw5


def k7_inputs(scene, s, lanes: int, steps: int, seed: int = 0, spp: int = 8,
              pixels=None):
    """K7's arguments for a real mid-render state of the unfused driver:
    kernel A (its plain version on the CPU) steps ``lanes`` lanes of the
    image of ``s`` (pixels ``pixels``, by default spread evenly over the
    image) ``steps`` times from idle lanes, regenerating, capping and
    playing Russian roulette as ``trace_wavefront_diff`` does at
    ``rotate_k == 1``; the next bounce's inputs (dead lanes not parked),
    its uniforms and winner index are K7's, with random normal cotangents
    drawn from a ``torch.Generator`` seeded with ``seed``.  Returns
    ``(args, kw)`` for :func:`bounce_bwd_megakernel`."""
    from .core import rng
    from .ops.row_reduce import row_tables, winner_rows
    from .render.camera import camera_frame, camera_table, rays_from_table
    from .render.integrator import (
        _init_comps, _russian_roulette, bounce_mega_soa, bounce_tables,
    )
    dev = scene.device
    tb = bounce_tables(scene, s)
    cam = camera_table(s, camera_frame(s))
    key = rng.base_key(seed, dev)
    n_pix = s.image_width * s.image_height
    pix = (torch.arange(lanes) * n_pix // lanes if pixels is None
           else pixels).to(dev, torch.int32)
    comps = _init_comps(lanes, dev)
    zero3 = torch.zeros((3, lanes), device=dev)
    thr = torch.ones((3, lanes), device=dev)
    alive = torch.zeros(lanes, dtype=torch.bool, device=dev)
    sample = torch.full((lanes,), -1, dtype=torch.int32, device=dev)
    depth = torch.zeros(lanes, dtype=torch.int32, device=dev)
    for step in range(steps + 1):
        can = ~alive & (sample < spp - 1)
        sample = torch.where(can, sample + 1, sample)
        depth = torch.where(can, 0, depth)
        alive = alive | can
        uni = rng.uniform_cols(rng.mix_depth(rng.ray_keys_fast(key, pix,
                                                               sample),
                                             depth), 14)
        comps = torch.where(can, rays_from_table(cam, s.image_width, pix,
                                                 uni[8:13]), comps)
        thr = torch.where(can, 1.0, thr)
        if step == steps:
            break
        comps, _, thr, alive, died = bounce_mega_soa(
            scene, s, comps, uni, zero3, thr, alive, tables=tb)
        depth = depth + 1
        alive = alive & (depth < s.max_depth)
        if s.rr_depth is not None:
            thr, alive, _ = _russian_roulette(s, uni[13], depth, thr, alive,
                                              died)
    idx = bounce_mega_soa(scene, s, comps, uni, zero3, thr, alive,
                          with_idx=True, tables=tb)[5]
    n_row = 15 if scene.prims.has_motion else 9
    gath = winner_rows(row_tables(scene, n_row), idx)
    gen = torch.Generator().manual_seed(seed)
    cts = torch.randn((12, lanes), generator=gen).to(dev).unbind(0)
    args = (tb.ttbl, gath, idx.to(torch.float32),
            tuple(comps.unbind(0)) + tuple(thr.unbind(0)), uni[:8],
            torch.where(alive, 1.0, 0.0), cts)
    kw = dict(n_targets=tb.n_targets, has_motion=tb.has_motion,
              has_box=scene.prims.has_box, t_min=tb.t_min, n_row=n_row)
    return args, kw


def compare_k7(args, kw):
    """K7 and ``bounce_bwd_megakernel_plain`` on the same arguments:
    ``(bwd_errs(...), kernel outputs)``."""
    from .ops.bounce_bwd_kernel import (
        bounce_bwd_megakernel, bounce_bwd_megakernel_plain,
    )
    ref = bounce_bwd_megakernel_plain(*args, **kw)
    out = bounce_bwd_megakernel(*args, **kw)
    return bwd_errs(ref, out), out


def bwd_bound(ref):
    """The per-lane tolerance of K5's and K7's outputs against their
    plain outputs ``ref`` (see the module docstring), float64."""
    mag = torch.nan_to_num(torch.stack(ref).to(torch.float64).abs(),
                           nan=0.0)
    return BWD_RTOL * (mag + mag.amax(1, keepdim=True)
                       + mag.amax(0, keepdim=True))


def _abs_diff(a, b):
    """|a - b| in float64, 0 where both are NaN, infinite where one is."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    diff = (a - b).abs()
    return torch.where(a.isnan() & b.isnan(), 0.0,
                       torch.nan_to_num(diff, nan=float("inf")))


def bwd_errs(ref, out):
    """``(max abs error, worst excess over the K5 tolerance)`` between
    K5's plain and kernel outputs (see the module docstring); NaN in one
    of them is an infinite error."""
    diff = _abs_diff(torch.stack(ref), torch.stack(out))
    return float(diff.max()), float((diff - bwd_bound(ref)).max())


def reduce_row_grads(tables, rows_g, bi, n_row: int):
    """The per-lane row gradients ``rows_g`` (``n_row + 7`` [R] columns:
    winner rows, c0, c1, param) of the lanes whose winner index is ``bi``
    (f32, -1 on a miss: row 0), summed by ``index_add_`` over the lanes
    straight onto the prim, material and texture tables, in their dtype:
    the fwd+bwd's reduction before it moved into the backward kernels, and
    the reference of theirs (``ops/row_reduce.RowGrads``)."""
    from .ops.row_reduce import RowGrads
    pi = torch.clamp(bi, min=0).long()
    rows = torch.stack(tuple(rows_g), dim=1)
    z = lambda *shape: torch.zeros(shape, dtype=rows.dtype,
                                   device=rows.device)
    mat, tex = tables.mat.long()[pi], tables.tex.long()[pi]
    return RowGrads(
        z(tables.n_prims, n_row).index_add_(0, pi, rows[:, :n_row]),
        z(tables.n_mats).index_add_(0, mat, rows[:, n_row + 6]),
        z(tables.n_tex, 3).index_add_(0, tex, rows[:, n_row:n_row + 3]),
        z(tables.n_tex, 3).index_add_(0, tex, rows[:, n_row + 3:n_row + 6]))


def row_grads_errs(tables, rows_g, bi, n_row: int, out, lane_bound=None):
    """``(max abs error, worst excess)`` of reduced row gradients ``out``
    (``RowGrads``) against the float64 sum of the per-lane row gradients
    ``rows_g`` they were reduced from: each entry, a sum over ``n``
    lanes, within ``n * 2^-23 * sum |g|`` of them (two summation orders
    of the same terms), plus, with ``lane_bound`` (the ``n_row + 7`` rows
    of :func:`bwd_bound` when ``rows_g`` are the plain version's and
    ``out`` summed the kernel's), the sum of the lanes' tolerances."""
    g = [x.to(torch.float64) for x in rows_g]
    ref = reduce_row_grads(tables, g, bi, n_row)
    mag = reduce_row_grads(tables, [torch.nan_to_num(x.abs(), nan=0.0)
                                    for x in g], bi, n_row)
    cnt = reduce_row_grads(tables, [torch.ones_like(g[0])] * len(g), bi,
                           n_row)
    extra = (reduce_row_grads(tables, tuple(lane_bound), bi, n_row)
             if lane_bound is not None else [0.0] * 4)
    err = excess = -float("inf")
    inf = float("inf")
    for o, r, m, c, e in zip(out, ref, mag, cnt, extra):
        diff = _abs_diff(r, o)
        bound = c * 2.0 ** -23 * m + e
        # an entry with a zero bound (no lane, or only zero terms) must be
        # exact; it sets no margin
        x = torch.where(bound > 0, diff - bound,
                        torch.where(diff > 0, inf, -inf))
        if diff.numel():
            err = max(err, float(diff.max()))
            excess = max(excess, float(x.max()))
    return err, excess


def reduced_args(args, tables):
    """A reduced mode's arguments from the per-lane mode's (K5's
    :func:`bwd_inputs` or K7's :func:`k7_inputs`): ``tables`` (its
    ``row_reduce.RowTables``) in place of the gathered columns."""
    k = 3 if len(args) == 11 else 1
    return args[:k] + (tables,) + args[k + 1:]


def compare_reduced(args, kw, tables):
    """A reduced mode (K5 for :func:`bwd_inputs`' ``args``, K7 for
    :func:`k7_inputs`') on the card against its plain version and its
    per-lane mode on the same arguments.  Returns a dict: ``lane_err``,
    ``lane_excess`` (the lane outputs against the plain version's,
    :func:`bwd_errs`), ``lane_differ`` (lane outputs that differ from the
    per-lane mode's, which runs the same device code), ``rows_err``,
    ``rows_excess`` (the reduced tables against the float64 sum of the
    per-lane mode's row gradients: float association alone),
    ``plain_err``, ``plain_excess`` (against the plain version's: plus
    the per-lane tolerances), and ``out``, the kernel's outputs."""
    from .ops import bounce_bwd_gather_kernel as k5
    from .ops import bounce_bwd_kernel as k7
    is_k5 = len(args) == 11
    per_lane = (k5.bounce_bwd_regen_pre_megakernel if is_k5
                else k7.bounce_bwd_megakernel)
    per_lane_plain = (k5.bounce_bwd_regen_pre_plain if is_k5
                      else k7.bounce_bwd_megakernel_plain)
    reduced = (k5.bounce_bwd_regen_pre_reduced if is_k5
               else k7.bounce_bwd_megakernel_reduced)
    bi = args[4] if is_k5 else args[2]
    n = kw["n_row"] + 7
    ref = per_lane_plain(*args, **kw)
    per = per_lane(*args, **kw)
    lane, rows = reduced(*reduced_args(args, tables), **kw)
    lane_err, lane_excess = bwd_errs(ref[n:], lane)
    differ = sum(int((_abs_diff(a, b) > 0).sum())
                 for a, b in zip(per[n:], lane))
    rows_err, rows_excess = row_grads_errs(tables, per[:n], bi, kw["n_row"],
                                           rows)
    plain_err, plain_excess = row_grads_errs(
        tables, ref[:n], bi, kw["n_row"], rows, bwd_bound(ref)[:n])
    return dict(lane_err=lane_err, lane_excess=lane_excess,
                lane_differ=differ, rows_err=rows_err,
                rows_excess=rows_excess, plain_err=plain_err,
                plain_excess=plain_excess, out=(lane, rows))


def compare_bwd(args, kw):
    """K5 and ``bounce_bwd_regen_pre_plain`` on the same arguments:
    ``(bwd_errs(...), kernel outputs)``."""
    from .ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_plain,
    )
    ref = bounce_bwd_regen_pre_plain(*args, **kw)
    out = bounce_bwd_regen_pre_megakernel(*args, **kw)
    return bwd_errs(ref, out), out


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the fused iteration runs the plain versions of
    kernel B (and its mesh variant) forward and of K5 backward, the
    unfused bounce those of kernel A and K7, and the split path those of
    the crossing kernels K11 and K11b, on any device."""
    from .diff import fused_iter
    from .ops.bounce_kernel import bounce_plain
    from .ops.iter_kernel import iter_plain
    from .ops.volume_kernel import volume_crossings_plain
    from .render import integrator, volumes
    saved = (fused_iter.iter_megakernel, volumes.pallas_volume_crossings,
             volumes.pallas_volume_crossings_bcast,
             integrator.bounce_megakernel)
    fused_iter.iter_megakernel = iter_plain
    integrator.bounce_megakernel = bounce_plain
    volumes.pallas_volume_crossings = volume_crossings_plain
    volumes.pallas_volume_crossings_bcast = \
        lambda vtbl, cbox, *rays, **kw: volume_crossings_plain(vtbl, *rays,
                                                               **kw)
    try:
        with plain_backward():
            yield
    finally:
        (fused_iter.iter_megakernel, volumes.pallas_volume_crossings,
         volumes.pallas_volume_crossings_bcast,
         integrator.bounce_megakernel) = saved


@contextlib.contextmanager
def torch_threads(n: int):
    """Inside the block torch's CPU operators use ``n`` threads.  The CPU
    tests run in several worker processes at once, whose thread pools
    otherwise contend for the same cores (a render test then runs over
    ten times slower than alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def plain_backward():
    """Inside the block the fused iteration's backward runs the plain
    versions of K5 (torch autograd over ``lane_math`` and the torch
    reduction) and of the atlas gradient, and the unfused bounce's
    backward that of K7, on any device."""
    from .ops import bounce_bwd_kernel
    from .ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_reduced_plain,
    )
    from .ops.image_grad_kernel import image_grad_plain
    from .textures import textures
    with _backward_as(bounce_bwd_regen_pre_reduced_plain,
                      bounce_bwd_kernel.bounce_bwd_megakernel_reduced_plain):
        k13 = textures.image_grad_pallas
        textures.image_grad_pallas = image_grad_plain
        try:
            yield
        finally:
            textures.image_grad_pallas = k13


@contextlib.contextmanager
def _backward_as(k5, k7):
    """Inside the block the fused iteration's backward calls ``k5`` in
    place of the reduced K5 and the unfused bounce's ``k7`` in place of
    the reduced K7."""
    from .diff import fused_iter
    from .ops import bounce_bwd_kernel
    saved = (fused_iter.bounce_bwd_regen_pre_reduced,
             bounce_bwd_kernel.bounce_bwd_megakernel_reduced)
    fused_iter.bounce_bwd_regen_pre_reduced = k5
    bounce_bwd_kernel.bounce_bwd_megakernel_reduced = k7
    try:
        yield
    finally:
        (fused_iter.bounce_bwd_regen_pre_reduced,
         bounce_bwd_kernel.bounce_bwd_megakernel_reduced) = saved


@contextlib.contextmanager
def per_lane_backward():
    """Inside the block the fused iteration's and the unfused bounce's
    backward launch K5's and K7's per-lane modes, with the winner rows
    gathered per lane and the row gradients summed by
    :func:`reduce_row_grads` (``index_add_`` over the lanes) in torch:
    the backward as it was before the gather and the reduction moved into
    the kernels, to time against theirs."""
    from .ops.bounce_bwd_gather_kernel import bounce_bwd_regen_pre_megakernel
    from .ops.bounce_bwd_kernel import bounce_bwd_megakernel
    from .ops.row_reduce import winner_rows

    def k5(ttbl, kt, cam, tables, bi, *rest, **kw):
        g = bounce_bwd_regen_pre_megakernel(
            ttbl, kt, cam, winner_rows(tables, bi), bi, *rest, **kw)
        n = kw["n_row"] + 7
        return g[n:], reduce_row_grads(tables, g[:n], bi, kw["n_row"])

    def k7(ttbl, tables, bi, *rest, **kw):
        g = bounce_bwd_megakernel(ttbl, winner_rows(tables, bi), bi, *rest,
                                  **kw)
        n = kw["n_row"] + 7
        return g[n:], reduce_row_grads(tables, g[:n], bi, kw["n_row"])

    with _backward_as(k5, k7):
        yield


# Definitions that let the host C++ compiler build a kernel's body: the
# CUDA qualifiers, the launch indices, the bit casts, the read-only load,
# dynamic shared memory, atomics and the warp primitives.  A runner may
# call a kernel from one thread per lane (one block of one thread per
# lane, blockDim and gridDim 1), or run a block's threads as host threads
# with rt_host_launch, which gives __syncthreads and the warp primitives
# their meaning: each waits for the block's or the warp's threads.
HOST_SHIM = r"""
#include <math.h>
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __shared__ static
using std::max;
using std::min;
struct Dim3 { unsigned x = 0; };
static thread_local Dim3 threadIdx, blockIdx;
static Dim3 blockDim, gridDim;
// n threads meet: the last to arrive releases the others (n < 2: no-op)
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, waiting = 0;
  long gen = 0;
  void wait() {
    if (n < 2) return;
    std::unique_lock<std::mutex> lk(m);
    const long g = gen;
    if (++waiting == n) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
struct HostWarp {
  HostBarrier bar;
  unsigned u[32];
  float f[32];
};
static HostBarrier rt_host_block;
static HostWarp rt_host_warps[32];
static std::mutex rt_host_atomic;
static inline void __syncthreads() { rt_host_block.wait(); }
static inline HostWarp& rt_host_warp() {
  return rt_host_warps[threadIdx.x >> 5];
}
static inline void __syncwarp(unsigned = 0xffffffffu) {
  rt_host_warp().bar.wait();
}
static inline unsigned __match_any_sync(unsigned, int key) {
  HostWarp& w = rt_host_warp();
  w.u[threadIdx.x & 31] = static_cast<unsigned>(key);
  w.bar.wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (w.u[i] == static_cast<unsigned>(key)) m |= 1u << i;
  w.bar.wait();
  return m;
}
static inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  HostWarp& w = rt_host_warp();
  w.u[threadIdx.x & 31] = v;
  w.bar.wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m = std::max(m, w.u[i]);
  w.bar.wait();
  return m;
}
static inline float __shfl_sync(unsigned, float v, int src) {
  HostWarp& w = rt_host_warp();
  w.f[threadIdx.x & 31] = v;
  w.bar.wait();
  const float r = w.f[src];
  w.bar.wait();
  return r;
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
static inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> lk(rt_host_atomic);
  const float old = *p;
  *p = old + v;
  return old;
}
namespace rt {
static float* dyn_smem() {
  static float buf[1 << 16];
  return buf;
}
}  // namespace rt
// blocks 0..n_blocks-1 in order, each as n_threads host threads (whole
// warps) running fn
static void rt_host_launch(int n_blocks, int n_threads,
                           const std::function<void()>& fn) {
  gridDim.x = n_blocks;
  blockDim.x = n_threads;
  rt_host_block.n = n_threads;
  for (auto& w : rt_host_warps) w.bar.n = 32;
  for (int b = 0; b < n_blocks; ++b) {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t)
      ts.emplace_back([=, &fn] {
        threadIdx.x = t;
        blockIdx.x = b;
        fn();
      });
    for (auto& t : ts) t.join();
  }
  rt_host_block.n = 0;
}
"""


def host_library(cu_name: str, runner: str, out_dir):
    """Build the body of ``csrc/<cu_name>`` (everything before its first
    ``extern "C"`` launcher) with the host C++ compiler, behind
    :data:`HOST_SHIM` and followed by ``runner`` (C++ that calls the
    kernel once per lane, or runs its blocks with ``rt_host_launch``),
    into a shared library in ``out_dir``; return it loaded with ctypes,
    or None without a host compiler.  The build uses
    ``-ffp-contract=off``, as the card's uses ``--fmad=false``."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path
    from .ops._build import CSRC
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    src = (CSRC / cu_name).read_text()
    src = src[:src.index('extern "C"')].replace("#include <cuda_runtime.h>",
                                                "")
    out = Path(out_dir)
    stem = Path(cu_name).stem
    (out / f"{stem}.cpp").write_text(HOST_SHIM + src + runner)
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-pthread", "-shared", "-I", str(CSRC), "-o",
                    str(out / f"{stem}.so"),
                    str(out / f"{stem}.cpp")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out / f"{stem}.so"))
