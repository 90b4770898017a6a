"""Scenes, lane states and kernel-versus-plain comparisons shared by
``chip_smoke.py`` and the tests.

The world and settings builders of the scene drivers
(``raytrace_tpu_torch/scenes/``: ``cornell_box``, ``noise_test``,
``cuboid_test``, ``demo2``, ``cornell_smoke``, ``pawn_test``'s camera,
``_assets.earthmap``) are re-exported here under the names below.

* :func:`cornell_scene_and_settings` (over :func:`cornell_world` and
  :func:`cornell_settings`) and :func:`all_materials_scene` build, with
  the port's own builder, the Cornell box of
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
* The rest of M11: :func:`demo2_scene` (``scenes/demo2.py``: 1,407
  surface rows, a fog and a subsurface medium, the earth on a rotated
  sphere, marble; :data:`DEMO2_SEED`, :data:`DEMO2_GRAD`),
  :func:`ellipsoid_scene` (the Cornell box with three ellipsoids: scaled
  and rotated, earth-textured, moving; :func:`scale3`) and
  :func:`rotated_spheres_scene` (32 rotated checker spheres), whose
  :func:`sphere_rot_inputs` are the shade kernel's inputs with its
  in-kernel sphere uv and rotation table.
* :data:`FWD_BWD` is the fwd+bwd configuration of ``bench.py`` and
  :func:`fwd_bwd_pixels` its lanes; :data:`MESH_FWD_BWD` the mesh
  configuration of ``tools/prof_bunny_grad.py``;
  :data:`IMAGE_GRAD_FWD_BWD` that of ``tools/prof_texture_grad.py``.
* Several processes: :func:`run_ranks` runs a function on spawned ranks
  joined in one gloo group (a ``file://`` rendezvous, a time limit that
  kills them); :func:`sharded_forward_cases` is what each rank of the
  sharding tests renders (:func:`sharding_world`, ``tests/
  test_sharding.py``'s scene, and :func:`many_spheres_world`);
  :func:`free_port` a localhost port for a TCP rendezvous.
* :func:`bounce_inputs`, :func:`primary_bounce_inputs`,
  :func:`next_bounce_inputs`, :func:`iter_state` and :func:`fresh_carry`
  make lane inputs for the kernels: random ones from a numpy seed, or the
  ones the stationary driver gives them; :func:`route_marble_lanes` and
  :func:`marble_patterns` those of the marble kernel K12 (the route's
  compacted rich lanes, and patterns of marble and other lanes).
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
  :func:`per_turn_loss` builds the fused driver's loss turn by turn, to
  hold its whole-loop node against; :func:`tape_nodes` counts a tape's
  nodes by name.

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
import dataclasses

import numpy as np
import torch

from .scenes import (
    _assets, bunny_test, cornell_box, cornell_smoke, cuboid_test, demo2,
    noise_test, pawn_test,
)

# the world and settings builders of the scene drivers, under the names
# the smoke and the tests use
cornell_world = cornell_box.world
noise_test_world = noise_test.world
noise_test_settings = noise_test.settings
noise_test_scene = noise_test.scene
earthmap = _assets.earthmap
cuboid_test_world = cuboid_test.world
demo2_world = demo2.world
demo2_settings = demo2.settings
demo2_scene = demo2.scene
DEMO2_LIGHT = demo2.LIGHT
DEMO2_SEED = demo2.SEED
cornell_smoke_world = cornell_smoke.world
cornell_smoke_settings = cornell_smoke.settings
cornell_smoke_scene = cornell_smoke.scene
pawn_standin_settings = pawn_test.settings
# demo2's fwd+bwd: grad_render over 2^16 pixels spread evenly over the
# image x 4 samples at the scene's depth 4
DEMO2_GRAD = dict(pixels=1 << 16, samples=4)

# kernel vs plain: the tolerance of tests/test_bounce_kernel.py
ATOL, RTOL = 2e-3, 1e-3
# the crossing kernels' candidate mode against its plain version on the
# card: t_med's largest distance in ulps where both scatter (the kernel's
# logf against torch's log, the one operation the two do not share)
CAND_ULPS = 0
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
# the media fwd+bwd through the generic differentiable bounce: cornell_smoke
# at 600 x 600, depth 50, RR from depth 2, 2^18 lanes x 16 spp, each
# iteration checkpointed, 100 iterations then 40 at 2^14 and 100 at 2^12
# lanes; the pawn stand-in at 500 x 500, depth 20, 2^17 lanes x 4 spp
SMOKE_FWD_BWD = dict(rr_depth=2, lanes=1 << 18, spp=16, n_iters=100,
                     schedule=((40, 1 << 14), (100, 1 << 12)), remat=True)
PAWN_FWD_BWD = dict(rr_depth=2, lanes=1 << 17, spp=4, n_iters=60,
                    remat=True)
# grad_render on cornell_smoke at 600 x 600, depth 50: a tile of 2^16
# pixels (0 .. 2^16) x 4 samples
SMOKE_GRAD_RENDER = dict(pixels=1 << 16, samples=4)


def cornell_settings(rt, width=16, spp=4, depth=6):
    """The Cornell box's camera (:func:`.scenes.cornell_box.settings`)
    at the small defaults of the tests: one MIS redirect target on the
    light, black background."""
    return cornell_box.settings(rt, width, spp, depth)


def cornell_scene_and_settings(width=16, spp=4, depth=6, device="cuda"):
    """The Cornell box of ``__graft_entry__._cornell_scene_and_settings``
    (:func:`.scenes.cornell_box.scene` at the tests' small defaults)."""
    return cornell_box.scene(width, spp, depth, device)


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


def image_panel_scene(width: int = 16, spp: int = 2, max_depth: int = 4,
                      device="cuda"):
    """``(scene, settings)``: a lambertian panel with a 4 x 8 image
    texture, lit by a panel light, constant background 0.2; the smallest
    scene of rich textures that the fused differentiable driver takes."""
    import raytrace_tpu_torch as rt
    img = (torch.arange(4 * 8 * 3) % 7 / 7.0).reshape(4, 8, 3).numpy()
    scene = rt.compile_scene(rt.group([
        rt.with_material(rt.lambertian(rt.image_texture(img)),
                         rt.parallelogram([-2, -1, -4], [4, 0, 0],
                                          [0, 2, 0])),
        rt.with_material(rt.light_source(rt.constant_texture(3.0)),
                         rt.parallelogram([-2, 4, -5], [4, 0, 0],
                                          [0, 0, 4]))]), device=device)
    settings = rt.CameraSettings(image_width=width, samples_per_pixel=spp,
                                 max_depth=max_depth,
                                 background=rt.const_background(0.2))
    return scene, settings


def scale3(sx: float, sy: float, sz: float) -> np.ndarray:
    """The 4 x 4 matrix of a non-uniform scale."""
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def ellipsoid_world(rt):
    """The Cornell box (:func:`cornell_world`) with three ellipsoids: a
    blue one scaled by (1.5, 0.6, 1.0) and rotated, lying on the short
    box; an earth-textured one (its uv in object space, the image
    :func:`earthmap`) at the front right; and an orange one moving along
    x under the light.  ``rt`` is the builder module (this package or the
    JAX one)."""
    deg = rt.degrees
    blue = rt.lambertian(rt.constant_texture([0.2, 0.4, 0.9]))
    orange = rt.lambertian(rt.constant_texture([0.8, 0.45, 0.1]))
    earth = rt.lambertian(rt.image_texture(earthmap()))
    return rt.group([
        cornell_world(rt),
        rt.transform(
            rt.compose(rt.translate([212, 215, 147]), rt.rotate_y(deg(30)),
                       rt.rotate_z(deg(10)), scale3(1.5, 0.6, 1.0)),
            rt.with_material(blue, rt.sphere([0, 0, 0], 50))),
        rt.transform(
            rt.compose(rt.translate([450, 95, 130]), rt.rotate_y(deg(60)),
                       scale3(1.0, 1.1, 0.8)),
            rt.with_material(earth, rt.sphere([0, 0, 0], 80))),
        rt.moving([0, 0, 0], [40, 0, 0], rt.transform(
            rt.compose(rt.translate([260, 420, 300]), scale3(1.2, 0.7, 0.9)),
            rt.with_material(orange, rt.sphere([0, 0, 0], 50)))),
    ])


def ellipsoid_scene(width: int = 600, spp: int = 16, depth: int = 50,
                    device="cuda"):
    """``(scene, settings)``: :func:`ellipsoid_world` under the Cornell
    camera (:func:`cornell_settings`): 18 surface rows (the flat scan K8)
    and 3 ellipsoids merged after it; the earth's image sends it to the
    split path."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(ellipsoid_world(rt), device=device),
            cornell_settings(rt, width, spp, depth))


def rotated_spheres_world(rt, n: int = 8):
    """An n x n grid of checker spheres (8 x 4 cells) on a grey ground,
    every other one rotated about a random axis by a random angle (numpy
    seed 0), so that ``sphere_rots`` lists n^2 / 2 rows.  ``rt`` is the
    builder module (this package or the JAX one)."""
    rg = np.random.default_rng(0)
    check = rt.lambertian(rt.checker_texture(8, 4, [0.9, 0.2, 0.1],
                                             [0.1, 0.3, 0.9]))
    parts = [rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                              rt.parallelogram([-50, 0, 50], [100, 0, 0],
                                               [0, 0, -100]))]
    for k in range(n * n):
        c = [2.5 * (k % n) - 1.25 * (n - 1), 1.0, -2.5 * (k // n)]
        ball = rt.with_material(check, rt.sphere([0, 0, 0], 1.0))
        rot = np.eye(4)
        if k % 2:
            axis = (rt.rotate_x, rt.rotate_y, rt.rotate_z)[k % 3]
            rot = axis(float(rg.uniform(0.3, 3.0)))
        parts.append(rt.transform(rt.compose(rt.translate(c), rot), ball))
    return rt.group(parts)


def rotated_spheres_scene(width: int = 600, device="cuda"):
    """``(scene, settings)``: :func:`rotated_spheres_world` seen from above
    the front of the grid, sky background, 1 spp, depth 4."""
    import raytrace_tpu_torch as rt
    settings = rt.CameraSettings(
        center=np.asarray([0.0, 9.0, 9.0]),
        look_at=np.asarray([0.0, 0.0, -8.0]), vfov=rt.degrees(60),
        aspect_ratio=1.0, image_width=width, samples_per_pixel=1,
        max_depth=4, background=rt.sky)
    return rt.compile_scene(rotated_spheres_world(rt), device=device), \
        settings


def sphere_rot_inputs(scene, s, seed: int, pixels=None):
    """The shade kernel's inputs with its sphere uv evaluated in the
    kernel: the split tables of ``scene``, the hit record of
    :func:`camera_rays` (``pixels``, or one ray a pixel of ``s``'s image
    rounded up to 128 lanes) with sphere flag 1 on every sphere lane and,
    on every third lane that misses, a winner index ``-2 - e`` (an
    ellipsoid's, e in 0..1), random throughput, 90% of the lanes alive and
    fresh uniforms.  Returns ``(tables, hit, lanes, uniforms)``."""
    from .core import rng
    from .render.integrator import split_tables, surface_hit
    tb = split_tables(scene, s)
    n_pix = s.image_width * s.image_height
    n = (-(-n_pix // 128) * 128 if pixels is None else pixels.shape[0])
    comps, _ = camera_rays(scene, s, n, seed, pixels=pixels)
    dev = comps.device
    hit = list(surface_hit(tb, comps[0:3], comps[3:6], comps[6]))
    k = torch.clamp(hit[1], min=0).long()
    hit[9] = ((hit[1] >= 0) & (scene.prims.kind[k] == 0)).to(torch.float32)
    lane = torch.arange(n, device=dev)
    fake = ~torch.isfinite(hit[0]) & (lane % 3 == 0)
    hit[1] = torch.where(fake, -2.0 - (lane % 2).to(torch.float32), hit[1])
    rg = np.random.default_rng(seed)
    thr = _tensor(rg.uniform(0.2, 1.0, (3, n)).astype(np.float32), dev)
    al = _tensor((rg.uniform(size=n) < 0.9).astype(np.float32), dev)
    keys = rng.ray_keys_fast(rng.base_key(seed, dev),
                             lane.to(torch.int32),
                             torch.zeros(n, dtype=torch.int32, device=dev))
    uni = rng.uniform_cols(keys, 8).contiguous()
    lanes = tuple(x.contiguous() for x in comps[0:6]) + tuple(thr) + (al,)
    return tb, tuple(x.contiguous() for x in hit), lanes, uni


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
    return (rt.compile_scene(bunny_standin_world(rt), device=device),
            bunny_test.settings(rt, width, spp, depth))


# bigmesh-512: tools/bench_bigmesh.py at --lat 512 --lon 512, 523,264
# triangles (523,328 kind-segmented rows with the floor and the light);
# its grad_render tile (2^16 pixels spread over the image x 4 samples)
BIGMESH = dict(n_lat=512, n_lon=512)
BIGMESH_GRAD = dict(pixels=1 << 16, samples=4)


def bigmesh_mesh(rt, n_lat: int, n_lon: int):
    """``tools/bench_bigmesh.py``'s mesh: ``uv_sphere(n_lat, n_lon)``
    scaled by 1.5, no uv."""
    v, f = uv_sphere(n_lat, n_lon)
    return rt.Mesh(vertices=v * 1.5, uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full_like(f, -1))


def bigmesh_world(rt, n_lat: int, n_lon: int, mesh=None):
    """``tools/bench_bigmesh.py:build_scene``'s world: the mesh
    (:func:`bigmesh_mesh`, or ``mesh``, e.g. read back from its .obj) in
    a lambertian (0.7, 0.6, 0.5) on a grey floor parallelogram under an
    8.0 light parallelogram.  ``rt`` is the builder module (this package
    or the JAX one)."""
    if mesh is None:
        mesh = bigmesh_mesh(rt, n_lat, n_lon)
    return rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture([0.7, 0.6, 0.5])),
                         rt.triangle_mesh(mesh)),
        rt.with_material(rt.lambertian(rt.constant_texture([0.5, 0.5, 0.5])),
                         rt.parallelogram([-50, -1.51, -50], [100, 0, 0],
                                          [0, 0, 100])),
        rt.with_material(rt.light_source(rt.constant_texture(8.0)),
                         rt.parallelogram([-3, 8, -3], [6, 0, 0],
                                          [0, 0, 6])),
    ])


def bigmesh_settings(rt, width: int = 512, spp: int = 16, depth: int = 8):
    """``tools/bench_bigmesh.py``'s camera: from (0, 1.5, -7) at the
    origin, vfov 0.7, square, a constant 0.05 background."""
    return rt.CameraSettings(
        center=np.asarray([0.0, 1.5, -7.0]),
        look_at=np.asarray([0.0, 0.0, 0.0]), vfov=0.7, aspect_ratio=1.0,
        image_width=width, samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.05))


def bigmesh_scene(n_lat: int, n_lon: int, width: int = 512, spp: int = 16,
                  depth: int = 8, mesh=None, device="cuda"):
    """``(scene, settings)`` of :func:`bigmesh_world` and
    :func:`bigmesh_settings` (at ``BIGMESH``: 523,264 triangles; past
    65,536 surface rows the default ``accel`` gives the BVH mode on the
    CPU and a kind-segmented table on the card)."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(bigmesh_world(rt, n_lat, n_lon, mesh),
                             device=device),
            bigmesh_settings(rt, width, spp, depth))


def mesh_obj_text(v, f) -> str:
    """.obj text of the vertices ``v`` [V, 3] and triangles ``f`` [F, 3]
    (0-based): ``v`` lines with 17 significant digits (so a parse gives
    ``v`` back exactly), then 1-based ``f`` lines."""
    import io
    buf = io.StringIO()
    np.savetxt(buf, np.asarray(v, np.float64), fmt="v %.17g %.17g %.17g")
    np.savetxt(buf, np.asarray(f, np.int64) + 1, fmt="f %d %d %d")
    return buf.getvalue()


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


def nine_target_settings(rt, width: int = 600, spp: int = 200,
                         depth: int = 50):
    """cornell_smoke's camera with nine redirect targets, the 3 x 3 cells
    of its light, each of probability 1/12: more targets than the shade
    kernel's eight, so the forward takes the generic bounce."""
    cells = [(1.0 / 12.0, [113 + 110 * i, 554, 127 + 305 / 3 * j],
              [110, 0, 0], [0, 0, 305 / 3])
             for i in range(3) for j in range(3)]
    return rt.CameraSettings(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, background=rt.const_background(0.0),
        vfov=rt.degrees(40), center=np.asarray([278.0, 278.0, -800.0]),
        look_at=np.asarray([278.0, 278.0, 0.0]),
    ).with_redirect_targets(cells)


def nine_target_scene(width: int = 600, spp: int = 200, depth: int = 50,
                      device="cuda"):
    """``(scene, settings)``: cornell_smoke's world under
    :func:`nine_target_settings` (the generic bounce's forward, its media
    through K11's candidate mode)."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(cornell_smoke_world(rt), device=device),
            nine_target_settings(rt, width, spp, depth))


def fog_world(rt, density: float = 0.8):
    """The JAX package's density-gradient scene
    (``tests/test_gradients.py:366-383``): a light quad seen through a
    fog sphere, so the transmitted light depends strongly on the
    density."""
    return rt.group([
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-2, -2, -4], [4, 0, 0],
                                          [0, 4, 0])),
        rt.with_material(rt.isotropic(rt.constant_texture(0.3)),
                         rt.constant_medium(density,
                                            rt.sphere([0, 0, -2], 1.0))),
    ])


def fog_settings(rt, width: int = 16, spp: int = 8, depth: int = 12):
    """The fog scene's camera (``tests/test_gradients.py:386-389``)."""
    return rt.CameraSettings(
        image_width=width, samples_per_pixel=spp, max_depth=depth,
        center=np.asarray([0.0, 0.0, 1.0]),
        look_at=np.asarray([0.0, 0.0, -2.0]), vfov=1.0,
        background=rt.const_background(0.0))


def marble_light_world(rt):
    """A marble-textured spherical light over a grey ground, beside a
    blue diffuse ball and a fuzzy metal one: a light with a rich texture,
    which kernel A and the split path refuse, so the forward takes the
    generic bounce (its stripes through K12)."""
    return rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture(0.6)),
                         rt.parallelogram([-8, -1, 4], [16, 0, 0],
                                          [0, 0, -16])),
        rt.with_material(rt.light_source(rt.marble_texture([0, 0, 1], 2.0)),
                         rt.sphere([0, 0.6, -4], 1.4)),
        rt.with_material(rt.lambertian(rt.constant_texture([0.2, 0.4, 0.8])),
                         rt.sphere([2.6, 0.0, -3.5], 1.0)),
        rt.with_material(rt.metal(0.2, rt.constant_texture(0.8)),
                         rt.sphere([-2.6, 0.0, -3.5], 1.0)),
    ])


def marble_light_settings(rt, width: int = 400, spp: int = 16,
                          depth: int = 50):
    """The marble-lit scene's camera: square, vfov 40 degrees, a dim sky
    of 0.05."""
    return rt.CameraSettings(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, center=np.asarray([0.0, 1.5, 4.0]),
        look_at=np.asarray([0.0, 0.3, -4.0]), vfov=rt.degrees(40),
        background=rt.const_background(0.05))


def marble_light_scene(width: int = 400, spp: int = 16, depth: int = 50,
                       device="cuda"):
    """``(scene, settings)`` of :func:`marble_light_world`."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(marble_light_world(rt), device=device),
            marble_light_settings(rt, width, spp, depth))

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


def pawn_standin_scene(width: int = 500, spp: int = 400, depth: int = 20,
                       device="cuda"):
    """``(scene, settings)`` of ``scenes/pawn_test.py`` (500 x 500, 400
    spp, depth 20 there) with the stand-in pawn: a 1,216-row
    kind-segmented shell (the BVH walk, K9) and a 1,200-row medium
    boundary (kernel K11b), rendered by the sorted driver."""
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(pawn_standin_world(rt), device=device),
            pawn_standin_settings(rt, width, spp, depth))


def pawn_two_media_scene(width: int = 64, spp: int = 4, depth: int = 20,
                         device="cuda"):
    """``(scene, settings)``: :func:`pawn_standin_world` with a blue fog
    ball beside the pawn, a second medium, so a bounce draws 8 + 2
    uniform columns and HEAD an even 16 (the pawn alone: 15)."""
    import raytrace_tpu_torch as rt
    fog = rt.with_material(
        rt.isotropic(rt.constant_texture([0.3, 0.4, 0.9])),
        rt.constant_medium(0.8, rt.sphere([2.2, 1.5, 0.5], 1.0)))
    return (rt.compile_scene(rt.group([pawn_standin_world(rt), fog]),
                             device=device),
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


def mixed_media_world(rt, moving: bool = False):
    """Four media of mixed sizes in one boundary table of 1,266 rows, so
    all four take kernel K11b: the stand-in pawn (1,200 triangles), a fog
    ball (a sphere row), a smoke box (a ``PRIM_BOX`` row) and a 64-triangle
    uv sphere, over a ground parallelogram; with ``moving`` all four move.
    :data:`MIXED_MEDIA_INSIDE` are points inside each.  ``rt`` is the
    builder module (this package or the JAX one)."""
    v, f = pawn_standin_mesh()
    sv, sf = uv_sphere(5, 8)
    p = sv[sf]
    if np.einsum("ij,ij->i", p[:, 0], np.cross(p[:, 1], p[:, 2])).sum() < 0:
        sf = sf[:, ::-1].copy()             # wind the normals outward
    mesh = lambda vv, ff: rt.triangle_mesh(rt.Mesh(
        vertices=vv, uv=np.zeros((0, 2)), faces=ff,
        uv_faces=np.full_like(ff, -1)))
    media = rt.group([
        rt.with_material(rt.isotropic(rt.constant_texture([1.0, 0.2, 0.2])),
                         rt.constant_medium(5.0, mesh(v, f))),
        rt.with_material(rt.isotropic(rt.constant_texture(0.8)),
                         rt.constant_medium(0.7, rt.sphere([4, 1, 0], 1.0))),
        rt.with_material(rt.anisotropic(0.4, rt.constant_texture(0.9)),
                         rt.constant_medium(1.2, rt.cuboid([-5, 0, -1],
                                                           [-3, 2, 1]))),
        rt.with_material(rt.pitch_black(),
                         rt.constant_medium(2.0, mesh(sv + [0.0, 1.5, 4.0],
                                                      sf))),
    ])
    if moving:
        media = rt.moving([0, 0, 0], [0.3, 0.2, -0.2], media)
    return rt.group([media, rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)),
        rt.parallelogram([-20, -1, -20], [40, 0, 0], [0, 0, 40]))])


# points inside each medium of mixed_media_world (before it moves)
MIXED_MEDIA_INSIDE = ([0.0, 2.0, 0.0], [4.0, 1.0, 0.0], [-4.0, 1.0, 0.0],
                      [0.0, 1.5, 4.0])


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
    """Kernel A, with the tables prepared as the drivers launch it (its
    planar instantiation where ``tables.launch.planar``), and
    ``bounce_plain`` on the same lane arguments: returns
    ``(max_errs(...), kernel outputs)``."""
    from .ops.bounce_kernel import bounce_megakernel, bounce_plain
    tb = tables
    ref = bounce_plain(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw)
    out = bounce_megakernel(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw,
                            prepared=tb.launch)
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
    """Kernel B (or, for a mesh-scale table, its mesh variant), prepared
    as the drivers launch it (the planar instantiation where it serves the
    table), against ``iter_plain`` on ``n`` lanes of the image of ``s``:
    one iteration from a random state (origins in ``box``), with the
    winner's uv (``max_errs``), then ``n_iters`` from a fresh state
    (fraction of lanes whose summed radiance differs by more than 1e-5,
    relative mean difference, max abs difference)."""
    from .core import rng
    from .diff.fused_iter import iter_kernel_args
    from .ops.iter_kernel import (
        iter_megakernel, iter_plain, next_carry, prepare_iter,
    )
    dev = scene.device
    tables, kw = iter_kernel_args(scene, s, rng.base_key(seed, dev), 7)
    n_pix = s.image_width * s.image_height
    pix, carry = iter_state(n, n_pix, seed, dev, box)
    lane_in = (pix,) + carry
    kw_uv = {k: v for k, v in kw.items() if k != "prepared"}
    kw_uv["with_uv"] = True
    kw_uv["prepared"] = prepare_iter(*tables, **kw_uv)
    ref = iter_plain(*tables, lane_in, **kw_uv)
    out = iter_megakernel(*tables, lane_in, **kw_uv)
    one = max_errs(ref, out, ITER_INT_ROWS)

    acc = []
    for fn in (iter_plain, iter_megakernel):
        c = fresh_carry(n, dev)
        a = torch.zeros((3, n), device=dev)
        for _ in range(n_iters):
            o = fn(*tables, (pix,) + c, **kw)
            c = next_carry(o)
            a += torch.stack(o[7:10]) * o[16]
        acc.append(a)
    diff = (acc[0] - acc[1]).abs().amax(0)
    frac = float((diff > 1e-5).float().mean())
    mean_rel = abs(float(acc[1].mean()) / float(acc[0].mean()) - 1.0)
    return one, frac, mean_rel, float(diff.max())


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


def route_marble_lanes(scene, s, seed: int):
    """``(tex_ids [R] i64, points [R, 3])``: what the forward route hands
    K12 for one camera ray a pixel of ``s``: the lanes whose hit has a
    rich texture, compacted in lane order by ``torch.nonzero`` as
    ``integrator.rich_albedo_multiply`` compacts them, with their texture
    ids and hit points (noise_test: the noise ground's lanes and the
    marble ball's, interleaved row by row)."""
    from .render.integrator import split_tables
    from .textures.textures import TEX_CHECKER
    tb = split_tables(scene, s)
    comps, _ = camera_rays(scene, s, s.image_width * s.image_height, seed)
    pts, hit = surface_points(tb, comps)
    tex = scene.materials.tex[hit[8].long()].long()
    live = torch.isfinite(hit[0]) & (scene.textures.kind[tex] > TEX_CHECKER)
    sel = torch.nonzero(live)[:, 0]
    return tex[sel], pts[sel].contiguous()


def compare_marble(table, tex_ids, points, mtbl=None):
    """Kernel K12 and ``marble_stripe_plain`` on the same lanes (and the
    same marble table ``mtbl``, by default ``marble_table(table)``):
    ``(max_errs(...), kernel output)``; the caller holds the error to
    0."""
    from .ops.texture_kernel import marble_stripe_pallas, marble_stripe_plain
    ref = marble_stripe_plain(table, tex_ids, points, mtbl)
    out = marble_stripe_pallas(table, tex_ids, points, mtbl)
    return max_errs((ref,), (out,), ()), out


def marble_patterns(seed: int, n: int = 90_112):
    """K12's lane patterns beside a render's: ``{name: (table, tex_ids,
    points, mtbl)}`` on the CPU over a table of 4 constant and 32 marble
    textures, ``n`` lanes (``n`` - 13 for "ragged") of random points:
    marble and non-marble lanes alternating ("alternating"); every lane
    marble ("all"); none ("none"); a lane count that is not a multiple of
    the kernel's 32-lane tile ("ragged"), these four over the first 2
    marble rows; and all 32 marble rows in a shuffled order, one row's id
    repeated by a later row with other parameters, so that the later row
    wins ("rows32")."""
    from .ops.texture_kernel import marble_table
    from .textures.textures import (
        compile_textures, constant_texture, marble_texture,
    )
    rg = np.random.default_rng(seed)
    texs = [constant_texture(rg.uniform(0, 1, 3)) for _ in range(4)]
    texs += [marble_texture(rg.normal(size=3), float(rg.uniform(0.5, 8)),
                            shift=tuple(rg.uniform(-1, 1, 3)))
             for _ in range(32)]
    table = compile_textures(texs)
    mtbl = marble_table(table)
    shuffled = mtbl[torch.from_numpy(rg.permutation(32))].clone()
    shuffled[20, 0] = shuffled[5, 0]          # row 20 wins over row 5
    pts = torch.from_numpy(rg.uniform(-4, 4, (n, 3)).astype(np.float32))
    marble = torch.from_numpy(rg.integers(4, 6, n))
    const = torch.from_numpy(rg.integers(0, 4, n))
    alt = torch.where(torch.arange(n) % 2 == 0, marble, const)
    two = mtbl[:2].clone()
    return {"alternating": (table, alt, pts, two),
            "all": (table, marble, pts, two),
            "none": (table, const, pts, two),
            "ragged": (table, alt[:n - 13], pts[:n - 13].contiguous(), two),
            "rows32": (table, torch.from_numpy(rg.integers(0, 36, n)), pts,
                       shuffled)}


def compare_crossings(volumes, comps, t_min: float = 1e-3, tables=None,
                      prepared: bool = False):
    """The crossing kernel of ``volumes`` (K11b for a mesh-scale boundary,
    else K11) and ``volume_crossings_plain`` on the rays ``comps`` [7, R]:
    ``(max_errs(...) with the front flags as exact rows, kernel
    outputs)``.  Without ``prepared`` the wrappers check the tables and
    K11 runs its general instantiation; with it the launches of
    ``tables`` (``render/volumes.py:volume_tables``; K11's planar
    instantiation where it serves them, unless :func:`general_tables`
    made them) run, as ``volume_crossings`` runs them."""
    from .ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
        volume_crossings_plain,
    )
    from .render.volumes import crossing_kw, volume_crossings, volume_tables
    tables = volume_tables(volumes) if tables is None else tables
    vtbl, forest = tables.vtbl, tables.forest
    kw = crossing_kw(volumes, t_min)
    rays = tuple(comps.unbind(0))
    ref = volume_crossings_plain(vtbl, *rays, **kw)
    if prepared:
        out = volume_crossings(volumes, rays, t_min, tables)
    elif forest is None:
        out = pallas_volume_crossings(vtbl, *rays, **kw)
    else:
        out = pallas_volume_crossings_bcast(vtbl, forest, *rays, **kw)
    return max_errs(ref, out, tuple(range(1, len(ref), 3))), out


def keyed_plain(vtbl, *rays, **kw):
    """``volume_crossings_plain(..., keys=True)`` as one list: the 3V
    crossing rows, then the 2V key rows (as f32)."""
    from .ops.volume_kernel import volume_crossings_plain
    outs, keys = volume_crossings_plain(vtbl, *rays, keys=True, **kw)
    return outs + [k.to(torch.float32) for k in keys]


def keyed_check(n_vol: int):
    """The comparison of :func:`checked_launches` for the keyed mode's
    :func:`keyed_plain` lists of ``n_vol`` media: the front flags and the
    keys as exact rows."""
    exact = tuple(range(1, 3 * n_vol, 3)) + tuple(range(3 * n_vol,
                                                        5 * n_vol))
    return lambda ref, out: max_errs(ref, out, exact)


def compare_keyed(volumes, comps, t_min: float = 1e-3, tables=None):
    """The keyed mode of the crossing kernels of ``volumes`` (the launches
    of ``tables``, ``render/volumes.py:volume_crossings_keyed``) against
    :func:`keyed_plain` on the rays ``comps`` [7, R]: ``(max_errs(...)
    with the flags and keys as exact rows, lanes whose keyed crossings
    differ from the crossings mode's)``."""
    from .render.volumes import (
        crossing_kw, volume_crossings, volume_crossings_keyed, volume_tables,
    )
    tables = volume_tables(volumes) if tables is None else tables
    rays = tuple(comps.unbind(0))
    ref = keyed_plain(tables.vtbl, *rays, **crossing_kw(volumes, t_min))
    outs, keys = volume_crossings_keyed(volumes, rays, t_min, tables)
    plain_mode = volume_crossings(volumes, rays, t_min, tables)
    n_mode = sum(int((a != b).sum()) for a, b in zip(outs, plain_mode))
    got = outs + [k.to(torch.float32) for k in keys]
    return keyed_check(volumes.n_volumes)(ref, got), n_mode


def general_tables(tables):
    """``tables`` (``render/volumes.py:volume_tables``) with every launch
    prepared again for K11's general instantiation."""
    from .ops.volume_kernel import prepare_volume_launch
    return dataclasses.replace(tables, launches=tuple(
        prepare_volume_launch(x.vtbl, x.forest, slices=x.slices,
                              has_motion=x.has_motion, has_box=x.has_box,
                              density=x.density, mats=x.mats, general=True)
        for x in tables.launches))


def scatter_draws(n_vol: int, r: int, seed: int, device="cpu"):
    """[V, R] draws of the media's scatter columns as the bounce draws
    them (multiples of 2^-16), exactly 0 on every 7th lane."""
    rg = np.random.default_rng(seed)
    u = (rg.integers(0, 1 << 16, (n_vol, r)) / 65536.0).astype(np.float32)
    u[:, ::7] = 0.0
    return _tensor(u, device)


def ulp_diff(a, b) -> int:
    """The largest distance in float32 units in the last place between
    ``a`` and ``b`` over the lanes where both are finite (0 if none)."""
    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0
    ia = a[both].view(torch.int32).to(torch.int64)
    ib = b[both].view(torch.int32).to(torch.int64)
    # the integers of IEEE floats, made monotonic across the sign
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def compare_medium_hit(volumes, comps, u, t_min: float = 1e-3, tables=None):
    """``render/volumes.py:medium_hit`` (on CUDA tensors the candidate mode
    of K11 or K11b, one launch per group of 16 media, over the prepared
    launches of ``tables``) and its plain version
    (``volume_candidates_plain`` over every medium) on the rays ``comps``
    [7, R] with the draws ``u`` [V, R]: ``((lanes whose material id or
    whether they scatter differ, max abs error of t_med, its largest ulp
    distance), (t_med, vmat))``."""
    from .ops.volume_kernel import volume_candidates_plain
    from .render.volumes import crossing_kw, medium_hit, volume_tables
    tables = volume_tables(volumes) if tables is None else tables
    rays = tuple(comps.unbind(0))
    r = comps.shape[1]
    ref = volume_candidates_plain(
        tables.vtbl, *rays, u=u,
        t_med=torch.full((r,), float("inf"), device=comps.device),
        vmat=torch.zeros(r, device=comps.device), density=volumes.density,
        mats=volumes.mat.tolist(), **crossing_kw(volumes, t_min))
    out = medium_hit(volumes, rays, t_min, u, tables)
    n_int = int(((ref[1] != out[1])
                 | (torch.isfinite(ref[0]) != torch.isfinite(out[0])))
                .sum())
    _, err, _ = max_errs(ref, out, (1,))
    return (n_int, err, ulp_diff(ref[0], out[0])), out


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
def checked_launches(sample: int | None = None):
    """Inside the block, every kernel A launch of the render drivers,
    every nearest-hit (BVH walk and flat scan), medium crossing (K11,
    K11b, any mode: the keyed one's keys as exact rows), shade and marble
    kernel launch of the split path and the generic bounce, every kernel
    B launch of the fused step (the rotated mode's planes too), every
    atlas-gradient launch of its backward and every HEAD and TAIL launch
    of the sorted driver (:func:`sorted_turn_checks`) is held against its
    plain version on the same inputs (run first: the candidate mode
    updates its rows in place).  Yields
    ``{kernel name: stats}`` with ``launches`` (checked), ``n_int``
    (differing exact-row lanes, summed), ``err`` (max abs float error)
    and ``excess`` (worst tolerance excess; the atlas gradient's is
    :func:`image_grad_errs`', the candidate mode's its ulps over
    :data:`CAND_ULPS`).  With ``sample``, each launch of the BVH walk
    (K9) is held on ``sample`` of its lanes spread evenly over them (its
    plain version scans every row for every lane it is given: a table of
    half a million rows would take it minutes over a whole launch)."""
    from .diff import fused_iter
    from .ops.allpairs_kernel import allpairs_nearest_plain
    from .ops.bounce_kernel import bounce_plain, shade_plain
    from .ops.image_grad_kernel import image_grad_plain
    from .ops.intersect_kernel import pallas_nearest_plain
    from .ops.iter_kernel import iter_plain
    from .ops.texture_kernel import marble_stripe_plain
    from .ops.volume_kernel import (
        volume_candidates_plain, volume_crossings_plain,
    )
    from .render import integrator, volumes
    from .textures import textures
    stats = {}

    def pick(n):
        k = n if sample is None else min(sample, n)
        return torch.arange(k, dtype=torch.int64) * n // k

    def nearest_plain(tbl, bvh, *rays, **kw):
        lanes = pick(rays[0].shape[0]).to(rays[0].device)
        return allpairs_nearest_plain(tbl, *(x[lanes] for x in rays), **kw)

    def nearest_check(args, ref, out):
        lanes = pick(args[2].shape[0]).to(args[2].device)
        return max_errs(ref, tuple(x[lanes] for x in out), NEAREST_INT_ROWS)

    def crossings_bcast_plain(vtbl, forest, *rays, **kw):
        return volume_crossings_plain(vtbl, *rays, **kw)

    def candidates_bcast_plain(vtbl, forest, *rays, **kw):
        return volume_candidates_plain(vtbl, *rays, **kw)

    def crossing_check(args, ref, out):
        return max_errs(ref, out, tuple(range(1, len(ref), 3)))

    def keyed_kernel_check(args, ref, out):
        n_vol = len(ref) // 5
        return keyed_check(n_vol)(ref, out[0] + [k.to(torch.float32)
                                                 for k in out[1]])

    def keyed_bcast_plain(vtbl, forest, *rays, **kw):
        return keyed_plain(vtbl, *rays, **kw)

    def candidate_check(args, ref, out):
        # the material id and whether a lane scatters exact, t_med's max
        # abs error, and its ulps over CAND_ULPS as the excess
        n_int, err, _ = max_errs(ref, out, (1,))
        n_int += int((torch.isfinite(ref[0]) != torch.isfinite(out[0]))
                     .sum())
        return n_int, err, ulp_diff(ref[0], out[0]) - CAND_ULPS

    def rows(int_rows):
        return lambda args, ref, out: max_errs(ref, out, int_rows)

    def image_grad_check(args, ref, out):
        return image_grad_errs(*args[:4], ref, out)

    def spy(module, name, plain, compare):
        kernel = getattr(module, name)
        st = stats[name] = dict(launches=0, n_int=0, err=0.0,
                                excess=-float("inf"))

        def checked(*args, **kw):
            # the plain version first: the candidate mode updates its
            # fold rows in place; kernel B's rotated mode adds into its
            # planes, so its plain version adds into a copy, and the
            # planes are compared too
            rot = kw.get("rotation")
            if rot is None:
                ref = plain(*args, **kw)
                out = kernel(*args, **kw)
                n_int, err, excess = compare(args, ref, out)
            else:
                ref_rot = dataclasses.replace(rot, planes=rot.planes.clone())
                ref = plain(*args, **dict(kw, rotation=ref_rot))
                out = kernel(*args, **kw)
                n_int, err, excess = compare(args, ref + (ref_rot.planes,),
                                             out + (rot.planes,))
            st["launches"] += 1
            st["n_int"] += n_int
            st["err"] = max(st["err"], err)
            st["excess"] = max(st["excess"], excess)
            return out
        return kernel, checked

    patched = [(integrator, "bounce_megakernel", bounce_plain,
                rows(BOUNCE_INT_ROWS)),
               (integrator, "allpairs_nearest_record", nearest_plain,
                nearest_check),
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
                crossings_bcast_plain, crossing_check),
               (volumes, "pallas_volume_candidates", volume_candidates_plain,
                candidate_check),
               (volumes, "pallas_volume_candidates_bcast",
                candidates_bcast_plain, candidate_check),
               (volumes, "pallas_volume_crossings_keyed", keyed_plain,
                keyed_kernel_check),
               (volumes, "pallas_volume_crossings_bcast_keyed",
                keyed_bcast_plain, keyed_kernel_check)]
    originals = []
    for module, name, plain, rows in patched:
        kernel, checked = spy(module, name, plain, rows)
        originals.append((module, name, kernel))
        setattr(module, name, checked)
    for name, checked in sorted_turn_checks(
            stats, integrator.sorted_head, integrator.sorted_tail).items():
        originals.append((integrator, name, getattr(integrator, name)))
        setattr(integrator, name, checked)
    try:
        yield stats
    finally:
        for module, name, kernel in originals:
            setattr(module, name, kernel)


def sorted_turn_checks(stats: dict, head_kernel, tail_kernel) -> dict:
    """``{"sorted_head": f, "sorted_tail": g}``: the sorted driver's
    HEAD and TAIL, each call held against its plain version (run first,
    on copies of what the call writes) and returning ``head_kernel``'s or
    ``tail_kernel``'s results.  ``stats`` gains an entry of each name, as
    :func:`checked_launches`' (the control words, lane ints, key and
    segments as exact rows; the floats' max abs error and excess over
    ``ATOL + RTOL |plain|``); TAIL's also ``acc_excess``, the radiance
    sums' worst excess over ``SCATTER_RTOL x k x |plain|`` (``k`` the
    lanes on the pixel: float atomics add in another order), and HEAD's
    ``turns``, its launches by the queue's state: ``first`` (no work
    taken), ``middle`` (every dead lane takes an item), ``runs_out`` (the
    items run out inside the dead suffix), ``drain`` (none left)."""
    from .ops.sorted_turn import (
        SortedLanes, sorted_head_plain, sorted_tail_plain,
    )
    inf = float("inf")
    h = stats["sorted_head"] = dict(
        launches=0, n_int=0, err=0.0, excess=-inf,
        turns=dict(first=0, middle=0, runs_out=0, drain=0))
    t = stats["sorted_tail"] = dict(launches=0, n_int=0, err=0.0,
                                    excess=-inf, acc_excess=-inf)

    def add(st, n_int, err, excess):
        st["launches"] += 1
        st["n_int"] += n_int
        st["err"] = max(st["err"], err)
        st["excess"] = max(st["excess"], excess)

    def head(turn, perm, lanes, par):
        next_w, n_live = int(lanes.ctl[par]), int(lanes.ctl[2 + par])
        ref_lanes = dataclasses.replace(lanes, ctl=lanes.ctl.clone())
        ref = sorted_head_plain(turn, perm, ref_lanes, par)
        out = head_kernel(turn, perm, lanes, par)
        # floats: comps, rad, thr, uniforms; exact: lane ints, alive, ctl
        n_int, err, excess = max_errs(
            ref + (ref_lanes.ctl,), tuple(out) + (lanes.ctl,), (4, 5, 6))
        add(h, n_int, err, excess)
        kind = ("drain" if next_w >= turn.total_work else
                "first" if next_w == 0 else
                "runs_out" if next_w + turn.lanes - n_live > turn.total_work
                else "middle")
        h["turns"][kind] += 1
        return out

    def tail(turn, lanes, par, hd, out, acc3, segments=None):
        ref_lanes = SortedLanes(*(x.clone() for x in (
            lanes.fstate, lanes.istate, lanes.key, lanes.ctl)))
        ref_acc = acc3.clone()
        ref_seg = None if segments is None else segments.clone()
        sorted_tail_plain(turn, ref_lanes, par, hd, out, ref_acc, ref_seg)
        tail_kernel(turn, lanes, par, hd, out, acc3, segments)
        exact = [(ref_lanes.istate, lanes.istate), (ref_lanes.key, lanes.key),
                 (ref_lanes.ctl, lanes.ctl)]
        if segments is not None:
            exact.append((ref_seg, segments))
        n_int, err, excess = max_errs(
            [ref_lanes.fstate] + [a for a, _ in exact],
            [lanes.fstate] + [b for _, b in exact],
            tuple(range(1, len(exact) + 1)))
        add(t, n_int, err, excess)
        k = torch.bincount(hd[4][0].long(), minlength=turn.n_pix)
        diff = (ref_acc - acc3).abs().to(torch.float64)
        t["acc_excess"] = max(t["acc_excess"], float(
            (diff - SCATTER_RTOL * k * ref_acc.abs()).max()))
    return {"sorted_head": head, "sorted_tail": tail}


@contextlib.contextmanager
def plain_sorted_turn():
    """Inside the block the sorted driver's HEAD and TAIL run their plain
    versions (the driver's torch lines), on any device."""
    from .ops.sorted_turn import sorted_head_plain, sorted_tail_plain
    from .render import integrator
    saved = integrator.sorted_head, integrator.sorted_tail
    integrator.sorted_head = sorted_head_plain
    integrator.sorted_tail = sorted_tail_plain
    try:
        yield
    finally:
        integrator.sorted_head, integrator.sorted_tail = saved


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
    from .ops.iter_kernel import iter_megakernel, next_carry
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
        carry = next_carry(outs)
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
    unfused bounce those of kernel A and K7, the split path and the
    generic bounce those of the nearest-hit kernels K8 and K9 and of the
    crossing kernels K11 and K11b (every mode), the sorted driver those of
    HEAD and TAIL, on any device."""
    from functools import partial

    from .diff import fused_iter
    from .ops.allpairs_kernel import allpairs_nearest_plain
    from .ops.bounce_kernel import bounce_plain
    from .ops.intersect_kernel import pallas_nearest_plain
    from .ops.iter_kernel import iter_plain
    from .ops.volume_kernel import (
        volume_candidates_plain, volume_crossings_plain,
    )
    from .render import integrator, volumes

    def no_forest(plain, vtbl, forest, *rays, **kw):
        return plain(vtbl, *rays, **kw)

    keyed = partial(volume_crossings_plain, keys=True)
    swaps = [(fused_iter, "iter_megakernel", iter_plain),
             (integrator, "bounce_megakernel", bounce_plain),
             (integrator, "pallas_nearest_record", pallas_nearest_plain),
             (integrator, "allpairs_nearest_record",
              partial(no_forest, allpairs_nearest_plain))]
    for name, plain in (("pallas_volume_crossings", volume_crossings_plain),
                        ("pallas_volume_candidates",
                         volume_candidates_plain),
                        ("pallas_volume_crossings_keyed", keyed)):
        swaps.append((volumes, name, plain))
        swaps.append((volumes, name.replace("crossings", "crossings_bcast")
                      if name.endswith("keyed") else name + "_bcast",
                      partial(no_forest, plain)))
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, fn in swaps:
        setattr(m, n, fn)
    try:
        with plain_backward(), plain_sorted_turn():
            yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


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


def per_turn_loss(params, statics, s, key, pixel_ids, target, spp: int,
                  n_iters: int, schedule=None):
    """``render_loss_wavefront``'s ``(loss, frac_done)`` on the fused
    route built turn by turn: each turn one ``fused_iter.fused_loop``
    node of one turn, the turns' sums as autograd ops, the completion
    phases compacted as the driver compacts them.  The reference the
    whole-loop node is held against."""
    from .core.vecmath import DTYPE
    from .diff.fused_iter import fused_loop
    from .diff.gradients import combine
    scene = combine(params, statics)
    dev = scene.device
    loop = fused_loop(scene, s, key.to(dev), spp, 0)
    pix = pixel_ids.to(device=dev, dtype=torch.int32)
    r = pix.shape[0]

    def zeros(w, dtype=DTYPE):
        return torch.zeros((w,), dtype=dtype, device=dev)

    def run(pix, carry, n):
        w = pix.shape[0]
        acc = torch.zeros((3, w), dtype=DTYPE, device=dev)
        done = zeros(w, torch.int32)
        for _ in range(n):
            acc_t, done_t, carry = loop(pix, carry, 1)
            acc, done = acc + acc_t, done + done_t
        return acc, done, carry

    z, o = zeros(r), torch.ones((r,), dtype=DTYPE, device=dev)
    carry = ((torch.full((r,), -1, dtype=torch.int32, device=dev),
              zeros(r, torch.int32), z)
             + (z, z, z, z, z, o, z) + (z, z, z) + (o, o, o))
    acc, done, carry = run(pix, carry, n_iters)
    slot = torch.arange(r, device=dev)
    for it_b, w_b in schedule or ():
        unfinished = (carry[2] > 0.5) | (carry[0] < spp - 1)
        sel = torch.argsort((~unfinished).to(torch.int32), stable=True)[:w_b]
        slot, pix = slot[sel], pix[sel]
        acc_b, done_b, carry = run(pix, tuple(c[sel] for c in carry), it_b)
        acc = acc.index_add(1, slot, acc_b)
        done = done.index_add(0, slot, done_b)
    img = acc.T.contiguous() / torch.clamp(done, min=1)[:, None]
    return torch.mean((img - target) ** 2), torch.mean(done / spp)


def tape_nodes(out) -> dict:
    """How many autograd nodes of each name the tape behind ``out``
    holds."""
    seen, count, todo = set(), {}, [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        count[fn.name()] = count.get(fn.name(), 0) + 1
        todo.extend(f for f, _ in fn.next_functions)
    return count


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
#define __launch_bounds__(...)
#define __shared__ static
using std::max;
using std::min;
struct Dim3 { unsigned x = 0; };
struct float4 { float x, y, z, w; };
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
static inline unsigned __ballot_sync(unsigned, int pred) {
  HostWarp& w = rt_host_warp();
  w.u[threadIdx.x & 31] = pred ? 1u : 0u;
  w.bar.wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (w.u[i]) m |= 1u << i;
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
static inline unsigned long long atomicAdd(unsigned long long* p,
                                           unsigned long long v) {
  std::lock_guard<std::mutex> lk(rt_host_atomic);
  const unsigned long long old = *p;
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


# the multi-process tests: each rank's torch threads, and the seconds a
# spawned group may take before its ranks are killed and the test fails
RANK_THREADS = 1
RANK_TIMEOUT_S = 240.0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, init_file: str, out: str):
    """One spawned rank: join the gloo group over ``file://init_file``,
    save ``fn()`` to ``out``."""
    import torch.distributed as dist
    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        torch.save(fn(), out)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_dir) -> list:
    """``fn()`` on ``world`` spawned processes joined in one gloo group (a
    ``file://`` rendezvous in ``tmp_dir``: no port to collide), each with
    :data:`RANK_THREADS` torch threads; returns every rank's result.
    Past :data:`RANK_TIMEOUT_S` every rank is killed and it raises, as it
    does if a rank fails.  ``fn`` must be importable by name."""
    import multiprocessing
    import os
    import time
    ctx = multiprocessing.get_context("spawn")
    init = os.path.join(str(tmp_dir), "pg")
    outs = [os.path.join(str(tmp_dir), f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still running after "
                           f"{RANK_TIMEOUT_S} s: killed")
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise RuntimeError(f"ranks failed (rank, exit code): {failed}")
    return [torch.load(o, weights_only=False) for o in outs]


def sharding_world(rt):
    """The scene of ``tests/test_sharding.py``: a lambertian sphere under
    a large light."""
    return rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture([0.6, 0.3, 0.2])),
                         rt.sphere([0, 0, -3], 1.0)),
        rt.with_material(rt.light_source(rt.constant_texture(3.0)),
                         rt.parallelogram([-5, 4, -5], [10, 0, 0],
                                          [0, 0, 10])),
    ])


def sharding_settings(rt, width: int = 24):
    """``tests/test_sharding.py``'s camera at ``width`` x ``width``: 8
    spp, depth 4, background 0.3."""
    return rt.CameraSettings(image_width=width, samples_per_pixel=8,
                             max_depth=4,
                             background=rt.const_background(0.3))


def many_spheres_world(rt):
    """``tests/test_sharding.py``'s stand-in of a mesh-scale scene: 15
    spheres of graded albedo under a light."""
    objs = [rt.with_material(
        rt.lambertian(rt.constant_texture([0.5 + 0.02 * i, 0.3, 0.2])),
        rt.sphere([(i % 5) - 2.0, (i // 5) - 1.0, -4.0], 0.35))
        for i in range(15)]
    objs.append(rt.with_material(
        rt.light_source(rt.constant_texture(3.0)),
        rt.parallelogram([-5, 4, -5], [10, 0, 0], [0, 0, 10])))
    return rt.group(objs)


# the sharded forward checks: the seeds of the tile render, of the
# pixel-stationary wavefront and of the sorted one, and their spp
SHARDED = dict(tile_seed=0, wave_seed=7, sorted_seed=11, wave_spp=4)


def sharded_forward_cases() -> dict:
    """On every rank of the current process group (or the one process):
    the sharded forward renders of :func:`sharding_world` at 24 x 24 on
    the CPU, as numpy.  ``tile`` (``sharded_render_fn`` on the default
    mesh, every pixel x 8 samples; the mesh's shape ``mesh_shape``) and
    ``tile sp=<k>`` on the other mesh shapes; ``wavefront``
    (``sharded_wavefront_render_fn``, 4 spp, the image's 576 pixels);
    ``sorted`` (the same on :func:`many_spheres_world` with the sorted
    driver's threshold lowered to 8 rows) and ``sorted_calls`` (how often
    that driver ran here)."""
    import raytrace_tpu_torch as rt
    import torch.distributed as dist
    from .core import rng
    from .parallel.sharding import (
        make_mesh, sharded_render_fn, sharded_wavefront_render_fn,
    )
    from .render import render as render_mod
    world = dist.get_world_size() if dist.is_initialized() else 1
    scene = rt.compile_scene(sharding_world(rt), device="cpu")
    s = sharding_settings(rt)
    n_pix = s.image_width * s.image_height
    pix = torch.arange(n_pix, dtype=torch.int32)
    smp = torch.arange(s.samples_per_pixel, dtype=torch.int32)
    key = rng.base_key(SHARDED["tile_seed"])
    mesh = make_mesh()
    out = {"tile": sharded_render_fn(mesh)(scene, s, key, pix, smp).numpy(),
           "mesh_shape": mesh.shape}
    for sp in sorted({1, world} - {mesh.sp}):
        out[f"tile sp={sp}"] = sharded_render_fn(make_mesh(sp=sp))(
            scene, s, key, pix, smp).numpy()
    spp = SHARDED["wave_spp"]
    out["wavefront"] = sharded_wavefront_render_fn(mesh, n_pix, spp)(
        scene, s, rng.base_key(SHARDED["wave_seed"]))[:n_pix].numpy()
    many = rt.compile_scene(many_spheres_world(rt), device="cpu")
    calls = []
    real_min, real_sorted = (render_mod.SORT_MIN_PRIMS,
                             render_mod.trace_wavefront_sorted)

    def spy(*a, **k):
        calls.append(1)
        return real_sorted(*a, **k)

    render_mod.SORT_MIN_PRIMS = 8
    render_mod.trace_wavefront_sorted = spy
    try:
        out["sorted"] = sharded_wavefront_render_fn(mesh, n_pix, spp)(
            many, s, rng.base_key(SHARDED["sorted_seed"]))[:n_pix].numpy()
    finally:
        render_mod.SORT_MIN_PRIMS = real_min
        render_mod.trace_wavefront_sorted = real_sorted
    out["sorted_calls"] = len(calls)
    return out
