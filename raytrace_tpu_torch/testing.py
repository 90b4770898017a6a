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
* :data:`FWD_BWD` is the fwd+bwd configuration of ``bench.py`` and
  :func:`fwd_bwd_pixels` its lanes; :data:`MESH_FWD_BWD` the mesh
  configuration of ``tools/prof_bunny_grad.py``.
* :func:`bounce_inputs`, :func:`primary_bounce_inputs`,
  :func:`next_bounce_inputs`, :func:`iter_state` and :func:`fresh_carry`
  make lane inputs for the kernels: random ones from a numpy seed, or the
  ones the stationary driver gives them.
* :func:`compare_bounce`, :func:`compare_iter`, :func:`compare_bwd`,
  :func:`compare_nearest`, :func:`compare_shade` and
  :func:`checked_launches` hold each kernel against its plain version on
  the same inputs; :func:`bwd_inputs` makes K5's arguments from a real
  mid-render state, :func:`plain_backward` forces the fused iteration's
  backward onto K5's plain version and :func:`plain_kernels` forward and
  backward onto the plain versions.

Tolerances: alive/miss/winner index (and sample/depth/died for kernel B,
winner index, flags and material for the nearest kernel) equal on every
lane; floats within ``ATOL + RTOL * |plain|``
(``tests/test_bounce_kernel.py``).  K5 against its plain version: every
gradient within ``BWD_RTOL * (|plain| + max|plain| over its output +
max|plain| over its lane)``.  The forward replay rounds alike
(``--fmad=false``, same association), but the hand-derived adjoint sums
the chain-rule terms in another order than torch autograd, so a gradient
that is a sum of terms of both signs keeps an error of a few ulps of its
largest term, not of its value; the largest gradients of the output and
of the lane bound those terms.
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

ALL_MATERIAL_TARGETS = [(0.25, [-1, 9, -1], [2, 0, 0], [0, 0, 2]),
                        (0.15, [5, 9, 5], [1, 0, 0], [0, 0, 1])]

# bench.py's fwd+bwd on the Cornell box at 600 x 600, depth 50: RR from
# depth 2, 2^18 lanes x 64 spp, 205 iterations then 25 at 2^14 and 100 at
# 2^12 lanes
FWD_BWD = dict(rr_depth=2, lanes=1 << 18, spp=64, n_iters=205,
               schedule=((25, 1 << 14), (100, 1 << 12)))


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


def bunny_standin_world(rt):
    """The bunny scene's world with a procedural mesh of the bunny's size:
    ``uv_sphere(47, 54)`` (4,968 triangles) with each vertex moved to
    radius 0.9 * (1 + 0.15 sin(5 theta) cos(4 phi)), a non-convex lobed
    surface that shades itself; no uv; the bunny's blue lambertian.
    ``rt`` is the builder module (this package or the JAX one)."""
    v, f = uv_sphere(47, 54)
    th = np.linspace(0, np.pi, 48)
    ph = np.linspace(0, 2 * np.pi, 54, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = (0.9 * (1.0 + 0.15 * np.sin(5.0 * tt) * np.cos(4.0 * pp))).ravel()
    mesh = rt.Mesh(vertices=v * r[:, None], uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full_like(f, -1))
    return rt.with_material(
        rt.lambertian(rt.constant_texture([0.3, 0.3, 1.0])),
        rt.triangle_mesh(mesh))


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
    ref = iter_plain(*tables, lane_in, with_uv=True, **kw)
    out = iter_megakernel(*tables, lane_in, with_uv=True, **kw)
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
    every nearest and shade kernel launch of the split path and every
    kernel B launch of the fused step is followed by its plain version on
    the same inputs.  Yields ``{kernel name: stats}`` with ``launches``
    (checked), ``n_int`` (differing exact-row lanes, summed), ``err``
    (max abs float error) and ``excess`` (worst tolerance excess)."""
    from .diff import fused_iter
    from .ops.allpairs_kernel import allpairs_nearest_plain
    from .ops.bounce_kernel import bounce_plain, shade_plain
    from .ops.iter_kernel import iter_plain
    from .render import integrator
    stats = {}

    def nearest_plain(tbl, bvh, *rays, **kw):
        return allpairs_nearest_plain(tbl, *rays, **kw)

    def spy(module, name, plain, int_rows):
        kernel = getattr(module, name)
        st = stats[name] = dict(launches=0, n_int=0, err=0.0,
                                excess=-float("inf"))

        def checked(*args, **kw):
            out = kernel(*args, **kw)
            n_int, err, excess = max_errs(plain(*args, **kw), out, int_rows)
            st["launches"] += 1
            st["n_int"] += n_int
            st["err"] = max(st["err"], err)
            st["excess"] = max(st["excess"], excess)
            return out
        return kernel, checked

    patched = [(integrator, "bounce_megakernel", bounce_plain,
                BOUNCE_INT_ROWS),
               (integrator, "allpairs_nearest_record", nearest_plain,
                NEAREST_INT_ROWS),
               (integrator, "shade_megakernel", shade_plain, BOUNCE_INT_ROWS),
               (fused_iter, "iter_megakernel", iter_plain, ITER_INT_ROWS)]
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
    from .diff.fused_iter import _prim_columns, iter_kernel_args
    from .ops.iter_kernel import iter_megakernel
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
    cols, _, _ = _prim_columns(scene, n_row)
    idx = outs[17]
    gath = cols[torch.clamp(idx, min=0.0).long()].T.contiguous().unbind(0)
    gen = torch.Generator().manual_seed(seed)
    cts = torch.randn((13, lanes), generator=gen).to(dev).unbind(0)
    _, _, ttbl, cam, kt = tables
    args = (ttbl, kt, cam, gath, idx, lane_in[0:3], lane_in[3],
            lane_in[4:11], lane_in[14:17], outs[18], cts)
    kw5 = dict(n_targets=kw["n_targets"], has_motion=kw["has_motion"],
               has_box=scene.prims.has_box, t_min=kw["t_min"], n_row=n_row,
               n_u=kw["n_u"], width=kw["width"], bg_kind=kw["bg_kind"])
    return args, kw5


def bwd_errs(ref, out):
    """``(max abs error, worst excess over the K5 tolerance)`` between
    K5's plain and kernel outputs (see the module docstring); NaN in one
    of them is an infinite error."""
    a = torch.stack(ref).to(torch.float64)
    b = torch.stack(out).to(torch.float64)
    diff = (a - b).abs()
    diff = torch.where(a.isnan() & b.isnan(), 0.0,
                       torch.nan_to_num(diff, nan=float("inf")))
    mag = torch.nan_to_num(a.abs(), nan=0.0)
    bound = BWD_RTOL * (mag + mag.amax(1, keepdim=True)
                        + mag.amax(0, keepdim=True))
    return float(diff.max()), float((diff - bound).max())


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
    kernel B (and its mesh variant) forward and of K5 backward, on any
    device."""
    from .diff import fused_iter
    from .ops.iter_kernel import iter_plain
    kernel = fused_iter.iter_megakernel
    fused_iter.iter_megakernel = iter_plain
    try:
        with plain_backward():
            yield
    finally:
        fused_iter.iter_megakernel = kernel


@contextlib.contextmanager
def plain_backward():
    """Inside the block the fused iteration's backward runs K5's plain
    version (torch autograd over ``lane_math``) on any device."""
    from .diff import fused_iter
    from .ops.bounce_bwd_gather_kernel import bounce_bwd_regen_pre_plain
    kernel = fused_iter.bounce_bwd_regen_pre_megakernel
    fused_iter.bounce_bwd_regen_pre_megakernel = bounce_bwd_regen_pre_plain
    try:
        yield
    finally:
        fused_iter.bounce_bwd_regen_pre_megakernel = kernel
