"""Scenes, lane states and kernel-versus-plain comparisons shared by
``chip_smoke.py`` and the tests.

* :func:`cornell_scene_and_settings` and :func:`all_materials_scene` build,
  with the port's own builder, the Cornell box of
  ``__graft_entry__._cornell_scene_and_settings`` and the scene of
  ``tests/test_bounce_kernel.py``; :func:`box_motion_scene` adds
  axis-aligned boxes (``PRIM_BOX`` rows), motion and the isotropic and
  anisotropic materials.
* :data:`FWD_BWD` is the fwd+bwd configuration of ``bench.py`` and
  :func:`fwd_bwd_pixels` its lanes.
* :func:`bounce_inputs`, :func:`primary_bounce_inputs`,
  :func:`next_bounce_inputs`, :func:`iter_state` and :func:`fresh_carry`
  make lane inputs for the kernels: random ones from a numpy seed, or the
  ones the stationary driver gives them.
* :func:`compare_bounce`, :func:`compare_iter`, :func:`compare_bwd` and
  :func:`checked_launches` hold each kernel against its plain version on
  the same inputs; :func:`bwd_inputs` makes K5's arguments from a real
  mid-render state and :func:`plain_backward` forces the fused
  iteration's backward onto K5's plain version.

Tolerances: alive/miss/winner index (and sample/depth/died for kernel B)
equal on every lane; floats within ``ATOL + RTOL * |plain|``
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
        # NaN in both is agreement; NaN in one is an infinite error
        diff = torch.where(a.isnan() & b.isnan(), 0.0,
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


def iter_state(n: int, n_pix: int, seed: int, device):
    """A random mid-render lane state for kernel B: lane ``l`` serves pixel
    ``min(l, n_pix - 1)`` as in the stationary driver, plus a random
    carry."""
    rg = np.random.default_rng(seed)
    pix = np.minimum(np.arange(n), n_pix - 1).astype(np.int32)
    smp = rg.integers(-1, 7, n).astype(np.int32)
    dep = rg.integers(0, 9, n).astype(np.int32)
    al = (rg.uniform(size=n) < 0.5).astype(np.float32)
    o = rg.uniform(0, 555, (3, n)).astype(np.float32)
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


def compare_iter(scene, s, n: int, seed: int, n_iters: int = 30):
    """Kernel B against ``iter_plain`` on ``n`` lanes of the image of
    ``s``: one iteration from a random state, with the winner's uv
    (``max_errs``), then ``n_iters`` from a fresh state (fraction of lanes
    whose summed radiance differs by more than 1e-5, relative mean
    difference)."""
    from .core import rng
    from .diff.fused_iter import iter_kernel_args
    from .ops.iter_kernel import iter_megakernel, iter_plain
    dev = scene.device
    tables, kw = iter_kernel_args(scene, s, rng.base_key(seed, dev), 7)
    n_pix = s.image_width * s.image_height
    pix, carry = iter_state(n, n_pix, seed, dev)
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


@contextlib.contextmanager
def checked_launches():
    """Inside the block, every kernel A launch of the render drivers and
    every kernel B launch of the fused step is followed by its plain
    version on the same inputs.  Yields ``{kernel name: stats}`` with
    ``launches`` (checked), ``n_int`` (differing exact-row lanes, summed),
    ``err`` (max abs float error) and ``excess`` (worst tolerance
    excess)."""
    from .diff import fused_iter
    from .ops.bounce_kernel import bounce_plain
    from .ops.iter_kernel import iter_plain
    from .render import integrator
    stats = {}

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
