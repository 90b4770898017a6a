"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the
machine with the card run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: this file needs neither JAX nor the JAX package).
Tolerances: alive/miss/winner index equal on every lane (the kernels are
built without multiply-add contraction and round like the plain version),
floats within atol 2e-3 + rtol 1e-3 (tests/test_bounce_kernel.py); the
backward kernels K5 and K7 within ``testing.BWD_RTOL`` of the scale of
each gradient (``testing.bwd_errs``), their reduced tables within
``n * 2^-23 * sum |g|`` of a float64 sum of the per-lane mode's row
gradients and within that plus the per-lane tolerances of the plain
version's (``testing.compare_reduced``), and the fwd+bwd with K5 (or K7)
against the same with its plain version within ``GRAD_RTOL`` per
gradient leaf (the per-lane differences of the kernel, summed in another
order).  The mesh
kernels (nearest hit over the BVH, shade, kernel B's mesh variant) equal
their plain versions exactly on every lane, as do the flat-scan nearest kernel K8, the marble
kernel K12 and the medium crossing kernels K11 and K11b (in every mode,
the keyed one's keys included); the atlas gradient K13 within
``testing.image_grad_errs`` (float atomics add in a varying order).  The
generic bounce's routes (the media fwd+bwd, a marble-lit render,
``grad_render``) launch their kernels, and the fwd+bwd equals the one
with every plain version within ``GRAD_RTOL``.  The sorted driver's HEAD
and TAIL equal their plain versions bit for bit, but for the radiance
sums (float atomics: within ``SCATTER_RTOL`` x the lanes on a pixel x
the sum).
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.render.integrator import bounce_tables
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, FRAC_LANES, ITER_INT_ROWS, MEAN_RTOL,
    MIXED_MEDIA_INSIDE, all_materials_scene,
    bounce_inputs, box_motion_scene, bunny_standin_scene, bwd_inputs,
    camera_rays, checked_launches, compare_bounce, compare_bwd, compare_iter,
    compare_image_grad, compare_k7, compare_marble, compare_nearest,
    compare_crossings, compare_nearest_flat, compare_shade,
    cornell_scene_and_settings, cornell_smoke_scene, fresh_carry,
    image_grad_scene, k7_inputs, many_media_settings, many_media_world,
    marble_patterns, max_errs, media_bounce_rays, mesh_all_kinds_scene,
    mixed_media_world, next_split_rays,
    noise_test_scene, pawn_inside_rays, pawn_standin_scene, plain_backward,
    plain_kernels, route_marble_lanes, surface_points, synthetic_medium,
    volume_rays, volume_test_world,
)

pytestmark = pytest.mark.cuda

GRAD_RTOL = 1e-3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["cornell", "all_materials",
                                  "all_materials_targets"])
def test_bounce_kernel_matches_plain(device, case):
    import raytrace_tpu_torch as rt
    if case == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
        box = (0.0, 555.0)
    else:
        scene = all_materials_scene(device=device)
        s = rt.CameraSettings(background=rt.const_background(0.2))
        if case == "all_materials_targets":
            s = s.with_redirect_targets(ALL_MATERIAL_TARGETS)
        box = (-8.0, 8.0)
    (n_int, _, excess), _ = compare_bounce(
        bounce_tables(scene, s), bounce_inputs(scene, 4096, 5, box))
    assert n_int == 0
    assert excess <= 0.0


def test_iter_kernel_matches_plain(device):
    scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
    (n_int, _, excess), frac, mean_rel, _ = compare_iter(
        scene, s.replace(rr_depth=2), 4096, 3)
    assert n_int == 0
    assert excess <= 0.0
    assert frac < FRAC_LANES
    assert mean_rel <= MEAN_RTOL


@pytest.mark.parametrize("case", ["cornell", "all_materials",
                                  "box_motion"])
def test_iter_kernel_instantiations_match_plain(device, case):
    """Kernel B prepared as the drivers launch it: the planar
    instantiation on the Cornell box (and its general one, unprepared,
    giving the same bits), the general one on the all-materials and
    box/motion scenes; every lane equal to the plain version."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel, iter_plain
    if case == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
        box = (0.0, 555.0)
    elif case == "box_motion":
        scene, s = box_motion_scene(device=device)
        box = (-8.0, 8.0)
    else:
        scene = all_materials_scene(device=device)
        s = rt.CameraSettings(background=rt.const_background(0.2))
        box = (-8.0, 8.0)
    p0 = iter_megakernel.planar_launches
    (n_int, err, _), frac, _, err30 = compare_iter(
        scene, s.replace(rr_depth=2), 4096, 5, box=box)
    assert (iter_megakernel.planar_launches > p0) == (case == "cornell")
    assert n_int == 0 and err == 0.0 and frac == 0.0 and err30 == 0.0
    tables, kw = iter_kernel_args(scene, s, rng.base_key(2, device), 3)
    lane_in = (torch.arange(4096, dtype=torch.int32, device=device)
               % (s.image_width * s.image_height),) + fresh_carry(4096, device)
    ref = iter_plain(*tables, lane_in, **kw)
    out = iter_megakernel(*tables, lane_in, **kw)
    gen = iter_megakernel(*tables, lane_in, **dict(kw, prepared=None))
    for a, b, c in zip(ref, out, gen):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_render_launches_kernels(device):
    from raytrace_tpu_torch.ops.bounce_kernel import bounce_megakernel
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.render.render import render_accumulate
    scene, s = cornell_scene_and_settings(128, 8, 10, device=device)
    # 8 spp rotates 8 ways (kernel B's rotated mode), 1 spp does not
    a0, b0 = bounce_megakernel.launches, iter_megakernel.launches
    acc, _ = render_accumulate(scene, s, 1, spp=8)
    assert bounce_megakernel.launches == a0
    b1 = iter_megakernel.launches
    assert b1 > b0
    acc1, _ = render_accumulate(scene, s, 1, spp=1)
    assert iter_megakernel.launches > b1
    # under 16384 pixels: the work-queue driver, through kernel A
    small, s_small = cornell_scene_and_settings(32, 8, 10, device=device)
    a1 = bounce_megakernel.launches
    acc2, _ = render_accumulate(small, s_small, 1, spp=8)
    assert bounce_megakernel.launches > a1
    assert all(bool(torch.isfinite(a).all()) for a in (acc, acc1, acc2))


@pytest.mark.parametrize("spp", [8, 1])
def test_render_launches_match_plain(device, spp):
    """Every launch of a 130 x 130 render (16900 pixels on 17024 lanes:
    the padding lanes and, at 8 spp, kernel B's rotated mode, planes
    included) agrees with the plain version on the inputs the driver
    gave it."""
    from raytrace_tpu_torch.render.render import render_accumulate
    scene, s = cornell_scene_and_settings(130, spp, 10, device=device)
    with checked_launches() as stats:
        acc, _ = render_accumulate(scene, s.replace(rr_depth=2), 1, spp=spp)
    assert stats["bounce_megakernel"]["launches"] == 0
    st = stats["iter_megakernel"]
    assert st["launches"] > 0
    assert st["n_int"] == 0
    assert st["excess"] <= 0.0
    assert bool(torch.isfinite(acc).all())


def _compare_rotated_iter(scene, s, n: int, seed: int, k_rot: int = 8,
                         n_iters: int = 30):
    """Kernel B's rotated mode (prepared as the drivers launch it) against
    ``iter_plain``'s on ``n`` lanes serving a band of the image of ``s``
    from pixel 50 with at least 64 padding slots, 2 samples a chunk from
    sample 3: ``n_iters`` launches from every lane idle, each held
    against the plain version on the kernel's last state and a copy of
    its planes.  Returns ``(errs, planes)``: ``max_errs`` over the
    launches, the planes compared as one more row, and the kernel's
    planes."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.ops.iter_kernel import (
        Rotation, iter_megakernel, iter_plain, next_carry,
    )
    from raytrace_tpu_torch.render.integrator import rotation_stride
    dev = scene.device
    off, s0, spp_k = 50, 3, 2
    n_pix = min(s.image_width * s.image_height - off, n - 64)
    tables, kw = iter_kernel_args(scene, s, rng.base_key(seed, dev),
                                  s0 + k_rot * spp_k - 1)
    rot = Rotation(k_rot, spp_k, rotation_stride(n, k_rot), s0, off, n_pix,
                   torch.zeros((k_rot, 3, n), device=dev))
    carry = fresh_carry(n, dev)
    carry = (carry[0] + s0,) + carry[1:]
    pix = torch.zeros(n, dtype=torch.int32, device=dev)
    n_int, err, excess = 0, 0.0, -float("inf")
    for _ in range(n_iters):
        ref_rot = dataclasses.replace(rot, planes=rot.planes.clone())
        ref = iter_plain(*tables, (pix,) + carry, rotation=ref_rot, **kw)
        out = iter_megakernel(*tables, (pix,) + carry, rotation=rot, **kw)
        a, b, c = max_errs(ref + (ref_rot.planes,), out + (rot.planes,),
                           ITER_INT_ROWS)
        n_int, err, excess = n_int + a, max(err, b), max(excess, c)
        carry = next_carry(out)
    return (n_int, err, excess), rot.planes


@pytest.mark.parametrize("case", ["cornell", "all_materials"])
def test_rotated_iter_kernel_matches_plain(device, case):
    """Kernel B's rotated mode (planar on the Cornell box, general on the
    all-materials scene) against ``iter_plain``'s, launch by launch over
    30 turns of 4,096 lanes rotating 8 ways: every lane's outputs and
    the accumulation planes equal."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    if case == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
    else:
        scene = all_materials_scene(device=device)
        s = rt.CameraSettings(image_width=64,
                              background=rt.const_background(0.2))
    p0 = iter_megakernel.planar_launches
    (n_int, err, _), planes = _compare_rotated_iter(
        scene, s.replace(rr_depth=2), 4096, 5)
    assert (iter_megakernel.planar_launches > p0) == (case == "cornell")
    assert n_int == 0 and err == 0.0
    assert bool((planes != 0).any())


def test_rotated_stationary_render_matches_unfused(device, monkeypatch):
    """The stationary driver at rotate_k 8 over 130 x 130 (padding slots),
    8 spp, depth 10: the fused branch (kernel B's rotated mode) and the
    unfused body (kernel A and the glue, forced) trace the same paths:
    equal ``iterations`` and ``segments``, and the image up to the order
    of each pixel's float32 sums."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops.bounce_kernel import bounce_megakernel
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.render import integrator
    scene, s = cornell_scene_and_settings(130, 8, 10, device=device)
    n_pix = 130 * 130

    def render():
        return integrator.trace_wavefront_stationary(
            scene, s, rng.base_key(3, device), n_pix, 8, rotate_k=8,
            with_stats=True)
    b0 = iter_megakernel.launches
    acc, st = render()
    assert iter_megakernel.launches - b0 == st["iterations"]
    monkeypatch.setattr(integrator, "stationary_fused", lambda *a: False)
    a0 = bounce_megakernel.launches
    acc_u, st_u = render()
    assert bounce_megakernel.launches - a0 == st_u["iterations"]
    assert st["iterations"] == st_u["iterations"]
    assert int(st["segments"]) == int(st_u["segments"])
    den = acc_u.abs().sum(1)
    lit = den > 0
    rel = (acc - acc_u).abs().sum(1)[lit] / den[lit]
    assert float(rel.median()) <= 1e-6 and float(rel.max()) <= 1e-5


def test_compile_scene_defaults_to_the_card(device):
    import raytrace_tpu_torch as rt
    scene = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)), rt.sphere([0, 0, 0], 1)))
    assert scene.device.type == "cuda"


@pytest.mark.parametrize("case", ["cornell", "all_materials_targets",
                                  "box_motion"])
def test_backward_kernel_matches_plain(device, case):
    import raytrace_tpu_torch as rt
    if case == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
        s = s.replace(rr_depth=2)
    elif case == "box_motion":
        scene, s = box_motion_scene(device=device)
    else:
        scene = all_materials_scene(device=device)
        s = rt.CameraSettings(background=rt.sky, image_width=64,
                              max_depth=10).with_redirect_targets(
                                  ALL_MATERIAL_TARGETS)
    args, kw = bwd_inputs(scene, s, 1 << 14, 5, n_iters=4)
    (err, excess), _ = compare_bwd(args, kw)
    assert excess <= 0.0


def test_fwd_bwd_kernel_matches_plain_backward(device):
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import loss_and_grads, partition
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    scene, s = cornell_scene_and_settings(128, 8, 10, device=device)
    params, statics = partition(scene)
    pix = torch.arange(1 << 14, dtype=torch.int32, device=device)
    target = torch.zeros((1 << 14, 3), device=device)

    def run():
        return loss_and_grads(params, statics, s.replace(rr_depth=2),
                              rng.base_key(0, device), pix, target, spp=8,
                              n_iters=40, remat=False)

    k0 = bounce_bwd_regen_pre_reduced.launches
    p0 = bounce_bwd_regen_pre_megakernel.launches
    (loss_k, frac_k), g_k = run()
    assert bounce_bwd_regen_pre_reduced.launches == k0 + 40
    with plain_backward():
        (loss_p, frac_p), g_p = run()
    assert bounce_bwd_regen_pre_reduced.launches == k0 + 40
    assert bounce_bwd_regen_pre_megakernel.launches == p0
    assert float(loss_k) == float(loss_p) and float(frac_k) == float(frac_p)
    gk, gp = grads_to_numpy(g_k), grads_to_numpy(g_p)
    for k in gp:
        assert np.isfinite(gk[k]).all(), k
        scale = np.abs(gp[k]).max()
        assert np.abs(gk[k] - gp[k]).max() <= GRAD_RTOL * scale, k


@pytest.mark.parametrize("case", ["cornell", "cornell_schedule",
                                  "image_panel"])
def test_fused_loop_matches_per_turn_on_the_card(device, case):
    """The fused driver's whole-loop node against the same loss built
    turn by turn (``testing.per_turn_loss``), both with kernel B and K5,
    on Cornell without and with a completion schedule (a node a phase,
    whose compacted lanes' cotangents come back through ``c[sel]``'s
    backward), and on the image-textured panel, whose driver runs
    one-turn nodes, each followed by the albedo multiply, so K13 runs in
    every backward turn but the last: the loss bit-equal, every gradient
    leaf within rtol 1e-5 (only the order of the turns' row sums
    differs), K5 launched once a turn; and a train step
    (``sharded_train_step_fn`` at one rank) launches K5 exactly
    ``n_iters`` times."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        leaves, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.image_grad_kernel import image_grad_pallas
    from raytrace_tpu_torch.parallel.sharding import (
        make_mesh, sharded_train_step_fn,
    )
    from raytrace_tpu_torch.testing import (
        image_panel_scene, per_turn_loss, tape_nodes,
    )
    rich = case == "image_panel"
    schedule = ((20, 4096),) if case == "cornell_schedule" else None
    if rich:
        scene, s = image_panel_scene(128, 8, 10, device=device)
    else:
        scene, s = cornell_scene_and_settings(128, 8, 10, device=device)
    s = s.replace(rr_depth=2)
    params, statics = partition(scene)
    named = {k: v for k, v in leaves(params).items() if v.requires_grad}
    pix = (torch.arange(1 << 14, device=device)
           % (s.image_width * s.image_height)).to(torch.int32)
    target = torch.rand((1 << 14, 3), device=device,
                        generator=torch.Generator(device).manual_seed(1))
    key, n_iters = rng.base_key(0, device), 40
    turns = n_iters + sum(n for n, _ in schedule or ())

    k0, t0 = bounce_bwd_regen_pre_reduced.launches, image_grad_pallas.launches
    loss, frac = render_loss_wavefront(params, statics, s, key, pix, target,
                                       8, n_iters=n_iters, schedule=schedule)
    assert tape_nodes(loss).get("_FusedLoopBackward") == (
        turns if rich else 1 + len(schedule or ()))
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    assert bounce_bwd_regen_pre_reduced.launches == k0 + turns
    assert image_grad_pallas.launches == t0 + (turns - 1 if rich else 0)
    ref, ref_frac = per_turn_loss(params, statics, s, key, pix, target, 8,
                                  n_iters, schedule)
    assert tape_nodes(ref).get("_FusedLoopBackward") == turns
    ref_grads = torch.autograd.grad(ref, list(named.values()),
                                    allow_unused=True)
    assert bounce_bwd_regen_pre_reduced.launches == k0 + 2 * turns
    assert image_grad_pallas.launches == t0 + (2 * turns - 2 if rich else 0)
    assert torch.equal(loss, ref) and torch.equal(frac, ref_frac)
    if rich:
        assert bool(torch.any(grads[list(named).index("textures.images")]))
    for k, g, g_ref in zip(named, grads, ref_grads):
        if g_ref is None:
            assert g is None or not torch.any(g), k
        else:
            torch.testing.assert_close(g, g_ref, rtol=1e-5, atol=1e-7,
                                       msg=k)

    step = sharded_train_step_fn(
        make_mesh(), s, spp=8, n_iters=n_iters,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=0.02))
    state = step.init(scene)
    for k in range(2):
        k0 = bounce_bwd_regen_pre_reduced.launches
        _, scene, state = step.with_state(scene, state, rng.base_key(k, device),
                                          pix, None, target)
        assert bounce_bwd_regen_pre_reduced.launches == k0 + n_iters


@pytest.mark.parametrize("case", ["cornell", "all_materials_targets",
                                  "box_motion"])
def test_replay_backward_kernel_matches_plain(device, case):
    """K7 against its plain version on 2^14 lanes of the unfused driver's
    mid-render state (``testing.k7_inputs``), within ``BWD_RTOL``."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.bounce_bwd_kernel import (
        bounce_bwd_megakernel,
    )
    if case == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
        s = s.replace(rr_depth=2)
    elif case == "box_motion":
        scene, s = box_motion_scene(device=device)
    else:
        scene = all_materials_scene(device=device)
        s = rt.CameraSettings(background=rt.sky, image_width=64,
                              max_depth=10).with_redirect_targets(
                                  ALL_MATERIAL_TARGETS)
    args, kw = k7_inputs(scene, s, 1 << 14, 4, seed=5)
    k0 = bounce_bwd_megakernel.launches
    (err, excess), out = compare_k7(args, kw)
    torch.cuda.synchronize()
    assert bounce_bwd_megakernel.launches == k0 + 1
    assert excess <= 0.0


def test_unfused_fwd_bwd_kernels_match_plain(device):
    """The unfused fwd+bwd (``rotate_k=2``: kernel A forward, K7 backward,
    once per iteration each) against the same with K7's plain version:
    equal losses, gradients within ``GRAD_RTOL`` per leaf."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import loss_and_grads, partition
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.bounce_bwd_kernel import (
        bounce_bwd_megakernel, bounce_bwd_megakernel_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import bounce_megakernel
    scene, s = cornell_scene_and_settings(128, 8, 10, device=device)
    params, statics = partition(scene)
    pix = torch.arange(1 << 14, dtype=torch.int32, device=device)
    target = torch.zeros((1 << 14, 3), device=device)

    def run():
        return loss_and_grads(params, statics, s.replace(rr_depth=2),
                              rng.base_key(0, device), pix, target, spp=8,
                              n_iters=40, remat=False, rotate_k=2)

    a0, k0 = bounce_megakernel.launches, bounce_bwd_megakernel_reduced.launches
    p0 = bounce_bwd_megakernel.launches
    (loss_k, frac_k), g_k = run()
    assert bounce_megakernel.launches == a0 + 40
    assert bounce_bwd_megakernel_reduced.launches == k0 + 40
    with plain_backward():
        (loss_p, frac_p), g_p = run()
    assert bounce_bwd_megakernel_reduced.launches == k0 + 40
    assert bounce_bwd_megakernel.launches == p0
    assert float(loss_k) == float(loss_p) and float(frac_k) == float(frac_p)
    gk, gp = grads_to_numpy(g_k), grads_to_numpy(g_p)
    for k in gp:
        assert np.isfinite(gk[k]).all(), k
        scale = np.abs(gp[k]).max()
        assert np.abs(gk[k] - gp[k]).max() <= GRAD_RTOL * scale, k


@pytest.mark.parametrize("kernel", ["k5", "k7"])
@pytest.mark.parametrize("case", ["cornell", "box_motion", "mesh"])
def test_reduced_backward_kernels_match_plain(device, kernel, case):
    """The reduced K5 and K7 (rows read by index, row gradients summed in
    the launch) on 2^14 lanes of a mid-render state: lane outputs equal to
    the per-lane mode's and within ``BWD_RTOL`` of the plain version's,
    the tables within ``n * 2^-23 * sum |g|`` of the per-lane mode's rows
    summed in float64 and within that plus the per-lane tolerances of the
    plain version's.  The mesh (K5: the 4,992-row stand-in; K7: a 384-row
    mixed-kind mesh) takes the global mode; the staged mode's sums are the
    same from run to run."""
    from raytrace_tpu_torch.ops import row_reduce
    from raytrace_tpu_torch.testing import compare_reduced, reduced_args
    if case == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device=device)
        s = s.replace(rr_depth=2)
    elif case == "box_motion":
        scene, s = box_motion_scene(device=device)
    elif kernel == "k5":
        scene, s = bunny_standin_scene(128, 8, 10, device=device)
    else:
        scene, s = mesh_all_kinds_scene(10, False, 128, device=device)
    if kernel == "k5":
        args, kw = bwd_inputs(scene, s, 1 << 14, 5, n_iters=4)
    else:
        # the mesh at 2 spp: dead lanes parked at 3e18 read a sphere row
        args, kw = k7_inputs(scene, s, 1 << 14, 4, seed=5,
                             spp=2 if case == "mesh" else 8)
    tables = row_reduce.row_tables(scene, kw["n_row"])
    res = compare_reduced(args, kw, tables)
    torch.cuda.synchronize()
    assert res["lane_excess"] <= 0.0 and res["lane_differ"] == 0, res
    assert res["rows_excess"] <= 0.0 and res["plain_excess"] <= 0.0, res
    staged = row_reduce.row_mode(tables.n_prims, kw["n_row"]) \
        == row_reduce.STAGED
    assert staged == (case != "mesh")
    if staged:
        from raytrace_tpu_torch.ops import bounce_bwd_gather_kernel as k5
        from raytrace_tpu_torch.ops import bounce_bwd_kernel as k7
        fn = (k5.bounce_bwd_regen_pre_reduced if kernel == "k5"
              else k7.bounce_bwd_megakernel_reduced)
        again = fn(*reduced_args(args, tables), **kw)[1]
        assert all(torch.equal(a, b) for a, b in zip(res["out"][1], again))


@pytest.mark.parametrize("rotated", [False, True])
def test_many_media_render_launches_match_plain(device, rotated):
    """17 media: the crossing kernel (K11, or K11b for the 102-row
    boundary of rotated boxes) launches in the candidate mode once per
    group of at most 16 media (two a bounce), each launch equal to its
    plain version (t_med within ``CAND_ULPS``)."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.render.render import render_accumulate
    scene = rt.compile_scene(many_media_world(rt, 17, rotated),
                             device=device)
    s = many_media_settings(rt, 64, 2, 8)
    assert scene.volumes.n_volumes == 17
    with checked_launches() as stats:
        acc, _ = render_accumulate(scene, s, 0, spp=2)
    st = stats["pallas_volume_candidates_bcast" if rotated
               else "pallas_volume_candidates"]
    assert st["launches"] == 2 * stats["pallas_nearest_record"]["launches"]
    assert st["n_int"] == 0 and st["excess"] <= 0
    assert bool(torch.isfinite(acc).all())


def _mesh_case(case, device):
    if case == "standin":
        return bunny_standin_scene(128, 4, 10, device=device)
    return mesh_all_kinds_scene(18, case == "all_kinds_moving", 64,
                                device=device)


@pytest.mark.parametrize("case", ["standin", "all_kinds",
                                  "all_kinds_moving"])
def test_mesh_kernels_match_plain(device, case):
    """The nearest kernel on camera rays and their second bounce, and the
    shade kernel on the hit records with and without a medium: every
    output equal to the plain version's on every lane."""
    from raytrace_tpu_torch.render.integrator import split_tables
    scene, s = _mesh_case(case, device)
    tb = split_tables(scene, s)
    comps, uni = camera_rays(scene, s, 1 << 14, 3)
    thr = torch.ones((3, comps.shape[1]), device=device)
    alive = torch.ones(comps.shape[1], dtype=torch.bool, device=device)
    for depth in (0, 1):
        (n_int, err, _), _ = compare_nearest(tb, comps)
        assert n_int == 0 and err == 0.0
        (n_int, err, _), out, hit = compare_shade(tb, comps, uni, thr, alive)
        assert n_int == 0 and err == 0.0
        med = synthetic_medium(hit[0], tb.n_mats, 5)
        (n_int, err, _), _, _ = compare_shade(tb, comps, uni, thr, alive,
                                              medium=med, hit=hit)
        assert n_int == 0 and err == 0.0
        comps, uni, thr, alive = next_split_rays(comps, out, 3, depth + 1)


def test_mesh_iteration_kernel_matches_plain(device):
    from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap
    scene, s = bunny_standin_scene(128, 4, 10, device=device)
    m0 = iter_mega_ap.launches
    (n_int, err, excess), frac, mean_rel, _ = compare_iter(
        scene, s.replace(rr_depth=2), 1 << 14, 3, n_iters=10,
        box=(-1.0, 1.0))
    assert iter_mega_ap.launches == m0 + 11
    assert n_int == 0 and err == 0.0
    assert frac < FRAC_LANES and mean_rel <= MEAN_RTOL


@pytest.mark.parametrize("case", ["triangle_only", "general"])
def test_bvh_walks_match_plain(device, case):
    """The walk's two instantiations: the triangle-only test (the
    stand-in: every row an unmoving triangle) and the general one (the
    mixed-kind mesh: spheres, parallelograms, a box and triangles), in the
    nearest kernel on camera rays and their second bounce, and in the mesh
    iteration kernel, every output equal to the plain version's."""
    from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap
    from raytrace_tpu_torch.render.integrator import split_tables
    if case == "triangle_only":
        scene, s = bunny_standin_scene(128, 4, 10, device=device)
    else:
        scene, s = mesh_all_kinds_scene(18, False, 64, device=device)
    tb = split_tables(scene, s)
    assert tb.bvh.tri_only == (case == "triangle_only")
    comps, uni = camera_rays(scene, s, 1 << 14, 9)
    thr = torch.ones((3, comps.shape[1]), device=device)
    alive = torch.ones(comps.shape[1], dtype=torch.bool, device=device)
    for depth in (0, 1):
        (n_int, err, _), _ = compare_nearest(tb, comps)
        assert n_int == 0 and err == 0.0
        _, out, _ = compare_shade(tb, comps, uni, thr, alive)
        comps, uni, thr, alive = next_split_rays(comps, out, 9, depth + 1)
    m0 = iter_mega_ap.launches
    (n_int, err, _), frac, mean_rel, _ = compare_iter(
        scene, s.replace(rr_depth=2), 1 << 14, 9, n_iters=10,
        box=(-1.0, 1.0))
    assert iter_mega_ap.launches == m0 + 11
    assert n_int == 0 and err == 0.0
    assert frac < FRAC_LANES and mean_rel <= MEAN_RTOL


@pytest.mark.parametrize("case", ["triangle_only", "general"])
def test_k9_marks_the_nodes_and_rows_it_reads(device, case):
    """K9's ``seen`` (what its bound counts): one ray marks ``visits / 2``
    nodes and ``visits`` rows (it reads each once), a batch the union of
    its rays' marks, and the outputs are those of a launch without it."""
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.render.integrator import split_tables
    if case == "triangle_only":
        scene, s = bunny_standin_scene(96, 1, 10, device=device)
    else:
        scene, s = mesh_all_kinds_scene(18, False, 64, device=device)
    tb = split_tables(scene, s)
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    n_pix = s.image_width * s.image_height
    pix = torch.arange(64) * (n_pix // 64) + s.image_width // 2
    comps, _ = camera_rays(scene, s, 64, 5, pixels=pix)
    n_nodes = tb.bvh.n_nodes
    union = torch.zeros(n_nodes + tb.bvh.rows.shape[0], dtype=torch.uint8,
                        device=device)
    for i in range(comps.shape[1]):
        seen = torch.zeros_like(union)
        _, v = allpairs_nearest_record(
            tb.ptbl, tb.bvh, *comps[:, i:i + 1].contiguous().unbind(0),
            count_visits=True, seen=seen, **kw)
        assert int(seen[:n_nodes].sum()) * 2 == int(v[0, 0])
        assert int(seen[n_nodes:].sum()) == int(v[1, 0])
        union |= seen
    seen = torch.zeros_like(union)
    rays = comps.unbind(0)
    out, _ = allpairs_nearest_record(tb.ptbl, tb.bvh, *rays,
                                     count_visits=True, seen=seen, **kw)
    assert torch.equal(seen, union) and int(union[n_nodes:].sum()) > 20
    for a, b in zip(out, allpairs_nearest_record(tb.ptbl, tb.bvh, *rays,
                                                 **kw)):
        assert torch.equal(a, b)


def test_mesh_render_launches_split_kernels(device):
    """A stationary render of the stand-in runs the nearest and shade
    kernels once per iteration and never kernel A; at 1 spp every launch
    equals its plain version."""
    from raytrace_tpu_torch.ops.allpairs_kernel import (
        allpairs_nearest_record,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.render.render import render_accumulate
    scene, s = bunny_standin_scene(128, 4, 10, device=device)
    a0 = bounce_megakernel.launches
    n0, s0 = allpairs_nearest_record.launches, shade_megakernel.launches
    acc, _ = render_accumulate(scene, s, 1, spp=4)
    n_it = allpairs_nearest_record.launches - n0
    assert n_it > 0 and shade_megakernel.launches - s0 == n_it
    assert bounce_megakernel.launches == a0
    assert bool(torch.isfinite(acc).all())
    with checked_launches() as stats:
        render_accumulate(scene, s.replace(rr_depth=2), 1, spp=1)
    for name in ("allpairs_nearest_record", "shade_megakernel"):
        st = stats[name]
        assert st["launches"] > 0 and st["n_int"] == 0 and st["err"] == 0.0


@pytest.mark.parametrize("case", ["noise_test", "box_motion", "all_kinds"])
def test_flat_nearest_kernel_matches_plain(device, case):
    """K8 on camera rays and their second bounce: every output equal to
    the plain version's on every lane (the 832-row table: four tiles)."""
    from raytrace_tpu_torch.render.integrator import split_tables
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    if case == "noise_test":
        scene, s = noise_test_scene(128, 1, 8, device=device)
    elif case == "box_motion":
        scene, s = box_motion_scene(device=device)
    else:
        scene, s = mesh_all_kinds_scene(18, True, 64, device=device)
    tb = split_tables(scene, s)
    comps, uni = camera_rays(scene, s, 1 << 14, 3)
    thr = torch.ones((3, comps.shape[1]), device=device)
    alive = torch.ones(comps.shape[1], dtype=torch.bool, device=device)
    k0 = pallas_nearest_record.launches
    for depth in (0, 1):
        (n_int, err, _), _ = compare_nearest_flat(tb, comps)
        assert n_int == 0 and err == 0.0
        _, sh, _ = compare_shade(tb, comps, uni, thr, alive)
        comps, uni, thr, alive = next_split_rays(comps, sh, 3, depth + 1)
    assert pallas_nearest_record.launches >= k0 + 2


def test_marble_kernel_matches_plain(device):
    """K12 on the hit points of noise_test's camera rays with their
    texture ids (the ball's lanes marble, the ground's not): equal to the
    plain version on every lane, 0 off the marble."""
    from raytrace_tpu_torch.render.integrator import split_tables
    scene, s = noise_test_scene(128, 1, 8, device=device)
    tb = split_tables(scene, s)
    comps, _ = camera_rays(scene, s, 1 << 14, 3)
    pts, hit = surface_points(tb, comps)
    tex = scene.materials.tex[hit[8].long()]
    (_, err, _), out = compare_marble(scene.textures, tex, pts)
    assert err == 0.0
    marble = tex == scene.textures.marble_rows[0]
    assert int(marble.sum()) > 100 and bool((out[~marble] == 0).all())


@pytest.mark.parametrize("pattern", ["alternating", "all", "none",
                                     "ragged", "rows32", "route"])
def test_marble_kernel_on_patterns_matches_plain(device, pattern):
    """K12 on ``testing.marble_patterns`` and on the lanes the forward
    route hands it: equal to the plain version on every lane, 0 off the
    marble rows."""
    if pattern == "route":
        scene, s = noise_test_scene(160, 1, 4, device=device)
        table, (tid, pts), mtbl = (scene.textures,
                                   route_marble_lanes(scene, s, 4), None)
    else:
        table, tid, pts, mtbl = marble_patterns(8, 5000)[pattern]
        tid, pts, mtbl = tid.to(device), pts.to(device), mtbl.to(device)
    (_, err, _), out = compare_marble(table, tid, pts, mtbl)
    assert err == 0.0
    from raytrace_tpu_torch.ops.texture_kernel import marble_table
    rows = (marble_table(table) if mtbl is None else mtbl)[:, 0]
    off = ~torch.isin(tid.to(torch.float32), rows.to(device))
    assert bool((out[off] == 0).all())


def test_image_grad_kernel_matches_plain(device):
    rg = np.random.default_rng(4)
    n, n_img, h, w = 1 << 17, 2, 64, 96
    t = lambda x, dt: torch.from_numpy(x).to(device, dt)
    img = t(rg.integers(0, n_img, n), torch.int32)
    j = t(rg.integers(0, h, n), torch.int32)
    i = t(rg.integers(0, w, n), torch.int32)
    g = t(rg.normal(size=(n, 3)).astype(np.float32), torch.float32)
    dead = torch.arange(n, device=device) % 3 != 0
    img[dead], j[dead], i[dead], g[dead] = 0, 0, 0, 0.0
    (_, _, ex_p), (_, _, ex_x), out = compare_image_grad(img, j, i, g, n_img,
                                                         h, w)
    assert ex_p <= 0.0 and ex_x <= 0.0
    assert out.shape == (n_img, h, w, 3)


def test_rich_render_launches_kernels(device):
    """noise_test renders through K8, the shade kernel and K12, never
    kernels A or B; at 1 spp every launch equals its plain version."""
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import marble_stripe_pallas
    from raytrace_tpu_torch.render.render import render_accumulate
    scene, s = noise_test_scene(256, 4, 10, device=device)
    c = (bounce_megakernel, iter_megakernel, pallas_nearest_record,
         shade_megakernel, marble_stripe_pallas)
    before = [k.launches for k in c]
    acc, _ = render_accumulate(scene, s, 0, spp=4)
    la, lb, l8, l10, l12 = (k.launches - b for k, b in zip(c, before))
    assert la == lb == 0 and l8 > 0 and l10 == l8 and 0 < l12 <= l8
    assert bool(torch.isfinite(acc).all())
    with checked_launches() as stats:
        render_accumulate(scene, s, 0, spp=1)
    for name in ("pallas_nearest_record", "shade_megakernel",
                 "marble_stripe_pallas"):
        st = stats[name]
        assert st["launches"] > 0 and st["n_int"] == 0 and st["err"] == 0.0


def test_image_fwd_bwd_kernels_match_plain(device):
    """The image scene's fwd+bwd: one K13 launch per iteration but the
    last (whose albedo multiply feeds no later radiance, so autograd skips
    its backward), and the all-kernel run against the all-plain one (loss
    equal, every gradient leaf within ``GRAD_RTOL`` of its largest value,
    the atlas included)."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import loss_and_grads, partition
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.image_grad_kernel import image_grad_pallas
    scene, s = image_grad_scene(128, device=device)
    params, statics = partition(scene)
    pix = torch.arange(1 << 14, dtype=torch.int32, device=device)
    target = torch.zeros((1 << 14, 3), device=device)

    def run():
        return loss_and_grads(params, statics, s, rng.base_key(0, device),
                              pix, target, spp=4, n_iters=24, remat=False)

    k0 = image_grad_pallas.launches
    (loss_k, frac_k), g_k = run()
    assert image_grad_pallas.launches == k0 + 23
    with plain_kernels():
        (loss_p, frac_p), g_p = run()
    assert image_grad_pallas.launches == k0 + 23
    assert float(loss_k) == float(loss_p) and float(frac_k) == float(frac_p)
    gk, gp = grads_to_numpy(g_k), grads_to_numpy(g_p)
    assert np.abs(gp["textures.images"]).sum() > 0.0
    for k in gp:
        assert np.isfinite(gk[k]).all(), k
        scale = np.abs(gp[k]).max()
        assert np.abs(gk[k] - gp[k]).max() <= GRAD_RTOL * scale, k


@pytest.mark.parametrize("case", ["cornell_smoke", "ball_box",
                                  "ball_box_moving", "pawn", "mixed",
                                  "mixed_moving"])
def test_crossing_kernels_match_plain(device, case):
    """K11 (cornell_smoke's 12 boundary rows, the ball and box media, still
    and moving) and K11b's forest walk (the stand-in pawn's 1,200 rows; the
    four media of ``testing.mixed_media_world``, still and moving) on
    camera rays, their second bounce, random rays and rays from inside
    the media: the front flags and crossings equal to the plain version's
    on every lane."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
    )
    if case == "cornell_smoke":
        scene, s = cornell_smoke_scene(128, 1, 10, device=device)
        rays = [c for c, _ in media_bounce_rays(scene, s, 3)]
    elif case == "pawn":
        scene, s = pawn_standin_scene(128, 1, 20, device=device)
        rays = [c for c, _ in media_bounce_rays(scene, s, 3)]
        rays.append(pawn_inside_rays(1 << 14, 4, device=device))
    elif case.startswith("mixed"):
        scene = rt.compile_scene(mixed_media_world(rt, case.endswith(
            "moving")), device=device)
        rays = [volume_rays(1 << 14, 5, (-6.0, 6.0), MIXED_MEDIA_INSIDE,
                            device=device)]
    else:
        scene = rt.compile_scene(volume_test_world(rt, case.endswith(
            "moving")), device=device)
        rays = [volume_rays(1 << 14, 5, (-6.0, 6.0), ([0.0, 0.0, -3.0],
                                                      [3.2, 0.0, -3.5]),
                            device=device)]
    k0 = (pallas_volume_crossings.launches,
          pallas_volume_crossings_bcast.launches)
    for comps in rays:
        (n_int, err, _), _ = compare_crossings(scene.volumes, comps)
        assert n_int == 0 and err == 0.0
    k1 = (pallas_volume_crossings.launches,
          pallas_volume_crossings_bcast.launches)
    bcast = case == "pawn" or case.startswith("mixed")
    assert k1[1] - k0[1] == (len(rays) if bcast else 0)
    assert k1[0] - k0[0] == (0 if bcast else len(rays))


@pytest.mark.parametrize("case", ["cornell_smoke", "ball_box",
                                  "ball_box_moving", "pawn", "mixed"])
def test_crossing_instantiations_and_candidate_mode_match_plain(device,
                                                                case):
    """K11's planar instantiation (cornell_smoke's unmoving boxes) and its
    general one, prepared as the route prepares them, in the crossings
    mode equal to the plain version on every lane; the candidate mode of
    K11 (both instantiations) and of K11b (the pawn, the four mixed
    media) against its plain version: material id and scattering equal
    on every lane, t_med within ``CAND_ULPS``."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.render.volumes import volume_tables
    from raytrace_tpu_torch.testing import (
        CAND_ULPS, compare_medium_hit, general_tables, scatter_draws,
    )
    if case == "cornell_smoke":
        scene, s = cornell_smoke_scene(128, 1, 10, device=device)
        rays = [c for c, _ in media_bounce_rays(scene, s, 3)]
    elif case == "pawn":
        scene, s = pawn_standin_scene(128, 1, 20, device=device)
        rays = [c for c, _ in media_bounce_rays(scene, s, 3)]
        rays.append(pawn_inside_rays(1 << 14, 4, device=device))
    elif case == "mixed":
        scene = rt.compile_scene(mixed_media_world(rt), device=device)
        rays = [volume_rays(1 << 14, 5, (-6.0, 6.0), MIXED_MEDIA_INSIDE,
                            device=device)]
    else:
        scene = rt.compile_scene(volume_test_world(rt, case.endswith(
            "moving")), device=device)
        rays = [volume_rays(1 << 14, 5, (-6.0, 6.0), ([0.0, 0.0, -3.0],
                                                      [3.2, 0.0, -3.5]),
                            device=device)]
    tables = volume_tables(scene.volumes)
    assert [x.planar for x in tables.launches] == [case == "cornell_smoke"]
    variants = [tables]
    if tables.forest is None:
        variants.append(general_tables(tables))
    for k, comps in enumerate(rays):
        u = scatter_draws(scene.volumes.n_volumes, comps.shape[1], 6 + k,
                          device=device)
        for tb in variants:
            if tb.forest is None:
                (n_int, err, _), _ = compare_crossings(
                    scene.volumes, comps, tables=tb, prepared=True)
                assert n_int == 0 and err == 0.0
            (n_int, _, ulps), out = compare_medium_hit(scene.volumes, comps,
                                                       u, tables=tb)
            assert n_int == 0 and ulps <= CAND_ULPS
            assert bool(torch.isfinite(out[0]).any())


def test_k11_stages_a_table_past_48_kb(device):
    """K11 takes any boundary table up to ``MAX_STAGED_ROWS`` rows, not
    only those the routes give it (under 64): on the 1,266 rows of
    ``testing.mixed_media_world`` (182,304 bytes of shared memory, past
    the 48 KB a launch gets without opting in) both modes equal the plain
    version."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_candidates, pallas_volume_crossings,
        volume_candidates_plain, volume_crossings_plain,
    )
    from raytrace_tpu_torch.render.volumes import crossing_kw
    from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
    from raytrace_tpu_torch.testing import (
        max_errs, scatter_draws, ulp_diff,
    )
    vol = rt.compile_scene(mixed_media_world(rt), device=device).volumes
    vtbl = pack_prims(vol.prims).contiguous()
    assert vtbl.shape[0] * 36 * 4 > 48 * 1024
    comps = volume_rays(1 << 14, 7, (-6.0, 6.0), MIXED_MEDIA_INSIDE,
                        device=device)
    rays = tuple(comps.unbind(0))
    kw = crossing_kw(vol, 1e-3)
    ref = volume_crossings_plain(vtbl, *rays, **kw)
    out = pallas_volume_crossings(vtbl, *rays, **kw)
    n_int, err, _ = max_errs(ref, out, tuple(range(1, len(ref), 3)))
    assert n_int == 0 and err == 0.0
    u = scatter_draws(vol.n_volumes, comps.shape[1], 8, device=device)
    cand = dict(u=u, t_med=None, vmat=None, density=vol.density,
                mats=vol.mat.tolist(), **kw)
    ref = volume_candidates_plain(vtbl, *rays, **cand)
    out = pallas_volume_candidates(vtbl, *rays, **cand)
    assert torch.equal(ref[1], out[1])
    assert torch.equal(torch.isfinite(ref[0]), torch.isfinite(out[0]))
    assert ulp_diff(ref[0], out[0]) == 0


def test_media_render_launches_kernels(device):
    """cornell_smoke renders through K8, K11 (planar, in the candidate
    mode) and the shade kernel, never kernels A or B (at 1 spp neither:
    the fused branch refuses media); the pawn stand-in through the sorted
    driver with K9, K11b (candidate mode) and the shade kernel; at 1 spp
    every launch equals its plain version, and cornell_smoke's image under
    ``plain_kernels`` equals the kernels'."""
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
    )
    from raytrace_tpu_torch.render.render import render_accumulate
    c = (bounce_megakernel, iter_megakernel, pallas_nearest_record,
         allpairs_nearest_record, shade_megakernel, pallas_volume_crossings,
         pallas_volume_crossings_bcast)
    smoke, s = cornell_smoke_scene(128, 4, 10, device=device)
    pawn, s_p = pawn_standin_scene(128, 2, 8, device=device)
    for scene, settings, spp, near, cross in (
            (smoke, s, 4, 2, 5), (smoke, s, 1, 2, 5),
            (pawn, s_p, 2, 3, 6)):
        before = [k.launches for k in c]
        modes = (pallas_volume_crossings.planar_launches,
                 c[cross].candidate_launches)
        acc, _ = render_accumulate(scene, settings, 0, spp=spp)
        n = [k.launches - b for k, b in zip(c, before)]
        planar = pallas_volume_crossings.planar_launches - modes[0]
        cand = c[cross].candidate_launches - modes[1]
        assert n[0] == n[1] == 0 and n[near] > 0
        assert n[4] == n[near] == n[cross] == cand, n
        assert planar == (n[cross] if scene is smoke else 0)
        assert bool(torch.isfinite(acc).all())
    for scene, settings, names in (
            (smoke, s, ("pallas_nearest_record", "pallas_volume_candidates")),
            (pawn, s_p, ("allpairs_nearest_record",
                         "pallas_volume_candidates_bcast"))):
        with checked_launches() as stats:
            render_accumulate(scene, settings, 0, spp=1)
        for name in names + ("shade_megakernel",):
            st = stats[name]
            exact = st["excess"] <= 0 if "candidates" in name \
                else st["err"] == 0.0
            assert st["launches"] > 0 and st["n_int"] == 0 and exact, \
                (name, st)
    # with K11's plain version the stationary driver's image is the same
    acc, _ = render_accumulate(smoke, s, 0, spp=1)
    before = pallas_volume_crossings.launches
    with plain_kernels():
        acc_p, _ = render_accumulate(smoke, s, 0, spp=1)
    assert pallas_volume_crossings.launches == before
    assert torch.equal(acc, acc_p)


def test_media_scene_lands_on_the_card_and_stays_off_kernel_b(device):
    """A media scene compiled with the defaults lives on the card; kernel
    B, which draws 8 bounce columns, refuses its 8 + V."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.testing import cornell_smoke_world, fresh_carry
    scene = rt.compile_scene(cornell_smoke_world(rt))
    assert scene.device.type == "cuda"
    assert scene.volumes.density.device.type == "cuda"
    _, s = cornell_smoke_scene(64, 1, 10, device=device)
    tables, kw = iter_kernel_args(scene, s, rng.base_key(0, device), 0)
    assert kw["n_u"] == 10
    pix = torch.arange(128, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="n_u=10"):
        iter_megakernel(*tables, (pix,) + fresh_carry(128, device), **kw)


@pytest.mark.parametrize("case", ["cornell_smoke", "ball_box",
                                  "ball_box_moving", "pawn"])
def test_keyed_crossing_mode_matches_plain(device, case):
    """The keyed mode of K11 (cornell_smoke's planar launches, the fog
    ball and box's general ones) and K11b (the pawn) against
    ``volume_crossings_plain(keys=True)`` on every lane: flags and keys
    equal, crossings max |err| 0 and equal to the crossings mode's."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
    )
    from raytrace_tpu_torch.render.volumes import volume_tables
    from raytrace_tpu_torch.testing import compare_keyed
    if case == "cornell_smoke":
        scene, s = cornell_smoke_scene(128, 1, 10, device=device)
        comps, _ = camera_rays(scene, s, 1 << 14, 31)
    elif case == "pawn":
        scene, s = pawn_standin_scene(128, 1, 10, device=device)
        comps = torch.cat([camera_rays(scene, s, 1 << 13, 32)[0],
                           pawn_inside_rays(1 << 13, 33, device=device)], 1)
    else:
        scene = rt.compile_scene(volume_test_world(rt, case.endswith(
            "moving")), device=device)
        comps = volume_rays(1 << 14, 34, (-6.0, 6.0),
                            ([0.0, 0.0, -3.0], [3.2, 0.0, -3.5]),
                            device=device)
    kernel = (pallas_volume_crossings_bcast if case == "pawn"
              else pallas_volume_crossings)
    n0 = kernel.keyed_launches
    (n_int, err, _), n_mode = compare_keyed(scene.volumes, comps,
                                            tables=volume_tables(
                                                scene.volumes))
    assert kernel.keyed_launches == n0 + 1
    assert n_int == 0 and err == 0.0 and n_mode == 0


def test_generic_routes_launch_the_kernels(device):
    """The generic bounce on the card: the media fwd+bwd of cornell_smoke
    (2^12 lanes x 2 spp, 12 iterations) launches K8 and the keyed K11
    (twice an iteration under remat) and no kernel A, B or K5, with finite
    gradients and a non-zero density gradient, equal to the run with
    every plain version (``testing.plain_kernels``) within ``GRAD_RTOL``
    per leaf; a marble-lit render launches K8 and K12; ``grad_render``
    launches K8 and the keyed K11 once a bounce and once in its replay."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        grad_render, leaves, loss_and_grads, partition,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import marble_stripe_pallas
    from raytrace_tpu_torch.ops.volume_kernel import pallas_volume_crossings
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import marble_light_scene
    smoke, s = cornell_smoke_scene(64, 2, 10, device=device)
    s = s.replace(rr_depth=2)
    pix = torch.arange(1 << 12, dtype=torch.int32, device=device) % 4096
    target = torch.zeros((1 << 12, 3), device=device)

    def run():
        return loss_and_grads(*partition(smoke), s, rng.base_key(0, device),
                              pix, target, spp=2, n_iters=12)
    k8, k11, b = (pallas_nearest_record.launches,
                  pallas_volume_crossings.keyed_launches,
                  iter_megakernel.launches)
    (loss, frac), g = run()
    assert pallas_nearest_record.launches - k8 == 24
    assert pallas_volume_crossings.keyed_launches - k11 == 24
    assert iter_megakernel.launches == b
    assert bool((g.volumes.density != 0).any())
    with plain_kernels():
        (loss_p, _), g_p = run()
    assert float(loss) == float(loss_p)
    for k, x in leaves(g_p).items():
        if x is None or not x.is_floating_point():
            continue
        y = leaves(g)[k]
        assert bool(torch.isfinite(y).all()), k
        scale = float(x.abs().max())
        assert float((x - y).abs().max()) <= GRAD_RTOL * scale + 1e-12, k
    scene, sm = marble_light_scene(64, 2, 10, device=device)
    k8, k12 = pallas_nearest_record.launches, marble_stripe_pallas.launches
    acc, total = render_accumulate(scene, sm, seed=0, spp=2)
    assert bool(torch.isfinite(acc).all())
    assert pallas_nearest_record.launches > k8
    assert marble_stripe_pallas.launches > k12
    k8, k11 = (pallas_nearest_record.launches,
               pallas_volume_crossings.keyed_launches)
    _, g = grad_render(smoke, s, rng.base_key(1, device), pix[:1024],
                       torch.arange(2, dtype=torch.int32), target[:1024])
    assert pallas_nearest_record.launches - k8 == 2 * s.max_depth
    assert pallas_volume_crossings.keyed_launches - k11 == 2 * s.max_depth
    assert bool(torch.isfinite(g.volumes.density).all())


@pytest.mark.parametrize("with_medium", [False, True])
def test_shade_kernel_rotation_table_matches_plain(device, with_medium):
    """K10 with its sphere rotation table (sphere flag 1 on sphere lanes,
    ellipsoid winner indices on some missing lanes) equals ``shade_plain``
    with the same rotations on every lane; the table moves the checker
    cell of rotated lanes only."""
    from raytrace_tpu_torch.ops.bounce_kernel import (
        shade_megakernel, shade_plain, sphere_rot_table,
    )
    from raytrace_tpu_torch.testing import (
        BOUNCE_INT_ROWS, max_errs, rotated_spheres_scene, sphere_rot_inputs,
    )
    scene, s = rotated_spheres_scene(128, device=device)
    tb, hit, lanes, uni = sphere_rot_inputs(scene, s, 7)
    rots = scene.prims.sphere_rots
    medium = synthetic_medium(hit[0], tb.n_mats, 8) if with_medium else None
    kw = dict(n_mats=tb.n_mats, n_targets=tb.n_targets,
              has_medium=with_medium)
    ref = shade_plain(tb.mtbl, tb.ttbl, hit, medium, lanes, uni,
                      sphere_rots=rots, **kw)
    n0 = shade_megakernel.rot_launches
    out = shade_megakernel(tb.mtbl, tb.ttbl, hit, medium, lanes, uni,
                           sphere_rots=rots, **kw)
    assert shade_megakernel.rot_launches == n0 + 1
    n_int, err, _ = max_errs(ref, out, BOUNCE_INT_ROWS)
    assert n_int == 0 and err == 0.0
    out0 = shade_megakernel(tb.mtbl, tb.ttbl, hit, medium, lanes, uni, **kw)
    rot = torch.isin(hit[1], sphere_rot_table(rots, device)[:, 0]) \
        & (lanes[9] > 0.5)
    moved = (out[6] - out0[6]).abs() > 1e-3
    assert bool((moved & rot).any()) and not bool((moved & ~rot).any())


def test_ellipsoids_and_demo2_render_and_differentiate(device):
    """The ellipsoid scene and demo2 render on the card through the split
    route (K8 or K9, K10; demo2's media through K11), every checked launch
    exact, and ``grad_render`` of each gives finite gradients (the
    ellipsoids' leaves, demo2's fog density and earth texels non-zero)."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import grad_render
    from raytrace_tpu_torch.testing import demo2_scene, ellipsoid_scene
    for scene, s, names in (
            (*ellipsoid_scene(64, 2, 8, device=device),
             ("pallas_nearest_record", "shade_megakernel")),
            (*demo2_scene(64, 2, 4, device=device),
             ("allpairs_nearest_record", "shade_megakernel",
              "pallas_volume_candidates", "marble_stripe_pallas"))):
        with checked_launches() as st:
            img = rt.render(scene, s, seed=1)
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
        for name in names:
            assert st[name]["launches"] > 0, name
            assert st[name]["n_int"] == 0 and st[name]["err"] == 0.0, name
        pix = torch.arange(0, 4096, dtype=torch.int32, device=device)
        loss, g = grad_render(scene, s, rng.base_key(2, device), pix,
                              torch.arange(2, dtype=torch.int32),
                              torch.zeros((4096, 3), device=device))
        assert np.isfinite(float(loss))
        if scene.ellipsoids is not None:
            assert all(bool(torch.isfinite(getattr(g.ellipsoids, f)).all())
                       for f in ("center", "radius", "fwd", "inv", "shift",
                                 "mv0", "mv1"))
            assert bool((g.ellipsoids.fwd != 0).any())
        else:
            assert float(g.volumes.density[0]) != 0.0
            assert bool((g.textures.images != 0).any())


def test_k9_past_the_cap_matches_plain(device):
    """K9 over ``testing.bigmesh_world(rt, 184, 184)`` (67,392
    kind-segmented rows, past the old 65,536 cap) against its plain
    version on 4,096 camera rays and their second bounce: exact; the card
    keeps ``accel="auto"`` dense at any size."""
    from raytrace_tpu_torch.render.integrator import split_tables
    from raytrace_tpu_torch.testing import bigmesh_scene
    scene, s = bigmesh_scene(184, 184, 64, 1, 4, device=device)
    assert scene.bvh is None and scene.prims.kind.shape[0] > 65536
    tb = split_tables(scene, s)
    comps, uni = camera_rays(scene, s, 4096, 21)
    errs, out = compare_nearest(tb, comps)
    assert errs[0] == 0 and errs[1] == 0.0, errs
    assert int((out[1] >= 0).sum()) > 1000
    hit = surface_points(tb, comps)[1]
    alive = torch.ones(4096, dtype=torch.bool, device=device)
    lanes = (*comps[0:6], *torch.ones((3, 4096), device=device),
             alive.float())
    from raytrace_tpu_torch.ops.bounce_kernel import shade_megakernel
    sh = shade_megakernel(tb.mtbl, tb.ttbl, hit, None, lanes, uni,
                          n_mats=tb.n_mats, n_targets=tb.n_targets,
                          has_medium=False)
    nxt, _, _, alive2 = next_split_rays(comps, sh, 22, 1)
    nxt[0:3] = torch.where(alive2, nxt[0:3], 3e18)
    errs2, _ = compare_nearest(tb, nxt.contiguous())
    assert errs2[0] == 0 and errs2[1] == 0.0, errs2


def test_bigmesh_route_matches_engine_report(device):
    """A past-the-cap mesh renders through the sorted driver and the split
    path (K9 and K10, no kernel A, B or K8), as ``engine_report`` says,
    every checked launch exact (K9 on 4,096 lanes of each); its
    ``grad_render`` through K9 gives finite gradients, non-zero for the
    rows' edges and the albedo (the corners' is zero, in the JAX package
    too: a lambertian hit's weight does not depend on the hit point)."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import grad_render
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.testing import bigmesh_scene
    from raytrace_tpu_torch.utils.engines import engine_report
    scene, s = bigmesh_scene(184, 184, 128, 1, 8, device=device)
    rep = engine_report(scene, s)
    assert (rep["driver"], rep["forward"], rep["intersect"]) == (
        "sorted", "split", "K9")
    with checked_launches(sample=4096) as st:
        img = rt.render(scene, s, seed=1)
    assert bool(torch.isfinite(img).all())
    for name in ("allpairs_nearest_record", "shade_megakernel"):
        assert st[name]["launches"] > 0, name
        assert st[name]["n_int"] == 0 and st[name]["err"] == 0.0, name
    for name in ("bounce_megakernel", "pallas_nearest_record"):
        assert st[name]["launches"] == 0, name
    assert engine_report(scene, s, diff=True)["intersect"] == "K9"
    n0 = allpairs_nearest_record.launches
    pix = torch.arange(0, 16384, 4, dtype=torch.int32, device=device)
    loss, g = grad_render(scene, s, rng.base_key(2, device), pix,
                          torch.arange(1, dtype=torch.int32),
                          torch.zeros((4096, 3), device=device))
    assert allpairs_nearest_record.launches > n0
    assert np.isfinite(float(loss))
    assert bool(torch.isfinite(g.prims.p0).all())
    for t in (g.prims.e1, g.prims.e2, g.textures.c0):
        assert bool(torch.isfinite(t).all()) and bool((t != 0).any())


def test_bvh_mode_scene_takes_k9_on_the_card(device):
    """A scene compiled in the BVH accelerator mode on the CPU, moved to
    the card, renders through the split path over K9 (its unsegmented
    rows; no kernel A, B or K8), within ``tests/test_torch_render.py``'s
    bound of the CPU render over the tree walk in torch."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.render.integrator import surface_engine
    from raytrace_tpu_torch.testing import mesh_all_kinds_world
    cpu = rt.compile_scene(mesh_all_kinds_world(rt, 18), accel="bvh",
                           device="cpu")
    card = cpu.to(device)
    assert surface_engine(cpu) == "torch-bvh" and surface_engine(card) == "K9"
    s = rt.CameraSettings(center=[0.0, 2.0, 8.0], look_at=[0.0, 0.0, 0.0],
                          image_width=32, samples_per_pixel=2, max_depth=4,
                          background=rt.sky)
    with checked_launches() as st:
        img = rt.render(card, s, seed=3).cpu().numpy()
    assert st["allpairs_nearest_record"]["launches"] > 0
    assert st["allpairs_nearest_record"]["n_int"] == 0
    for name in ("bounce_megakernel", "pallas_nearest_record",
                 "iter_megakernel"):
        assert st[name]["launches"] == 0, name
    ref = rt.render(cpu, s, seed=3).numpy()
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-5).mean() < 0.05 and np.median(diff) <= 1e-6
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=2e-3)


def test_sharded_wavefront_one_rank_nccl_equals_render_accumulate(device):
    """``sharded_wavefront_render_fn`` at one rank over NCCL (the backend
    of the multi-GPU path) runs the stationary driver on the whole image:
    its sums equal ``render_accumulate``'s bit for bit, and the padding
    rows are zero; ``multihost.render`` gives the same image."""
    import torch.distributed as dist
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.parallel import multihost
    from raytrace_tpu_torch.parallel.sharding import (
        make_mesh, sharded_wavefront_render_fn,
    )
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import free_port
    scene, s = cornell_scene_and_settings(130, 16, 20, device=device)
    n_pix = s.image_width * s.image_height
    multihost.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        fn = sharded_wavefront_render_fn(make_mesh(), n_pix, 16)
        acc = fn(scene, s, rng.base_key(4, device))
        ref, _ = render_accumulate(scene, s, seed=4, spp=16)
        assert torch.equal(acc[:n_pix], ref)
        assert not acc[n_pix:].any()
        img = multihost.render(scene, s, seed=4)
        np.testing.assert_array_equal(
            img, (ref / 16).cpu().numpy().reshape(img.shape))
    finally:
        dist.destroy_process_group()


def test_scene_main_on_the_card(device, tmp_path):
    """A scene driver without ``--cpu`` renders on the card through kernel
    B (the stationary driver's rotated mode at 4 spp) and writes its
    PNG."""
    from PIL import Image
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.scenes import metal_test
    out = str(tmp_path / "metal.png")
    before = iter_megakernel.launches
    img = metal_test.main(["--width", "192", "--spp", "4", "--depth", "8",
                           "--out", out])
    assert iter_megakernel.launches > before
    assert tuple(img.shape) == (108, 192, 3) and torch.isfinite(img).all()
    assert Image.open(out).size == (192, 108)



def _sorted_case(case, device):
    from raytrace_tpu_torch.testing import pawn_two_media_scene
    if case == "two_media":
        scene, s = pawn_two_media_scene(64, 4, 20, device=device)
    else:
        scene, s = pawn_standin_scene(64, 4, 20, device=device)
    if case == "rr":
        s = s.replace(rr_depth=2)
    offset = 700 if case == "offset" else 0
    return scene, s, 64 * 64 - offset, offset


@pytest.mark.parametrize("case", ["pawn", "two_media", "rr", "offset"])
def test_sorted_turn_matches_plain(device, case):
    """Every HEAD and TAIL launch of the sorted driver on the pawn
    stand-in (one medium: 15 uniform columns; two media: 16), with and
    without Russian roulette (``rr_depth`` 2), at a pixel offset with
    padding lanes, equals its plain version lane for lane, bit for bit:
    the lane state, uniforms, camera rays, keys, control words and
    counts; the radiance sums within ``SCATTER_RTOL x k x |plain|`` (float
    atomics in another order).  The launches cover the first turn, middle
    turns, the turn whose items run out inside the dead suffix and drain
    turns."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.render.integrator import trace_wavefront_sorted
    scene, s, n_pix, offset = _sorted_case(case, device)
    with checked_launches() as stats:
        acc, st = trace_wavefront_sorted(scene, s, rng.base_key(3, device),
                                         n_pix, 4, sample_offset=11,
                                         pixel_offset=offset, with_stats=True)
    head, tail = stats["sorted_head"], stats["sorted_tail"]
    assert head["launches"] == tail["launches"] == st["iterations"] > 0
    assert head["n_int"] == 0 and head["err"] == 0.0, head
    assert tail["n_int"] == 0 and tail["err"] == 0.0, tail
    assert tail["acc_excess"] <= 0.0, tail
    assert all(n > 0 for n in head["turns"].values()), head["turns"]
    assert bool(torch.isfinite(acc).all())


@pytest.mark.parametrize("case", ["pawn", "two_media", "rr", "offset"])
def test_sorted_render_matches_plain_driver(device, case):
    """The sorted driver with HEAD and TAIL launched against the same
    driver on their plain versions (``testing.plain_sorted_turn``): the
    ``with_stats`` counts equal, the image within rtol 1e-5, atol 1e-6 (a
    pixel's paths added by float atomics in another order)."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops.sorted_turn import sorted_head
    from raytrace_tpu_torch.render.integrator import trace_wavefront_sorted
    from raytrace_tpu_torch.testing import plain_sorted_turn
    scene, s, n_pix, offset = _sorted_case(case, device)
    key = rng.base_key(5, device)
    run = lambda: trace_wavefront_sorted(scene, s, key, n_pix, 4,
                                         pixel_offset=offset,
                                         with_stats=True)
    before = sorted_head.launches
    acc, st = run()
    assert sorted_head.launches - before == st["iterations"]
    with plain_sorted_turn():
        ref, ref_st = run()
    assert sorted_head.launches - before == st["iterations"]
    for name in ("iterations", "segments", "medium_segments", "lanes"):
        assert int(st[name]) == int(ref_st[name]), name
    torch.testing.assert_close(acc, ref, rtol=1e-5, atol=1e-6)


def test_sorted_turn_host_launches(device):
    """A turn of the sorted driver on the pawn stand-in issues at most 80
    host kernel launches under ``torch.profiler``: the argsort, HEAD, the
    split bounce (K9, K11b, K10 and their torch glue) and TAIL; its plain
    versions' turn (the driver's torch lines before HEAD and TAIL) over
    300."""
    from torch.autograd import DeviceType
    from portbench.trace import LAUNCH_CALLS
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops.sorted_turn import sorted_head
    from raytrace_tpu_torch.render.integrator import trace_wavefront_sorted
    from raytrace_tpu_torch.testing import plain_sorted_turn
    scene, s = pawn_standin_scene(128, 2, 20, device=device)
    key = rng.base_key(2, device)
    run = lambda: trace_wavefront_sorted(scene, s, key, 128 * 128, 2)
    run()
    torch.cuda.synchronize()

    def launches_a_turn():
        before = sorted_head.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        calls = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name in LAUNCH_CALLS)
        return calls, sorted_head.launches - before

    calls, turns = launches_a_turn()
    assert turns > 0 and calls / turns <= 80, (calls, turns)
    with plain_sorted_turn():
        plain_calls, _ = launches_a_turn()
    assert plain_calls / turns > 300, (plain_calls, turns)


def test_demo2_cell_reads_correct_on_the_card(device):
    """The ``demo2-fwd`` cell at 128 x 128 and 10 spp (16,384 pixels: the
    stationary driver's split branch at rotate_k 5, K9, K11, K10, K12) in
    a process of its own reads ``correct`` against its plain reference,
    its ``image_gap`` far under the cell's limit."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    child = (
        "import sys\n"
        "from portbench import run\n"
        "tiny = {'config': {'camera': {'image_width': 128}},\n"
        "        'traffic': {'pass_spp': 10, 'warm_spp': 5},\n"
        "        'cell': {'check_pixels': 2048}}\n"
        "line, _, code = run.run_cell('demo2-fwd', 2 ** 31 + 99, 0.0, False,\n"
        "                             overrides=tiny)\n"
        "print(line)\n"
        "sys.exit(code)\n")
    out = subprocess.run([sys.executable, "-c", child],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    gap = res["checks"]["image_gap"]
    assert gap["value"] <= gap["limit"] / 100
    assert res["device"]["platform"] == "gpu"
