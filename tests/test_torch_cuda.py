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
kernel K12 and the medium crossing kernels K11 and K11b; the atlas
gradient K13 within ``testing.image_grad_errs`` (float atomics add in a
varying order).
"""
import numpy as np
import pytest
import torch

from raytrace_tpu_torch.render.integrator import bounce_tables
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, FRAC_LANES, MEAN_RTOL, all_materials_scene,
    bounce_inputs, box_motion_scene, bunny_standin_scene, bwd_inputs,
    camera_rays, checked_launches, compare_bounce, compare_bwd, compare_iter,
    compare_image_grad, compare_k7, compare_marble, compare_nearest,
    compare_crossings, compare_nearest_flat, compare_shade,
    cornell_scene_and_settings, cornell_smoke_scene, image_grad_scene,
    k7_inputs, many_media_settings, many_media_world,
    media_bounce_rays, mesh_all_kinds_scene, next_split_rays,
    noise_test_scene, pawn_inside_rays, pawn_standin_scene, plain_backward,
    plain_kernels, surface_points, synthetic_medium, volume_rays,
    volume_test_world,
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
    (n_int, _, excess), frac, mean_rel = compare_iter(
        scene, s.replace(rr_depth=2), 4096, 3)
    assert n_int == 0
    assert excess <= 0.0
    assert frac < FRAC_LANES
    assert mean_rel <= MEAN_RTOL


def test_render_launches_kernels(device):
    from raytrace_tpu_torch.ops.bounce_kernel import bounce_megakernel
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.render.render import render_accumulate
    scene, s = cornell_scene_and_settings(128, 8, 10, device=device)
    a0, b0 = bounce_megakernel.launches, iter_megakernel.launches
    acc, _ = render_accumulate(scene, s, 1, spp=8)
    assert bounce_megakernel.launches > a0
    assert iter_megakernel.launches == b0
    acc1, _ = render_accumulate(scene, s, 1, spp=1)
    assert iter_megakernel.launches > b0
    # under 16384 pixels: the work-queue driver, through kernel A
    small, s_small = cornell_scene_and_settings(32, 8, 10, device=device)
    a1 = bounce_megakernel.launches
    acc2, _ = render_accumulate(small, s_small, 1, spp=8)
    assert bounce_megakernel.launches > a1
    assert all(bool(torch.isfinite(a).all()) for a in (acc, acc1, acc2))


@pytest.mark.parametrize("spp", [8, 1])
def test_render_launches_match_plain(device, spp):
    """Every launch of a 130 x 130 render (16900 pixels on 17024 lanes:
    the padding lanes and the rotated pixel maps of the main path) agrees
    with the plain version on the inputs the driver gave it."""
    from raytrace_tpu_torch.render.render import render_accumulate
    scene, s = cornell_scene_and_settings(130, spp, 10, device=device)
    with checked_launches() as stats:
        acc, _ = render_accumulate(scene, s.replace(rr_depth=2), 1, spp=spp)
    st = stats["bounce_megakernel" if spp > 1 else "iter_megakernel"]
    assert st["launches"] > 0
    assert st["n_int"] == 0
    assert st["excess"] <= 0.0
    assert bool(torch.isfinite(acc).all())


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
        args, kw = k7_inputs(scene, s, 1 << 14, 4, seed=5)
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
    boundary of rotated boxes) launches once per group of at most 16
    media (two a bounce), each launch equal to its plain version."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.render.render import render_accumulate
    scene = rt.compile_scene(many_media_world(rt, 17, rotated),
                             device=device)
    s = many_media_settings(rt, 64, 2, 8)
    assert scene.volumes.n_volumes == 17
    with checked_launches() as stats:
        acc, _ = render_accumulate(scene, s, 0, spp=2)
    st = stats["pallas_volume_crossings_bcast" if rotated
               else "pallas_volume_crossings"]
    assert st["launches"] == 2 * stats["pallas_nearest_record"]["launches"]
    assert st["n_int"] == 0 and st["err"] == 0.0
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
    (n_int, err, excess), frac, mean_rel = compare_iter(
        scene, s.replace(rr_depth=2), 1 << 14, 3, n_iters=10,
        box=(-1.0, 1.0))
    assert iter_mega_ap.launches == m0 + 11
    assert n_int == 0 and err == 0.0
    assert frac < FRAC_LANES and mean_rel <= MEAN_RTOL


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
                                  "ball_box_moving", "pawn"])
def test_crossing_kernels_match_plain(device, case):
    """K11 (cornell_smoke's 12 boundary rows, the ball and box media, still
    and moving) and K11b (the stand-in pawn's 1,200 rows) on camera rays,
    their second bounce, random rays and rays from inside the media: the
    front flags and crossings equal to the plain version's on every
    lane."""
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
    bcast = case == "pawn"
    assert k1[1] - k0[1] == (len(rays) if bcast else 0)
    assert k1[0] - k0[0] == (0 if bcast else len(rays))


def test_media_render_launches_kernels(device):
    """cornell_smoke renders through K8, K11 and the shade kernel, never
    kernels A or B (at 1 spp neither: the fused branch refuses media); the
    pawn stand-in through the sorted driver with K9, K11b and the shade
    kernel; at 1 spp every launch equals its plain version, and
    cornell_smoke's image under ``plain_kernels`` equals the kernels'."""
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
        acc, _ = render_accumulate(scene, settings, 0, spp=spp)
        n = [k.launches - b for k, b in zip(c, before)]
        assert n[0] == n[1] == 0 and n[near] > 0
        assert n[4] == n[near] == n[cross], n
        assert bool(torch.isfinite(acc).all())
    for scene, settings, names in (
            (smoke, s, ("pallas_nearest_record", "pallas_volume_crossings")),
            (pawn, s_p, ("allpairs_nearest_record",
                         "pallas_volume_crossings_bcast"))):
        with checked_launches() as stats:
            render_accumulate(scene, settings, 0, spp=1)
        for name in names + ("shade_megakernel",):
            st = stats[name]
            assert st["launches"] > 0 and st["n_int"] == 0 \
                and st["err"] == 0.0, (name, st)
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
