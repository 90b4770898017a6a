"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the
machine with the card run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: this file needs neither JAX nor the JAX package).
Tolerances: alive/miss/winner index equal on every lane (the kernels are
built without multiply-add contraction and round like the plain version),
floats within atol 2e-3 + rtol 1e-3 (tests/test_bounce_kernel.py); the
backward kernel K5 within ``testing.BWD_RTOL`` of the scale of each
gradient (``testing.bwd_errs``), and the fwd+bwd with K5 against the same
with its plain version within ``GRAD_RTOL`` per gradient leaf (the
per-lane differences of K5, summed by atomic ``index_add_`` in an order
that changes from run to run).  The mesh kernels (nearest hit over the
BVH, shade, kernel B's mesh variant) equal their plain versions exactly
on every lane.
"""
import numpy as np
import pytest
import torch

from raytrace_tpu_torch.render.integrator import bounce_tables
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, FRAC_LANES, MEAN_RTOL, all_materials_scene,
    bounce_inputs, box_motion_scene, bunny_standin_scene, bwd_inputs,
    camera_rays, checked_launches, compare_bounce, compare_bwd, compare_iter,
    compare_nearest, compare_shade, cornell_scene_and_settings,
    mesh_all_kinds_scene, next_split_rays, plain_backward, synthetic_medium,
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
        bounce_bwd_regen_pre_megakernel,
    )
    scene, s = cornell_scene_and_settings(128, 8, 10, device=device)
    params, statics = partition(scene)
    pix = torch.arange(1 << 14, dtype=torch.int32, device=device)
    target = torch.zeros((1 << 14, 3), device=device)

    def run():
        return loss_and_grads(params, statics, s.replace(rr_depth=2),
                              rng.base_key(0, device), pix, target, spp=8,
                              n_iters=40, remat=False)

    k0 = bounce_bwd_regen_pre_megakernel.launches
    (loss_k, frac_k), g_k = run()
    assert bounce_bwd_regen_pre_megakernel.launches == k0 + 40
    with plain_backward():
        (loss_p, frac_p), g_p = run()
    assert bounce_bwd_regen_pre_megakernel.launches == k0 + 40
    assert float(loss_k) == float(loss_p) and float(frac_k) == float(frac_p)
    gk, gp = grads_to_numpy(g_k), grads_to_numpy(g_p)
    for k in gp:
        assert np.isfinite(gk[k]).all(), k
        scale = np.abs(gp[k]).max()
        assert np.abs(gk[k] - gp[k]).max() <= GRAD_RTOL * scale, k


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
