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
that changes from run to run).
"""
import numpy as np
import pytest
import torch

from raytrace_tpu_torch.render.integrator import bounce_tables
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, FRAC_LANES, MEAN_RTOL, all_materials_scene,
    bounce_inputs, box_motion_scene, bwd_inputs, checked_launches,
    compare_bounce, compare_bwd, compare_iter, cornell_scene_and_settings,
    plain_backward,
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
