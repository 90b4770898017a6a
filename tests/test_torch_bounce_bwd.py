"""Kernel K5's plain version against the JAX package's Pallas kernel.

``bounce_bwd_regen_pre_plain`` (torch autograd over the port's
``lane_math``) and ``raytrace_tpu``'s ``bounce_bwd_regen_pre_megakernel``
(``interpret=True``) take the same inputs: 1024 lanes of a real
mid-render state (kernel B's plain version steps a fresh carry four
times; the fifth step's inputs, winner index and RR scale are K5's) with
random normal cotangents, on the Cornell box (one redirect target,
constant background, RR from depth 2), the all-materials scene (two
targets, sky) and the box/motion scene (no target, gray fade).  Every one
of the ``n_row + 20`` outputs is compared on every lane.

Tolerance: ``RTOL * (|jax| + max|jax| over the output + max|jax| over the
lane)`` with ``RTOL = 1e-4`` (the bound of ``testing.bwd_errs``) on all
but ``FRAC = 0.5%`` of the lanes: the JAX kernel runs as one XLA program,
whose CPU backend contracts a*b+c into fused multiply-adds, so a
comparison near a branch threshold may go the other way on a rare lane.
Measured: 1 lane of 1024 differs on the all-materials state, none on the
others.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu.ops.pallas.bounce_bwd_gather_kernel import (
    bounce_bwd_regen_pre_megakernel as jax_k5,
)
from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
    bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_plain,
)
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, all_materials_scene, box_motion_scene, bwd_inputs,
    cornell_scene_and_settings,
)

R = 1024
RTOL = 1e-4
FRAC = 0.005


def _case(name):
    if name == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device="cpu")
        return scene, s.replace(rr_depth=2)
    if name == "all_materials":
        s = rt.CameraSettings(background=rt.sky, image_width=64,
                              max_depth=10)
        return (all_materials_scene(device="cpu"),
                s.with_redirect_targets(ALL_MATERIAL_TARGETS))
    scene, s = box_motion_scene(device="cpu")
    return scene, s.replace(background=rt.gray_fade)


@pytest.mark.parametrize("name", ["cornell", "all_materials", "box_motion"])
def test_plain_backward_matches_jax_kernel(name):
    scene, s = _case(name)
    args, kw = bwd_inputs(scene, s, R, 11, n_iters=4)
    (ttbl, kt, cam, gath, bi, ints, al, comps_in, thr_in, scale, cts) = args
    a0 = bounce_bwd_regen_pre_megakernel.launches
    ours = bounce_bwd_regen_pre_megakernel(*args, **kw)
    assert bounce_bwd_regen_pre_megakernel.launches == a0   # CPU: plain
    ref = bounce_bwd_regen_pre_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ours, ref))

    g = R // 128
    j = lambda x: jnp.asarray(x.numpy().reshape(g, 128))
    outs = jax_k5(jnp.asarray(ttbl.numpy()), jnp.asarray(kt.numpy()[None]),
                  jnp.asarray(cam.numpy()[None]), [j(x) for x in gath],
                  j(bi), tuple(j(x) for x in ints), j(al),
                  tuple(j(x) for x in comps_in), tuple(j(x) for x in thr_in),
                  j(scale), tuple(j(x) for x in cts), interpret=True, **kw)
    flat = [x for part in outs
            for x in (part if isinstance(part, tuple) else (part,))]
    assert len(flat) == len(ours) == kw["n_row"] + 20
    jx = np.stack([np.asarray(x).reshape(R) for x in flat]).astype(np.float64)
    tx = torch.stack(ours).numpy().astype(np.float64)
    mag = np.abs(jx)
    bound = RTOL * (mag + mag.max(1, keepdims=True)
                    + mag.max(0, keepdims=True))
    bad = (np.abs(tx - jx) > bound) | (np.isnan(tx) != np.isnan(jx))
    assert bad.any(0).mean() <= FRAC, int(bad.any(0).sum())
    # the lanes carry gradient: live hits and every output row in use
    assert int((al > 0.5).sum()) > R // 8
    assert (np.abs(jx).max(1) > 0).sum() >= kw["n_row"] + 10
