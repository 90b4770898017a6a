"""The port's differentiable render path against the JAX package's.

* ``render_loss_wavefront`` forward and backward (kernel B's and K5's
  plain versions on the CPU) against ``jax.value_and_grad`` of the same
  loss over ``trace_wavefront_diff(..., use_mega=True,
  mega_interpret=True)`` (the fused custom-VJP driver, Pallas kernels in
  interpret mode), as ``tests/test_fused_iter.py`` builds it: Cornell at
  64 px, 4096 lanes, 4 spp, 16 iterations, Russian roulette from depth 2,
  with and without the completion schedule ``((15, 2048),)``.
* The same on a scene with axis-aligned boxes, motion, metal and a
  dielectric (gradients of every kind of leaf the backward reaches).
* ``partition``/``combine`` round trip, and a central finite difference
  of a wall albedo against its gradient.

Tolerances.  The JAX side runs as XLA programs, whose CPU backend
contracts a*b+c into fused multiply-adds, so a grazing or edge hit (or a
Russian-roulette draw next to its survival probability) resolves
differently on a few paths, and the two renders then follow different
paths from there on (PERF.md).  The loss agrees to ``LOSS_RTOL = 1e-3``
(measured 1.5e-5 and 1.5e-4), and the completed-sample fraction exactly.
A gradient leaf is a sum over all paths, and a wall's normal gradient is
carried by few paths with large weights (those whose MIS pdf is far from
the cosine pdf), so each leaf is held in the L2 norm: ``|port - jax| <=
rtol * |jax|`` with ``rtol`` 0.02 for 16 iterations (measured 0.005) and
0.25 for the 31 of the schedule, where more paths have diverged (measured
0.10 on the light's edge vectors).  Leaves that JAX gives exactly zero
(corners, uvs, motion, material params, the second checker color, the
unused texture fields) are zero here too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.gradients import combine as jcombine
from raytrace_tpu.diff.gradients import partition as jpartition
from raytrace_tpu.render.integrator import trace_wavefront_diff as jtrace
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import (
    combine, finite_difference, leaves, loss_and_grads, partition,
    render_loss_wavefront,
)
from raytrace_tpu_torch.interop import (
    fields_to_numpy, grads_to_numpy, scene_from_numpy, scene_to_numpy,
    settings_from_numpy,
)
from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
    bounce_bwd_regen_pre_megakernel,
)

R = 4096
SPP = 4
N_ITERS = 16
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def cornell():
    js, jset = _cornell_scene_and_settings(64, SPP, 10)
    jset = jset.replace(rr_depth=2)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    return js, jset, ts, settings_from_numpy(d)


@pytest.mark.parametrize("schedule,rtol", [(None, 0.02),
                                           (((15, 2048),), 0.25)])
def test_loss_and_gradients_match_jax(cornell, schedule, rtol):
    js, jset, ts, tset = cornell
    pix = np.arange(R, dtype=np.int32) % (64 * 64)

    def jloss(params, statics):
        img, done = jtrace(jcombine(params, statics), jset, jrng.base_key(0),
                           jnp.asarray(pix), SPP, n_iters=N_ITERS,
                           remat=False, use_mega=True, mega_interpret=True,
                           schedule=schedule)
        return jnp.mean(img ** 2), jnp.mean(done / SPP)

    (jl, jfrac), jg = jax.value_and_grad(jloss, has_aux=True)(
        *jpartition(js))
    params, statics = partition(ts)
    k0 = bounce_bwd_regen_pre_megakernel.launches
    (tl, tfrac), tg = loss_and_grads(
        params, statics, tset, rng.base_key(0), torch.from_numpy(pix),
        torch.zeros((R, 3)), spp=SPP, n_iters=N_ITERS, remat=False,
        schedule=schedule)
    assert bounce_bwd_regen_pre_megakernel.launches == k0   # CPU: plain
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(tfrac) == float(jfrac)
    jn, tn = grads_to_numpy(jg), grads_to_numpy(tg)
    assert sorted(jn) == sorted(tn)
    for k in jn:
        assert tn[k].shape == jn[k].shape, k
        assert np.all(np.isfinite(tn[k])), k
        scale = np.linalg.norm(jn[k])
        if scale == 0.0:
            assert not np.any(tn[k]), k
        else:
            assert np.linalg.norm(tn[k] - jn[k]) <= rtol * scale, k
    assert np.linalg.norm(jn["textures.c0"]) > 0.1
    assert np.linalg.norm(jn["prims.e2"]) > 0.0


def test_partition_combine_round_trip(cornell):
    _, _, ts, _ = cornell
    params, statics = partition(ts)
    back = combine(params, statics)
    for k, v in leaves(ts).items():
        assert torch.equal(leaves(back)[k], v), k
        p, s = leaves(params).get(k), leaves(statics).get(k)
        if v.is_floating_point():
            assert p.requires_grad and p.is_leaf and s is None, k
        else:
            assert s is v and p is None, k
    assert back.prims.n == ts.prims.n
    assert back.materials.n_behaviors == ts.materials.n_behaviors


def test_albedo_gradient_matches_finite_difference(cornell):
    """The red wall's albedo (exact estimator, so the paths do not depend
    on it and the same seed makes the difference noise-free): the
    gradient within 2% of the central difference."""
    _, _, ts, tset = cornell
    tset = tset.replace(rr_depth=None)
    pix = torch.arange(2048, dtype=torch.int32) * 2
    target = torch.full((2048, 3), 0.1)
    red = int(torch.argmax(ts.textures.c0[:, 0] - ts.textures.c0[:, 1]))
    params, statics = partition(ts)
    kw = dict(spp=2, n_iters=24, remat=False)
    _, g = loss_and_grads(params, statics, tset, rng.base_key(3), pix,
                          target, **kw)

    def f(x):
        c0 = ts.textures.c0.clone()
        c0[red, 0] = x[0]
        sc = dataclasses.replace(
            ts, textures=dataclasses.replace(ts.textures, c0=c0))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), tset,
                                         rng.base_key(3), pix, target,
                                         **kw)[0]

    x0 = ts.textures.c0[red, 0:1].clone()
    fd = finite_difference(f, x0, eps=1e-2)
    gv = float(g.textures.c0[red, 0])
    assert abs(gv) > 1e-4
    np.testing.assert_allclose(gv, float(fd[0]), rtol=0.02)


def _box_motion_pair():
    """A JAX scene with axis-aligned boxes (one moving), a moving sphere,
    a checker ground and a light, under the sky, and the port's copy."""
    import raytrace_tpu as jrt
    from raytrace_tpu.render.camera import sky
    world = jrt.group([
        jrt.with_material(jrt.lambertian(jrt.checker_texture(
            2, 2, [0.8, 0.3, 0.2], [0.2, 0.3, 0.8])),
            jrt.parallelogram([-6, -1, -6], [12, 0, 0], [0, 0, 12])),
        jrt.with_material(jrt.lambertian(jrt.constant_texture(
            [0.7, 0.6, 0.5])), jrt.cuboid([-2.5, -1, -1], [-0.5, 1, 1])),
        jrt.with_material(jrt.metal(0.2, jrt.constant_texture(
            [0.9, 0.8, 0.6])), jrt.moving([0, 0, 0], [0.4, 0.2, 0],
                                          jrt.cuboid([0.5, -1, -1],
                                                     [2, 0.5, 0.5]))),
        jrt.with_material(jrt.dielectric(1.4), jrt.moving(
            [0, 0, 0], [0, 0.3, 0.2], jrt.sphere([0, 1.5, 1.5], 0.8))),
        jrt.with_material(jrt.light_source(jrt.constant_texture(4.0)),
                          jrt.parallelogram([-1, 4, -1], [2, 0, 0],
                                            [0, 0, 2])),
    ])
    js = jrt.compile_scene(world, accel="dense")
    jset = jrt.CameraSettings(center=jnp.asarray([0.0, 2.0, 8.0]),
                              look_at=jnp.zeros(3), image_width=32,
                              max_depth=6, background=sky, rr_depth=2)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = "sky"
    return js, jset, ts, settings_from_numpy(d)


def test_box_motion_gradients_match_jax():
    """Boxes, motion, metal and dielectric end to end: the motion leaves
    (mv0, mv1), the box corners and the material params get gradients
    through K5's plain version and the reduction.  Few paths diverge in
    12 iterations of this scene, so each leaf is held to 1e-3 in the L2
    norm (measured at most 3.7e-5, on the dielectric's index)."""
    js, jset, ts, tset = _box_motion_pair()
    assert ts.prims.has_box and ts.prims.has_motion
    r, spp, n_iters = 2048, 4, 12
    pix = np.arange(r, dtype=np.int32) % (32 * 32)
    target = np.full((r, 3), 0.2, np.float32)

    def jloss(params, statics):
        img, done = jtrace(jcombine(params, statics), jset, jrng.base_key(1),
                           jnp.asarray(pix), spp, n_iters=n_iters,
                           remat=False, use_mega=True, mega_interpret=True)
        return jnp.mean((img - target) ** 2), jnp.mean(done / spp)

    (jl, jfrac), jg = jax.value_and_grad(jloss, has_aux=True)(
        *jpartition(js))
    params, statics = partition(ts)
    (tl, tfrac), tg = loss_and_grads(
        params, statics, tset, rng.base_key(1), torch.from_numpy(pix),
        torch.from_numpy(target), spp=spp, n_iters=n_iters, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(tfrac) == float(jfrac)
    jn, tn = grads_to_numpy(jg), grads_to_numpy(tg)
    for k in jn:
        scale = np.linalg.norm(jn[k])
        if scale == 0.0:
            assert not np.any(tn[k]), k
        else:
            assert np.linalg.norm(tn[k] - jn[k]) <= 1e-3 * scale, k
    for k in ("prims.mv1", "prims.p0", "prims.e1", "materials.param"):
        assert np.linalg.norm(jn[k]) > 0.0, k


def test_unported_diff_branches_raise(cornell):
    """The fused driver is the port's only differentiable path: the other
    branches, lights with rich textures (emission is in-kernel) and other
    devices raise, naming their ROADMAP item."""
    import raytrace_tpu_torch as trt
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel,
    )
    _, _, ts, tset = cornell
    params, statics = partition(ts)
    pix = torch.arange(128, dtype=torch.int32)
    target = torch.zeros((128, 3))
    args = (params, statics, tset, rng.base_key(0), pix, target, 2)
    for kw, item in ((dict(remat=True), "M6c"),
                     (dict(remat=False, rotate_k=2), "M6c"),
                     (dict(remat=False, skip_done=True), "M6c"),
                     (dict(remat=False, pixel_cost=pix), "M6c")):
        with pytest.raises(NotImplementedError, match=item):
            render_loss_wavefront(*args, **kw)
    from raytrace_tpu_torch.render.integrator import trace_wavefront_diff
    with pytest.raises(NotImplementedError, match="M11"):
        trace_wavefront_diff(ts, tset, rng.base_key(0), pix, 2, remat=False,
                             use_mega=False)
    marble = trt.compile_scene(trt.with_material(
        trt.light_source(trt.marble_texture([0, 0, 1], 2.0)),
        trt.sphere([0, 0, -2], 1)), device="cpu")
    with pytest.raises(NotImplementedError, match="M4"):
        render_loss_wavefront(*partition(marble), tset, rng.base_key(0),
                              pix, target, 2, remat=False)
    m = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bounce_bwd_regen_pre_megakernel(
            m, m, m, [m] * 27, m, (m, m, m), m, [m] * 7, [m] * 3, m,
            [m] * 13, n_targets=0, has_motion=False, has_box=False,
            t_min=1e-3, n_row=9, n_u=8, width=64, bg_kind=0)


def test_mesh_gradients_match_jax():
    """The mesh-scale fwd+bwd: on the mixed-kind mesh scene (832 rows,
    so the forward is kernel B's mesh variant, ``iter_plain(use_ap=True)``
    here and ``_iter_mega_ap`` in interpret mode in JAX) the loss and every
    gradient leaf against JAX's ``value_and_grad``.  1024 lanes, 2 spp, 6
    iterations: the loss to ``LOSS_RTOL``, the completed fraction exactly,
    each leaf in the L2 norm to 2% of its norm (the Cornell slice test's
    bound at 16 iterations; a path that resolves a shared edge
    differently moves a few gradients)."""
    import raytrace_tpu as jrt
    from raytrace_tpu.render.camera import sky as jsky
    from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap
    from raytrace_tpu_torch.testing import (
        mesh_all_kinds_scene, mesh_all_kinds_world,
    )
    ts, tset = mesh_all_kinds_scene(18, False, 32, device="cpu")
    tset = tset.replace(rr_depth=2)
    js = jrt.compile_scene(mesh_all_kinds_world(jrt, 18))
    jset = jrt.CameraSettings(center=jnp.asarray([0.0, 2.0, 8.0]),
                              look_at=jnp.zeros(3), image_width=32,
                              max_depth=6, background=jsky, rr_depth=2)
    r, spp, n_iters = 1024, 2, 6
    pix = np.arange(r, dtype=np.int32)
    target = np.full((r, 3), 0.1, np.float32)

    def jloss(params, statics):
        img, done = jtrace(jcombine(params, statics), jset, jrng.base_key(2),
                           jnp.asarray(pix), spp, n_iters=n_iters,
                           remat=False, use_mega=True, mega_interpret=True)
        return jnp.mean((img - target) ** 2), jnp.mean(done / spp)

    (jl, jfrac), jg = jax.value_and_grad(jloss, has_aux=True)(
        *jpartition(js))
    params, statics = partition(ts)
    m0 = iter_mega_ap.launches
    (tl, tfrac), tg = loss_and_grads(
        params, statics, tset, rng.base_key(2), torch.from_numpy(pix),
        torch.from_numpy(target), spp=spp, n_iters=n_iters, remat=False)
    assert iter_mega_ap.launches == m0               # CPU: plain version
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(tfrac) == float(jfrac)
    jn, tn = grads_to_numpy(jg), grads_to_numpy(tg)
    assert sorted(jn) == sorted(tn)
    for k in jn:
        scale = np.linalg.norm(jn[k])
        if scale == 0.0:
            assert not np.any(tn[k]), k
        else:
            assert np.linalg.norm(tn[k] - jn[k]) <= 0.02 * scale, k
    assert np.linalg.norm(jn["prims.p0"]) > 0.0
    assert np.linalg.norm(jn["textures.c0"]) > 0.0
