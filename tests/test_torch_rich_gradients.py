"""The differentiable path with rich textures against the JAX package's.

``render_loss_wavefront``'s value and gradient (kernel B's, K5's and the
atlas gradient's plain versions on the CPU, with the deferred albedo
multiply ``fused_iter.apply_rich`` after every step) against
``jax.value_and_grad`` of the same loss over ``trace_wavefront_diff(...,
use_mega=True, mega_interpret=True)``, on 1024 lanes:

* the image + noise scene of ``tests/test_fused_iter.py:_rich_scene``
  (the general ``eval_texture`` branch: atlas, noise colours, frequency
  and shift all get gradients);
* the image-only scene of ``test_fused_iter_image_only_soa_path_matches``
  (the image-only branch: every lane off the atlas fetches texel (0, 0)
  with a zero cotangent);
* a marble-textured height-field mesh of 650 rows
  (``test_fused_iter_ap_stage_rich_mesh_gradients``): the forward is
  kernel B's mesh variant (``iter_plain(use_ap=True)`` here).

Tolerances, as ``tests/test_torch_gradients.py``: the loss within
``LOSS_RTOL`` = 1e-3, the completed fraction exactly, each gradient leaf
in the L2 norm within ``GRAD_RTOL`` = 2% of its norm (XLA's CPU backend
contracts multiply-adds into FMAs, so a few paths could resolve an edge
differently; measured at most 2.5e-5, loss within 4e-7), and leaves JAX
gives exactly zero are zero here.  Then a central finite difference of one atlas texel and of a
noise colour against their gradients (exact estimator, the same seed:
the paths do not depend on an albedo), within 2%.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.gradients import combine as jcombine
from raytrace_tpu.diff.gradients import partition as jpartition
from raytrace_tpu.render.integrator import trace_wavefront_diff as jtrace
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import (
    finite_difference, loss_and_grads, partition, render_loss_wavefront,
)
from raytrace_tpu_torch.interop import grads_to_numpy
from raytrace_tpu_torch.ops.image_grad_kernel import image_grad_pallas

R = 1024
LOSS_RTOL = 1e-3
GRAD_RTOL = 0.02


def rich_world(rt):
    """``tests/test_fused_iter.py:_rich_scene``: an image on a
    parallelogram, a noise ground sphere, a light."""
    img = np.linspace(0.1, 0.9, 8 * 16 * 3).astype(np.float32).reshape(
        8, 16, 3)
    return rt.group([
        rt.with_material(rt.lambertian(rt.image_texture(img)),
                         rt.parallelogram([-2, -1, -4], [4, 0, 0],
                                          [0, 2, 0])),
        rt.with_material(rt.lambertian(
            rt.noise_texture(2, 4.0, [0, 0, 0], [0.1, 0.1, 0.4],
                             [0.9, 0.9, 1.0])),
            rt.sphere([0, -51, -4], 50.0)),
        rt.with_material(rt.light_source(rt.constant_texture(3.0)),
                         rt.parallelogram([-2, 4, -5], [4, 0, 0],
                                          [0, 0, 4])),
    ])


def image_only_world(rt):
    img = (np.arange(4 * 8 * 3, dtype=np.float32) % 7 / 7.0).reshape(4, 8, 3)
    return rt.group([
        rt.with_material(rt.lambertian(rt.image_texture(img)),
                         rt.parallelogram([-2, -1, -4], [4, 0, 0],
                                          [0, 2, 0])),
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                         rt.parallelogram([-9, -1, -9], [18, 0, 0],
                                          [0, 0, 18])),
        rt.with_material(rt.light_source(rt.constant_texture(3.0)),
                         rt.parallelogram([-2, 4, -5], [4, 0, 0],
                                          [0, 0, 4])),
    ])


def marble_mesh_world(rt):
    """``test_fused_iter_ap_stage_rich_mesh_gradients``' marble mesh: a
    648-triangle height field under a light."""
    n_grid = 18
    xs = np.linspace(-3, 3, n_grid + 1)
    xx, zz = np.meshgrid(xs, xs, indexing="ij")
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
    return rt.group([
        rt.with_material(rt.lambertian(rt.marble_texture([0.0, 0.0, 1.0],
                                                         2.0)),
                         rt.triangle_mesh(mesh)),
        rt.with_material(rt.light_source(
            rt.constant_texture([4.0, 3.0, 2.0])),
            rt.parallelogram([-1, 4, -1], [2, 0, 0], [0, 0, 2])),
    ])


def _settings(rt, case, xp):
    if case == "marble_mesh":
        return rt.CameraSettings(center=xp([0.0, 2.5, 6.0]),
                                 look_at=xp([0.0, 0.0, 0.0]), vfov=0.9,
                                 image_width=64, samples_per_pixel=4,
                                 max_depth=4,
                                 background=rt.const_background(0.3))
    return rt.CameraSettings(image_width=64, samples_per_pixel=4,
                             max_depth=6, background=rt.const_background(0.2))


_WORLDS = {"image_noise": rich_world, "image_only": image_only_world,
           "marble_mesh": marble_mesh_world}


def _pair(case):
    world = _WORLDS[case]
    js = jrt.compile_scene(world(jrt))
    ts = trt.compile_scene(world(trt), device="cpu")
    return (js, _settings(jrt, case, jnp.asarray), ts,
            _settings(trt, case, list))


@pytest.mark.parametrize("case", ["image_noise", "image_only",
                                  "marble_mesh"])
def test_rich_loss_and_gradients_match_jax(case):
    js, jset, ts, tset = _pair(case)
    spp, n_iters = 4, 16
    pix = np.arange(R, dtype=np.int32) * 4
    target = np.full((R, 3), 0.2, np.float32)

    def jloss(params, statics):
        img, done = jtrace(jcombine(params, statics), jset, jrng.base_key(0),
                           jnp.asarray(pix), spp, n_iters=n_iters,
                           remat=False, use_mega=True, mega_interpret=True)
        return jnp.mean((img - target) ** 2), jnp.mean(done / spp)

    (jl, jfrac), jg = jax.value_and_grad(jloss, has_aux=True)(
        *jpartition(js))
    params, statics = partition(ts)
    k0 = image_grad_pallas.launches
    (tl, tfrac), tg = loss_and_grads(
        params, statics, tset, rng.base_key(0), torch.from_numpy(pix),
        torch.from_numpy(target), spp=spp, n_iters=n_iters, remat=False)
    assert image_grad_pallas.launches == k0          # CPU: plain version
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(tfrac) == float(jfrac)
    jn, tn = grads_to_numpy(jg), grads_to_numpy(tg)
    assert sorted(jn) == sorted(tn)
    for k in jn:
        assert np.all(np.isfinite(tn[k])), k
        scale = np.linalg.norm(jn[k])
        if scale == 0.0:
            assert not np.any(tn[k]), k
        else:
            assert np.linalg.norm(tn[k] - jn[k]) <= GRAD_RTOL * scale, k
    reached = {"image_noise": ("textures.images", "textures.c0",
                               "textures.c1", "textures.f0"),
               "image_only": ("textures.images", "textures.c0"),
               "marble_mesh": ("textures.f0", "prims.p0")}[case]
    for k in reached:
        assert np.linalg.norm(jn[k]) > 0.0, k


def test_rich_gradients_match_finite_differences():
    """An atlas texel and the noise ground's second colour: the gradient
    within 2% of the central difference (exact estimator)."""
    _, _, ts, tset = _pair("image_noise")
    pix = torch.arange(R, dtype=torch.int32) * 4
    target = torch.full((R, 3), 0.1)
    kw = dict(spp=2, n_iters=20, remat=False)
    params, statics = partition(ts)
    _, g = loss_and_grads(params, statics, tset, rng.base_key(3), pix,
                          target, **kw)
    tx = ts.textures
    gi = g.textures.images[0, :, :, 1].abs()
    texel = np.unravel_index(int(torch.argmax(gi)), gi.shape)
    noise = int(torch.nonzero(tx.kind == 3)[0, 0])
    # the loss is quadratic in an albedo under the exact estimator: wide
    # steps lift the change above the f32 rounding of the loss
    cases = (("images", (0, *texel, 1), 0.25),
             ("c1", (noise, 2), 0.1))
    for field, idx, eps in cases:
        def f(x, field=field, idx=idx):
            v = getattr(tx, field).clone()
            v[idx] = x[0]
            sc = dataclasses.replace(
                ts, textures=dataclasses.replace(tx, **{field: v}))
            with torch.no_grad():
                return render_loss_wavefront(*partition(sc), tset,
                                             rng.base_key(3), pix, target,
                                             **kw)[0]
        x0 = getattr(tx, field)[idx].reshape(1).clone()
        fd = float(finite_difference(f, x0, eps=eps)[0])
        gv = float(getattr(g.textures, field)[idx])
        assert abs(gv) > 1e-6, field
        np.testing.assert_allclose(gv, fd, rtol=0.02, err_msg=field)
