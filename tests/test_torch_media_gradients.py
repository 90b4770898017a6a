"""Gradients of scenes with constant-density media, on the CPU.

* ``loss_and_grads`` on cornell_smoke (16 x 16, every pixel a lane, 2
  spp, depth 5, Russian roulette from depth 2, 14 iterations, a target of
  0.1, ``base_key(0)``): the unfused driver's generic differentiable
  bounce (the fused step refuses media, as the JAX package's does),
  against ``jax.value_and_grad`` of the JAX package's
  ``render_loss_wavefront``: the loss within rtol 1e-4, the completed
  fraction exactly, every gradient leaf (the surfaces, textures, the
  media's ``volumes.density`` and boundary rows ``volumes.prims``) within
  1e-3 of its norm in the L2 norm (measured under 1e-6: the same
  estimator and draws, the forward through the kernels' plain versions).
* The JAX package's four fog tests (``tests/test_gradients.py:393-470``)
  on the port's ``render_tile(differentiable=True)`` (``trace`` over the
  generic bounce), with their tolerances: d(mean radiance)/d(density) by
  the score-function weight, averaged over 4 seeds, against a central
  difference at +-0.15 over 6 other seeds (both below -0.05, rtol 0.35);
  the render's value bit-identical with the density detached (the weight
  is exactly 1); the medium albedo's gradient against a same-seed central
  difference (rtol 0.05); finite gradients of every leaf, the boundary
  sphere's included.
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
from raytrace_tpu.diff.gradients import partition as jpartition
from raytrace_tpu.diff.gradients import render_loss_wavefront as jloss
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import (
    combine, leaves, loss_and_grads, partition, render_tile,
)
from raytrace_tpu_torch.interop import grads_to_numpy
from raytrace_tpu_torch.testing import (
    cornell_smoke_settings, cornell_smoke_world, fog_settings, fog_world,
    torch_threads,
)

W = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_cornell_smoke_gradients_match_jax():
    ts = trt.compile_scene(cornell_smoke_world(trt), device="cpu")
    js = jrt.compile_scene(cornell_smoke_world(jrt))
    s_t = cornell_smoke_settings(trt, W, 2, 5).replace(rr_depth=2)
    s_j = cornell_smoke_settings(jrt, W, 2, 5).replace(rr_depth=2)
    pix = np.arange(W * W, dtype=np.int32)
    target = np.full((W * W, 3), 0.1, np.float32)
    jp, jst = jpartition(js)
    (jl, jfrac), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, jst, s_j, jrng.base_key(0), jnp.asarray(pix),
        jnp.asarray(target), 2, n_iters=14)
    (tl, tfrac), tg = loss_and_grads(
        *partition(ts), s_t, rng.base_key(0), torch.from_numpy(pix),
        torch.from_numpy(target), 2, n_iters=14)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert float(tfrac) == float(jfrac)
    a, b = grads_to_numpy(jg), grads_to_numpy(tg)
    assert set(a) == set(b)
    assert np.abs(a["volumes.density"]).max() > 0
    for k in a:
        assert np.all(np.isfinite(b[k])), k
        if not np.any(a[k]):
            assert not np.any(b[k]), k
        assert np.linalg.norm(a[k] - b[k]) <= 1e-3 * np.linalg.norm(a[k]), k


def _fog():
    return (trt.compile_scene(fog_world(trt), device="cpu"),
            fog_settings(trt))


def _fog_mean(scene, s, seed, spp=8):
    pix = torch.arange(256, dtype=torch.int32)
    img = render_tile(scene, s, rng.base_key(seed), pix,
                      torch.arange(spp, dtype=torch.int32),
                      differentiable=True)
    return torch.mean(img)


def _with_density(params, statics, dens):
    vol = dataclasses.replace(params.volumes, density=dens)
    return combine(dataclasses.replace(params, volumes=vol), statics)


def test_fog_density_gradient_matches_fd():
    scene, s = _fog()
    params, statics = partition(scene)
    gs = []
    for seed in range(4):
        d0 = torch.tensor([0.8], requires_grad=True)
        f = _fog_mean(_with_density(params, statics, d0), s, seed)
        gs.append(float(torch.autograd.grad(f, d0)[0][0]))
    g_ad = float(np.mean(gs))
    eps = 0.15
    with torch.no_grad():
        fd = lambda dens: np.mean([float(_fog_mean(_with_density(
            params, statics, torch.tensor([dens])), s, seed))
            for seed in range(4, 10)])
        g_fd = (fd(0.8 + eps) - fd(0.8 - eps)) / (2 * eps)
    # denser fog blocks more of the light: both clearly negative
    assert g_ad < -0.05 and g_fd < -0.05, (g_ad, g_fd)
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.35)


def test_fog_density_weight_leaves_the_value_unchanged():
    scene, s = _fog()
    params, statics = partition(scene)
    d0 = torch.tensor([0.8], requires_grad=True)
    v0 = float(_fog_mean(_with_density(params, statics, d0), s, 0).detach())
    v1 = float(_fog_mean(_with_density(params, statics, d0.detach()), s,
                         0).detach())
    assert v0 == v1


def test_fog_albedo_gradient_matches_fd():
    scene, s = _fog()
    row = int(scene.materials.tex[int(scene.volumes.mat[0])])

    def f(a):
        c0 = scene.textures.c0.clone()
        c0 = torch.where(torch.arange(c0.shape[0])[:, None] == row, a, c0)
        tx = dataclasses.replace(scene.textures, c0=c0)
        return _fog_mean(dataclasses.replace(scene, textures=tx), s, 0)

    a0 = torch.tensor(0.3, requires_grad=True)
    g_auto = float(torch.autograd.grad(f(a0), a0)[0])
    eps = 1e-2
    with torch.no_grad():
        g_fd = (float(f(torch.tensor(0.3 + eps)))
                - float(f(torch.tensor(0.3 - eps)))) / (2 * eps)
    assert np.isfinite(g_auto) and g_auto > 0.0
    np.testing.assert_allclose(g_auto, g_fd, rtol=0.05)


def test_fog_boundary_geometry_gradient_finite():
    scene, s = _fog()
    params, statics = partition(scene)
    f = _fog_mean(combine(params, statics), s, 0)
    named = {k: v for k, v in leaves(params).items() if v.requires_grad}
    gs = torch.autograd.grad(f, list(named.values()), allow_unused=True)
    for k, g in zip(named, gs):
        assert g is None or bool(torch.isfinite(g).all()), k
    gb = gs[list(named).index("volumes.prims.p0")]
    assert gb is not None and bool(torch.isfinite(gb).all())
