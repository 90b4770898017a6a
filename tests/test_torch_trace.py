"""The bounded-depth path against the JAX package's, on the CPU.

* threefry2x32 ``fold_in`` (``core/rng.py:fold_in``), and through it
  ``ray_keys``, ``fold_depth`` and ``site``, against ``jax.random``'s,
  bit for bit: 4,096 keys, data words up to 2^32 - 1 (above 2^31
  included), draw sites 0-9.
* ``camera.generate_rays`` (the key's draw site 0) against JAX's: the
  same uniforms bit for bit, origins and directions within 1e-5.
* ``integrator.trace``, forward (the Cornell box through kernel A's
  plain version, cornell_smoke through the split path, the marble-lit
  scene through the generic bounce) and differentiable (the generic
  bounce, fixed depth, each bounce checkpointed), and ``render_tile``
  (every sample of a tile traced as one batch), against JAX's
  ``trace``/``render_tile`` on the same rays and keys: 256 rays of the
  image (seeds from a numpy generator), depth 6.  Per-ray radiance: at
  most 3% of the rays differ by more than 1e-4 relative (XLA's CPU
  backend contracts multiply-adds, so a grazing hit or a Russian roulette
  draw next to its survival probability can resolve the other way on a
  path); light reaches over 10% of the rays.

``tests/test_torch_grad_render.py`` holds ``grad_render`` against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.gradients import render_tile as jrender_tile
from raytrace_tpu.render.camera import camera_frame as jframe
from raytrace_tpu.render.camera import generate_rays as jgen
from raytrace_tpu.render.integrator import trace as jtrace
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import render_tile
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.render.camera import camera_frame, generate_rays
from raytrace_tpu_torch.testing import (
    cornell_smoke_settings, cornell_smoke_world, fog_settings, fog_world,
    marble_light_settings, marble_light_world, torch_threads,
)
from __graft_entry__ import _cornell_scene_and_settings

N = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _kd(keys):
    return np.asarray(jax.random.key_data(keys)).view(np.int32)


def test_threefry_fold_in_site_and_ray_keys_match_jax():
    rg = np.random.default_rng(0)
    n = 4096
    pix = rg.integers(0, 1 << 31, n).astype(np.int32)
    smp = rg.integers(0, 1 << 31, n).astype(np.int32)
    for seed in (0, 7, 123456789):
        jk = jrng.ray_keys(jrng.base_key(seed), jnp.asarray(pix),
                           jnp.asarray(smp))
        tk = rng.ray_keys(rng.base_key(seed), torch.from_numpy(pix),
                          torch.from_numpy(smp))
        assert np.array_equal(_kd(jk), tk.numpy())
        for i in (0, 1, 7, 9):
            assert np.array_equal(_kd(jrng.site(jk, i)),
                                  rng.site(tk, i).numpy())
        assert np.array_equal(_kd(jrng.fold_depth(jk, 3)),
                              rng.fold_depth(tk, 3).numpy())
    # data words of every size, 2^31 and above included, per key
    data = np.concatenate([rg.integers(0, 1 << 32, n - 4, dtype=np.uint64),
                           [0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]]) \
        .astype(np.uint32)
    jk = jrng.ray_keys_fast(jrng.base_key(3), jnp.arange(n), jnp.arange(n))
    jout = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data))
    tout = rng.fold_in(torch.from_numpy(_kd(jk).copy()),
                       torch.from_numpy(data.astype(np.int64)))
    assert np.array_equal(_kd(jout), tout.numpy())


def _cornell(rt_name):
    if rt_name == "jax":
        return _cornell_scene_and_settings(16, 2, 6)
    from raytrace_tpu_torch.testing import cornell_scene_and_settings
    return cornell_scene_and_settings(16, 2, 6, device="cpu")


def _pair(name):
    """``(jax scene, jax settings, port scene, port settings)``."""
    if name == "cornell":
        return (*_cornell("jax"), *_cornell("torch"))
    world, sett = {"cornell_smoke": (cornell_smoke_world,
                                     cornell_smoke_settings),
                   "marble_light": (marble_light_world,
                                    marble_light_settings),
                   "fog": (fog_world, fog_settings)}[name]
    return (jrt.compile_scene(world(jrt)), sett(jrt, 16, 2, 6),
            trt.compile_scene(world(trt), device="cpu"), sett(trt, 16, 2, 6))


def _rays(js, jset, ts, tset, seed):
    rg = np.random.default_rng(seed)
    pix = rg.integers(0, 256, N).astype(np.int32)
    smp = rg.integers(0, 4, N).astype(np.int32)
    jk = jrng.ray_keys_fast(jrng.base_key(seed), jnp.asarray(pix),
                            jnp.asarray(smp))
    tk = rng.ray_keys_fast(rng.base_key(seed), torch.from_numpy(pix),
                           torch.from_numpy(smp))
    jr = jgen(jset, jframe(jset), jnp.asarray(pix), jk)
    tr = generate_rays(tset, camera_frame(tset), torch.from_numpy(pix), tk)
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    return jr, jrng.site(jk, 7), tr, rng.site(tk, 7)


def _close_rays(a, b, label):
    a, b = np.asarray(a), b.detach().numpy()
    assert np.all(np.isfinite(b)), label
    off = np.abs(a - b) > 1e-4 * (1.0 + np.abs(a))
    assert off.any(1).mean() <= 0.03, (label, off.any(1).mean())
    assert (a > 0).any(1).mean() > 0.1, label          # light reached


@pytest.mark.parametrize("name,route", [
    ("cornell", "bounce_mega_soa"), ("cornell_smoke", "bounce_split_soa"),
    ("marble_light", "bounce_generic_soa")])
def test_trace_forward_matches_jax(name, route):
    js, jset, ts, tset = _pair(name)
    (jo, jd, jt), jk, (o, d, t), tk = _rays(js, jset, ts, tset, 1)
    assert integrator._bounce_step(ts, tset, N)[0].__name__ == route
    jrad = jtrace(js, jset, jo, jd, jt, jk)
    trad = integrator.trace(ts, tset, o, d, t, tk)
    _close_rays(jrad, trad, name)
    assert float(trad.mean()) > 0.0


@pytest.mark.parametrize("name", ["cornell", "cornell_smoke"])
def test_trace_differentiable_and_render_tile_match_jax(name):
    js, jset, ts, tset = _pair(name)
    (jo, jd, jt), jk, (o, d, t), tk = _rays(js, jset, ts, tset, 2)
    jrad = jtrace(js, jset, jo, jd, jt, jk, differentiable=True)
    trad = integrator.trace(ts, tset, o, d, t, tk, differentiable=True)
    _close_rays(jrad, trad, name)
    pix = np.arange(0, 256, 4, dtype=np.int32)
    smp = np.arange(3, dtype=np.int32)
    jimg = jrender_tile(js, jset, jrng.base_key(5), jnp.asarray(pix),
                        jnp.asarray(smp))
    timg = render_tile(ts, tset, rng.base_key(5), torch.from_numpy(pix),
                       torch.from_numpy(smp))
    _close_rays(jimg, timg, name + " render_tile")
