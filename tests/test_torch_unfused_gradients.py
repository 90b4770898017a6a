"""The unfused differentiable wavefront against the JAX package's.

``render_loss_wavefront``'s loss and every gradient leaf against
``jax.value_and_grad`` of the same loss over the JAX package's
``trace_wavefront_diff(..., use_mega=True, mega_interpret=True)``: its
scan body around ``mega_bounce_diff_soa`` with kernel A forward and K7
backward in interpret mode (or, for tables of more than 64 rows, its
generic XLA replay backward).  The port runs kernel A's and K7's plain
versions on the CPU.  Cornell at 16 x 16, all 256 pixels as lanes, 8
spp, depth 6, RR from depth 2, a target of 0.1, ``base_key(0)``:

* ``rotate_k`` 2 and 4 (the rolled pixel maps at JAX's stride);
* ``rotate_k=4`` with ``pixel_cost``: the port's ``_antithetic_maps``
  equal JAX's on the same cost and each is a permutation, the port's
  ``lane_cost_estimate`` agrees with JAX's, and the balanced run's
  gradients match;
* ``skip_done`` at 21 iterations (samples left incomplete);
* ``remat=True`` on the fused route (``rotate_k=1``) and on the unfused
  one;
* a custom background at ``rotate_k=1`` (kernel B evaluates only the
  three shipped ones, so both packages take the unfused route), with and
  without a completion schedule;
* the 80-triangle scene of ``tests/test_mega_bounce_diff.py:111-121`` at
  ``rotate_k=2`` (81 rows: JAX's backward is its generic XLA replay with
  exact trig, the port's K7 with the polynomial one).

A spy counts the port's K7 calls (one per iteration on the unfused
route, none on the fused one).

Tolerances.  The JAX side runs as XLA programs whose CPU backend
contracts a*b+c into fused multiply-adds, so a grazing hit or a Russian
roulette draw next to its survival probability resolves differently on a
rare path (``tests/test_torch_gradients.py``).  The loss within
``LOSS_RTOL = 1e-4`` (measured at most 1e-5), the completed fraction
exactly, each gradient leaf within ``GRAD_RTOL = 5e-3`` of its norm in
the L2 norm (measured at most 1.2e-3, on the light's edge vectors
``prims.e2``, whose gradient few paths carry), and a leaf that JAX
gives exactly zero is zero here too.  The 80-triangle case as
``tests/test_mega_bounce_diff.py:74-75``: every gradient element within
rtol 2e-3, atol 2e-4 of JAX's (the trig difference touches only
sphere uvs, and the scene has no sphere; measured: within rtol 2e-3
alone but for 2e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.gradients import combine as jcombine
from raytrace_tpu.diff.gradients import partition as jpartition
from raytrace_tpu.render.integrator import _antithetic_maps as jmaps
from raytrace_tpu.render.integrator import lane_cost_estimate as jcost
from raytrace_tpu.render.integrator import trace_wavefront_diff as jtrace
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import loss_and_grads, partition
from raytrace_tpu_torch.interop import (
    fields_to_numpy, grads_to_numpy, scene_from_numpy, scene_to_numpy,
    settings_from_numpy,
)
from raytrace_tpu_torch.ops import bounce_bwd_kernel
from raytrace_tpu_torch.render.integrator import (
    _antithetic_maps, lane_cost_estimate,
)
from raytrace_tpu_torch.testing import torch_threads

R = 256
SPP = 8
N_ITERS = 30
LOSS_RTOL = 1e-4
GRAD_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _port_settings(jset, background):
    d = fields_to_numpy(jset)
    d["background"] = background
    return settings_from_numpy(d)


@pytest.fixture(scope="module")
def cornell():
    js, jset = _cornell_scene_and_settings(16, SPP, 6)
    jset = jset.replace(rr_depth=2)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    return js, jset, ts, _port_settings(jset, ("const", (0.0, 0.0, 0.0)))


@pytest.fixture
def k7_calls(monkeypatch):
    calls = []
    plain = bounce_bwd_kernel.bounce_bwd_megakernel_plain

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    monkeypatch.setattr(bounce_bwd_kernel, "bounce_bwd_megakernel_plain",
                        spy)
    return calls


def _compare(js, jset, ts, tset, spp=SPP, target=0.1, elementwise=False,
             **kw):
    """Run both packages' loss and gradients with the options ``kw``;
    check them; return JAX's completed fraction."""
    pix = np.arange(R, dtype=np.int32)
    tgt = np.full((R, 3), target, np.float32)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
               else v) for k, v in kw.items()}

    def jloss(params, statics):
        img, done = jtrace(jcombine(params, statics), jset, jrng.base_key(0),
                           jnp.asarray(pix), spp, use_mega=True,
                           mega_interpret=True, **jkw)
        return jnp.mean((img - tgt) ** 2), jnp.mean(done / spp)

    (jl, jf), jg = jax.value_and_grad(jloss, has_aux=True)(
        *jpartition(js))
    (tl, tf), tg = loss_and_grads(
        *partition(ts), tset, rng.base_key(0), torch.from_numpy(pix),
        torch.from_numpy(tgt), spp=spp, **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(tf) == float(jf)
    jn, tn = grads_to_numpy(jg), grads_to_numpy(tg)
    assert sorted(jn) == sorted(tn)
    for k in jn:
        assert tn[k].shape == jn[k].shape and np.all(np.isfinite(tn[k])), k
        if elementwise:
            np.testing.assert_allclose(tn[k], jn[k], rtol=2e-3, atol=2e-4,
                                       err_msg=k)
            continue
        scale = np.linalg.norm(jn[k])
        if scale == 0.0:
            assert not np.any(tn[k]), k
        else:
            assert np.linalg.norm(tn[k] - jn[k]) <= GRAD_RTOL * scale, k
    assert np.linalg.norm(jn["textures.c0"]) > 0.0
    return float(jf)


@pytest.mark.parametrize("rotate_k", [2, 4])
def test_rotated_matches_jax(cornell, k7_calls, rotate_k):
    frac = _compare(*cornell, n_iters=N_ITERS, remat=False,
                    rotate_k=rotate_k)
    assert len(k7_calls) == N_ITERS
    assert frac > 0.99


def test_balanced_maps_and_gradients_match_jax(cornell, k7_calls):
    js, jset, ts, tset = cornell
    pix = np.arange(R, dtype=np.int32)
    jc = np.asarray(jcost(js, jset, jrng.base_key(0), jnp.asarray(pix),
                          spp_est=2))
    tc = lane_cost_estimate(ts, tset, rng.base_key(0), torch.from_numpy(pix),
                            spp_est=2).numpy()
    assert tc.shape == (R,) and tc.min() >= 2.0
    # the cost's paths follow the same draws; XLA's contracted
    # multiply-adds may end a rare path at another bounce
    assert (tc == jc).mean() >= 0.98
    cost = torch.from_numpy(jc.copy())
    maps = _antithetic_maps(cost, 4)
    for m, jm in zip(maps, jmaps(jnp.asarray(jc), 4)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(np.sort(m.numpy()), np.arange(R))
    frac = _compare(*cornell, n_iters=N_ITERS, remat=False, rotate_k=4,
                    pixel_cost=cost)
    assert len(k7_calls) == N_ITERS
    assert frac > 0.99


def test_skip_done_incomplete_matches_jax(cornell, k7_calls):
    frac = _compare(*cornell, n_iters=21, remat=False, skip_done=True)
    assert len(k7_calls) == 21
    assert frac < 1.0


@pytest.mark.parametrize("rotate_k", [1, 2])
def test_remat_matches_jax(cornell, k7_calls, rotate_k):
    _compare(*cornell, n_iters=N_ITERS, remat=True, rotate_k=rotate_k)
    # the fused route takes K5; the unfused one checkpoints its
    # iterations (kernel A runs again in the backward), K7 once each
    assert len(k7_calls) == (0 if rotate_k == 1 else N_ITERS)


@pytest.mark.parametrize("schedule", [None, ((12, 128),)])
def test_custom_background_matches_jax(cornell, k7_calls, schedule):
    js, jset, ts, tset = cornell
    jset = jset.replace(background=lambda o, d: 0.25 + 0.25 * d)
    tset = tset.replace(background=lambda o, d: 0.25 + 0.25 * d)
    n_iters = N_ITERS - 12 if schedule else N_ITERS
    _compare(js, jset, ts, tset, n_iters=n_iters, remat=False,
             schedule=schedule)
    assert len(k7_calls) == N_ITERS


def test_triangle_scene_matches_jax_generic_replay(k7_calls):
    import raytrace_tpu as jrt
    rs = np.random.RandomState(3)
    p0 = rs.uniform(-2, 2, (80, 3))
    tris = [jrt.triangle(p, p + [0.3, 0, 0], p + [0, 0.3, 0]) for p in p0]
    world = jrt.group([
        jrt.with_material(jrt.lambertian(jrt.constant_texture(0.6)),
                          jrt.group(tris)),
        jrt.with_material(jrt.light_source(jrt.constant_texture(3.0)),
                          jrt.parallelogram([-3, 4, -3], [6, 0, 0],
                                            [0, 0, 6])),
    ])
    js = jrt.compile_scene(world, accel="dense")
    assert js.prims.kind.shape[0] > 64         # JAX's generic replay
    jset = jrt.CameraSettings(image_width=16, samples_per_pixel=4,
                              max_depth=4, center=np.asarray([0., 0., 6.]),
                              look_at=np.zeros(3), vfov=0.9,
                              background=jrt.const_background(0.3))
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    tset = _port_settings(jset, ("const", (0.3, 0.3, 0.3)))
    _compare(js, jset, ts, tset, spp=4, target=0.0, elementwise=True,
             n_iters=16, remat=False, rotate_k=2)
    assert len(k7_calls) == 16
