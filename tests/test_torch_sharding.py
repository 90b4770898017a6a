"""The port's sharding (``raytrace_tpu_torch/parallel/sharding.py``) against
the JAX package's (``raytrace_tpu/parallel/sharding.py``) on the CPU.

The port's ranks are spawned processes in one gloo group (1, 2 and 4 of
them, ``testing.run_ranks``); JAX's reference runs on one device.  The
scene is ``tests/test_sharding.py``'s at 24 x 24, depth 4.

* ``sharded_render_fn`` (pixels over dp, samples over sp) on the default
  mesh and on the other mesh shapes, and ``sharded_wavefront_render_fn``
  (a pixel block a rank, 4 spp), against JAX's single-device
  ``render_tile`` and ``trace_wavefront_stationary``, and the sorted
  dispatch with its threshold lowered against JAX's
  ``trace_wavefront_sorted``: within atol 2e-5, rtol 1e-5
  (``tests/test_sharding.py``), every rank holding the same image, and
  the wavefront's images of the three world sizes equal within the same
  bound (the RNG is keyed on absolute (pixel, sample) ids; only the order
  of float sums differs).
* The train step at one rank against JAX's ``sharded_train_step_fn`` on a
  1-device mesh: one step with ``optax.sgd`` against ``torch.optim.SGD``
  and one with ``optax.adam`` against ``torch.optim.Adam`` (the same lr,
  b1, b2, eps): the loss within ``GRAD_RTOL`` relative, each leaf's
  update within ``GRAD_RTOL`` of the largest update of that leaf (SGD:
  the gradient's bound) or, for Adam, within ``GRAD_RTOL * lr`` where
  the port's gradient entry is over ``ADAM_G_MIN`` (Adam's first update is
  ``lr * g / (|g| + eps)``, so an entry whose gradient is a rounding
  error of zero moves by up to lr either way in both packages).
* 12 Adam steps descend and move the perturbed albedo back
  (``tests/test_sharding.py:71-101``); the step refuses a schedule and
  blocks that are not whole multiples of 128 lanes; the entry points run;
  ``multihost.initialize`` stays local with no job and raises when an
  explicit join fails.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.gradients import render_tile as jrender_tile
from raytrace_tpu.parallel.sharding import make_mesh as jmake_mesh
from raytrace_tpu.parallel.sharding import (
    sharded_train_step_fn as jtrain_step,
)
from raytrace_tpu.render.integrator import (
    trace_wavefront_sorted as jsorted, trace_wavefront_stationary as jwave,
)
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import leaves
from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from raytrace_tpu_torch.parallel import multihost
from raytrace_tpu_torch.parallel.sharding import (
    make_mesh, sharded_render_fn, sharded_train_step_fn,
)
from raytrace_tpu_torch.render.integrator import LANE_ALIGN
from raytrace_tpu_torch.testing import (
    SHARDED, free_port, many_spheres_world, run_ranks, sharded_forward_cases,
    sharding_settings, sharding_world, torch_threads,
)

ATOL, RTOL = 2e-5, 1e-5
GRAD_RTOL = 1e-3
WORLDS = (1, 2, 4)
LR = 0.02
# Adam: gradient entries below this are rounding errors of zero
ADAM_G_MIN = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def jax_ref():
    s = sharding_settings(jrt)
    js = jrt.compile_scene(sharding_world(jrt))
    n_pix = s.image_width * s.image_height
    spp = SHARDED["wave_spp"]
    many = jrt.compile_scene(many_spheres_world(jrt))
    return {
        "tile": np.asarray(jrender_tile(
            js, s, jrng.base_key(SHARDED["tile_seed"]),
            jnp.arange(n_pix, dtype=jnp.int32),
            jnp.arange(s.samples_per_pixel, dtype=jnp.int32))),
        "wavefront": np.asarray(jwave(js, s, jrng.base_key(
            SHARDED["wave_seed"]), n_pix, spp)),
        "sorted": np.asarray(jsorted(many, s, jrng.base_key(
            SHARDED["sorted_seed"]), n_pix, spp)),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{world: [each rank's sharded_forward_cases()]}``."""
    return {w: run_ranks(sharded_forward_cases, w,
                         tmp_path_factory.mktemp(f"world{w}"))
            for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes(worlds, world):
    assert [r["mesh_shape"] for r in worlds[world]] == [
        {1: (1, 1), 2: (1, 2), 4: (2, 2)}[world]] * world


def test_mesh_without_process_group():
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
    assert make_mesh(1, sp=1).shape == (1, 1)
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(2)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["tile", "wavefront", "sorted"])
def test_sharded_matches_jax_single_device(worlds, jax_ref, world, case):
    ranks = worlds[world]
    for r in ranks:
        np.testing.assert_array_equal(r[case], ranks[0][case])
    np.testing.assert_allclose(ranks[0][case], jax_ref[case], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_invariant_to_mesh_shape(worlds, world):
    r0 = worlds[world][0]
    others = [k for k in r0 if k.startswith("tile sp=")]
    assert len(others) == {1: 0, 2: 1, 4: 2}[world]
    for k in others:
        np.testing.assert_allclose(r0[k], r0["tile"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_sharded_wavefront_equal_across_worlds(worlds, world):
    np.testing.assert_allclose(worlds[world][0]["wavefront"],
                               worlds[1][0]["wavefront"], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_wavefront_takes_sorted_driver(worlds, world):
    # every rank whose block holds pixels of the image runs the sorted
    # driver once (at 4 ranks the blocks are 256 pixels: the last is
    # empty)
    block = -(-576 // (world * LANE_ALIGN)) * LANE_ALIGN
    assert [r["sorted_calls"] for r in worlds[world]] == [
        int(r * block < 576) for r in range(world)]


def _train_pair():
    s_t = sharding_settings(trt, 16)
    s_j = sharding_settings(jrt, 16)
    js = jrt.compile_scene(sharding_world(jrt))
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    return js, s_j, ts, s_t


def _field(tree, name):
    for part in name.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_matches_jax(opt):
    js, s_j, ts, s_t = _train_pair()
    pix = np.arange(256, dtype=np.int32)
    samp = np.arange(8, dtype=np.int32)
    target = np.full((256, 3), 0.1, np.float32)
    jopt = optax.sgd(LR) if opt == "sgd" else optax.adam(LR)
    topt = ((lambda ps: torch.optim.SGD(ps, lr=LR)) if opt == "sgd" else
            (lambda ps: torch.optim.Adam(ps, lr=LR, betas=(0.9, 0.999),
                                         eps=1e-8)))
    jstep = jtrain_step(jmake_mesh(1), s_j, optimizer=jopt)
    jl, js2 = jstep(js, jrng.base_key(0), jnp.asarray(pix), jnp.asarray(samp),
                    jnp.asarray(target))
    tstep = sharded_train_step_fn(make_mesh(), s_t, optimizer=topt)
    tl, ts2 = tstep(ts, rng.base_key(0), torch.from_numpy(pix),
                    torch.from_numpy(samp), torch.from_numpy(target))
    assert abs(float(tl) - float(jl)) <= GRAD_RTOL * abs(float(jl))
    _, grads = tstep.loss_and_grads(ts, rng.base_key(0),
                                    torch.from_numpy(pix),
                                    torch.from_numpy(samp),
                                    torch.from_numpy(target))
    g_t = leaves(grads)
    moved = 0
    for name, new in leaves(ts2).items():
        if not new.is_floating_point():
            continue
        old = _field(js, name)
        du_j = _field(js2, name) - old
        du_t = new.numpy() - old
        if opt == "sgd":
            bound = GRAD_RTOL * max(np.abs(du_j).max(), 1e-30)
            assert np.abs(du_t - du_j).max() <= bound, name
        else:
            real = np.abs(g_t[name].numpy()) > ADAM_G_MIN
            assert (np.abs(du_t - du_j)[real] <= GRAD_RTOL * LR).all(), name
        moved += int((du_t != 0).sum())
    assert moved > 0


def test_train_step_descends():
    js, s_j, ts, s_t = _train_pair()
    pix = torch.arange(256, dtype=torch.int32)
    samp = torch.arange(8, dtype=torch.int32)
    key = rng.base_key(0)
    mesh = make_mesh()
    target = sharded_render_fn(mesh)(ts, s_t, key, pix, samp)
    c0 = ts.textures.c0.clone()
    c0[0] += 0.2
    perturbed = dataclasses.replace(
        ts, textures=dataclasses.replace(ts.textures, c0=c0))
    step = sharded_train_step_fn(
        mesh, s_t, optimizer=lambda ps: torch.optim.Adam(ps, lr=0.02))
    losses, sc = [], perturbed
    state = step.init(sc)
    for _ in range(12):
        loss, sc, state = step.with_state(sc, state, key, pix, samp, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert min(losses[1:]) < losses[0]
    d0 = float((perturbed.textures.c0[0] - ts.textures.c0[0]).abs().sum())
    d1 = float((sc.textures.c0[0] - ts.textures.c0[0]).abs().sum())
    assert d1 < d0
    # the caller's scene is not changed in place
    assert torch.equal(perturbed.textures.c0, c0)


def test_train_step_refuses_schedule_and_misaligned_blocks():
    _, _, ts, s_t = _train_pair()
    with pytest.raises(ValueError, match="schedule"):
        sharded_train_step_fn(make_mesh(), s_t,
                              schedule=((25, 1 << 14),))
    step = sharded_train_step_fn(make_mesh(), s_t)
    with pytest.raises(ValueError, match="200 pixels over 1 ranks"):
        step(ts, rng.base_key(0), torch.arange(200), torch.arange(8),
             torch.zeros((200, 3)))


def test_entry_points():
    from raytrace_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == (256, 3) and torch.isfinite(out).all()
    loss, moved = dryrun_multichip(1, device="cpu")
    assert np.isfinite(loss) and moved > 0
    with pytest.raises(ValueError):
        dryrun_multichip(2, device="cpu")


def test_initialize_single_process_and_failed_join(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.initialize()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(num_processes=2, device="cpu")
    port = free_port()
    # rank 1 of 2 with no rank 0 serving the rendezvous: raises, stays
    # uninitialized
    with pytest.raises((RuntimeError, TimeoutError)):
        multihost.initialize(f"localhost:{port}", 2, 1, device="cpu",
                             timeout_s=3.0)
    assert not torch.distributed.is_initialized()
