"""The mesh-scale forward against the JAX package.

* Kernel B's mesh variant: ``fused_iter_fwd_step`` of each package on
  the mixed-kind mesh scene (832 rows, over 512, so both take the mesh
  variant: the port's ``iter_plain(use_ap=True)`` on the CPU, the JAX
  package's ``iter_megakernel(use_ap=True, interpret=True)``, i.e.
  ``_iter_mega_ap``), with Russian roulette from depth 2: one iteration
  from a random mid-render state, lane by lane, and 6 iterations from a
  fresh state in the mean.
* The split forward: ``render_accumulate`` (the work-queue driver at
  32 x 32, 4 spp) and ``trace_wavefront_stationary`` (2 spp, rotate_k 2)
  of each package on the same scene; the port takes the split path (nearest-hit
  and shade wrappers, never kernel A), the JAX package its XLA bounce.

Tolerances.  XLA's CPU backend contracts multiply-adds, so an edge or a
grazing hit can resolve to the other primitive (the height field's
triangles share edges): sample, depth, alive, died and winner index
agree on all but ``FRAC_INT`` of the lanes in one iteration, and floats
within atol 2e-3 + rtol 1e-3 on the lanes that agree
(tests/test_bounce_kernel.py).  Over 6 iterations the summed radiance
agrees in mean to ``MEAN_RTOL``.  Images: PR 1's bounds
(tests/test_torch_render.py): the mean within rtol 2e-3, the median pixel
to f32 rounding, the share of pixels that differ by more than 1e-5
below 5%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.fused_iter import fused_iter_fwd_step as jstep_fn
from raytrace_tpu.render import integrator as jint
from raytrace_tpu.render.camera import sky as jsky
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.core import rng as trng
from raytrace_tpu_torch.diff.fused_iter import (
    fused_iter_fwd_step as tstep_fn,
)
from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap, iter_megakernel
from raytrace_tpu_torch.render import integrator as tint
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.testing import (
    fresh_carry, iter_state, mesh_all_kinds_scene, mesh_all_kinds_world,
)

R = 1024
N_PIX = 32 * 32
FRAC_INT = 0.01
MEAN_RTOL = 2e-3


@pytest.fixture(scope="module")
def scenes():
    ts, tset = mesh_all_kinds_scene(18, False, 32, device="cpu")
    js = jrt.compile_scene(mesh_all_kinds_world(jrt, 18))
    jset = jrt.CameraSettings(center=jnp.asarray([0.0, 2.0, 8.0]),
                              look_at=jnp.zeros(3), image_width=32,
                              max_depth=6, background=jsky)
    return js, jset, ts, tset


def _to_jax(pix, carry):
    g = R // 128
    return (jnp.asarray(pix.numpy().reshape(g, 128)),
            tuple(jnp.asarray(c.numpy().reshape(g, 128)) for c in carry))


def _flat(xs):
    return [np.asarray(x).reshape(R) for x in xs]


def test_mesh_iteration_matches_jax(scenes):
    js, jset, ts, tset = scenes
    jset, tset = jset.replace(rr_depth=2), tset.replace(rr_depth=2)
    assert ts.prims.kind.shape[0] > 512 and ts.prims.kind_segments
    jstep = jstep_fn(js, jset, jrng.base_key(4), 8, 0, interpret=True)
    tstep = tstep_fn(ts, tset, trng.base_key(4), 8, 0)
    pix, carry = iter_state(R, N_PIX, 2, "cpu", box=(-3.0, 3.0))
    b0, m0 = iter_megakernel.launches, iter_mega_ap.launches
    tcar, trad, tdied = tstep(pix, carry)
    assert (iter_megakernel.launches, iter_mega_ap.launches) == (b0, m0)
    jcar, jrad, jdied = jstep(*_to_jax(pix, carry))
    jcar, jrad, jdied = _flat(jcar), _flat(jrad), _flat([jdied])[0]
    tcar = [x.numpy() for x in tcar]
    agree = tdied.numpy() == jdied
    for k in (0, 1, 2):                        # sample, depth, alive
        agree &= tcar[k] == jcar[k]
    assert (~agree).mean() <= FRAC_INT, (~agree).mean()
    assert (tcar[2] > 0.5).mean() > 0.05
    for k in range(3, 16):
        np.testing.assert_allclose(tcar[k][agree], jcar[k][agree], atol=2e-3,
                                   rtol=1e-3, err_msg=f"carry[{k}]")
    np.testing.assert_allclose(torch.stack(trad).numpy()[:, agree],
                               np.stack(jrad)[:, agree], atol=2e-3,
                               rtol=1e-3)

    # 6 iterations from a fresh state
    tc = fresh_carry(R, "cpu")
    jpix, jc = _to_jax(pix, tc)
    ta = torch.zeros((3, R))
    ja = np.zeros((3, R), np.float32)
    for _ in range(6):
        tc, trad, tdied = tstep(pix, tc)
        ta += torch.stack(trad) * tdied
        jc, jrad, jdied = jstep(jpix, jc)
        ja += np.stack(_flat(jrad)) * _flat([jdied])[0]
    assert ta.mean() > 0.0
    np.testing.assert_allclose(float(ta.mean()), ja.mean(), rtol=MEAN_RTOL)


@pytest.mark.parametrize("driver", ["queue", "stationary"])
def test_split_forward_matches_jax(scenes, monkeypatch, driver):
    js, jset, ts, tset = scenes
    calls = []
    for name in ("bounce_megakernel", "allpairs_nearest_record",
                 "shade_megakernel"):
        real = getattr(tint, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tint, name, spy)
    if driver == "queue":
        jacc, _ = jrender(js, jset, 1, spp=4)
        tacc, _ = trender(ts, tset, 1, spp=4)
        spp = 4
    else:
        spp = 2
        jacc = jint.trace_wavefront_stationary(js, jset, jrng.base_key(1),
                                               N_PIX, spp, rotate_k=2)
        tacc = tint.trace_wavefront_stationary(ts, tset, trng.base_key(1),
                                               N_PIX, spp, rotate_k=2)
    assert "bounce_megakernel" not in calls
    assert calls.count("allpairs_nearest_record") \
        == calls.count("shade_megakernel") > 5
    a = np.asarray(jacc) / spp
    b = tacc.numpy() / spp
    assert b.shape == a.shape == (N_PIX, 3) and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_standin_renders_and_trains_on_the_cpu():
    """The bunny stand-in (4,992 rows) through both entry points on CPU
    tensors: ``render_accumulate`` at 32 x 32 (the split path) and
    ``loss_and_grads`` on 512 lanes (the mesh variant forward, K5's
    plain backward)."""
    from raytrace_tpu_torch.diff.gradients import loss_and_grads, partition
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.testing import bunny_standin_scene
    scene, s = bunny_standin_scene(32, 1, 4, device="cpu")
    assert scene.prims.kind.shape[0] == 4992
    acc, n = trender(scene, s, 1, spp=1)
    img = acc.numpy() / n
    assert img.shape == (N_PIX, 3) and np.isfinite(img).all()
    assert img.min() < img.max()
    params, statics = partition(scene)
    pix = torch.arange(512, dtype=torch.int32) * 2
    (loss, frac), g = loss_and_grads(
        params, statics, s.replace(rr_depth=2), trng.base_key(0), pix,
        torch.zeros((512, 3)), spp=1, n_iters=4, remat=False)
    gn = grads_to_numpy(g)
    assert np.isfinite(float(loss)) and 0.0 < float(frac) <= 1.0
    assert all(np.isfinite(v).all() for v in gn.values())
    assert np.abs(gn["textures.c0"]).max() > 0.0


def test_split_path_raises_outside_its_slice():
    """A mesh-scale scene the split path does not take raises, naming its
    ROADMAP item: a light with a rich texture and more materials than the
    shade kernel's 24 (both the generic bounce, M4)."""
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.testing import uv_sphere
    v, f = uv_sphere(12, 30)
    mesh = rt.triangle_mesh(rt.Mesh(v, np.zeros((0, 2)), f,
                                    np.full_like(f, -1)))
    s = rt.CameraSettings(image_width=16, samples_per_pixel=1)
    marble = rt.compile_scene(rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)), mesh),
        rt.with_material(rt.light_source(rt.marble_texture([0, 0, 1], 2.0)),
                         rt.sphere([0, 0, -3], 1))]), device="cpu")
    assert marble.prims.kind.shape[0] > 512
    with pytest.raises(NotImplementedError, match="M4"):
        trender(marble, s, 1, spp=1)
    many = rt.compile_scene(rt.group(
        [rt.with_material(rt.lambertian(rt.constant_texture(0.5)), mesh)]
        + [rt.with_material(rt.metal(0.01 * i, rt.constant_texture(0.5)),
                            rt.sphere([i, 0, -3], 0.2)) for i in range(25)]),
        device="cpu")
    with pytest.raises(NotImplementedError, match="M4"):
        trender(many, s, 1, spp=1)
