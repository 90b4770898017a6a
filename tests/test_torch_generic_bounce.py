"""One step of the generic bounce (``render/integrator.py:
bounce_generic_soa``) against the JAX package's ``bounce``, in both modes,
on the CPU (where the port's nearest-hit, crossing and marble kernels run
their plain versions and JAX's ``bounce`` its XLA path).

Scenes: the all-materials scene of ``tests/test_bounce_kernel.py`` with
its two redirect targets (carried across with ``interop``), cornell_smoke
(two media), ``testing.marble_light_world`` (a light with a marble
texture) and cornell_smoke under ``testing.nine_target_settings`` (nine
redirect targets): 512 lanes each from a numpy seed, origins in the
scene's box, random directions (half of them aimed at a row's corner), times, radiance and throughput, 90% of
the lanes alive, the uniforms ``8 + V`` pair16-valued draws.

* ``diff=False`` and ``diff=True``: the new origin, direction, radiance
  and throughput, ``alive`` and ``died``.  The flags equal on all but
  0.5% of the lanes (XLA's CPU backend contracts multiply-adds, so a
  grazing hit can resolve the other way); on the lanes whose flags agree
  the floats within rtol 1e-4, atol 2e-4 of JAX's (the marble stripe's
  sines of large arguments spread most).
* ``diff=True``'s VJP of random cotangents on the four float outputs
  (zero on the lanes whose flags differ) with respect to every float leaf
  of the scene, ``volumes.density`` and ``volumes.prims`` included, and
  to the origin, direction and throughput: each within 1e-3 of JAX's
  norm in the L2 norm, and zero where JAX's is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.diff.gradients import combine as jcombine
from raytrace_tpu.diff.gradients import partition as jpartition
from raytrace_tpu.render.integrator import bounce as jbounce
from raytrace_tpu_torch.diff.gradients import combine, leaves, partition
from raytrace_tpu_torch.interop import (
    fields_to_numpy, grads_to_numpy, scene_from_numpy, scene_to_numpy,
    settings_from_numpy,
)
from raytrace_tpu_torch.render.integrator import (
    bounce_generic_soa, generic_tables, n_bounce_uniforms,
)
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, cornell_smoke_settings, cornell_smoke_world,
    marble_light_settings, marble_light_world, nine_target_settings,
    torch_threads,
)
from test_bounce_kernel import _scene_all_materials

R = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _all_materials():
    js = _scene_all_materials()
    jset = jrt.CameraSettings(background=jrt.const_background(0.2)) \
        .with_redirect_targets(ALL_MATERIAL_TARGETS)
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.2, 0.2, 0.2))
    return (js, jset, scene_from_numpy(scene_to_numpy(js), device="cpu"),
            settings_from_numpy(d), (-8.0, 8.0))


def _built(world, settings, box):
    return (jrt.compile_scene(world(jrt)), settings(jrt, 16, 1, 4),
            trt.compile_scene(world(trt), device="cpu"),
            settings(trt, 16, 1, 4), box)


CASES = {
    "all_materials_targets": _all_materials,
    "cornell_smoke": lambda: _built(cornell_smoke_world,
                                    cornell_smoke_settings, (0.0, 555.0)),
    "marble_light": lambda: _built(marble_light_world, marble_light_settings,
                                   (-5.0, 5.0)),
    "nine_targets": lambda: _built(cornell_smoke_world, nine_target_settings,
                                   (0.0, 555.0)),
}


def _lanes(ts, box, seed):
    rg = np.random.default_rng(seed)
    o = rg.uniform(box[0], box[1], (R, 3)).astype(np.float32)
    # half the lanes aim at a row's corner, so that most of them hit
    pts = ts.prims.p0.numpy()[ts.prims.kind.numpy() >= 0]
    d = rg.normal(size=(R, 3)).astype(np.float32)
    aim = pts[rg.integers(0, len(pts), R // 2)] - o[:R // 2]
    d[:R // 2] = aim + rg.normal(0, 0.3, aim.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rg.uniform(0, 1, R).astype(np.float32)
    u = (rg.integers(0, 1 << 16, (R, n_bounce_uniforms(ts))) / 65536.0) \
        .astype(np.float32)
    rad = rg.uniform(0, 1, (R, 3)).astype(np.float32)
    thr = rg.uniform(0.2, 1, (R, 3)).astype(np.float32)
    alive = rg.uniform(size=R) < 0.9
    return o, d, tm, u, rad, thr, alive


def _run_torch(ts, s, lanes, diff, grad_inputs=False):
    o, d, tm, u, rad, thr, alive = (torch.from_numpy(x.copy())
                                    for x in lanes)
    if grad_inputs:
        o, d, thr = (x.requires_grad_(True) for x in (o, d, thr))
    comps = torch.cat([o.T, d.T, tm[None]])
    out = bounce_generic_soa(ts, s, comps, u.T.contiguous(), rad.T, thr.T,
                             alive, tables=generic_tables(ts, s, diff=diff),
                             diff=diff)
    res = (out[0][0:3].T, out[0][3:6].T, out[1].T, out[2].T, out[3], out[4])
    return res, (o, d, thr)


def _run_jax(js, s, lanes, diff):
    o, d, tm, u, rad, thr, alive = (jnp.asarray(x) for x in lanes)
    return jbounce(js, s, o, d, tm, u, rad, thr, alive, diff=diff)


def _agree(jout, tout):
    """The lanes whose alive and died flags agree (at least 99.5%)."""
    same = np.ones(R, bool)
    for a, b in zip(jout[4:], tout[4:]):
        same &= np.asarray(a) == b.numpy()
    assert same.mean() >= 0.995, same.mean()
    return same


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_generic_bounce_matches_jax(name, diff):
    js, jset, ts, tset, box = CASES[name]()
    lanes = _lanes(ts, box, 11)
    jout = _run_jax(js, jset, lanes, diff)
    with torch.no_grad():
        tout, _ = _run_torch(ts, tset, lanes, diff)
    same = _agree(jout, tout)
    alive = lanes[6]
    assert (np.asarray(jout[4]) & alive).sum() > R // 8    # bounces
    for k in range(4):
        a = np.asarray(jout[k])[same]
        b = tout[k].numpy()[same]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-4,
                                   err_msg=f"{name} output {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_generic_bounce_vjp_matches_jax(name):
    js, jset, ts0, tset, box = CASES[name]()
    lanes = _lanes(ts0, box, 12)
    params, statics = partition(ts0)
    ts = combine(params, statics)
    tout, tin = _run_torch(ts, tset, lanes, True, grad_inputs=True)
    jout = _run_jax(js, jset, lanes, True)
    same = _agree(jout, tout)
    rg = np.random.default_rng(13)
    cts = [(rg.normal(size=(R, 3)) * same[:, None]).astype(np.float32)
           for _ in range(4)]
    jp, jst = jpartition(js)
    o, d, tm, u, rad, thr, alive = (jnp.asarray(x) for x in lanes)

    def jf(p, o_, d_, thr_):
        out = jbounce(jcombine(p, jst), jset, o_, d_, tm, u, rad, thr_,
                      alive, diff=True)
        return sum(jnp.sum(x * c) for x, c in zip(out[:4], cts))

    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(jp, o, d, thr)
    loss = sum((x * torch.from_numpy(c)).sum() for x, c in zip(tout, cts))
    named = {k: v for k, v in leaves(params).items() if v.requires_grad}
    tg = torch.autograd.grad(loss, list(named.values()) + list(tin),
                             allow_unused=True)
    jn = grads_to_numpy(jg[0])
    got = {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy())
           for (k, v), g in zip(named.items(), tg)}
    assert set(jn) == set(got)
    if "smoke" in name or "nine" in name:
        assert np.abs(jn["volumes.density"]).max() > 0
    for k, a in list(jn.items()) + [(n, np.asarray(x)) for n, x in zip(
            ("o", "d", "thr"), jg[1:])]:
        b = got[k] if k in got else tg[len(named) + ("o", "d", "thr")
                                       .index(k)].numpy()
        assert np.all(np.isfinite(b)), (name, k)
        if not np.any(a):
            assert not np.any(b), (name, k)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a), (
            name, k, float(np.linalg.norm(a - b)), float(np.linalg.norm(a)))
