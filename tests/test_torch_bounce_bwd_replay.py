"""Kernel K7's plain version and the unfused differentiable bounce against
the JAX package.

* ``bounce_bwd_megakernel_plain`` (torch autograd over the port's
  ``lane_math``) against ``raytrace_tpu``'s ``bounce_bwd_megakernel``
  (``interpret=True``) on the same inputs: 1024 lanes of the unfused
  driver's mid-render states (``testing.k7_inputs``: kernel A's plain
  version steps idle lanes four times; the fifth bounce's inputs,
  uniforms and winner index are K7's) with random normal cotangents, on
  the Cornell box (one redirect target, RR from depth 2), the
  all-materials scene and the box/motion scene, each with 0 and 2
  targets.  Every output (the ``n_row + 17`` gradients and the miss
  flag) on every lane.
* ``diff/mega_bounce.py:mega_bounce_diff_soa`` over one bounce of the
  Cornell box against the JAX package's (kernel A and K7 in interpret
  mode): its outputs, and its VJP with respect to the lanes and every
  float leaf of the scene for random cotangents.

Tolerances.  K7: ``RTOL * (|jax| + max|jax| over the output + max|jax|
over the lane)`` with ``RTOL = 1e-4`` (``testing.bwd_errs``' bound) on
all but ``FRAC = 0.5%`` of the lanes: the JAX kernel runs as one XLA
program whose CPU backend contracts a*b+c into fused multiply-adds, so a
comparison next to a branch threshold may go the other way on a rare
lane (``tests/test_torch_bounce_bwd.py``).  The bounce: alive and died
equal on all but 0.5% of the lanes, the float outputs within atol 2e-3 +
rtol 1e-3 (``tests/test_bounce_kernel.py``) on the lanes where both
agree; the lane gradients within the K7 bound on all but 0.5% of the
lanes, each scene leaf's gradient within 1e-3 of its norm in the L2
norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.diff.gradients import combine as jcombine
from raytrace_tpu.diff.gradients import partition as jpartition
from raytrace_tpu.diff.mega_bounce import mega_bounce_diff_soa as jmega
from raytrace_tpu.ops.pallas.bounce_bwd_kernel import (
    bounce_bwd_megakernel as jax_k7,
)
from raytrace_tpu_torch.diff.gradients import combine, leaves, partition
from raytrace_tpu_torch.diff.mega_bounce import mega_bounce_diff_soa
from raytrace_tpu_torch.interop import (
    fields_to_numpy, grads_to_numpy, scene_from_numpy, scene_to_numpy,
    settings_from_numpy,
)
from raytrace_tpu_torch.ops.bounce_bwd_kernel import (
    bounce_bwd_megakernel, bounce_bwd_megakernel_plain,
)
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, ATOL, RTOL as F_RTOL, all_materials_scene,
    box_motion_scene, cornell_scene_and_settings, k7_inputs,
    mesh_all_kinds_scene, torch_threads,
)

R = 1024
RTOL = 1e-4
FRAC = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _case(name):
    if name == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device="cpu")
        return scene, s.replace(rr_depth=2)
    if name.startswith("all_materials"):
        scene = all_materials_scene(device="cpu")
        s = rt.CameraSettings(background=rt.sky, image_width=64,
                              max_depth=10)
    else:
        scene, s = box_motion_scene(device="cpu")
        s = s.replace(background=rt.gray_fade)
    if name.endswith("2t"):
        s = s.with_redirect_targets(ALL_MATERIAL_TARGETS)
    return scene, s


def _bad_lanes(jx, tx):
    """Per lane, whether any output is outside the K7 bound."""
    mag = np.abs(jx)
    bound = RTOL * (mag + mag.max(1, keepdims=True)
                    + mag.max(0, keepdims=True))
    bad = (np.abs(tx - jx) > bound) | (np.isnan(tx) != np.isnan(jx))
    return bad.any(0)


@pytest.mark.parametrize("name", ["cornell", "all_materials",
                                  "all_materials_2t", "box_motion",
                                  "box_motion_2t"])
def test_plain_k7_matches_jax_kernel(name):
    scene, s = _case(name)
    args, kw = k7_inputs(scene, s, R, 4, seed=11)
    ttbl, gath, bi, lane, u_cols, al, cts = args
    a0 = bounce_bwd_megakernel.launches
    ours = bounce_bwd_megakernel(*args, **kw)
    assert bounce_bwd_megakernel.launches == a0   # CPU: the plain version
    ref = bounce_bwd_megakernel_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ours, ref))

    n_row = kw["n_row"]
    j = lambda x: jnp.asarray(x.numpy().reshape(R // 128, 128))
    diff = tuple(j(x) for x in tuple(gath[:n_row + 7]) + tuple(lane))
    det = tuple(j(x) for x in tuple(gath[n_row + 7:]) + tuple(u_cols)
                + (al, torch.where(bi >= 0.0, 1.0, 0.0)))
    gdiff, miss = jax_k7(jnp.asarray(ttbl.numpy()), diff, det,
                         tuple(j(x) for x in cts), interpret=True,
                         n_targets=kw["n_targets"],
                         has_motion=kw["has_motion"],
                         has_box=kw["has_box"], t_min=kw["t_min"])
    flat = list(gdiff) + [miss]
    assert len(flat) == len(ours) == n_row + 18
    jx = np.stack([np.asarray(x).reshape(R) for x in flat]).astype(np.float64)
    tx = torch.stack(ours).numpy().astype(np.float64)
    assert _bad_lanes(jx, tx).mean() <= FRAC, int(_bad_lanes(jx, tx).sum())
    # the state carries gradient: live hits and the rows in use
    assert int((al > 0.5).sum()) > R // 8
    assert (np.abs(jx).max(1) > 0).sum() >= n_row + 10


def test_k7_on_parked_dead_lanes_of_a_mesh_state():
    """ROADMAP F9: a 384-row mesh state at 2 spp, whose dead lanes are
    parked at 3e18 with winner -1, reading row 0, a sphere.  JAX's K7
    returns NaN there (its f32 vjp multiplies a zero cotangent by the
    overflowed refraction term); the route reads those lanes only through
    the row sums and discards their lane gradients.  The port's plain
    version agrees with JAX on every live lane and gives the exact
    gradients (float64 autograd) on the dead ones: 0 for the row, the
    cotangent for the lane."""
    scene, s = mesh_all_kinds_scene(10, False, 64, device="cpu")
    args, kw = k7_inputs(scene, s, R, 4, seed=7, spp=2)
    ttbl, gath, bi, lane, u_cols, al, cts = args
    live = (al > 0.5).numpy()
    assert live.sum() > R // 16 and (~live).sum() > R // 2
    ours = bounce_bwd_megakernel_plain(*args, **kw)
    tx = torch.stack(ours).numpy().astype(np.float64)
    assert np.isfinite(tx).all()

    n_row = kw["n_row"]
    j = lambda x: jnp.asarray(x.numpy().reshape(R // 128, 128))
    diff = tuple(j(x) for x in tuple(gath[:n_row + 7]) + tuple(lane))
    det = tuple(j(x) for x in tuple(gath[n_row + 7:]) + tuple(u_cols)
                + (al, torch.where(bi >= 0.0, 1.0, 0.0)))
    gdiff, miss = jax_k7(jnp.asarray(ttbl.numpy()), diff, det,
                         tuple(j(x) for x in cts), interpret=True,
                         n_targets=kw["n_targets"],
                         has_motion=kw["has_motion"],
                         has_box=kw["has_box"], t_min=kw["t_min"])
    jx = np.stack([np.asarray(x).reshape(R)
                   for x in list(gdiff) + [miss]]).astype(np.float64)
    assert _bad_lanes(jx[:, live], tx[:, live]).mean() <= FRAC

    f64 = lambda xs: tuple(x.double() for x in xs)
    exact = bounce_bwd_megakernel_plain(
        ttbl.double(), f64(gath), bi.double(), f64(lane), f64(u_cols),
        al.double(), f64(cts), **kw)
    ex = torch.stack(exact).numpy()
    np.testing.assert_array_equal(tx[:n_row + 7, ~live], 0.0)
    np.testing.assert_array_equal(ex[:n_row + 7, ~live], 0.0)
    np.testing.assert_allclose(tx[:, ~live], ex[:, ~live], rtol=1e-6,
                               atol=0.0)


@pytest.fixture(scope="module")
def cornell_pair():
    js, jset = _cornell_scene_and_settings(64, 8, 10)
    jset = jset.replace(rr_depth=2)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    return js, jset, ts, settings_from_numpy(d)


def test_mega_bounce_value_and_vjp_match_jax(cornell_pair):
    js, jset, ts, tset = cornell_pair
    args, _ = k7_inputs(ts, tset, R, 3, seed=5)
    lane, u_cols, al = args[3], args[4], args[5]
    comps = torch.stack(lane[:7])
    thr = torch.stack(lane[7:10])
    alive = al > 0.5
    gen = torch.Generator().manual_seed(6)
    cts = torch.randn((13, R), generator=gen)

    # JAX: value and VJP through its custom VJP (K7 in interpret mode)
    jparams, jstatics = jpartition(js)
    juni = jnp.asarray(u_cols.numpy().T)
    jalive = jnp.asarray(alive.numpy())

    def f(params, c, t):
        c2, contrib, t2, a2, d2 = jmega(jcombine(params, jstatics), jset, c,
                                        juni, t, jalive, interpret=True)
        return (c2, contrib, t2), (a2, d2)

    jc = tuple(jnp.asarray(x.numpy()) for x in comps)
    jt = tuple(jnp.asarray(x.numpy()) for x in thr)
    jouts, vjp, (ja2, jd2) = jax.vjp(f, jparams, jc, jt, has_aux=True)
    jct = (tuple(jnp.asarray(x.numpy()) for x in cts[0:7]),
           tuple(jnp.asarray(x.numpy()) for x in cts[7:10]),
           tuple(jnp.asarray(x.numpy()) for x in cts[10:13]))
    jg_params, jg_c, jg_t = vjp(jct)

    # the port
    params, statics = partition(ts)
    c_in = comps.clone().requires_grad_(True)
    t_in = thr.clone().requires_grad_(True)
    c2, contrib, t2, a2, d2 = mega_bounce_diff_soa(
        combine(params, statics), tset, c_in, u_cols, t_in, alive)
    named = {k: v for k, v in leaves(params).items() if v.requires_grad}
    gs = torch.autograd.grad([c2, contrib, t2], [c_in, t_in]
                             + list(named.values()),
                             grad_outputs=[cts[0:7], cts[7:10], cts[10:13]],
                             allow_unused=True)

    agree = ((np.asarray(ja2) == a2.numpy())
             & (np.asarray(jd2) == d2.numpy()))
    assert agree.mean() >= 1.0 - FRAC
    jv = np.stack([np.asarray(x) for part in jouts for x in part])
    tv = torch.cat([c2, contrib, t2]).detach().numpy()
    assert np.all(np.isfinite(tv))
    np.testing.assert_allclose(tv[:, agree], jv[:, agree], atol=ATOL,
                               rtol=F_RTOL)

    jl = np.stack([np.asarray(x) for x in tuple(jg_c) + tuple(jg_t)])
    tl = torch.cat(gs[:2]).numpy()
    assert _bad_lanes(jl.astype(np.float64),
                      tl.astype(np.float64)).mean() <= FRAC
    jn = grads_to_numpy(jg_params)
    tn = {k: (np.zeros_like(jn[k]) if g is None else g.numpy())
          for k, g in zip(named, gs[2:])}
    assert sorted(jn) == sorted(tn)
    for k in jn:
        scale = np.linalg.norm(jn[k])
        if scale == 0.0:
            assert not np.any(tn[k]), k
        else:
            assert np.linalg.norm(tn[k] - jn[k]) <= 1e-3 * scale, k
    assert np.linalg.norm(jn["textures.c0"]) > 0.0
    assert np.linalg.norm(jn["prims.e1"]) > 0.0
