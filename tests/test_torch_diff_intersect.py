"""The differentiable surface hit (``ops/diff_intersect.py:
DiffSurfaceHit``) against the JAX package's ``make_diff_surface_hit``
(``use_pallas=False``: its dense nearest-hit forward and its winner-only
custom VJP), on the CPU, where the port's forward runs the nearest-hit
kernels' plain versions (K8's flat scan, and for the 832-row mesh, a
kind-segmented table, K9's).

Scenes: the Cornell box (18 parallelograms), ``testing.box_motion_scene``
(boxes, spheres, planes, half of them moving) and
``testing.mesh_all_kinds_world`` (832 rows); 1024 camera rays of each,
and 1024 random rays through the scene's box at random times.

The forward: the winner index equal on all but 0.5% of the rays (a
grazing ray can resolve an edge differently, the two packages summing a
dot product's products in different orders); on the rays whose winner
agrees, t, the normal and the uv within rtol 1e-4, atol 1e-4 on all but
0.5% of them and within 1e-2 on all (K8 and K9 build the record in their
own association, and a near-tangent sphere hit turns an ulp of t into
1e-4 of the normal), the front flag and the material equal.  The VJP of a random cotangent on t, the
normal and the uv (zero on the rays whose winner differs) with respect to
every float input (``p0, e1, e2, uvs, mv0, mv1, o, d, time``): within
1e-4 of JAX's norm in the L2 norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops.diff_intersect import make_diff_surface_hit
from raytrace_tpu_torch.ops.diff_intersect import diff_surface_hit, hit_statics
from raytrace_tpu_torch.render.integrator import split_tables, uses_bvh
from raytrace_tpu_torch.testing import (
    box_motion_scene, camera_rays, cornell_scene_and_settings,
    mesh_all_kinds_scene, torch_threads,
)

R = 1024
FLOATS = ("p0", "e1", "e2", "uvs", "mv0", "mv1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _scene(name):
    if name == "cornell":
        return cornell_scene_and_settings(16, 1, 4, device="cpu")
    if name == "box_motion":
        return box_motion_scene(device="cpu")
    return mesh_all_kinds_scene(18, False, 32, device="cpu")


def _random_rays(p, seed):
    rg = np.random.default_rng(seed)
    pts = p.p0.numpy()[p.kind.numpy() >= 0]
    o = rg.uniform(pts.min(0) - 1.0, pts.max(0) + 1.0, (R, 3))
    tgt = pts[rg.integers(0, len(pts), R)] + rg.normal(0, 0.3, (R, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(rg.uniform(0, 1, R).astype(np.float32)))


@pytest.mark.parametrize("rays", ["camera", "random"])
@pytest.mark.parametrize("name", ["cornell", "box_motion", "mesh"])
def test_diff_surface_hit_matches_jax(name, rays):
    scene, s = _scene(name)
    p = scene.prims
    assert uses_bvh(p) == (name == "mesh")
    if rays == "camera":
        comps, _ = camera_rays(scene, s, R, 5)
        o, d, tm = comps[0:3].T.contiguous(), comps[3:6].T.contiguous(), \
            comps[6].contiguous()
    else:
        o, d, tm = _random_rays(p, 6)
    tb = split_tables(scene, s)
    st = hit_statics(tb, p, tb.t_min)
    jhit = make_diff_surface_hit(p.has_motion, tb.t_min, False,
                                 has_box=p.has_box,
                                 kind_segments=p.kind_segments)
    jf = tuple(jnp.asarray(getattr(p, f).numpy()) for f in FLOATS)
    ints_f = (jnp.asarray(p.kind.numpy(), jnp.float32),
              jnp.asarray(p.mat.numpy(), jnp.float32))
    jin = (jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
           jnp.asarray(tm.numpy()))
    def jfn(f, a, b, c):
        out = jhit(f, ints_f, a, b, c)
        return (out[0], out[2], out[4]), out

    _, vjp, jout = jax.vjp(jfn, jf, *jin, has_aux=True)
    leaves = [getattr(p, f).clone().requires_grad_(True) for f in FLOATS]
    tin = [x.clone().requires_grad_(True) for x in (o, d, tm)]
    tp = type(p)(**{**{f: getattr(p, f) for f in p.__dataclass_fields__},
                    **dict(zip(FLOATS, leaves))})
    tout = diff_surface_hit(st, tp, *tin)
    jidx = np.asarray(jout[1])
    same = jidx == tout[1].numpy()
    assert same.mean() > 0.995, (name, rays, same.mean())
    hit = same & (jidx >= 0)
    assert hit.sum() > 150
    for k in (0, 2, 4):
        a = np.asarray(jout[k])[hit]
        b = tout[k].detach().numpy()[hit]
        close = np.isclose(b, a, rtol=1e-4, atol=1e-4)
        close = close.reshape(close.shape[0], -1).all(1)
        assert close.mean() > 0.995, (name, rays, k, close.mean())
        assert np.abs(a - b).max() < 1e-2, (name, rays, k)
    assert np.array_equal(tout[3].numpy()[hit], np.asarray(jout[3])[hit])
    assert np.array_equal(tout[5].numpy()[hit], np.asarray(jout[5])[hit])
    rg = np.random.default_rng(9)
    m = same.astype(np.float32)
    cts = (rg.normal(size=R).astype(np.float32) * m,
           rg.normal(size=(R, 3)).astype(np.float32) * m[:, None],
           rg.normal(size=(R, 2)).astype(np.float32) * m[:, None])
    jf_g, *jr_g = vjp(tuple(jnp.asarray(c) for c in cts))
    tg = torch.autograd.grad((tout[0], tout[2], tout[4]), leaves + tin,
                             tuple(torch.from_numpy(c) for c in cts),
                             allow_unused=True)
    for k, (a, b) in enumerate(zip(list(jf_g) + jr_g, tg)):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.all(np.isfinite(b)), (name, k)
        scale = np.linalg.norm(a)
        assert np.linalg.norm(a - b) <= 1e-4 * scale + 1e-6, (name, rays, k)
