"""The shade kernel's plain version against the JAX package's
``shade_megakernel`` (Pallas, interpret mode), in the manner of
tests/test_fused_shade.py.

Both take the same numpy inputs: hit records of the split path (the
port's nearest-hit plain version and exact sphere uv, sphere flag 0) of
random rays in the all-materials scene (eight materials, checker and
constant textures, two redirect targets) and in the mixed-kind mesh
scene, the same lane state (random throughput, 90% alive) and uniforms,
and the same material and target tables; with and without a synthetic
medium (an event nearer than the surface on about a third of the lanes,
of a random material).

Tolerances (tests/test_bounce_kernel.py): the alive and miss flags and
the winner index equal on all but ``FRAC_INT`` of the lanes (XLA's CPU
backend contracts multiply-adds, which can move a Schlick or hemisphere
decision on a lane), floats within atol 2e-3 + rtol 1e-3 on the lanes
whose flags agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu.ops.pallas import bounce_kernel as jbk
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.ops.bounce_kernel import (
    shade_megakernel, shade_plain,
)
from raytrace_tpu_torch.render.integrator import split_tables, surface_hit
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, BOUNCE_INT_ROWS, all_materials_scene,
    mesh_all_kinds_scene, synthetic_medium,
)

N = 1024
FRAC_INT = 0.01


def _inputs(case, seed):
    if case == "all_materials":
        scene = all_materials_scene(device="cpu")
        s = rt.CameraSettings(background=rt.const_background(0.2))
        s = s.with_redirect_targets(ALL_MATERIAL_TARGETS)
        box = (-8.0, 8.0)
    else:
        scene, s = mesh_all_kinds_scene(18, False, device="cpu")
        box = (-3.0, 3.0)
    rg = np.random.default_rng(seed)
    o = rg.uniform(box[0], box[1], (3, N)).astype(np.float32)
    d = rg.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    tm = rg.uniform(0, 1, (1, N)).astype(np.float32)
    comps = torch.from_numpy(np.concatenate([o, d, tm]))
    tb = split_tables(scene, s)
    hit = surface_hit(tb, comps[0:3], comps[3:6], comps[6])
    thr = torch.from_numpy(rg.uniform(0.2, 1.0, (3, N)).astype(np.float32))
    al = torch.from_numpy((rg.uniform(size=N) < 0.9).astype(np.float32))
    keys = rng.ray_keys_fast(rng.base_key(seed), torch.arange(N),
                             torch.zeros(N, dtype=torch.int32))
    uni = rng.uniform_cols(keys, 8).contiguous()
    lanes = (*comps[0:6], *thr, al)
    return tb, hit, lanes, uni


@pytest.mark.parametrize("case", ["all_materials", "mesh_all_kinds"])
@pytest.mark.parametrize("with_medium", [False, True])
def test_shade_plain_matches_jax(case, with_medium):
    tb, hit, lanes, uni = _inputs(case, 3 + with_medium)
    medium = synthetic_medium(hit[0], tb.n_mats, 7) if with_medium else None
    kw = dict(n_mats=tb.n_mats, n_targets=tb.n_targets,
              has_medium=with_medium)
    n0 = shade_megakernel.launches
    out = shade_megakernel(tb.mtbl, tb.ttbl, hit, medium, lanes, uni, **kw)
    assert shade_megakernel.launches == n0          # CPU: plain version
    ref = shade_plain(tb.mtbl, tb.ttbl, hit, medium, lanes, uni, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)

    g = N // 128
    j = lambda x: jnp.asarray(x.numpy().reshape(g, 128))
    jout = jbk.shade_megakernel(
        jnp.asarray(tb.mtbl.numpy()), jnp.asarray(tb.ttbl.numpy()),
        tuple(j(x) for x in hit),
        tuple(j(x) for x in medium) if with_medium else None,
        tuple(j(x) for x in lanes), jnp.asarray(uni.numpy().reshape(8, g, 128)),
        interpret=True, **kw)
    jout = [np.asarray(x).reshape(N) for x in jout]
    out = [x.numpy() for x in out]
    agree = np.ones(N, bool)
    for k in BOUNCE_INT_ROWS:
        agree &= out[k] == jout[k]
    assert (~agree).mean() <= FRAC_INT, (~agree).mean()
    for k in range(15):
        np.testing.assert_allclose(out[k][agree], jout[k][agree], rtol=1e-3,
                                   atol=2e-3, err_msg=str(k))
    alive = lanes[9].numpy() > 0.5
    assert (out[12] > 0.5).sum() > N // 20        # paths go on
    assert ((out[13] > 0.5) == (alive & ~np.isfinite(
        np.minimum(hit[0].numpy(), medium[0].numpy() if with_medium
                   else np.inf)))).all()
