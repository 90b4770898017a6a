"""The port's ``lane_math`` against the JAX package's, forward and VJP.

The same random lanes (numpy, seeded) go through
``raytrace_tpu.diff.lane_replay.lane_math(exact_trig=False)`` under
``jax.vjp`` and ``raytrace_tpu_torch.diff.lane_replay.lane_math`` under
torch autograd, with the same random cotangents.  Each lane's winner is a
random row of a scene holding all 10 material kinds and all 4 primitive
kinds (checker textures included), its ray aimed at a point of that row,
so most lanes hit it; some lanes are dead and some winners are misses.
Parametrised over motion, box rows and 0/1/2 redirect targets.

Tolerance: every output and every gradient within ``RTOL * (|jax| +
max|jax| over its column)``, ``RTOL = 1e-4``, on all but ``FRAC`` of the
lanes.  JAX runs eagerly here, op by op, so XLA does not contract a*b+c
into fused multiply-adds and both sides round alike; the JAX package
takes 1/rsqrt for the plane normal where the port takes 1/sqrt (the
kernels' form), so a comparison near a branch threshold (a hit at a
parallelogram's edge, Schlick's reflect-or-refract draw) may still go the
other way on a rare lane: ``FRAC = 0.2%`` of the lanes (4 of 2048) may
differ.  Measured: at most 1 lane in any column over the 12 cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu.diff import lane_replay as jlr
from raytrace_tpu_torch.diff import lane_replay as tlr

R = 2048
RTOL = 1e-4
FRAC = 0.002
TARGETS = [(0.2, [1.0, 4.0, 1.0], [-1.5, 0, 0], [0, 0, -1.2]),
           (0.15, [-2.0, 4.0, -1.0], [1.0, 0, 0.2], [0, 0.1, 1.0])]


def _scene(motion: bool, box: bool):
    """All 10 material kinds on spheres, parallelograms, triangles and
    (with ``box``) axis-aligned cuboids; with ``motion`` some rows move."""
    checker = jrt.checker_texture(3.0, 4.0, [0.8, 0.2, 0.1], [0.1, 0.2, 0.8])
    mats = [
        jrt.lambertian(jrt.constant_texture([0.7, 0.5, 0.3])),
        jrt.lambertian(checker),
        jrt.lommel_seeliger(jrt.constant_texture([0.4, 0.6, 0.2])),
        jrt.mirror(jrt.constant_texture([0.9, 0.9, 0.8])),
        jrt.metal(0.3, jrt.constant_texture([0.8, 0.6, 0.4])),
        jrt.dielectric(1.5),
        jrt.transparent(jrt.constant_texture([0.9, 0.7, 0.9])),
        jrt.light_source(jrt.constant_texture([4.0, 3.0, 2.0])),
        jrt.pitch_black(),
        jrt.isotropic(checker),
        jrt.anisotropic(0.4, jrt.constant_texture([0.6, 0.4, 0.5])),
    ]
    rg = np.random.RandomState(0)
    geoms = []
    for i, m in enumerate(mats):
        c = rg.uniform(-3, 3, 3)
        parts = [jrt.sphere(c, 0.7),
                 jrt.parallelogram(c + [0, -1.5, 0], [1.2, 0.1, 0],
                                   [0, 0.2, 1.1]),
                 jrt.triangle(c + [2, 0, 0], c + [3, 0.2, 0],
                              c + [2.2, 1, 0.3], uv0=(0.1, 0.2),
                              uv1=(0.9, 0.1), uv2=(0.3, 0.8))]
        if box:
            parts.append(jrt.cuboid(c + [-2, -2, -2], c + [-1, -0.5, -1.2]))
        for k, g in enumerate(parts):
            if motion and (i + k) % 3 == 0:
                g = jrt.moving(rg.uniform(-0.3, 0.3, 3),
                               rg.uniform(-0.3, 0.3, 3), g)
            geoms.append(jrt.with_material(m, g))
    return jrt.compile_scene(jrt.group(geoms), accel="dense")


def _lanes(scene, motion: bool, seed: int):
    """``(diff, det)`` numpy columns of R random lanes aimed at their
    winners."""
    p, m, tx = scene.prims, scene.materials, scene.textures
    kind = np.asarray(p.kind)
    real = np.nonzero(kind >= 0)[0]
    rg = np.random.RandomState(seed)
    idx = real[rg.randint(0, real.size, R)]
    idx[rg.uniform(size=R) < 0.03] = -1
    pi = np.maximum(idx, 0)
    p0, e1, e2 = (np.asarray(x)[pi] for x in (p.p0, p.e1, p.e2))
    mv0, mv1 = np.asarray(p.mv0)[pi], np.asarray(p.mv1)[pi]
    time = rg.uniform(0, 1, R)
    a, b = rg.uniform(0.05, 0.95, (2, R))
    tri = kind[pi] == 2
    a, b = np.where(tri, a * 0.5, a), np.where(tri, b * 0.5, b)
    unit = rg.normal(size=(R, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    aim = np.where((kind[pi] == 0)[:, None], p0 + e1[:, :1] * unit,
                   p0 + a[:, None] * e1 + b[:, None] * e2)
    aim = np.where((kind[pi] == 3)[:, None],
                   p0 + rg.uniform(0, 1, (R, 3)) * (e1 - p0), aim)
    if motion:
        aim = aim + mv0 * (1 - time[:, None]) + mv1 * time[:, None]
    o = aim + rg.normal(size=(R, 3)) * 3.0
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a few rays in random directions (mostly misses of their winner)
    stray = rg.uniform(size=R) < 0.05
    d[stray] = unit[stray]
    mat = np.asarray(p.mat)[pi]
    tex = np.asarray(m.tex)[mat]
    c0, c1 = np.asarray(tx.c0)[tex], np.asarray(tx.c1)[tex]
    cols = [p0, e1, e2] + ([mv0, mv1] if motion else []) + [c0, c1]
    diff = ([c[:, k] for c in cols for k in range(3)]
            + [np.asarray(m.param)[mat]] + [o[:, k] for k in range(3)]
            + [d[:, k] for k in range(3)] + [time]
            + list(rg.uniform(0.1, 1.0, (3, R))))
    uvr = np.asarray(p.uvs).reshape(-1, 6)[pi]
    det = ([kind[pi], np.asarray(m.kind)[mat], np.asarray(tx.kind)[tex],
            np.asarray(tx.f0)[tex], np.asarray(tx.f1)[tex]]
           + [uvr[:, k] for k in range(6)]
           + list(rg.uniform(0, 1, (8, R)))
           + [(rg.uniform(size=R) < 0.9), idx >= 0])
    f32 = lambda xs: [np.asarray(x, np.float32) for x in xs]
    return f32(diff), f32(det)


@pytest.fixture(scope="module")
def scenes():
    return {(mo, bx): _scene(mo, bx) for mo in (False, True)
            for bx in (False, True)}


def _close(t, j, name):
    """Within RTOL * (|j| + column max) on all but FRAC of the lanes."""
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    scale = np.abs(j).max() if j.size else 0.0
    bad = np.abs(t - j) > RTOL * (np.abs(j) + scale)
    bad |= np.isnan(t) != np.isnan(j)
    assert bad.mean() <= FRAC, (name, int(bad.sum()))


@pytest.mark.parametrize("n_targets", [0, 1, 2])
@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("motion", [False, True])
def test_lane_math_forward_and_vjp_match_jax(scenes, motion, box,
                                              n_targets):
    scene = scenes[(motion, box)]
    assert scene.prims.has_box == box and scene.prims.has_motion == motion
    diff, det = _lanes(scene, motion, 10 * n_targets + 2 * box + motion)
    kinds = set(det[1][det[20] > 0.5].astype(int).tolist())
    assert kinds == set(range(10))
    assert set(det[0].astype(int).tolist()) == (
        {0, 1, 2, 3} if box else {0, 1, 2})
    tg = TARGETS[:n_targets]
    tgt = ([t[1] for t in tg], [t[2] for t in tg], [t[3] for t in tg],
           [t[0] for t in tg])
    kw = dict(has_motion=motion, has_box=box, t_min=1e-3,
              n_targets=n_targets)
    rg = np.random.RandomState(99)
    cts = [np.asarray(rg.normal(size=R), np.float32) for _ in range(12)]

    jdet = tuple(jnp.asarray(x) for x in det)
    jtgt = tuple([tuple(jnp.float32(c) for c in v) for v in part]
                 for part in tgt[:3]) + ([jnp.float32(x) for x in tgt[3]],)
    jout, vjp = jax.vjp(
        lambda *xs: jlr.lane_math(xs, jdet, jtgt, exact_trig=False, **kw),
        *[jnp.asarray(x) for x in diff])
    jgrad = vjp(tuple(jnp.asarray(c) for c in cts)
                + (jnp.zeros(R, jnp.float32),))

    xs = [torch.from_numpy(x).requires_grad_(True) for x in diff]
    tout = tlr.lane_math(xs, tuple(torch.from_numpy(x) for x in det), tgt,
                         **kw)
    tgrad = torch.autograd.grad(tout[:12], xs, [torch.from_numpy(c)
                                                for c in cts],
                                allow_unused=True)
    for k in range(13):
        _close(tout[k].detach().numpy(), jout[k], f"output {k}")
    for k, (t, j) in enumerate(zip(tgrad, jgrad)):
        t = np.zeros(R, np.float32) if t is None else t.numpy()
        _close(t, j, f"gradient of input {k}")
