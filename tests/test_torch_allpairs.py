"""The nearest-hit record over mesh-scale tables against the JAX package.

* ``allpairs_nearest_plain`` (the plain version of the nearest kernel)
  against ``allpairs_nearest_record(..., interpret=True)`` on the
  mixed-kind mesh scene (648 triangles, spheres, parallelograms and a
  box: 832 rows in three kind segments), without and with motion, through
  the static kernel and through the dynamic one (its chunk size and
  threshold lowered, as tests/test_allpairs_intersect.py does).  Rays:
  camera rays of a 32 x 32 image, their scattered second bounce, and
  random rays from inside the scene.
* ``pack_bvh``: every non-pad row of the packed table is in exactly one
  leaf, once, in the leaf-ordered copy of the rows beside its original
  index (kind-major order, not the builder's); every child box holds its
  rows and lies inside its parent's; the depth is within the walk's
  stack; two builds are equal.

Tolerances.  XLA's CPU backend contracts multiply-adds into fused ones,
so a ray that grazes an edge shared by two triangles, or a sphere's
silhouette, can resolve to the other primitive: the winner index may
differ on at most 1% of lanes (``FRAC_IDX``).  On lanes whose winners
agree, t within rtol 2e-4 + atol 3e-5 (tests/test_allpairs_intersect.py:
grazing sphere hits carry association noise) and the normal, front flag,
uv and material within atol 2e-3 + rtol 1e-3
(tests/test_bounce_kernel.py), the flags and material exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
from raytrace_tpu.ops.pallas import allpairs_kernel as jak
from raytrace_tpu.ops.pallas import intersect_kernel as jik
from raytrace_tpu_torch.ops.allpairs_kernel import (
    LEAF_SIZE, ORIG_COL, STACK_SIZE, allpairs_nearest_plain,
    allpairs_nearest_record, pack_bvh,
)
from raytrace_tpu_torch.ops.bounce_kernel import shade_plain
from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
from raytrace_tpu_torch.render.integrator import split_tables, surface_hit
from raytrace_tpu_torch.scene.types import PRIM_PAD
from raytrace_tpu_torch.testing import (
    bunny_standin_scene, camera_rays, mesh_all_kinds_scene,
    mesh_all_kinds_world,
)

FRAC_IDX = 0.01


def mesh_rays(scene, s, n: int, seed: int):
    """[7, n] rays: a third camera rays, a third their second bounce
    (nearest + shade plain versions; dead lanes parked far away), a third
    random rays from inside the scene with random times."""
    tb = split_tables(scene, s)
    k = n // 3
    cam, uni = camera_rays(scene, s, k, seed)
    alive = torch.ones(k, dtype=torch.bool)
    hit = surface_hit(tb, cam[0:3], cam[3:6], cam[6])
    lanes = (*cam[0:6], *torch.ones((3, k)), alive.float())
    out = shade_plain(tb.mtbl, tb.ttbl, hit, None, lanes, uni,
                      n_mats=tb.n_mats, n_targets=tb.n_targets,
                      has_medium=False)
    o2 = torch.where(out[12] > 0.5, torch.stack(out[0:3]), 3e18)
    second = torch.cat([o2, torch.stack(out[3:6]), cam[6:7]])
    rg = np.random.default_rng(seed)
    m = n - 2 * k
    d = rg.normal(size=(3, m))
    d /= np.linalg.norm(d, axis=0)
    rand = np.concatenate([rg.uniform(-3, 3, (3, m)), d,
                           rg.uniform(0, 1, (1, m))]).astype(np.float32)
    return torch.cat([cam, second, torch.from_numpy(rand)], dim=1)


def _jax_record(js, rays, n_prims, t_min, has_motion):
    g = rays.shape[1] // 128
    r = [jnp.asarray(x.numpy().reshape(g, 128)) for x in rays]
    out = jak.allpairs_nearest_record(
        jik.pack_prims(js.prims), *r, n_prims=n_prims, t_min=t_min,
        has_motion=has_motion, segments=js.prims.kind_segments,
        ctbl=jik.pack_clusters(js.prims), interpret=True)
    return [np.asarray(o).reshape(-1) for o in out]


@pytest.mark.parametrize("kernel,moving,n", [
    ("static", False, 1536), ("static", True, 1408),
    ("dynamic", False, 1280), ("dynamic", True, 1152)])
def test_allpairs_plain_matches_jax(monkeypatch, kernel, moving, n):
    if kernel == "dynamic":
        monkeypatch.setattr(jak, "CHUNK", 64)
        monkeypatch.setattr(jak, "DYN_MIN_CHUNKS", 2)
    ts, s = mesh_all_kinds_scene(18, moving, 32, device="cpu")
    js = jrt.compile_scene(mesh_all_kinds_world(jrt, 18, moving))
    rays = mesh_rays(ts, s, n, 5 + n)
    t_min = float(np.float32(s.t_min))
    n_prims = ts.prims.kind.shape[0]
    ref = [x.numpy() for x in allpairs_nearest_plain(
        pack_prims(ts.prims), *rays, n_prims=n_prims, t_min=t_min,
        has_motion=moving)]
    jx = _jax_record(js, rays, n_prims, t_min, moving)
    hit = np.isfinite(ref[0])
    assert hit.mean() > 0.2 and (ref[1] >= 0).sum() == hit.sum()
    same = ref[1] == jx[1]
    assert (~same).mean() <= FRAC_IDX, (~same).mean()
    assert np.isfinite(jx[0][~hit]).sum() <= (~same).sum()
    ok = same & hit
    np.testing.assert_allclose(ref[0][ok], jx[0][ok], rtol=2e-4, atol=3e-5)
    for k in (2, 3, 4, 6, 7):           # normal, u, v
        np.testing.assert_allclose(ref[k][ok], jx[k][ok], rtol=1e-3,
                                   atol=2e-3, err_msg=str(k))
    for k in (5, 8):                    # front | sphere << 1, material
        np.testing.assert_array_equal(ref[k][ok], jx[k][ok], err_msg=str(k))


@pytest.mark.parametrize("case", ["standin", "all_kinds_moving"])
def test_pack_bvh_covers_the_packed_table(case):
    if case == "standin":
        scene, _ = bunny_standin_scene(32, 1, 4, device="cpu")
    else:
        scene, _ = mesh_all_kinds_scene(18, True, device="cpu")
    p = scene.prims
    n_rows = p.kind.shape[0]
    tbl = pack_prims(p).contiguous()
    bvh = pack_bvh(p, tbl, n_rows)
    nodes = bvh.nodes.numpy()
    words = nodes.view(np.int32)
    rows = bvh.rows.numpy()
    kind = p.kind.numpy()
    real = np.nonzero(kind != PRIM_PAD)[0]
    # every non-pad row exactly once, pad rows never: the leaf-ordered copy
    # is the table's row beside its original index
    orig = rows[:, ORIG_COL].astype(np.int64)
    np.testing.assert_array_equal(orig, rows[:, ORIG_COL])
    np.testing.assert_array_equal(np.sort(orig), real)
    np.testing.assert_array_equal(rows[:, :ORIG_COL],
                                  tbl.numpy()[orig, :ORIG_COL])
    assert bvh.tri_only == (case == "standin")
    # every interior node is reached once from the root, the depth is the
    # most interior nodes on a path, within the walk's stack, and the
    # leaves (at most LEAF_SIZE rows) tile the copy
    child, count = words[:, 12:14], words[:, 14:16]
    n_nodes = nodes.shape[0]
    seen = np.zeros(n_nodes, np.int64)
    next_row, max_depth = 0, 0
    stack = [(0, 1)]
    while stack:
        i, d = stack.pop()
        seen[i] += 1
        max_depth = max(max_depth, d)
        for k in (0, 1):
            if count[i, k] == 0:
                assert child[i, k] > i
                stack.append((child[i, k], d + 1))
    np.testing.assert_array_equal(seen, 1)
    assert bvh.depth == max_depth <= STACK_SIZE
    leaves = sorted((child[i, k], count[i, k]) for i in range(n_nodes)
                    for k in (0, 1) if count[i, k] > 0)
    for start, c in leaves:
        assert start == next_row and 1 <= c <= LEAF_SIZE
        next_row += c
    assert next_row == real.size
    # each child box holds its rows (their corners, over both motion
    # extremes) and lies inside its parent's box
    p0 = p.p0.numpy().astype(np.float64)
    e1 = p.e1.numpy().astype(np.float64)
    e2 = p.e2.numpy().astype(np.float64)
    mv = [p.mv0.numpy().astype(np.float64), p.mv1.numpy().astype(np.float64)]
    box = lambda i, k: (nodes[i, 6 * k:6 * k + 3],
                        nodes[i, 6 * k + 3:6 * k + 6])
    parent = {}
    for i in range(n_nodes):
        for k in (0, 1):
            lo, hi = box(i, k)
            if count[i, k] == 0:
                parent[child[i, k]] = (lo, hi)
                continue
            for r in orig[child[i, k]:child[i, k] + count[i, k]]:
                if kind[r] == 0:
                    rad = abs(e1[r, 0])
                    pts = [p0[r] - rad, p0[r] + rad]
                elif kind[r] == 3:
                    pts = [p0[r], e1[r]]
                else:
                    pts = [p0[r], p0[r] + e1[r], p0[r] + e2[r]]
                for m in mv:
                    for q in pts:
                        assert np.all(q + m[r] >= lo), (i, k, r)
                        assert np.all(q + m[r] <= hi), (i, k, r)
    for i, (plo, phi) in parent.items():
        for k in (0, 1):
            lo, hi = box(i, k)
            assert np.all(lo >= plo) and np.all(hi <= phi), (i, k)
    # two builds are equal
    again = pack_bvh(p, tbl, n_rows)
    assert torch.equal(again.nodes, bvh.nodes)
    assert torch.equal(again.rows, bvh.rows)
    assert again.depth == bvh.depth


def test_nearest_wrapper_runs_plain_on_cpu():
    """CPU tensors take the plain version and launch nothing; the outputs
    follow the TPU kernel's contract (i32 index, flags and material)."""
    scene, s = mesh_all_kinds_scene(18, False, device="cpu")
    tb = split_tables(scene, s)
    rays, _ = camera_rays(scene, s, 256, 3)
    n0 = allpairs_nearest_record.launches
    out = allpairs_nearest_record(tb.ptbl, tb.bvh, *rays, n_prims=tb.n_prims,
                                  t_min=tb.t_min, has_motion=tb.has_motion)
    assert allpairs_nearest_record.launches == n0
    assert [x.dtype for x in out] == [torch.float32, torch.int32] \
        + [torch.float32] * 3 + [torch.int32] + [torch.float32] * 2 \
        + [torch.int32]
    hit = out[1] >= 0
    assert bool(hit.any()) and bool(torch.isfinite(out[0][hit]).all())
    assert bool(torch.isinf(out[0][~hit]).all())
    m = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        allpairs_nearest_record(m, None, m, m, m, m, m, m, m, n_prims=1,
                                t_min=1e-3, has_motion=False)
