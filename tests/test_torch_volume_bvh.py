"""The per-medium BVH forest of kernel K11b
(``ops/volume_kernel.py:pack_volume_bvh``) on the CPU.

* Every leaf row lies inside the boxes of every node above it (the boxes
  padded outward as ``pack_bvh``'s are, so containment is strict).
* Each medium's tree holds exactly that medium's rows, each once, with
  its index in the packed boundary table in column ``ORIG_COL``; the
  leaf-ordered rows are the packed rows themselves; the forest is
  triangle-only where every row is an unmoving triangle.
* A moving boundary's boxes hold each row at both ends of its motion.
* A scene of 17 media launches the walk in two groups (16 media, then 1),
  each with its own media's roots, and the crossings equal the plain
  version's (the CPU wrappers run it).
* A tree deeper than the walk's stack raises.

Scenes: the stand-in pawn (1,200 rows), ``testing.mixed_media_world``
(four media of 1,200, 1, 1 and 64 rows), still and moving, and
``testing.many_media_world`` with rotated boxes (17 media of 6 rows).
"""
import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import allpairs_kernel as ak
from raytrace_tpu_torch.ops import volume_kernel as tvk
from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
from raytrace_tpu_torch.render import volumes as rv
from raytrace_tpu_torch.scene.bvh import prim_aabbs
from raytrace_tpu_torch.testing import (
    many_media_world, mixed_media_world, pawn_standin_world, volume_rays,
)

WORLDS = {
    "pawn": pawn_standin_world,
    "mixed": mixed_media_world,
    "mixed_moving": lambda r: mixed_media_world(r, True),
}


def _forest(world):
    vol = rt.compile_scene(world(rt), device="cpu").volumes
    vtbl = pack_prims(vol.prims)
    slices = tuple(zip(vol.starts, vol.counts))
    return vol, vtbl, tvk.pack_volume_bvh(vol.prims, vtbl, slices)


def _walk(forest, root):
    """``[(first row, count, [node boxes on the path])]`` of every leaf
    under ``root`` (a root whose two children are one leaf gives it
    once)."""
    nodes = forest.nodes.numpy()
    words = nodes.view(np.int32)
    out, todo = [], [(root, [])]
    while todo:
        w, path = todo.pop()
        one_leaf = (words[w, 12] == words[w, 13]
                    and words[w, 14] == words[w, 15] > 0)
        for c in (0,) if one_leaf else (0, 1):
            box = (nodes[w, 6 * c:6 * c + 3], nodes[w, 6 * c + 3:6 * c + 6])
            word, count = words[w, 12 + c], words[w, 14 + c]
            if count == 0:
                todo.append((word, path + [box]))
            else:
                out.append((word, count, path + [box]))
    return out


def _row_boxes(prims, t):
    """Each boundary row's unpadded box at motion time ``t`` (a motion is
    a translation from ``mv0`` to ``mv1``)."""
    f64 = lambda x: x.numpy().astype(np.float64)
    lo, hi = prim_aabbs(prims.kind.numpy(), f64(prims.p0), f64(prims.e1),
                        f64(prims.e2))
    mv = f64(prims.mv0) + t * (f64(prims.mv1) - f64(prims.mv0))
    return lo + mv, hi + mv


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_leaf_rows_lie_inside_their_node_boxes(name):
    vol, _, forest = _forest(WORLDS[name])
    orig = forest.rows[:, ak.ORIG_COL].numpy().astype(np.int64)
    times = (0.0, 0.5, 1.0) if vol.prims.has_motion else (0.0,)
    boxes = [_row_boxes(vol.prims, t) for t in times]
    for root in forest.roots:
        for first, count, path in _walk(forest, root):
            rows = orig[first:first + count]
            for lo, hi in boxes:
                for blo, bhi in path:
                    assert np.all(lo[rows] > blo) and np.all(hi[rows] < bhi)
    assert 0 < forest.depth <= ak.STACK_SIZE


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_each_medium_holds_its_rows_once(name):
    vol, vtbl, forest = _forest(WORLDS[name])
    assert len(forest.roots) == vol.n_volumes
    assert forest.tri_only == (name == "pawn")     # the walk's test
    orig = forest.rows[:, ak.ORIG_COL].numpy().astype(np.int64)
    seen = []
    for root, start, count in zip(forest.roots, vol.starts, vol.counts):
        rows = np.concatenate([orig[w:w + n] for w, n, _ in
                               _walk(forest, root)])
        np.testing.assert_array_equal(np.sort(rows),
                                      np.arange(start, start + count))
        seen.append(rows)
    assert forest.rows.shape[0] == vtbl.shape[0] == sum(map(len, seen))
    # the leaf-ordered rows are the packed rows, the index column aside
    cols = [c for c in range(vtbl.shape[1]) if c != ak.ORIG_COL]
    assert torch.equal(forest.rows[:, cols], vtbl[orig][:, cols])


def test_moving_boundary_boxes_are_swept():
    """The moving mixed media: at the end of its motion every row lies
    inside its leaf's box, while the still media's leaf boxes miss more
    than 100 rows at that time."""
    vol, _, moving = _forest(WORLDS["mixed_moving"])
    still_vol, _, still = _forest(WORLDS["mixed"])
    lo1, hi1 = _row_boxes(vol.prims, 1.0)
    orig = moving.rows[:, ak.ORIG_COL].numpy().astype(np.int64)
    for root in moving.roots:
        for first, count, path in _walk(moving, root):
            rows = orig[first:first + count]
            blo, bhi = path[-1]
            assert np.all(lo1[rows] > blo) and np.all(hi1[rows] < bhi)
    escaped = 0
    orig_s = still.rows[:, ak.ORIG_COL].numpy().astype(np.int64)
    for root in still.roots:
        for first, count, path in _walk(still, root):
            rows = orig_s[first:first + count]
            blo, bhi = path[-1]
            escaped += int((~(np.all(lo1[rows] > blo, 1)
                              & np.all(hi1[rows] < bhi, 1))).sum())
    assert escaped > 100


def test_seventeen_media_launch_in_two_groups(monkeypatch):
    world = many_media_world(rt, 17, rotated=True)
    vol = rt.compile_scene(world, device="cpu").volumes
    assert rv.uses_bcast(vol) and vol.n_volumes == 17
    tables = rv.volume_tables(vol)
    forest = tables.forest
    calls = []
    real = rv.pallas_volume_crossings_bcast

    def spy(vtbl, fr, *rays, **kw):
        calls.append((fr.roots, kw["slices"]))
        return real(vtbl, fr, *rays, **kw)
    monkeypatch.setattr(rv, "pallas_volume_crossings_bcast", spy)
    rays = volume_rays(256, 9, (-7.0, 7.0))
    outs = rv.volume_crossings(vol, tuple(rays.unbind(0)), 1e-3, tables)
    slices = tuple(zip(vol.starts, vol.counts))
    assert [len(s) for _, s in calls] == [16, 1]
    assert calls[0] == (forest.roots[:16], slices[:16])
    assert calls[1] == (forest.roots[16:], slices[16:])
    orig = forest.rows[:, ak.ORIG_COL].numpy().astype(np.int64)
    for (roots, group) in calls:
        for root, (start, count) in zip(roots, group):
            rows = np.concatenate([orig[w:w + n] for w, n, _ in
                                   _walk(forest, root)])
            np.testing.assert_array_equal(np.sort(rows),
                                          np.arange(start, start + count))
    ref = tvk.volume_crossings_plain(tables.vtbl, *rays.unbind(0),
                                     **rv.crossing_kw(vol, 1e-3))
    assert len(outs) == 3 * 17
    for a, b in zip(ref, outs):
        assert torch.equal(a, b)


def test_a_tree_too_deep_raises(monkeypatch):
    """The pawn's tree is 10 levels deep: with a stack of 6 the pack
    raises, as it would for a tree deeper than the walk's 32."""
    vol = rt.compile_scene(pawn_standin_world(rt), device="cpu").volumes
    vtbl = pack_prims(vol.prims)
    slices = tuple(zip(vol.starts, vol.counts))
    assert tvk.pack_volume_bvh(vol.prims, vtbl, slices).depth == 10
    monkeypatch.setattr(ak, "STACK_SIZE", 6)
    with pytest.raises(ValueError, match="overflows the walk's stack"):
        tvk.pack_volume_bvh(vol.prims, vtbl, slices)


@pytest.mark.parametrize("name", sorted(WORLDS) + ["many_rotated"])
def test_keyed_crossings_name_their_roots(name):
    """The keyed mode on the forest's scenes (``render/volumes.py:
    volume_crossings_keyed``, the groups of 16 media included): every
    finite crossing's key names a row of its own medium, and that row's
    root of the key's slot (``ops/intersect.py:chunk_roots_rows``, the
    root the differentiable backward recomputes) equals the crossing
    within rtol 1e-4, atol 1e-4 (the root recomputed from the raw rows in
    the JAX package's association, the crossing from the packed table);
    +inf crossings carry key -1."""
    from raytrace_tpu_torch.ops.intersect import chunk_roots_rows
    world = (WORLDS[name] if name in WORLDS
             else lambda r: many_media_world(r, 17, True))
    sc = rt.compile_scene(world(rt), accel="dense", device="cpu")
    vol = sc.volumes
    vp = vol.prims
    rays = volume_rays(512, 8, (-6.0, 6.0), ())
    outs, keys = rv.volume_crossings_keyed(vol, tuple(rays.unbind(0)), 1e-3)
    n_fin = 0
    for v, (start, count) in enumerate(zip(vol.starts, vol.counts)):
        for s in (0, 1):
            t, k = outs[3 * v + 2 * s], keys[2 * v + s]
            fin = torch.isfinite(t)
            assert bool((k[~fin] == -1).all())
            k, lanes = k[fin].long(), torch.nonzero(fin)[:, 0]
            row = k // 2
            assert bool(((row >= start) & (row < start + count)).all())
            r1, r2 = chunk_roots_rows(
                vp.kind[row], vp.p0[row], vp.e1[row], vp.e2[row],
                vp.mv0[row], vp.mv1[row], vp.has_motion,
                rays[0:3, lanes].T, rays[3:6, lanes].T, rays[6, lanes],
                has_box=vp.has_box)
            root = torch.where(k % 2 == 1, r2, r1)
            np.testing.assert_allclose(root.numpy(), t[fin].numpy(),
                                       rtol=1e-4, atol=1e-4)
            n_fin += int(fin.sum())
    assert n_fin > 40
