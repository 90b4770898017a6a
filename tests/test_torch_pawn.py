"""The pawn deployment (``portbench/configs/pawn.json``: the stand-in pawn
as a dielectric shell around an isotropic red medium bounded by the same
mesh, on the gray fade) against the benchmark's plain reference
(``portbench/reference/media.py``), on the CPU at 24 x 24, 4 spp, depth
20.

* The sorted driver called directly traces the reference's paths: the
  image within the cell's ``image_gap`` limit, the segments and the
  ``medium_segments`` of ``with_stats`` equal to the reference's counts
  of segments and of scatters in the medium (at most the segments).
* The reference's medium through the non-convex neck: a ray that starts
  inside and one that crosses the boundary four times meet the medium
  between their first two crossings, which are the first two of a
  float64 ray-triangle scan; the renderer's plain crossings agree.
* A triangle hit against its closed form.
* With ``with_stats`` and the recorder both off, the sorted driver
  counts nothing: no counter, no medium count in the bounce, and the
  same host reads as with both on.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.ops.volume_kernel import volume_crossings_plain
from raytrace_tpu_torch.render import integrator as tint
from raytrace_tpu_torch.testing import (
    pawn_standin_mesh, pawn_standin_scene, torch_threads,
)
from raytrace_tpu_torch.utils import profiling

from portbench import core
from portbench.entries.progressive_render import image_gap
from portbench.reference import media
from portbench.reference import rng as ref_rng

WIDTH, SPP, DEPTH = 24, 4, 20
LIMIT = core.load_json(core.PKG / "cells" / "pawn-fwd.json")["check"][
    "image_gap"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def config():
    cfg = core.load_json(core.PKG / "configs" / "pawn.json")
    cfg["camera"]["image_width"] = WIDTH
    return cfg


@pytest.fixture(scope="module")
def pawn():
    return pawn_standin_scene(WIDTH, SPP, DEPTH, device="cpu")


def _reference(config, seed):
    tb = media.tables(media.build_world(config), "cpu")
    view = media.build_view(config)
    n_pix = view.width * view.height
    pix = torch.arange(n_pix, dtype=torch.int32).repeat(SPP)
    smp = torch.arange(SPP, dtype=torch.int32).repeat_interleave(n_pix)
    rad, segs, meds = media.trace(tb, view, ref_rng.key_words(0, seed), pix,
                                  smp)
    return (rad.double().reshape(SPP, n_pix, 3).sum(0), int(segs.sum()),
            int(meds.sum()))


@pytest.mark.parametrize("seed", [2 ** 31 + 12345, 55])
def test_sorted_driver_against_the_reference(pawn, config, seed):
    scene, s = pawn
    n_pix = WIDTH * WIDTH
    acc, st = tint.trace_wavefront_sorted(scene, s, rng.base_key(seed),
                                          n_pix, SPP, with_stats=True)
    ref, segs, meds = _reference(config, seed)
    assert image_gap(acc, ref) <= LIMIT
    assert int(st["segments"]) == segs
    assert st["medium_segments"].dtype == torch.int64
    assert st["medium_segments"].dim() == 0
    assert int(st["medium_segments"]) == meds
    assert 0 < meds <= segs


def _scan_f64(o, d):
    """Every crossing of the stand-in pawn's boundary by the ray ``o +
    t d`` in float64 (Moller-Trumbore), sorted, with whether it enters
    (against the outward normal)."""
    v, f = pawn_standin_mesh()
    p0, p1, p2 = (v[f[:, k]] for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    h = np.cross(d, e2)
    a = np.einsum("ij,ij->i", e1, h)
    ok = np.abs(a) > 1e-12
    s = o - p0
    u = np.einsum("ij,ij->i", s, h) / np.where(ok, a, 1.0)
    q = np.cross(s, e1)
    w = (q @ d) / np.where(ok, a, 1.0)
    t = np.einsum("ij,ij->i", e2, q) / np.where(ok, a, 1.0)
    hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > 1e-3)
    enters = np.cross(e1, e2) @ d < 0
    order = np.argsort(t[hit])
    return t[hit][order], enters[hit][order]


# through the neck (the collar's radius 0.9 at heights 3.05-3.25 between
# radii 0.5 below and above): a ray from the collar's inside, and one
# rising at radius 0.66 between two vertex angles, which enters the
# collar, leaves it, enters the head and leaves it
NECK_RAYS = {
    "inside": ([0.1, 3.15, 0.05], [0.8, 0.02, 0.3]),
    "four_crossings": ([0.66 * np.cos(0.0785), 2.6, 0.66 * np.sin(0.0785)],
                       [0.02, 1.0, 0.01]),
}


@pytest.mark.parametrize("case", sorted(NECK_RAYS))
def test_medium_meets_the_first_two_crossings(config, case):
    o, d = (np.asarray(x, np.float64) for x in NECK_RAYS[case])
    d = d / np.linalg.norm(d)
    ts, enters = _scan_f64(o, d)
    assert len(ts) == (1 if case == "inside" else 4)
    tb = media.tables(media.build_world(config), "cpu")
    ot = tuple(torch.tensor([x], dtype=torch.float32) for x in o)
    dt = tuple(torch.tensor([x], dtype=torch.float32) for x in d)
    t1, front1, t2 = media.crossings(tb.media[0], ot, dt, 1e-3)
    np.testing.assert_allclose(float(t1), ts[0], rtol=1e-5)
    assert bool(front1) == bool(enters[0]) == (case != "inside")
    if case == "inside":
        assert float(t2) == float("inf")
        entry, exit_t = 1e-3, ts[0]
    else:
        np.testing.assert_allclose(float(t2), ts[1], rtol=1e-5)
        assert not enters[1] and enters[2] and not enters[3]
        entry, exit_t = ts[0], ts[1]
    # the flight lands between them for every draw that scatters, and
    # a draw too small to scatter passes through
    neg = tb.neg_inv_density[0]
    for u in (0.999, 0.5, 0.2):
        c = float(media.flight(neg, t1, front1, t2, 1e-3,
                               torch.tensor([u])))
        dist = -np.log(u) / 5.0
        if dist < exit_t - entry:
            np.testing.assert_allclose(c, entry + dist, rtol=1e-5)
        else:
            assert c == float("inf")
    assert float(media.flight(neg, t1, front1, t2, 1e-3,
                              torch.tensor([1e-30]))) == float("inf")
    # the renderer's plain crossings: the same triple
    scene, _ = pawn_standin_scene(WIDTH, SPP, DEPTH, device="cpu")
    vol = scene.volumes
    from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
    outs = volume_crossings_plain(
        pack_prims(vol.prims), *ot, *dt, torch.zeros(1),
        slices=tuple(zip(vol.starts, vol.counts)), t_min=1e-3,
        has_motion=False, has_box=False)
    assert float(outs[0]) == float(t1)
    assert (float(outs[1]) > 0.5) == bool(front1)
    assert float(outs[2]) == float(t2)


def test_triangle_hit_closed_form(config):
    cfg = dict(config, meshes={"tri": {
        "vertices": [[0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]],
        "faces": [[0, 1, 2]]}}, objects=[{"mesh": "tri", "material": "glass"}])
    tb = media.tables(media.build_world(cfg), "cpu")
    # rays (as columns): straight down at (0.25, 0.25); tilted from
    # (0.9, 0.2) to land at a + b = 0.52; up and away; down at (0.75,
    # 0.75), outside the hypotenuse
    o = tuple(torch.tensor(x) for x in ([0.25, 0.9, 0.1, 0.75],
                                        [0.25, 0.2, 0.2, 0.75],
                                        [0.0, 0.0, 0.0, 0.0]))
    d = tuple(torch.tensor(x) for x in ([0.0, -0.28, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.0],
                                        [-1.0, -0.96, 1.0, -1.0]))
    t, row = media.nearest(tb.surface, o, d, 1e-3)
    assert float(t[0]) == 2.0
    np.testing.assert_allclose(float(t[1]), 2.0 / 0.96, rtol=1e-6)
    assert float(t[2]) == float(t[3]) == float("inf")
    assert row.tolist() == [0, 0, 0, 0]


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched and the host reads among them."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_counting_off_adds_nothing(pawn, monkeypatch):
    scene, s = pawn
    key = rng.base_key(3)
    got = []
    split = tint.bounce_split_soa

    def spy(*a, medium_count=None, **kw):
        got.append(medium_count)
        return split(*a, medium_count=medium_count, **kw)
    monkeypatch.setattr(tint, "bounce_split_soa", spy)

    def run(**kw):
        got.clear()
        with _Ops() as ops:
            acc = tint.trace_wavefront_sorted(scene, s, key, 256, 2, **kw)
        return acc, ops, list(got)

    def refuse(*a):
        raise AssertionError("counted with the recorder off")
    with monkeypatch.context() as m:
        m.setattr(profiling, "count", refuse)
        off, ops_off, counts_off = run()
    assert counts_off and all(c is None for c in counts_off)
    with profiling.tracing() as rec:
        (on, st), ops_on, counts_on = run(with_stats=True)
    assert all(c is st["medium_segments"] for c in counts_on)
    assert rec.export()["counters"] == {
        "driver.medium_segments": int(st["medium_segments"])}
    # the counts add operators, and no host read
    assert ops_off.reads == ops_on.reads
    assert ops_off.ops < ops_on.ops
    assert torch.equal(off, on)
