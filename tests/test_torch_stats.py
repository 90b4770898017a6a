"""The forward drivers' ``with_stats`` (``render/integrator.py``) and the
render counters fed by them (``utils/profiling.py``), on the CPU.

* Against the JAX package's drivers with ``with_stats=True`` on the
  Cornell box carried over with ``interop`` (depth 8, seed 1): the
  stationary driver at 32 x 32, 8 spp, rotate_k 1 and 8 (the port's
  fused branch, kernel B's plain version, in its rotated mode at 8; JAX's
  CPU run takes its XLA body unrotated and kernel A's rotated, which
  count the same lanes), and the work queue at 32 x 32, 4 spp, 256
  lanes.  ``lanes`` equal;
  ``iterations`` within 2% and ``segments`` within 1%.  XLA's CPU backend
  contracts multiply-adds, so ~0.5% of paths resolve a grazing hit
  differently (``tests/test_torch_render.py``): here 3.8% of the 1,024
  pixels at 8 spp and 2.1% at 4 spp differ, about 40 and 22 of the 8,192
  and 4,096 paths.  Each such path changes the segment count by its change
  of length, at most ``max_depth - 1`` = 7 and 3.2 on average, so by ~130
  of 25,900 segments (0.5%; measured 28, 0.11%, and 2 of 12,870).  A
  lane's iterations move only where a differing path lies on the longest
  lane (measured: equal counts, 49, 50 and 56).  The sorted driver is
  held against JAX's in ``tests/test_torch_sorted.py``.
* ``RenderStats.record()`` fed the port's dicts equals JAX's fed JAX's
  dicts, its rates and ratios within the same 1%.
* Exact identities at ``max_depth`` 1, where every path is one segment
  (20 x 20 pixels on 512 lanes, 3 spp): the stationary driver unrotated
  runs ``spp`` iterations of ``n_pix`` segments (its 112 padding lanes
  idle), rotated ``spp`` iterations of every lane (the padding lanes
  trace dummy pixels); the work queue (256 lanes) and the sorted driver
  (the pawn stand-in) run ``ceil(n_pix * spp / lanes)`` iterations of
  ``n_pix * spp`` segments.
* Every branch's image is bit-equal with and without ``with_stats``
  (fused, rotated, queue, sorted), and ``segments`` is a 0-d int64 tensor.
* ``render_with_stats`` equals ``render_accumulate`` bit for bit over a
  two-band stationary render, a queue render of two sample chunks and a
  sorted render (the pawn stand-in at 16 x 16, the stationary drivers'
  floor of 16,384 pixels lowered to its 256), one dict a launch, and
  its counters add up.
"""
import numpy as np
import pytest
import torch

from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render import integrator as jint
from raytrace_tpu.utils.profiling import RenderStats as JRenderStats
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.interop import (
    fields_to_numpy, scene_from_numpy, scene_to_numpy, settings_from_numpy,
)
from raytrace_tpu_torch.render import integrator as tint
from raytrace_tpu_torch.render import render as render_mod
from raytrace_tpu_torch.render.render import (
    forward_driver, render_accumulate, row_bands,
)
from raytrace_tpu_torch.testing import (
    cornell_scene_and_settings, pawn_standin_scene, torch_threads,
)
from raytrace_tpu_torch.utils.profiling import RenderStats, render_with_stats

# the bounds on the counts against JAX's (module docstring)
ITER_RTOL = 0.02
SEG_RTOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def cornell():
    js, jset = _cornell_scene_and_settings(32, 8, 8)
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    return (js, jset, scene_from_numpy(scene_to_numpy(js), device="cpu"),
            settings_from_numpy(d))


# (driver, spp, keyword arguments of both packages' calls)
JAX_CASES = {
    "fused": ("stationary", 8, dict(rotate_k=1)),
    "rotated": ("stationary", 8, dict(rotate_k=8)),
    "queue": ("queue", 4, dict(n_lanes=256)),
}


def _run(pkg, driver, scene, settings, key, n_pix, spp, kw, **stats):
    if driver == "queue":
        return pkg.trace_wavefront(scene, settings, key, n_pix, spp,
                                   kw["n_lanes"], **stats)
    return pkg.trace_wavefront_stationary(scene, settings, key, n_pix, spp,
                                          rotate_k=kw["rotate_k"], **stats)


def assert_counts_close(got, want):
    """``got`` (the port's dict) against ``want`` (JAX's) within the
    module's bounds."""
    assert int(got["lanes"]) == int(want["lanes"])
    for name, rtol in (("iterations", ITER_RTOL), ("segments", SEG_RTOL)):
        a, b = int(got[name]), int(want[name])
        assert abs(a - b) <= rtol * b, (name, a, b)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_stats_match_jax(cornell, case):
    js, jset, ts, tset = cornell
    driver, spp, kw = JAX_CASES[case]
    n_pix = 32 * 32
    if driver == "stationary":
        assert tint.stationary_fused(ts, tset, n_pix)
    jacc, jst = _run(jint, driver, js, jset, jrng.base_key(1), n_pix, spp,
                     kw, with_stats=True)
    tacc, tst = _run(tint, driver, ts, tset, rng.base_key(1), n_pix, spp,
                     kw, with_stats=True)
    assert set(tst) == set(jst) == {"iterations", "segments", "lanes"}
    assert tst["segments"].dtype == torch.int64 and tst["segments"].dim() == 0
    assert_counts_close(tst, jst)
    # the image: bit-equal without the flag; JAX's within the bounds of
    # tests/test_torch_render.py
    assert torch.equal(tacc, _run(tint, driver, ts, tset, rng.base_key(1),
                                  n_pix, spp, kw))
    diff = np.abs(np.asarray(jacc) - tacc.numpy()).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05 and np.median(diff) <= 1e-6

    # the render counters fed each package's dict, the same launch
    ours, theirs = RenderStats(), JRenderStats()
    ours.add_launch(tst, n_pix * spp, 0.5)
    theirs.add_launch(jst, n_pix * spp, 0.5)
    a, b = ours.record(), theirs.record()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=SEG_RTOL, err_msg=k)
    assert 0.0 < ours.occupancy <= 1.0 and ours.mean_path_length > 1.0


@pytest.fixture(scope="module")
def depth_one():
    scene, s = cornell_scene_and_settings(20, 3, 1, device="cpu")
    return scene, s, rng.base_key(4)


@pytest.mark.parametrize("driver,rotate_k", [
    ("stationary", 1), ("stationary", 3), ("queue", 1)])
def test_depth_one_identities(depth_one, driver, rotate_k):
    scene, s, key = depth_one
    n_pix, spp = 400, 3
    if driver == "queue":
        acc, st = tint.trace_wavefront(scene, s, key, n_pix, spp, 256,
                                       with_stats=True)
        plain = tint.trace_wavefront(scene, s, key, n_pix, spp, 256)
        assert st["lanes"] == 256
        assert st["iterations"] == -(-n_pix * spp // 256)
        assert int(st["segments"]) == n_pix * spp
    else:
        # both fused: kernel B, in its rotated mode at rotate_k 3
        assert tint.stationary_fused(scene, s, n_pix)
        acc, st = tint.trace_wavefront_stationary(
            scene, s, key, n_pix, spp, rotate_k=rotate_k, with_stats=True)
        plain = tint.trace_wavefront_stationary(scene, s, key, n_pix, spp,
                                                rotate_k=rotate_k)
        assert st["lanes"] == 512 and st["iterations"] == spp
        # unrotated, the padding lanes idle; rotated, every lane works
        working = n_pix if rotate_k == 1 else 512
        assert int(st["segments"]) == working * spp
    assert torch.equal(acc, plain)


@pytest.fixture(scope="module")
def pawn():
    return pawn_standin_scene(16, 2, 4, device="cpu")


def test_sorted_stats(pawn):
    """The sorted driver: bit-equal with and without the flag at the
    scene's depth; at depth 1 ``ceil(n_pix * spp / lanes)`` iterations of
    ``n_pix * spp`` segments."""
    scene, s = pawn
    key = rng.base_key(2)
    acc, st = tint.trace_wavefront_sorted(scene, s, key, 256, 2,
                                          with_stats=True)
    assert torch.equal(acc, tint.trace_wavefront_sorted(scene, s, key, 256,
                                                        2))
    assert st["lanes"] == 256
    assert 256 * 2 <= int(st["segments"]) <= 256 * st["iterations"]
    _, st1 = tint.trace_wavefront_sorted(scene, s.replace(max_depth=1), key,
                                         200, 3, with_stats=True)
    assert st1["lanes"] == 256 and st1["iterations"] == -(-600 // 256)
    assert int(st1["segments"]) == 600


@pytest.mark.parametrize("case", ["stationary_bands", "queue_chunks",
                                  "sorted"])
def test_render_with_stats_equals_render_accumulate(pawn, case, monkeypatch):
    if case == "stationary_bands":
        # 256 x 128 in two bands of 16,384 pixels, rotate_k 2
        scene, s = cornell_scene_and_settings(256, 2, 2, device="cpu")
        s = s.replace(aspect_ratio=2.0)
        kw, driver, launches = dict(max_band=1 << 14), "stationary", 2
    elif case == "queue_chunks":
        # 32 x 32 at 8 spp on 128 lanes: two chunks of 4 samples
        scene, s = cornell_scene_and_settings(32, 8, 4, device="cpu")
        kw, driver, launches = dict(n_lanes=128), "queue", 2
    else:
        # the pawn stand-in's 256 pixels, the stationary drivers' floor
        # lowered to them
        monkeypatch.setattr(render_mod, "_STATIONARY_MIN_PIXELS", 256)
        scene, s = pawn
        kw, driver, launches = {}, "sorted", 1
    n_pix = s.image_width * s.image_height
    spp = s.samples_per_pixel
    bands = row_bands(s.image_height, s.image_width,
                      kw.get("max_band", 1 << 19))
    assert forward_driver(scene, bands[0][1]) == driver
    dicts = []
    add = RenderStats.add_launch

    def spy(self, st, *a):
        dicts.append(st)
        add(self, st, *a)
    monkeypatch.setattr(RenderStats, "add_launch", spy)
    acc, stats = render_with_stats(scene, s, 3, **kw)
    ref, _ = render_accumulate(scene, s, 3, **kw)
    assert torch.equal(acc, ref)
    assert len(dicts) == launches
    assert stats.primary_rays == n_pix * spp
    assert stats.iterations == sum(d["iterations"] for d in dicts)
    assert stats.path_segments == sum(int(d["segments"]) for d in dicts)
    assert n_pix * spp <= stats.path_segments <= stats.lane_iterations
    assert 0.0 < stats.occupancy <= 1.0 and stats.wall_s > 0.0
