"""The port's checkpoints, render counters and timer
(``raytrace_tpu_torch/utils``) against the JAX package's.

* A checkpoint the JAX package writes (its ``render_accumulate`` of the
  Cornell box, 2 of 4 spp) resumes in the port's ``render_resumable``,
  and the image is the port's direct 4-spp render within
  ``tests/test_torch_render.py``'s bound (the JAX half carries XLA's
  contracted multiply-adds); a checkpoint the port writes loads in the
  JAX package with the same keys, exactly.
* ``render_resumable`` in checkpoints of 2 spp equals the direct render
  (the same paths; the queue driver sums them in another order: atol
  1e-5), and resuming a finished checkpoint renders nothing more.
* ``RenderStats`` gives the JAX package's record for the same launches,
  with the port's ``engine_report``.
"""
import numpy as np
import pytest
import torch

from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu.utils import checkpoint as jck
from raytrace_tpu.utils.profiling import RenderStats as JRenderStats
from raytrace_tpu_torch.interop import (
    fields_to_numpy, scene_from_numpy, scene_to_numpy, settings_from_numpy,
)
from raytrace_tpu_torch.render.render import render
from raytrace_tpu_torch.testing import torch_threads
from raytrace_tpu_torch.utils.checkpoint import (
    load_checkpoint, render_resumable, save_checkpoint,
)
from raytrace_tpu_torch.utils.engines import engine_report
from raytrace_tpu_torch.utils.profiling import RenderStats, Timer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _cornell(width=16, spp=4, depth=4):
    js, jset = _cornell_scene_and_settings(width, spp, depth)
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    return (js, jset, scene_from_numpy(scene_to_numpy(js), device="cpu"),
            settings_from_numpy(d))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    js, jset, ts, tset = _cornell()
    path = str(tmp_path / "jax.npz")
    jacc, jn = jrender(js, jset, 3, spp=2)
    jck.save_checkpoint(path, jacc, jn, meta={"scene": "cornell"})
    img = render_resumable(ts, tset, path, seed=3, spp=4,
                           spp_per_checkpoint=2)
    direct = render(ts, tset, seed=3, spp=4).numpy()
    assert img.shape == direct.shape == (16, 16, 3)
    diff = np.abs(img - direct).max(axis=-1)
    assert (diff > 1e-5).mean() < 0.05 and np.median(diff) <= 1e-6
    np.testing.assert_allclose(img.mean(), direct.mean(), rtol=2e-3)
    acc, done = load_checkpoint(path, device="cpu")
    assert done == 4 and acc.dtype == torch.float32
    # the port's checkpoint, read by the JAX package
    jacc2, jdone = jck.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jacc2), acc.numpy())
    assert jdone == 4


def test_render_resumable_matches_direct(tmp_path):
    _, _, ts, tset = _cornell()
    path = str(tmp_path / "r.npz")
    img = render_resumable(ts, tset, path, seed=5, spp_per_checkpoint=2)
    direct = render(ts, tset, seed=5).numpy()
    np.testing.assert_allclose(img, direct, atol=1e-5, rtol=1e-5)
    acc, done = load_checkpoint(path, device="cpu")
    assert done == 4
    img2 = render_resumable(ts, tset, path, seed=5)     # already complete
    np.testing.assert_array_equal(img2, img)
    save_checkpoint(path, acc, done, meta={"note": "x"})
    assert set(np.load(path)) == {"acc", "spp_done", "meta_note"}


def test_render_stats_matches_jax():
    _, _, ts, tset = _cornell(width=128, spp=8)
    ours, theirs = RenderStats(), JRenderStats()
    for st in (ours, theirs):
        st.add_launch(dict(segments=1000, iterations=10, lanes=200), 300,
                      0.5)
        st.add_launch(dict(segments=500, iterations=5, lanes=200), 100, 0.5)
    assert ours.record() == theirs.record()
    rep = ours.record_engines(ts, tset)
    assert rep == engine_report(ts, tset) and rep["forward"] == "kernel-B"
    assert ours.record()["engines"] == rep
    assert np.isclose(ours.occupancy, 0.5)
    assert np.isclose(ours.mean_path_length, 3.75)


def test_timer_on_the_cpu():
    with Timer(torch.zeros(3)) as t:
        torch.ones(100).sum()
    assert not t.cuda and 0.0 <= t.elapsed < 5.0
    with Timer() as t2:
        pass
    assert t2.elapsed >= 0.0
    assert Timer("cuda:0").cuda
