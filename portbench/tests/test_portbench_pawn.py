"""The pawn configuration and its cell (``configs/pawn.json``,
``pawn-fwd``): the frozen data compiles to the repository's stand-in
pawn scene row for row; the cell runs end to end on the CPU at a tiny
size, its driver lowered to the sorted one; each new reader reads None
where its counter or span is missing; the work count by hand."""
import json
import math

import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.render import render as render_mod
from raytrace_tpu_torch.testing import (
    pawn_standin_settings, pawn_standin_world,
)

from portbench import core, media_world, rooflines, run
from portbench.reference import media
from portbench.trace import Reading

SEED = 2 ** 31 + 12345
TINY = {"config": {"camera": {"image_width": 16},
                   "render": {"max_depth": 8}},
        "traffic": {"pass_spp": 4, "warm_spp": 2},
        "cell": {"check_pixels": 64}}
READERS = ["device.idle.pawn", "driver.iteration_ms.pawn",
           "driver.rebin_ms.pawn", "kernels_roofline.pawn"]


def _config():
    return core.load_json(core.PKG / "configs" / "pawn.json")


def _tensor_fields(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, torch.Tensor)}


def test_config_compiles_to_the_standin_scene():
    cfg = _config()
    ours = media_world.scene(rt, cfg, "cpu")
    theirs = rt.compile_scene(pawn_standin_world(rt), device="cpu")
    for table in ("prims", "materials", "textures"):
        a, b = getattr(ours, table), getattr(theirs, table)
        fa, fb = _tensor_fields(a), _tensor_fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (table, k)
    assert ours.prims.kind_segments == theirs.prims.kind_segments
    va, vb = ours.volumes, theirs.volumes
    for k, x in _tensor_fields(va).items():
        assert torch.equal(x, getattr(vb, k)), k
    for k, x in _tensor_fields(va.prims).items():
        assert torch.equal(x, getattr(vb.prims, k)), k
    assert (va.starts, va.counts) == (vb.starts, vb.counts)
    s_ours = media_world.settings(rt, cfg)
    s_theirs = pawn_standin_settings(rt, 500, 400, 20)
    for f in ("center", "look_at", "up"):
        assert torch.equal(getattr(s_ours, f), getattr(s_theirs, f)), f
    for f in ("vfov", "defocus_angle", "focus_dist", "aspect_ratio",
              "image_width", "image_height", "samples_per_pixel",
              "max_depth", "rr_depth", "t_min", "n_redirect"):
        assert getattr(s_ours, f) == getattr(s_theirs, f), f
    assert s_ours.background is rt.gray_fade is s_theirs.background


def test_reference_rows_are_the_program_rows():
    """The reference's shell and boundary rows, in face order, are the
    program's real rows (the shell's in its BVH order)."""
    cfg = _config()
    ours = media_world.scene(rt, cfg, "cpu")
    w = media.build_world(cfg)
    real = ours.prims.kind >= 0
    key = lambda p0, e1, e2: sorted(map(tuple, torch.cat(
        [p0, e1, e2], 1).tolist()))
    s = w.surface
    assert key(s.p0, s.e1, s.e2) == key(ours.prims.p0[real],
                                       ours.prims.e1[real],
                                       ours.prims.e2[real])
    b, vp = w.boundaries[0], ours.volumes.prims
    for x, y in ((b.p0, vp.p0), (b.e1, vp.e1), (b.e2, vp.e2)):
        assert torch.equal(x, y)
    assert w.density == [5.0] and w.colour == [[1.0, 0.0, 0.0]]
    assert s.param.tolist() == [1.5]


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_end_to_end(trace, monkeypatch):
    monkeypatch.setattr(render_mod, "_STATIONARY_MIN_PIXELS", 256)
    line, checks, code = run.run_cell("pawn-fwd", SEED, 0.0, bool(trace),
                                      device="cpu", overrides=TINY)
    out = json.loads(line)
    assert code == 0 and out["correct"] and out["failed"] == 0
    assert checks[0][0] == "image_gap" and checks[0][1] <= checks[0][2]
    m = out["metrics"]
    if trace:
        assert "setup.scene_build_s" in m and "setup.kernel_load_s" in m
        # on the CPU the profiler sees no device: the device readers
        # read nothing
        for name in ("driver.iteration_ms.pawn", "driver.rebin_ms.pawn"):
            assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
        assert "device.idle.pawn" not in m
        assert "kernels_roofline.pawn" not in m
    else:
        assert m["fwd_rays_per_s"]["value"] > 0 and "setup_s" in m


def _ctx(**counters):
    base = dict(iterations=10, segments=1000, lane_iterations=2560,
                medium_segments=600, table_bytes=1 << 10,
                span_s={"driver.rebin": 0.01})
    base.update(counters)
    return dict(spans={}, work="pawn", counters=base, reading=Reading(
        window_s=1.0, busy_s=0.5, port_kernel_s=0.25, host_launches=100,
        device_ops=[], idle_gaps=[]))


def test_readers_read_and_fall_silent():
    ctx = _ctx()
    got = {n: core.load_metric(n).read(ctx) for n in READERS}
    assert got["device.idle.pawn"] == pytest.approx(50.0)
    assert got["driver.iteration_ms.pawn"] == pytest.approx(100.0)
    assert got["driver.rebin_ms.pawn"] == pytest.approx(1.0)
    assert 0 < got["kernels_roofline.pawn"] < 100
    # a program without the span, the counter, the iterations or the
    # device: nothing to read
    assert core.load_metric("driver.rebin_ms.pawn").read(
        _ctx(span_s={"driver.iteration": 1.0})) is None
    assert core.load_metric("driver.rebin_ms.pawn").read(
        _ctx(span_s=None)) is None
    assert core.load_metric("kernels_roofline.pawn").read(
        _ctx(medium_segments=None)) is None
    assert core.load_metric("driver.iteration_ms.pawn").read(
        _ctx(iterations=0)) is None
    idle = _ctx()
    idle["reading"].busy_s = 0.0
    assert core.load_metric("device.idle.pawn").read(idle) is None
    # another cell's work: none of them reads it
    other = dict(_ctx(), work="fwd")
    assert all(core.load_metric(n).read(other) is None for n in READERS)


def test_pawn_work_by_hand():
    # 2 segments x (11 + 9 + 15) floats x 4 bytes, 1 medium segment x 8
    # bytes, 3 iterations x a table of 100 bytes; 2 x 470 operations
    ops, nbytes = rooflines.work("pawn", dict(
        segments=2, medium_segments=1, iterations=3, table_bytes=100))
    assert ops == 940 and nbytes == 2 * 140 + 8 + 300
    c = dict(segments=10 ** 9, medium_segments=6 * 10 ** 8,
             iterations=2000, table_bytes=4 * 36 * 2416)
    ops, nbytes = rooflines.work("pawn", c)
    assert rooflines.bound_s(ops, nbytes) == pytest.approx(
        nbytes / 3.35e12)
    assert rooflines.share("pawn", c, 4 * nbytes / 3.35e12) == \
        pytest.approx(25.0)
    assert np.isfinite(ops)
