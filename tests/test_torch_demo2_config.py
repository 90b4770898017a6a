"""The demo2 configuration and its cell (``portbench/configs/demo2.json``,
``demo2-fwd``), on the CPU.

* The frozen data compiles, through ``portbench/demo2_world.py``, to the
  tables of ``scenes/demo2.py``'s scene row for row (primitives, the
  earth's rotation, materials, textures with the image, media), its
  camera to the script's settings; the reference's own rows
  (``portbench/reference/demo2.py``) are the program's real rows.
* The stationary driver's unfused branch at rotate_k 5 (1,024 pixels,
  10 spp, depth 4: K9's, K11's, K10's and K12's plain versions) against
  the reference called directly on the same (pixel, sample) paths:
  ``image_gap`` (sum |program - reference| / sum |reference| of the
  pixel sums) at most ``GAP``, and the segments and medium scatters
  equal.  The same paths meet the same surfaces (measured: 9.3e-9, no
  pixel apart): what is left is the order of the float adds (the
  driver's float32 per lane, the reference's float64 over paths), ~1e-7
  of a sum at most, so ``GAP`` leaves a factor of 10 over that and one
  diverging path of the 10,240 moves the gap by ~1e-4, above it.  The
  reference in bfloat16 and the reference without the fog (its density
  0) read above ``GAP`` (measured 0.76 and 0.14).
* The cell end to end at a tiny size (16 x 16, depth 2, the stationary
  drivers' floor of 16,384 pixels lowered to its 256) in a process of
  its own, its traced run reading the new metrics it can read on the
  CPU.
* Each new reader reads None where its counter, span or work is
  missing; the roofline's work counted by hand.
"""
import copy
import json
import math
import subprocess
import sys

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.render import integrator as tint
from raytrace_tpu_torch.render import render as render_mod
from raytrace_tpu_torch.testing import demo2_scene, torch_threads

from portbench import core, demo2_world, rooflines, run
from portbench.reference import demo2 as ref
from portbench.reference import rng as ref_rng
from portbench.trace import Reading

SEED = 2 ** 31 + 12345
GAP = 1e-6
READERS = ["driver.iteration_ms.demo2", "device.idle.demo2",
           "glue.launches_per_iteration.demo2", "bounce.texture_ms.demo2",
           "kernels_roofline.demo2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _config(width=None):
    cfg = core.load_json(core.PKG / "configs" / "demo2.json")
    if width is not None:
        cfg["camera"]["image_width"] = width
    return cfg


def _tensor_fields(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, torch.Tensor)}


def test_config_compiles_to_the_scene_script():
    cfg = _config()
    ours = demo2_world.scene(rt, cfg, "cpu")
    theirs, s_theirs = demo2_scene(device="cpu")
    for table in ("prims", "materials", "textures"):
        a, b = getattr(ours, table), getattr(theirs, table)
        fa, fb = _tensor_fields(a), _tensor_fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (table, k)
    for f in ("kind_segments", "sphere_rots", "has_motion", "has_box", "n"):
        assert getattr(ours.prims, f) == getattr(theirs.prims, f), f
    assert ours.prims.kind.shape[0] == 1536 and ours.prims.n == 1407
    va, vb = ours.volumes, theirs.volumes
    for k, x in _tensor_fields(va).items():
        assert torch.equal(x, getattr(vb, k)), k
    for k, x in _tensor_fields(va.prims).items():
        assert torch.equal(x, getattr(vb.prims, k)), k
    assert (va.starts, va.counts) == (vb.starts, vb.counts)
    s_ours = demo2_world.settings(rt, cfg)
    for f in ("center", "look_at", "up", "redirect_prob", "redirect_q",
              "redirect_u", "redirect_v"):
        assert torch.equal(getattr(s_ours, f), getattr(s_theirs, f)), f
    for f in ("vfov", "defocus_angle", "focus_dist", "aspect_ratio",
              "image_width", "image_height", "samples_per_pixel",
              "max_depth", "rr_depth", "t_min", "background"):
        assert getattr(s_ours, f) == getattr(s_theirs, f), f
    # the cell's route: the stationary driver's split branch, K9
    assert render_mod.forward_route(ours, s_ours) == ("stationary", False)
    assert tint.bounce_route(ours, s_ours, 160000) == "split"
    assert tint.surface_engine(ours) == "K9"


def test_reference_rows_are_the_program_rows():
    cfg = _config()
    ours = demo2_world.scene(rt, cfg, "cpu")
    w = ref.build_world(cfg)
    p = ours.prims
    key = lambda x: sorted(map(tuple, x.tolist()))
    sph = p.kind == 0
    assert key(torch.cat([w.centre, w.radius[:, None]], 1)) == key(
        torch.cat([p.p0[sph], p.e1[sph, :1]], 1))
    box = p.kind == 3
    assert key(torch.cat([w.box_lo, w.box_hi], 1)) == key(
        torch.cat([p.p0[box], p.e1[box]], 1))
    pl = p.kind == 1
    assert torch.equal(torch.cat([w.planes.p0, w.planes.e1, w.planes.e2]),
                       torch.cat([p.p0[pl], p.e1[pl], p.e2[pl]]))
    (row, r9), = p.sphere_rots
    assert w.rotated[1] == r9
    assert torch.equal(w.centre[w.rotated[0]], p.p0[row])
    mv = p.mv1 != p.mv0
    assert torch.equal(w.centre[w.moving[0]], p.p0[mv.any(1)][0])
    vp = ours.volumes.prims
    assert [m["density"] for m in w.media] == [1e-4, 0.2]
    assert torch.equal(torch.tensor([m["centre"] for m in w.media]), vp.p0)
    assert torch.equal(torch.tensor([float(m["radius"]) for m in w.media]),
                       vp.e1[:, 0])
    img = ours.textures.images[0]
    h, wd = ours.textures.image_hw[0].tolist()
    assert torch.equal(w.image, img[:h, :wd])


def _reference_sums(cfg, n_pix, spp, dtype=torch.float32):
    tb = ref.tables(ref.build_world(cfg), "cpu", dtype)
    view = ref.build_view(cfg)
    pix = torch.arange(n_pix).repeat(spp).to(torch.int32)
    smp = torch.arange(spp, dtype=torch.int32).repeat_interleave(n_pix)
    rad, segs, meds = ref.trace(tb, view, ref_rng.key_words(0, SEED), pix,
                                smp, dtype=dtype)
    return (rad.double().reshape(spp, n_pix, 3).sum(0), int(segs.sum()),
            int(meds.sum()))


def _gap(prog, ref_sum):
    return float((prog.double() - ref_sum).abs().sum()
                 / ref_sum.abs().sum())


def test_unfused_stationary_branch_matches_the_reference():
    cfg = _config(32)
    scene = demo2_world.scene(rt, cfg, "cpu")
    s = demo2_world.settings(rt, cfg)
    n_pix, spp = 32 * 32, 10
    assert not tint.stationary_fused(scene, s, n_pix)
    acc, st = tint.trace_wavefront_stationary(
        scene, s, rng.base_key(SEED), n_pix, spp, rotate_k=5,
        with_stats=True)
    want, segs, meds = _reference_sums(cfg, n_pix, spp)
    assert _gap(acc, want) <= GAP
    assert int(st["segments"]) == segs and int(st["medium_segments"]) == meds
    assert 0 < meds < segs
    low, _, _ = _reference_sums(cfg, n_pix, spp, torch.bfloat16)
    assert _gap(low, want) > GAP
    fogless = copy.deepcopy(cfg)
    fogless["objects"][9]["medium"]["density"] = 0.0
    assert fogless["objects"][9]["material"] == "fog"
    thin, _, _ = _reference_sums(fogless, n_pix, spp)
    assert _gap(thin, want) > GAP


# the cell at a tiny size, in a process of its own: the run refuses a
# process that has loaded JAX, as this one has
CHILD = r"""
import sys
import torch
torch.set_num_threads(1)
from raytrace_tpu_torch.render import render
from portbench import run
render._STATIONARY_MIN_PIXELS = 256
tiny = {"config": {"camera": {"image_width": 16},
                   "render": {"max_depth": 2}},
        "traffic": {"pass_spp": 5, "warm_spp": 5},
        "cell": {"check_pixels": 64}}
line, checks, code = run.run_cell("demo2-fwd", int(sys.argv[1]), 0.0,
                                  bool(int(sys.argv[2])), device="cpu",
                                  overrides=tiny)
print(line)
sys.exit(code)
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_end_to_end(trace):
    out = subprocess.run([sys.executable, "-c", CHILD, str(SEED), str(trace)],
                         cwd=core.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["image_gap"]["value"] <= GAP
    m = res["metrics"]
    if trace:
        assert "setup.scene_build_s" in m and "setup.kernel_load_s" in m
        for name in ("driver.iteration_ms.demo2", "bounce.texture_ms.demo2"):
            assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
        # on the CPU the profiler sees no device: the device readers
        # read nothing
        for name in ("device.idle.demo2", "kernels_roofline.demo2",
                     "glue.launches_per_iteration.demo2"):
            assert name not in m
    else:
        assert m["fwd_rays_per_s"]["value"] > 0 and "setup_s" in m


def _ctx(**counters):
    base = dict(iterations=10, segments=1000, lane_iterations=2560,
                medium_segments=200, texture_lanes=100, table_bytes=1 << 10,
                span_s={"bounce.texture": 0.02})
    base.update(counters)
    return dict(spans={}, work="demo2", counters=base, reading=Reading(
        window_s=1.0, busy_s=0.25, port_kernel_s=0.2, host_launches=4500,
        device_ops=[], idle_gaps=[]))


def test_readers_read_and_fall_silent():
    got = {n: core.load_metric(n).read(_ctx()) for n in READERS}
    assert got["driver.iteration_ms.demo2"] == pytest.approx(100.0)
    assert got["device.idle.demo2"] == pytest.approx(75.0)
    assert got["glue.launches_per_iteration.demo2"] == pytest.approx(450.0)
    assert got["bounce.texture_ms.demo2"] == pytest.approx(2.0)
    assert 0 < got["kernels_roofline.demo2"] < 100
    # a program without the span, the counters, the iterations or the
    # device (the parent's: no span, no texture count): nothing to read
    silent = {
        "bounce.texture_ms.demo2": [_ctx(span_s={"driver.wait": 1.0}),
                                    _ctx(span_s=None)],
        "kernels_roofline.demo2": [_ctx(texture_lanes=None),
                                   _ctx(medium_segments=None)],
        "driver.iteration_ms.demo2": [_ctx(iterations=0)],
        "glue.launches_per_iteration.demo2": [_ctx(iterations=0)],
    }
    for name, ctxs in silent.items():
        for ctx in ctxs:
            assert core.load_metric(name).read(ctx) is None, name
    idle = _ctx()
    idle["reading"].busy_s = 0.0
    idle["reading"].host_launches = 0
    assert core.load_metric("device.idle.demo2").read(idle) is None
    assert core.load_metric(
        "glue.launches_per_iteration.demo2").read(idle) is None
    # another cell's work: none of them reads it
    assert all(core.load_metric(n).read(dict(_ctx(), work="pawn")) is None
               for n in READERS)


def test_demo2_work_by_hand():
    # 2 segments x (11 + 10 + 15) floats x 4 bytes and 490 operations,
    # 1 medium segment x 8 bytes, 3 textured lanes x (12 bytes, 4,600
    # operations), 4 iterations x a table of 100 bytes
    ops, nbytes = rooflines.work("demo2", dict(
        segments=2, medium_segments=1, texture_lanes=3, iterations=4,
        table_bytes=100))
    assert ops == 2 * 490 + 3 * 4600
    assert nbytes == 2 * 144 + 8 + 3 * 12 + 400
    c = dict(segments=10 ** 8, medium_segments=2 * 10 ** 7,
             texture_lanes=10 ** 7, iterations=700, table_bytes=4 * 36 * 1538)
    ops, nbytes = rooflines.work("demo2", c)
    # bytes bound it
    assert rooflines.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert rooflines.share("demo2", c, 2 * nbytes / 3.35e12) == \
        pytest.approx(50.0)
