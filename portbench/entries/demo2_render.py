"""Entry ``demo2_render``: whole images of ``pass_spp`` samples a pixel
of a configuration of spheres, boxes, textures and sphere-bounded media
(``demo2_world.py``) through ``render_accumulate``, each pass a fresh
image of samples no earlier pass drew (pass ``k``: ``spp_done = k *
pass_spp``), under the render key of the seed: ``pawn_render``'s window
on another world.  Set-up builds the world and renders one warm pass of
``warm_spp`` samples (the same route, and the same rotation where
``rotate_k_for`` gives both the same) far beyond the window's samples.

The traced window renders the next pass twice through
``forward_launches``, each launch with the drivers' ``with_stats``
counts: first under the profiler (the reading, the counts and
``medium_segments``), then under the program's recorder alone (the
seconds of each span name and the program's counters, among them
``bounce.texture_lanes``).  A count or span the program lacks reads
None.  The counts also go to standard error (``info``).

The check compares the sums of ``check_pixels`` pixels drawn from the
seed, over the last pass's samples, with the reference's
(``reference/demo2.py``) sums of the same samples, computed in blocks.

Traffic keys: ``pass_spp``, ``warm_spp``.  Cell keys: ``check_pixels``,
``check`` (the limits).
"""
from __future__ import annotations

import collections

import torch

from .. import core, demo2_world
from ..reference import demo2 as ref
from ..reference import rng as ref_rng
from .pawn_render import _launches, _next, window  # noqa: F401
from .progressive_render import check_pixels, image_gap

WORK = "demo2"


def setup(run):
    cfg, dev = run.cell.config, run.device
    with run.spans("setup.scene_build_s"):
        scene = demo2_world.scene(run.rt, cfg, dev)
        settings = demo2_world.settings(run.rt, cfg)
    warm = int(run.cell.traffic["warm_spp"])
    with run.spans("setup.warm_s"):
        run.rt.render_accumulate(scene, settings, seed=run.seed, spp=warm,
                                 spp_done=1 << 24)
        core.sync(dev)
    n_pix = settings.image_width * settings.image_height
    return dict(scene=scene, settings=settings, acc=None, spp_done=0,
                passes=0, n_pix=n_pix)


def recorded(run, st, s0: int) -> tuple[dict, dict]:
    """``(span seconds by name, counters)`` of the pass of samples from
    ``s0`` rendered under the recorder alone."""
    from raytrace_tpu_torch.utils.profiling import tracing
    acc = torch.zeros((st["n_pix"], 3), device=run.device)
    core.sync(run.device)
    with tracing() as rec:
        _launches(run, st, s0, acc, [])
        core.sync(run.device)
    out = rec.export()
    spans = collections.defaultdict(float)
    for s in out["spans"]:
        if s["end_ns"] is not None:
            spans[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    return dict(spans), out["counters"]


def traced(run, st, profile) -> dict:
    from raytrace_tpu_torch.ops.intersect_kernel import N_COLS
    scene = st["scene"]
    s0 = _next(run, st)
    acc = torch.zeros((st["n_pix"], 3), device=run.device)
    stats = []
    reading = profile(lambda: _launches(run, st, s0, acc, stats))
    st["acc"], st["spp_done"] = acc, s0
    medium = [x.get("medium_segments") for x in stats]
    rows = int(scene.prims.kind.shape[0]) + (
        0 if scene.volumes is None else int(scene.volumes.prims.kind.shape[0]))
    span_s, program = recorded(run, st, s0)
    counters = dict(
        iterations=sum(x["iterations"] for x in stats),
        segments=sum(int(x["segments"]) for x in stats),
        lane_iterations=sum(x["iterations"] * x["lanes"] for x in stats),
        medium_segments=None if None in medium else sum(map(int, medium)),
        texture_lanes=program.get("bounce.texture_lanes"),
        table_bytes=4 * N_COLS * rows, span_s=span_s)
    return dict(attempted=1, failed=int(not bool(torch.isfinite(acc).all())),
                reading=reading, counters=counters, work=WORK, info=counters)


def reference_sums(run, pix, s0: int, spp: int, dtype=torch.float32,
                   config: dict | None = None, block: int = 1 << 18):
    """The reference's radiance sums of samples ``s0 .. s0 + spp - 1`` of
    pixels ``pix`` (float64), and its counts ``(segments, medium)``;
    ``config`` in place of the cell's (a control's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dev = config or run.cell.config, run.device
    tb = ref.tables(ref.build_world(cfg), dev, dtype)
    view = ref.build_view(cfg)
    key = ref_rng.key_words(0, run.seed, dev)
    pix = pix.to(dev)
    n = pix.shape[0]
    out = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    counts = [0, 0]
    per = max(1, block // n)
    with torch.no_grad():
        for k0 in range(0, spp, per):
            k = min(per, spp - k0)
            p = pix.repeat(k).to(torch.int32)
            smp = (s0 + k0 + torch.arange(k, device=dev, dtype=torch.int32)
                   ).repeat_interleave(n)
            rad, segs, meds = ref.trace(tb, view, key, p, smp, dtype=dtype)
            out += rad.double().reshape(k, n, 3).sum(0)
            counts[0] += int(segs.sum())
            counts[1] += int(meds.sum())
    return out, tuple(counts)


def check(run, st) -> list:
    pix = check_pixels(run, st["n_pix"])
    prog = st["acc"][pix.to(st["acc"].device)].cpu()
    s0 = st["spp_done"]
    st.clear()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref_sum, _ = reference_sums(run, pix, s0,
                                int(run.cell.traffic["pass_spp"]))
    lim = run.cell.params["check"]
    return [("image_gap", image_gap(prog, ref_sum), lim["image_gap"])]
