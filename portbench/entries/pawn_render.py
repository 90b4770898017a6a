"""Entry ``pawn_render``: whole images of ``pass_spp`` samples a pixel
over a configuration of meshes and media (``media_world.py``) through
``render_accumulate``, each pass a fresh image of samples no earlier
pass drew (pass ``k``: ``acc=None``, ``spp_done = k * pass_spp``), under
the render key of the seed.  Set-up builds the world and renders one
warm pass of ``warm_spp`` samples (the same route) far beyond the
window's samples.  The window runs whole passes until ``--seconds``
have passed; each pass ends with a synchronize.

The traced window renders the next pass twice through
``forward_launches``, the plan of launches ``render_accumulate``
iterates, each launch with the drivers' ``with_stats`` counts: first
under the profiler (the reading and the counts), then under the
program's recorder alone (``utils/profiling.py:tracing``: the seconds
of each span name), so that the recorder never shares a window with
the profiler.  A count or span the program lacks reads None.  The
counts also go to standard error (``info``).

The check compares the sums of ``check_pixels`` pixels drawn from the
seed, over the last pass's samples, with the reference's
(``reference/media.py``) sums of the same samples, computed in blocks.

Traffic keys: ``pass_spp``, ``warm_spp``.  Cell keys: ``check_pixels``,
``check`` (the limits).
"""
from __future__ import annotations

import collections
import time

import torch

from .. import core, media_world
from ..reference import media
from ..reference import rng as ref_rng
from .progressive_render import check_pixels, image_gap


def setup(run):
    cfg, dev = run.cell.config, run.device
    with run.spans("setup.scene_build_s"):
        scene = media_world.scene(run.rt, cfg, dev)
        settings = media_world.settings(run.rt, cfg)
    warm = int(run.cell.traffic["warm_spp"])
    with run.spans("setup.warm_s"):
        run.rt.render_accumulate(scene, settings, seed=run.seed, spp=warm,
                                 spp_done=1 << 24)
        core.sync(dev)
    n_pix = settings.image_width * settings.image_height
    return dict(scene=scene, settings=settings, acc=None, spp_done=0,
                passes=0, n_pix=n_pix)


def _next(run, st) -> int:
    """The first sample of the next pass; counts the pass."""
    s0 = st["passes"] * int(run.cell.traffic["pass_spp"])
    st["passes"] += 1
    return s0


def _pass(run, st):
    spp = int(run.cell.traffic["pass_spp"])
    s0 = _next(run, st)
    st["acc"], _ = run.rt.render_accumulate(
        st["scene"], st["settings"], seed=run.seed, spp=spp, spp_done=s0)
    st["spp_done"] = s0
    return st["n_pix"] * spp


def window(run, st, seconds: float) -> dict:
    rays, busy, passes, walls = 0, 0.0, 0, []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        rays += _pass(run, st)
        core.sync(run.device)
        t1 = time.perf_counter()
        busy += t1 - t0
        walls.append(t1 - t0)
        passes += 1
        if t1 - t_start >= seconds:
            break
    failed = int(not bool(torch.isfinite(st["acc"]).all()))
    return dict(attempted=passes, failed=failed,
                metrics=dict(fwd_rays_per_s=rays / busy),
                info=dict(passes=passes, window_s=busy, pass_s=walls))


def _launches(run, st, s0: int, acc, stats: list):
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.render.render import forward_launches
    for _, off, bp, _, launch in forward_launches(
            st["scene"], st["settings"], rng.base_key(run.seed, run.device),
            int(run.cell.traffic["pass_spp"]), spp_done=s0):
        out, st_ = launch(with_stats=True)
        acc[off:off + bp] += out
        stats.append(st_)


def span_seconds(run, st, s0: int) -> dict:
    """Seconds of each program span name over the pass of samples from
    ``s0`` rendered under the recorder alone."""
    from raytrace_tpu_torch.utils.profiling import tracing
    acc = torch.zeros((st["n_pix"], 3), device=run.device)
    core.sync(run.device)
    with tracing() as rec:
        _launches(run, st, s0, acc, [])
        core.sync(run.device)
    out = collections.defaultdict(float)
    for s in rec.export()["spans"]:
        if s["end_ns"] is not None:
            out[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    return dict(out)


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
    counters = dict(
        iterations=sum(x["iterations"] for x in stats),
        segments=sum(int(x["segments"]) for x in stats),
        lane_iterations=sum(x["iterations"] * x["lanes"] for x in stats),
        medium_segments=None if None in medium else sum(map(int, medium)),
        table_bytes=4 * N_COLS * rows,
        span_s=span_seconds(run, st, s0))
    return dict(attempted=1, failed=int(not bool(torch.isfinite(acc).all())),
                reading=reading, counters=counters, work="pawn",
                info=counters)


def reference_sums(run, pix, s0: int, spp: int, dtype=torch.float32,
                   config: dict | None = None, block: int = 1 << 18):
    """The reference's radiance sums of samples ``s0 .. s0 + spp - 1`` of
    pixels ``pix`` (float64), and its counts ``(segments, medium)``;
    ``config`` in place of the cell's (a control's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dev = config or run.cell.config, run.device
    tb = media.tables(media.build_world(cfg), dev, dtype)
    view = media.build_view(cfg)
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
            rad, segs, meds = media.trace(tb, view, key, p, smp, dtype=dtype)
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
    ref, _ = reference_sums(run, pix, s0, int(run.cell.traffic["pass_spp"]))
    lim = run.cell.params["check"]
    return [("image_gap", image_gap(prog, ref), lim["image_gap"])]
