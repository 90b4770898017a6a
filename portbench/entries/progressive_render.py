"""Entry ``progressive_render``: passes of ``pass_spp`` samples a pixel
over the whole image through ``render_accumulate``, each resuming the
sums of the last (``acc=``, ``spp_done=``), under the render key of the
seed.  Set-up renders one warm pass of ``warm_spp`` samples (the same
route and rotation).  The window runs whole passes until ``--seconds``
have passed; each pass ends with a synchronize.

The traced window renders one pass through ``forward_launches``, the
plan of launches ``render_accumulate`` iterates, each launch with the
drivers' ``with_stats`` counts.

The check compares the sums of ``check_pixels`` pixels drawn from the
seed with the reference's sums of the same samples.

Traffic keys: ``pass_spp``, ``warm_spp``.  Cell keys: ``check_pixels``,
``check`` (the limits).
"""
from __future__ import annotations

import time

import torch

from .. import core
from ..reference import rng as ref_rng
from ..reference import scene as ref_scene
from ..reference import tracer


def setup(run):
    from .. import world as W
    cfg, dev = run.cell.config, run.device
    with run.spans("setup.scene_build_s"):
        scene = W.scene(run.rt, cfg, dev)
        settings = W.settings(run.rt, cfg)
    warm = int(run.cell.traffic["warm_spp"])
    with run.spans("setup.warm_s"):
        run.rt.render_accumulate(scene, settings, seed=run.seed, spp=warm,
                                 spp_done=1 << 20)
        core.sync(dev)
    n_pix = settings.image_width * settings.image_height
    return dict(scene=scene, settings=settings, acc=None, spp_done=0,
                n_pix=n_pix)


def _pass(run, st):
    spp = int(run.cell.traffic["pass_spp"])
    st["acc"], st["spp_done"] = run.rt.render_accumulate(
        st["scene"], st["settings"], seed=run.seed, spp=spp, acc=st["acc"],
        spp_done=st["spp_done"])
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


def traced(run, st, profile) -> dict:
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops.intersect_kernel import N_COLS
    from raytrace_tpu_torch.render.render import forward_launches
    spp = int(run.cell.traffic["pass_spp"])
    scene, s, dev = st["scene"], st["settings"], run.device
    acc = torch.zeros((st["n_pix"], 3), device=dev)
    stats = []

    def go():
        for _, off, bp, _, launch in forward_launches(
                scene, s, rng.base_key(run.seed, dev), spp):
            out, st_ = launch(with_stats=True)
            acc[off:off + bp] += out
            stats.append(st_)

    reading = profile(go)
    st["acc"], st["spp_done"] = acc, spp
    counters = dict(
        iterations=sum(x["iterations"] for x in stats),
        segments=sum(int(x["segments"]) for x in stats),
        lane_iterations=sum(x["iterations"] * x["lanes"] for x in stats),
        table_bytes=4 * N_COLS * int(scene.prims.kind.shape[0]))
    return dict(attempted=1, failed=int(not bool(torch.isfinite(acc).all())),
                reading=reading, counters=counters, work="fwd")


def check_pixels(run, n_pix: int):
    g = torch.Generator().manual_seed(run.seed)
    n = min(int(run.cell.params["check_pixels"]), n_pix)
    return torch.sort(torch.randperm(n_pix, generator=g)[:n]).values


def reference_sums(run, pix, spp_done: int, dtype=torch.float32,
                   block: int = 1 << 18):
    """The reference's radiance sums of samples ``0 .. spp_done - 1`` of
    pixels ``pix`` (float64)."""
    cfg, dev = run.cell.config, run.device
    world = ref_scene.build_world(cfg)
    view = ref_scene.build_view(cfg)
    tb = tracer.tables(world, dev, dtype)
    key = ref_rng.key_words(0, run.seed, dev)
    pix = pix.to(dev)
    n = pix.shape[0]
    out = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    per = max(1, block // n)
    with torch.no_grad():
        for s0 in range(0, spp_done, per):
            k = min(per, spp_done - s0)
            p = pix.repeat(k).to(torch.int32)
            smp = (s0 + torch.arange(k, device=dev, dtype=torch.int32)
                   ).repeat_interleave(n)
            rad, _ = tracer.trace(tb, view, key, p, smp, dtype=dtype)
            out += rad.double().reshape(k, n, 3).sum(0)
    return out


def image_gap(prog, ref) -> float:
    """Relative L1 gap of the sums: sum |prog - ref| / sum |ref|, a
    pixel whose sum is not finite counting as one not rendered (its
    whole reference value)."""
    prog, ref = prog.double().to(ref.device), ref.double()
    prog = torch.where(torch.isfinite(prog), prog, 0.0)
    return float((prog - ref).abs().sum() / ref.abs().sum())


def check(run, st) -> list:
    pix = check_pixels(run, st["n_pix"])
    prog = st["acc"][pix.to(st["acc"].device)].cpu()
    spp_done = st["spp_done"]
    st.clear()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref = reference_sums(run, pix, spp_done)
    lim = run.cell.params["check"]
    return [("image_gap", image_gap(prog, ref), lim["image_gap"])]
