"""Entry ``train_step``: Adam over a scene's parameters through the
renderer's sharded inverse-rendering step
(``parallel.sharding.sharded_train_step_fn(...).with_state``) at one
rank: the loss, the gradients, the all-reduce and the update.

Set-up builds one step object and drives it from the published scene
and a fresh optimizer state through the first ``check_steps`` steps,
the optimizer's state carried from step to step: those are the steps
the reference follows.  Each step of the window then runs the same call
on the same feed from the published scene and a fresh optimizer state,
one key ``(step, seed)`` a step, so every step is the same work (a fit
carried through the window toward the target would move the colours
past 1 within a few dozen steps, after which the roulette no longer
ends paths and a step's work changes).  Each step ends with a
synchronize.  Lane ``i`` traces pixel ``i``: no two lanes share a pixel,
so no two trace the same paths.  The target is a seeded image, uniform
in [0, 1) a channel, made on the device.

Traffic keys: ``lanes``, ``spp``, ``lr``, ``check_steps``,
``trace_steps``.  Cell keys: ``n_iters`` (the fixed iteration count of
a step) and ``check`` (the limits).
"""
from __future__ import annotations

import statistics
import time

import torch

from .. import core
from ..reference import rng as ref_rng
from ..reference import scene as ref_scene
from ..reference import train as ref_train

BETA1 = 0.9


def step_key(step: int, seed: int, device=None):
    return ref_rng.key_words(step + ((seed >> 32) << 16), seed, device)


def inputs(run):
    """``(lane_pix, target)``: lane ``i``'s pixel ``i`` and its target,
    drawn from the seed by a generator on the run's device."""
    view = ref_scene.build_view(run.cell.config)
    n_pix = view.width * view.height
    lanes = int(run.cell.traffic["lanes"])
    if lanes > n_pix:
        raise ValueError(f"{lanes} lanes over {n_pix} pixels: lanes that "
                         "share a pixel trace the same paths")
    lane_pix = torch.arange(lanes, device=run.device, dtype=torch.int32)
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    target = torch.rand((lanes, 3), generator=gen, device=run.device)
    return lane_pix, target


def _norms(named: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in named.items()}


def setup(run):
    from .. import world as W
    with run.spans("setup.step_import_s"):
        from raytrace_tpu_torch.diff.gradients import leaves, partition
        from raytrace_tpu_torch.parallel import sharding

    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    with run.spans("setup.scene_build_s"):
        scene = W.scene(run.rt, cfg, dev)
        settings = W.settings(run.rt, cfg)
    with run.spans("setup.inputs_s"):
        lane_pix, target = inputs(run)

    # completed samples of each step: the step's own loss_and_grads
    # returns them beside the loss; the harness keeps them as it passes
    fracs = []
    inner = sharding.loss_and_grads

    def counted(*a, **k):
        (loss, frac), grads = inner(*a, **k)
        fracs.append(frac.detach())
        return (loss, frac), grads

    sharding.loss_and_grads = counted
    step = sharding.sharded_train_step_fn(
        sharding.make_mesh(), settings, spp=int(tr["spp"]),
        n_iters=int(run.cell.params["n_iters"]),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=float(tr["lr"])))
    names = list(leaves(partition(scene)[0]))
    start = leaves(partition(scene)[0])
    published, state = scene, step.init(scene)
    fresh = state
    losses, first_grads = [], None
    with run.spans("setup.first_steps_s"):
        for k in range(int(tr["check_steps"])):
            loss, scene, state = step.with_state(
                scene, state, step_key(k, run.seed, dev), lane_pix, None,
                target)
            losses.append(float(loss))
            if k == 0:
                first_grads = _norms({
                    names[i]: s["exp_avg"] / (1.0 - BETA1)
                    for i, s in state["state"].items()})
    now = leaves(partition(scene)[0])
    change = _norms({k: now[k] - start[k] for k in names})
    core.sync(dev)
    return dict(step=step, scene=published, opt=fresh, lane_pix=lane_pix,
                target=target, fracs=fracs, next_key=len(losses),
                restore=lambda: setattr(sharding, "loss_and_grads", inner),
                readings=dict(losses=losses, grads=first_grads,
                              change=change,
                              fracs=[float(f) for f in fracs]))


def _one(run, st):
    """One step from the published scene and a fresh optimizer state."""
    k = st["next_key"]
    loss, _, _ = st["step"].with_state(
        st["scene"], st["opt"], step_key(k, run.seed, run.device),
        st["lane_pix"], None, st["target"])
    st["next_key"] = k + 1
    return loss


def _fracs(st, steps: int) -> list:
    """Each step's completed share, as the step's ``loss_and_grads``
    returned it; raises where the harness saw fewer than the steps run
    (the step no longer reaches ``sharding.loss_and_grads``)."""
    fracs = st["fracs"]
    if len(fracs) != steps:
        raise RuntimeError(
            f"train_step: read the completed share of {len(fracs)} of "
            f"{steps} steps; the step no longer calls "
            "parallel.sharding.loss_and_grads through its module")
    return [float(f) for f in fracs]


def window(run, st, seconds: float) -> dict:
    tr = run.cell.traffic
    st["fracs"].clear()
    walls, losses = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        losses.append(_one(run, st))
        core.sync(run.device)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    done = sum(_fracs(st, len(walls))) * int(tr["lanes"]) * int(tr["spp"])
    failed = sum(1 for x in losses if not torch.isfinite(x))
    return dict(attempted=len(walls), failed=failed, metrics=dict(
        train_rays_per_s=done / window_s,
        train_step_p95_ms=1e3 * core.percentile_beyond(walls, 0.95)),
        info=dict(steps=len(walls), window_s=window_s,
                  step_ms=[1e3 * min(walls), 1e3 * statistics.median(walls),
                           1e3 * max(walls)],
                  first_last_20_ms=[1e3 * statistics.mean(walls[:20]),
                                    1e3 * statistics.mean(walls[-20:])]))


def traced(run, st, profile) -> dict:
    """``profile(fn) -> reading``: the traced window of ``trace_steps``
    steps."""
    n = int(run.cell.traffic["trace_steps"])
    st["fracs"].clear()
    losses = []

    def go():
        for _ in range(n):
            losses.append(_one(run, st))

    reading = profile(go)
    _fracs(st, n)
    counters = dict(steps=n, lanes=int(run.cell.traffic["lanes"]),
                    n_iters=int(run.cell.params["n_iters"]))
    return dict(attempted=n,
                failed=sum(1 for x in losses if not torch.isfinite(x)),
                reading=reading, counters=counters, work="train")


def free(st) -> dict:
    """Drop the program's state; the readings taken in set-up."""
    readings = st["readings"]
    st["restore"]()
    st.clear()
    return readings


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each compared leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's.  Leaves whose reference norm is under a thousandth of
    the median are left out (the median over the leaves the reference
    moves at all); a compared leaf the program lacks reads inf."""
    moved = sorted(v for v in ref.values() if v > 0)
    if not moved:
        return {}
    med = statistics.median(moved)
    out = {}
    for k, r in ref.items():
        if r >= 1e-3 * med:
            p = prog.get(k)
            out[k] = (float("inf") if p is None
                      else abs(p - r) / max(r, med))
    return out


def reference_readings(run, lane_pix, target, dtype=torch.float32) -> dict:
    """The reference's losses, first gradient and change over
    ``check_steps`` steps."""
    cfg, tr = run.cell.config, run.cell.traffic
    world = ref_scene.build_world(cfg)
    view = ref_scene.build_view(cfg)
    keys = [step_key(k, run.seed, run.device)
            for k in range(int(tr["check_steps"]))]
    outs, grads, change = ref_train.steps(
        world, view, keys, lane_pix, target, int(tr["spp"]),
        int(run.cell.params["n_iters"]), float(tr["lr"]), dtype=dtype,
        device=run.device)
    return dict(losses=[o.loss for o in outs], fracs=[o.frac_done
                                                      for o in outs],
                grads=_norms(grads), change=_norms(change))


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers: the set-up's steps' losses (the widest
    relative gap), the first gradient and the change over the set-up's
    steps, each by its worst leaf (:func:`leaf_gaps`)."""
    def worst(gaps: dict) -> float:
        return max(gaps.values()) if gaps else float("inf")
    return dict(
        loss_gap=max(abs(p - r) / abs(r) for p, r in zip(
            prog["losses"], ref["losses"])),
        grad_gap=worst(leaf_gaps(prog["grads"], ref["grads"])),
        change_gap=worst(leaf_gaps(prog["change"], ref["change"])))


def details(prog: dict, ref: dict) -> dict:
    """What the readings record beside the numbers: every step's loss
    gap, each leaf's gaps."""
    return dict(step_loss_gaps=[abs(p - r) / abs(r) for p, r in zip(
        prog["losses"], ref["losses"])],
        grad_leaves=leaf_gaps(prog["grads"], ref["grads"]),
        change_leaves=leaf_gaps(prog["change"], ref["change"]))


def check(run, st) -> list:
    lane_pix, target = st["lane_pix"], st["target"]
    prog = free(st)
    if run.device != "cpu":
        torch.cuda.empty_cache()
    ref = reference_readings(run, lane_pix, target)
    lim = run.cell.params["check"]
    return [(k, v, lim[k]) for k, v in numbers(prog, ref).items()]
