"""Readings that set the limits of ``correct``, and the control that has
to fail them.  Run on the card at the cells' own sizes:

    python3 -m portbench.control readings --workload <cell> \
        --seeds 11 12 ... [--control-seeds 21 22 23]
    python3 -m portbench.control n_iters --workload cornell-train --seed 0

``readings`` prints one JSON line a seed: the compared numbers of the
program against the reference (``"side": "program"``), then of the
control, the reference itself computed in bfloat16, against the
reference in float32 (``"side": "control"``), then of the train step
with a fault planted (``--faults half grad``, see :func:`_fault`).  The program's side of a
render is two passes (the resumption included) with the run's sample of
pixels; of a train step the set-up's steps.  ``n_iters`` prints the
share of a train step's samples completed within each iteration budget,
from the reference's segment counts (the same paths the program traces),
and the least budget that completes 0.9999 of them.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import core
from .run import Run


def _run(workload: str, seed: int, device: str, overrides=None) -> Run:
    import raytrace_tpu_torch as rt
    return Run(core.Cell(workload, overrides=overrides), seed, device,
               core.Spans(), rt)


def _fault(side: str):
    """A fault planted in the train step's ``loss_and_grads`` (the
    program's own, wrapped in this process): ``half`` drops the second
    half of the lanes and takes the mean over the rest; ``grad`` doubles
    the colours' gradient where it is produced."""
    from raytrace_tpu_torch.parallel import sharding
    inner = sharding.loss_and_grads

    def half(params, statics, settings, key, pixel_ids, target, **kw):
        n = pixel_ids.shape[0] // 2
        return inner(params, statics, settings, key, pixel_ids[:n],
                     target[:n], **kw)

    def grad(*a, **kw):
        (loss, frac), grads = inner(*a, **kw)
        grads.textures.c0.mul_(2.0)
        return (loss, frac), grads

    sharding.loss_and_grads = {"half": half, "grad": grad}[side]
    return lambda: setattr(sharding, "loss_and_grads", inner)


def train_numbers(run: Run, side: str) -> dict:
    from .entries import train_step as E
    if side == "control":
        lane_pix, target = E.inputs(run)
        prog = E.reference_readings(run, lane_pix, target,
                                    dtype=torch.bfloat16)
    else:
        undo = _fault(side) if side != "program" else (lambda: None)
        try:
            st = E.setup(run)
            lane_pix, target = st["lane_pix"], st["target"]
            prog = E.free(st)
        finally:
            undo()
    ref = E.reference_readings(run, lane_pix, target)
    return dict(E.numbers(prog, ref), **E.details(prog, ref),
                fracs=prog["fracs"], ref_fracs=ref["fracs"],
                losses=prog["losses"], ref_losses=ref["losses"])


def render_numbers(run: Run, side: str, passes: int = 2) -> dict:
    from .entries import progressive_render as E
    if side == "control":
        st = E.setup(run)
        n_pix = st["n_pix"]
        st.clear()
        spp = passes * int(run.cell.traffic["pass_spp"])
        pix = E.check_pixels(run, n_pix)
        ctl = E.reference_sums(run, pix, spp, dtype=torch.bfloat16)
        ref = E.reference_sums(run, pix, spp)
        return dict(image_gap=E.image_gap(ctl, ref))
    st = E.setup(run)
    for _ in range(passes):
        E.window(run, st, 0.0)
    return dict(image_gap=E.check(run, st)[0][1])


def readings(args) -> None:
    cell = core.Cell(args.workload)
    fn = train_numbers if cell.traffic["entry"] == "train_step" \
        else render_numbers
    out = []
    sides = [("program", args.seeds), ("control", args.control_seeds)]
    sides += [(f, args.fault_seeds) for f in args.faults]
    for side, seeds in sides:
        for seed in seeds:
            t0 = time.perf_counter()
            nums = fn(_run(args.workload, seed, args.device), side)
            rec = dict(workload=args.workload, side=side, seed=seed,
                       seconds=time.perf_counter() - t0, **nums)
            print(json.dumps(rec), flush=True)
            out.append(rec)
            if args.device != "cpu":
                torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for rec in out:
                f.write(json.dumps(rec) + "\n")


def n_iters(args) -> None:
    from .entries.train_step import step_key
    from .reference import scene as ref_scene, tracer
    run = _run(args.workload, args.seed, args.device)
    cfg, tr = run.cell.config, run.cell.traffic
    world, view = ref_scene.build_world(cfg), ref_scene.build_view(cfg)
    tb = tracer.tables(world, args.device)
    n_pix = view.width * view.height
    lanes, spp = int(tr["lanes"]), int(tr["spp"])
    weight = torch.bincount(torch.arange(lanes) % n_pix,
                            minlength=n_pix).to(args.device)
    pix = torch.arange(n_pix, device=args.device, dtype=torch.int32)
    segs = []
    with torch.no_grad():
        for k in range(spp):
            _, sg = tracer.trace(tb, view, step_key(0, args.seed,
                                                    args.device), pix,
                                 torch.full_like(pix, k))
            segs.append(sg)
    cum = torch.cumsum(torch.stack(segs), 0)
    total = float(weight.sum()) * spp
    curve = {}
    for n in range(args.lo, args.hi + 1):
        done = ((cum <= n).sum(0) * weight).sum()
        curve[n] = float(done) / total
    least = min((n for n, f in curve.items() if f >= args.share),
                default=None)
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          least=least, share=args.share,
                          mean_segments=float(cum[-1].double().mean())
                          / spp, curve=curve)), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", type=int, nargs="*", default=[])
    r.add_argument("--control-seeds", type=int, nargs="*", default=[])
    r.add_argument("--faults", nargs="*", default=[],
                   choices=("half", "grad"))
    r.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    r.add_argument("--out")
    n = sub.add_parser("n_iters")
    n.add_argument("--workload", required=True)
    n.add_argument("--seed", type=int, default=0)
    n.add_argument("--lo", type=int, default=60)
    n.add_argument("--hi", type=int, default=220)
    n.add_argument("--share", type=float, default=0.9999)
    for q in (r, n):
        q.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    (readings if args.cmd == "readings" else n_iters)(args)


if __name__ == "__main__":
    main()
