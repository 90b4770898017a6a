"""Readings that set the limit of ``image_gap`` in a cell of the
``pawn_render`` entry, and the controls that have to fail it.  Run on
the card at the cell's own size:

    python3 -m portbench.media_control --workload pawn-fwd \
        --seeds 11 12 ... --control-seeds 21 22

prints one JSON line a seed: the program's pass (set-up, one window
pass, the cell's check) against the reference (``"side": "program"``,
with the reference's segments and medium scatters over the checked
pixels), then for each control seed the reference in bfloat16
(``"side": "dtype"``) and the reference with every medium's density
times ``--density-scale`` (``"side": "density"``), each against the
reference in float32 over the same pixels and samples.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from . import core
from .entries import pawn_render as E
from .reference import media
from .run import Run


def _run(workload: str, seed: int, device: str) -> Run:
    import raytrace_tpu_torch as rt
    return Run(core.Cell(workload), seed, device, core.Spans(), rt)


def program(run: Run) -> dict:
    st = E.setup(run)
    E.window(run, st, 0.0)
    pix = E.check_pixels(run, st["n_pix"])
    prog = st["acc"][pix.to(st["acc"].device)].cpu()
    s0 = st["spp_done"]
    st.clear()
    ref, (segs, med) = E.reference_sums(
        run, pix, s0, int(run.cell.traffic["pass_spp"]))
    return dict(image_gap=E.image_gap(prog, ref), ref_segments=segs,
                ref_medium_segments=med)


def controls(run: Run, density_scale: float) -> list:
    view = media.build_view(run.cell.config)
    pix = E.check_pixels(run, view.width * view.height)
    spp = int(run.cell.traffic["pass_spp"])
    ref, _ = E.reference_sums(run, pix, 0, spp)
    low, _ = E.reference_sums(run, pix, 0, spp, dtype=torch.bfloat16)
    cfg = copy.deepcopy(run.cell.config)
    for obj in cfg["objects"]:
        if "medium" in obj:
            obj["medium"]["density"] *= density_scale
    thin, _ = E.reference_sums(run, pix, 0, spp, config=cfg)
    return [("dtype", E.image_gap(low, ref)),
            ("density", E.image_gap(thin, ref))]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="pawn-fwd")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--density-scale", type=float, default=0.9)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu":
        from raytrace_tpu_torch.ops._build import load_library
        load_library()
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            run = _run(args.workload, seed, args.device)
            recs = ([("program", program(run))] if side == "program" else
                    [(k, dict(image_gap=v))
                     for k, v in controls(run, args.density_scale)])
            for name, nums in recs:
                print(json.dumps(dict(workload=args.workload, side=name,
                                      seed=seed, seconds=time.perf_counter()
                                      - t0, **nums)), flush=True)
            if args.device != "cpu":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
