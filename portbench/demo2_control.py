"""Readings that set the limit of ``image_gap`` in a cell of the
``demo2_render`` entry, and the controls that have to fail it.  Run on
the card at the cell's own size:

    python3 -m portbench.demo2_control --workload demo2-fwd \
        --seeds 11 12 ... --control-seeds 21 22

prints one JSON line a seed: the program's pass (set-up, one window
pass, the cell's check) against the reference (``"side": "program"``,
with the reference's segments and medium scatters over the checked
pixels), then for each control seed each control against the reference
in float32 over the same pixels and samples (``"side"`` its name): the
reference in bfloat16 (``dtype``), the fog left out (``fog``: its
density 0, so that the draws keep their columns), the moving sphere
frozen at its start (``frozen``), the marble and the earth each replaced
by a constant of its mean albedo (``marble``, ``earth``), the
redirection off (``redirect``).
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from . import core
from .entries import demo2_render as E
from .reference import demo2 as ref
from .run import Run


def _run(workload: str, seed: int, device: str, overrides=None) -> Run:
    import raytrace_tpu_torch as rt
    return Run(core.Cell(workload, overrides), seed, device, core.Spans(),
               rt)


def program(run: Run) -> dict:
    st = E.setup(run)
    E.window(run, st, 0.0)
    pix = E.check_pixels(run, st["n_pix"])
    prog = st["acc"][pix.to(st["acc"].device)].cpu()
    s0 = st["spp_done"]
    st.clear()
    ref_sum, (segs, med) = E.reference_sums(
        run, pix, s0, int(run.cell.traffic["pass_spp"]))
    return dict(image_gap=E.image_gap(prog, ref_sum), ref_segments=segs,
                ref_medium_segments=med, ref_paths=int(pix.shape[0])
                * int(run.cell.traffic["pass_spp"]))


def control_configs(config: dict) -> dict:
    """Each control's configuration (the bfloat16 control runs the
    configuration as it is)."""
    out = {}
    cfg = copy.deepcopy(config)
    for obj in cfg["objects"]:
        if obj["material"] == "fog":
            obj["medium"]["density"] = 0.0
    out["fog"] = cfg
    cfg = copy.deepcopy(config)
    for obj in cfg["objects"]:
        if obj.get("moving"):
            obj["moving"] = [obj["moving"][0], obj["moving"][0]]
    out["frozen"] = cfg
    cfg = copy.deepcopy(config)
    cfg["materials"]["marble"] = {"kind": "lambertian",
                                  "color": [0.5, 0.5, 0.5]}
    out["marble"] = cfg
    cfg = copy.deepcopy(config)
    img = ref.earth_image(config["images"]["earth"])
    cfg["materials"]["earth"] = {
        "kind": "lambertian",
        "color": [float(x) for x in img.reshape(-1, 3).mean(0)]}
    out["earth"] = cfg
    cfg = copy.deepcopy(config)
    cfg["camera"]["redirect"] = []
    out["redirect"] = cfg
    return out


def controls(run: Run) -> list:
    view = ref.build_view(run.cell.config)
    pix = E.check_pixels(run, view.width * view.height)
    spp = int(run.cell.traffic["pass_spp"])
    base, _ = E.reference_sums(run, pix, 0, spp)
    low, _ = E.reference_sums(run, pix, 0, spp, dtype=torch.bfloat16)
    out = [("dtype", E.image_gap(low, base))]
    for name, cfg in control_configs(run.cell.config).items():
        other, _ = E.reference_sums(run, pix, 0, spp, config=cfg)
        out.append((name, E.image_gap(other, base)))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="demo2-fwd")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--check-pixels", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    over = (None if args.check_pixels is None
            else {"cell": {"check_pixels": args.check_pixels}})
    if args.device != "cpu":
        from raytrace_tpu_torch.ops._build import load_library
        load_library()
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            run = _run(args.workload, seed, args.device, over)
            recs = ([("program", program(run))] if side == "program" else
                    [(k, dict(image_gap=v)) for k, v in controls(run)])
            for name, nums in recs:
                print(json.dumps(dict(workload=args.workload, side=name,
                                      seed=seed, seconds=time.perf_counter()
                                      - t0, **nums)), flush=True)
            if args.device != "cpu":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
