"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs the cell's traced window under
``torch.profiler`` and reads its per-layer metrics.  Either way the
output is checked against the reference once the window has closed, and
the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``busy_s``, ``window_s``) and ``breakdown``, then ``checks``, each
compared number with its limit (also the last lines of standard error).

The run needs as many CUDA devices as the cell asks for and exits with
another code than 0 without them.  ``setup_s`` runs from this module's
start to the first timed step: imports, the kernels' load (built into
``raytrace_tpu_torch/_build/`` at a checkout's first run), the scene,
the traffic's inputs and the warm work.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import core  # noqa: E402


class Run:
    """What an entry sees of a run: the cell, the seed, the device, the
    spans, the renderer's package (``rt``)."""

    def __init__(self, cell, seed: int, device: str, spans, rt):
        self.cell, self.seed, self.device = cell, seed, device
        self.spans, self.rt = spans, rt


def _profile_fn(run, names):
    import torch
    from .trace import read_profile

    def profile(fn):
        core.sync(run.device)
        # on the card the device's activity alone: its runtime calls
        # on the host side, a tenth of the host ops' tracing cost
        acts = [torch.profiler.ProfilerActivity.CPU
                if run.device == "cpu" else
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            core.sync(run.device)
            window_s = time.perf_counter() - t0
        return read_profile(prof, window_s, names)
    return profile


def per_layer(cell, spans: dict, traced: dict) -> dict:
    """Each per-layer metric's reader over what the traced run kept; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    ctx = dict(spans=spans, counters=traced["counters"],
               reading=traced["reading"], work=traced["work"])
    for m in cell.per_layer:
        value = core.load_metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             t0: float = T0) -> tuple[str, list, int]:
    """Run a cell; returns ``(result line, checks, exit code)``.  The
    device check is the caller's."""
    spans = core.Spans()
    # the interpreter's torch import and the device check, before here
    spans.s["setup.before_cell_s"] = time.perf_counter() - t0
    cell = core.Cell(workload, overrides)
    with spans("setup.import_s"):
        import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops._build import load_library
    with spans("setup.kernel_load_s"):
        if device != "cpu":
            load_library()
    run = Run(cell, seed, device, spans, rt)
    entry = cell.entry()
    st = entry.setup(run)
    core.sync(device)
    setup_s = time.perf_counter() - t0
    breakdown = None
    if trace:
        from .trace import kernel_names
        names = kernel_names(core.ROOT / "raytrace_tpu_torch")
        res = entry.traced(run, st, _profile_fn(run, names))
        rd = res["reading"]
        metrics = per_layer(cell, spans.s, res)
        breakdown = {"device_ops": rd.device_ops, "idle_gaps": rd.idle_gaps}
    else:
        res = entry.window(run, st, seconds)
        metrics = {m["name"]: {"value": res["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev_info = core.device_info(device, cell.chips)
    if trace:
        dev_info.update(busy_s=res["reading"].busy_s / cell.chips,
                        window_s=res["reading"].window_s)
    with spans("check_s"):
        checks = entry.check(run, st)
    correct = (res["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks))
    print("spans " + " ".join(f"{k}={v:.3f}" for k, v in spans.s.items())
          + f" setup_s={setup_s:.3f}", file=sys.stderr)
    if "info" in res:
        print("window " + json.dumps(res["info"]), file=sys.stderr)
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    if bad:
        return "", checks, 3
    line = core.result_line(correct, res["attempted"], res["failed"],
                            metrics, dev_info, checks, breakdown)
    return line, checks, 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the JAX package's namesake libraries stay out of this process
    os.environ.setdefault("USE_FLAX", "0")
    # a fixed kernel cache inside the checkout, should a kernel compile
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(core.PKG / "_cache" / "triton"))
    import torch
    cell = core.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, _, code = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    if code == 0:
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
