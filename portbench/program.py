"""The span window: a second traced window of a cell with the program's
own recorder on (``raytrace_tpu_torch/utils/profiling.py``), its spans
put on the device trace's clock, each idle gap of the device put down
to the program span open on the host when it opened, and the per-layer
metrics that read those spans and counters.

    python3 -m portbench.program --workload <cell> --seed <n>

runs the cell's set-up and its traced window as ``run.py --trace 1``
does, that window's per-layer metrics, then the span window and the
metrics that read it (:data:`METRICS`), then the cell's check, and
prints one JSON line (none, and exit code 3, where JAX or the JAX
package was loaded, as ``run.py``): ``correct``, ``metrics``, ``device``, ``windows_s``
(the first window's and the span window's), ``clock`` (the recorder's
offset to the trace's clock, each anchor's bracket, the drift),
``idle`` (the span window's device idle seconds and the share under a
named span), ``breakdown`` (``idle_gaps`` of the first window,
``idle_by_span`` of the span window) and ``checks``.  The first window,
its reading and its metrics are the ones ``run.py`` takes: the span
window runs after them.

The span window repeats the cell's traced work with recording on:
cornell-train's ``trace_steps`` steps, demo1-fwd's pass through
``render_accumulate`` itself into an accumulator of its own; the state
the check reads is left as the first window left it.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import math
import os
import sys
import time

from . import core
from .trace import TOP, _union, kernel_names, read_profile

OUTSIDE = "(outside any span)"
# the per-layer metrics that read the span window, with their units
METRICS = {"driver.enqueue_ms.fwd": "ms", "driver.wait_ms.fwd": "ms",
           "driver.occupancy.train": "ratio",
           "glue.host_ms_per_iteration.train": "ms",
           "glue.update_ms.train": "ms"}


def device_gaps(events) -> list:
    """``[(start, end)]`` in us of the trace's clock: the gaps between
    the device operations' merged intervals, from the window's first
    host event on (``trace.read_profile``'s gaps, all of them)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((s, t))
        else:
            host.append(s)
    merged = _union(dev)
    if not merged:
        return []
    start = min(host, default=merged[0][0])
    edges = [(start, merged[0][0])] + [
        (merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return [(a, b) for a, b in edges if b > a]


def idle_by_span(gaps, spans, offset_ns: float) -> dict:
    """Seconds of the ``gaps`` (us, the trace's clock) by the innermost
    program span open on the host when each opened (``spans`` as
    ``Recording.export()`` gives them, in the order opened; ``offset_ns``
    the recorder's clock to the trace's), or :data:`OUTSIDE`.  The
    innermost is found from the last span opened before the gap, up its
    parents: spans nest, so every span open then is one of them."""
    starts = [s["start_ns"] for s in spans]
    out = collections.defaultdict(float)
    for a, b in gaps:
        t = 1e3 * a - offset_ns
        i = bisect.bisect_right(starts, t) - 1
        while i is not None and i >= 0:
            end = spans[i]["end_ns"]
            if end is not None and end > t:
                break
            i = spans[i]["parent"]
        name = OUTSIDE if i is None or i < 0 else spans[i]["name"]
        out[name] += (b - a) / 1e6
    return dict(out)


def top(by_name: dict) -> list:
    """The ``TOP`` largest ``[name, seconds]``, as ``idle_gaps``."""
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def durations_ms(program: dict, name: str) -> list:
    """Each closed span ``name``'s duration in ms."""
    return [(s["end_ns"] - s["start_ns"]) / 1e6 for s in program["spans"]
            if s["name"] == name and s["end_ns"] is not None]


def mean_ms(program: dict, name: str):
    """The mean duration of the spans ``name`` in ms, None without one."""
    d = durations_ms(program, name)
    return sum(d) / len(d) if d else None


def _train_work(run, st):
    from .entries import train_step
    n = int(run.cell.traffic["trace_steps"])
    st["fracs"].clear()
    for _ in range(n):
        train_step._one(run, st)
    train_step._fracs(st, n)


def _fwd_work(run, st):
    run.rt.render_accumulate(st["scene"], st["settings"], seed=run.seed,
                             spp=int(run.cell.traffic["pass_spp"]))


WORK = {"train_step": _train_work, "progressive_render": _fwd_work}


def span_window(run, st, names) -> dict | None:
    """The span window of the cell; None where the program has no
    recorder.  ``program``: the recording's export with its ``clock``;
    ``program_reading``: the window's ``read_profile``; ``idle``: the
    device's idle seconds by span."""
    import torch
    try:
        from raytrace_tpu_torch.utils.profiling import clock_offset, tracing
    except ImportError:
        return None
    work = WORK[run.cell.traffic["entry"]]
    core.sync(run.device)
    acts = [torch.profiler.ProfilerActivity.CPU if run.device == "cpu"
            else torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with tracing() as rec:
            work(run, st)
        core.sync(run.device)
        window_s = time.perf_counter() - t0
    program = rec.export()
    events = prof.events()
    # raises where the spans cannot be put on the trace's clock
    program["clock"] = clock_offset(program, events)
    idle = idle_by_span(device_gaps(events), program["spans"],
                        program["clock"]["offset_ns"])
    return dict(program=program,
                program_reading=read_profile(prof, window_s, names),
                idle=idle)


def run_spans(workload: str, seed: int, *, device: str = "cuda",
              overrides: dict | None = None, t0: float | None = None
              ) -> dict:
    """The cell's set-up, first traced window, span window and check;
    the result line's object.  The set-up and the first window are
    ``run.run_cell``'s, step for step."""
    from . import run as R
    t0 = time.perf_counter() if t0 is None else t0
    spans = core.Spans()
    spans.s["setup.before_cell_s"] = time.perf_counter() - t0
    cell = core.Cell(workload, overrides)
    with spans("setup.import_s"):
        import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops._build import load_library
    with spans("setup.kernel_load_s"):
        if device != "cpu":
            load_library()
    run = R.Run(cell, seed, device, spans, rt)
    entry = cell.entry()
    st = entry.setup(run)
    core.sync(device)
    spans.s["setup_s"] = time.perf_counter() - t0
    names = kernel_names(core.ROOT / "raytrace_tpu_torch")
    first = entry.traced(run, st, R._profile_fn(run, names))
    metrics = R.per_layer(cell, spans.s, first)
    win = span_window(run, st, names)
    out = dict(windows_s=[first["reading"].window_s], clock=None, idle=None,
               breakdown={"idle_gaps": first["reading"].idle_gaps})
    if win is not None:
        ctx = dict(spans=spans.s, counters=first["counters"],
                   reading=first["reading"], work=first["work"],
                   program=win["program"],
                   program_reading=win["program_reading"])
        for name, unit in METRICS.items():
            value = core.load_metric(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        total = sum(win["idle"].values())
        out.update(
            windows_s=out["windows_s"] + [win["program_reading"].window_s],
            clock=win["program"]["clock"],
            idle=dict(total_s=total, named_share=(
                1.0 - win["idle"].get(OUTSIDE, 0.0) / total
                if total else None)),
            counters=win["program"]["counters"])
        out["breakdown"]["idle_by_span"] = top(win["idle"])
    checks = entry.check(run, st)
    out.update(correct=(first["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)),
        metrics=metrics, device=core.device_info(device, cell.chips),
        checks={k: {"value": v, "limit": lim} for k, v, lim in checks})
    return out


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    # as run.py: the JAX package's namesake libraries stay out, and a
    # kernel that compiles caches inside the checkout
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(core.PKG / "_cache" / "triton"))
    import torch
    if not torch.cuda.is_available():
        print(f"{args.workload}: needs a CUDA device", file=sys.stderr)
        return 2
    out = run_spans(args.workload, args.seed, t0=t0)
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
