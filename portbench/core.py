"""What every run shares: finding a cell's files by name, host-clock
spans, the device's description, the check for JAX in the process, and
the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``entry``
names ``entries/<entry>.py``) and ``cells/<cell>.json``.  A per-layer
metric ``<name>`` is read by ``metrics/<name>.py``.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with the keys of ``over`` replaced (nested dicts merged)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Cell:
    """One workload: its entry of ``BENCHMARK.json`` and its three files.
    ``overrides`` (``{"config": {...}, "traffic": {...}, "cell": {...}}``)
    replace keys of the files, for runs at a test's size."""

    def __init__(self, name: str, overrides: dict | None = None):
        bench = benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        ov = overrides or {}
        self.config = merge(load_json(
            PKG / "configs" / f"{self.workload['config']}.json"),
            ov.get("config"))
        self.traffic = merge(load_json(
            PKG / "traffic" / f"{self.workload['traffic']}.json"),
            ov.get("traffic"))
        self.params = merge(load_json(PKG / "cells" / f"{name}.json"),
                            ov.get("cell"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def entry(self):
        return importlib.import_module(
            f"{PKG.name}.entries.{self.traffic['entry']}")


def load_metric(name: str):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG.name}_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Host-clock spans of the harness's own calls into the program,
    in seconds by name."""

    def __init__(self):
        self.s: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``raytrace_tpu_torch`` is not ``raytrace_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device, count: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def percentile_beyond(values: list, q: float) -> float:
    """The ``q`` quantile of ``values``: the sorted value at index
    ``ceil(q n) - 1``, so that at q = 0.95 ten of 200 lie beyond it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None = None
                ) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)
