"""Render counters (``raytrace_tpu/utils/profiling.py``): primary rays
and path segments per second, wavefront occupancy, and the engines that
served the render, as one-line JSON records."""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch


@dataclasses.dataclass
class RenderStats:
    """Counters for one render (accumulate over launches)."""
    primary_rays: int = 0
    path_segments: int = 0      # bounces processed, over all lanes
    iterations: int = 0
    lane_iterations: int = 0    # lanes x iterations (the work issued)
    wall_s: float = 0.0
    # which engine served each stage (utils/engines.py:engine_report)
    engines: dict = dataclasses.field(default_factory=dict)

    def add_launch(self, stats: dict, primary: int, wall_s: float):
        self.primary_rays += int(primary)
        self.path_segments += int(stats["segments"])
        self.iterations += int(stats["iterations"])
        self.lane_iterations += int(stats["iterations"]) * int(stats["lanes"])
        self.wall_s += wall_s

    def record_engines(self, scene, settings, **kw):
        from .engines import engine_report
        self.engines = engine_report(scene, settings, **kw)
        return self.engines

    @property
    def occupancy(self) -> float:
        return self.path_segments / max(self.lane_iterations, 1)

    @property
    def primary_rays_per_s(self) -> float:
        return self.primary_rays / max(self.wall_s, 1e-12)

    @property
    def segments_per_s(self) -> float:
        return self.path_segments / max(self.wall_s, 1e-12)

    @property
    def mean_path_length(self) -> float:
        return self.path_segments / max(self.primary_rays, 1)

    def record(self) -> dict:
        out = {
            "primary_rays": self.primary_rays,
            "primary_rays_per_s": round(self.primary_rays_per_s, 1),
            "path_segments_per_s": round(self.segments_per_s, 1),
            "mean_path_length": round(self.mean_path_length, 3),
            "wavefront_occupancy": round(self.occupancy, 4),
            "wall_s": round(self.wall_s, 3),
        }
        if self.engines:
            out["engines"] = self.engines
        return out

    def log(self, tag: str = "render", stream=sys.stderr):
        print(json.dumps({"event": tag, **self.record()}), file=stream,
              flush=True)


class Timer:
    """``with Timer(device) as t: ...`` sets ``t.elapsed`` to the block's
    wall seconds.  For a CUDA ``device`` (a device, its name or a tensor
    on it) the block starts and ends with ``torch.cuda.synchronize``, so
    the time covers the device work the block queued."""

    def __init__(self, device=None):
        if isinstance(device, torch.Tensor):
            device = device.device
        self.cuda = (device is not None
                     and torch.device(device).type == "cuda")
        self.device = device

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
