"""Render counters (``raytrace_tpu/utils/profiling.py``): primary rays
and path segments per second, wavefront occupancy, and the engines that
served the render, as one-line JSON records; and the port's recorder of
spans and counters inside the program.

The forward drivers count their own work: called with ``with_stats``
(``render/integrator.py``) they also return ``dict(iterations, segments,
lanes)``, which :meth:`RenderStats.add_launch` takes as it is.
:func:`render_with_stats` does that for every launch of a
``render_accumulate`` call.

The recorder: ``with tracing() as rec:`` records, for the block, every
:func:`span` the program opens (its name, start and end by
``time.perf_counter_ns()``, its parent span and the id of its call: a
span opened where none is open starts a call, and the spans inside it
share its id) and every :func:`count`; ``rec.export()`` returns them.
With recording off :func:`span` returns one shared no-op context and
:func:`count` returns at once, so the program launches and reads
nothing for them.  Counts that live on the device (the fused diff
driver's segments, 0-d tensors) are kept as they are and read at
``export()``.
Spans nest across threads: the autograd engine's device thread records
its backward spans under the span its caller waits in.  Under
``torch.profiler`` the block starts and ends with a clock anchor, from
which :func:`clock_offset` maps the spans onto the trace's clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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


def render_with_stats(scene, settings, seed: int = 0, *,
                      spp: int | None = None, n_lanes: int = 1 << 17,
                      max_band: int = 1 << 19):
    """``render_accumulate(scene, settings, seed, spp=spp,
    n_lanes=n_lanes, max_band=max_band)`` launch by launch
    (``render.py:forward_launches``), each driver called with
    ``with_stats=True`` and its dict fed to :meth:`RenderStats.add_launch`
    with the launch's primary rays and wall (:class:`Timer` on the
    scene's device).  Returns ``(acc, stats)``, ``acc`` the radiance sum
    of ``render_accumulate``."""
    from ..core import rng
    from ..core.vecmath import DTYPE
    from ..render.render import forward_launches
    dev = scene.device
    spp = spp if spp is not None else settings.samples_per_pixel
    acc = torch.zeros((settings.image_height * settings.image_width, 3),
                      dtype=DTYPE, device=dev)
    stats = RenderStats()
    for _, off, bp, n_s, launch in forward_launches(
            scene, settings, rng.base_key(seed, dev), spp, n_lanes,
            max_band=max_band):
        with Timer(dev) as t:
            part, st = launch(with_stats=True)
            acc[off:off + bp] += part
        stats.add_launch(st, bp * n_s, t.elapsed)
    return acc, stats


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


# the recorder's clock anchor: on the card a CUDA event's synchronize (a
# runtime call the program makes nowhere else), else a labelled range;
# the trace's name of each
ANCHOR = "profiling.anchor"
ANCHOR_CALLS = {"cuda": "cudaEventSynchronize", "label": ANCHOR}
# the most the two anchors' offsets may differ (on an H100: under 2 us)
MAX_DRIFT_NS = 1e6


class Recording:
    """What one :func:`tracing` block records.  ``spans``: ``[name,
    start_ns, end_ns, parent index, call id]`` in the order opened;
    ``counters``: each :func:`count`'s values by name; ``anchors``:
    ``(kind, before_ns, after_ns)`` of each clock anchor."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.anchors: list = []
        self._open: list = []
        self._calls = 0

    def open(self, name: str) -> int:
        if self._open:
            parent = self._open[-1]
            call = self.spans[parent][4]
        else:
            parent, call = None, self._calls
            self._calls += 1
        i = len(self.spans)
        self.spans.append([name, time.perf_counter_ns(), None, parent, call])
        self._open.append(i)
        return i

    def close(self, i: int) -> None:
        self.spans[i][2] = time.perf_counter_ns()
        # spans left open inside this one (by a raise) close with it
        if i in self._open:
            del self._open[self._open.index(i):]

    def anchor(self) -> None:
        """Stamp the host's clock just before and just after an anchor
        call (``ANCHOR_CALLS``).  The same call is made once before,
        unstamped: the first call of a kind under the profiler costs
        20-60 us on the card, the next 2-5 us.  On the card the device
        is drained first, so the event's synchronize returns at once."""
        if torch.cuda.is_initialized():
            kind = "cuda"
            torch.cuda.synchronize()
            event = torch.cuda.Event()
            event.record()
            call = event.synchronize
        else:
            kind = "label"

            def call():
                with torch.profiler.record_function(ANCHOR):
                    pass
        call()
        t0 = time.perf_counter_ns()
        call()
        self.anchors.append((kind, t0, time.perf_counter_ns()))

    def export(self) -> dict:
        """``{"spans": [{name, start_ns, end_ns, parent, call}],
        "counters": {name: sum}, "anchors": [...]}``; device counts are
        read here."""
        def value(v):
            return v.item() if isinstance(v, torch.Tensor) else v
        return {
            "spans": [dict(name=n, start_ns=t0, end_ns=t1, parent=p, call=c)
                      for n, t0, t1, p, c in self.spans],
            "counters": {k: sum(value(v) for v in vs)
                         for k, vs in self.counters.items()},
            "anchors": [list(a) for a in self.anchors]}


_ACTIVE: Recording | None = None


# the no-op span of recording off
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.i)
        return None


def span(name: str):
    """A context that records the span ``name`` while recording is on."""
    rec = _ACTIVE
    return _OFF if rec is None else _Span(rec, name)


def spanned(name: str):
    """Decorator: every call of the function runs under :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a 0-d tensor read at ``export()``) to
    the counter ``name`` while recording is on."""
    rec = _ACTIVE
    if rec is not None:
        rec.counters.setdefault(name, []).append(value)


def recording() -> bool:
    """Is a :func:`tracing` block recording?  Callers test it before
    computing a count that costs work."""
    return _ACTIVE is not None


@contextlib.contextmanager
def tracing():
    """Record spans and counters for the block; yields the
    :class:`Recording`.  Under ``torch.profiler`` the block starts and
    ends with a clock anchor (:meth:`Recording.anchor`)."""
    global _ACTIVE
    rec, prev = Recording(), _ACTIVE
    profiled = torch._C._autograd._profiler_enabled()
    if profiled:
        rec.anchor()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = prev
        if profiled:
            rec.anchor()


def clock_offset(exported: dict, events) -> dict:
    """The recorder's clock against a ``torch.profiler`` trace's:
    ``events`` the trace's (``prof.events()``), ``exported`` a recording
    whose :func:`tracing` block ran under it, with its two anchors.  An
    anchor's calls are the trace's events of its name
    (``ANCHOR_CALLS``), made twice, the second stamped: the start
    anchor's are the first two such events of the trace, the end
    anchor's the last two, whatever the block made of that name
    between them.  Returns ``offset_ns`` (the start anchor's stamped
    event start minus its first stamp: a span's ``start_ns +
    offset_ns`` is on the trace's clock, in ns), ``bounds_ns`` (each
    anchor's bracket, the error of its offset) and ``drift_ns`` (the
    end anchor's offset minus the start's).  Raises ``ValueError`` when
    the trace lacks the anchors' events or the two offsets differ by
    more than ``MAX_DRIFT_NS``: the spans cannot be aligned."""
    anchors = exported["anchors"]
    if len(anchors) != 2:
        raise ValueError(f"clock_offset: {len(anchors)} clock anchors, "
                         "not 2: the block ran outside the profiler")
    name = ANCHOR_CALLS[anchors[0][0]]
    starts = sorted(1e3 * e.time_range.start for e in events
                    if e.name == name)
    if len(starts) < 4:
        raise ValueError(f"clock_offset: {len(starts)} {name} events in "
                         "the trace, not the anchors' 4")
    offsets = [starts[1] - anchors[0][1], starts[-1] - anchors[1][1]]
    drift = offsets[1] - offsets[0]
    if abs(drift) > MAX_DRIFT_NS:
        raise ValueError(f"clock_offset: the anchors' offsets differ by "
                         f"{drift:.0f} ns: another {name} was taken "
                         "for an anchor's")
    return dict(offset_ns=offsets[0], drift_ns=drift,
                bounds_ns=[a - b for _, b, a in anchors])
