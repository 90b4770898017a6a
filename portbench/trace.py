"""Reading a ``torch.profiler`` trace of a traced window: device busy
time as the union of the device operations' intervals, the device time
of the program's own kernels, the host's kernel-launch calls, the
operations that took the most device time, and the idle gaps by what
the host was doing.

The program's own kernels are the ``__global__`` functions under
``raytrace_tpu_torch/csrc/`` and the ``@triton.jit`` functions of the
package, read from the sources when a run starts, so a kernel added
later is counted without an edit here.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from pathlib import Path

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
TOP = 10


def kernel_names(pkg_dir: Path) -> frozenset:
    """Names of the program's own device functions."""
    names = set()
    for p in sorted((pkg_dir / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(p.read_text()))
    for p in sorted(pkg_dir.rglob("*.py")):
        text = p.read_text()
        if "triton.jit" in text:
            names.update(_TRITON.findall(text))
    return frozenset(names)


def kernel_matcher(names: frozenset):
    """``f(event name) -> bool``: is the device event one of ``names``
    (a demangled name: an optional return type and namespaces, the
    anonymous one included, then the function's name before its template
    or argument list)?"""
    if not names:
        return lambda name: False
    pat = re.compile(r"^(?:void\s+)?(?:(?:\w+|\(anonymous namespace\))::)*(?:"
                     + "|".join(sorted(map(re.escape, names)))
                     + r")\s*[<(]")
    return lambda name: pat.match(name) is not None


@dataclasses.dataclass
class Reading:
    window_s: float
    busy_s: float
    port_kernel_s: float
    host_launches: int
    device_ops: list
    idle_gaps: list


def _union(intervals):
    """Merged ``[(start, end)]`` of the intervals, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_profile(prof, window_s: float, names: frozenset) -> Reading:
    """``prof``: a finished ``torch.profiler.profile`` over the traced
    window; ``window_s`` its length by the host's clock."""
    from torch.autograd import DeviceType
    is_port = kernel_matcher(names)
    dev, cpu = [], []
    launches = 0
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a labelled range on the device's timeline spans the gaps
            # between the kernels under it: not device work
            if not getattr(e, "is_user_annotation", False):
                dev.append((s, t, e.name))
        else:
            cpu.append((s, t, e.name))
            if e.name in LAUNCH_CALLS:
                launches += 1
    by_op = collections.defaultdict(float)
    port_us = 0.0
    for s, t, name in dev:
        by_op[name] += t - s
        if is_port(name):
            port_us += t - s
    merged = _union((s, t) for s, t, _ in dev)
    busy_us = sum(t - s for s, t in merged)
    # gaps between device work, from the window's first host event on
    gaps = []
    if merged:
        start = min((s for s, _, _ in cpu), default=merged[0][0])
        edges = [(start, merged[0][0])] + [
            (merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps = [(a, b) for a, b in edges if b > a]
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    by_host = collections.defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        # the innermost host event running when the gap opened
        i = bisect.bisect_right(starts, a) - 1
        name = "(host outside any op)"
        for j in range(i, max(-1, i - 5000), -1):
            if cpu[j][1] > a:
                name = cpu[j][2]
                break
        by_host[name] += b - a
    top = lambda d: [[k[:120], v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Reading(window_s=window_s, busy_s=busy_us / 1e6,
                   port_kernel_s=port_us / 1e6,
                   host_launches=launches, device_ops=top(by_op),
                   idle_gaps=top(by_host))
