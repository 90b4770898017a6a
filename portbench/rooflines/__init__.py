"""Work counts for roofline shares, and the card's peaks.

A share is the least time the card could take for the problem's work,
the larger of its operations over the float32 peak and its bytes over
the memory bandwidth, over the measured time, in percent.  The work is
that of the problem, not of a kernel: inputs read once, outputs written
once, no ray-row or box tests (an acceleration structure changes those,
not the work).  Each kind of work is a module of this package,
``<kind>.py``, with ``work(counters) -> (operations, bytes)``; its
docstring says where its count may overstate.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, float32 outside
the tensor cores and HBM3 bandwidth.
"""
from __future__ import annotations

import importlib

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def work(kind: str, counters: dict) -> tuple[float, float]:
    return importlib.import_module(f"{__name__}.{kind}").work(counters)


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share(kind: str, counters: dict, seconds: float) -> float | None:
    """Percent of the roofline over ``seconds``; None where nothing was
    measured."""
    if not seconds or seconds <= 0:
        return None
    ops, nbytes = work(kind, counters)
    if ops <= 0 and nbytes <= 0:
        return None
    return 100.0 * bound_s(ops, nbytes) / seconds
