"""The span window (``portbench/program.py``) at the cells' tiny sizes
on the CPU: each cell yields its new metrics, finite, and an
``idle_by_span`` list, every existing metric read from the first window
alone; and the attribution of idle gaps to the innermost open span."""
import math

import pytest

from portbench import core, program
from portbench.tests.tiny import SEED, TINY

# the span window's metrics each cell reads
NEW = {"cornell-train": {"driver.occupancy.train",
                         "glue.host_ms_per_iteration.train",
                         "glue.update_ms.train"},
       "demo1-fwd": {"driver.enqueue_ms.fwd", "driver.wait_ms.fwd"}}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_span_window(cell, monkeypatch):
    load, seen = core.load_metric, []

    def spy(name):
        mod = load(name)
        read = mod.read

        class Reader:
            @staticmethod
            def read(ctx):
                seen.append((name, "program" in ctx))
                return read(ctx)
        return Reader
    monkeypatch.setattr(core, "load_metric", spy)
    out = program.run_spans(cell, SEED, device="cpu", overrides=TINY[cell])
    assert out["correct"]
    new = {k: v for k, v in out["metrics"].items() if k in program.METRICS}
    assert set(new) == NEW[cell]
    for k, v in new.items():
        assert math.isfinite(v["value"]) and v["value"] > 0
        assert v["unit"] == program.METRICS[k]
    assert isinstance(out["breakdown"]["idle_by_span"], list)
    assert len(out["windows_s"]) == 2
    clock = out["clock"]
    assert clock is not None and len(clock["bounds_ns"]) == 2
    # every metric the benchmark has reads the first window alone
    old = [m["name"] for m in core.Cell(cell).per_layer]
    assert seen and all(has is (name in program.METRICS)
                        for name, has in seen)
    assert {n for n, _ in seen} >= set(old) | NEW[cell]


def test_idle_by_span_takes_the_innermost_open_span():
    # a [0, 100] (call 0) holding b [10, 40] holding c [20, 30], then
    # d [50, 60] under a; e [200, 300] alone; times in ns, offset 1000
    def sp(name, s, e, parent):
        return dict(name=name, start_ns=s, end_ns=e, parent=parent, call=0)
    spans = [sp("a", 0, 100, None), sp("b", 10, 40, 0), sp("c", 20, 30, 1),
             sp("d", 50, 60, 0), sp("e", 200, 300, None)]
    # gaps in us on the trace's clock: start 1e3 * t_us - 1000 ns
    gaps = [(1.025, 1.026), (1.035, 1.036), (1.045, 1.047), (1.055, 1.06),
            (1.150, 1.160), (1.250, 1.251), (0.5, 0.6)]
    out = program.idle_by_span(gaps, spans, 1000.0)
    got = {k: round(v * 1e9) for k, v in out.items()}
    assert got == {"c": 1, "b": 1, "a": 2, "d": 5, program.OUTSIDE: 110,
                   "e": 1}
    assert program.top(out)[0] == [program.OUTSIDE, out[program.OUTSIDE]]
