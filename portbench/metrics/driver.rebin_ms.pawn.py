"""Milliseconds of host time an iteration of the sorted driver spends
enqueuing its re-bin (the sort key, the argsort, the lane state's
permutation): the summed durations of the program's ``driver.rebin``
spans over the pass rendered under the recorder
(``render/integrator.py:trace_wavefront_sorted``), over the driver's
iterations."""
SOURCE, LAYER, MOVES = "program_span", "driver", "fwd_rays_per_s"


def read(ctx):
    c = ctx["counters"]
    spans = c.get("span_s") or {}
    if ctx["work"] != "pawn" or "driver.rebin" not in spans \
            or not c.get("iterations"):
        return None
    return 1e3 * spans["driver.rebin"] / c["iterations"]
