"""Wavefront occupancy of the fused differentiable driver in the span
window: the lanes alive or dying after kernel B's step, summed over the
iterations (``diff.segments``), over the iterations times lanes
(``diff.lane_iterations``), both the program's own counters
(``render/integrator.py:_trace_wavefront_diff_fused``)."""
SOURCE, LAYER, MOVES = "program_counter", "driver", "train_rays_per_s"


def read(ctx):
    prog = ctx.get("program")
    if ctx["work"] != "train" or not prog:
        return None
    c = prog["counters"]
    if not c.get("diff.lane_iterations"):
        return None
    return c["diff.segments"] / c["diff.lane_iterations"]
