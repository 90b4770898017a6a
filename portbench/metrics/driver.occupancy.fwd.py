"""Wavefront occupancy of the traced pass: the drivers' own segment
count over their iterations times lanes (``with_stats``), the
arithmetic of ``utils/profiling.py:RenderStats``."""
SOURCE, LAYER, MOVES = "program_counter", "driver", "fwd_rays_per_s"


def read(ctx):
    c = ctx["counters"]
    if not c.get("lane_iterations"):
        return None
    return c["segments"] / c["lane_iterations"]
