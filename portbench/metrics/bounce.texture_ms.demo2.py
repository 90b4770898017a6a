"""Milliseconds of host time an iteration spends in the split bounce's
rich-texture multiply (the earth's texels, the marble's stripes through
K12, the compaction of their lanes): the summed durations of the
program's ``bounce.texture`` spans over the pass rendered under the
recorder (``render/integrator.py:bounce_split_soa``), over the driver's
iterations."""
SOURCE, LAYER, MOVES = "program_span", "bounce", "fwd_rays_per_s"


def read(ctx):
    c = ctx["counters"]
    spans = c.get("span_s") or {}
    if ctx["work"] != "demo2" or "bounce.texture" not in spans \
            or not c.get("iterations"):
        return None
    return 1e3 * spans["bounce.texture"] / c["iterations"]
