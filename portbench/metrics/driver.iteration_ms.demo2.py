"""Milliseconds an iteration of the traced pass: the traced window by
the host's clock over the stationary driver's iterations
(``with_stats``)."""
SOURCE, LAYER, MOVES = "host_clock", "driver", "fwd_rays_per_s"


def read(ctx):
    c, rd = ctx["counters"], ctx["reading"]
    if ctx["work"] != "demo2" or not c.get("iterations"):
        return None
    return 1e3 * rd.window_s / c["iterations"]
