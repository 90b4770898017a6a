"""Host kernel-launch calls in the traced pass over the stationary
driver's iterations: the program's kernels and the torch ops of the
driver's turn and of the split bounce around them.  A count, so it
repeats exactly for a seed."""
SOURCE, LAYER, MOVES = "device_trace", "driver", "fwd_rays_per_s"


def read(ctx):
    c, rd = ctx["counters"], ctx["reading"]
    if ctx["work"] != "demo2" or not rd.host_launches \
            or not c.get("iterations"):
        return None
    return rd.host_launches / c["iterations"]
