"""Host kernel-launch calls in the traced steps over steps x
``n_iters``: every launch of the step, the program's kernels and the
torch ops around them, an iteration.  A count, so it repeats exactly."""
SOURCE, LAYER, MOVES = ("device_trace", "autograd step and glue",
                        "train_rays_per_s")


def read(ctx):
    c, rd = ctx["counters"], ctx["reading"]
    if not rd.host_launches or not c.get("steps"):
        return None
    return rd.host_launches / (c["steps"] * c["n_iters"])
