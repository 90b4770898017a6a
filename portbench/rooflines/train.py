"""The train step's work: per lane and iteration of the fixed-length
differentiable wavefront, the forward iteration's lane columns (17 in,
19 out) and the backward's (29 in, 13 out), read once and written once:
``4 x (17 + 19) + 4 x (29 + 13)`` bytes; about 1,450 operations.  The
count is ``lanes x n_iters`` of the cell's files, a step.

Where it may overstate: the issued lane-iterations include lanes that
have finished their samples and idle until the step's last iteration.
No ray-row test is counted.
"""
LANE_ITER_BYTES = 4 * (17 + 19) + 4 * (29 + 13)
LANE_ITER_OPS = 1450


def work(c: dict) -> tuple[float, float]:
    n = float(c["lanes"]) * float(c["n_iters"]) * float(c["steps"])
    return LANE_ITER_OPS * n, LANE_ITER_BYTES * n
