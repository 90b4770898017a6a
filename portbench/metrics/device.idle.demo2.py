"""Percent of the traced pass in which no operation ran on the device:
1 minus the union of the device operations' intervals
(``torch.profiler``) over the window by the host's clock."""
SOURCE, LAYER, MOVES = "device_trace", "device", "fwd_rays_per_s"


def read(ctx):
    rd = ctx["reading"]
    if ctx["work"] != "demo2" or not rd.busy_s or rd.window_s <= 0:
        return None
    return 100.0 * (1.0 - rd.busy_s / rd.window_s)
