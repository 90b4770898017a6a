"""Share of the roofline of the program's own kernels in the traced
pass: the least time the card needs for the problem's work
(``rooflines/demo2.py``) over the device time of the kernels whose names
are ``__global__`` functions of ``raytrace_tpu_torch/csrc/`` or
``@triton.jit`` functions of the package, in percent."""
from portbench import rooflines

SOURCE, LAYER, MOVES = "device_trace", "kernels", "fwd_rays_per_s"


def read(ctx):
    c = ctx["counters"]
    if ctx["work"] != "demo2" or c.get("medium_segments") is None \
            or c.get("texture_lanes") is None:
        return None
    return rooflines.share("demo2", c, ctx["reading"].port_kernel_s)
