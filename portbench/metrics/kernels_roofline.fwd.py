"""Share of the roofline of the program's own kernels in the traced
window: the least time the card needs for the problem's work
(``rooflines/fwd.py``) over the device time of the kernels whose
names are ``__global__`` functions of ``raytrace_tpu_torch/csrc/`` or
``@triton.jit`` functions of the package, in percent."""
from portbench import rooflines

SOURCE, LAYER, MOVES = "device_trace", "kernels", "fwd_rays_per_s"


def read(ctx):
    if ctx["work"] != "fwd":
        return None
    return rooflines.share("fwd", ctx["counters"],
                           ctx["reading"].port_kernel_s)
