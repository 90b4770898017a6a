"""Share of the roofline of the program's own kernels in the traced
window: the least time the card needs for the problem's work
(``rooflines/train.py``) over the device time of the kernels whose
names are ``__global__`` functions of ``raytrace_tpu_torch/csrc/`` or
``@triton.jit`` functions of the package, in percent."""
from portbench import rooflines

SOURCE, LAYER, MOVES = "device_trace", "kernels", "train_rays_per_s"


def read(ctx):
    if ctx["work"] != "train":
        return None
    return rooflines.share("train", ctx["counters"],
                           ctx["reading"].port_kernel_s)
