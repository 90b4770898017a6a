"""Milliseconds of host time a forward-driver iteration takes to enqueue
its kernels and glue: the mean duration of the program's
``driver.iteration`` spans in the span window (``render/integrator.py:
_turns``, ``portbench/program.py``)."""
from portbench import program

SOURCE, LAYER, MOVES = "program_span", "driver", "fwd_rays_per_s"


def read(ctx):
    if ctx["work"] != "fwd" or not ctx.get("program"):
        return None
    return program.mean_ms(ctx["program"], "driver.iteration")
