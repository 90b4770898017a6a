"""Milliseconds the host waits on a forward-driver iteration's read of
its loop condition (``bool(...)``: the host blocked until the card has
drained the iteration): the mean duration of the program's
``driver.wait`` spans in the span window (``render/integrator.py:
_turns``, ``portbench/program.py``)."""
from portbench import program

SOURCE, LAYER, MOVES = "program_span", "driver", "fwd_rays_per_s"


def read(ctx):
    if ctx["work"] != "fwd" or not ctx.get("program"):
        return None
    return program.mean_ms(ctx["program"], "driver.wait")
