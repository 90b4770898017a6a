"""Milliseconds of a train step's update on the host: the mean duration
of the program's ``step.update`` spans in the span window (the
optimizer rebuilt from its state, ``opt.step()``, the new scene;
``parallel/sharding.py``)."""
from portbench import program

SOURCE, LAYER, MOVES = ("program_span", "autograd step and glue",
                        "train_rays_per_s")


def read(ctx):
    if ctx["work"] != "train" or not ctx.get("program"):
        return None
    return program.mean_ms(ctx["program"], "step.update")
