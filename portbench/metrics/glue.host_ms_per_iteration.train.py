"""Host milliseconds a fused differentiable iteration costs, forward and
backward: the summed durations of the program's ``diff.fwd_iter`` spans
(the step and its accumulation adds) and ``diff.bwd_iter`` spans (K5,
the row gradients, the leaves) in the span window, over its iterations
(``diff.iterations``: steps x ``n_iters``)."""
from portbench import program

SOURCE, LAYER, MOVES = ("program_span", "autograd step and glue",
                        "train_rays_per_s")


def read(ctx):
    prog = ctx.get("program")
    if ctx["work"] != "train" or not prog:
        return None
    n = prog["counters"].get("diff.iterations")
    if not n:
        return None
    return sum(program.durations_ms(prog, "diff.fwd_iter")
               + program.durations_ms(prog, "diff.bwd_iter")) / n
