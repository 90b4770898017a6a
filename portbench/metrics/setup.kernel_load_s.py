"""Seconds of the kernels' load in set-up (``ops._build.load_library``:
the library built or found in ``_build/`` and bound), by the host's
clock around the harness's call."""
SOURCE, LAYER, MOVES = "host_clock", "build", "setup_s"


def read(ctx):
    return ctx["spans"].get("setup.kernel_load_s")
