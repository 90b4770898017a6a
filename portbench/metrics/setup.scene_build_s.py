"""Seconds to build and compile the scene from the configuration's data
(the scene API and ``compile_scene``) and make its camera, by the host's
clock around the harness's calls."""
SOURCE, LAYER, MOVES = "host_clock", "scene", "setup_s"


def read(ctx):
    return ctx["spans"].get("setup.scene_build_s")
