"""lommelSeeligerTest (``scenes/lommel_seeliger_test.py``, reference
``test/Main.hs:346-360``): a Lommel-Seeliger moon-like sphere lit by a
spherical light, with redirection toward a quad in front of the light.
500 px, 500 spp, depth 10, seed 55, written linear; kernel A."""
from __future__ import annotations

from ._common import scene_main

NAME = "lommel_seeliger_test"
SEED = 55
DEFAULTS = (500, 500, 10)
WRITER = "linear"


def world(rt):
    return rt.group([
        rt.with_material(rt.lommel_seeliger(rt.constant_texture(1.0)),
                         rt.sphere([0, 0, -2], 1)),
        rt.with_material(rt.light_source(rt.constant_texture(160.0)),
                         rt.sphere([0, 0, 22], 1)),
    ])


def settings(rt, width: int = 500, spp: int = 500, depth: int = 10):
    return rt.CameraSettings(
        image_width=width, samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.0),
    ).with_redirect_targets([(0.5, [-1, -1, 21], [2, 0, 0], [0, 2, 0])])


def build(args):
    import raytrace_tpu_torch as rt
    return (rt.compile_scene(world(rt), device=args.device),
            settings(rt, args.width, args.spp, args.depth), SEED)


def main(argv=None):
    return scene_main(NAME, build, *DEFAULTS, writer=WRITER, argv=argv)


if __name__ == "__main__":
    main()
