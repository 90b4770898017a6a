"""Shared command-line plumbing of the scene drivers
(``scenes/_common.py``)."""
from __future__ import annotations

import argparse
import time


def scene_main(name, build, default_width, default_spp, default_depth,
               writer="sqrt", argv=None, flags=()):
    """Parse the standard flags, render, write the image; return the
    [H, W, 3] image.

    ``build(args) -> (scene, settings, seed)``; it compiles the scene on
    ``args.device``.  The card is the default: without ``--cpu`` a
    missing CUDA device raises.  ``writer`` is ``"sqrt"``
    (``write_image_sqrt``, the reference's gamma) or ``"linear"``
    (``write_image``, sRGB).  ``flags``: extra ``(name, argparse
    keywords)`` pairs of the scene (``cornell_box``'s ``--no-redirect``).
    """
    p = argparse.ArgumentParser(description=f"render the '{name}' scene")
    p.add_argument("--width", type=int, default=default_width)
    p.add_argument("--spp", type=int, default=default_spp)
    p.add_argument("--depth", type=int, default=default_depth)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", default=f"{name}.png")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions) "
                        "instead of the CUDA device")
    p.add_argument("--lanes", type=int, default=1 << 17,
                   help="wavefront lane-pool size")
    for flag, kw in flags:
        p.add_argument(flag, **kw)
    args = p.parse_args(argv)

    import torch
    import raytrace_tpu_torch as rt
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; pass --cpu to render "
                           "on the CPU")
    args.device = "cpu" if args.cpu else "cuda"

    scene, settings, seed = build(args)
    if args.seed is not None:
        seed = args.seed
    t0 = time.perf_counter()
    img = rt.render(scene, settings, seed=seed, n_lanes=args.lanes,
                    progress=True).cpu()
    dt = time.perf_counter() - t0
    rays = (settings.image_width * settings.image_height
            * settings.samples_per_pixel)
    print(f"{name}: {dt:.1f}s, {rays / dt / 1e6:.2f}M primary rays/s")
    if writer == "sqrt":
        rt.write_image_sqrt(args.out, img)
    else:
        rt.write_image(args.out, img)
    print(f"wrote {args.out}")
    return img
