"""One rank of a multi-process render (``tools/multihost_worker.py``).

Joins the job through :func:`.multihost.initialize` (explicit ranks over
TCP on ``localhost:PORT``, or torchrun's environment), renders a scene
through :func:`.multihost.render`, the all-gather of the pixel blocks
included, and with ``--train`` takes the loss and gradients of one
sharded train step (:func:`.sharding.sharded_train_step_fn`) over
``--train-lanes`` lanes against a zero target.  Rank 0 writes ``--out``
(an ``.npz``: ``image``, and ``loss`` and ``grad/<leaf>`` with
``--train``)::

    python -m raytrace_tpu_torch.parallel.worker --pid K --nproc N \\
        --port P --out F.npz [--cpu] [--backend gloo]
    torchrun --nproc_per_node=N -m raytrace_tpu_torch.parallel.worker \\
        --out F.npz

Scenes: ``test`` (the scene of the JAX worker: a white floor, a red
sphere and a light, 24 x 24, 4 spp, depth 4, background 0.1) or
``cornell`` (``scenes/cornell_box.py``).
"""
from __future__ import annotations

import argparse

import numpy as np

# the render key's seed (the JAX worker's)
SEED = 3


def worker_world(rt):
    """The JAX worker's scene: a white floor, a red sphere, a light."""
    red = rt.lambertian(rt.constant_texture([0.65, 0.05, 0.05]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    light = rt.light_source(rt.constant_texture([5.0, 5.0, 5.0]))
    return rt.group([
        rt.with_material(white, rt.parallelogram([0, 0, 0], [4, 0, 0],
                                                 [0, 0, 4])),
        rt.with_material(red, rt.sphere([2, 1, 2], 1.0)),
        rt.with_material(light, rt.parallelogram([1, 3.5, 1], [2, 0, 0],
                                                 [0, 0, 2])),
    ])


def worker_settings(rt, width: int = 24, spp: int = 4, depth: int = 4):
    return rt.CameraSettings(
        center=np.asarray([2.0, 2.0, -4.0]),
        look_at=np.asarray([2.0, 1.0, 2.0]),
        vfov=0.9, aspect_ratio=1.0, image_width=width,
        samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.1))


def build(name: str, width: int, spp: int, depth: int, device):
    """``(scene, settings)`` of the named scene on ``device``."""
    import raytrace_tpu_torch as rt
    if name == "cornell":
        from ..scenes import cornell_box
        return cornell_box.scene(width, spp, depth, device)
    return (rt.compile_scene(worker_world(rt), device=device),
            worker_settings(rt, width, spp, depth))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--scene", choices=("test", "cornell"), default="test")
    ap.add_argument("--width", type=int, default=24)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--train-lanes", type=int, default=512)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..core import rng
    from ..diff.gradients import leaves
    from . import multihost
    from .sharding import make_mesh, sharded_train_step_fn

    addr = None if args.port is None else f"localhost:{args.port}"
    dev = multihost.initialize(addr, args.nproc, args.pid,
                               device="cpu" if args.cpu else "cuda",
                               backend=args.backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.nproc is not None and world != args.nproc:
        raise RuntimeError(f"joined a world of {world}, not {args.nproc}")

    scene, settings = build(args.scene, args.width, args.spp, args.depth,
                            dev)
    out = {"image": multihost.render(scene, settings, seed=SEED)}
    if args.train:
        n_pix = settings.image_width * settings.image_height
        pix = (torch.arange(args.train_lanes) % n_pix).to(torch.int32)
        step = sharded_train_step_fn(make_mesh(sp=1), settings)
        loss, grads = step.loss_and_grads(
            scene, rng.base_key(SEED, dev), pix,
            torch.arange(settings.samples_per_pixel),
            torch.zeros((args.train_lanes, 3)))
        out["loss"] = float(loss)
        out.update({f"grad/{k}": v.cpu().numpy()
                    for k, v in leaves(grads).items()})
    if rank == 0 and args.out:
        np.savez(args.out, **out)
    print(f"proc {rank}: ok, img mean {float(out['image'].mean()):.6f}"
          + (f", loss {out['loss']:.6f}" if args.train else ""), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
