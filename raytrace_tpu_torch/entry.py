"""Driver entry points (``__graft_entry__.py``) on the port's Cornell box
(``scenes/cornell_box.py``).

* :func:`entry`: the single-GPU forward step (``render_tile`` of a tile)
  and example arguments.
* :func:`dryrun_multichip`: the sharded forward render and one full
  sharded train step (forward, backward, all-reduced gradients, update)
  over a mesh of ``n_devices`` ranks, on tiny shapes.

Run ``python -m raytrace_tpu_torch.entry [--cpu]`` for both at one rank.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def entry(device="cuda"):
    """``(fn, example_args)``: the bounded-depth forward of a tile
    (``diff/gradients.py:render_tile``) on the Cornell box at 16 x 16, 4
    spp, depth 6."""
    from .core import rng
    from .diff.gradients import render_tile
    from .scenes import cornell_box

    scene, settings = cornell_box.scene(16, 4, 6, device)
    n_pix = settings.image_width * settings.image_height
    args = (scene, settings, rng.base_key(0, scene.device),
            torch.arange(n_pix, dtype=torch.int32),
            torch.arange(settings.samples_per_pixel, dtype=torch.int32))
    return render_tile, args


def dryrun_multichip(n_devices: int, device="cuda") -> tuple[float, float]:
    """One sharded forward and train step on a mesh of ``n_devices``
    ranks (the process group's world; one process without one): the
    Cornell box at 16 x 16, 4 spp, depth 3 and ``LANE_ALIGN`` lanes a rank
    (the JAX package's 8 x 8 has too few pixels for the wavefront's
    128-lane blocks).  Returns ``(loss, param_delta)``; raises on a
    non-finite loss or a step that moved nothing."""
    from .core import rng
    from .diff.gradients import leaves
    from .parallel.sharding import (
        make_mesh, sharded_render_fn, sharded_train_step_fn,
    )
    from .render.integrator import LANE_ALIGN
    from .scenes import cornell_box

    scene, settings = cornell_box.scene(16, 4, 3, device)
    mesh = make_mesh(n_devices)
    n_pix = settings.image_width * settings.image_height
    pixel_ids = (torch.arange(LANE_ALIGN * mesh.size) % n_pix).to(torch.int32)
    sample_ids = torch.arange(settings.samples_per_pixel, dtype=torch.int32)
    key = rng.base_key(0, scene.device)

    target = sharded_render_fn(mesh)(scene, settings, key, pixel_ids,
                                     sample_ids)
    if target.shape != (pixel_ids.shape[0], 3):
        raise AssertionError(f"sharded render: shape {tuple(target.shape)}")
    step = sharded_train_step_fn(mesh, settings, lr=1e-3)
    loss, scene2 = step(scene, key, pixel_ids, sample_ids, target + 0.01)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: non-finite loss {loss}")
    a, b = leaves(scene), leaves(scene2)
    moved = sum(float((a[k] - b[k]).abs().sum()) for k in a
                if a[k].is_floating_point())
    if not moved > 0.0:
        raise AssertionError("dryrun_multichip: the step moved nothing")
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f} "
          f"param_delta={moved:.3e}")
    return loss, moved


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    dev = "cpu" if ap.parse_args().cpu else "cuda"
    fn, args = entry(dev)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), float(out.mean()))
    dryrun_multichip(1, dev)
