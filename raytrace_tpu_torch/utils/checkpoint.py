"""Progressive-render checkpoint and resume
(``raytrace_tpu/utils/checkpoint.py``).

A render is an accumulation of per-pixel radiance sums and a sample
count (``render/render.py:render_accumulate``), so saving that pair
resumes a render exactly.  The ``.npz`` keys are the JAX package's
(``acc``, ``spp_done``, ``meta_*``), so a checkpoint written by either
package resumes in the other.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, acc, spp_done: int, *,
                    meta: dict | None = None):
    """Write the (radiance-sum, samples-done) accumulator to ``path``
    (.npz)."""
    a = acc.detach().cpu().numpy() if isinstance(acc, torch.Tensor) \
        else np.asarray(acc)
    np.savez(path, acc=a, spp_done=int(spp_done),
             **({f"meta_{k}": v for k, v in (meta or {}).items()}))


def load_checkpoint(path: str, device="cuda"):
    """Read ``(acc, spp_done)`` back: the accumulator as an f32 tensor on
    ``device`` (the card unless the caller asks for the CPU) and the
    sample count."""
    data = np.load(path)
    acc = torch.from_numpy(np.asarray(data["acc"], np.float32)).to(device)
    return acc, int(data["spp_done"])


def render_resumable(scene, settings, path: str, seed: int = 0, *,
                     spp: int | None = None, spp_per_checkpoint: int = 16,
                     **render_kwargs):
    """Render with a checkpoint at ``path`` after every
    ``spp_per_checkpoint`` samples, resuming from it if it exists.
    Returns the final image [H, W, 3] as numpy."""
    from ..render.render import render_accumulate

    spp = spp if spp is not None else settings.samples_per_pixel
    acc, done = (load_checkpoint(path, scene.device)
                 if os.path.exists(path) else (None, 0))
    while done < spp:
        n = min(spp_per_checkpoint, spp - done)
        acc, done = render_accumulate(scene, settings, seed, spp=n, acc=acc,
                                      spp_done=done, **render_kwargs)
        save_checkpoint(path, acc, done)
    h, w = settings.image_height, settings.image_width
    return (acc / done).reshape(h, w, 3).cpu().numpy()
