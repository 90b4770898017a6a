"""Rendering over several processes (``raytrace_tpu/parallel/multihost.py``):
every process joins one ``torch.distributed`` job, owns one GPU, and runs
the sharded persistent wavefront (:mod:`.sharding`) on its block of the
pixels.  The scene is small and replicated; the only traffic is the final
all-gather of the radiance sums.  The RNG is keyed on absolute (pixel,
sample) ids, so the image does not depend on the number of processes but
for the order of float sums.

Usage (one process a GPU, e.g. ``torchrun --nproc_per_node=N``)::

    from raytrace_tpu_torch.parallel import multihost
    dev = multihost.initialize()          # torchrun's environment
    img = multihost.render(scene, settings, seed=0)   # on every rank
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core import rng
from .sharding import Mesh, make_mesh, sharded_wavefront_render_fn

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _bind(device: str, local_rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("multihost: no CUDA device; pass device='cpu' "
                           "to run on the CPU")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device: str = "cuda",
               backend: str | None = None,
               timeout_s: float = 300.0) -> torch.device:
    """Join (or start) a job of one process a device; return this
    process's device.

    * Explicit arguments (``coordinator_address`` ``"host:port"``,
      ``num_processes``, ``process_id``): the process group over TCP.
    * No arguments: torchrun's environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``).
    * Neither: a single process, no process group (as the JAX package's).

    A request that fails raises (after ``timeout_s`` where a peer does not
    come); it never stays local.  ``device="cuda"`` binds
    ``cuda:LOCAL_RANK`` (explicit ranks without ``LOCAL_RANK``: the
    process id modulo the devices); ``backend`` defaults to NCCL on CUDA
    and gloo on the CPU (gloo also takes CUDA tensors)."""
    explicit = (coordinator_address, num_processes, process_id) != (
        None, None, None)
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("multihost.initialize: give coordinator_address,"
                             " num_processes and process_id together")
        rank, world = int(process_id), int(num_processes)
        init = f"tcp://{coordinator_address}"
        n_dev = torch.cuda.device_count() if device != "cpu" else 1
        local = int(os.environ.get("LOCAL_RANK", rank % max(n_dev, 1)))
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        return _bind(device, 0)
    dev = _bind(device, local)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError("multihost.initialize: another process group "
                               "is already initialized")
        return dev
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def global_mesh() -> Mesh:
    """The ``(dp, sp) = (ranks, 1)`` mesh over every process's device:
    pixel blocks only, in rank order."""
    return make_mesh(sp=1)


def render(scene, settings, seed: int = 0, spp: int | None = None,
           mesh: Mesh | None = None) -> np.ndarray:
    """Render the whole image sharded over every rank: each returns the
    complete ``[H, W, 3]`` image (an all-gather of the pixel blocks' sums,
    the only communication)."""
    mesh = mesh or global_mesh()
    spp = spp if spp is not None else settings.samples_per_pixel
    h, w = settings.image_height, settings.image_width
    n_pix = h * w
    fn = sharded_wavefront_render_fn(mesh, n_pix, spp)
    acc = fn(scene, settings, rng.base_key(seed, scene.device))
    return (acc[:n_pix] / spp).cpu().numpy().reshape(h, w, 3)
