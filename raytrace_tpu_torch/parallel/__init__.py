"""Several GPUs and several processes (``raytrace_tpu/parallel``): one
process a GPU over ``torch.distributed`` (NCCL on CUDA, gloo on the CPU).

* :mod:`.sharding`: the ``(dp, sp)`` :class:`~.sharding.Mesh` over the
  ranks, the sharded bounded-depth render, the sharded persistent
  wavefront and the sharded inverse-rendering train step;
* :mod:`.multihost`: joining a job (explicit arguments or torchrun's
  environment) and the full image on every rank;
* :mod:`.worker`: one rank of a multi-process render, for torchrun or
  explicit ranks.
"""
