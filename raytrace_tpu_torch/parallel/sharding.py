"""Sharding over several GPUs (``raytrace_tpu/parallel/sharding.py``):
one process a GPU, the ranks of the default ``torch.distributed`` process
group laid out as a ``(dp, sp)`` :class:`Mesh`.

* **dp**: data parallel over pixels; each rank owns a block of them.
* **sp**: sample parallel over the samples of a pixel; the per-pixel mean
  is a sum over the sp ranks, weighted by each rank's sample count.
* The scene is replicated: every rank holds all of it on its device.

The RNG is keyed on absolute (pixel, sample) coordinates
(``core/rng.py``), so the image does not depend on the mesh's shape but
for the order of float sums.  Gradients are partial sums on each rank,
all-reduced in one buffer before the update, which every rank applies to
its replica alike.

A world of one process needs no process group: :func:`make_mesh` gives
the mesh ``(1, 1)`` and the functions below run no collective.  With a
process group, every collective runs, also over a group of one rank (so
one GPU exercises NCCL).
"""
from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist

from ..core.vecmath import DTYPE
from ..diff.gradients import (
    combine, leaves, loss_and_grads, map_scene, partition, render_tile,
)
from ..render.integrator import LANE_ALIGN
from ..render.render import _stationary_fn, rotate_k_for
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, sp)`` grid of the process group's ranks, row-major: rank
    ``r`` sits at ``(r // sp, r % sp)``.  ``groups`` maps ``"dp"``,
    ``"sp"`` and ``"world"`` to this rank's process groups along each
    axis (empty without a process group)."""
    dp: int
    sp: int
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp, self.sp)

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.sp)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``."""
        group = self.groups.get(axis)
        if group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axis: str) -> list:
        """``x`` of every rank along ``axis``, in the axis's order (each
        rank's ``x`` of the same shape)."""
        group = self.groups.get(axis)
        if group is None:
            return [x]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return out


def make_mesh(n_devices: int | None = None, sp: int | None = None) -> Mesh:
    """The ``(dp, sp)`` mesh over the process group's ranks (one device a
    rank; without a process group, the one process).  ``n_devices``, if
    given, must be the world's size.  ``sp`` (sample-parallel width)
    defaults to 2 where the world is even and over 1, else 1.  Every rank
    must call it, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: {n} devices, but the process group "
                         f"has {world} ranks (one device a rank; a mesh "
                         "spans them all)")
    if sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
    if n % sp:
        raise ValueError(f"make_mesh: n_devices={n} not divisible by sp={sp}")
    dp = n // sp
    if not dist.is_initialized():
        return Mesh(dp, sp)
    rank = dist.get_rank()

    def group(ranks):
        return (dist.group.WORLD if len(ranks) == world
                else dist.new_group(ranks))

    groups = {"world": dist.group.WORLD}
    # every rank creates every group, rows then columns
    for i in range(dp):
        ranks = [i * sp + j for j in range(sp)]
        g = group(ranks)
        if rank in ranks:
            groups["sp"] = g
    for j in range(sp):
        ranks = [i * sp + j for i in range(dp)]
        g = group(ranks)
        if rank in ranks:
            groups["dp"] = g
    return Mesh(dp, sp, rank, groups)


def sharded_render_fn(mesh: Mesh):
    """The sharded bounded-depth render of a tile
    (``diff/gradients.py:render_tile``).

    ``fwd(scene, settings, key, pixel_ids[P], sample_ids[S]) -> [P, 3]``:
    the pixels split in contiguous blocks over dp, the samples over sp;
    each rank's sample mean, weighted by its sample count, is summed over
    sp, and the blocks gathered over dp, so every rank returns the whole
    ``[P, 3]``."""
    def fwd(scene, settings, key, pixel_ids, sample_ids):
        dev = scene.device
        pix = torch.as_tensor(pixel_ids).to(dev, torch.int32)
        smp = torch.as_tensor(sample_ids).to(dev, torch.int32)
        i, j = mesh.coords
        blocks = torch.tensor_split(pix, mesh.dp)
        mine, my_smp = blocks[i], torch.tensor_split(smp, mesh.sp)[j]
        part = torch.zeros((blocks[0].shape[0], 3), dtype=DTYPE, device=dev)
        if mine.numel() and my_smp.numel():
            part[:mine.shape[0]] = render_tile(
                scene, settings, key, mine, my_smp) * my_smp.shape[0]
        part = mesh.all_reduce(part, "sp") / smp.shape[0]
        return torch.cat([g[:b.shape[0]] for g, b in
                          zip(mesh.all_gather(part, "dp"), blocks)])
    return fwd


def sharded_wavefront_render_fn(mesh: Mesh, n_pix: int, spp: int):
    """The production forward render over every rank of the mesh: each
    rank runs the stationary driver (``render.py:_stationary_fn``: the
    pixel-stationary wavefront, or the sorted one for mesh-scale scenes)
    on its own contiguous pixel block ``[r * block, (r + 1) * block)``,
    ``block = ceil(n_pix / (ranks * LANE_ALIGN)) * LANE_ALIGN``, at the
    rotation ``rotate_k_for(spp)``; nothing crosses ranks until the
    radiance sums are gathered.

    Returns ``render(scene, settings, key) -> acc[ranks * block, 3]``:
    radiance sums (divide by ``spp``); slice ``[:n_pix]`` for the image.
    A rank drives only its block's pixels inside the image (the JAX
    package's also traces the last block's padding, then drops it): the
    padding rows are zero, and at one rank the sums are
    ``render_accumulate``'s own."""
    block = -(-n_pix // (mesh.size * LANE_ALIGN)) * LANE_ALIGN
    rot = rotate_k_for(spp)

    def render(scene, settings, key):
        off = mesh.rank * block
        n_mine = max(0, min(block, n_pix - off))
        acc = torch.zeros((block, 3), dtype=DTYPE, device=scene.device)
        if n_mine:
            acc[:n_mine] = _stationary_fn(scene, settings, key, n_mine, spp,
                                          0, rot, off)
        return torch.cat(mesh.all_gather(acc, "world"))

    return render


def sharded_train_step_fn(mesh: Mesh, settings, lr: float = 1e-2,
                          optimizer=None, spp: int | None = None,
                          n_iters: int | None = None, schedule=None):
    """The sharded inverse-rendering train step on the differentiable
    regenerative wavefront (``diff/gradients.py:render_loss_wavefront``:
    kernel B forward, K5 backward).

    ``step(scene, key, pixel_ids, sample_ids, target) -> (loss, scene')``:
    the lanes ``pixel_ids[P]`` split in equal contiguous blocks over every
    rank (the wavefront is pixel-stationary: the lane axis is its only
    parallel axis; ``sample_ids`` only sets ``spp = len(sample_ids)``
    unless ``spp`` is given), the MSE against ``target[P, 3]``, each
    rank's loss and gradients weighted by its share of the pixels and
    all-reduced, so both are the global MSE's; then the update of every
    float leaf of the replicated scene.  Each block must be a whole
    multiple of ``LANE_ALIGN`` lanes: the step raises rather than pad, as
    padding would enter the loss.  ``schedule`` (compaction phases in
    absolute lane counts, which would mean another thing on each rank's
    block) is refused: the JAX package's sharded step runs none.

    ``optimizer``: a factory ``f(params) -> torch.optim.Optimizer`` (the
    JAX package takes an optax transformation; ``torch.optim.SGD`` and
    ``torch.optim.Adam`` compute optax's ``sgd`` and ``adam``); default
    SGD at ``lr``.  Scene parameters span very different scales, so a
    scale-invariant optimizer (Adam) is the one for real inverse
    rendering.  ``step.init(scene)`` gives the initial optimizer state,
    ``step.with_state(scene, opt_state, key, pixel_ids, sample_ids,
    target) -> (loss, scene', opt_state')`` carries it (the state is the
    optimizer's ``state_dict``, never changed in place), and
    ``step.loss_and_grads(scene, key, pixel_ids, sample_ids, target) ->
    (loss, grads)`` gives the all-reduced loss and gradients alone.

    Spans (``utils/profiling.py``): ``step`` around ``with_state``, and
    inside it ``step.loss_and_grads`` (the forward and, in
    ``gradients._grads``, ``step.backward``), ``step.allreduce`` (the
    flat buffer's all-reduce) and ``step.update`` (the optimizer's
    rebuild and step, the new scene)."""
    if schedule is not None:
        raise ValueError("sharded_train_step_fn: no compaction schedule "
                         "(its widths are absolute lane counts, which mean "
                         "another thing on each rank's block)")
    make_opt = optimizer or (lambda ps: torch.optim.SGD(ps, lr=lr))

    def block(n: int) -> int:
        w = mesh.size
        if n % w or (n // w) % LANE_ALIGN:
            raise ValueError(
                f"sharded_train_step_fn: {n} pixels over {w} ranks: each "
                f"rank's block must be a whole multiple of {LANE_ALIGN} "
                f"lanes (give a multiple of {w * LANE_ALIGN} pixels); the "
                "step pads nothing, as padding would enter the loss")
        return n // w

    def grads_on_mesh(scene, key, pixel_ids, sample_ids, target):
        n = pixel_ids.shape[0]
        b = block(n)
        lo = mesh.rank * b
        dev = scene.device
        params, statics = partition(scene)
        n_s = spp if spp is not None else len(sample_ids)
        with profiling.span("step.loss_and_grads"):
            (loss, _), grads = loss_and_grads(
                params, statics, settings, key,
                pixel_ids[lo:lo + b].to(dev, torch.int32),
                target[lo:lo + b].to(dev), spp=n_s, n_iters=n_iters)
        # one all-reduce of the loss and every gradient leaf, each rank's
        # weighted by its share of the pixels
        gs = list(leaves(grads).values())
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in gs])
        with profiling.span("step.allreduce"):
            flat = mesh.all_reduce(flat * (b / n), "world")
        parts = torch.split(flat[1:], [g.numel() for g in gs])
        by_id = {id(g): p.view_as(g) for g, p in zip(gs, parts)}
        return flat[0], params, statics, map_scene(lambda g: by_id[id(g)],
                                                   grads)

    def new_optimizer(params, opt_state):
        named = leaves(params)
        new = {k: v.detach().clone() for k, v in named.items()}
        opt = make_opt(list(new.values()))
        if opt_state is not None:
            opt.load_state_dict(copy.deepcopy(opt_state))
        return opt, named, new

    def init(scene):
        return new_optimizer(partition(scene)[0], None)[0].state_dict()

    @profiling.spanned("step")
    def with_state(scene, opt_state, key, pixel_ids, sample_ids, target):
        loss, params, statics, grads = grads_on_mesh(
            scene, key, pixel_ids, sample_ids, target)
        with profiling.span("step.update"):
            opt, named, new = new_optimizer(params, opt_state)
            for k, g in leaves(grads).items():
                new[k].grad = g
            opt.step()
            by_id = {id(named[k]): new[k] for k in new}
            scene2 = combine(map_scene(lambda p: by_id[id(p)], params),
                             statics)
            state = opt.state_dict()
        return loss, scene2, state

    def step(scene, key, pixel_ids, sample_ids, target):
        loss, scene2, _ = with_state(scene, init(scene), key, pixel_ids,
                                     sample_ids, target)
        return loss, scene2

    def loss_and_grads_fn(scene, key, pixel_ids, sample_ids, target):
        loss, _, _, grads = grads_on_mesh(scene, key, pixel_ids, sample_ids,
                                          target)
        return loss, grads

    step.init = init
    step.with_state = with_state
    step.loss_and_grads = loss_and_grads_fn
    return step
