"""The sorted driver's turn around its bounce (``render/integrator.py:
trace_wavefront_sorted``): HEAD before the bounce and TAIL after it.

A turn is ``argsort(key) -> HEAD -> bounce -> TAIL -> read the flag``.
HEAD gathers the lane state through the re-bin's permutation, gives the
dead lanes fresh work items (the queue), draws every lane's counter-hash
uniforms and the thin-lens ray of each lane that starts a sample; TAIL
takes the bounce's results through the depth cap and Russian roulette,
adds the finished paths into their pixels (the flush), writes the lane
state and the next turn's sort key, and sets the loop's flag.  The JAX
package's sorted driver is XLA: no TPU kernel stands behind these.

* :class:`SortedLanes` is the lane state between turns and the control
  words (:func:`sorted_lanes` makes the first turn's);
* :class:`SortedTurn` holds a driver call's statics;
* :func:`sorted_head` and :func:`sorted_tail` launch
  ``csrc/sorted_turn.cu`` for CUDA tensors and run
  :func:`sorted_head_plain` and :func:`sorted_tail_plain`, the driver's
  torch lines, for CPU tensors.

The control words ``ctl`` (int64 [5]): ``next_w`` in ``ctl[par]`` and the
count of live lanes in ``ctl[2 + par]``, read by HEAD with ``par`` the
turn's parity; HEAD writes the next turn's ``next_w`` into ``ctl[1 -
par]``, zeroes ``ctl[3 - par]``, which TAIL sets to the live count, and
sets the flag ``ctl[4]`` to ``next_w < total_work``; TAIL sets it if a
lane stays alive.  The kernel needs no scan for the queue: the stable
argsort puts the dead lanes (key :data:`DEAD_KEY`) after the live ones,
so the exclusive count of dead lanes before dead lane ``l`` is ``l -
n_live``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import rng
from ..core.vecmath import DTYPE
from ..render.camera import CameraSettings, rays_from_table

# origin cells per axis of the sorted driver's ray binning
SORT_CELLS = 256
# the key of a dead lane, above every live key
DEAD_KEY = 8 * SORT_CELLS ** 3
N_CTL = 5


def _spread3(x):
    """Spread the low 10 bits of int32 ``x`` to every third bit (the 3-D
    Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _sort_key(comps, alive, blo, binv):
    """Binning key of every lane: direction octant, then the Morton code
    of the origin's cell (``SORT_CELLS`` per axis over the scene box);
    dead lanes after every live one."""
    octant = ((comps[3] < 0).to(torch.int32) * 4
              + (comps[4] < 0).to(torch.int32) * 2
              + (comps[5] < 0).to(torch.int32))
    q = [torch.clamp((comps[k] - blo[k]) * binv[k] * SORT_CELLS, 0.0,
                     SORT_CELLS - 1).to(torch.int32) for k in range(3)]
    cell = _spread3(q[0]) | (_spread3(q[1]) << 1) | (_spread3(q[2]) << 2)
    return torch.where(alive, octant * SORT_CELLS ** 3 + cell, DEAD_KEY)


@dataclasses.dataclass
class SortedLanes:
    """The sorted driver's lanes between turns, in the order of the last
    re-bin: ``fstate`` [13, R] f32 (origin, direction, time, radiance,
    throughput), ``istate`` [4, R] i32 (pixel, sample, depth, alive),
    ``key`` [R] i32 (the next re-bin's sort key) and the control words
    ``ctl`` (module docstring)."""
    fstate: torch.Tensor
    istate: torch.Tensor
    key: torch.Tensor
    ctl: torch.Tensor

    def more(self) -> bool:
        """The loop's condition: work items left or a lane alive (a read
        that waits for the card)."""
        return bool(self.ctl[4])


def sorted_lanes(lanes: int, total_work: int, device) -> SortedLanes:
    """The first turn's lanes: every lane dead (its key :data:`DEAD_KEY`),
    a dummy unit direction (0, 0, 1), no work taken."""
    fstate = torch.zeros((13, lanes), dtype=DTYPE, device=device)
    fstate[5] = 1.0
    ctl = torch.zeros((N_CTL,), dtype=torch.int64, device=device)
    ctl[4] = int(total_work > 0)
    return SortedLanes(
        fstate=fstate,
        istate=torch.zeros((4, lanes), dtype=torch.int32, device=device),
        key=torch.full((lanes,), DEAD_KEY, dtype=torch.int32, device=device),
        ctl=ctl)


@dataclasses.dataclass
class SortedTurn:
    """A sorted driver call's statics: the camera ``s`` and its table
    ``cam`` (``render/camera.py:camera_table``), the base key words [2]
    on the device, the scene box ``box`` [6] (its low corner, then one
    over its extent) and the work: ``n_pix`` pixels from ``pixel_offset``,
    ``total_work`` items from sample ``sample_offset``, on ``lanes``
    lanes, ``n_u`` bounce uniform columns (``n_u + 6`` drawn a lane).
    ``buffers`` and ``cam_table`` hold HEAD's outputs and the camera
    table on the card (:func:`head_buffers`)."""
    s: CameraSettings
    cam: list
    base_key: torch.Tensor
    box: torch.Tensor
    n_pix: int
    lanes: int
    total_work: int
    n_u: int
    sample_offset: int = 0
    pixel_offset: int = 0
    buffers: tuple | None = None
    cam_table: torch.Tensor | None = None


def sorted_head_plain(turn: SortedTurn, perm, st: SortedLanes, par: int):
    """:func:`sorted_head` in plain PyTorch, on any device."""
    t = turn
    fstate = st.fstate[:, perm]
    istate = st.istate[:, perm]
    comps, rad, thr = fstate[0:7], fstate[7:10], fstate[10:13]
    pixel, sample, depth = istate[0], istate[1], istate[2]
    alive = istate[3] > 0

    # queue regeneration: dead lanes pull fresh work items
    next_w = st.ctl[par]
    dead = ~alive
    dead_i = dead.to(torch.int64)
    wi = next_w + torch.cumsum(dead_i, 0) - dead_i
    can = dead & (wi < t.total_work)
    w_safe = torch.clamp(wi, max=t.total_work - 1)
    pixel = torch.where(can, (w_safe % t.n_pix).to(torch.int32), pixel)
    sample = torch.where(
        can, (torch.div(w_safe, t.n_pix, rounding_mode="floor")
              + t.sample_offset).to(torch.int32), sample)
    depth = torch.where(can, 0, depth)
    alive = alive | can
    next_w = next_w + can.sum()
    st.ctl[1 - par] = next_w
    st.ctl[3 - par] = 0
    st.ctl[4] = next_w < t.total_work

    keys = rng.ray_keys_fast(t.base_key, t.pixel_offset + pixel, sample)
    uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), t.n_u + 6)
    new_comps = rays_from_table(t.cam, t.s.image_width,
                                t.pixel_offset + pixel,
                                uniforms[t.n_u:t.n_u + 5])
    comps = torch.where(can, new_comps, comps)
    rad = rad * (1.0 - can.to(DTYPE))
    thr = torch.where(can, 1.0, thr)
    return comps, rad, thr, uniforms, torch.stack([pixel, sample, depth]), \
        alive


def sorted_tail_plain(turn: SortedTurn, st: SortedLanes, par: int, head,
                      out, acc3, segments=None):
    """:func:`sorted_tail` in plain PyTorch, on any device."""
    from ..render.integrator import _russian_roulette
    t, s = turn, turn.s
    comps, rad, thr, alive, died = out
    uniforms = head[3]
    pixel, sample, depth = head[4]
    depth = depth + 1
    capped = alive & (depth >= s.max_depth)
    died = died | capped
    alive = alive & ~capped
    if s.rr_depth is not None:
        thr, alive, died = _russian_roulette(
            s, uniforms[t.n_u + 5], depth, thr, alive, died)

    # flush: finished paths into their pixels
    acc3.index_add_(1, pixel.long(), rad * died.to(DTYPE))
    st.fstate.copy_(torch.cat([comps, rad, thr]))
    st.istate.copy_(torch.stack([pixel, sample, depth,
                                 alive.to(torch.int32)]))
    st.key.copy_(_sort_key(st.fstate, alive, t.box[0:3], t.box[3:6]))
    st.ctl[3 - par] = alive.sum()
    st.ctl[4] = st.ctl[4] | alive.any()
    if segments is not None:
        segments += (alive | died).sum()


class _HeadArgs(ctypes.Structure):
    """Mirror of ``HeadArgs`` in csrc/sorted_turn.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "perm", "fstate", "istate", "ctl", "key", "cam", "comps", "rad",
        "thr", "u", "lane", "alive")]
        + [(f, ctypes.c_int64) for f in ("n_lanes", "total_work", "n_pix")]
        + [(f, ctypes.c_int) for f in ("width", "n_cols", "n_u",
                                       "sample_offset", "pixel_offset",
                                       "par")])


class _TailArgs(ctypes.Structure):
    """Mirror of ``TailArgs`` in csrc/sorted_turn.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "comps", "rad", "thr", "alive", "died", "lane", "u_rr", "box",
        "fstate", "istate", "key", "ctl", "acc", "segments")]
        + [(f, ctypes.c_int64) for f in ("n_lanes", "n_pix")]
        + [(f, ctypes.c_int) for f in ("max_depth", "rr_depth", "par")]
        + [("rr_min", ctypes.c_float)])


def _check(name, x, shape, dtype, device):
    if (tuple(x.shape) != shape or x.dtype != dtype or x.device != device
            or not x.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous {dtype} {shape} tensor "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _check_lanes(turn: SortedTurn, st: SortedLanes, device):
    r = turn.lanes
    for name, x, shape, dtype in (
            ("fstate", st.fstate, (13, r), DTYPE),
            ("istate", st.istate, (4, r), torch.int32),
            ("key", st.key, (r,), torch.int32),
            ("ctl", st.ctl, (N_CTL,), torch.int64),
            ("base_key", turn.base_key, (2,), torch.int32),
            ("box", turn.box, (6,), DTYPE)):
        _check(name, x, shape, dtype, device)


def head_buffers(turn: SortedTurn, device) -> tuple:
    """HEAD's outputs, made once a driver call on ``device`` (with the
    camera table the kernel reads): comps [7, R], rad [3, R], thr [3, R],
    uniforms [n_u + 6, R], lane [3, R] i32, alive [R] bool."""
    if turn.buffers is None:
        r = turn.lanes
        f = lambda n: torch.empty((n, r), dtype=DTYPE, device=device)
        turn.buffers = (f(7), f(3), f(3), f(turn.n_u + 6),
                        torch.empty((3, r), dtype=torch.int32, device=device),
                        torch.empty((r,), dtype=torch.bool, device=device))
        turn.cam_table = torch.tensor(turn.cam, dtype=DTYPE, device=device)
    return turn.buffers


def head_args(turn: SortedTurn, perm, st: SortedLanes, par: int,
              buffers) -> _HeadArgs:
    """HEAD's argument struct, its results into ``buffers``
    (:func:`head_buffers`); the inputs checked."""
    r, dev = turn.lanes, perm.device
    _check("perm", perm, (r,), torch.int64, dev)
    _check_lanes(turn, st, dev)
    comps, rad, thr, u, lane, alive = buffers
    return _HeadArgs(
        perm.data_ptr(), st.fstate.data_ptr(), st.istate.data_ptr(),
        st.ctl.data_ptr(), turn.base_key.data_ptr(),
        turn.cam_table.data_ptr(), comps.data_ptr(), rad.data_ptr(),
        thr.data_ptr(), u.data_ptr(), lane.data_ptr(), alive.data_ptr(),
        r, turn.total_work, turn.n_pix, turn.s.image_width, turn.n_u + 6,
        turn.n_u, turn.sample_offset, turn.pixel_offset, par)


def tail_args(turn: SortedTurn, st: SortedLanes, par: int, head, out, acc3,
              segments=None):
    """``(TAIL's argument struct, the bounce's results made contiguous)``;
    the inputs checked (keep the results alive until the launch)."""
    r, s, dev = turn.lanes, turn.s, acc3.device
    out = tuple(x.contiguous() for x in out)
    comps, rad, thr, alive, died = out
    for name, x, shape, dtype in (
            ("comps", comps, (7, r), DTYPE), ("rad", rad, (3, r), DTYPE),
            ("thr", thr, (3, r), DTYPE), ("alive", alive, (r,), torch.bool),
            ("died", died, (r,), torch.bool),
            ("acc3", acc3, (3, turn.n_pix), DTYPE),
            ("lane", head[4], (3, r), torch.int32),
            ("uniforms", head[3], (turn.n_u + 6, r), DTYPE)):
        _check(name, x, shape, dtype, dev)
    _check_lanes(turn, st, dev)
    if segments is not None:
        _check("segments", segments, (), torch.int64, dev)
    args = _TailArgs(
        comps.data_ptr(), rad.data_ptr(), thr.data_ptr(), alive.data_ptr(),
        died.data_ptr(), head[4].data_ptr(),
        head[3][turn.n_u + 5].data_ptr(), turn.box.data_ptr(),
        st.fstate.data_ptr(), st.istate.data_ptr(), st.key.data_ptr(),
        st.ctl.data_ptr(), acc3.data_ptr(),
        None if segments is None else segments.data_ptr(), r, turn.n_pix,
        s.max_depth, -1 if s.rr_depth is None else s.rr_depth, par,
        s.rr_min)
    return args, out


def sorted_head(turn: SortedTurn, perm, st: SortedLanes, par: int):
    """HEAD of a turn of parity ``par`` (0 or 1): the lanes ``st``
    gathered through ``perm`` (the stable argsort of ``st.key``), the
    queue, the uniforms and the camera rays.  Returns ``(comps [7, R],
    rad [3, R], thr [3, R], uniforms [n_u + 6, R], lane [3, R] i32
    (pixel, sample, depth), alive [R] bool)``; writes ``st.ctl``.

    CPU tensors run :func:`sorted_head_plain`; CUDA tensors launch
    ``csrc/sorted_turn.cu:sorted_head_kernel`` into
    :func:`head_buffers` (the results stay valid until the next launch;
    ``sorted_head.launches`` counts the launches)."""
    dev = perm.device
    if dev.type == "cpu":
        return sorted_head_plain(turn, perm, st, par)
    if dev.type != "cuda":
        raise ValueError(f"sorted_head: unsupported device {dev}")
    from ._build import launch
    buffers = head_buffers(turn, dev)
    launch("rt_sorted_head", head_args(turn, perm, st, par, buffers), dev)
    sorted_head.launches += 1
    return buffers


sorted_head.launches = 0


def sorted_tail(turn: SortedTurn, st: SortedLanes, par: int, head, out,
                acc3, segments=None):
    """TAIL of the turn of parity ``par``: the bounce's results ``out =
    (comps, rad, thr, alive, died)`` for HEAD's lanes ``head`` through the
    depth cap and Russian roulette (uniform column ``n_u + 5``), the
    finished paths added into ``acc3`` [3, n_pix] at their pixels, the
    lane state and the next sort key written into ``st``, the live count
    and the flag into ``st.ctl``, and with ``segments`` (a 0-d int64
    tensor) the lanes alive or dying added into it.

    CPU tensors run :func:`sorted_tail_plain`; CUDA tensors launch
    ``csrc/sorted_turn.cu:sorted_tail_kernel``, whose float atomics add
    in another order than ``index_add_``'s (``sorted_tail.launches``
    counts the launches)."""
    dev = acc3.device
    if dev.type == "cpu":
        return sorted_tail_plain(turn, st, par, head, out, acc3, segments)
    if dev.type != "cuda":
        raise ValueError(f"sorted_tail: unsupported device {dev}")
    from ._build import launch
    args, _keep = tail_args(turn, st, par, head, out, acc3, segments)
    launch("rt_sorted_tail", args, dev)
    sorted_tail.launches += 1


sorted_tail.launches = 0
