"""The fused wavefront iteration (``raytrace_tpu/diff/fused_iter.py``:
``background_kind``, ``fused_iter_eligible`` (with ``need_replay=True``:
:func:`fused_diff_reason`), ``fused_iter_fwd_step``, ``fused_iter_step``
(here :func:`fused_loop`)).

One kernel B launch per iteration; the caller only adds dead lanes'
radiance into the image.  :func:`fused_loop` runs the differentiable
iterations, and the dying lanes' adds into the image, as one
``torch.autograd.Function`` (:class:`_FusedLoop`) for a run of turns:
kernel B forward (its mesh variant, over the table's BVH, for
kind-segmented tables of 512 < rows <= 8192), and a backward that runs
the turns in reverse through kernel K5
(``ops/bounce_bwd_gather_kernel.py:bounce_bwd_regen_pre_reduced``), which
reads each lane's winner, material and texture columns by index and
reduces the row gradients onto the scene's tables itself; the turns' row
gradients are summed and mapped onto the scene's leaves once.
The regeneration stage is detached (sampling) or linear (selects), so
the backward rebuilds it from the saved (pixel, sample, depth).

Image, noise, marble and custom textures are shaded at albedo 1.0 by the
kernels; :func:`apply_rich` multiplies the real albedo into the
throughput after each step, outside the ``autograd.Function``, in plain
differentiable torch: the texture parameters (the atlas through the
atlas-gradient kernel, the noise and marble parameters, the colours) and
the hit points (``carry2[3:6]``) get their gradients from ordinary
autograd.  The uv only feeds ``floor`` lookups, so it stays detached.
Such a scene runs one-turn nodes of the same Function, each followed by
:func:`apply_rich`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.allpairs_kernel import pack_bvh
from ..ops.bounce_bwd_gather_kernel import bounce_bwd_regen_pre_reduced
from ..ops.iter_kernel import (
    BG_CONST, BG_GRAY, BG_SKY, iter_megakernel, next_carry, pack_cam,
    pack_kt, prepare_iter, resolve_use_ap,
)
from ..ops.row_reduce import RowTables, add_rows, row_tables
from ..core.vecmath import DTYPE
from ..render.camera import ConstBackground, camera_frame, gray_fade, sky
from ..textures.textures import (
    BASE_KINDS, TEX_CHECKER, TEX_IMAGE, _image_gather, eval_texture, is_rich,
)
from ..utils import profiling
from .gradients import leaves, map_scene
from .lane_replay import scene_row_grads

N_CARRY = 16        # smp, dep, alive, comps (7), rad (3), thr (3)
MEDIA_GRADIENTS = (
    "constant-density media: the fused step does not take them, as the JAX "
    "package's does not; trace_wavefront_diff sends them to the unfused "
    "driver's generic differentiable bounce")


def background_kind(s):
    """``(bg_kind, color)`` when kernel B can evaluate the background
    in-kernel (the three shipped backgrounds), else None."""
    bg = s.background
    if bg is sky:
        return BG_SKY, np.zeros(3, np.float32)
    if bg is gray_fade:
        return BG_GRAY, np.zeros(3, np.float32)
    if isinstance(bg, ConstBackground):
        return BG_CONST, np.asarray(bg.color, np.float32)
    return None


def fused_iter_eligible(scene, s, lanes: int) -> bool:
    """Can kernel B drive the forward stationary wavefront for this scene
    (the JAX package's check with ``need_replay=False``)?  Kernel A's
    eligibility, plus an in-kernel background and no rotated uv-textured
    spheres."""
    from ..render.integrator import bounce_kernel_eligible
    return (bounce_kernel_eligible(scene, s, lanes)
            and background_kind(s) is not None
            and not scene.prims.sphere_rots)


def iter_kernel_args(scene, s, base_key, last_sample: int):
    """``(tables, kw)``: the positional tables ``(ptbl, mtbl, ttbl, cam,
    kt)`` and the keyword parameters of kernel B (and of ``iter_plain``)
    for this scene and camera, on the scene's device.  A mesh-scale table
    (:func:`resolve_use_ap`) gets ``use_ap=True`` and its BVH, built
    here; a scene with rich textures gets ``with_uv=True`` (the winner's
    uv, for :func:`apply_rich`).  ``kw["prepared"]`` is the launch of
    :func:`~..ops.iter_kernel.prepare_iter`: the tables checked, the
    planar instantiation chosen where it serves them, once per driver
    call."""
    from ..render.integrator import bounce_tables, n_bounce_uniforms
    dev = scene.device
    tb = bounce_tables(scene, s)
    bg_kind, bg_color = background_kind(s)
    cam = pack_cam(s, camera_frame(s), bg_color).to(dev)
    kt = pack_kt(base_key, last_sample).to(dev)
    use_ap = resolve_use_ap(tb.n_prims, scene.prims.kind_segments)
    kw = dict(tb.kw, n_u=n_bounce_uniforms(scene),
              rr_depth=None if s.rr_depth is None else int(s.rr_depth),
              max_depth=int(s.max_depth), width=int(s.image_width),
              bg_kind=bg_kind, use_ap=use_ap,
              bvh=(pack_bvh(scene.prims, tb.ptbl, tb.n_prims) if use_ap
                   else None),
              with_uv=is_rich(scene.textures.kinds_present))
    tables = (tb.ptbl, tb.mtbl, tb.ttbl, cam, kt)
    kw["prepared"] = prepare_iter(*tables, **kw)
    return tables, kw


def fused_iter_fwd_step(scene, s, base_key, spp: int, sample_offset: int,
                        rotation=None):
    """Returns ``step(pixel_ids, carry) -> (carry2, rad2, died_f)``: one
    forward iteration of kernel B.  ``carry`` is 16 [R] tensors (smp i32,
    dep i32, alive f32, comps 7, rad 3, thr 3); ``rad2`` the radiance
    rows (3), ``died_f`` 0/1.  With ``rotation`` (the rotated mode's
    :class:`~..ops.iter_kernel.Rotation`) every step also adds the dying
    lanes' radiance into its planes, and ``pixel_ids`` is not read."""
    tables, kw = iter_kernel_args(scene, s, base_key,
                                  sample_offset + spp - 1)

    def step(pix, carry):
        outs = iter_megakernel(*tables, (pix,) + tuple(carry), **kw,
                               rotation=rotation)
        return next_carry(outs), tuple(outs[7:10]), outs[16]

    return step


@dataclasses.dataclass(frozen=True)
class _StepStatics:
    """What the backward of the fused iterations needs besides the saved
    lane tensors: the kernel tables, the per-prim column table K5 reads
    and the routing of prims to material and texture rows."""
    tables: tuple           # (ptbl, mtbl, ttbl, cam, kt) of kernel B
    kw: dict                # kernel B's keyword parameters
    scene: object           # the detached scene (gradient shapes)
    names: tuple            # names of the float leaves, in input order
    rows: RowTables         # K5's per-prim columns, material, texture
    n_row: int


def _k5(st: _StepStatics, pix, ins, idx, scale, cts):
    """K5 over one turn: its inputs ``ins`` (smp, dep, alive, comps (7),
    thr (3)), winner index and RR scale, and the cotangents ``cts`` (13)
    of its outputs comps, rad, thr.  Returns ``(lane, rows)``."""
    _, _, ttbl, cam, kt = st.tables
    return bounce_bwd_regen_pre_reduced(
        ttbl, kt, cam, st.rows, idx, (pix,) + tuple(ins[0:2]), ins[2],
        ins[3:10], ins[10:13], scale, cts, n_targets=st.kw["n_targets"],
        has_motion=st.kw["has_motion"], has_box=st.scene.prims.has_box,
        t_min=st.kw["t_min"], n_row=st.n_row, n_u=st.kw["n_u"],
        width=st.kw["width"], bg_kind=st.kw["bg_kind"])


def _rows(ts):
    """The [k, R] tensor whose rows are the [R] tensors ``ts``: a view
    where they are consecutive rows of one storage (kernel B's and K5's
    outputs on the card), else a stack."""
    x, r = ts[0], ts[0].shape[0]
    st = x.untyped_storage().data_ptr()
    if all(t.is_contiguous() and t.dtype == x.dtype
           and t.untyped_storage().data_ptr() == st
           and t.data_ptr() == x.data_ptr() + k * r * x.element_size()
           for k, t in enumerate(ts)):
        return x.as_strided((len(ts), r), (r, 1))
    return torch.stack(ts)


# the residuals a turn of _FusedLoop saves
_TURN = 16


class _FusedLoop(torch.autograd.Function):
    """``n`` >= 1 differentiable fused iterations as one node; inputs
    ``(st, n, alive, pix, carry (16), *float leaves of the scene)``,
    outputs ``acc [3, R], done, carry2 (16)``: the radiance of the
    samples the lanes completed and their number (i32), and the last
    carries; with kernel B's ``with_uv`` also the last turn's winner
    (u, v) and index, for :func:`apply_rich` (not differentiable).

    Forward: each turn (the span ``diff.fwd_iter``) kernel B, then the
    dying lanes' radiance added into ``acc`` and their deaths into
    ``done`` in place; each turn keeps its residuals: its inputs without
    rad (a linear passthrough), the winner index, the RR scale, the
    deaths.  ``alive`` (a list, or None) takes each turn's alive flags
    after the step.  Backward: the turns in reverse, each (the span
    ``diff.bwd_iter``) the adjoint of the adds (``g_acc * died``) into
    its radiance cotangent, K5, and its row gradients added into one
    running sum; after the last, the sum mapped onto the leaves."""

    @staticmethod
    def forward(ctx, st, n, alive, pix, *args):
        ctx.set_materialize_grads(False)
        carry = tuple(args[:N_CARRY])
        r = pix.shape[0]
        acc = torch.zeros((3, r), dtype=DTYPE, device=pix.device)
        # f32 counts, exact below 2^24
        done = torch.zeros((r,), dtype=DTYPE, device=pix.device)
        saved = [pix]
        for _ in range(n):
            with profiling.span("diff.fwd_iter"):
                outs = iter_megakernel(*st.tables, (pix,) + carry, **st.kw)
                died = outs[16]
                # died is 0 or 1, so acc + rad * died is exact
                acc.addcmul_(_rows(outs[7:10]), died)
                done.add_(died)
            saved += carry[0:10] + carry[13:16] + (outs[17], outs[18], died)
            carry = next_carry(outs)
            if alive is not None:
                alive.append(carry[2])
        ctx.save_for_backward(*saved)
        ctx.st = st
        done = done.to(torch.int32)
        uv = ((outs[19], outs[20], outs[17].clone()) if st.kw["with_uv"]
              else ())
        ctx.mark_non_differentiable(done, *carry[0:3], *uv)
        return (acc, done) + carry + uv

    @staticmethod
    def backward(ctx, g_acc, _, *g_carry):
        st = ctx.st
        pix, *saved = ctx.saved_tensors
        g_acc = None if g_acc is None else g_acc.contiguous()
        cts = g_carry[3:N_CARRY]
        if any(g is None for g in cts):
            zeros = iter(torch.zeros((len(cts), pix.shape[0]), dtype=DTYPE,
                                     device=pix.device).unbind(0))
            cts = tuple(next(zeros) if g is None else g for g in cts)
        cts = tuple(g.contiguous() for g in cts)
        total = None
        for at in range(len(saved) - _TURN, -1, -_TURN):
            *ins, idx, scale, died = saved[at:at + _TURN]
            with profiling.span("diff.bwd_iter"):
                if g_acc is not None:
                    g_rad = torch.addcmul(_rows(cts[7:10]), g_acc, died)
                    cts = cts[0:7] + tuple(g_rad.unbind(0)) + cts[10:13]
                g, rg = _k5(st, pix, tuple(ins), idx, scale, cts)
                # each launch's rows are fresh: the first is the sum's
                if total is None:
                    total = rg
                else:
                    add_rows(total, rg)
                cts = tuple(g)
        gl = leaves(scene_row_grads(st.scene, total, st.n_row))
        return (None,) * 7 + cts + tuple(gl[k] for k in st.names)


@dataclasses.dataclass(frozen=True)
class _RichStatics:
    """The routing of :func:`apply_rich`, per prim row (detached): the
    texture row and kind; for a scene whose only rich kind is the image,
    the image id and its true height and width (f32)."""
    tex: torch.Tensor
    kind: torch.Tensor
    image_only: bool
    img: torch.Tensor | None = None
    h: torch.Tensor | None = None
    w: torch.Tensor | None = None


def rich_statics(scene) -> _RichStatics:
    """:class:`_RichStatics` of a (detached) scene."""
    tx = scene.textures
    tex = scene.materials.tex[scene.prims.mat.long()].long()
    image_only = set(tx.kinds_present) <= BASE_KINDS | {TEX_IMAGE}
    if not image_only:
        return _RichStatics(tex=tex, kind=tx.kind[tex], image_only=False)
    img = tx.i0[tex].long()
    hw = tx.image_hw[img].to(DTYPE)
    return _RichStatics(tex=tex, kind=tx.kind[tex], image_only=True,
                        img=img.to(DTYPE), h=hw[:, 0], w=hw[:, 1])


def apply_rich(textures, rs: _RichStatics, carry2, uu, vv, idx):
    """The deferred albedo multiply of one step (the JAX package's
    ``apply_rich``): every lane still alive whose winner row has an
    image, noise, marble or custom texture gets ``thr *= albedo`` at its
    hit point ``carry2[3:6]`` and uv ``(uu, vv)``.  Differentiable in
    ``textures`` (the scene's, with its ``requires_grad`` leaves) and in
    the carries.  The image-only branch computes the atlas indices per
    lane and sends every other lane to texel (0, 0) with a zero
    cotangent; the general branch is :func:`eval_texture`."""
    thr = carry2[13:16]
    pi = torch.clamp(idx, min=0.0).long()
    live = (carry2[2] > 0.5) & (idx >= 0.0) & (rs.kind[pi] > TEX_CHECKER)
    if rs.image_only:
        live_f = live.to(DTYPE)
        h = torch.clamp(rs.h[pi], min=1.0)
        w = torch.clamp(rs.w[pi], min=1.0)
        i = live_f * torch.remainder(torch.floor(uu * w), w)
        j = live_f * torch.remainder(torch.floor((1.0 - vv) * h), h)
        alb = _image_gather(textures.images, (live_f * rs.img[pi]).long(),
                            j.long(), i.long())
        thr2 = tuple(t * (1.0 + live_f * (alb[:, k] - 1.0))
                     for k, t in enumerate(thr))
    else:
        point = torch.stack(carry2[3:6], dim=-1)
        uv = torch.stack([uu, vv], dim=-1)
        alb = eval_texture(textures, rs.tex[pi], point, uv)
        mult = torch.where(live[:, None], alb, 1.0)
        thr2 = tuple(t * mult[:, k] for k, t in enumerate(thr))
    return carry2[:13] + thr2 + carry2[16:]


def fused_diff_reason(scene, s):
    """Why the fused differentiable step cannot take this scene and
    camera, or None (the JAX package's ``fused_iter_eligible`` with
    ``need_replay=True``): kernel B (or its mesh variant) with deferred
    rich textures, the replay backward's caps, an in-kernel background,
    no rotated spheres.  The differentiable driver sends a scene refused
    for its background or its rotated spheres to the unfused route."""
    from ..render.integrator import MEGA_MAX_PRIMS, _kernel_reason
    from .lane_replay import replay_pre_eligible
    if scene.volumes is not None:
        return MEDIA_GRADIENTS
    reason = _kernel_reason(scene, s, 128, MEGA_MAX_PRIMS, defer_rich=True)
    if reason is None and not replay_pre_eligible(scene):
        reason = "the scene's tables exceed the replay backward's caps"
    if reason is None and background_kind(s) is None:
        reason = ("kernel B evaluates only the const, sky and gray_fade "
                  "backgrounds")
    if reason is None and scene.prims.sphere_rots:
        reason = "kernel B does not rotate sphere uvs"
    return reason


def _statics(scene, s, base_key, spp: int, sample_offset: int):
    """``(st, params, rs)``: the :class:`_StepStatics`, the float leaves
    with ``requires_grad`` and, for rich textures, the
    :class:`_RichStatics` of the differentiable iteration."""
    named = {k: v for k, v in leaves(scene).items() if v.requires_grad}
    with torch.no_grad():
        det = map_scene(lambda x: x.detach(), scene)
        tables, kw = iter_kernel_args(det, s, base_key,
                                      sample_offset + spp - 1)
        n_row = 15 if det.prims.has_motion else 9
        rows = row_tables(det, n_row)
        rs = rich_statics(det) if kw["with_uv"] else None
    st = _StepStatics(tables=tables, kw=kw, scene=det, names=tuple(named),
                      rows=rows, n_row=n_row)
    return st, tuple(named.values()), rs


def fused_loop(scene, s, base_key, spp: int, sample_offset: int):
    """Returns ``loop(pixel_ids, carry, n, alive=None) -> (acc, done,
    carry2)``: ``n`` differentiable fused iterations from 16 [R] carries
    (smp i32, dep i32, alive f32, comps (7), rad (3), thr (3)), ``acc``
    the radiance of the samples the lanes completed (f32 [3, R]) and
    ``done`` their number (i32 [R]), as the driver sums them; ``alive``
    (a list) takes each turn's alive flags.  Differentiable with respect
    to every float leaf of ``scene`` (those with ``requires_grad``, as
    :func:`gradients.partition` makes them).  The pixel assignment is an
    argument, so compacted completion phases can rebind it.  The ``n``
    turns are one autograd node (:class:`_FusedLoop`); a scene with rich
    textures, whose :func:`apply_rich` runs differentiable torch between
    the turns, runs ``n`` one-turn nodes, each followed by it, and sums
    their ``acc`` and ``done``.  Raises for the scenes
    :func:`fused_diff_reason` refuses."""
    reason = fused_diff_reason(scene, s)
    if reason is not None:
        raise NotImplementedError(f"fused_loop: {reason}")
    st, params, rs = _statics(scene, s, base_key, spp, sample_offset)

    def loop(pix, carry, n, alive=None):
        if n == 0:
            r = pix.shape[0]
            return (torch.zeros((3, r), dtype=DTYPE, device=pix.device),
                    torch.zeros((r,), dtype=torch.int32, device=pix.device),
                    tuple(carry))
        if rs is None:
            out = _FusedLoop.apply(st, n, alive, pix, *carry, *params)
            return out[0], out[1], out[2:]
        acc = done = None
        for _ in range(n):
            out = _FusedLoop.apply(st, 1, alive, pix, *carry, *params)
            carry = apply_rich(scene.textures, rs, out[2:2 + N_CARRY],
                               *out[2 + N_CARRY:])
            # acc + rad * died is exact, as within one node
            acc = out[0] if acc is None else acc + out[0]
            done = out[1] if done is None else done + out[1]
        return acc, done, carry

    return loop
