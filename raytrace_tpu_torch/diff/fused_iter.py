"""The fused wavefront iteration (``raytrace_tpu/diff/fused_iter.py``:
``background_kind``, ``fused_iter_eligible`` (with ``need_replay=True``:
:func:`fused_diff_reason`), ``fused_iter_fwd_step``, ``fused_iter_step``).

One kernel B launch per iteration; the caller only adds dead lanes'
radiance into the image.  :func:`fused_iter_step` is the differentiable
iteration, a ``torch.autograd.Function``: kernel B forward (its mesh
variant, over the table's BVH, for kind-segmented tables of 512 < rows
<= 8192), and a backward through kernel K5
(``ops/bounce_bwd_gather_kernel.py:bounce_bwd_regen_pre_reduced``), which
reads each lane's winner, material and texture columns by index and
reduces the row gradients onto the scene's tables itself.
The regeneration stage is detached (sampling) or linear (selects), so
the backward rebuilds it from the saved (pixel, sample, depth).

Image, noise, marble and custom textures are shaded at albedo 1.0 by the
kernels; :func:`apply_rich` multiplies the real albedo into the
throughput after each step, outside the ``autograd.Function``, in plain
differentiable torch: the texture parameters (the atlas through the
atlas-gradient kernel, the noise and marble parameters, the colours) and
the hit points (``carry2[3:6]``) get their gradients from ordinary
autograd.  The uv only feeds ``floor`` lookups, so it stays detached.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.allpairs_kernel import pack_bvh
from ..ops.bounce_bwd_gather_kernel import bounce_bwd_regen_pre_reduced
from ..ops.iter_kernel import (
    BG_CONST, BG_GRAY, BG_SKY, iter_megakernel, pack_cam, pack_kt,
    resolve_use_ap,
)
from ..ops.row_reduce import RowTables, row_tables
from ..core.vecmath import DTYPE
from ..render.camera import ConstBackground, camera_frame, gray_fade, sky
from ..textures.textures import (
    BASE_KINDS, TEX_CHECKER, TEX_IMAGE, _image_gather, eval_texture, is_rich,
)
from .gradients import leaves, map_scene
from .lane_replay import scene_row_grads

N_CARRY = 16        # smp, dep, alive, comps (7), rad (3), thr (3)
MEDIA_GRADIENTS = (
    "gradients of scenes with constant-density media are not ported yet: "
    "the JAX package differentiates them with its generic bounce and a "
    "score-function density weight (ROADMAP M10, with the generic bounce "
    "M4 and M11's diff_intersect)")


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
    uv, for :func:`apply_rich`)."""
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
              bvh=pack_bvh(scene.prims, tb.n_prims) if use_ap else None,
              with_uv=is_rich(scene.textures.kinds_present))
    return (tb.ptbl, tb.mtbl, tb.ttbl, cam, kt), kw


def fused_iter_fwd_step(scene, s, base_key, spp: int, sample_offset: int):
    """Returns ``step(pixel_ids, carry) -> (carry2, rad2, died_f)``: one
    forward iteration of kernel B.  ``carry`` is 16 [R] tensors (smp i32,
    dep i32, alive f32, comps 7, rad 3, thr 3); ``rad2`` the radiance
    rows (3), ``died_f`` 0/1."""
    tables, kw = iter_kernel_args(scene, s, base_key,
                                  sample_offset + spp - 1)

    def step(pix, carry):
        outs = iter_megakernel(*tables, (pix,) + tuple(carry), **kw)
        carry2 = ((outs[14], outs[15], outs[13]) + tuple(outs[0:7])
                  + tuple(outs[7:10]) + tuple(outs[10:13]))
        return carry2, tuple(outs[7:10]), outs[16]

    return step


@dataclasses.dataclass(frozen=True)
class _StepStatics:
    """What the backward of one fused iteration needs besides the saved
    lane tensors: the kernel tables, the per-prim column table K5 reads
    and the routing of prims to material and texture rows."""
    tables: tuple           # (ptbl, mtbl, ttbl, cam, kt) of kernel B
    kw: dict                # kernel B's keyword parameters
    scene: object           # the detached scene (gradient shapes)
    names: tuple            # names of the float leaves, in input order
    rows: RowTables         # K5's per-prim columns, material, texture
    n_row: int


class _FusedIter(torch.autograd.Function):
    """One differentiable fused iteration; inputs ``(st, pix, carry (16),
    *float leaves of the scene)``, outputs ``carry2 (16) + (died_f,)``,
    with ``with_uv`` also the winner's (u, v) and index, for
    :func:`apply_rich` (not differentiable)."""

    @staticmethod
    def forward(ctx, st, pix, *args):
        carry = args[:N_CARRY]
        outs = iter_megakernel(*st.tables, (pix,) + tuple(carry), **st.kw)
        carry2 = ((outs[14], outs[15], outs[13]) + tuple(outs[0:7])
                  + tuple(outs[7:10]) + tuple(outs[10:13]) + (outs[16],))
        if st.kw["with_uv"]:
            carry2 = carry2 + (outs[19], outs[20], outs[17].clone())
        # residuals: the inputs without rad (a linear passthrough), the
        # winner index and the RR scale
        ctx.save_for_backward(pix, *carry[0:10], *carry[13:16], outs[17],
                              outs[18])
        ctx.st = st
        ctx.mark_non_differentiable(carry2[0], carry2[1], carry2[2],
                                    *carry2[16:])
        return carry2

    @staticmethod
    def backward(ctx, *gouts):
        st = ctx.st
        (pix, smp, dep, al, *rest) = ctx.saved_tensors
        comps_in, thr_in, idx, scale = rest[0:7], rest[7:10], rest[10], \
            rest[11]
        cts = tuple(torch.zeros_like(al) if g is None else g.contiguous()
                    for g in gouts[3:16])
        _, _, ttbl, cam, kt = st.tables
        g, rg = bounce_bwd_regen_pre_reduced(
            ttbl, kt, cam, st.rows, idx, (pix, smp, dep), al, comps_in,
            thr_in, scale, cts, n_targets=st.kw["n_targets"],
            has_motion=st.kw["has_motion"], has_box=st.scene.prims.has_box,
            t_min=st.kw["t_min"], n_row=st.n_row, n_u=st.kw["n_u"],
            width=st.kw["width"], bg_kind=st.kw["bg_kind"])
        gl = leaves(scene_row_grads(st.scene, rg, st.n_row))
        return ((None, None, None, None, None) + tuple(g)
                + tuple(gl[k] for k in st.names))


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
    from ..ops.intersect_kernel import MAX_SMEM_PRIMS
    from ..render.integrator import MEGA_MAX_PRIMS, _kernel_reason
    from .lane_replay import replay_pre_eligible
    if scene.volumes is not None:
        return MEDIA_GRADIENTS
    reason = _kernel_reason(scene, s, 128, MEGA_MAX_PRIMS, defer_rich=True)
    p = scene.prims
    if (reason is None and p.kind.shape[0] > MAX_SMEM_PRIMS
            and p.kind_segments is None):
        reason = ("an unsegmented table of more than 512 rows (ROADMAP "
                  "M8)")
    if reason is None and not replay_pre_eligible(scene):
        reason = "the scene's tables exceed the replay backward's caps"
    if reason is None and background_kind(s) is None:
        reason = ("kernel B evaluates only the const, sky and gray_fade "
                  "backgrounds")
    if reason is None and scene.prims.sphere_rots:
        reason = "kernel B does not rotate sphere uvs"
    return reason


def fused_iter_step(scene, s, base_key, spp: int, sample_offset: int):
    """Returns ``step(pixel_ids, carry) -> (carry2, died_f)``: one
    differentiable fused iteration over 16 [R] carries (smp i32, dep i32,
    alive f32, comps (7), rad (3), thr (3)), differentiable with respect
    to every float leaf of ``scene`` (those with ``requires_grad``, as
    :func:`gradients.partition` makes them).  The pixel assignment is an
    argument, so compacted completion phases can rebind it.  A scene with
    rich textures gets :func:`apply_rich` after every step.  Raises for
    the scenes :func:`fused_diff_reason` refuses."""
    reason = fused_diff_reason(scene, s)
    if reason is not None:
        raise NotImplementedError(f"fused_iter_step: {reason}")
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
    params = tuple(named.values())

    def step(pix, carry):
        out = _FusedIter.apply(st, pix, *carry, *params)
        carry2 = out[:N_CARRY]
        if rs is not None:
            carry2 = apply_rich(scene.textures, rs, carry2,
                                *out[N_CARRY + 1:])
        return carry2, out[N_CARRY]

    return step
