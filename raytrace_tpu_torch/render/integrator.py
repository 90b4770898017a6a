"""Wavefront path-tracing drivers, forward subset
(``raytrace_tpu/render/integrator.py``).

A pool of lanes advances through bounce iterations carrying (radiance,
throughput, alive); each recursion level ``emitted + weight * child``
becomes ``radiance += throughput * emitted; throughput *= weight``, and a
finished path adds its radiance into the image.

* :func:`trace_wavefront_stationary` — lane ``l`` owns pixel ``l`` for
  the launch and traces its samples one after another.  With ``rotate_k >
  1`` a lane rotates through ``k`` pixels spread over the image; the body
  is then torch glue (RNG, camera, regeneration, Russian roulette, flush)
  around the bounce.  With ``rotate_k == 1`` the whole body is kernel B.
* :func:`trace_wavefront` — a work queue refills dead lanes with the next
  (pixel, sample) around the bounce.

The bounce is kernel A for tables of at most 512 rows with constant and
checker textures (:func:`bounce_mega_soa`).  Every other scene takes the
split path (:func:`bounce_split_soa`), as the JAX package's ``bounce``
does: the nearest hit record (kernel K8's flat scan for small and
unsegmented tables, the walk of the table's BVH for kind-segmented
tables of 192 rows and more), the exact sphere uv in torch, the shade
kernel (``shade_megakernel``), then the image, noise, marble and custom
texture albedo multiplied into the surviving lanes' throughput in torch
(marble stripes through kernel K12).

Every random draw is a pure function of (pixel, sample, depth, column), so
every driver and every ``rotate_k`` traces the same samples.  The loop
condition is read on the host once per iteration.

Lane state is stacked: comps [7, R] (origin, direction, time), rad and
thr [3, R]; the JAX package keeps the same rows as tuples of [R] arrays.

* :func:`trace_wavefront_diff` — the differentiable pixel-stationary
  wavefront: a fixed number of iterations of the fused differentiable
  step (kernel B forward, kernel K5 backward), then optional compacted
  completion phases.  It keeps the carries as tuples of [R] tensors, as
  the JAX package does.

The generic bounce (for scenes neither path takes, such as lights with
rich textures), the bounded-depth ``trace``, the sorted driver (tables
of 8192 rows and more), the BVH accelerator mode beyond 65,536 rows and
media are ROADMAP M4, M6b, M8 and M10.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import rng
from ..core.vecmath import DTYPE
from ..diff.fused_iter import fused_iter_eligible, fused_iter_fwd_step
from ..materials.materials import MaterialTable
from ..ops.allpairs_kernel import (
    MIN_PRIMS, DeviceBVH, allpairs_nearest_record, pack_bvh,
)
from ..ops.bounce_kernel import (
    MAX_MAT_ROWS, MAX_SHADE_MATS, MAX_TARGETS, N_U, bounce_megakernel,
    pack_behaviors, pack_materials, pack_targets, shade_megakernel,
)
from ..ops.intersect_kernel import (
    MAX_DENSE_PRIMS, MAX_SMEM_PRIMS, pack_prims, pallas_nearest_record,
)
from ..scene.types import Scene
from ..textures.textures import (
    TEX_CHECKER, TEX_CONSTANT, eval_texture, is_rich,
)
from .camera import CameraSettings, camera_frame, camera_table, rays_from_table

_N_BASE_U = 8       # bounce uniform columns (+ one per volume in JAX)
LANE_ALIGN = 128    # lane-pool alignment; keeps lane->pixel maps as JAX's
# row cap of the fused differentiable driver (kernel B and its mesh
# variant forward, K5 backward)
MEGA_MAX_PRIMS = 8192


def n_bounce_uniforms(scene: Scene) -> int:
    return _N_BASE_U


def _n_scan_prims(prims) -> int:
    """Rows the scan visits: an unsegmented table has its pad rows
    trailing, so only the real rows are scanned (Cornell: 18 of 24);
    a kind-segmented table pads inside its segments and is scanned
    whole."""
    if prims.kind_segments is None and 0 < prims.n < prims.kind.shape[0]:
        return prims.n
    return prims.kind.shape[0]


def _russian_roulette(s: CameraSettings, u_rr, depth, thr, alive, died):
    """Opt-in Russian roulette: from ``depth >= s.rr_depth`` a path
    survives with probability ``clamp(max(throughput), rr_min, 1)`` and
    survivors' throughput is divided by it.  ``thr`` is [3, R].  Returns
    (thr', alive', died')."""
    thr_max = torch.maximum(thr[0], torch.maximum(thr[1], thr[2]))
    p = torch.clamp(thr_max, min=s.rr_min, max=1.0)
    do = depth >= s.rr_depth
    kill = do & (u_rr >= p)
    scale = torch.where(do & ~kill, 1.0 / p, 1.0)
    return thr * scale, alive & ~kill, died | (alive & kill)


_RICH_LIGHT = ("lights with image, noise, marble or custom textures need "
               "the generic bounce (ROADMAP M4)")


def _kernel_reason(scene: Scene, s: CameraSettings, n_rays: int,
                   max_rows: int, defer_rich: bool = False):
    """Why kernels A and B (at most ``max_rows`` rows) cannot take this
    scene (with the ROADMAP item that will cover it), or None.  The
    kernels shade constant and checker textures; ``defer_rich`` (the
    differentiable driver, which multiplies the other kinds in after each
    iteration) lets them shade the rest at albedo 1.0, except on lights,
    whose emission is in-kernel."""
    rows = scene.prims.kind.shape[0]
    if rows > max_rows:
        return (f"{rows} primitive rows: the kernels take at most "
                f"{max_rows} here (mesh scale: ROADMAP M8)")
    m = scene.materials
    n_rows = m.n_behaviors if m.n_behaviors > 0 else m.kind.shape[0]
    if defer_rich and is_rich(m.light_tex_kinds):
        return _RICH_LIGHT
    if not defer_rich and is_rich(scene.textures.kinds_present):
        return ("kernel A shades constant and checker textures only (the "
                "split path multiplies the other kinds in)")
    if s.n_redirect > MAX_TARGETS:
        return (f"{s.n_redirect} redirect targets: the kernels take at most "
                f"{MAX_TARGETS} (generic bounce: ROADMAP M4)")
    if n_rows > MAX_MAT_ROWS:
        return (f"{n_rows} material behaviours: the kernels take at most "
                f"{MAX_MAT_ROWS} (generic bounce: ROADMAP M4)")
    if scene.prims.sphere_rots and TEX_CHECKER in \
            scene.textures.kinds_present:
        return ("rotated checker-textured spheres need object-space uv "
                "(ROADMAP M11)")
    if n_rays % LANE_ALIGN:
        return f"{n_rays} lanes: not a multiple of {LANE_ALIGN}"
    return None


def _ineligible_reason(scene: Scene, s: CameraSettings, n_rays: int):
    """Why kernel A (at most 512 rows) cannot take this scene, or None."""
    return _kernel_reason(scene, s, n_rays, MAX_SMEM_PRIMS)


def _split_ineligible_reason(scene: Scene, s: CameraSettings, n_rays: int):
    """Why the split path (nearest kernel + shade kernel + the rich-texture
    multiply) cannot take this scene (with its ROADMAP item), or None: it
    takes tables of up to 65,536 rows, up to 24 materials and 8 redirect
    targets, and every texture kind except on lights.  The shade kernel's
    part is the JAX package's ``fused_shade_eligible``."""
    p, m = scene.prims, scene.materials
    rows = p.kind.shape[0]
    if rows > MAX_DENSE_PRIMS:
        return (f"{rows} primitive rows: past {MAX_DENSE_PRIMS} the BVH "
                "accelerator mode is not ported yet (ROADMAP M8)")
    if m.kind.shape[0] > MAX_SHADE_MATS:
        return (f"{m.kind.shape[0]} materials: the shade kernel takes at "
                f"most {MAX_SHADE_MATS} (generic bounce: ROADMAP M4)")
    if s.n_redirect > MAX_TARGETS:
        return (f"{s.n_redirect} redirect targets: the shade kernel takes "
                f"at most {MAX_TARGETS} (generic bounce: ROADMAP M4)")
    if is_rich(m.light_tex_kinds):
        return _RICH_LIGHT
    if p.sphere_rots:
        return ("rotated uv-textured spheres need object-space uv "
                "(ROADMAP M11)")
    if n_rays % LANE_ALIGN:
        return f"{n_rays} lanes: not a multiple of {LANE_ALIGN}"
    return None


def bounce_kernel_eligible(scene: Scene, s: CameraSettings,
                           n_rays: int) -> bool:
    """Static check for kernel A (the forward cap of the JAX package's
    check): at most 512 rows, constant or checker textures, at most 8
    redirect targets and 16 material behaviours, lanes a multiple of
    128."""
    return _ineligible_reason(scene, s, n_rays) is None


@dataclasses.dataclass(frozen=True)
class BounceTables:
    """Packed tables and static parameters of kernel A for one scene and
    camera, on the scene's device."""
    ptbl: torch.Tensor
    mtbl: torch.Tensor
    ttbl: torch.Tensor
    n_prims: int
    n_mats: int
    n_targets: int
    use_prim_albedo: bool
    has_motion: bool
    t_min: float

    @property
    def kw(self) -> dict:
        """The keyword parameters both kernels take for these tables."""
        return dict(n_prims=self.n_prims, n_mats=self.n_mats,
                    n_targets=self.n_targets, t_min=self.t_min,
                    has_motion=self.has_motion,
                    use_prim_albedo=self.use_prim_albedo)


def bounce_tables(scene: Scene, s: CameraSettings) -> BounceTables:
    """Pack the kernel tables: behaviour-collapsed when the material table
    has behaviours (constant-texture color and param ride in prim columns
    31-34), per material otherwise."""
    dev = scene.device
    m: MaterialTable = scene.materials
    use_beh = m.n_behaviors > 0
    p = scene.prims
    if use_beh:
        tex_ids = m.tex[p.mat.long()].long()
        is_const = (scene.textures.kind[tex_ids] == TEX_CONSTANT)[:, None]
        prim_albedo = torch.where(is_const, scene.textures.c0[tex_ids], 0.0)
        ptbl = pack_prims(p, mat_override=m.behavior_of[p.mat.long()],
                          albedo=prim_albedo, param=m.param[p.mat.long()])
        mtbl = pack_behaviors(m, scene.textures)
        n_mats = m.n_behaviors
    else:
        ptbl = pack_prims(p)
        mtbl = pack_materials(m, scene.textures)
        n_mats = m.kind.shape[0]
    ttbl = pack_targets(s.redirect_prob, s.redirect_q, s.redirect_u,
                        s.redirect_v)
    return BounceTables(
        ptbl=ptbl.contiguous(), mtbl=mtbl.to(dev).contiguous(),
        ttbl=ttbl.to(dev).contiguous(), n_prims=_n_scan_prims(p),
        n_mats=n_mats, n_targets=s.n_redirect, use_prim_albedo=use_beh,
        has_motion=p.has_motion, t_min=float(np.float32(s.t_min)))


def bounce_mega_soa(scene: Scene, s: CameraSettings, comps, uniforms, rad,
                    thr, alive, with_idx: bool = False,
                    tables: BounceTables | None = None):
    """One bounce of every lane through kernel A.  ``comps`` [7, R],
    ``uniforms`` [>=8, R], ``rad``/``thr`` [3, R], ``alive`` bool [R].
    Returns (comps', rad', thr', alive', died), plus the winner row index
    (i32, -1 on a miss) with ``with_idx``.  The background on a miss is
    added here, so any background callable works."""
    tb = tables if tables is not None else bounce_tables(scene, s)
    # dead lanes carry stale rays: park them far outside the scene
    o = torch.where(alive, comps[0:3], 3e18)
    outs = bounce_megakernel(
        tb.ptbl, tb.mtbl, tb.ttbl, o[0], o[1], o[2], comps[3], comps[4],
        comps[5], comps[6], thr[0], thr[1], thr[2], alive.to(DTYPE),
        uniforms[:N_U], **tb.kw)
    new_comps = torch.stack(outs[0:6] + (comps[6],))
    thr_new = torch.stack(outs[6:9])
    alive_new = outs[12] > 0.5
    miss_f = torch.where(outs[13] > 0.5, 1.0, 0.0)
    bg = s.background(o.T, comps[3:6].T).to(DTYPE).T
    rad_new = rad + torch.stack(outs[9:12]) + miss_f * thr * bg
    died = alive & ~alive_new
    res = (new_comps, rad_new, thr_new, alive_new, died)
    return res + (outs[14].to(torch.int32),) if with_idx else res


@dataclasses.dataclass(frozen=True)
class SplitTables:
    """Packed tables and static parameters of the split path for one scene
    and camera: the prim table with per-material ids, its BVH (None where
    the flat scan serves the table), the material rows (not behaviours)
    and the targets; ``rich`` says whether the scene has textures the
    shade kernel defers (image, noise, marble, custom)."""
    ptbl: torch.Tensor
    mtbl: torch.Tensor
    ttbl: torch.Tensor
    bvh: DeviceBVH | None
    n_prims: int
    n_mats: int
    n_targets: int
    has_motion: bool
    t_min: float
    rich: bool = False


def uses_bvh(prims) -> bool:
    """Does the split path walk a BVH (kernel K9) for this table, or scan
    it flat (kernel K8)?  The JAX package's rule (``_surface_hit``): the
    all-pairs kernel for kind-segmented tables of ``MIN_PRIMS`` (192) rows
    and more, the flat scan otherwise."""
    return prims.kind_segments is not None and \
        _n_scan_prims(prims) >= MIN_PRIMS


def split_tables(scene: Scene, s: CameraSettings) -> SplitTables:
    """Pack the split path's tables and, for a table the BVH walk serves,
    build its BVH (once per driver call)."""
    dev = scene.device
    p = scene.prims
    n_prims = _n_scan_prims(p)
    return SplitTables(
        ptbl=pack_prims(p).contiguous(),
        mtbl=pack_materials(scene.materials, scene.textures).to(dev)
        .contiguous(),
        ttbl=pack_targets(s.redirect_prob, s.redirect_q, s.redirect_u,
                          s.redirect_v).to(dev).contiguous(),
        bvh=pack_bvh(p, n_prims) if uses_bvh(p) else None, n_prims=n_prims,
        n_mats=scene.materials.kind.shape[0], n_targets=s.n_redirect,
        has_motion=p.has_motion, t_min=float(np.float32(s.t_min)),
        rich=is_rich(scene.textures.kinds_present))


def surface_hit(tb: SplitTables, o, d, time):
    """The nearest hit record of every lane (``o``, ``d`` [3, R], ``time``
    [R]) through a nearest-hit kernel (the BVH walk where ``tb`` has a
    BVH, else the flat scan), with the exact sphere uv from the outward
    normal computed here in torch, as the JAX package's ``_surface_hit``
    does after its kernel.  Returns the 10 [R] f32 hit columns of
    ``shade_megakernel`` (sphere flag 0: the uv is final)."""
    rays = (o[0], o[1], o[2], d[0], d[1], d[2], time)
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    if tb.bvh is None:
        rec = pallas_nearest_record(tb.ptbl, *rays, **kw)
    else:
        rec = allpairs_nearest_record(tb.ptbl, tb.bvh, *rays, **kw)
    t, idx, nx, ny, nz, flags, uu, vv, mat = rec
    front = (flags & 1) > 0
    is_sphere = (flags & 2) > 0
    flip = torch.where(front, 1.0, -1.0)
    owx, owy, owz = nx * flip, ny * flip, nz * flip
    xz_ok = owx ** 2 + owz ** 2 > 1e-12
    sx = torch.where(xz_ok, owx, 0.0)
    sz = torch.where(xz_ok, owz, 1.0)
    su = torch.atan2(sx, sz) / (2.0 * math.pi) + 0.5
    sv = torch.arccos(torch.clamp(-owy, -1.0 + 1e-6, 1.0 - 1e-6)) / math.pi
    return (t, idx.to(DTYPE), nx, ny, nz, front.to(DTYPE),
            torch.where(is_sphere, su, uu), torch.where(is_sphere, sv, vv),
            mat.to(DTYPE), torch.zeros_like(t))


def rich_albedo_multiply(scene: Scene, o, d, hit, thr, alive):
    """The rich-texture post-multiply of the JAX package's
    ``_fused_shade_bounce``: the shade kernel shaded image, noise, marble
    and custom textures at albedo 1.0, so each lane that stays ``alive``
    on such a texture gets ``thr *= albedo``, evaluated at the point
    ``o + t_safe * d`` and the hit's uv (marble stripes through kernel
    K12).  ``o``, ``d``, ``thr`` are [3, R], ``hit`` the 10 hit columns
    of :func:`surface_hit`.  Only those lanes are evaluated."""
    tx = scene.textures
    tex_id = scene.materials.tex[hit[8].long()].long()
    tkind = tx.kind[tex_id]
    live = alive & (tkind > TEX_CHECKER)
    sel = torch.nonzero(live)[:, 0]
    t = hit[0][sel]
    t_safe = torch.where(torch.isfinite(t), t, 1.0)
    point = (o[:, sel] + t_safe * d[:, sel]).T.contiguous()
    uv = torch.stack([hit[6][sel], hit[7][sel]], dim=1)
    alb = eval_texture(tx, tex_id[sel], point, uv, marble_kernel=True)
    thr = thr.clone()
    thr[:, sel] = thr[:, sel] * alb.T
    return thr


def bounce_split_soa(scene: Scene, s: CameraSettings, comps, uniforms, rad,
                     thr, alive, tables: SplitTables):
    """One bounce of every lane through the split path (the JAX package's
    ``bounce`` with its kernel intersect and ``_fused_shade_bounce``): the
    nearest-hit kernel, the sphere uv, the shade kernel, then the
    rich-texture multiply (:func:`rich_albedo_multiply`).  The arguments
    and results are those of :func:`bounce_mega_soa`."""
    tb = tables
    # dead lanes carry stale rays: park them far outside the scene
    o = torch.where(alive, comps[0:3], 3e18)
    d = comps[3:6]
    hit = surface_hit(tb, o, d, comps[6])
    lanes = (o[0], o[1], o[2], d[0], d[1], d[2], thr[0], thr[1], thr[2],
             alive.to(DTYPE))
    outs = shade_megakernel(tb.mtbl, tb.ttbl, hit, None, lanes,
                            uniforms[:N_U], n_mats=tb.n_mats,
                            n_targets=tb.n_targets, has_medium=False)
    new_comps = torch.stack(outs[0:6] + (comps[6],))
    thr_new = torch.stack(outs[6:9])
    alive_new = outs[12] > 0.5
    miss = outs[13] > 0.5
    bg = s.background(o.T, d.T).to(DTYPE).T
    rad_new = rad + torch.where(miss, thr * bg, 0.0) + torch.stack(outs[9:12])
    if tb.rich:
        thr_new = rich_albedo_multiply(scene, o, d, hit, thr_new, alive_new)
    return new_comps, rad_new, thr_new, alive_new, alive & ~alive_new


def _bounce_step(scene: Scene, s: CameraSettings, n_rays: int):
    """``(bounce, tables)`` of the forward drivers for this scene: kernel
    A's :func:`bounce_mega_soa`, or for every scene kernel A refuses
    (tables over 512 rows, rich textures, more behaviours than it stages)
    the split path's :func:`bounce_split_soa`, as the JAX package's
    drivers fall back to ``bounce``; with their tables packed once.
    Raise, naming the ROADMAP item, if neither takes the scene."""
    if _ineligible_reason(scene, s, n_rays) is None:
        return bounce_mega_soa, bounce_tables(scene, s)
    reason = _split_ineligible_reason(scene, s, n_rays)
    if reason is None:
        return bounce_split_soa, split_tables(scene, s)
    raise NotImplementedError(f"render: {reason}")


def _init_comps(lanes: int, device):
    comps = torch.zeros((7, lanes), dtype=DTYPE, device=device)
    comps[5] = 1.0      # dummy unit direction (0, 0, 1)
    return comps


def trace_wavefront(scene: Scene, s: CameraSettings, base_key, n_pix: int,
                    spp: int, n_lanes: int, acc=None, sample_offset: int = 0):
    """Work-queue wavefront: ``n_pix * spp`` paths on a pool of
    ``n_lanes`` lanes, dead lanes refilled every iteration.  Work item
    ``w`` is (pixel ``w % n_pix``, sample ``w // n_pix``).  Returns the
    [n_pix, 3] radiance *sum* over samples (plus ``acc``)."""
    dev = scene.device
    total_work = n_pix * spp
    n_u = n_bounce_uniforms(scene)
    cam = camera_table(s, camera_frame(s))
    if acc is None:
        acc = torch.zeros((n_pix, 3), dtype=DTYPE, device=dev)
    lanes = min(n_lanes, -(-total_work // LANE_ALIGN) * LANE_ALIGN)
    bounce_fn, tables = _bounce_step(scene, s, lanes)
    base_key = base_key.to(dev)

    acc3 = torch.zeros((3, n_pix), dtype=DTYPE, device=dev)
    next_w = torch.zeros((), dtype=torch.int64, device=dev)
    comps = _init_comps(lanes, dev)
    rad = torch.zeros((3, lanes), dtype=DTYPE, device=dev)
    thr = torch.ones((3, lanes), dtype=DTYPE, device=dev)
    alive = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    pixel = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    sample = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    depth = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    keys = rng.ray_keys_fast(base_key, pixel, sample)

    while bool((next_w < total_work) | alive.any()):
        # regenerate dead lanes from the queue
        dead = ~alive
        dead_i = dead.to(torch.int64)
        wi = next_w + torch.cumsum(dead_i, 0) - dead_i
        can = dead & (wi < total_work)
        new_pixel = (wi % n_pix).to(torch.int32)
        new_sample = (torch.div(wi, n_pix, rounding_mode="floor")
                      + sample_offset).to(torch.int32)
        nk = rng.ray_keys_fast(base_key, new_pixel, new_sample)
        keys = torch.where(can[:, None], nk, keys)
        rad = rad * (1.0 - can.to(DTYPE))
        thr = torch.where(can, 1.0, thr)
        pixel = torch.where(can, new_pixel, pixel)
        sample = torch.where(can, new_sample, sample)
        depth = torch.where(can, 0, depth)
        alive = alive | can
        next_w = next_w + can.sum()

        # one uniform block: bounce draws, camera draws, RR
        uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), n_u + 6)
        new_comps = rays_from_table(cam, s.image_width, pixel,
                                    uniforms[n_u:n_u + 5])
        comps = torch.where(can, new_comps, comps)
        comps, rad, thr, alive, died = bounce_fn(
            scene, s, comps, uniforms, rad, thr, alive, tables=tables)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[n_u + 5], depth, thr, alive, died)

        # flush finished paths into the accumulator
        acc3.index_add_(1, pixel.long(), rad * died.to(DTYPE))
    return acc + acc3.T


def trace_wavefront_stationary(scene: Scene, s: CameraSettings, base_key,
                               n_pix: int, spp: int, acc=None,
                               sample_offset: int = 0,
                               rotate_k: int = 1, pixel_offset: int = 0):
    """Pixel-stationary wavefront: lane ``l`` owns pixel ``pixel_offset +
    l`` and traces its ``spp`` samples in turn.  ``rotate_k > 1`` (a
    divisor of ``spp``) rotates each lane through ``k`` pixels — lane
    ``l`` serves lane slot ``(l + c*stride) % lanes`` for samples in
    chunk ``c = sample // (spp/k)`` — so per-lane work averages the
    path-length variance of ``k`` pixels; its contributions land back in
    place through ``k`` masked rolls.  Returns the [n_pix, 3] radiance
    sum (plus ``acc``)."""
    dev = scene.device
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    k_rot = rotate_k if (rotate_k > 1 and spp % rotate_k == 0) else 1
    spp_k = spp // k_rot
    n_u = n_bounce_uniforms(scene)
    cam = camera_table(s, camera_frame(s))
    if acc is None:
        acc = torch.zeros((n_pix, 3), dtype=DTYPE, device=dev)
    base_key = base_key.to(dev)
    last_sample = sample_offset + spp - 1

    # rotation stride: a multiple of 32 x 128 lanes near lanes / k;
    # small pools where that degenerates use plain lanes / k
    blk = 32 * LANE_ALIGN
    stride = max((lanes // max(k_rot, 1)) // blk * blk, blk)
    if k_rot > 1 and stride % lanes == 0:
        stride = max(lanes // k_rot, 1)

    lane_ids = torch.arange(lanes, dtype=torch.int32, device=dev)
    base_pixel = pixel_offset + torch.clamp(lane_ids, max=n_pix - 1)

    # the forward's fused branch takes kernel A's tables (at most 512
    # rows, the JAX package's forward cap); larger tables take the split
    # bounce below
    if k_rot == 1 and fused_iter_eligible(scene, s, lanes):
        # the whole body is kernel B + the accumulation add
        step = fused_iter_fwd_step(scene, s, base_key, spp, sample_offset)
        init_smp = torch.where(lane_ids < n_pix, sample_offset - 1,
                               last_sample + 1).to(torch.int32)
        comps = _init_comps(lanes, dev)
        z = torch.zeros((lanes,), dtype=DTYPE, device=dev)
        o = torch.ones((lanes,), dtype=DTYPE, device=dev)
        carry = ((init_smp, torch.zeros_like(init_smp), z)
                 + tuple(comps.unbind(0)) + (z, z, z) + (o, o, o))
        acc3 = torch.zeros((3, lanes), dtype=DTYPE, device=dev)
        while bool(((carry[2] > 0.5) | (carry[0] < last_sample)).any()):
            carry, rad2, died_f = step(base_pixel, carry)
            acc3 += torch.stack(rad2) * died_f
    else:
        if k_rot == 1:
            # padding lanes (>= n_pix) start exhausted
            sample = torch.where(lane_ids < n_pix, sample_offset - 1,
                                 last_sample + 1).to(torch.int32)
            maps = None
        else:
            # every lane works; padding slots' contributions land at
            # slots >= n_pix and are dropped at the end
            sample = torch.full((lanes,), sample_offset - 1,
                                dtype=torch.int32, device=dev)
            maps = [pixel_offset + torch.clamp(
                        (lane_ids + cc * stride) % lanes, max=n_pix - 1)
                    for cc in range(k_rot)]
        bounce_fn, tables = _bounce_step(scene, s, lanes)
        comps = _init_comps(lanes, dev)
        rad = torch.zeros((3, lanes), dtype=DTYPE, device=dev)
        thr = torch.ones((3, lanes), dtype=DTYPE, device=dev)
        alive = torch.zeros((lanes,), dtype=torch.bool, device=dev)
        depth = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        keys = rng.ray_keys_fast(base_key, torch.zeros_like(lane_ids),
                                 torch.zeros_like(lane_ids))
        acc3 = torch.zeros((3, lanes), dtype=DTYPE, device=dev)

        while bool((alive | (sample < last_sample)).any()):
            # start this lane's next sample if idle
            can = ~alive & (sample < last_sample)
            sample = torch.where(can, sample + 1, sample)
            if maps is None:
                lane_pixel = base_pixel
            else:
                rot_c = torch.clamp(torch.div(sample - sample_offset, spp_k,
                                              rounding_mode="floor"),
                                    0, k_rot - 1)
                lane_pixel = maps[0]
                for cc in range(1, k_rot):
                    lane_pixel = torch.where(rot_c == cc, maps[cc],
                                             lane_pixel)
            nk = rng.ray_keys_fast(base_key, lane_pixel, sample)
            keys = torch.where(can[:, None], nk, keys)
            rad = rad * (1.0 - can.to(DTYPE))
            thr = torch.where(can, 1.0, thr)
            depth = torch.where(can, 0, depth)
            alive = alive | can

            uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), n_u + 6)
            new_comps = rays_from_table(cam, s.image_width, lane_pixel,
                                        uniforms[n_u:n_u + 5])
            comps = torch.where(can, new_comps, comps)
            comps, rad, thr, alive, died = bounce_fn(
                scene, s, comps, uniforms, rad, thr, alive, tables=tables)
            depth = depth + 1
            capped = alive & (depth >= s.max_depth)
            died = died | capped
            alive = alive & ~capped
            if s.rr_depth is not None:
                thr, alive, died = _russian_roulette(
                    s, uniforms[n_u + 5], depth, thr, alive, died)

            # flush: lane-indexed masked add; with rotation, chunk c's
            # contributions shift back by c * stride lanes
            contrib = rad * died.to(DTYPE)
            if maps is None:
                acc3 += contrib
            else:
                for cc in range(k_rot):
                    m = (rot_c == cc).to(DTYPE)
                    acc3 += torch.roll(contrib * m, cc * stride, dims=1)
    return acc + acc3[:, :n_pix].T


def _trace_wavefront_diff_fused(scene: Scene, s: CameraSettings, base_key,
                                pixel_ids, spp: int, n_iters: int,
                                sample_offset: int, schedule):
    """The fused differentiable driver: ``n_iters`` iterations of the
    differentiable step on every lane, then the completion schedule.
    There is no host sync inside the loops."""
    from ..diff.fused_iter import fused_iter_step
    dev = scene.device
    lanes = pixel_ids.shape[0]
    last_sample = sample_offset + spp - 1
    step = fused_iter_step(scene, s, base_key.to(dev), spp, sample_offset)

    def init_carry(w):
        z = torch.zeros((w,), dtype=DTYPE, device=dev)
        o = torch.ones((w,), dtype=DTYPE, device=dev)
        zi = torch.zeros((w,), dtype=torch.int32, device=dev)
        return ((torch.full((w,), sample_offset - 1, dtype=torch.int32,
                            device=dev), zi, z)
                + (z, z, z, z, z, o, z) + (z, z, z) + (o, o, o))

    def run(pix, state, n):
        acc, done, carry = state
        for _ in range(n):
            carry, died_f = step(pix, carry)
            acc = tuple(a + r * died_f for a, r in zip(acc, carry[10:13]))
            done = done + died_f.to(torch.int32)
        return acc, done, carry

    def zeros_state(w, carry):
        z = torch.zeros((w,), dtype=DTYPE, device=dev)
        return (z, z, z), torch.zeros((w,), dtype=torch.int32,
                                      device=dev), carry

    pix = pixel_ids.to(device=dev, dtype=torch.int32)
    acc, done, carry = run(pix, zeros_state(lanes, init_carry(lanes)),
                           n_iters)
    if schedule:
        # compact the unfinished lanes (stable: JAX's argsort is) and run
        # each phase there; its sums land back in the lanes' slots
        slot = torch.arange(lanes, device=dev)
        for it_b, w_b in schedule:
            smp_c, _, al_c = carry[0:3]
            unfinished = (al_c > 0.5) | (smp_c < last_sample)
            sel = torch.argsort((~unfinished).to(torch.int32),
                                stable=True)[:w_b]
            slot = slot[sel]
            pix = pix[sel]
            acc_b, done_b, carry = run(
                pix, zeros_state(w_b, tuple(c[sel] for c in carry)), it_b)
            acc = tuple(a.index_add(0, slot, ab)
                        for a, ab in zip(acc, acc_b))
            done = done.index_add(0, slot, done_b)
    mean = torch.stack(acc, dim=-1) / torch.clamp(done, min=1)[:, None]
    return mean, done


def trace_wavefront_diff(scene: Scene, s: CameraSettings, base_key,
                         pixel_ids, spp: int, n_iters: int | None = None,
                         sample_offset: int = 0, remat: bool = True,
                         use_mega: bool | None = None, rotate_k: int = 1,
                         skip_done: bool = False, pixel_cost=None,
                         schedule: tuple | None = None):
    """Differentiable pixel-stationary wavefront over the lanes
    ``pixel_ids[P]`` (a multiple of 128): each lane traces ``spp``
    samples of its pixel in turn for a fixed ``n_iters`` iterations
    (default ``6 * spp + max_depth``).  Returns ``(mean_radiance[P, 3],
    samples_done[P])``: lanes that run out of iterations drop their
    remaining samples, so monitor ``samples_done == spp``.

    ``schedule``: ``((extra_iters, width), ...)`` completion phases: after
    the full-width iterations the unfinished lanes are compacted into
    ``width`` lanes and run ``extra_iters`` more; the compacted lanes
    keep their absolute (pixel, sample) coordinates, so the estimator is
    the single-phase one.

    The port has the fused driver only: ``remat``, ``skip_done``,
    ``rotate_k > 1``, ``pixel_cost`` and the unfused path (``use_mega``
    False) raise ``NotImplementedError``."""
    if remat:
        raise NotImplementedError(
            "trace_wavefront_diff: remat=True (recompute the forward in the "
            "backward) is not ported yet (ROADMAP M6c); pass remat=False")
    if skip_done or rotate_k != 1 or pixel_cost is not None:
        raise NotImplementedError(
            "trace_wavefront_diff: skip_done, rotate_k > 1 and pixel_cost "
            "are not ported yet (ROADMAP M6c)")
    if use_mega is False:
        raise NotImplementedError(
            "trace_wavefront_diff: the unfused differentiable path "
            "(diff/mega_bounce.py) is not ported yet (ROADMAP M11)")
    if n_iters is None:
        n_iters = 6 * spp + s.max_depth
    if pixel_ids.shape[0] % LANE_ALIGN:
        raise ValueError(f"trace_wavefront_diff: {pixel_ids.shape[0]} lanes "
                         f"is not a multiple of {LANE_ALIGN}")
    return _trace_wavefront_diff_fused(scene, s, base_key, pixel_ids, spp,
                                       n_iters, sample_offset, schedule)
