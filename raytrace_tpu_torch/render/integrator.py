"""Wavefront path-tracing drivers, forward subset
(``raytrace_tpu/render/integrator.py``).

A pool of lanes advances through bounce iterations carrying (radiance,
throughput, alive); each recursion level ``emitted + weight * child``
becomes ``radiance += throughput * emitted; throughput *= weight``, and a
finished path adds its radiance into the image.

* :func:`trace_wavefront_stationary` — lane ``l`` owns pixel ``l`` for
  the launch and traces its samples one after another; with ``rotate_k >
  1`` a lane rotates through ``k`` pixels spread over the image.  Where
  kernel B takes the scene the whole body is kernel B (its rotated mode
  where the pixels rotate); elsewhere it is torch glue (RNG, camera,
  regeneration, Russian roulette, flush) around the bounce.
* :func:`trace_wavefront` — a work queue refills dead lanes with the next
  (pixel, sample) around the bounce.
* :func:`trace_wavefront_sorted` — the work queue over a pool of one lane
  per pixel, with the lanes re-sorted every iteration by direction octant
  and the Morton cell of the origin, so that the rays of a block of
  threads travel together; stationary renders of mesh-boundary media and
  of tables of 8,192 rows and more take it.

The bounce is kernel A for tables of at most 512 rows with constant and
checker textures (:func:`bounce_mega_soa`).  Every other scene takes the
split path (:func:`bounce_split_soa`), as the JAX package's ``bounce``
does: the nearest hit record (:func:`surface_engine`: kernel K8's flat
scan for small and unsegmented tables, kernel K9's walk of a BVH for
kind-segmented tables of 192 rows and more, of any size, and for scenes
compiled in the BVH accelerator mode on the card; on the CPU such a
scene walks its own threaded tree in torch, ``ops/intersect.py:
nearest_hit_t``), the exact sphere uv in torch (in object
space for rotated sphere instances), the ellipsoids' nearest hit merged
in (``ops/ellipsoid.py``), for scenes with constant-density media the
nearest medium's scatter candidate (``render/volumes.py:medium_hit``:
kernel K11, or K11b for mesh boundaries, in the candidate mode) passed
to the shade kernel (``shade_megakernel``), then the
image, noise, marble and custom texture albedo multiplied into the
surviving lanes' throughput in torch (marble stripes through kernel K12).

Every random draw is a pure function of (pixel, sample, depth, column), so
every driver and every ``rotate_k`` traces the same samples.  The loop
condition is read on the host once per iteration, under the span
``driver.wait``, and the iteration's body runs under ``driver.iteration``
(:func:`_turns`, ``utils/profiling.py``).  With ``with_stats`` each of
the three also returns ``dict(iterations, segments, lanes)``
(:func:`_stats`; for a scene with media the sorted driver's and the
stationary driver's split branch add ``medium_segments``), whose
count adds no host read and no op to the image's.  (On the card the
queue's and the sorted driver's ``index_add_`` adds the paths of a pixel
that finish in one iteration in an order that can vary between runs,
flag or not.)

Lane state is stacked: comps [7, R] (origin, direction, time), rad and
thr [3, R]; the JAX package keeps the same rows as tuples of [R] arrays.

* :func:`trace_wavefront_diff` — the differentiable pixel-stationary
  wavefront: a fixed number of iterations, then optional compacted
  completion phases, through one of two routes: the fused differentiable
  step (kernel B forward, kernel K5 backward; carries as tuples of [R]
  tensors, as the JAX package keeps them), or the unfused driver for
  ``rotate_k > 1``, ``pixel_cost`` (:func:`lane_cost_estimate`,
  :func:`_antithetic_maps`), ``skip_done`` and the scenes the fused step
  refuses: torch glue around ``diff/mega_bounce.py:mega_bounce_diff_soa``
  (kernel A forward, kernel K7 backward).

* :func:`bounce_generic_soa` — the JAX package's generic ``bounce`` in
  both modes: with ``diff=False`` the forward drivers' third route, for
  the scenes neither kernel A nor the split path takes (lights with rich
  textures, more than 24 materials or 8 redirect targets); with
  ``diff=True`` the unfused differentiable driver's bounce for every
  scene the fused step and kernel A refuse (media, ``use_mega=False``,
  rich textures and tables of more than 512 rows off the fused step):
  the nearest-hit kernels (through the winner-only differentiable hit),
  the crossing kernels (in their candidate mode forward, their keyed mode
  differentiable), and the shading in plain torch.
* :func:`trace` — the bounded-depth driver of a fixed batch of rays
  (``diff/gradients.py:render_tile``), forward or differentiable.

:func:`bounce_route`, :func:`diff_route` and :func:`surface_engine` name
the route each driver takes; ``utils/engines.py:engine_report`` reads
them.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core import rng
from ..core.vecmath import (
    DTYPE, normalize, reflect, refract, take_rows, vcross, vdot0,
)
from ..diff.fused_iter import fused_iter_eligible, fused_iter_fwd_step
from ..materials.materials import (
    MAT_ANISOTROPIC, MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_LIGHT, MAT_LOMMEL,
    MAT_METAL, MAT_MIRROR, MAT_PITCH_BLACK, MAT_TRANSPARENT, MaterialTable,
)
from ..ops.diff_intersect import HitStatics, diff_surface_hit, hit_statics
from ..ops.ellipsoid import merge_ellipsoid_hits
from ..ops.allpairs_kernel import (
    MAX_BVH_ROWS, MIN_PRIMS, DeviceBVH, allpairs_nearest_record, pack_bvh,
)
from ..ops.bounce_kernel import (
    MAX_MAT_ROWS, MAX_SHADE_MATS, MAX_TARGETS, N_U, BounceLaunch,
    bounce_megakernel, pack_behaviors, pack_materials, pack_targets,
    prepare_bounce, shade_megakernel,
)
from ..ops.intersect import (
    INF, apply_sphere_rotations, make_hit_record, nearest_hit_t,
)
from ..ops.intersect_kernel import (
    MAX_SMEM_PRIMS, pack_prims, pallas_nearest_record,
)
from ..ops.iter_kernel import Rotation
from ..ops.sorted_turn import (
    SortedTurn, sorted_head, sorted_lanes, sorted_tail,
)
from ..scene.types import BVH, Ellipsoids, Primitives, Scene, Volumes
from ..textures.textures import (
    TEX_CHECKER, TEX_CONSTANT, eval_texture, is_rich,
)
from ..utils import profiling
from .camera import CameraSettings, camera_frame, camera_table, rays_from_table
from .volumes import (
    CrossingStatics, VolumeTables, crossing_statics, medium_hit,
    volume_candidates_diff, volume_tables,
)

_N_BASE_U = 8       # bounce uniform columns, + one per medium
LANE_ALIGN = 128    # lane-pool alignment; keeps lane->pixel maps as JAX's
# row cap of the fused differentiable driver (kernel B and its mesh
# variant forward, K5 backward)
MEGA_MAX_PRIMS = 8192


def n_bounce_uniforms(scene: Scene) -> int:
    """Uniform columns of one bounce: 8, then one free-flight draw per
    medium.  The camera and Russian-roulette draws follow them, so media
    move those columns (and, through the pair16 layout, every draw)."""
    nv = scene.volumes.n_volumes if scene.volumes is not None else 0
    return _N_BASE_U + nv


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
    (thr', alive', died').  The survival probability is a sampling
    decision, like the MIS pdf, so no gradient flows through it (the JAX
    package's ``detach=True``; the port's forward drivers carry no
    gradient, so every caller detaches)."""
    thr_max = torch.maximum(thr[0], torch.maximum(thr[1], thr[2]))
    p = torch.clamp(thr_max, min=s.rr_min, max=1.0).detach()
    do = depth >= s.rr_depth
    kill = do & (u_rr >= p)
    scale = torch.where(do & ~kill, 1.0 / p, 1.0)
    return thr * scale, alive & ~kill, died | (alive & kill)


_RICH_LIGHT = ("lights with image, noise, marble or custom textures: their "
               "emission is shaded in-kernel (the generic bounce takes "
               "them)")


def _kernel_reason(scene: Scene, s: CameraSettings, n_rays: int,
                   max_rows: int, defer_rich: bool = False):
    """Why kernels A and B (at most ``max_rows`` rows) cannot take this
    scene (with the ROADMAP item that will cover it), or None.  The
    kernels shade constant and checker textures; ``defer_rich`` (the
    differentiable driver, which multiplies the other kinds in after each
    iteration) lets them shade the rest at albedo 1.0, except on lights,
    whose emission is in-kernel."""
    if scene.volumes is not None:
        return ("constant-density media: kernels A and B do not take them "
                "(the forward takes the split path, the fwd+bwd the "
                "generic differentiable bounce)")
    if scene.ellipsoids is not None:
        return ("ellipsoids: kernels A and B do not take them (the forward "
                "takes the split path, the fwd+bwd the generic "
                "differentiable bounce)")
    if scene.bvh is not None:
        return ("the BVH accelerator mode: its unsegmented table takes the "
                "split path and the generic differentiable bounce, as in "
                "the JAX package")
    rows = scene.prims.kind.shape[0]
    if rows > max_rows:
        return (f"{rows} primitive rows: the kernels take at most "
                f"{max_rows} here")
    m = scene.materials
    n_rows = m.n_behaviors if m.n_behaviors > 0 else m.kind.shape[0]
    if defer_rich and is_rich(m.light_tex_kinds):
        return _RICH_LIGHT
    if not defer_rich and is_rich(scene.textures.kinds_present):
        return ("kernel A shades constant and checker textures only (the "
                "split path multiplies the other kinds in)")
    if s.n_redirect > MAX_TARGETS:
        return (f"{s.n_redirect} redirect targets: the kernels take at most "
                f"{MAX_TARGETS}")
    if n_rows > MAX_MAT_ROWS:
        return (f"{n_rows} material behaviours: the kernels take at most "
                f"{MAX_MAT_ROWS}")
    if scene.prims.sphere_rots and TEX_CHECKER in \
            scene.textures.kinds_present:
        return ("rotated checker-textured spheres: the kernels' checker "
                "reads world-space uv (the split path and the generic "
                "bounce rotate it into object space)")
    if n_rays % LANE_ALIGN:
        return f"{n_rays} lanes: not a multiple of {LANE_ALIGN}"
    return None


def _ineligible_reason(scene: Scene, s: CameraSettings, n_rays: int):
    """Why kernel A (at most 512 rows) cannot take this scene, or None."""
    return _kernel_reason(scene, s, n_rays, MAX_SMEM_PRIMS)


def _split_ineligible_reason(scene: Scene, s: CameraSettings, n_rays: int):
    """Why the split path (nearest kernel, media crossings, shade kernel,
    the rich-texture multiply) cannot take this scene, or None: it takes
    tables of any size (up to ``MAX_BVH_ROWS``), up to 24 materials and 8
    redirect targets, any number of media, and every texture kind except
    on lights.  The shade kernel's part is the JAX package's
    ``fused_shade_eligible``."""
    p, m = scene.prims, scene.materials
    reason = _generic_reason(scene, s)
    if reason is not None:
        return reason
    if m.kind.shape[0] > MAX_SHADE_MATS:
        return (f"{m.kind.shape[0]} materials: the shade kernel takes at "
                f"most {MAX_SHADE_MATS}")
    if s.n_redirect > MAX_TARGETS:
        return (f"{s.n_redirect} redirect targets: the shade kernel takes "
                f"at most {MAX_TARGETS}")
    if is_rich(m.light_tex_kinds):
        return _RICH_LIGHT
    if n_rays % LANE_ALIGN:
        return f"{n_rays} lanes: not a multiple of {LANE_ALIGN}"
    return None


def bounce_kernel_eligible(scene: Scene, s: CameraSettings,
                           n_rays: int) -> bool:
    """Static check for kernel A (the forward cap of the JAX package's
    check): no media, at most 512 rows, constant or checker textures, at
    most 8 redirect targets and 16 material behaviours, lanes a multiple
    of 128."""
    return _ineligible_reason(scene, s, n_rays) is None


@dataclasses.dataclass(frozen=True)
class BounceTables:
    """Packed tables and static parameters of kernel A for one scene and
    camera, on the scene's device; ``launch`` is kernel A's
    ``prepare_bounce`` of them, made at the first launch (the tables'
    checks, the planar flag and the table part of the argument struct,
    once per driver call)."""
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

    @functools.cached_property
    def launch(self) -> BounceLaunch:
        return prepare_bounce(self.ptbl, self.mtbl, self.ttbl, **self.kw)


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
                    tables: BounceTables | None = None, medium_count=None):
    """One bounce of every lane through kernel A.  ``comps`` [7, R],
    ``uniforms`` [>=8, R], ``rad``/``thr`` [3, R], ``alive`` bool [R].
    Returns (comps', rad', thr', alive', died), plus the winner row index
    (i32, -1 on a miss) with ``with_idx``.  The background on a miss is
    added here, so any background callable works.  ``medium_count`` is
    the other bounces' (:func:`bounce_split_soa`); media never take
    kernel A, so it stays as it is."""
    tb = tables if tables is not None else bounce_tables(scene, s)
    # dead lanes carry stale rays: park them far outside the scene
    o = torch.where(alive, comps[0:3], 3e18)
    outs = bounce_megakernel(
        tb.ptbl, tb.mtbl, tb.ttbl, o[0], o[1], o[2], comps[3], comps[4],
        comps[5], comps[6], thr[0], thr[1], thr[2], alive.to(DTYPE),
        uniforms[:N_U], **tb.kw, prepared=tb.launch)
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
    shade kernel defers (image, noise, marble, custom); ``sphere_rots``
    the rotated uv-textured spheres' rows and rotations; ``ellipsoids``
    the scene's ellipsoids or None.  For a scene with media: ``volumes``
    and their packed boundary table, BVH forest and prepared
    crossing-kernel launches (``render/volumes.py:volume_tables``, which
    hold each medium's density and material id)."""
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
    volumes: Volumes | None = None
    vol_tables: VolumeTables | None = None
    sphere_rots: tuple = ()
    ellipsoids: Ellipsoids | None = None
    tree: tuple[Primitives, BVH] | None = None


def uses_bvh(prims) -> bool:
    """Does the split path walk a BVH (kernel K9) for this dense table, or
    scan it flat (kernel K8)?  The JAX package's rule (``_surface_hit``):
    the all-pairs kernel for kind-segmented tables of ``MIN_PRIMS`` (192)
    rows and more, of any size, the flat scan otherwise."""
    return prims.kind_segments is not None and \
        _n_scan_prims(prims) >= MIN_PRIMS


def surface_engine(scene: Scene) -> str:
    """The split path's nearest hit for this scene: ``"K9"`` (the BVH walk
    kernel: :func:`uses_bvh`, and the BVH accelerator mode's unsegmented
    table on the card), ``"K8"`` (the flat scan) or ``"torch-bvh"`` (the
    BVH mode on the CPU: the walk of the scene's threaded tree in torch,
    ``ops/intersect.py:nearest_hit_t``, the route of the JAX package's
    BVH mode)."""
    if scene.bvh is not None:
        return "torch-bvh" if scene.device.type == "cpu" else "K9"
    return "K9" if uses_bvh(scene.prims) else "K8"


def split_tables(scene: Scene, s: CameraSettings) -> SplitTables:
    """Pack the split path's tables and, for a table K9 serves, build its
    BVH (once per driver call); a BVH-mode scene on the CPU keeps its
    table and threaded tree for the walk in torch."""
    dev = scene.device
    p = scene.prims
    n_prims = _n_scan_prims(p)
    vol = scene.volumes
    ptbl = pack_prims(p).contiguous()
    engine = surface_engine(scene)
    return SplitTables(
        ptbl=ptbl,
        mtbl=pack_materials(scene.materials, scene.textures).to(dev)
        .contiguous(),
        ttbl=pack_targets(s.redirect_prob, s.redirect_q, s.redirect_u,
                          s.redirect_v).to(dev).contiguous(),
        bvh=pack_bvh(p, ptbl, n_prims) if engine == "K9" else None,
        n_prims=n_prims,
        n_mats=scene.materials.kind.shape[0], n_targets=s.n_redirect,
        has_motion=p.has_motion, t_min=float(np.float32(s.t_min)),
        rich=is_rich(scene.textures.kinds_present), volumes=vol,
        vol_tables=None if vol is None else volume_tables(vol),
        sphere_rots=p.sphere_rots, ellipsoids=scene.ellipsoids,
        tree=(p, scene.bvh) if engine == "torch-bvh" else None)


def surface_hit(tb: SplitTables, o, d, time, ellipsoids: bool = True):
    """The nearest hit record of every lane (``o``, ``d`` [3, R], ``time``
    [R]) through a nearest-hit kernel (the BVH walk where ``tb`` has a
    BVH, else the flat scan), with the exact sphere uv from the outward
    normal computed here in torch (turned into object space first for the
    rows of ``tb.sphere_rots``), or, for ``tb.tree``, by the walk of the
    BVH mode's tree in torch and the winner's record; then, with
    ``ellipsoids``, the nearest ellipsoid hit of ``tb.ellipsoids`` merged
    in (winner index ``-2 - e``), as the JAX package's ``_surface_hit``
    does after its kernel.  Returns the 10 [R] f32 hit columns of
    ``shade_megakernel`` (sphere flag 0: the uv is final)."""
    if tb.tree is not None:
        t, idx, nx, ny, nz, front, uu, vv, mat = _tree_hit(tb, o, d, time)
    else:
        t, idx, nx, ny, nz, front, uu, vv, mat = _kernel_hit(tb, o, d, time)
    if ellipsoids and tb.ellipsoids is not None:
        t, idx, normal, front, uv, mat = merge_ellipsoid_hits(
            tb.ellipsoids, o.T, d.T, time, tb.t_min, t, idx,
            torch.stack([nx, ny, nz], dim=-1), front,
            torch.stack([uu, vv], dim=-1), mat)
        # the shade kernel takes contiguous columns
        nx, ny, nz = normal.T.contiguous()
        uu, vv = uv.T.contiguous()
    return (t, idx.to(DTYPE), nx, ny, nz, front.to(DTYPE), uu, vv,
            mat.to(DTYPE), torch.zeros_like(t))


def _tree_hit(tb: SplitTables, o, d, time):
    """:func:`surface_hit`'s record by ``nearest_hit_t`` over the BVH
    mode's tree ``tb.tree`` and the winner's record (its sphere uv in
    object space for rotated spheres), the JAX package's XLA route."""
    prims, tree = tb.tree
    o_r, d_r = o.T, d.T
    t, idx = nearest_hit_t(prims, tree, o_r, d_r, time,
                           torch.full_like(time, tb.t_min),
                           torch.full_like(time, INF))
    rec = make_hit_record(prims, idx, o_r, d_r, time,
                          torch.where(torch.isfinite(t), t, 1.0))
    nx, ny, nz = rec.normal.T
    uu, vv = rec.uv.T
    return t, idx, nx, ny, nz, rec.front, uu, vv, rec.mat


def _kernel_hit(tb: SplitTables, o, d, time):
    """:func:`surface_hit`'s record by kernel K9 or K8, the sphere uv
    from the outward normal."""
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
    if tb.sphere_rots:
        owx, owy, owz = apply_sphere_rotations(
            torch.stack([owx, owy, owz], dim=-1), idx,
            tb.sphere_rots).unbind(-1)
    xz_ok = owx ** 2 + owz ** 2 > 1e-12
    sx = torch.where(xz_ok, owx, 0.0)
    sz = torch.where(xz_ok, owz, 1.0)
    su = torch.atan2(sx, sz) / (2.0 * math.pi) + 0.5
    sv = torch.arccos(torch.clamp(-owy, -1.0 + 1e-6, 1.0 - 1e-6)) / math.pi
    uu = torch.where(is_sphere, su, uu)
    vv = torch.where(is_sphere, sv, vv)
    return t, idx, nx, ny, nz, front, uu, vv, mat


def rich_albedo_multiply(scene: Scene, o, d, hit, thr, alive, medium=None):
    """The rich-texture post-multiply of the JAX package's
    ``_fused_shade_bounce``: the shade kernel shaded image, noise, marble
    and custom textures at albedo 1.0, so each lane that stays ``alive``
    on such a texture gets ``thr *= albedo``, evaluated at the point
    ``o + t_safe * d`` and the hit's uv (marble stripes through kernel
    K12).  ``o``, ``d``, ``thr`` are [3, R], ``hit`` the 10 hit columns
    of :func:`surface_hit`.  A medium event ``medium`` = (t_med, material
    id) nearer than the surface takes the medium's material, its point
    and uv 0, as the shade kernel does.  Only those lanes are
    evaluated; while the recorder records, their number is added to the
    counter ``bounce.texture_lanes``."""
    tx = scene.textures
    t, mat, uu, vv = hit[0], hit[8], hit[6], hit[7]
    if medium is not None:
        t_med, vmat = medium
        in_med = t_med < t
        mat = torch.where(in_med, vmat, mat)
        t = torch.minimum(t_med, t)
        uu = torch.where(in_med, 0.0, uu)
        vv = torch.where(in_med, 0.0, vv)
    tex_id = scene.materials.tex[mat.long()].long()
    tkind = tx.kind[tex_id]
    live = alive & (tkind > TEX_CHECKER)
    sel = torch.nonzero(live)[:, 0]
    # the nonzero has read the count to the host already
    profiling.count("bounce.texture_lanes", sel.shape[0])
    t = t[sel]
    t_safe = torch.where(torch.isfinite(t), t, 1.0)
    point = (o[:, sel] + t_safe * d[:, sel]).T.contiguous()
    uv = torch.stack([uu[sel], vv[sel]], dim=1)
    alb = eval_texture(tx, tex_id[sel], point, uv, marble_kernel=True)
    thr = thr.clone()
    thr[:, sel] = thr[:, sel] * alb.T
    return thr


def bounce_split_soa(scene: Scene, s: CameraSettings, comps, uniforms, rad,
                     thr, alive, tables: SplitTables, medium_count=None):
    """One bounce of every lane through the split path (the JAX package's
    ``bounce`` with its kernel intersect and ``_fused_shade_bounce``): the
    nearest-hit kernel, the sphere uv, with media the nearest medium's
    scatter candidate from the uniform columns ``8 .. 8 + V`` (the first
    medium on a tie; ``render/volumes.py:medium_hit``), the shade kernel,
    then the rich-texture
    multiply (:func:`rich_albedo_multiply`).  The arguments and results
    are those of :func:`bounce_mega_soa`.  ``medium_count`` (a 0-d int64
    tensor, or None) gains, in place, the live lanes whose event is a
    scatter in a medium (its candidate nearer than the surface).  While
    the recorder records, the four stages run under the spans
    ``bounce.surface`` (the nearest hit and its uv), ``bounce.media``,
    ``bounce.shade`` (the shade kernel, the background, the radiance) and
    ``bounce.texture`` (the rich-texture multiply), and the multiply
    counts the lanes it evaluates (``bounce.texture_lanes``)."""
    tb = tables
    with profiling.span("bounce.surface"):
        # dead lanes carry stale rays: park them far outside the scene
        o = torch.where(alive, comps[0:3], 3e18)
        d = comps[3:6]
        hit = surface_hit(tb, o, d, comps[6])
    medium = None
    if tb.volumes is not None:
        with profiling.span("bounce.media"):
            medium = medium_hit(
                tb.volumes, (o[0], o[1], o[2], d[0], d[1], d[2], comps[6]),
                tb.t_min,
                uniforms[_N_BASE_U:_N_BASE_U + tb.volumes.n_volumes],
                tables=tb.vol_tables)
            if medium_count is not None:
                medium_count += (alive & (medium[0] < hit[0])).sum()
    with profiling.span("bounce.shade"):
        lanes = (o[0], o[1], o[2], d[0], d[1], d[2], thr[0], thr[1], thr[2],
                 alive.to(DTYPE))
        outs = shade_megakernel(tb.mtbl, tb.ttbl, hit, medium, lanes,
                                uniforms[:N_U], n_mats=tb.n_mats,
                                n_targets=tb.n_targets,
                                has_medium=medium is not None)
        new_comps = torch.stack(outs[0:6] + (comps[6],))
        thr_new = torch.stack(outs[6:9])
        alive_new = outs[12] > 0.5
        miss = outs[13] > 0.5
        bg = s.background(o.T, d.T).to(DTYPE).T
        rad_new = (rad + torch.where(miss, thr * bg, 0.0)
                   + torch.stack(outs[9:12]))
    if tb.rich:
        with profiling.span("bounce.texture"):
            thr_new = rich_albedo_multiply(scene, o, d, hit, thr_new,
                                           alive_new, medium)
    return new_comps, rad_new, thr_new, alive_new, alive & ~alive_new


def _eval_redirect_pdf(tg, point, direction):
    """The sum over the redirect targets ``tg = (prob, q, u, v)`` of each
    lane's pdf term ``t^2 / |cross(u, v) . dir|`` where the ray from
    ``point`` along ``direction`` ([R, 3]) hits the target parallelogram
    in ``(0, inf)``, else 0: the JAX package's ``_eval_redirect_pdf``."""
    prob, q, u, v = tg
    cp = vcross(u, v)
    cp_sq = torch.clamp(vdot0(cp, cp), min=1e-30)
    n_unit = cp * torch.rsqrt(cp_sq)[:, None]
    n_s = cp / cp_sq[:, None]
    w_a = vcross(v, n_s)
    w_b = vcross(n_s, u)
    denom = direction @ n_unit.T
    den_ok = torch.abs(denom) > 1e-8
    t = ((q * n_unit).sum(-1)[None, :] - point @ n_unit.T) / torch.where(
        den_ok, denom, 1.0)

    def p_rel_dot(w):
        return (point @ w.T - (q * w).sum(-1)[None, :]
                + t * (direction @ w.T))
    a = p_rel_dot(w_a)
    b = p_rel_dot(w_b)
    hit = (den_ok & (t > 0.0) & (0.0 <= a) & (a <= 1.0) & (0.0 <= b)
           & (b <= 1.0))
    cross_dot = torch.abs(direction @ cp.T)
    pdf_each = torch.where(hit, t * t / torch.clamp(cross_dot, min=1e-12),
                           0.0)
    return pdf_each @ prob


def _henyey_greenstein(g, mu):
    """The Henyey-Greenstein phase (times albedo times 4 pi, the
    reference's contract)."""
    g2 = g * g
    return (1.0 - g2) / torch.pow(
        torch.clamp(1.0 + g2 - 2.0 * g * mu, min=1e-12), 1.5)


@dataclasses.dataclass(frozen=True)
class GenericTables:
    """The generic bounce's tables for one scene and camera, built once
    per driver call from the detached scene: the split path's
    (:class:`SplitTables`: the nearest-hit kernels' table and BVH, the
    media's boundary tables), and for ``diff=True`` the statics of the
    differentiable surface hit and of the media's keyed crossings."""
    split: SplitTables
    hit: HitStatics | None = None
    crossings: CrossingStatics | None = None


def _generic_reason(scene: Scene, s: CameraSettings):
    """Why the generic bounce cannot take this scene, or None: it takes
    every scene of at most ``MAX_BVH_ROWS`` (2^24) primitive rows, the
    most kernel K9 indexes exactly."""
    rows = scene.prims.kind.shape[0]
    if rows > MAX_BVH_ROWS:
        return (f"{rows} primitive rows: the nearest-hit walk takes at most "
                f"{MAX_BVH_ROWS}")
    return None


def generic_tables(scene: Scene, s: CameraSettings,
                   diff: bool = False) -> GenericTables:
    """:class:`GenericTables` of ``scene`` (its tensors detached) and
    ``s``; raise for a scene the generic bounce does not take."""
    from ..diff.gradients import map_scene
    reason = _generic_reason(scene, s)
    if reason is not None:
        raise NotImplementedError(f"generic bounce: {reason}")
    with torch.no_grad():
        det = map_scene(lambda x: x.detach(), scene)
        tb = split_tables(det, s)
    if not diff:
        return GenericTables(split=tb)
    return GenericTables(
        split=tb, hit=hit_statics(tb, det.prims, tb.t_min),
        crossings=(None if det.volumes is None
                   else crossing_statics(det.volumes, tb.t_min)))


def surface_hit_diff(scene: Scene, tables: GenericTables, o, d, time):
    """The differentiable nearest surface hit of the rays ``o``, ``d`` [R,
    3] at ``time`` [R] (the JAX package's ``_surface_hit`` with
    ``diff=True``): the winner-only ``DiffSurfaceHit`` over the primitive
    table (``tables`` of :func:`generic_tables` with ``diff=True``), then
    the scene's ellipsoids merged in differentiable torch, so a
    primitive's cotangent is zero where an ellipsoid wins.  Returns ``(t,
    idx, normal, front, uv, mat)``."""
    hit = diff_surface_hit(tables.hit, scene.prims, o, d, time)
    if scene.ellipsoids is None:
        return hit
    return merge_ellipsoid_hits(scene.ellipsoids, o, d, time,
                                tables.split.t_min, *hit)


def bounce_generic_soa(scene: Scene, s: CameraSettings, comps, uniforms, rad,
                       thr, alive, tables: GenericTables,
                       diff: bool = False, medium_count=None):
    """One bounce of every lane through the generic bounce (the JAX
    package's ``bounce``), for every scene kernel A and the split path do
    not take and for the differentiable routes the fused step and kernel A
    do not take.  The arguments and results are those of
    :func:`bounce_mega_soa` (``uniforms`` [8 + V (+ more), R]).

    The surface hit comes from a nearest-hit kernel (K8's flat scan, or
    K9's BVH walk): with ``diff=True`` through the winner-only
    ``ops/diff_intersect.py:DiffSurfaceHit``.  Media: with ``diff=False``
    the nearest scatter candidate of kernel K11 or K11b in the candidate
    mode (``render/volumes.py:medium_hit``; dead lanes are parked far
    outside the scene first); with ``diff=True`` every medium's candidate
    from the keyed crossings (``render/volumes.py:volume_candidates_diff``)
    folded in medium order, and the score-function weight ``exp(logp -
    sg(logp))`` (value exactly 1) that carries the density's gradient.
    The shading is plain torch: the background, the medium's overrides,
    emission, the specular family, the diffuse family with any number of
    redirect targets, the Lommel-Seeliger and Henyey-Greenstein factors;
    the sampled direction and the mixture pdf are detached.  Textures are
    evaluated here (marble stripes through K12 with ``diff=False``, in
    differentiable torch with ``diff=True``).  ``medium_count`` as
    :func:`bounce_split_soa`'s."""
    dev = comps.device
    r = comps.shape[1]
    tb = tables
    d = comps[3:6].T
    time = comps[6]
    throughput = thr.T
    n_t = s.n_redirect
    if not diff:
        # dead lanes carry stale rays: park them far outside the scene
        o_soa = torch.where(alive, comps[0:3], 3e18).contiguous()
        o = o_soa.T
        hit = surface_hit(tb.split, o_soa, comps[3:6].contiguous(), time)
        t_srf = hit[0]
        normal = torch.stack(hit[2:5], dim=-1)
        front = hit[5] > 0.5
        uv = torch.stack(hit[6:8], dim=-1)
        mat_id = hit[8].long()
    else:
        o = comps[0:3].T
        t_srf, _, normal, front, uv, mat_id = surface_hit_diff(
            scene, tb, o, d, time)

    vol = scene.volumes
    if vol is not None:
        nv = vol.n_volumes
        u_sc = uniforms[_N_BASE_U:_N_BASE_U + nv]
        if diff:
            t_vol, seg_entry, seg_exit, seg_has = volume_candidates_diff(
                vol, tb.crossings, o, d, time, u_sc)
            # the winner medium by a fold in medium order (strict <)
            t_med = torch.full((r,), math.inf, dtype=DTYPE, device=dev)
            vol_mat = torch.zeros((r,), dtype=torch.long, device=dev)
            vol_win = torch.full((r,), -1, dtype=torch.long, device=dev)
            for v in range(nv):
                better = t_vol[v] < t_med
                t_med = torch.where(better, t_vol[v], t_med)
                vol_mat = torch.where(better, vol.mat[v].long(), vol_mat)
                vol_win = torch.where(better, v, vol_win)
        else:
            t_med, vmat = medium_hit(
                tb.split.volumes, (o_soa[0], o_soa[1], o_soa[2],
                                   *comps[3:6].contiguous().unbind(0), time),
                tb.split.t_min, u_sc, tables=tb.split.vol_tables)
            vol_mat = vmat.long()
        in_medium = t_med < t_srf
        t_hit = torch.where(in_medium, t_med, t_srf)
        if medium_count is not None:
            medium_count += (alive & in_medium).sum()
        if diff:
            # the score-function density weight: per medium, log pdf of
            # scattering here (rho exp(-rho s)) or of passing through a
            # length L of it (exp(-rho L)); every length detached, so the
            # weight's gradient is d logp / d rho alone
            t_evt = torch.where(torch.isfinite(t_hit), t_hit,
                                3e18).detach()
            logp = torch.zeros((r,), dtype=DTYPE, device=dev)
            for v in range(nv):
                rho = vol.density[v]
                scat_v = in_medium & (vol_win == v) & alive
                entry_v = seg_entry[v].detach()
                exit_v = seg_exit[v].detach()
                has_v = seg_has[v] & alive
                # finite masked lengths: an infinite unselected branch
                # would still poison the backward (0 * inf)
                seg_len = torch.clamp(torch.minimum(t_evt, exit_v) - entry_v,
                                      min=0.0)
                seg_len = torch.where(has_v & torch.isfinite(seg_len),
                                      seg_len, 0.0)
                s_v = torch.clamp(t_med.detach() - entry_v, min=0.0)
                s_v = torch.where(scat_v & torch.isfinite(s_v), s_v, 0.0)
                lf = torch.where(
                    scat_v, torch.log(torch.clamp(rho, min=1e-20)) - rho * s_v,
                    torch.where(has_v, -rho * seg_len, 0.0))
                logp = logp + lf
            throughput = throughput * torch.exp(logp - logp.detach())[:, None]
    else:
        in_medium = torch.zeros((r,), dtype=torch.bool, device=dev)
        t_hit = t_srf

    hit_any = torch.isfinite(t_hit)
    # the background on a miss
    bg = s.background(o, d).to(DTYPE)
    miss = alive & ~hit_any
    radiance = rad.T + torch.where(miss[:, None], throughput * bg, 0.0)

    # the hit point; a medium event's normal faces the ray, its uv is 0
    t_safe = torch.where(hit_any, t_hit, 1.0)
    point = (o + t_safe[:, None] * d).contiguous()
    if vol is not None:
        med = in_medium[:, None]
        normal = torch.where(med, -d, normal)
        front = torch.where(in_medium, True, front)
        uv = torch.where(med, 0.0, uv)
        mat_id = torch.where(in_medium, vol_mat, mat_id)

    m = scene.materials
    kind = m.kind[mat_id]
    tex_id = m.tex[mat_id]
    param = take_rows(m.param, mat_id)
    albedo = eval_texture(scene.textures, tex_id, point, uv,
                          marble_kernel=not diff)
    live_hit = alive & hit_any

    # emission: only lights emit
    emitted = torch.where((kind == MAT_LIGHT)[:, None], albedo, 0.0)
    radiance = radiance + torch.where(live_hit[:, None],
                                      throughput * emitted, 0.0)

    is_absorb = (kind == MAT_LIGHT) | (kind == MAT_PITCH_BLACK)
    is_hemi = (kind == MAT_LAMBERTIAN) | (kind == MAT_LOMMEL)
    is_spec = ((kind == MAT_MIRROR) | (kind == MAT_METAL)
               | (kind == MAT_DIELECTRIC) | (kind == MAT_TRANSPARENT))

    # the specular family
    refl = reflect(normal, d)
    fuzz_u = rng.unit_vector_from_uniforms(uniforms[0], uniforms[1])
    metal_dir = refl + param[:, None] * fuzz_u
    metal_ok = vdot0(metal_dir, normal) > 0.0
    metal_dir = normalize(metal_dir)
    ior = torch.clamp(param, min=1e-6)
    ior_ratio = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(vdot0(normal, -d), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ior_ratio * sin_t > 1.0
    r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * torch.pow(1.0 - cos_t, 5.0)
    di_reflect = cannot | (uniforms[2] < schlick)
    di_dir = torch.where(di_reflect[:, None], refl,
                         refract(ior_ratio, cos_t, normal, d))
    spec_dir = torch.where((kind == MAT_MIRROR)[:, None], refl, d)
    spec_dir = torch.where((kind == MAT_METAL)[:, None], metal_dir, spec_dir)
    spec_dir = torch.where((kind == MAT_DIELECTRIC)[:, None], di_dir,
                           spec_dir)
    spec_att = torch.where((kind == MAT_DIELECTRIC)[:, None],
                           torch.ones_like(albedo), albedo)
    spec_dead = (kind == MAT_METAL) & ~metal_ok

    # the diffuse family with redirection
    unit_u = rng.unit_vector_from_uniforms(uniforms[3], uniforms[4])
    cos_dir = normalize(normal + unit_u)
    base_dir = torch.where(is_hemi[:, None], cos_dir, unit_u)
    if n_t:
        tg = tuple(x.to(dev) for x in (s.redirect_prob, s.redirect_q,
                                       s.redirect_u, s.redirect_v))
        prob, q, tu, tv = tg
        rem_prob = 1.0 - torch.sum(prob)
        cdf = torch.cumsum(prob, 0)
        # the first target whose cumulative probability exceeds the draw;
        # none: the base sample
        t_sel = torch.sum((uniforms[5][:, None] >= cdf[None, :])
                          .to(torch.int32), 1)
        use_target = t_sel < n_t
        ti = torch.clamp(t_sel, max=n_t - 1).long()
        light_pt = (q[ti] + uniforms[6][:, None] * tu[ti]
                    + uniforms[7][:, None] * tv[ti])
        tgt_dir = normalize(light_pt - point)
        diff_dir = torch.where(use_target[:, None], tgt_dir, base_dir)
    else:
        diff_dir = base_dir
    diff_dir = diff_dir.detach()
    mu1 = vdot0(diff_dir, normal)
    pdf_base = torch.where(is_hemi, mu1 / math.pi, 0.25 / math.pi)
    hemi_dead = is_hemi & (pdf_base <= 0.0)
    pdf_mix = (rem_prob * pdf_base + _eval_redirect_pdf(tg, point, diff_dir)
               if n_t else pdf_base)
    # the sampling density is detached; the BRDF's numerator is not
    pdf_mix = torch.clamp(pdf_mix, min=1e-12).detach()
    mu0 = -vdot0(d, normal)
    lommel = 0.25 / torch.clamp(mu0 + mu1, min=1e-8)
    hg = _henyey_greenstein(param, vdot0(d, diff_dir))
    brdf = torch.ones((r,), dtype=DTYPE, device=dev)
    brdf = torch.where(kind == MAT_LOMMEL, lommel, brdf)
    brdf = torch.where(kind == MAT_ANISOTROPIC, hg, brdf)
    diff_w = albedo * (brdf * pdf_base / pdf_mix)[:, None]

    new_dir = torch.where(is_spec[:, None], spec_dir, diff_dir)
    weight = torch.where(is_spec[:, None], spec_att, diff_w)
    next_alive = live_hit & ~is_absorb & ~spec_dead & ~hemi_dead
    na = next_alive[:, None]
    throughput = torch.where(na, throughput * weight, throughput)
    o_new = torch.where(na, point, o)
    d_new = torch.where(na, new_dir, d)
    comps2 = torch.cat([o_new.T, d_new.T, time[None]])
    return comps2, radiance.T, throughput.T, next_alive, alive & ~next_alive


def bounce_route(scene: Scene, s: CameraSettings, n_rays: int) -> str:
    """The forward drivers' bounce for this scene: ``"kernel-A"``
    (:func:`bounce_mega_soa`); for every scene kernel A refuses (tables
    over 512 rows, rich textures, more behaviours than it stages, media,
    ellipsoids, the BVH mode) ``"split"`` (:func:`bounce_split_soa`); for
    every scene the split path refuses too (lights with rich textures,
    more than 24 materials or 8 redirect targets) ``"generic"``
    (:func:`bounce_generic_soa` with ``diff=False``), as the JAX
    package's drivers fall back to ``bounce``.  Raise if none takes the
    scene."""
    if _ineligible_reason(scene, s, n_rays) is None:
        return "kernel-A"
    if _split_ineligible_reason(scene, s, n_rays) is None:
        return "split"
    reason = _generic_reason(scene, s)
    if reason is not None:
        raise NotImplementedError(f"render: {reason}")
    return "generic"


def _bounce_step(scene: Scene, s: CameraSettings, n_rays: int):
    """``(bounce, tables)`` of :func:`bounce_route`'s route, with its
    tables packed once."""
    route = bounce_route(scene, s, n_rays)
    if route == "kernel-A":
        return bounce_mega_soa, bounce_tables(scene, s)
    if route == "split":
        return bounce_split_soa, split_tables(scene, s)
    return bounce_generic_soa, generic_tables(scene, s)


def _init_comps(lanes: int, device):
    comps = torch.zeros((7, lanes), dtype=DTYPE, device=device)
    comps[5] = 1.0      # dummy unit direction (0, 0, 1)
    return comps


def _segments(with_stats: bool, device):
    """A forward driver's count of path segments: a 0-d int64 tensor on
    the device with ``with_stats`` (the JAX package's int32 wraps past
    2^31 segments, which demo1's 1200 x 675 x 500 spp render approaches),
    else None."""
    if not with_stats:
        return None
    return torch.zeros((), dtype=torch.int64, device=device)


def _stats(acc, with_stats: bool, iters: int, segments, lanes: int):
    """A forward driver's result: ``acc``, or with ``with_stats`` ``(acc,
    dict(iterations, segments, lanes))`` as the JAX package's drivers
    return it: the loop's turns (a host int), the sum over turns of the
    lanes alive or dying in that turn (the 0-d int64 tensor of
    :func:`_segments`) and the lane pool.  ``segments / (iterations *
    lanes)`` is the wavefront occupancy (``utils/profiling.py:
    RenderStats``)."""
    if not with_stats:
        return acc
    return acc, dict(iterations=iters, segments=segments, lanes=lanes)


def _turns(go):
    """A forward driver's loop: yields once a turn while ``go()``, the
    host's read of the loop condition, is true.  The read runs under the
    span ``driver.wait`` (the host blocked until the card has drained
    the last turn), each turn's body under ``driver.iteration`` (the
    enqueue of its kernels and glue)."""
    while True:
        with profiling.span("driver.wait"):
            if not go():
                return
        with profiling.span("driver.iteration"):
            yield


def trace_wavefront(scene: Scene, s: CameraSettings, base_key, n_pix: int,
                    spp: int, n_lanes: int, acc=None, sample_offset: int = 0,
                    with_stats: bool = False):
    """Work-queue wavefront: ``n_pix * spp`` paths on a pool of
    ``n_lanes`` lanes, dead lanes refilled every iteration.  Work item
    ``w`` is (pixel ``w % n_pix``, sample ``w // n_pix``).  Returns the
    [n_pix, 3] radiance *sum* over samples (plus ``acc``); with
    ``with_stats`` also :func:`_stats`' dict."""
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
    iters, segments = 0, _segments(with_stats, dev)

    for _ in _turns(lambda: bool((next_w < total_work) | alive.any())):
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
        if with_stats:
            iters += 1
            segments += (alive | died).sum()
    return _stats(acc + acc3.T, with_stats, iters, segments, lanes)


def _rotation(spp: int, rotate_k: int) -> int:
    """The stationary driver's pixel rotation: ``rotate_k`` where it is
    over 1 and divides ``spp``, else 1."""
    return rotate_k if (rotate_k > 1 and spp % rotate_k == 0) else 1


def rotation_stride(lanes: int, k_rot: int) -> int:
    """The rotation's stride over ``lanes`` lanes: a multiple of 32 x 128
    lanes near ``lanes / k_rot``; small pools where that degenerates use
    plain ``lanes / k_rot``."""
    blk = 32 * LANE_ALIGN
    stride = max((lanes // k_rot) // blk * blk, blk)
    if k_rot > 1 and stride % lanes == 0:
        stride = max(lanes // k_rot, 1)
    return stride


def stationary_fused(scene: Scene, s: CameraSettings, n_pix: int) -> bool:
    """Does :func:`trace_wavefront_stationary` over ``n_pix`` pixels fuse
    its iteration (kernel B, in its rotated mode where the pixels
    rotate)?  Where ``fused_iter_eligible``; else it takes
    :func:`bounce_route`."""
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    return fused_iter_eligible(scene, s, lanes)


def trace_wavefront_stationary(scene: Scene, s: CameraSettings, base_key,
                               n_pix: int, spp: int, acc=None,
                               sample_offset: int = 0,
                               rotate_k: int = 1, pixel_offset: int = 0,
                               with_stats: bool = False):
    """Pixel-stationary wavefront: lane ``l`` owns pixel ``pixel_offset +
    l`` and traces its ``spp`` samples in turn.  ``rotate_k > 1`` (a
    divisor of ``spp``) rotates each lane through ``k`` pixels — lane
    ``l`` serves lane slot ``(l + c*stride) % lanes`` for samples in
    chunk ``c = sample // (spp/k)`` — so per-lane work averages the
    path-length variance of ``k`` pixels.  The fused branch (kernel B)
    adds each turn's contributions into ``k`` planes in place, in the
    launch (kernel B's rotated mode), summed once after the loop; the
    other lands them back in place through ``k`` masked rolls a turn.
    Returns the [n_pix, 3] radiance sum (plus
    ``acc``); with ``with_stats`` also :func:`_stats`' dict (the fused
    branch counts the lanes alive or dying after kernel B's step, the
    other the lanes alive or dying after Russian roulette); for a scene
    with media the other branch adds ``medium_segments`` to it and, while
    the recorder records, the counter ``driver.medium_segments``, as the
    sorted driver does."""
    dev = scene.device
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    k_rot = _rotation(spp, rotate_k)
    spp_k = spp // k_rot
    n_u = n_bounce_uniforms(scene)
    cam = camera_table(s, camera_frame(s))
    if acc is None:
        acc = torch.zeros((n_pix, 3), dtype=DTYPE, device=dev)
    base_key = base_key.to(dev)
    last_sample = sample_offset + spp - 1

    stride = rotation_stride(lanes, k_rot)

    lane_ids = torch.arange(lanes, dtype=torch.int32, device=dev)
    base_pixel = pixel_offset + torch.clamp(lane_ids, max=n_pix - 1)
    if k_rot == 1:
        # padding lanes (>= n_pix) start exhausted
        sample = torch.where(lane_ids < n_pix, sample_offset - 1,
                             last_sample + 1).to(torch.int32)
    else:
        # every lane works; padding slots' contributions land at slots
        # >= n_pix and are dropped at the end
        sample = torch.full((lanes,), sample_offset - 1, dtype=torch.int32,
                            device=dev)

    # the segments that scatter in a medium (kernel B takes no media)
    medium = None
    # the forward's fused branch takes kernel A's tables (at most 512
    # rows, the JAX package's forward cap); larger tables take the split
    # bounce below
    if stationary_fused(scene, s, n_pix):
        # the whole body is kernel B (+ the accumulation add unrotated)
        rot = None if k_rot == 1 else Rotation(
            k_rot, spp_k, stride, sample_offset, pixel_offset, n_pix,
            torch.zeros((k_rot, 3, lanes), dtype=DTYPE, device=dev))
        step = fused_iter_fwd_step(scene, s, base_key, spp, sample_offset,
                                   rotation=rot)
        comps = _init_comps(lanes, dev)
        z = torch.zeros((lanes,), dtype=DTYPE, device=dev)
        o = torch.ones((lanes,), dtype=DTYPE, device=dev)
        carry = ((sample, torch.zeros_like(sample), z)
                 + tuple(comps.unbind(0)) + (z, z, z) + (o, o, o))
        # unrotated, the host adds each turn's radiance: that keeps the
        # kRotate = false instantiation, ~10% faster a launch than the
        # rotated one with its planes
        acc3 = (torch.zeros((3, lanes), dtype=DTYPE, device=dev)
                if rot is None else None)
        iters, segments = 0, _segments(with_stats, dev)
        for _ in _turns(lambda: bool(
                ((carry[2] > 0.5) | (carry[0] < last_sample)).any())):
            carry, rad2, died_f = step(base_pixel, carry)
            if rot is None:
                acc3 += torch.stack(rad2) * died_f
            if with_stats:
                iters += 1
                segments += ((carry[2] > 0.5) | (died_f > 0.5)).sum()
        if rot is not None:
            acc3 = rot.planes.sum(0)
    else:
        maps = None if k_rot == 1 else [
            pixel_offset + torch.clamp((lane_ids + cc * stride) % lanes,
                                       max=n_pix - 1)
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
        iters, segments = 0, _segments(with_stats, dev)
        recording = profiling.recording()
        if scene.volumes is not None:
            medium = _segments(with_stats or recording, dev)

        for _ in _turns(lambda: bool((alive | (sample < last_sample)).any())):
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
                scene, s, comps, uniforms, rad, thr, alive, tables=tables,
                medium_count=medium)
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
            if with_stats:
                iters += 1
                segments += (alive | died).sum()
        if medium is not None and recording:
            profiling.count("driver.medium_segments", medium)
    out = _stats(acc + acc3[:, :n_pix].T, with_stats, iters, segments,
                 lanes)
    if with_stats and medium is not None:
        out[1]["medium_segments"] = medium
    return out


def trace_wavefront_sorted(scene: Scene, s: CameraSettings, base_key,
                           n_pix: int, spp: int, acc=None,
                           sample_offset: int = 0, pixel_offset: int = 0,
                           with_stats: bool = False):
    """Ray-binned work-queue wavefront over one lane per pixel (rounded
    up to 128): dead lanes pull the next work items from a global counter
    (item ``w`` is pixel ``pixel_offset + w % n_pix``, sample
    ``sample_offset + w // n_pix``), and every iteration the lanes are
    re-sorted by ``ops/sorted_turn.py:_sort_key`` with one stable
    argsort, so that the threads of a block trace rays that travel
    together (the BVH walks of the surface and of the media then visit
    the same nodes).  A turn is the argsort, HEAD (``sorted_head``: the
    lane state gathered through the permutation, the queue, the hash and
    the camera), the bounce, TAIL (``sorted_tail``: the depth cap,
    Russian roulette, the finished paths added into their pixels, the
    lane state and the next sort key) and the read of one flag; on the
    card HEAD and TAIL are one launch each.  Returns the [n_pix, 3]
    radiance sum (plus ``acc``): the same (pixel, sample) paths as the
    other drivers, so the same image up to the order of float adds.
    With ``with_stats`` also :func:`_stats`' dict and in it
    ``medium_segments``, the segments whose event was a scatter in a
    medium (a 0-d int64 tensor summed over the turns, as ``segments``);
    while the recorder records, the same count as the counter
    ``driver.medium_segments``.  The argsort runs under the span
    ``driver.rebin``.

    The JAX package's driver also enumerates work items in 8 x 128 pixel
    tiles, for its TPU kernels' block consensus; the port does not."""
    dev = scene.device
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    if acc is None:
        acc = torch.zeros((n_pix, 3), dtype=DTYPE, device=dev)
    total_work = n_pix * spp
    bounce_fn, tables = _bounce_step(scene, s, lanes)

    # the scene box of the surface rows, for the origin cells
    p = scene.prims
    nn = _n_scan_prims(p)
    ext = torch.abs(p.e1[:nn]) + torch.abs(p.e2[:nn])
    blo = (p.p0[:nn] - ext).amin(0)
    bhi = (p.p0[:nn] + ext).amax(0)
    binv = 1.0 / torch.clamp(bhi - blo, min=1e-6)
    turn = SortedTurn(s=s, cam=camera_table(s, camera_frame(s)),
                      base_key=base_key.to(dev),
                      box=torch.cat([blo, binv]).contiguous(), n_pix=n_pix,
                      lanes=lanes, total_work=total_work,
                      n_u=n_bounce_uniforms(scene),
                      sample_offset=sample_offset, pixel_offset=pixel_offset)

    acc3 = torch.zeros((3, n_pix), dtype=DTYPE, device=dev)
    st = sorted_lanes(lanes, total_work, dev)
    iters, segments = 0, _segments(with_stats, dev)
    recording = profiling.recording()
    medium = _segments(with_stats or recording, dev)
    for _ in _turns(st.more):
        with profiling.span("driver.rebin"):
            perm = torch.argsort(st.key, stable=True)
        par = iters % 2
        head = sorted_head(turn, perm, st, par)
        comps, rad, thr, uniforms, _, alive = head
        out = bounce_fn(scene, s, comps, uniforms, rad, thr, alive,
                        tables=tables, medium_count=medium)
        sorted_tail(turn, st, par, head, out, acc3, segments)
        iters += 1
    if recording:
        profiling.count("driver.medium_segments", medium)
    out = _stats(acc + acc3.T, with_stats, iters, segments, lanes)
    if with_stats:
        out[1]["medium_segments"] = medium
    return out


def _trace_wavefront_diff_fused(scene: Scene, s: CameraSettings, base_key,
                                pixel_ids, spp: int, n_iters: int,
                                sample_offset: int, schedule):
    """The fused differentiable driver: ``n_iters`` iterations of the
    differentiable step on every lane, then the completion schedule.
    Each run of iterations (the ``n_iters`` and each phase) goes through
    ``fused_iter.fused_loop``: one autograd node, or a one-turn node a
    turn for a scene with rich textures, whose albedo multiply runs
    between the turns.  There is no host sync inside the loops.  The
    whole forward runs under the span ``diff.forward``, each iteration
    (kernel B and its accumulation adds) under ``diff.fwd_iter``; while
    the recorder records, the counters ``diff.iterations``,
    ``diff.lane_iterations`` and ``diff.segments`` (the lanes alive or
    dying after kernel B's step, as the stationary driver's fused branch
    counts them)."""
    from ..diff.fused_iter import fused_loop
    dev = scene.device
    lanes = pixel_ids.shape[0]
    last_sample = sample_offset + spp - 1
    loop = fused_loop(scene, s, base_key.to(dev), spp, sample_offset)

    def init_carry(w):
        z = torch.zeros((w,), dtype=DTYPE, device=dev)
        o = torch.ones((w,), dtype=DTYPE, device=dev)
        zi = torch.zeros((w,), dtype=torch.int32, device=dev)
        return ((torch.full((w,), sample_offset - 1, dtype=torch.int32,
                            device=dev), zi, z)
                + (z, z, z, z, z, o, z) + (z, z, z) + (o, o, o))

    counting = profiling.recording()

    def run(pix, carry, n):
        # each turn's alive flags after the step, kept (the backward
        # saves them as the next turn's input) and reduced once
        alive = [] if counting else None
        acc, done, carry = loop(pix, carry, n, alive)
        if alive:
            # a lane traces a segment in a turn when it is alive after
            # the step or dies in it, never both: the turns alive plus
            # the samples done
            profiling.count("diff.iterations", n)
            profiling.count("diff.lane_iterations", n * pix.shape[0])
            profiling.count("diff.segments",
                            (torch.stack(alive) > 0.5).sum() + done.sum())
        return acc, done, carry

    pix = pixel_ids.to(device=dev, dtype=torch.int32)
    with profiling.span("diff.forward"):
        acc, done, carry = run(pix, init_carry(lanes), n_iters)
        if schedule:
            # compact the unfinished lanes (stable: JAX's argsort is) and
            # run each phase there; its sums land back in the lanes' slots
            slot = torch.arange(lanes, device=dev)
            for it_b, w_b in schedule:
                smp_c, _, al_c = carry[0:3]
                unfinished = (al_c > 0.5) | (smp_c < last_sample)
                sel = torch.argsort((~unfinished).to(torch.int32),
                                    stable=True)[:w_b]
                slot = slot[sel]
                pix = pix[sel]
                acc_b, done_b, carry = run(
                    pix, tuple(c[sel] for c in carry), it_b)
                acc = acc.index_add(1, slot, acc_b)
                done = done.index_add(0, slot, done_b)
    # [R, 3] in memory, as the loss's reduction has always read it
    mean = acc.T.contiguous() / torch.clamp(done, min=1)[:, None]
    return mean, done


def _antithetic_maps(cost, k: int):
    """``k`` lane -> slot permutations with about equal per-lane total
    cost (the JAX package's ``_antithetic_maps``): the slots ranked by
    ``cost`` ascending (a stable sort, as JAX's, so equal costs keep their
    order), lane ``l`` serves ranks ``l, N-1-l, l+S, N-1-l-S, ...`` in the
    ``k`` chunks (``S = N // k``).  Each map is a permutation of the
    slots, so the estimator is the unbalanced one re-ordered.  Requires
    an even ``k``."""
    lanes = cost.shape[0]
    srt = torch.argsort(cost, stable=True)
    l = torch.arange(lanes, device=cost.device)
    maps = []
    for cc in range(k):
        shift = (cc // 2) * (lanes // k)
        if cc % 2 == 0:
            r = (l + shift) % lanes
        else:
            r = (lanes - 1 - l - shift) % lanes
        maps.append(srt[r])
    return maps


@torch.no_grad()
def lane_cost_estimate(scene: Scene, s: CameraSettings, base_key, pixel_ids,
                       spp_est: int = 4, sample_offset: int = 1 << 20):
    """Forward per-lane cost signal for the cost-balanced assignment (the
    JAX package's ``lane_cost_estimate``): the bounce iterations that
    ``spp_est`` samples of each lane's pixel take, from the regenerating
    stationary loop on a sample range disjoint from any render (kernel A
    where it takes the scene, the split bounce elsewhere).  The loop
    condition is read on the host once per iteration.  Returns [P] f32."""
    dev = scene.device
    pix = pixel_ids.to(device=dev, dtype=torch.int32)
    lanes = pix.shape[0]
    n_u = n_bounce_uniforms(scene)
    cam = camera_table(s, camera_frame(s))
    base_key = base_key.to(dev)
    last = sample_offset + spp_est - 1
    bounce_fn, tables = _bounce_step(scene, s, lanes)
    cnt = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    comps = _init_comps(lanes, dev)
    rad = torch.zeros((3, lanes), dtype=DTYPE, device=dev)
    thr = torch.ones((3, lanes), dtype=DTYPE, device=dev)
    alive = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    sample = torch.full((lanes,), sample_offset - 1, dtype=torch.int32,
                        device=dev)
    depth = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    while bool((alive | (sample < last)).any()):
        can = ~alive & (sample < last)
        sample = torch.where(can, sample + 1, sample)
        depth = torch.where(can, 0, depth)
        alive = alive | can
        keys = rng.ray_keys_fast(base_key, pix, sample)
        uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), n_u + 6)
        new_comps = rays_from_table(cam, s.image_width, pix,
                                    uniforms[n_u:n_u + 5])
        comps = torch.where(can, new_comps, comps)
        rad = torch.where(can, 0.0, rad)
        thr = torch.where(can, 1.0, thr)
        comps, rad, thr, alive, died = bounce_fn(
            scene, s, comps, uniforms, rad, thr, alive, tables=tables)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[n_u + 5], depth, thr, alive, died)
        cnt = cnt + (alive | died).to(torch.int32)
    return cnt.to(DTYPE)


def _trace_wavefront_diff_unfused(scene: Scene, s: CameraSettings, base_key,
                                  pixel_ids, spp: int, n_iters: int,
                                  sample_offset: int, remat: bool,
                                  rotate_k: int, pixel_cost, schedule,
                                  generic: bool = False):
    """The unfused differentiable driver (the JAX package's scan body of
    ``trace_wavefront_diff``): ``n_iters`` iterations of torch glue
    (regeneration, counter hash, camera, Russian roulette with a detached
    survival probability, the flush) around the differentiable bounce
    ``diff/mega_bounce.py:mega_bounce_diff_soa`` (kernel A forward, K7
    backward) or, with ``generic``, :func:`bounce_generic_soa` with
    ``diff=True``, then the completion schedule.

    ``rotate_k > 1`` (a divisor of ``spp``) rotates each lane through
    ``k`` pixels: by rolled pixel maps at JAX's stride, or with
    ``pixel_cost`` (and an even ``k``) by the cost-balanced antithetic
    maps.  Each chunk's contributions go to an accumulator of its own (a
    tuple, not an in-place [k, R] buffer), moved back to the lanes' slots
    once after the loop.  ``remat`` checkpoints each iteration (its
    forward runs again in the backward, kernel A included)."""
    from torch.utils.checkpoint import checkpoint

    from ..diff.mega_bounce import mega_bounce_diff_soa, mega_statics
    dev = scene.device
    pix = pixel_ids.to(device=dev, dtype=torch.int32)
    lanes = pix.shape[0]
    base_key = base_key.to(dev)
    k_rot = _rotation(spp, rotate_k)
    spp_k = spp // k_rot
    stride = rotation_stride(lanes, k_rot)
    balanced = pixel_cost is not None and k_rot > 1 and k_rot % 2 == 0
    if balanced:
        lane_maps = _antithetic_maps(pixel_cost.detach().to(dev), k_rot)
        pixel_maps = [pix[m] for m in lane_maps]
        inv_maps = [torch.argsort(m) for m in lane_maps]
    else:
        pixel_maps = [torch.roll(pix, -cc * stride) for cc in range(k_rot)]
    n_u = n_bounce_uniforms(scene)
    cam = camera_table(s, camera_frame(s))
    last_sample = sample_offset + spp - 1
    if generic:
        gt = generic_tables(scene, s, diff=True)
    else:
        st = mega_statics(scene, s)

    def make_step(pix_arr):
        def step(comps, rad, thr, alive, sample, depth, keys):
            can = ~alive & (sample < last_sample)
            can_f = torch.where(can, 1.0, 0.0)
            sample = torch.where(can, sample + 1, sample)
            lane_pixel = pix_arr if k_rot == 1 else rotated_pixel(sample)
            nk = rng.ray_keys_fast(base_key, lane_pixel, sample)
            keys = torch.where(can[:, None], nk, keys)
            rad = rad * (1.0 - can_f)
            thr = torch.where(can, 1.0, thr)
            depth = torch.where(can, 0, depth)
            alive = alive | can

            uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), n_u + 6)
            new_comps = rays_from_table(cam, s.image_width, lane_pixel,
                                        uniforms[n_u:n_u + 5])
            comps = torch.where(can, new_comps, comps)
            if generic:
                comps, rad, thr, alive, died = bounce_generic_soa(
                    scene, s, comps, uniforms, rad, thr, alive, tables=gt,
                    diff=True)
            else:
                comps, contrib, thr, alive, died = mega_bounce_diff_soa(
                    scene, s, comps, uniforms, thr, alive, statics=st)
                rad = rad + contrib
            depth = depth + 1
            capped = alive & (depth >= s.max_depth)
            died = died | capped
            alive = alive & ~capped
            if s.rr_depth is not None:
                thr, alive, died = _russian_roulette(
                    s, uniforms[n_u + 5], depth, thr, alive, died)
            return comps, rad, thr, alive, sample, depth, keys, died

        if not remat:
            return step
        # the flush stays outside the checkpoint, so the accumulators are
        # not among the tensors each iteration keeps for its replay
        return lambda *lane: checkpoint(step, *lane, use_reentrant=False,
                                        preserve_rng_state=False)

    def rot_chunk(sample):
        return torch.clamp(torch.div(sample - sample_offset, spp_k,
                                     rounding_mode="floor"), 0, k_rot - 1)

    def rotated_pixel(sample):
        rot_c = rot_chunk(sample)
        lane_pixel = pixel_maps[0]
        for cc in range(1, k_rot):
            lane_pixel = torch.where(rot_c == cc, pixel_maps[cc], lane_pixel)
        return lane_pixel

    def flush(acc, done, rad, sample, died):
        died_f = torch.where(died, 1.0, 0.0)
        if k_rot == 1:
            return (acc[0] + rad * died_f,), (done[0] + died.to(torch.int32),)
        # lane l's chunk-c contribution belongs to slot (l + c * stride) %
        # lanes (or to the chunk map's slot)
        rot_c = rot_chunk(sample)
        acc, done = list(acc), list(done)
        for cc in range(k_rot):
            m = died_f * torch.where(rot_c == cc, 1.0, 0.0)
            acc[cc] = acc[cc] + rad * m
            done[cc] = done[cc] + m.to(torch.int32)
        return tuple(acc), tuple(done)

    def zeros_acc(w):
        return (tuple(torch.zeros((3, w), dtype=DTYPE, device=dev)
                      for _ in range(k_rot)),
                tuple(torch.zeros((w,), dtype=torch.int32, device=dev)
                      for _ in range(k_rot)))

    def run(pix_arr, acc, done, lane, n):
        step = make_step(pix_arr)
        for _ in range(n):
            *lane, died = step(*lane)
            acc, done = flush(acc, done, lane[1], lane[4], died)
        return acc, done, tuple(lane)

    zi = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    lane = (_init_comps(lanes, dev),
            torch.zeros((3, lanes), dtype=DTYPE, device=dev),
            torch.ones((3, lanes), dtype=DTYPE, device=dev),
            torch.zeros((lanes,), dtype=torch.bool, device=dev),
            torch.full((lanes,), sample_offset - 1, dtype=torch.int32,
                       device=dev),
            zi, rng.ray_keys_fast(base_key, zi, zi))
    acc, done, lane = run(pix, *zeros_acc(lanes), lane, n_iters)

    if schedule:
        # k_rot == 1: compact the unfinished lanes (stable) and run each
        # phase there; its sums land back in the lanes' slots
        slot = torch.arange(lanes, device=dev)
        for it_b, w_b in schedule:
            comps, rad, thr, alive, sample, depth, keys = lane
            unfinished = alive | (sample < last_sample)
            sel = torch.argsort((~unfinished).to(torch.int32),
                                stable=True)[:w_b]
            slot = slot[sel]
            lane = (comps[:, sel], rad[:, sel], thr[:, sel], alive[sel],
                    sample[sel], depth[sel], keys[sel])
            acc_b, done_b, lane = run(pix[slot], *zeros_acc(w_b), lane, it_b)
            acc = (acc[0].index_add(1, slot, acc_b[0]),)
            done = (done[0].index_add(0, slot, done_b[0]),)

    if balanced:
        # chunk cc's contribution to slot p came from lane inv_maps[cc][p]
        acc = sum(a[:, inv] for a, inv in zip(acc, inv_maps))
        done = sum(d[inv] for d, inv in zip(done, inv_maps))
    elif k_rot > 1:
        acc = sum(torch.roll(a, cc * stride, dims=1)
                  for cc, a in enumerate(acc))
        done = sum(torch.roll(d, cc * stride) for cc, d in enumerate(done))
    else:
        acc, done = acc[0], done[0]
    mean = acc.T / torch.clamp(done, min=1)[:, None]
    return mean, done


def trace_wavefront_diff(scene: Scene, s: CameraSettings, base_key,
                         pixel_ids, spp: int, n_iters: int | None = None,
                         sample_offset: int = 0, remat: bool = True,
                         use_mega: bool | None = None, rotate_k: int = 1,
                         skip_done: bool = False, skip_chunk: int = 16,
                         pixel_cost=None, schedule: tuple | None = None):
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
    the single-phase one.  It requires ``rotate_k == 1`` and no
    ``skip_done``.

    Routing, in the JAX package's order: the fused step
    (``diff/fused_iter.py``: kernel B forward, K5 backward) when
    ``rotate_k == 1``, no ``skip_done``, no ``pixel_cost``, ``use_mega``
    not False and :func:`fused_diff_reason` takes the scene; otherwise the
    unfused driver, over ``mega_bounce_diff_soa`` (kernel A forward, K7
    backward) when kernel A takes the scene and ``use_mega`` is not
    False, else over the generic differentiable bounce
    (:func:`bounce_generic_soa` with ``diff=True``: ``use_mega=False``,
    rich textures, media, tables of more than 512 rows off the fused
    step).

    ``remat``: the fused step saves only its carries, the winner index
    and the RR scale, and K5 replays the lane, so it changes nothing
    there; the unfused driver checkpoints each iteration.
    ``skip_done`` is accepted and runs exactly ``n_iters`` iterations, so
    it changes nothing (the JAX package's flag skips chunks of
    ``skip_chunk`` iterations once every lane is done, a no-op on the
    estimator)."""
    if n_iters is None:
        n_iters = 6 * spp + s.max_depth
    lanes = pixel_ids.shape[0]
    if lanes % LANE_ALIGN:
        raise ValueError(f"trace_wavefront_diff: {lanes} lanes is not a "
                         f"multiple of {LANE_ALIGN}")
    route = diff_route(scene, s, lanes, rotate_k=rotate_k,
                       skip_done=skip_done, pixel_cost=pixel_cost,
                       use_mega=use_mega)
    if route == "fused":
        return _trace_wavefront_diff_fused(scene, s, base_key, pixel_ids, spp,
                                           n_iters, sample_offset, schedule)
    if schedule and (rotate_k > 1 and spp % rotate_k == 0 or skip_done):
        raise ValueError("schedule requires rotate_k=1, skip_done=False")
    return _trace_wavefront_diff_unfused(
        scene, s, base_key, pixel_ids, spp, n_iters, sample_offset, remat,
        rotate_k, pixel_cost, schedule, route == "generic")


def diff_route(scene: Scene, s: CameraSettings, lanes: int, *,
               rotate_k: int = 1, skip_done: bool = False, pixel_cost=None,
               use_mega: bool | None = None) -> str:
    """:func:`trace_wavefront_diff`'s route: ``"fused"`` (kernel B
    forward, K5 backward), ``"kernel-A"`` (the unfused driver over kernel
    A forward and K7 backward) or ``"generic"`` (the unfused driver over
    the generic differentiable bounce)."""
    from ..diff.fused_iter import fused_diff_reason
    if (rotate_k == 1 and not skip_done and pixel_cost is None
            and use_mega is not False and fused_diff_reason(scene, s) is None):
        return "fused"
    if use_mega is False or _ineligible_reason(scene, s, lanes) is not None:
        return "generic"
    return "kernel-A"


def trace(scene: Scene, s: CameraSettings, o, d, time, keys,
          differentiable: bool = False):
    """Trace a fixed batch of rays (``o``, ``d`` [R, 3], ``time`` [R], one
    key [R, 2] each) to completion: radiance [R, 3] (the JAX package's
    ``trace``).  Each bounce draws ``n_bounce_uniforms + 1`` columns of
    ``mix_depth(keys, depth)``, the last for Russian roulette.

    The forward loops to ``max_depth``, stopping once no lane is alive (a
    host read each bounce), through the forward drivers' bounce
    (:func:`_bounce_step`: kernel A, the split path or the generic
    bounce).  ``differentiable=True`` runs a fixed ``max_depth`` bounces
    of the generic bounce with ``diff=True``, each under
    ``torch.utils.checkpoint`` (its forward, kernels included, runs again
    in the backward), the survival probability detached."""
    from torch.utils.checkpoint import checkpoint
    dev = scene.device
    r = o.shape[0]
    n_u = n_bounce_uniforms(scene)
    comps = torch.cat([o.T, d.T, time[None]]).to(dev)
    rad = torch.zeros((3, r), dtype=DTYPE, device=dev)
    thr = torch.ones((3, r), dtype=DTYPE, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    keys = keys.to(dev)
    if differentiable:
        tables = generic_tables(scene, s, diff=True)
        bounce_fn = functools.partial(bounce_generic_soa, diff=True)
    else:
        bounce_fn, tables = _bounce_step(scene, s, r)

    def body(depth, comps, rad, thr, alive):
        uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), n_u + 1)
        comps, rad, thr, alive, died = bounce_fn(
            scene, s, comps, uniforms, rad, thr, alive, tables=tables)
        if s.rr_depth is not None:
            thr, alive, _ = _russian_roulette(s, uniforms[n_u], depth + 1,
                                              thr, alive, died)
        return comps, rad, thr, alive

    for depth in range(s.max_depth):
        if differentiable:
            comps, rad, thr, alive = checkpoint(
                body, depth, comps, rad, thr, alive, use_reentrant=False,
                preserve_rng_state=False)
        else:
            if not bool(alive.any()):
                break
            comps, rad, thr, alive = body(depth, comps, rad, thr, alive)
    return rad.T
