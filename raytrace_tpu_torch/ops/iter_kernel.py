"""Kernel B: one whole wavefront iteration per lane
(``raytrace_tpu/ops/pallas/iter_kernel.py``: ``iter_megakernel``).

Regeneration of idle lanes, the counter-hash RNG (bit-identical to
``core/rng.py``), the thin-lens camera, the bounce of kernel A, the
constant/sky/gray background on a miss, the depth cap, Russian roulette
and the death bookkeeping.  The caller only adds the dead lanes' radiance
into the image.

:func:`iter_megakernel` launches ``csrc/iter_kernel.cu`` for CUDA
tensors and runs :func:`iter_plain`, the same function in plain PyTorch,
for CPU tensors.  The pixel (i, j) is decoded with integer ``%`` and
``//``, exact for every pixel index (the TPU kernel's f32 decode is exact
below 2^24, so the two agree).

Tables of 512 < rows <= 65,536 that are kind-segmented take the mesh
variant (``iter_kernel.py:_iter_mega_ap``, :func:`resolve_use_ap`): the
same iteration, whose intersect stage walks the table's BVH
(:func:`iter_mega_ap`, ``rt_iter_bvh``); its plain version is
:func:`iter_plain` with ``use_ap=True``, whose intersect stage is the
all-pairs sweep of ``ops/allpairs_kernel.py``.

:func:`prepare_iter` checks the tables of one driver call once, decides
whether the kernel's planar instantiation serves them (as kernel A's
:func:`~.bounce_kernel.prepare_bounce` does) and prebuilds the table part
of the argument struct (:class:`IterLaunch`); a driver passes it to every
launch as ``prepared=``.

:class:`Rotation` selects the rotated mode (``rotation=``, flat scan
only): the stationary driver's pixel rotation, each lane's pixel drawn
from its sample and each dying lane's radiance added, in the launch, to
the rotation's accumulation planes.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core import rng
from ..render.camera import camera_table, rays_from_table
from .allpairs_kernel import check_bvh, nearest_hit_plain
from .bounce_kernel import (
    N_U, check_lanes, check_tables, planar_only, shade_values,
)
from .intersect_kernel import MAX_DENSE_PRIMS, MAX_SMEM_PRIMS, prim_loop_plain

# backgrounds the kernel evaluates in-kernel (render/camera.py)
BG_CONST = 0
BG_SKY = 1
BG_GRAY = 2

N_CAM = 24          # cam table columns (f32)
N_KT = 4            # kt table columns (i32)
N_LANE_IN = 17      # pix smp dep al + comps(7) + rad(3) + thr(3)
_N_OUT_F = 17       # f32 outputs (+2 with uv); smp/dep go to an i32 buffer


def resolve_use_ap(n_prims: int, segments) -> bool:
    """Does the iteration take the mesh variant?  Kind-segmented tables of
    512 < rows <= 65,536, as the JAX package decides."""
    return segments is not None and MAX_SMEM_PRIMS < n_prims \
        <= MAX_DENSE_PRIMS


def pack_cam(s, frame, bg_color) -> torch.Tensor:
    """[24] f32 table of the kernel's camera/RR/background stage: the
    camera values of ``render/camera.py:camera_table``, rr_min, the
    background color, zero padding."""
    vals = (camera_table(s, frame) + [s.rr_min]
            + [float(c) for c in np.asarray(bg_color, np.float32)])
    return torch.tensor(vals + [0.0] * (N_CAM - len(vals)),
                        dtype=torch.float32)


def pack_kt(base_key: torch.Tensor, last_sample: int) -> torch.Tensor:
    """[4] i32 table: the two key words and the last sample index."""
    k = base_key.to(torch.int32).cpu()
    return torch.tensor([int(k[0]), int(k[1]), int(last_sample), 0],
                        dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class Rotation:
    """Kernel B's rotated mode: the stationary driver's pixel rotation
    (``render/integrator.py:trace_wavefront_stationary``).  Lane ``l``
    tracing sample ``smp`` serves slot ``(l + c * stride) % R``, ``c =
    clamp((smp - sample_offset) // spp_k, 0, k_rot - 1)``, whose pixel is
    ``pixel_offset + min(slot, n_pix - 1)``; a dying lane adds its
    radiance to ``planes[c, :, slot]``, in place.  ``planes`` is the
    [k_rot, 3, R] f32 accumulator; a slot has one lane a plane, so the
    adds need no atomics, and the image is ``planes.sum(0)``."""
    k_rot: int
    spp_k: int
    stride: int
    sample_offset: int
    pixel_offset: int
    n_pix: int
    planes: torch.Tensor

    def slots(self, smp):
        """``(c, slot)`` of every lane tracing sample ``smp`` (int64)."""
        r = smp.shape[0]
        c = torch.clamp(torch.div(smp - self.sample_offset, self.spp_k,
                                  rounding_mode="floor"),
                        0, self.k_rot - 1).long()
        lane = torch.arange(r, dtype=torch.int64, device=smp.device)
        return c, (lane + c * self.stride) % r


def iter_plain(ptbl, mtbl, ttbl, cam, kt, lane_in, *, n_prims: int,
               n_mats: int, n_targets: int, t_min: float, has_motion: bool,
               use_prim_albedo: bool, n_u: int, rr_depth, max_depth: int,
               width: int, bg_kind: int, with_uv: bool = False,
               use_ap: bool = False, bvh=None, prepared=None,
               rotation: Rotation | None = None):
    """Kernel B in plain PyTorch: the same inputs and outputs as
    :func:`iter_megakernel`, on any device.  ``use_ap`` takes the
    all-pairs intersect stage of the mesh variant (``bvh`` and
    ``prepared`` are accepted so that both take the same arguments, and
    unused); ``rotation`` the rotated mode."""
    (pix, smp, dep, al, ox, oy, oz, dx, dy, dz, tm,
     rr, rg, rb, tr, tg, tb) = lane_in
    c = cam.tolist()
    last_sample = int(kt[2])

    # regeneration of idle lanes with samples left
    alv = al > 0.5
    can = ~alv & (smp < last_sample)
    can_f = torch.where(can, 1.0, 0.0)
    smp2 = torch.where(can, smp + 1, smp)
    dep_pre = torch.where(can, 0, dep)
    alive_pre = alv | can
    if rotation is not None:
        rot_c, slot = rotation.slots(smp2)
        pix = (rotation.pixel_offset
               + torch.clamp(slot, max=rotation.n_pix - 1)).to(torch.int32)

    keys = rng.mix_depth(rng.ray_keys_fast(kt[:2].to(pix.device), pix, smp2),
                         dep_pre)
    us = rng.uniform_cols(keys, n_u + 6)

    # thin-lens camera for the regenerated lanes
    new = rays_from_table(c, width, pix, us[n_u:n_u + 5])
    oxv, oyv, ozv, dxv, dyv, dzv, tmv = (
        torch.where(can, n, x)
        for n, x in zip(new, (ox, oy, oz, dx, dy, dz, tm)))
    rad = [x * (1.0 - can_f) for x in (rr, rg, rb)]
    thr = [torch.where(can, 1.0, x) for x in (tr, tg, tb)]

    # dead lanes are parked far outside the scene
    far = 3e18
    box = torch.where(alive_pre, oxv, far)
    boy = torch.where(alive_pre, oyv, far)
    boz = torch.where(alive_pre, ozv, far)

    nearest = nearest_hit_plain if use_ap else prim_loop_plain
    hit = nearest(ptbl, box, boy, boz, dxv, dyv, dzv, tmv, n_prims=n_prims,
                  t_min=t_min, has_motion=has_motion,
                  with_albedo=use_prim_albedo)
    sh = shade_values(hit, mtbl, ttbl, box, boy, boz, dxv, dyv, dzv, *thr,
                      alive_pre, us[:N_U], n_mats=n_mats,
                      n_targets=n_targets, use_prim_albedo=use_prim_albedo,
                      with_uv=with_uv)
    (o2x, o2y, o2z, d2x, d2y, d2z, t2r, t2g, t2b,
     emr, emg, emb, na_f, miss_f, bi) = sh[:15]

    if bg_kind == BG_SKY:
        a_sky = 0.5 * (dyv + 1.0)
        bg = ((1.0 - a_sky) + a_sky * 0.5, (1.0 - a_sky) + a_sky * 0.7,
              (1.0 - a_sky) + a_sky * 1.0)
    elif bg_kind == BG_GRAY:
        t_g = (dyv + 1.0) * 0.5
        bg = (t_g, t_g, t_g)
    else:
        bg = (c[20], c[21], c[22])
    rad2 = [rad[k] + e + miss_f * thr[k] * bg[k]
            for k, e in enumerate((emr, emg, emb))]

    # depth cap + Russian roulette
    dep2 = dep_pre + 1
    alive_b = na_f > 0.5
    capped = alive_b & (dep2 >= max_depth)
    died = (alive_pre & ~alive_b) | capped
    alive2 = alive_b & ~capped
    if rr_depth is not None:
        thr_max = torch.maximum(t2r, torch.maximum(t2g, t2b))
        p_srv = torch.clamp(thr_max, min=c[19], max=1.0)
        do_rr = dep2 >= int(rr_depth)
        kill = do_rr & (us[n_u + 5] >= p_srv)
        scale = torch.where(do_rr & ~kill, 1.0 / p_srv, 1.0)
        t2r = t2r * scale
        t2g = t2g * scale
        t2b = t2b * scale
        died = died | (alive2 & kill)
        alive2 = alive2 & ~kill
    else:
        scale = torch.ones_like(t2r)

    if rotation is not None:
        # each lane's own (plane, slot) address: unique, so a plain add
        r = pix.shape[0]
        at = ((rot_c * 3 * r + slot)[None, :]
              + torch.arange(3, device=slot.device)[:, None] * r)
        flat = rotation.planes.view(-1)
        flat[at] += torch.where(died, torch.stack(rad2), 0.0)

    out = (o2x, o2y, o2z, d2x, d2y, d2z, tmv, *rad2, t2r, t2g, t2b,
           torch.where(alive2, 1.0, 0.0), smp2, dep2,
           torch.where(died, 1.0, 0.0), bi, scale)
    return out + tuple(sh[15:17]) if with_uv else out


class _IterArgs(ctypes.Structure):
    """Mirror of ``IterArgs`` in csrc/iter_kernel.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "ptbl", "mtbl", "ttbl", "cam", "kt", "pix", "smp", "dep", "al",
        "ox", "oy", "oz", "dx", "dy", "dz", "tm", "rr", "rg", "rb", "tr",
        "tg", "tb", "outf", "outi", "nodes", "rows")]
        + [("n_lanes", ctypes.c_int64)]
        + [(f, ctypes.c_int) for f in (
            "n_prims", "n_mats", "n_targets", "has_motion",
            "use_prim_albedo", "n_u", "rr_depth", "max_depth", "width",
            "bg_kind", "with_uv", "n_nodes", "tri_only", "planar")]
        + [("t_min", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in (
            "k_rot", "spp_k", "stride", "sample_offset", "pixel_offset",
            "n_pix")]
        + [("acc", ctypes.c_void_p)])


_LANE_NAMES = ("pix", "smp", "dep", "al", "ox", "oy", "oz", "dx", "dy", "dz",
               "tm", "rr", "rg", "rb", "tr", "tg", "tb")


@dataclasses.dataclass(frozen=True)
class IterLaunch:
    """Kernel B's tables for one driver call, checked once by
    :func:`prepare_iter`: the five tables ``(ptbl, mtbl, ttbl, cam, kt)``,
    the kernel's keyword parameters, the mesh variant's BVH (None for the
    flat scan), whether the planar instantiation serves the tables, and
    the argument struct with its table part filled in (the lanes are
    filled per launch)."""
    tables: tuple
    kw: dict
    bvh: object
    planar: bool
    args: _IterArgs


def _check_tables(tables, bvh, kw, dev) -> None:
    """Raise unless kernel B (``bvh`` None) or its mesh variant takes the
    tables ``(ptbl, mtbl, ttbl, cam, kt)`` and parameters ``kw`` on
    ``dev`` (the uniform count is checked at each launch)."""
    ptbl, mtbl, ttbl, cam, kt = tables
    check_tables(ptbl, mtbl, ttbl, kw["n_prims"], kw["n_mats"],
                 kw["n_targets"], dev,
                 max_prims=MAX_SMEM_PRIMS if bvh is None else MAX_DENSE_PRIMS)
    if bvh is not None:
        check_bvh(bvh, kw["n_prims"], dev)
    check_lanes([("cam", cam)], N_CAM, dev)
    check_lanes([("kt", kt)], N_KT, dev, torch.int32)


def _make_table_args(tables, bvh, kw, planar: bool) -> _IterArgs:
    """Kernel B's argument struct with the table part filled in."""
    ptbl, mtbl, ttbl, cam, kt = tables
    rr_depth = kw["rr_depth"]
    return _IterArgs(
        ptbl=ptbl.data_ptr(), mtbl=mtbl.data_ptr(), ttbl=ttbl.data_ptr(),
        cam=cam.data_ptr(), kt=kt.data_ptr(),
        nodes=None if bvh is None else bvh.nodes.data_ptr(),
        rows=None if bvh is None else bvh.rows.data_ptr(),
        n_prims=kw["n_prims"], n_mats=kw["n_mats"],
        n_targets=kw["n_targets"], has_motion=int(kw["has_motion"]),
        use_prim_albedo=int(kw["use_prim_albedo"]), n_u=kw["n_u"],
        rr_depth=-1 if rr_depth is None else int(rr_depth),
        max_depth=kw["max_depth"], width=kw["width"],
        bg_kind=kw["bg_kind"], with_uv=int(kw["with_uv"]),
        n_nodes=0 if bvh is None else bvh.n_nodes,
        tri_only=int(bvh is not None and bvh.tri_only), planar=int(planar),
        t_min=float(kw["t_min"]))


def prepare_iter(ptbl, mtbl, ttbl, cam, kt, *, n_prims: int, n_mats: int,
                 n_targets: int, t_min: float, has_motion: bool,
                 use_prim_albedo: bool, n_u: int, rr_depth, max_depth: int,
                 width: int, bg_kind: int, with_uv: bool = False,
                 use_ap: bool = False, bvh=None) -> IterLaunch:
    """Check kernel B's tables (as :func:`iter_megakernel` does without
    them), decide whether its planar instantiation serves them
    (:func:`~.bounce_kernel.planar_only`: one host synchronisation) and
    prebuild its argument struct's table part."""
    kw = dict(n_prims=n_prims, n_mats=n_mats, n_targets=n_targets,
              t_min=t_min, has_motion=has_motion,
              use_prim_albedo=use_prim_albedo, n_u=n_u, rr_depth=rr_depth,
              max_depth=max_depth, width=width, bg_kind=bg_kind,
              with_uv=with_uv)
    tables = (ptbl, mtbl, ttbl, cam, kt)
    bvh = bvh if use_ap else None
    if use_ap and bvh is None:
        raise ValueError("prepare_iter: the mesh variant needs the table's "
                         "BVH (pack_bvh)")
    _check_tables(tables, bvh, kw, ptbl.device)
    planar = not use_ap and planar_only(ptbl, n_prims, has_motion)
    return IterLaunch(tables=tables, kw=kw, bvh=bvh, planar=planar,
                      args=_make_table_args(tables, bvh, kw, planar))


def table_args(tables, bvh, kw, prepared: IterLaunch | None) -> _IterArgs:
    """The table part of kernel B's argument struct for ``tables``, the
    mesh variant's ``bvh`` (or None) and the parameters ``kw``: that of
    ``prepared``, which must have been made for them, or (``prepared``
    None) that of the general instantiation after checking the tables."""
    if prepared is None:
        _check_tables(tables, bvh, kw, tables[0].device)
        return _make_table_args(tables, bvh, kw, False)
    if (any(a is not b for a, b in zip(prepared.tables, tables))
            or prepared.kw != kw or prepared.bvh is not bvh):
        raise ValueError("iter_megakernel: the prepared tables are not the "
                         "ones given")
    return prepared.args


def lane_args(table_part: _IterArgs, lane_in, outf, outi) -> _IterArgs:
    """A copy of ``table_part`` with the lane part filled in: the 17 lane
    tensors and the two outputs, for tensors that outlive it."""
    args = _IterArgs.from_buffer_copy(table_part)
    (args.pix, args.smp, args.dep, args.al, args.ox, args.oy, args.oz,
     args.dx, args.dy, args.dz, args.tm, args.rr, args.rg, args.rb, args.tr,
     args.tg, args.tb, args.outf, args.outi) = (
        x.data_ptr() for x in tuple(lane_in) + (outf, outi))
    args.n_lanes = outi.shape[1]
    return args


def _rotation_args(args: _IterArgs, rot: Rotation, r: int, dev) -> None:
    """Fill the rotated mode's part of ``args`` for ``r`` lanes."""
    p = rot.planes
    if rot.k_rot < 2 or rot.spp_k < 1 or not 0 < rot.n_pix <= r:
        raise ValueError(f"iter_megakernel: bad rotation {rot}")
    if (p.device != dev or p.dtype != torch.float32
            or tuple(p.shape) != (rot.k_rot, 3, r) or not p.is_contiguous()):
        raise ValueError(f"planes: need a contiguous float32 [{rot.k_rot}, "
                         f"3, {r}] tensor on {dev}")
    (args.k_rot, args.spp_k, args.stride, args.sample_offset,
     args.pixel_offset, args.n_pix) = (
        rot.k_rot, rot.spp_k, rot.stride, rot.sample_offset,
        rot.pixel_offset, rot.n_pix)
    args.acc = p.data_ptr()


def _launch_iter(entry, tables, lane_in, bvh, prepared, kw, rotation=None):
    """Check the lanes of kernel B (``entry`` rt_iter) or of its mesh
    variant (rt_iter_bvh, with ``bvh``) and launch it over
    :func:`table_args` (``rotation``: the rotated mode)."""
    dev = lane_in[0].device
    if dev.type != "cuda":
        raise ValueError(f"iter_megakernel: unsupported device {dev}")
    if len(lane_in) != N_LANE_IN:
        raise ValueError(f"lane_in: need {N_LANE_IN} lane tensors")
    if kw["n_u"] != N_U:
        raise ValueError(f"n_u={kw['n_u']}: the kernel draws {N_U} bounce "
                         "uniforms (media, whose columns follow, take the "
                         "generic bounce)")
    table_part = table_args(tables, bvh, kw, prepared)
    r = lane_in[0].shape[0]
    check_lanes(zip(_LANE_NAMES[:3], lane_in[:3]), r, dev, torch.int32)
    check_lanes(zip(_LANE_NAMES[3:], lane_in[3:]), r, dev)
    from ._build import launch
    # one allocation: the f32 rows, then the two i32 rows viewed as such
    n_f = _N_OUT_F + (2 if kw["with_uv"] else 0)
    buf = torch.empty((n_f + 2, r), dtype=torch.float32, device=dev)
    outf, outi = buf[:n_f], buf[n_f:].view(torch.int32)
    args = lane_args(table_part, lane_in, outf, outi)
    if rotation is not None:
        _rotation_args(args, rotation, r, dev)
    launch(entry, args, dev)
    f = outf.unbind(0)
    out = f[:14] + outi.unbind(0) + f[14:17]
    return out + f[17:19] if kw["with_uv"] else out


def iter_megakernel(ptbl, mtbl, ttbl, cam, kt, lane_in, *, n_prims: int,
                    n_mats: int, n_targets: int, t_min: float,
                    has_motion: bool, use_prim_albedo: bool, n_u: int,
                    rr_depth, max_depth: int, width: int, bg_kind: int,
                    with_uv: bool = False, use_ap: bool = False, bvh=None,
                    prepared: IterLaunch | None = None,
                    rotation: Rotation | None = None):
    """One wavefront iteration of every lane.  ``lane_in`` is 17 [R]
    tensors: pix, smp, dep (i32), al (0/1 f32), comps (7), rad (3),
    thr (3).  ``cam`` is the [24] f32 table of :func:`pack_cam`, ``kt``
    the [4] i32 table of :func:`pack_kt`.  Returns the 19 [R] outputs
    comps' (7), rad' (3), thr' (3), alive' (0/1), smp' (i32), dep' (i32),
    died (0/1), winner index (-1 on a miss), RR scale — with ``with_uv``
    also the winner's (u, v).  ``use_ap`` (:func:`resolve_use_ap`) takes
    the mesh variant, :func:`iter_mega_ap`, over the table's ``bvh``.
    ``prepared`` (:func:`prepare_iter` of these tables and parameters)
    skips the tables' checks and selects the planar instantiation where
    it serves them; without it the tables are checked and the general
    instantiation runs.  ``rotation`` (:class:`Rotation`, not with
    ``use_ap``) takes the rotated mode: the lanes' ``pix`` are not read,
    and the dying lanes' radiance is also added into its planes.

    CPU tensors run :func:`iter_plain`; CUDA tensors launch the kernel
    (``iter_megakernel.launches`` counts the launches of the flat-scan
    kernel, ``iter_megakernel.planar_launches`` those of its planar
    instantiation)."""
    kw = dict(n_prims=n_prims, n_mats=n_mats, n_targets=n_targets,
              t_min=t_min, has_motion=has_motion,
              use_prim_albedo=use_prim_albedo, n_u=n_u, rr_depth=rr_depth,
              max_depth=max_depth, width=width, bg_kind=bg_kind,
              with_uv=with_uv)
    if use_ap and rotation is not None:
        raise ValueError("iter_megakernel: the mesh variant does not rotate")
    if lane_in[0].device.type == "cpu":
        return iter_plain(ptbl, mtbl, ttbl, cam, kt, lane_in, use_ap=use_ap,
                          rotation=rotation, **kw)
    if use_ap:
        return iter_mega_ap(ptbl, mtbl, ttbl, cam, kt, lane_in, bvh=bvh,
                            prepared=prepared, **kw)
    out = _launch_iter("rt_iter", (ptbl, mtbl, ttbl, cam, kt), lane_in, None,
                       prepared, kw, rotation)
    iter_megakernel.launches += 1
    if prepared is not None and prepared.planar:
        iter_megakernel.planar_launches += 1
    return out


iter_megakernel.launches = 0
iter_megakernel.planar_launches = 0


def next_carry(outs) -> tuple:
    """The 16 carries of the next iteration from :func:`iter_megakernel`'s
    outputs: smp', dep', alive', comps' (7), rad' (3), thr' (3), the
    order of ``lane_in`` after its ``pix``."""
    return (outs[14], outs[15], outs[13]) + tuple(outs[0:13])


def iter_mega_ap(ptbl, mtbl, ttbl, cam, kt, lane_in, *, bvh,
                 prepared: IterLaunch | None = None, **kw):
    """The mesh variant of :func:`iter_megakernel` on CUDA tensors
    (``iter_kernel.py:_iter_mega_ap``): the intersect stage walks ``bvh``
    over the table in global memory (``rt_iter_bvh``;
    ``iter_mega_ap.launches`` counts the launches).  CPU tensors run
    :func:`iter_plain` with ``use_ap=True``."""
    if lane_in[0].device.type == "cpu":
        return iter_plain(ptbl, mtbl, ttbl, cam, kt, lane_in, use_ap=True,
                          **kw)
    if bvh is None:
        raise ValueError("iter_mega_ap: needs the table's BVH (pack_bvh)")
    out = _launch_iter("rt_iter_bvh", (ptbl, mtbl, ttbl, cam, kt), lane_in,
                       bvh, prepared, kw)
    iter_mega_ap.launches += 1
    return out


iter_mega_ap.launches = 0
