"""Top-level render driver (``raytrace_tpu/render/render.py``).

:func:`render_accumulate` splits the image into row-aligned bands and the
samples into chunks, and hands each to a wavefront driver: the
pixel-stationary one for bands of 16384 pixels and more, the work queue
otherwise.  Samples keep their absolute (pixel, sample) coordinates, so
the image does not depend on how the work is cut (nor on the lane ->
pixel map, so the JAX package's tile-ordered maps are not needed).
Stationary renders of tables of ``SORT_MIN_PRIMS`` rows and more, and of
scenes whose media have ``BCAST_MIN_ROWS`` boundary rows and more, take
the ray-sorted work-queue driver instead, as in the JAX package (scenes
of the BVH accelerator mode stay on the stationary driver).
"""
from __future__ import annotations

import functools

import torch

from ..core import rng
from ..core.vecmath import DTYPE
from ..scene.types import Scene
from ..utils import profiling
from .camera import CameraSettings
from .integrator import (
    stationary_fused, trace_wavefront, trace_wavefront_sorted,
    trace_wavefront_stationary,
)
from .volumes import uses_bcast

# below this many pixels the stationary scheduler cannot fill its lanes
_STATIONARY_MIN_PIXELS = 16384
# from this many rows the JAX package renders with the sorted driver
SORT_MIN_PRIMS = 8192


def rotate_k_for(n_s: int) -> int:
    """Pixel rotation of the stationary driver: the largest divisor of the
    chunk's sample count up to 8 (1 if there is none)."""
    for k in range(8, 1, -1):
        if n_s % k == 0:
            return k
    return 1


def uses_sorted(scene: Scene) -> bool:
    """Does a stationary render of this scene take the sorted driver?
    The JAX package's rule: a surface table of ``SORT_MIN_PRIMS`` rows
    and more, or media whose boundary takes kernel K11b (``BCAST_MIN_ROWS``
    rows and more), unless the scene is in the BVH accelerator mode."""
    return scene.bvh is None and (
        scene.prims.kind.shape[0] >= SORT_MIN_PRIMS
        or (scene.volumes is not None and uses_bcast(scene.volumes)))


def forward_driver(scene: Scene, band_pix: int) -> str:
    """:func:`render_accumulate`'s driver of a band of ``band_pix``
    pixels: ``"queue"`` below ``_STATIONARY_MIN_PIXELS``, else
    ``"sorted"`` where :func:`uses_sorted`, else ``"stationary"``."""
    if band_pix < _STATIONARY_MIN_PIXELS:
        return "queue"
    return "sorted" if uses_sorted(scene) else "stationary"


def default_spp_chunk(driver: str, spp: int, n_pix: int,
                      n_lanes: int) -> int:
    """:func:`render_accumulate`'s samples per driver launch when the
    caller sets none."""
    if driver != "queue":
        # one launch: the drain tail is paid once per launch
        return min(spp, 512)
    # each launch ends in a low-occupancy tail; queue >= ~32 lane-fills
    # to amortize it
    return max(1, min(spp, -(-32 * n_lanes // max(n_pix, 1))))


def queue_lanes(n_pix: int, n_s: int, n_lanes: int = 1 << 17) -> int:
    """The lane pool of :func:`render_accumulate`'s work-queue launch of
    ``n_s`` samples over ``n_pix`` pixels: its paths, up to ``n_lanes``
    (as the JAX package's; a pool that is not a multiple of 128 lanes
    takes the generic bounce)."""
    return min(n_lanes, n_pix * n_s)


def forward_route(scene: Scene, settings: CameraSettings,
                  n_pix: int | None = None) -> tuple[str, bool]:
    """``(driver, fused)`` of :func:`render_accumulate`'s launches over a
    band of ``n_pix`` pixels (the whole image by default):
    :func:`forward_driver`, and whether the stationary driver fuses their
    iteration (``integrator.py:stationary_fused``)."""
    if n_pix is None:
        n_pix = int(settings.image_width) * int(settings.image_height)
    driver = forward_driver(scene, n_pix)
    return driver, (driver == "stationary"
                    and stationary_fused(scene, settings, n_pix))


def _stationary_fn(scene: Scene, settings: CameraSettings, key, n_pix: int,
                   spp: int, sample_offset: int, rotate_k: int,
                   pixel_offset: int, with_stats: bool = False):
    """One band and sample chunk of a stationary render: the
    pixel-stationary driver, or the sorted driver where
    :func:`uses_sorted` (``rotate_k`` does not apply there);
    ``with_stats`` is the driver's."""
    if uses_sorted(scene):
        return trace_wavefront_sorted(
            scene, settings, key, n_pix, spp, sample_offset=sample_offset,
            pixel_offset=pixel_offset, with_stats=with_stats)
    return trace_wavefront_stationary(
        scene, settings, key, n_pix, spp, sample_offset=sample_offset,
        rotate_k=rotate_k, pixel_offset=pixel_offset, with_stats=with_stats)


def row_bands(h: int, w: int, max_band: int = 1 << 19) -> list:
    """``[(pixel offset, pixels)]``: the equal-row bands (but possibly the
    last) that bound a stationary render's lane state, for images over
    ``max_band`` pixels; one band otherwise."""
    n_bands = -(-(h * w) // max_band) if h * w > max_band >= w else 1
    band_rows = -(-h // n_bands)
    return [(r0 * w, min(band_rows, h - r0) * w)
            for r0 in range(0, h, band_rows)]


def forward_launches(scene: Scene, settings: CameraSettings, key, spp: int,
                     n_lanes: int = 1 << 17, spp_chunk: int | None = None,
                     spp_done: int = 0, max_band: int = 1 << 19):
    """:func:`render_accumulate`'s driver launches, in order: ``(samples
    done, pixel offset, pixels, samples, launch)``.  ``launch(**kw)``
    calls the band's driver on its chunk of samples (``kw``: the
    drivers' ``with_stats``) and returns the radiance sum over the band's
    pixels, under the span ``render.launch``; "samples done" counts the
    chunks up to this one."""
    h, w = settings.image_height, settings.image_width
    n_pix = h * w
    bands = row_bands(h, w, max_band)
    driver = forward_driver(scene, bands[0][1])
    if spp_chunk is None:
        spp_chunk = default_spp_chunk(driver, spp, n_pix, n_lanes)
    spanned = profiling.spanned("render.launch")
    for done in range(0, spp, spp_chunk):
        n_s = min(spp_chunk, spp - done)
        s0 = spp_done + done
        if driver == "queue":
            yield done + n_s, 0, n_pix, n_s, spanned(functools.partial(
                trace_wavefront, scene, settings, key, n_pix, n_s,
                queue_lanes(n_pix, n_s, n_lanes), sample_offset=s0))
            continue
        for off, bp in bands:
            yield done + n_s, off, bp, n_s, spanned(functools.partial(
                _stationary_fn, scene, settings, key, bp, n_s, s0,
                rotate_k_for(n_s), off))


@profiling.spanned("render.accumulate")
def render_accumulate(scene: Scene, settings: CameraSettings, seed: int = 0,
                      *, spp: int | None = None, n_lanes: int = 1 << 17,
                      spp_chunk: int | None = None, acc=None,
                      spp_done: int = 0, progress: bool = False,
                      max_band: int = 1 << 19):
    """Accumulate radiance sums for ``spp`` samples per pixel on the
    scene's device.  Returns ``(acc, spp_total)``: ``acc[n_pix, 3]`` is
    the radiance *sum* and ``acc / spp_total`` the image.  Pass a previous
    ``(acc, spp_done)`` to resume.  ``spp_chunk`` bounds the samples per
    driver launch; images over ``max_band`` pixels render in row bands
    (:func:`forward_launches`).  A call runs under the span
    ``render.accumulate`` (``utils/profiling.py``)."""
    dev = scene.device
    n_pix = settings.image_height * settings.image_width
    spp = spp if spp is not None else settings.samples_per_pixel
    acc = (torch.zeros((n_pix, 3), dtype=DTYPE, device=dev) if acc is None
           else acc.clone())
    for done, off, bp, _, launch in forward_launches(
            scene, settings, rng.base_key(seed, dev), spp, n_lanes,
            spp_chunk, spp_done, max_band):
        acc[off:off + bp] += launch()
        if progress and off + bp == n_pix:
            print(f"\r  spp {done}/{spp}", end="", flush=True)
    if progress:
        print()
    return acc, spp_done + spp


def render(scene: Scene, settings: CameraSettings, seed: int = 0, *,
           spp: int | None = None, n_lanes: int = 1 << 17,
           spp_chunk: int | None = None, progress: bool = False):
    """Render an [H, W, 3] linear-RGB image on the scene's device."""
    spp = spp if spp is not None else settings.samples_per_pixel
    acc, total = render_accumulate(
        scene, settings, seed, spp=spp, n_lanes=n_lanes,
        spp_chunk=spp_chunk, progress=progress)
    return (acc / total).reshape(settings.image_height,
                                 settings.image_width, 3)
