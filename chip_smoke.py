"""Drive the PyTorch/CUDA port's render paths once on one GPU: the
forward render and the differentiable forward + backward (fused and
unfused), on the Cornell box, on a mesh of the Stanford bunny's size, on
rich-textured scenes and on scenes with constant-density media.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels of raytrace_tpu_torch/csrc with nvcc;
3. kernel A (bounce) against its plain PyTorch version on the card: the
   Cornell box at the main path's shapes (600 x 600 camera rays on
   360,064 lanes, then their second bounce), and Cornell and an
   all-materials scene, with and without redirect targets, on 2^16
   random lanes;
4. kernel B (iteration) against its plain version at the main path's
   shapes (360,064 lanes, width 600), exact and with Russian roulette:
   one iteration from a random lane state, then 30 from a fresh one;
5. the main path, ``render_accumulate`` on the Cornell box at 600 x 600,
   depth 50, at 64 spp (bench.py's 200 cut to keep the smoke short;
   ``profile_render.py`` times 200) — exact estimator and Russian
   roulette from depth 2 (stationary driver, rotate_k 8: kernel A);
6. the main path at spp 1 (rotate_k 1: the fused branch, kernel B); then
   the same path at 2 spp and 1 spp once more, with every kernel launch
   held against its plain version on the inputs the driver gave it;
7. each kernel's device time per launch (torch.profiler) and its
   wrapper's call back to back (CUDA events: the host's cost) beside its
   plain version's at the main path's 360,064 lanes;
8. the backward kernel K5 against its plain version (torch autograd over
   ``lane_math``) on 2^18 lanes of a real mid-render state (kernel B
   steps the fwd+bwd configuration four times; random cotangents): the
   Cornell box, the all-materials scene and the box/motion scene, with 0
   and 2 redirect targets, and 2^17 lanes of the bunny stand-in's fused
   mesh state; per state the per-lane mode lane by lane, then the
   reduced mode (rows read by index, row gradients summed in the launch:
   the mode every fwd+bwd runs, staged or global as its table's size
   picks) against its plain version and its per-lane mode;
9. ``render_loss_wavefront``'s value and gradient at 2^14 lanes, 8 spp,
   40 iterations, with K5 and with the backward forced to its plain
   version: equal losses, gradients within ``GRAD_RTOL``;
10. the second main path: the fwd+bwd of ``bench.py`` (Cornell 600 x
    600, depth 50, RR from depth 2, 2^18 lanes x 64 spp, 205 iterations
    then 25 at 2^14 and 100 at 2^12 lanes) after one warm-up run: wall,
    primary rays/s, loss, samples completed, launches of kernel B and of
    K5's reduced and per-lane modes (the per-lane one never), peak memory;
11. central finite differences of the loss on the card (2^14 lanes,
    exact estimator, same seed) for the light's emission and the red
    wall's albedo against their gradients;
12. K5's time at 2^18 lanes: the reduced mode's device time (its kernel
    and the two finishing launches) and host time, its plain version's,
    its bound, and the per-lane mode's device time alone and with the
    torch gather and ``index_add_`` it replaced; then phase 10's fwd+bwd
    with the per-lane backward and with the reduced one in turns (per
    lane, reduced, reduced, per lane): walls, peaks, device time per
    iteration, and the index ops inside the backward steps (none in the
    reduced runs).

The mesh scale (``testing.bunny_standin_scene``: 4,968 triangles in 4,992
rows, the bunny scene's material, camera, gray fade and depth 10):

13. the nearest-hit kernel (BVH walk) against its plain all-pairs version
    on every lane: 2^17 camera rays of the stand-in at 600 x 600 and their
    second bounce, the same on the mixed-kind mesh scene (still and with
    its extras moving), and 2^14 rays on a 50,000-triangle sphere; the
    BVH build times;
14. the shade kernel against its plain version on those hit records, with
    and without a synthetic medium;
15. kernel B's mesh variant against its plain version on 2^17 lanes of
    the stand-in, exact and with Russian roulette, one iteration from a
    random state and 10 from a fresh one;
16. route 1, the split forward: ``render_accumulate`` of the stand-in at
    600 x 600, depth 10, 16 spp, exact and with RR from depth 2 (the
    nearest and shade kernels once per iteration, kernel A never); then
    the same at 1 spp with every launch held against its plain version;
17. route 2, the mesh fwd+bwd of ``tools/prof_bunny_grad.py``
    (``testing.MESH_FWD_BWD``: 2^17 lanes x 16 spp, 30 iterations then
    12 at 2^15 and 30 at 2^13 lanes; 72 launches each of the mesh variant
    and the reduced K5, none of the per-lane one) after one warm-up; at 2^14 lanes the fwd+bwd with every
    kernel against the one with every plain version; a finite difference
    of the mesh's albedo;
18. the three mesh kernels' device and host times at the slice's shapes
    beside their plain versions' and their bounds (the BVH's operation count from the
    nodes and rows each ray visited, counted by the kernel).

Rich textures (image, noise, marble):

19. the flat-scan nearest kernel K8 and the marble kernel K12 against
    their plain versions on every lane of ``scenes/noise_test.py``'s
    90,112 camera lanes at 400 x 225 and their second bounce (the ball's
    hit points with their texture ids), both held to equality;
20. route 3, the rich forward: ``render_accumulate`` of noise_test at
    400 x 225, 100 spp, depth 50, seed 0 (the stationary driver, rotate_k
    5: K8, the shade kernel and K12 every iteration, kernels A and B
    never), written to chiprun_out/noise_test.png; then a 1 spp render
    with every launch held against its plain version;
21. route 4, ``tools/prof_texture_grad.py``'s image-textured fwd+bwd
    (2^17 lanes x 16 spp, 80 iterations, RR from depth 2; the atlas
    gradient K13 once per iteration but the last, whose multiply feeds no
    later radiance) after one warm-up; the same again with every K13
    launch held against its plain version; at 2^14 lanes the fwd+bwd with
    every kernel against the one with every plain version; a finite
    difference of an atlas texel;
22. the textured bunny stand-in's fwd+bwd (``tools/prof_bunny_tex.py``'s
    image on the stand-in, ``testing.MESH_FWD_BWD``);
23. K8's, K12's and K13's times at those shapes (device time per launch
    from torch.profiler: each is shorter than its wrapper's host cost,
    which back-to-back CUDA events would time; those are printed too)
    beside their plain versions', their bounds and, for K13,
    ``index_put_``'s.

Constant-density media (``testing.cornell_smoke_scene``: the Cornell box
with two smoke blocks of 6 boundary rows each; ``testing.pawn_standin_scene``:
a 1,200-triangle procedural pawn used as a glass shell and as the boundary
of a red medium):

24. the crossing kernels against their plain version on every lane: K11
    on cornell_smoke's 360,064 camera rays at 600 x 600 and their second
    bounce (which starts inside both smoke blocks), K11b on 2^17 camera
    rays of the pawn stand-in, their second bounce and 2^17 rays from
    inside its medium, and K11 on 2^16 random rays of
    ``tests/test_volume_kernel.py``'s fog ball and smoke box (a box row),
    still and moving; every line must say 0 differing lanes and max |err|
    0;
25. route 5, the media forward: ``render_accumulate`` of cornell_smoke at
    600 x 600, depth 50, seed 0, at ``FWD_SPP`` (the scene's 200 cut;
    ``profile_render.py`` times 200): the stationary driver at rotate_k 8,
    K8, K11 and the shade kernel every iteration, kernels A and B never;
    written to chiprun_out/cornell_smoke.png; then a 1 spp render with
    every launch held against its plain version;
26. route 6, the mesh-boundary medium: the pawn stand-in at 500 x 500,
    depth 20, ``PAWN_SPP`` (the scene's 400 cut) through the sorted
    driver (K9, K11b and the shade kernel every iteration), written to
    chiprun_out/pawn_standin.png; then a checked 128 x 128 render at 1
    spp;
27. phase 13's 50,000-triangle sphere through the sorted driver at 256 x
    256, 4 spp, depth 10 (a stationary render of 8,192 rows and more,
    which raised before the sorted driver);
28. K11's and K11b's times at those shapes beside their plain versions',
    their bounds (the rows and chunk boxes each ray of K11b tested,
    counted by the kernel) and their launches.

The unfused differentiable wavefront (``trace_wavefront_diff`` with
``rotate_k > 1`` or ``pixel_cost``: torch glue around kernel A forward and
the replay backward K7 in every iteration) and F8's media groups:

29. K7 against its plain version on 2^18 lanes of the unfused driver's
    mid-render states (``testing.k7_inputs``: kernel A steps the lanes
    four times), on phase 8's scenes and targets and a 384-row mixed-kind
    mesh (the global mode), within ``testing.BWD_RTOL``, then its reduced
    mode as K5's in phase 8;
30. route 8, ``tools/prof_diff_rot.py``'s configuration
    (``testing.FWD_BWD_ROT8``: bench.py's Cornell fwd+bwd at 2^18 lanes x
    64 spp with rotate_k 8, 195 iterations, no remat) after one warm-up:
    wall, primary rays/s, loss, samples completed, launches of kernel A
    and the reduced K7 (each once per iteration; the per-lane K7 never),
    peak memory;
31. route 9, ``tools/prof_completion.py``'s (``testing.FWD_BWD_BAL4``:
    rotate_k 4 balanced by ``lane_cost_estimate(spp_est=4)``, which runs
    inside the timed region, 184 iterations), printing the same; then
    route 8 with ``remat=True`` (each iteration checkpointed), its peak
    memory beside route 8's; then route 8 with the per-lane backward and
    the reduced one in turns, as phase 12 does phase 10;
32. at 2^14 lanes: the unfused fwd+bwd with K7 against the same with
    K7's plain version (equal losses, gradients within ``GRAD_RTOL``);
    rotate_k 2 against the fused rotate_k 1 where every sample completes
    (the loss within 1e-4, the gradients within ``GRAD_RTOL``, the lanes
    the two resolve differently counted); a central finite difference of
    the red wall's albedo through the unfused route;
33. scenes of 17 media (``testing.many_media_world``, 400 x 400, 4 spp:
    fog balls and boxes through K11, and rotated boxes, a 102-row
    boundary, through K11b) rendered with every crossing launch (two a
    bounce: 16 media, then 1) held against its plain version;
34. K7's times at 2^18 lanes, as K5's in phase 12.

Then a JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  The rendered images go to
chiprun_out/.  Tolerances (``raytrace_tpu_torch/testing.py``): exact rows
equal on every lane, floats within atol 2e-3 + rtol 1e-3 (the mesh
kernels, K8, K12, K11 and K11b, built like the plain versions'
arithmetic, are held to equality: a max |err| of 0); K5 within ``testing.BWD_RTOL`` of each
gradient's scale (the hand-derived adjoint sums the chain-rule terms in
another order than autograd); K13 within ``testing.image_grad_errs`` of
its plain version and of a float64 sum (float atomics add in a varying
order); the reduced K5 and K7: lane outputs equal to the per-lane mode's,
each table entry within ``n * 2^-23 * sum |g|`` of the float64 sum of
the per-lane mode's row gradients, and within that plus the per-lane
tolerances of the plain version's (``testing.compare_reduced``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
# fwd+bwd with K5 vs with its plain backward: per gradient leaf, the
# largest difference within GRAD_RTOL of the leaf's largest value (K5's
# per-lane differences, summed by atomic index_add_ in a run-dependent
# order)
GRAD_RTOL = 1e-3
# finite differences: relative tolerance (the loss is a polynomial in an
# emission or an albedo under the exact estimator; f32 rounding of the
# loss and the step's curvature are far below it)
FD_RTOL = 0.02
# samples per pixel of the forward main path (bench.py renders 200)
FWD_SPP = 64
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# samples per pixel of the mesh forward main path (scenes/bunny_test.py
# renders 100; profile_render.py times 100)
MESH_SPP = 16
# float operations of the BVH walk (csrc/bvh_nearest.cuh): a node's slab
# test and a triangle row's test, counted from the sources
NODE_OPS = 30
ROW_OPS = 45
# float operations of one marble lane (csrc/noise.cuh): 7 octaves of 8
# corners, each a hash, a sine and a cosine (some 20 operations each), a
# dot and a weight, counted from the source
MARBLE_OPS = 4600
# samples per pixel of the mesh-boundary medium's forward
# (scenes/pawn_test.py renders 400; profile_render.py times more)
PAWN_SPP = 16
# float operations of the crossing kernels (csrc/volume.cuh): a boundary
# row's roots (sphere, plane or box, ~40) and its two folds (~10 each),
# and one chunk-box test of K11b (~20), counted from the source
VOL_ROW_OPS = 60
VOL_BOX_OPS = 20


def _smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, kernel, reps: int) -> float:
    """Mean device time in ms of one call of ``fn``'s launches of
    ``kernel`` (a substring of a kernel's name, or a tuple of them: the
    means of each summed) over ``reps`` calls, read from torch.profiler:
    a kernel shorter than its wrapper's host cost leaves the card idle
    between back-to-back launches, so CUDA events around them would time
    the host instead.  The profiler's device trace can drop some events
    of a burst of microsecond launches (31 of 50 seen on an H100), so each
    mean is over the launches it recorded, at least one a name."""
    import torch
    from torch.autograd import DeviceType
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for name in names:
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if not 0 < len(us) <= reps:
            raise AssertionError(f"{name}: {len(us)} profiled launches of "
                                 f"{reps}")
        total += sum(us) / len(us) / 1e3
    return total


def _device_total_ms(fn, reps: int) -> float:
    """Device time in ms of all of one call's launches (``fn`` run
    ``reps`` times under torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


# the CPU ops that gather or scatter by an index, and the autograd nodes of
# the two backward kernels' steps
INDEX_OPS = ("aten::index_add_", "aten::index_add", "aten::index",
             "aten::index_select", "aten::gather", "aten::take",
             "aten::index_put_", "aten::scatter_add_")
BWD_NODES = ("_FusedIterBackward", "_MegaBounceBackward")


def _profile_fwd_bwd(fn, iters: int) -> dict:
    """One call of ``fn`` (a fwd+bwd of ``iters`` iterations) under
    torch.profiler: its device time per iteration in ms and the index ops
    run inside the backward steps of K5 and K7 (``{op name: count}``)."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = 0.0
    index_ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us += e.time_range.end - e.time_range.start
        elif e.name in INDEX_OPS:
            p = e.cpu_parent
            while p is not None and not any(n in p.name for n in BWD_NODES):
                p = p.cpu_parent
            if p is not None:
                index_ops[e.name] = index_ops.get(e.name, 0) + 1
    return dict(device_ms_per_iter=dev_us / 1e3 / iters,
                backward_index_ops=index_ops)


def _check(label: str, errs, lanes: int) -> float:
    """Print one kernel-vs-plain comparison, raise if it is out of
    tolerance, return its max abs error."""
    from raytrace_tpu_torch.testing import ATOL, RTOL
    n_int, err, excess = errs
    print(f"[{label}] {lanes} lanes: exact rows differ on {n_int} lanes, "
          f"max |err| {err:.3g} (atol {ATOL} rtol {RTOL}, worst excess "
          f"{excess:.3g})", flush=True)
    if n_int or excess > 0:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             "version")
    return err


def _check_reduced(label: str, args, kw, tables) -> float:
    """Print one reduced K5 or K7 against its plain version and its
    per-lane mode (``testing.compare_reduced``), raise if out of
    tolerance, return its max abs error."""
    import torch
    from raytrace_tpu_torch.ops.row_reduce import STAGED, row_mode
    from raytrace_tpu_torch.testing import compare_reduced
    r = compare_reduced(args, kw, tables)
    torch.cuda.synchronize()
    mode = ("staged" if row_mode(tables.n_prims, kw["n_row"]) == STAGED
            else "global")
    print(f"[{label}] {tables.n_prims} rows, {mode} mode: lane outputs max "
          f"|err| {r['lane_err']:.3g}, worst excess {r['lane_excess']:.3g} "
          f"(BWD_RTOL), {r['lane_differ']} differ from the per-lane mode's; "
          f"tables max |err| {r['rows_err']:.3g} against the float64 sum of "
          f"the per-lane mode's rows (worst excess {r['rows_excess']:.3g} "
          f"over n*2^-23*sum|g|), {r['plain_err']:.3g} against the plain "
          f"version's (worst excess {r['plain_excess']:.3g} over that plus "
          "the lanes' tolerances)", flush=True)
    if (not r["lane_excess"] <= 0.0 or r["lane_differ"]
            or not r["rows_excess"] <= 0.0 or not r["plain_excess"] <= 0.0):
        raise AssertionError(f"{label}: out of tolerance")
    return max(r["lane_err"], r["plain_err"])


def _row_mode_name(scene) -> str:
    """The row mode the reduced K5 and K7 take for ``scene``'s table."""
    from raytrace_tpu_torch.ops.row_reduce import STAGED, row_mode
    n_prims = scene.prims.kind.shape[0]
    mode = row_mode(n_prims, 15 if scene.prims.has_motion else 9)
    return f"{'staged' if mode == STAGED else 'global'} mode, {n_prims} rows"


def _bwd_bound(n_lanes: int, n_in: int, n_out: int, tables, n_row: int):
    """``_bound_ms`` of a reduced backward kernel: ``n_in`` lane columns
    read and ``n_out`` written, the table, the prims' material and texture
    rows read and the reduced tables written once; ~1000 float operations
    a lane (lane_math's replay and its reverse sweep)."""
    t = tables
    n_bytes = 4 * (n_lanes * (n_in + n_out) + t.cols.numel() + 2 * t.n_prims
                   + t.n_prims * n_row + t.n_mats + 6 * t.n_tex)
    return _bound_ms(n_bytes, n_lanes * 1000)


def _in_turns(label: str, run, iters: int, smi: str) -> dict:
    """The fwd+bwd ``run`` (``iters`` iterations) with the backward before
    the reduction moved into K5 and K7 (``testing.per_lane_backward``:
    their per-lane modes with torch's gather and ``index_add_`` around
    them) and with the reduced kernels, in turns: per lane, reduced,
    reduced, per lane.  Each turn prints the wall and peak memory of an
    unprofiled run, and the device time per iteration and the index ops
    run inside the backward steps from a profiled one.  Raises if the
    reduced backward runs an index op, or the per-lane one none."""
    import torch
    from raytrace_tpu_torch.testing import per_lane_backward
    out = {"per_lane": [], "reduced": []}
    for mode in ("per_lane", "reduced", "reduced", "per_lane"):
        with (per_lane_backward() if mode == "per_lane"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            prof = _profile_fwd_bwd(run, iters)
        out[mode].append(dict(wall_s=wall, peak_bytes=peak, **prof))
        print(f"[in turns] {label}, {'per-lane K5/K7 + torch gather and '
              'index_add_' if mode == 'per_lane' else 'reduced K5/K7'}: "
              f"wall {wall:.3f} s, peak {peak / 2**30:.3f} GiB, device "
              f"{prof['device_ms_per_iter']:.4f} ms an iteration, index ops "
              f"in the backward steps {prof['backward_index_ops']} [{smi}]",
              flush=True)
    if any(t["backward_index_ops"] for t in out["reduced"]) \
            or not all(t["backward_index_ops"] for t in out["per_lane"]):
        raise AssertionError(f"{label}: index ops in the reduced backward, "
                             "or none found in the per-lane one")
    return out


def _bound_ms(n_bytes: float, n_ops: float):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over the float32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (there is no CPU "
                           "fallback)")
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, bounce_plain,
    )
    from raytrace_tpu_torch.ops.iter_kernel import (
        iter_megakernel, iter_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import bounce_tables
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        ALL_MATERIAL_TARGETS, BWD_RTOL, FRAC_LANES, FWD_BWD, ITER_INT_ROWS,
        MEAN_RTOL, MESH_FWD_BWD, all_materials_scene, bounce_inputs,
        box_motion_scene, bunny_standin_scene, bwd_inputs, checked_launches,
        compare_bounce, compare_bwd, compare_iter, cornell_scene_and_settings,
        fresh_carry, fwd_bwd_pixels, max_errs, next_bounce_inputs,
        per_lane_backward, plain_backward, primary_bounce_inputs,
        reduced_args, stationary_lanes,
    )
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.materials.materials import MAT_LIGHT
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
        bounce_bwd_regen_pre_reduced_plain,
    )
    from raytrace_tpu_torch.ops.row_reduce import row_tables

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase_done(name):
        torch.cuda.synchronize()
        print(f"[elapsed] {name}: {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # 1. device
    smi = _smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    log = (_build.BUILD_DIR / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "bytes stack" in ln] \
        if log.exists() else ["(library was already built)"]
    print(f"[build] {build_s:.1f} s; ptxas: {' | '.join(ptxas)}", flush=True)

    phase_done("build")

    # 3. kernel A vs plain
    cornell, s_c = cornell_scene_and_settings(600, 200, 50, device=dev)
    n_pix, lanes, lane_pix = stationary_lanes(s_c)
    tb_c = bounce_tables(cornell, s_c)
    a_args = primary_bounce_inputs(cornell, s_c, 1)
    errs, out = compare_bounce(tb_c, a_args)
    err_a = _check("kernel A vs plain: cornell 600x600 primary rays", errs,
                   lanes)
    errs, _ = compare_bounce(tb_c, next_bounce_inputs(a_args, out, 1, 1))
    err_a = max(err_a, _check("kernel A vs plain: cornell 600x600 second "
                              "bounce", errs, lanes))
    allm = all_materials_scene(device=dev)
    s_a = rt.CameraSettings(background=rt.const_background([0.5, 0.6, 0.7]))
    s_at = s_a.with_redirect_targets(ALL_MATERIAL_TARGETS)
    n = 1 << 16
    for name, sc, s, box, seed in (
            ("cornell", cornell, s_c, (0.0, 555.0), 11),
            ("all-materials", allm, s_a, (-8.0, 8.0), 12),
            ("all-materials+targets", allm, s_at, (-8.0, 8.0), 13)):
        errs, _ = compare_bounce(bounce_tables(sc, s),
                                 bounce_inputs(sc, n, seed, box))
        err_a = max(err_a, _check(f"kernel A vs plain: {name} random rays",
                                  errs, n))

    phase_done("kernel A vs plain")

    # 4. kernel B vs plain at the main path's shapes
    err_b = 0.0
    for name, s, seed in (("exact", s_c, 21),
                          ("rr2", s_c.replace(rr_depth=2), 22)):
        one, frac, mean_rel = compare_iter(cornell, s, lanes, seed)
        err_b = max(err_b, _check(f"kernel B vs plain: cornell 600x600 "
                                  f"{name}, one iteration", one, lanes))
        print(f"[kernel B vs plain] cornell 600x600 {name}, 30 iterations: "
              f"{frac:.5f} of lanes differ by > 1e-5 (bound {FRAC_LANES}), "
              f"mean rel diff {mean_rel:.2e} (bound {MEAN_RTOL})",
              flush=True)
        if frac >= FRAC_LANES or mean_rel > MEAN_RTOL:
            raise AssertionError("kernel B disagrees with iter_plain over "
                                 "30 iterations")

    phase_done("kernel B vs plain")

    # 5./6. the main path
    bounce_megakernel.launches = 0
    iter_megakernel.launches = 0
    runs = {}
    for name, s, spp in (("exact", s_c, FWD_SPP),
                         ("rr2", s_c.replace(rr_depth=2), FWD_SPP),
                         ("spp1", s_c, 1)):
        a0, b0 = bounce_megakernel.launches, iter_megakernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, total = render_accumulate(cornell, s, seed=1, spp=spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        img = acc / total
        la = bounce_megakernel.launches - a0
        lb = iter_megakernel.launches - b0
        finite = bool(torch.isfinite(img).all())
        mean = float(img.mean())
        runs[name] = dict(seconds=dt, rays_per_s=n_pix * spp / dt,
                          kernel_a=la, kernel_b=lb, mean=mean)
        iters = la + lb
        print(f"[main path] cornell 600x600 {spp} spp depth 50 {name}: "
              f"{dt:.3f} s, {n_pix * spp / dt / 1e6:.3f} M primary rays/s, "
              f"{iters} iterations ({1e3 * dt / max(iters, 1):.3f} ms/iter), "
              f"launches A={la} B={lb}, mean {mean:.6f}, finite {finite} "
              f"[{smi}]", flush=True)
        if not finite or img.shape != (n_pix, 3):
            raise AssertionError(f"main path {name}: bad image")
        if spp > 1 and (la == 0 or lb != 0):
            raise AssertionError(f"main path {name}: expected kernel A only")
        if spp == 1 and lb == 0:
            raise AssertionError("main path spp1: kernel B did not run")
        if name == "exact":
            write_image(os.path.join(OUT_DIR, "cornell600.png"),
                        img.reshape(600, 600, 3))
    main_a, main_b = bounce_megakernel.launches, iter_megakernel.launches
    rel = abs(runs["rr2"]["mean"] / runs["exact"]["mean"] - 1.0)
    print(f"[main path] mean exact vs rr2: rel diff {rel:.4f} (bound 0.03)",
          flush=True)
    if rel > 0.03:
        raise AssertionError("Russian roulette changed the image mean")
    if main_a == 0 or main_b == 0:
        raise AssertionError("a kernel of the main path never launched")

    phase_done("forward main path")

    # the main path again, every launch held against its plain version
    s_rr = s_c.replace(rr_depth=2)
    for name, s, spp in (("exact", s_c, 2), ("rr2", s_rr, 2),
                         ("exact", s_c, 1), ("rr2", s_rr, 1)):
        with checked_launches() as stats:
            acc, total = render_accumulate(cornell, s, seed=1, spp=spp)
        kernel = "bounce_megakernel" if spp > 1 else "iter_megakernel"
        st = stats[kernel]
        if st["launches"] == 0 or not bool(torch.isfinite(acc).all()):
            raise AssertionError(f"checked main path {spp} spp {name}: "
                                 f"{kernel} did not run or the image is "
                                 "not finite")
        err = _check(f"main path checked: cornell 600x600 {spp} spp {name}, "
                     f"{st['launches']} launches of {kernel}",
                     (st["n_int"], st["err"], st["excess"]), lanes)
        if spp > 1:
            err_a = max(err_a, err)
        else:
            err_b = max(err_b, err)

    phase_done("checked forward renders")

    # 7. kernel times at the main path's 360,064 lanes: device time per
    # launch, and the wrapper's call back to back (its host cost)
    a_call = lambda: bounce_megakernel(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                       *a_args, **tb_c.kw)
    ms_a = _device_ms(a_call, "bounce_kernel", 50)
    host_a = _time_ms(a_call, 50)
    plain_a = _time_ms(lambda: bounce_plain(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                            *a_args, **tb_c.kw), 5, 1)
    print(f"[time] kernel A {ms_a:.4f} ms on the device ({host_a:.4f} ms a "
          f"call back to back) vs bounce_plain {plain_a:.3f} ms at {lanes} "
          f"lanes (primary rays) [{smi}]", flush=True)
    b_tables, b_kw = iter_kernel_args(cornell, s_c, rng.base_key(1, dev), 199)
    b_lane = ((torch.from_numpy(lane_pix).to(dev, torch.int32),)
              + fresh_carry(lanes, dev))
    err_b = max(err_b, _check(
        "kernel B vs plain: cornell 600x600 every lane regenerating",
        max_errs(iter_plain(*b_tables, b_lane, **b_kw),
                 iter_megakernel(*b_tables, b_lane, **b_kw), ITER_INT_ROWS),
        lanes))
    b_call = lambda: iter_megakernel(*b_tables, b_lane, **b_kw)
    ms_b = _device_ms(b_call, "iter_kernel", 50)
    host_b = _time_ms(b_call, 50)
    plain_b = _time_ms(lambda: iter_plain(*b_tables, b_lane, **b_kw), 5, 1)
    print(f"[time] kernel B {ms_b:.4f} ms on the device ({host_b:.4f} ms a "
          f"call back to back) vs iter_plain {plain_b:.3f} ms at {lanes} "
          f"lanes (regenerating every lane) [{smi}]", flush=True)

    # bounds: each input column read once and each output written once;
    # operations estimated per lane from the sources (a row of the scan
    # ~45, the shade ~300, the hash, camera and RR ~150; K5's replay and
    # its reverse sweep ~1000), all at the float32 rate
    bound_a = _bound_ms(4 * lanes * (11 + 8 + 15),
                        lanes * (45 * tb_c.n_prims + 300))
    bound_b = _bound_ms(4 * lanes * (17 + 19),
                        lanes * (45 * tb_c.n_prims + 450))
    print(f"[bound] kernel A {bound_a[0]:.4f} ms ({bound_a[1]}), kernel B "
          f"{bound_b[0]:.4f} ms ({bound_b[1]}) at {lanes} lanes", flush=True)

    phase_done("kernel times")

    # 8. K5 vs plain on 2^18 lanes of real mid-render states
    n_bwd = FWD_BWD["lanes"]
    s_fb = s_c.replace(rr_depth=FWD_BWD["rr_depth"])
    s_a6 = s_a.replace(image_width=600)
    box, s_box = box_motion_scene(device=dev)
    s_box = s_box.replace(image_width=600)
    err_k5 = 0.0
    k5_args = None
    standin, s_st = bunny_standin_scene(600, MESH_FWD_BWD["spp"], 10,
                                        device=dev)
    for name, sc, s, pixels, n in (
            ("cornell fwd+bwd", cornell, s_fb,
             fwd_bwd_pixels(n_pix, n_bwd), n_bwd),
            ("all-materials", allm, s_a6, None, n_bwd),
            ("all-materials 2 targets", allm,
             s_a6.with_redirect_targets(ALL_MATERIAL_TARGETS), None, n_bwd),
            ("box/motion", box, s_box, None, n_bwd),
            ("box/motion 2 targets", box,
             s_box.with_redirect_targets(ALL_MATERIAL_TARGETS), None, n_bwd),
            ("bunny stand-in mesh fwd+bwd", standin,
             s_st.replace(rr_depth=MESH_FWD_BWD["rr_depth"]), None,
             MESH_FWD_BWD["lanes"])):
        args, kw = bwd_inputs(sc, s, n, 31, n_iters=4,
                              spp=FWD_BWD["spp"], pixels=pixels)
        (err, excess), _ = compare_bwd(args, kw)
        torch.cuda.synchronize()
        print(f"[K5 vs plain] {name}: {n} lanes x {kw['n_row'] + 20} "
              f"outputs, {int((args[6] > 0.5).sum())} alive, max |err| "
              f"{err:.3g}, worst excess {excess:.3g} (rtol {BWD_RTOL} of "
              "|plain| + output max + lane max) at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        if not excess <= 0.0:
            raise AssertionError(f"K5 vs plain: {name}: out of tolerance")
        tables = row_tables(sc, kw["n_row"])
        err_k5 = max(err_k5, err, _check_reduced(
            f"K5 reduced vs plain: {name}", args, kw, tables))
        if k5_args is None:
            k5_args, k5_kw, k5_tables = args, kw, tables

    phase_done("K5 vs plain")

    # 9. fwd+bwd with K5 against the same with its plain backward
    params, statics = partition(cornell)
    key = rng.base_key(0, dev)
    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=8, n_iters=40, remat=False)
    k0 = bounce_bwd_regen_pre_reduced.launches
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
    if bounce_bwd_regen_pre_reduced.launches - k0 != kw9["n_iters"]:
        raise AssertionError("fwd+bwd at 2^14 lanes: the reduced K5 did not "
                             "launch once per iteration")
    with plain_backward():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max(float(np.abs(g_k[k] - g_p[k]).max())
                / max(float(np.abs(g_p[k]).max()), 1e-30) for k in g_p)
    print(f"[fwd+bwd K5 vs plain] {n9} lanes, 8 spp, 40 iterations: loss "
          f"{float(l_k):.6f} vs {float(l_p):.6f}, samples {float(f_k):.4f}, "
          f"worst leaf max|diff|/max|plain| {worst:.3g} (bound {GRAD_RTOL})",
          flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst <= GRAD_RTOL:
        raise AssertionError("fwd+bwd: K5 and its plain version disagree")

    phase_done("fwd+bwd K5 vs plain")

    # 10. the fwd+bwd main path at bench size
    pix_fb = fwd_bwd_pixels(n_pix, n_bwd).to(dev)
    tgt_fb = torch.zeros((n_bwd, 3), device=dev)

    def fwd_bwd():
        return loss_and_grads(
            params, statics, s_fb, key, pix_fb, tgt_fb, spp=FWD_BWD["spp"],
            n_iters=FWD_BWD["n_iters"], remat=False,
            schedule=FWD_BWD["schedule"])

    fwd_bwd()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iter_megakernel.launches = 0
    bounce_bwd_regen_pre_reduced.launches = 0
    bounce_bwd_regen_pre_megakernel.launches = 0
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb_b = iter_megakernel.launches
    fb_k5 = bounce_bwd_regen_pre_reduced.launches
    fb_k5_lane = bounce_bwd_regen_pre_megakernel.launches
    peak = torch.cuda.max_memory_allocated()
    gnp = grads_to_numpy(grads)
    finite = all(bool(np.isfinite(v).all()) for v in gnp.values())
    fb = dict(seconds=wall, rays_per_s=n_bwd * FWD_BWD["spp"] / wall,
              loss=float(loss), samples_completed=float(frac),
              launches_iter=fb_b, launches_bwd=fb_k5, peak_bytes=peak)
    n_expect = FWD_BWD["n_iters"] + sum(i for i, _ in FWD_BWD["schedule"])
    print(f"[main path fwd+bwd] cornell 600x600 depth 50 rr2, {n_bwd} lanes "
          f"x {FWD_BWD['spp']} spp: {wall:.3f} s, "
          f"{fb['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
          f"{fb['loss']:.6f}, samples_completed {fb['samples_completed']:.6f},"
          f" launches B={fb_b} K5 reduced={fb_k5} ({_row_mode_name(cornell)}) "
          f"K5 per lane={fb_k5_lane}, "
          f"peak memory {peak / 2**30:.3f} GiB, gradients finite {finite} "
          f"[{smi}]", flush=True)
    if not finite or fb["samples_completed"] < 0.9999 \
            or fb_b != n_expect or fb_k5 != n_expect or fb_k5_lane:
        raise AssertionError("fwd+bwd main path: bad gradients, incomplete "
                             "samples or wrong launch counts")
    main_b += fb_b

    phase_done("fwd+bwd main path")

    # 11. finite differences on the card (exact estimator: the paths do
    # not depend on an emission or an albedo)
    s_fd = s_c.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=8, n_iters=80, remat=False)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex, mats = cornell.textures, cornell.materials
    light = int(mats.tex[(mats.kind == MAT_LIGHT).nonzero()[0, 0]])
    red = int(torch.argmax(tex.c0[:, 0] - tex.c0[:, 1]))
    for name, ti, eps in (("light emission", light, 0.5),
                          ("red wall albedo", red, 1e-2)):
        def loss_at(x, ti=ti):
            c0 = tex.c0.clone()
            c0[ti, 0] = x[0]
            sc = dataclasses.replace(
                cornell, textures=dataclasses.replace(tex, c0=c0))
            with torch.no_grad():
                return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                             tgt_fd, **kw_fd)[0]
        fd = float(finite_difference(loss_at, tex.c0[ti, 0:1].clone(),
                                     eps)[0])
        gv = float(g_fd.textures.c0[ti, 0])
        print(f"[finite difference] {name} (texture {ti}, red channel): "
              f"gradient {gv:.6g}, central difference {fd:.6g} (eps {eps}),"
              f" rel diff {abs(gv - fd) / abs(fd):.3g} (bound {FD_RTOL})",
              flush=True)
        if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
            raise AssertionError(f"finite difference: {name}")

    phase_done("finite differences")

    # 12. K5's time at 2^18 lanes (the Cornell fwd+bwd state of phase 8):
    # the reduced mode's device time (its kernel and the two finishing
    # launches) and its wrapper's call back to back; the per-lane mode's
    # device time, and that of the torch gather and index_add_ around it
    # that the reduced mode took in
    k5_red = lambda: bounce_bwd_regen_pre_reduced(
        *reduced_args(k5_args, k5_tables), **k5_kw)
    ms_k5 = _device_ms(k5_red, ("bounce_bwd_kernel", "row_sum_kernel",
                                "row_map_kernel"), 50)
    ms_k5_main = _device_ms(k5_red, "bounce_bwd_kernel", 50)
    host_k5 = _time_ms(k5_red, 50)
    k5_lane = lambda: bounce_bwd_regen_pre_megakernel(*k5_args, **k5_kw)
    ms_k5_lane = _device_ms(k5_lane, "bounce_bwd_kernel", 50)
    host_k5_lane = _time_ms(k5_lane, 50)
    with per_lane_backward():
        from raytrace_tpu_torch.diff import fused_iter
        old_k5 = fused_iter.bounce_bwd_regen_pre_reduced
        old_call = lambda: old_k5(*reduced_args(k5_args, k5_tables),
                                  **k5_kw)
        total_old = _device_total_ms(old_call, 10)
        host_old = _time_ms(old_call, 10)
    plain_k5 = _time_ms(lambda: bounce_bwd_regen_pre_reduced_plain(
        *reduced_args(k5_args, k5_tables), **k5_kw), 3, 1)
    bound_k5 = _bwd_bound(n_bwd, 29, 13, k5_tables, k5_kw["n_row"])
    print(f"[time] K5 reduced {ms_k5:.4f} ms on the device ({ms_k5_main:.4f}"
          f" ms the kernel, the rest the finishing launches; {host_k5:.4f} ms"
          f" a call back to back) vs "
          f"its plain version {plain_k5:.3f} ms at {n_bwd} lanes, "
          f"bound {bound_k5[0]:.4f} ms ({bound_k5[1]}: 29 columns in, 13 "
          f"out, the table and the reduced tables); before: the per-lane "
          f"mode {ms_k5_lane:.4f} ms on the device ({host_k5_lane:.4f} ms a "
          f"call), with the torch gather and index_add_ around it "
          f"{total_old:.4f} ms of device time a call ({host_old:.4f} ms a "
          f"call back to back) [{smi}]", flush=True)

    phase_done("K5 time")

    # the fwd+bwd main path with the backward before the reduction moved
    # into K5 and with the reduced K5, in turns
    turns = {"fwd_bwd": _in_turns("cornell fwd+bwd", fwd_bwd, n_expect, smi)}

    phase_done("fwd+bwd in turns")

    mesh = _mesh_phases(smi, phase_done)
    rich = _rich_phases(smi, phase_done, dev)
    media = _media_phases(smi, phase_done, dev)
    unfused = _unfused_phases(smi, phase_done, dev)
    turns["route8"] = unfused.pop("turns")
    main_a += unfused["a_launches"]
    main_b += rich["iter_launches"]
    mesh["kernels"][0]["launches"] += media["k9_launches"]
    mesh["kernels"][1]["launches"] += (rich["shade_launches"]
                                       + media["shade_launches"]
                                       + unfused["shade_launches"])
    mesh["kernels"][2]["launches"] += rich["mesh_iter_launches"]
    rich["kernels"][0]["launches"] += (media["k8_launches"]
                                       + unfused["k8_launches"])
    media["kernels"][0]["launches"] += unfused["k11_launches"]
    media["kernels"][1]["launches"] += unfused["k11b_launches"]
    print(json.dumps({"main_path": runs, "fwd_bwd": fb,
                      "mesh": mesh["summary"], "rich": rich["summary"],
                      "media": media["summary"],
                      "unfused": unfused["summary"], "in_turns": turns,
                      "build_seconds": build_s}), flush=True)
    no_lib = None   # no single PyTorch call computes a bounce
    print(json.dumps({"kernels": [
        {"name": "bounce_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/bounce_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:523",
         "launches": main_a, "max_abs_err": err_a, "ms": ms_a,
         "host_ms": host_a, "plain_ms": plain_a, "bound_ms": bound_a[0],
         "bound_by": bound_a[1], "library_ms": no_lib},
        {"name": "iter_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/iter_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/iter_kernel.py:328",
         "launches": main_b, "max_abs_err": err_b, "ms": ms_b,
         "host_ms": host_b, "plain_ms": plain_b, "bound_ms": bound_b[0],
         "bound_by": bound_b[1], "library_ms": no_lib},
        {"name": "bounce_bwd_regen_pre_reduced", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/bounce_bwd_kernel.cu",
         "replaces":
             "raytrace_tpu/ops/pallas/bounce_bwd_gather_kernel.py:497",
         "launches": fb_k5 + mesh["k5_launches"] + rich["k5_launches"],
         "max_abs_err": err_k5, "ms": ms_k5, "host_ms": host_k5,
         "plain_ms": plain_k5, "bound_ms": bound_k5[0],
         "bound_by": bound_k5[1], "library_ms": no_lib,
         "kernel_ms": ms_k5_main, "per_lane_ms": ms_k5_lane,
         "per_lane_host_ms": host_k5_lane,
         "per_lane_with_torch_reduction_ms": total_old,
         "per_lane_with_torch_reduction_host_ms": host_old},
    ] + mesh["kernels"] + rich["kernels"] + media["kernels"]
        + [unfused["kernel"]]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _mesh_phases(smi, phase_done) -> dict:
    """Phases 13-18 (the mesh scale).  Returns the summary for the JSON
    line, the K5 launches of route 2 and the ``kernels`` entries of the
    three mesh kernels."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.allpairs_kernel import (
        allpairs_nearest_plain, allpairs_nearest_record,
    )
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel, shade_plain,
    )
    from raytrace_tpu_torch.ops.iter_kernel import (
        iter_mega_ap, iter_megakernel, iter_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import split_tables
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        FRAC_LANES, MEAN_RTOL, MESH_FWD_BWD, bunny_standin_scene,
        camera_rays, checked_launches, compare_iter, compare_nearest,
        compare_shade, fresh_carry, mesh_all_kinds_scene, next_split_rays,
        plain_kernels, synthetic_medium, uv_sphere,
    )
    dev = torch.device("cuda", 0)
    standin, s_m = bunny_standin_scene(600, MESH_SPP, 10, device=dev)
    n_pix = s_m.image_width * s_m.image_height
    lanes = -(-n_pix // 128) * 128
    t0 = time.perf_counter()
    tb_m = split_tables(standin, s_m)
    print(f"[mesh] bunny stand-in: {standin.prims.n} triangles in "
          f"{standin.prims.kind.shape[0]} rows, kind segments "
          f"{standin.prims.kind_segments}; split tables + BVH "
          f"{time.perf_counter() - t0:.3f} s (BVH build "
          f"{tb_m.bvh.build_s:.3f} s, {tb_m.bvh.n_nodes} nodes)", flush=True)

    # 13./14. nearest and shade kernels vs plain
    err_n = err_s = 0.0
    n_k = 1 << 17
    v, f = uv_sphere(126, 200)
    big = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture([0.6, 0.6, 0.6])),
        rt.triangle_mesh(rt.Mesh(1.5 * v, np.zeros((0, 2)), f,
                                 np.full_like(f, -1)))), device=dev)
    s_big = rt.CameraSettings(center=[0.0, 1.0, 4.0], look_at=[0.0, 0.0, 0.0],
                              image_width=128, background=rt.gray_fade)
    cases = [("stand-in", standin, s_m, n_k)]
    for moving in (False, True):
        sc, s_k = mesh_all_kinds_scene(18, moving, 600, device=dev)
        cases.append((f"mesh all kinds{' moving' if moving else ''}", sc, s_k,
                      n_k))
    cases.append((f"{f.shape[0]}-triangle sphere", big, s_big, 1 << 14))
    for name, sc, s_k, n in cases:
        tb = tb_m if sc is standin else split_tables(sc, s_k)
        comps, uni = camera_rays(sc, s_k, n, 41)
        thr = torch.ones((3, n), device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for depth in (0, 1):
            errs, _ = compare_nearest(tb, comps)
            err_n = max(err_n, _check(
                f"nearest vs plain: {name} ({sc.prims.kind.shape[0]} rows, "
                f"BVH build {tb.bvh.build_s:.3f} s), bounce {depth + 1}",
                errs, n))
            errs, out, hit = compare_shade(tb, comps, uni, thr, alive)
            err_s = max(err_s, _check(f"shade vs plain: {name}, bounce "
                                      f"{depth + 1}", errs, n))
            med = synthetic_medium(hit[0], tb.n_mats, 43 + depth)
            errs, _, _ = compare_shade(tb, comps, uni, thr, alive,
                                       medium=med, hit=hit)
            err_s = max(err_s, _check(f"shade vs plain: {name}, bounce "
                                      f"{depth + 1}, synthetic medium",
                                      errs, n))
            if err_n or err_s:
                raise AssertionError("a mesh kernel is not exact")
            comps, uni, thr, alive = next_split_rays(comps, out, 41,
                                                     depth + 1)
    phase_done("nearest and shade kernels vs plain")

    # 15. kernel B's mesh variant vs plain
    err_m = 0.0
    for name, s_k, seed in (("exact", s_m, 51),
                            ("rr2", s_m.replace(rr_depth=2), 52)):
        one, frac, mean_rel = compare_iter(standin, s_k, n_k, seed,
                                           n_iters=10, box=(-1.0, 1.0))
        err_m = max(err_m, _check(f"mesh iteration vs plain: stand-in "
                                  f"{name}, one iteration", one, n_k))
        print(f"[mesh iteration vs plain] stand-in {name}, 10 iterations: "
              f"{frac:.5f} of lanes differ by > 1e-5 (bound {FRAC_LANES}), "
              f"mean rel diff {mean_rel:.2e} (bound {MEAN_RTOL})",
              flush=True)
        if frac >= FRAC_LANES or mean_rel > MEAN_RTOL:
            raise AssertionError("the mesh iteration kernel disagrees with "
                                 "iter_plain over 10 iterations")
    phase_done("mesh iteration kernel vs plain")

    # 16. route 1: the split forward at full size
    counters = (bounce_megakernel, iter_megakernel, allpairs_nearest_record,
                shade_megakernel)
    for c in counters:
        c.launches = 0
    runs = {}
    for name, s_k in (("exact", s_m), ("rr2", s_m.replace(rr_depth=2))):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, total = render_accumulate(standin, s_k, seed=1, spp=MESH_SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        la, lb, ln, ls = (c.launches - b for c, b in zip(counters, before))
        img = acc / total
        finite = bool(torch.isfinite(img).all())
        mean = float(img.mean())
        runs[name] = dict(seconds=dt, rays_per_s=n_pix * MESH_SPP / dt,
                          iterations=ln, nearest=ln, shade=ls, mean=mean)
        print(f"[route 1] stand-in 600x600 {MESH_SPP} spp depth 10 {name}: "
              f"{dt:.3f} s, {n_pix * MESH_SPP / dt / 1e6:.3f} M primary "
              f"rays/s, {ln} iterations ({1e3 * dt / max(ln, 1):.3f} "
              f"ms/iter), launches nearest={ln} shade={ls} A={la} B={lb}, "
              f"mean {mean:.6f}, finite {finite} [{smi}]", flush=True)
        if not finite or img.shape != (n_pix, 3) or ln == 0 or ls != ln \
                or la or lb:
            raise AssertionError(f"route 1 {name}: bad image or launches")
        if name == "exact":
            write_image(os.path.join(OUT_DIR, "mesh600.png"),
                        img.reshape(600, 600, 3))
    r1_nearest = allpairs_nearest_record.launches
    r1_shade = shade_megakernel.launches
    rel = abs(runs["rr2"]["mean"] / runs["exact"]["mean"] - 1.0)
    print(f"[route 1] mean exact vs rr2: rel diff {rel:.4f} (bound 0.03)",
          flush=True)
    if rel > 0.03:
        raise AssertionError("Russian roulette changed the mesh image mean")
    phase_done("route 1")
    for name, s_k in (("exact", s_m), ("rr2", s_m.replace(rr_depth=2))):
        with checked_launches() as stats:
            acc, _ = render_accumulate(standin, s_k, seed=1, spp=1)
        for kname in ("allpairs_nearest_record", "shade_megakernel"):
            st = stats[kname]
            if st["launches"] == 0 or not bool(torch.isfinite(acc).all()):
                raise AssertionError(f"checked route 1 {name}: {kname}")
            err = _check(f"route 1 checked: stand-in 600x600 1 spp {name}, "
                         f"{st['launches']} launches of {kname}",
                         (st["n_int"], st["err"], st["excess"]), lanes)
            if kname == "shade_megakernel":
                err_s = max(err_s, err)
            else:
                err_n = max(err_n, err)
    phase_done("checked route 1")

    # 17. route 2: the mesh fwd+bwd
    cfg = MESH_FWD_BWD
    params, statics = partition(standin)
    s_fb = s_m.replace(rr_depth=cfg["rr_depth"])
    key = rng.base_key(0, dev)
    pix_fb = (torch.arange(cfg["lanes"]) % n_pix).to(dev, torch.int32)
    tgt_fb = torch.zeros((cfg["lanes"], 3), device=dev)

    def fwd_bwd():
        return loss_and_grads(params, statics, s_fb, key, pix_fb, tgt_fb,
                              spp=cfg["spp"], n_iters=cfg["n_iters"],
                              remat=False, schedule=cfg["schedule"])

    fwd_bwd()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iter_mega_ap.launches = 0
    bounce_bwd_regen_pre_reduced.launches = 0
    bounce_bwd_regen_pre_megakernel.launches = 0
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r2_iter = iter_mega_ap.launches
    r2_k5 = bounce_bwd_regen_pre_reduced.launches
    r2_k5_lane = bounce_bwd_regen_pre_megakernel.launches
    peak = torch.cuda.max_memory_allocated()
    gnp = grads_to_numpy(grads)
    finite = all(bool(np.isfinite(x).all()) for x in gnp.values())
    n_expect = cfg["n_iters"] + sum(i for i, _ in cfg["schedule"])
    fb = dict(seconds=wall, rays_per_s=cfg["lanes"] * cfg["spp"] / wall,
              loss=float(loss), samples_completed=float(frac),
              launches_iter=r2_iter, launches_bwd=r2_k5, peak_bytes=peak)
    print(f"[route 2] stand-in fwd+bwd, {cfg['lanes']} lanes x {cfg['spp']} "
          f"spp, rr2, {cfg['n_iters']} iterations + {cfg['schedule']}: "
          f"{wall:.3f} s, {fb['rays_per_s'] / 1e6:.3f} M primary rays/s, "
          f"loss {fb['loss']:.6f}, samples_completed "
          f"{fb['samples_completed']:.6f}, launches mesh iteration={r2_iter} "
          f"K5 reduced={r2_k5} ({_row_mode_name(standin)}) K5 per lane="
          f"{r2_k5_lane}, peak memory "
          f"{peak / 2**30:.3f} GiB, gradients finite {finite} [{smi}]",
          flush=True)
    if not finite or r2_iter != n_expect or r2_k5 != n_expect or r2_k5_lane:
        raise AssertionError("route 2: bad gradients or launch counts")
    phase_done("route 2")

    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=4, n_iters=24, remat=False)
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
    with plain_kernels():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max(float(np.abs(g_k[k] - g_p[k]).max())
                / max(float(np.abs(g_p[k]).max()), 1e-30) for k in g_p)
    print(f"[route 2 kernels vs plain] {n9} lanes, 4 spp, 24 iterations: "
          f"loss {float(l_k):.6f} vs {float(l_p):.6f}, samples "
          f"{float(f_k):.4f} vs {float(f_p):.4f}, worst leaf "
          f"max|diff|/max|plain| {worst:.3g} (bound {GRAD_RTOL})",
          flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst <= GRAD_RTOL:
        raise AssertionError("route 2: the kernels and their plain versions "
                             "disagree")

    s_fd = s_m.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=4, n_iters=50, remat=False)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex = standin.textures

    def loss_at(x):
        c0 = tex.c0.clone()
        c0[0, 2] = x[0]
        sc = dataclasses.replace(standin,
                                 textures=dataclasses.replace(tex, c0=c0))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                         tgt_fd, **kw_fd)[0]
    fd = float(finite_difference(loss_at, tex.c0[0, 2:3].clone(), 1e-2)[0])
    gv = float(g_fd.textures.c0[0, 2])
    print(f"[finite difference] mesh albedo (blue channel): gradient "
          f"{gv:.6g}, central difference {fd:.6g} (eps 0.01), rel diff "
          f"{abs(gv - fd) / abs(fd):.3g} (bound {FD_RTOL})", flush=True)
    if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
        raise AssertionError("finite difference: mesh albedo")
    phase_done("route 2 checks")

    # 18. kernel times at the slice's shapes
    comps, uni = camera_rays(standin, s_m, lanes, 61)
    rays = tuple(comps.unbind(0))
    kw_n = dict(n_prims=tb_m.n_prims, t_min=tb_m.t_min,
                has_motion=tb_m.has_motion)
    hit_out, visits = allpairs_nearest_record(tb_m.ptbl, tb_m.bvh, *rays,
                                              count_visits=True, **kw_n)
    n_call = lambda: allpairs_nearest_record(tb_m.ptbl, tb_m.bvh, *rays,
                                             **kw_n)
    ms_n = _device_ms(n_call, "nearest_kernel", 20)
    host_n = _time_ms(n_call, 20)
    plain_n = _time_ms(lambda: allpairs_nearest_plain(tb_m.ptbl, *rays,
                                                      **kw_n), 2, 1)
    nodes_v = float(visits[0].double().mean())
    rows_v = float(visits[1].double().mean())
    tbl_bytes = 4 * (tb_m.ptbl.numel() + tb_m.bvh.nodes.numel()
                     + tb_m.bvh.leaf_rows.numel())
    bound_n = _bound_ms(4 * lanes * (7 + 9) + tbl_bytes,
                        lanes * (NODE_OPS * nodes_v + ROW_OPS * rows_v))
    print(f"[time] nearest kernel {ms_n:.4f} ms on the device ({host_n:.4f} "
          f"ms a call back to back) vs allpairs_nearest_plain "
          f"{plain_n:.3f} ms at {lanes} camera rays of the stand-in; a ray "
          f"visits {nodes_v:.2f} nodes and {rows_v:.2f} rows on average; "
          f"bound {bound_n[0]:.4f} ms ({bound_n[1]}) [{smi}]", flush=True)

    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    thr = torch.ones((3, lanes), device=dev)
    from raytrace_tpu_torch.render.integrator import surface_hit
    hit = surface_hit(tb_m, comps[0:3], comps[3:6], comps[6])
    sh_lanes = (*rays[0:6], *thr, alive.float())
    kw_s = dict(n_mats=tb_m.n_mats, n_targets=tb_m.n_targets,
                has_medium=False)
    s_call = lambda: shade_megakernel(tb_m.mtbl, tb_m.ttbl, hit, None,
                                      sh_lanes, uni, **kw_s)
    ms_s = _device_ms(s_call, "shade_kernel", 50)
    host_s = _time_ms(s_call, 50)
    plain_s = _time_ms(lambda: shade_plain(tb_m.mtbl, tb_m.ttbl, hit, None,
                                           sh_lanes, uni, **kw_s), 5, 1)
    bound_s = _bound_ms(4 * lanes * (10 + 10 + 8 + 15), lanes * 300)
    print(f"[time] shade kernel {ms_s:.4f} ms on the device ({host_s:.4f} ms "
          f"a call back to back) vs shade_plain {plain_s:.3f} ms at {lanes} "
          f"lanes; bound {bound_s[0]:.4f} ms ({bound_s[1]}) "
          f"[{smi}]", flush=True)

    # the mesh variant with every lane regenerating: its rays are the
    # camera rays of sample 0 of its pixels
    n_i = cfg["lanes"]
    tables, kw_i = iter_kernel_args(standin, s_fb, rng.base_key(1, dev), 15)
    lane_in = (pix_fb,) + fresh_carry(n_i, dev)
    c_i, _ = camera_rays(standin, s_m, n_i, 1, pixels=pix_fb)
    _, vis_i = allpairs_nearest_record(tb_m.ptbl, tb_m.bvh, *c_i.unbind(0),
                                       count_visits=True, **kw_n)
    i_call = lambda: iter_megakernel(*tables, lane_in, **kw_i)
    ms_i = _device_ms(i_call, "iter_kernel", 20)
    host_i = _time_ms(i_call, 20)
    plain_i = _time_ms(lambda: iter_plain(*tables, lane_in, **kw_i), 2, 1)
    nodes_i = float(vis_i[0].double().mean())
    rows_i = float(vis_i[1].double().mean())
    bound_i = _bound_ms(4 * n_i * (17 + 19) + tbl_bytes,
                        n_i * (450 + NODE_OPS * nodes_i + ROW_OPS * rows_i))
    print(f"[time] mesh iteration kernel {ms_i:.4f} ms on the device "
          f"({host_i:.4f} ms a call back to back) vs iter_plain "
          f"{plain_i:.3f} ms at {n_i} lanes (every lane regenerating; a ray "
          f"visits {nodes_i:.2f} nodes and {rows_i:.2f} rows); bound "
          f"{bound_i[0]:.4f} ms ({bound_i[1]}) [{smi}]", flush=True)
    phase_done("mesh kernel times")

    no_lib = None   # no single PyTorch call computes a nearest hit or shade
    kernels = [
        {"name": "allpairs_nearest_record", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/nearest_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/allpairs_kernel.py:920",
         "launches": r1_nearest, "max_abs_err": err_n, "ms": ms_n,
         "host_ms": host_n, "plain_ms": plain_n, "bound_ms": bound_n[0],
         "bound_by": bound_n[1], "library_ms": no_lib},
        {"name": "shade_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/shade_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:616",
         "launches": r1_shade, "max_abs_err": err_s, "ms": ms_s,
         "host_ms": host_s, "plain_ms": plain_s, "bound_ms": bound_s[0],
         "bound_by": bound_s[1], "library_ms": no_lib},
        {"name": "iter_mega_ap", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/iter_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/iter_kernel.py:445",
         "launches": r2_iter, "max_abs_err": err_m, "ms": ms_i,
         "host_ms": host_i, "plain_ms": plain_i, "bound_ms": bound_i[0],
         "bound_by": bound_i[1], "library_ms": no_lib},
    ]
    summary = dict(route1=runs, route2=fb, bvh_build_s=tb_m.bvh.build_s,
                   visits=dict(nodes=nodes_v, rows=rows_v))
    return dict(summary=summary, k5_launches=r2_k5, kernels=kernels)


def _rich_phases(smi, phase_done, dev) -> dict:
    """Phases 19-23 (rich textures) on ``dev``.  Returns the summary for
    the JSON line, the launches of the shade kernel, kernel B, its mesh
    variant and K5 on routes 3 and 4 and the textured mesh, and the
    ``kernels`` entries of K8, K12 and K13."""
    import numpy as np
    import torch
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.image_grad_kernel import (
        image_grad_pallas, image_grad_plain,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import (
        pallas_nearest_plain, pallas_nearest_record,
    )
    from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap, iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import (
        marble_stripe_pallas, marble_stripe_plain, marble_table,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import split_tables
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        IMAGE_GRAD_FWD_BWD, MESH_FWD_BWD, bunny_tex_scene, camera_rays,
        checked_launches, compare_marble, compare_nearest_flat,
        compare_shade, image_grad_errs, image_grad_scene, next_split_rays,
        noise_test_scene, plain_kernels, stationary_lanes, surface_points,
    )
    from raytrace_tpu_torch.textures import textures as tex_mod
    counters = (bounce_megakernel, iter_megakernel, iter_mega_ap,
                allpairs_nearest_record, pallas_nearest_record,
                shade_megakernel, marble_stripe_pallas,
                bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
                image_grad_pallas)

    def reset():
        for c in counters:
            c.launches = 0

    def read():
        return {c.__name__: c.launches for c in counters}

    # 19. K8 and K12 vs plain on noise_test's camera lanes, two bounces
    noise, s_n = noise_test_scene(400, 100, 50, device=dev)
    n_pix, lanes, lane_pix = stationary_lanes(s_n)
    tb_n = split_tables(noise, s_n)
    comps, uni = camera_rays(noise, s_n, lanes, 71,
                             pixels=torch.from_numpy(lane_pix))
    thr = torch.ones((3, lanes), device=dev)
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    marble_row = noise.textures.marble_rows[0]
    err8 = err12 = 0.0
    k8_rays = k12_in = None
    for depth in (0, 1):
        errs, _ = compare_nearest_flat(tb_n, comps)
        err8 = max(err8, _check(f"K8 vs plain: noise_test 400x225 "
                                f"({tb_n.n_prims} rows), bounce {depth + 1}",
                                errs, lanes))
        pts, hit = surface_points(tb_n, comps)
        tid = torch.where(alive, noise.materials.tex[hit[8].long()], -1)
        n_marble = int((tid == marble_row).sum())
        errs, _ = compare_marble(noise.textures, tid, pts)
        err12 = max(err12, _check(f"K12 vs plain: noise_test 400x225 bounce "
                                  f"{depth + 1}, {n_marble} marble lanes",
                                  errs, lanes))
        errs, out, _ = compare_shade(tb_n, comps, uni, thr, alive)
        _check(f"shade vs plain: noise_test 400x225 bounce {depth + 1}",
               errs, lanes)
        if err8 or err12 or n_marble == 0:
            raise AssertionError("K8 or K12 is not exact, or no lane hit "
                                 "the marble")
        if depth == 0:
            k8_rays, k12_in = tuple(comps.unbind(0)), (tid, pts, n_marble)
        comps, uni, thr, alive = next_split_rays(comps, out, 71, depth + 1)
    phase_done("K8 and K12 vs plain")

    # 20. route 3: the rich forward at full size
    spp = s_n.samples_per_pixel
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(noise, s_n, seed=0, spp=spp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r3 = read()
    l8, l10, l12 = (r3["pallas_nearest_record"], r3["shade_megakernel"],
                    r3["marble_stripe_pallas"])
    la, lb = r3["bounce_megakernel"], r3["iter_megakernel"]
    img = acc / total
    finite = bool(torch.isfinite(img).all())
    route3 = dict(seconds=dt, rays_per_s=n_pix * spp / dt, iterations=l8,
                  k8=l8, k10=l10, k12=l12, mean=float(img.mean()))
    print(f"[route 3] noise_test 400x225 {spp} spp depth 50 seed 0: "
          f"{dt:.3f} s, {n_pix * spp / dt / 1e6:.3f} M primary rays/s, {l8} "
          f"iterations ({1e3 * dt / max(l8, 1):.3f} ms/iter), launches "
          f"K8={l8} K10={l10} K12={l12} A={la} B={lb} K9="
          f"{r3['allpairs_nearest_record']}, mean {route3['mean']:.6f}, "
          f"finite {finite} [{smi}]", flush=True)
    if not finite or img.shape != (n_pix, 3) or l8 == 0 or l10 != l8 \
            or l12 == 0 or la or lb or r3["allpairs_nearest_record"]:
        raise AssertionError("route 3: bad image or launches")
    write_image(os.path.join(OUT_DIR, "noise_test.png"),
                img.reshape(s_n.image_height, s_n.image_width, 3))
    phase_done("route 3")
    with checked_launches() as stats:
        acc1, _ = render_accumulate(noise, s_n, seed=0, spp=1)
    for kname in ("pallas_nearest_record", "shade_megakernel",
                  "marble_stripe_pallas"):
        st = stats[kname]
        if st["launches"] == 0 or not bool(torch.isfinite(acc1).all()):
            raise AssertionError(f"checked route 3: {kname}")
        err = _check(f"route 3 checked: noise_test 400x225 1 spp, "
                     f"{st['launches']} launches of {kname}",
                     (st["n_int"], st["err"], st["excess"]), lanes)
        if err:
            raise AssertionError(f"checked route 3: {kname} is not exact")
    phase_done("checked route 3")

    # 21. route 4: the image-textured fwd+bwd
    cfg = IMAGE_GRAD_FWD_BWD
    img_scene, s_i = image_grad_scene(512, device=dev)
    n_pix_i = s_i.image_width * s_i.image_height
    params, statics = partition(img_scene)
    key = rng.base_key(0, dev)
    pix_i = (torch.arange(cfg["lanes"]) % n_pix_i).to(dev, torch.int32)
    tgt_i = torch.zeros((cfg["lanes"], 3), device=dev)

    def fwd_bwd():
        return loss_and_grads(params, statics, s_i, key, pix_i, tgt_i,
                              spp=cfg["spp"], n_iters=cfg["n_iters"],
                              remat=False)

    fwd_bwd()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r4 = read()
    peak = torch.cuda.max_memory_allocated()
    gnp = grads_to_numpy(grads)
    finite = all(bool(np.isfinite(x).all()) for x in gnp.values())
    atlas_l1 = float(np.abs(gnp["textures.images"]).sum())
    l13 = r4["image_grad_pallas"]
    route4 = dict(seconds=wall, rays_per_s=cfg["lanes"] * cfg["spp"] / wall,
                  loss=float(loss), samples_completed=float(frac),
                  launches_iter=r4["iter_megakernel"],
                  launches_bwd=r4["bounce_bwd_regen_pre_reduced"],
                  launches_k13=l13, atlas_grad_l1=atlas_l1, peak_bytes=peak)
    print(f"[route 4] image fwd+bwd 512x512, {cfg['lanes']} lanes x "
          f"{cfg['spp']} spp, rr2, {cfg['n_iters']} iterations: {wall:.3f} s, "
          f"{route4['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
          f"{route4['loss']:.6f}, samples_completed {float(frac):.6f}, "
          f"launches B={r4['iter_megakernel']} "
          f"K5 reduced={r4['bounce_bwd_regen_pre_reduced']} "
          f"({_row_mode_name(img_scene)}) K5 per lane="
          f"{r4['bounce_bwd_regen_pre_megakernel']} K13={l13}, atlas "
          f"gradient L1 {atlas_l1:.6g}, peak memory {peak / 2**30:.3f} GiB, "
          f"gradients finite {finite} [{smi}]", flush=True)
    n_it = cfg["n_iters"]
    if not finite or float(frac) < 0.9999 or atlas_l1 <= 0.0 \
            or l13 != n_it - 1 or r4["iter_megakernel"] != n_it \
            or r4["bounce_bwd_regen_pre_reduced"] != n_it \
            or r4["bounce_bwd_regen_pre_megakernel"]:
        raise AssertionError("route 4: bad gradients, incomplete samples or "
                             "wrong launch counts")
    phase_done("route 4")

    # every K13 launch of route 4 against its plain version and a float64
    # sum; the launch with the most contributing lanes is kept for timing
    k13_in = None
    err13 = 0.0
    with checked_launches() as stats:
        inner = tex_mod.image_grad_pallas

        def keep(*a, **kw):
            nonlocal k13_in
            nz = int((a[3] != 0).any(1).sum())
            if k13_in is None or nz > k13_in[2]:
                k13_in = (a, kw, nz)
            return inner(*a, **kw)
        tex_mod.image_grad_pallas = keep
        try:
            fwd_bwd()
        finally:
            tex_mod.image_grad_pallas = inner
    st = stats["image_grad_pallas"]
    err13 = _check(f"K13 vs plain: route 4, {st['launches']} launches at "
                   f"{cfg['lanes']} lanes (tolerance: testing.image_grad_errs)",
                   (st["n_int"], st["err"], st["excess"]), cfg["lanes"])
    a13, kw13, nz13 = k13_in
    exact = image_grad_plain(*a13[:3], a13[3].to(torch.float64), **kw13)
    _, e64, x64 = image_grad_errs(*a13[:4], exact, image_grad_pallas(*a13,
                                                                      **kw13))
    print(f"[K13 vs float64] the launch with the most contributing lanes "
          f"({nz13} of {cfg['lanes']}): max |err| {e64:.3g}, worst excess "
          f"{x64:.3g}", flush=True)
    if st["launches"] != n_it - 1 or x64 > 0.0:
        raise AssertionError("K13 disagrees with a float64 sum")

    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix_i // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=4, n_iters=24, remat=False)
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_i, key, pix9, tgt9,
                                     **kw9)
    with plain_kernels():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_i, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max((float(np.abs(g_k[k] - g_p[k]).max())
                 / max(float(np.abs(g_p[k]).max()), 1e-30), k) for k in g_p)
    print(f"[route 4 kernels vs plain] {n9} lanes, 4 spp, 24 iterations: "
          f"loss {float(l_k):.6f} vs {float(l_p):.6f}, samples "
          f"{float(f_k):.4f} vs {float(f_p):.4f}, worst leaf "
          f"max|diff|/max|plain| {worst[0]:.3g} ({worst[1]}; atlas "
          f"{float(np.abs(g_k['textures.images'] - g_p['textures.images']).max()) / max(float(np.abs(g_p['textures.images']).max()), 1e-30):.3g})"
          f" (bound {GRAD_RTOL})", flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst[0] <= GRAD_RTOL:
        raise AssertionError("route 4: the kernels and their plain versions "
                             "disagree")

    s_fd = s_i.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=4, n_iters=40, remat=False)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex = img_scene.textures
    ga = g_fd.textures.images[0, :, :, 1].abs()
    texel = tuple(int(x) for x in np.unravel_index(int(torch.argmax(ga)),
                                                   tuple(ga.shape)))
    idx = (0, *texel, 1)

    def loss_at(x):
        im = tex.images.clone()
        im[idx] = x[0]
        sc = dataclasses.replace(img_scene,
                                 textures=dataclasses.replace(tex, images=im))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                         tgt_fd, **kw_fd)[0]
    # the loss is quadratic in one texel under the exact estimator, so a
    # wide step costs no accuracy and lifts the change above the f32
    # rounding of the loss
    fd = float(finite_difference(loss_at, tex.images[idx].reshape(1).clone(),
                                 0.25)[0])
    gv = float(g_fd.textures.images[idx])
    print(f"[finite difference] atlas texel {idx} (green): gradient "
          f"{gv:.6g}, central difference {fd:.6g} (eps 0.25), rel diff "
          f"{abs(gv - fd) / abs(fd):.3g} (bound {FD_RTOL})", flush=True)
    if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
        raise AssertionError("finite difference: atlas texel")
    phase_done("route 4 checks")

    # 22. the textured bunny stand-in's fwd+bwd
    cfg_b = MESH_FWD_BWD
    bunny, s_b = bunny_tex_scene(600, device=dev)
    n_pix_b = s_b.image_width * s_b.image_height
    params_b, statics_b = partition(bunny)
    pix_b = (torch.arange(cfg_b["lanes"]) % n_pix_b).to(dev, torch.int32)
    tgt_b = torch.zeros((cfg_b["lanes"], 3), device=dev)

    def fwd_bwd_b():
        return loss_and_grads(params_b, statics_b, s_b, key, pix_b, tgt_b,
                              spp=cfg_b["spp"], n_iters=cfg_b["n_iters"],
                              remat=False, schedule=cfg_b["schedule"])

    fwd_bwd_b()                                 # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    (loss_b, frac_b), grads_b = fwd_bwd_b()
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    rb = read()
    gnp_b = grads_to_numpy(grads_b)
    finite_b = all(bool(np.isfinite(x).all()) for x in gnp_b.values())
    n_exp = cfg_b["n_iters"] + sum(i for i, _ in cfg_b["schedule"])
    bunny_fb = dict(seconds=wall_b,
                    rays_per_s=cfg_b["lanes"] * cfg_b["spp"] / wall_b,
                    samples_completed=float(frac_b),
                    launches_iter=rb["iter_mega_ap"],
                    launches_bwd=rb["bounce_bwd_regen_pre_reduced"],
                    launches_k13=rb["image_grad_pallas"])
    print(f"[textured mesh fwd+bwd] stand-in with a 128x256 image, "
          f"{cfg_b['lanes']} lanes x {cfg_b['spp']} spp: {wall_b:.3f} s, "
          f"{bunny_fb['rays_per_s'] / 1e6:.3f} M primary rays/s, "
          f"samples_completed {float(frac_b):.6f}, launches mesh iteration="
          f"{rb['iter_mega_ap']} K5 reduced="
          f"{rb['bounce_bwd_regen_pre_reduced']} ({_row_mode_name(bunny)}) "
          f"K5 per lane="
          f"{rb['bounce_bwd_regen_pre_megakernel']} "
          f"K13={rb['image_grad_pallas']}, atlas gradient L1 "
          f"{float(np.abs(gnp_b['textures.images']).sum()):.6g}, gradients "
          f"finite {finite_b} [{smi}]", flush=True)
    if not finite_b or rb["iter_mega_ap"] != n_exp \
            or rb["bounce_bwd_regen_pre_reduced"] != n_exp \
            or rb["bounce_bwd_regen_pre_megakernel"] \
            or rb["image_grad_pallas"] == 0:
        raise AssertionError("textured mesh fwd+bwd: bad gradients or "
                             "launch counts")
    phase_done("textured mesh fwd+bwd")

    # 23. kernel times at the slice's shapes
    kw_n = dict(n_prims=tb_n.n_prims, t_min=tb_n.t_min,
                has_motion=tb_n.has_motion)
    k8_call = lambda: pallas_nearest_record(tb_n.ptbl, *k8_rays, **kw_n)
    ms8 = _device_ms(k8_call, "nearest_flat_kernel", 50)
    call8 = _time_ms(k8_call, 50)
    plain8 = _time_ms(lambda: pallas_nearest_plain(tb_n.ptbl, *k8_rays,
                                                   **kw_n), 5, 1)
    bound8 = _bound_ms(4 * lanes * (7 + 9) + 4 * 36 * tb_n.n_prims,
                       lanes * ROW_OPS * tb_n.n_prims)
    print(f"[time] K8 {ms8:.4f} ms on the device ({call8:.4f} ms a call "
          f"back to back) vs pallas_nearest_plain {plain8:.3f} ms at "
          f"{lanes} camera rays of noise_test ({tb_n.n_prims} rows); bound "
          f"{bound8[0]:.4f} ms ({bound8[1]}) [{smi}]", flush=True)
    tid0, pts0, nm0 = k12_in
    mtbl = marble_table(noise.textures)
    k12_call = lambda: marble_stripe_pallas(noise.textures, tid0, pts0, mtbl)
    ms12 = _device_ms(k12_call, "marble_kernel", 50)
    call12 = _time_ms(k12_call, 50)
    plain12 = _time_ms(lambda: marble_stripe_plain(noise.textures, tid0,
                                                   pts0, mtbl), 5, 1)
    bound12 = _bound_ms(4 * lanes * (1 + 3 + 1) + 4 * mtbl.numel(),
                        nm0 * MARBLE_OPS)
    print(f"[time] K12 {ms12:.4f} ms on the device ({call12:.4f} ms a call "
          f"back to back) vs marble_stripe_plain {plain12:.3f} ms at {lanes} "
          f"lanes ({nm0} marble); bound {bound12[0]:.4f} ms "
          f"({bound12[1]}) [{smi}]", flush=True)
    a13i = tuple(x.to(torch.int32) for x in a13[:3]) + (a13[3],)
    k13_call = lambda: image_grad_pallas(*a13i, **kw13)
    ms13 = _device_ms(k13_call, "image_grad_kernel", 50)
    call13 = _time_ms(k13_call, 50)
    plain13 = _time_ms(lambda: image_grad_plain(*a13, **kw13), 20)
    idx13 = tuple(x.long() for x in a13[:3])
    shape13 = (kw13["n_img"], kw13["h"], kw13["w"], 3)
    lib13 = _time_ms(lambda: torch.zeros(shape13, device=dev).index_put_(
        idx13, a13[3], accumulate=True), 20)
    n13 = a13[3].shape[0]
    bound13 = _bound_ms(n13 * (3 * 4 + 3 * 4) + 4 * int(np.prod(shape13)),
                        3 * nz13)
    print(f"[time] K13 {ms13:.4f} ms on the device ({call13:.4f} ms a call "
          f"back to back) vs image_grad_plain {plain13:.4f} ms vs "
          f"index_put_(accumulate=True) {lib13:.4f} ms at {n13} lanes "
          f"({nz13} contributing) into a {shape13} atlas; bound "
          f"{bound13[0]:.5f} ms ({bound13[1]}) [{smi}]", flush=True)
    phase_done("rich kernel times")

    kernels = [
        {"name": "pallas_nearest_record", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/nearest_flat_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/intersect_kernel.py:1026",
         "launches": l8, "max_abs_err": err8, "ms": ms8, "host_ms": call8,
         "plain_ms": plain8, "bound_ms": bound8[0], "bound_by": bound8[1],
         "library_ms": None},
        {"name": "marble_stripe_pallas", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/texture_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/texture_kernel.py:89",
         "launches": l12, "max_abs_err": err12, "ms": ms12,
         "host_ms": call12, "plain_ms": plain12, "bound_ms": bound12[0],
         "bound_by": bound12[1], "library_ms": None},
        {"name": "image_grad_pallas", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/image_grad_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/image_grad_kernel.py:110",
         "launches": l13 + rb["image_grad_pallas"],
         "max_abs_err": max(err13, e64), "ms": ms13, "host_ms": call13,
         "plain_ms": plain13,
         "bound_ms": bound13[0], "bound_by": bound13[1],
         "library_ms": lib13},
    ]
    summary = dict(route3=route3, route4=route4, textured_mesh=bunny_fb)
    return dict(summary=summary, kernels=kernels, shade_launches=l10,
                iter_launches=r4["iter_megakernel"],
                mesh_iter_launches=rb["iter_mega_ap"],
                k5_launches=r4["bounce_bwd_regen_pre_reduced"]
                + rb["bounce_bwd_regen_pre_reduced"])


def _media_phases(smi, phase_done, dev) -> dict:
    """Phases 24-28 (constant-density media) on ``dev``.  Returns the
    summary for the JSON line, the launches of K8, K9 and the shade kernel
    on routes 5-7, and the ``kernels`` entries of K11 and K11b."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.volume_kernel import (
        _chunk_plans, pallas_volume_crossings, pallas_volume_crossings_bcast,
        volume_crossings_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.render.volumes import crossing_kw, volume_tables
    from raytrace_tpu_torch.testing import (
        checked_launches, compare_crossings, cornell_smoke_scene,
        media_bounce_rays, pawn_inside_rays, pawn_standin_scene,
        stationary_lanes, uv_sphere, volume_rays, volume_test_world,
    )
    counters = (bounce_megakernel, iter_megakernel, pallas_nearest_record,
                allpairs_nearest_record, shade_megakernel,
                pallas_volume_crossings, pallas_volume_crossings_bcast)

    def reset():
        for c in counters:
            c.launches = 0

    def read():
        return {c.__name__: c.launches for c in counters}

    def check_crossings(label, volumes, comps):
        errs, out = compare_crossings(volumes, comps)
        inside = [int(((out[3 * v + 1] == 0.0) & torch.isfinite(out[3 * v]))
                      .sum()) for v in range(volumes.n_volumes)]
        err = _check(f"{label}; lanes whose first crossing exits, per "
                     f"medium: {inside}", errs, comps.shape[1])
        if err:
            raise AssertionError(f"{label}: not exact")
        return err

    smoke, s_s = cornell_smoke_scene(600, FWD_SPP, 50, device=dev)
    pawn, s_p = pawn_standin_scene(500, PAWN_SPP, 20, device=dev)
    n_pix_s, lanes_s, _ = stationary_lanes(s_s)
    n_pix_p = s_p.image_width * s_p.image_height
    print(f"[media] cornell_smoke: {smoke.prims.n} surface rows, media of "
          f"{smoke.volumes.counts} boundary rows; pawn stand-in: "
          f"{pawn.prims.n} triangles in {pawn.prims.kind.shape[0]} rows "
          f"(segments {pawn.prims.kind_segments}), a medium of "
          f"{pawn.volumes.counts} boundary rows", flush=True)

    # 24. the crossing kernels vs plain
    err11 = err11b = 0.0
    smoke_rays = media_bounce_rays(smoke, s_s, 81)
    for k, (comps, alive) in enumerate(smoke_rays):
        err11 += check_crossings(f"K11 vs plain: cornell_smoke 600x600 bounce "
                        f"{k + 1} ({int(alive.sum())} live)", smoke.volumes,
                        comps)
    n_k = 1 << 17
    pix_p = (torch.arange(n_k) * n_pix_p // n_k).to(dev, torch.int32)
    pawn_rays = media_bounce_rays(pawn, s_p, 82, pixels=pix_p)
    for k, (comps, alive) in enumerate(pawn_rays):
        err11b += check_crossings(f"K11b vs plain: pawn stand-in 500x500 bounce "
                        f"{k + 1} ({int(alive.sum())} live)", pawn.volumes,
                        comps)
    err11b += check_crossings(
        "K11b vs plain: pawn stand-in, rays from inside the medium",
        pawn.volumes, pawn_inside_rays(n_k, 83, device=dev))
    for moving in (False, True):
        world = rt.compile_scene(volume_test_world(rt, moving), device=dev)
        comps = volume_rays(1 << 16, 84 + moving, (-6.0, 6.0),
                            ([0.0, 0.0, -3.0], [3.2, 0.0, -3.5]), device=dev)
        err11 += check_crossings(f"K11 vs plain: fog ball and smoke box"
                        f"{' moving' if moving else ''} (a box row), random "
                        f"rays", world.volumes, comps)
    phase_done("crossing kernels vs plain")

    # 25. route 5: the media forward at full size
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(smoke, s_s, seed=0, spp=FWD_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r5 = read()
    l8, l10, l11 = (r5["pallas_nearest_record"], r5["shade_megakernel"],
                    r5["pallas_volume_crossings"])
    others = (r5["bounce_megakernel"], r5["iter_megakernel"],
              r5["allpairs_nearest_record"],
              r5["pallas_volume_crossings_bcast"])
    img = acc / total
    finite = bool(torch.isfinite(img).all())
    route5 = dict(seconds=dt, rays_per_s=n_pix_s * FWD_SPP / dt,
                  iterations=l8, k8=l8, k10=l10, k11=l11,
                  mean=float(img.mean()))
    print(f"[route 5] cornell_smoke 600x600 {FWD_SPP} spp (the scene renders "
          f"200) depth 50 seed 0: {dt:.3f} s, "
          f"{route5['rays_per_s'] / 1e6:.3f} M primary rays/s, {l8} "
          f"iterations ({1e3 * dt / max(l8, 1):.3f} ms/iter), launches "
          f"K8={l8} K10={l10} K11={l11} A={others[0]} B={others[1]} "
          f"K9={others[2]} K11b={others[3]}, mean {route5['mean']:.6f}, "
          f"finite {finite} [{smi}]", flush=True)
    if not finite or img.shape != (n_pix_s, 3) or l8 == 0 or l10 != l8 \
            or l11 != l8 or any(others):
        raise AssertionError("route 5: bad image or launches")
    write_image(os.path.join(OUT_DIR, "cornell_smoke.png"),
                img.reshape(s_s.image_height, s_s.image_width, 3))
    phase_done("route 5")
    with checked_launches() as stats:
        acc1, _ = render_accumulate(smoke, s_s, seed=0, spp=1)
    for kname in ("pallas_nearest_record", "pallas_volume_crossings",
                  "shade_megakernel"):
        st = stats[kname]
        if st["launches"] == 0 or not bool(torch.isfinite(acc1).all()):
            raise AssertionError(f"checked route 5: {kname}")
        err = _check(f"route 5 checked: cornell_smoke 600x600 1 spp, "
                     f"{st['launches']} launches of {kname}",
                     (st["n_int"], st["err"], st["excess"]), lanes_s)
        if err:
            raise AssertionError(f"checked route 5: {kname} is not exact")
        if kname == "pallas_volume_crossings":
            err11 += err
    phase_done("checked route 5")

    # 26. route 6: the mesh-boundary medium through the sorted driver
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(pawn, s_p, seed=0, spp=PAWN_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r6 = read()
    l9, l10p, l11b = (r6["allpairs_nearest_record"], r6["shade_megakernel"],
                      r6["pallas_volume_crossings_bcast"])
    others = (r6["bounce_megakernel"], r6["iter_megakernel"],
              r6["pallas_nearest_record"], r6["pallas_volume_crossings"])
    img = acc / total
    finite = bool(torch.isfinite(img).all())
    route6 = dict(seconds=dt, rays_per_s=n_pix_p * PAWN_SPP / dt,
                  iterations=l9, k9=l9, k10=l10p, k11b=l11b,
                  mean=float(img.mean()))
    print(f"[route 6] pawn stand-in 500x500 {PAWN_SPP} spp (the scene "
          f"renders 400) depth 20 seed 0, sorted driver: {dt:.3f} s, "
          f"{route6['rays_per_s'] / 1e6:.3f} M primary rays/s, {l9} "
          f"iterations ({1e3 * dt / max(l9, 1):.3f} ms/iter), launches "
          f"K9={l9} K11b={l11b} K10={l10p} A={others[0]} B={others[1]} "
          f"K8={others[2]} K11={others[3]}, mean {route6['mean']:.6f}, "
          f"finite {finite} [{smi}]", flush=True)
    if not finite or img.shape != (n_pix_p, 3) or l9 == 0 or l10p != l9 \
            or l11b != l9 or any(others):
        raise AssertionError("route 6: bad image or launches")
    write_image(os.path.join(OUT_DIR, "pawn_standin.png"),
                img.reshape(s_p.image_height, s_p.image_width, 3))
    phase_done("route 6")
    small, s_small = pawn_standin_scene(128, 1, 20, device=dev)
    with checked_launches() as stats:
        acc1, _ = render_accumulate(small, s_small, seed=0, spp=1)
    for kname in ("allpairs_nearest_record", "pallas_volume_crossings_bcast",
                  "shade_megakernel"):
        st = stats[kname]
        if st["launches"] == 0 or not bool(torch.isfinite(acc1).all()):
            raise AssertionError(f"checked route 6: {kname}")
        err = _check(f"route 6 checked: pawn stand-in 128x128 1 spp, "
                     f"{st['launches']} launches of {kname}",
                     (st["n_int"], st["err"], st["excess"]), 128 * 128)
        if err:
            raise AssertionError(f"checked route 6: {kname} is not exact")
        if kname == "pallas_volume_crossings_bcast":
            err11b += err
    phase_done("checked route 6")

    # 27. the 50,000-triangle sphere through the sorted driver
    v, f = uv_sphere(126, 200)
    big = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture([0.6, 0.6, 0.6])),
        rt.triangle_mesh(rt.Mesh(1.5 * v, np.zeros((0, 2)), f,
                                 np.full_like(f, -1)))), device=dev)
    s_big = rt.CameraSettings(center=[0.0, 1.0, 4.0], look_at=[0.0, 0.0, 0.0],
                              image_width=256, max_depth=10,
                              background=rt.gray_fade)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(big, s_big, seed=0, spp=4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r7 = read()
    l9b, l10b = r7["allpairs_nearest_record"], r7["shade_megakernel"]
    finite = bool(torch.isfinite(acc).all())
    route7 = dict(seconds=dt, rays_per_s=256 * 256 * 4 / dt, iterations=l9b,
                  mean=float((acc / total).mean()))
    print(f"[route 7] {f.shape[0]}-triangle sphere ({big.prims.kind.shape[0]}"
          f" rows) 256x256 4 spp depth 10, sorted driver: {dt:.3f} s, "
          f"{route7['rays_per_s'] / 1e6:.3f} M primary rays/s, launches "
          f"K9={l9b} K10={l10b} A={r7['bounce_megakernel']} "
          f"B={r7['iter_megakernel']}, mean {route7['mean']:.6f}, finite "
          f"{finite} [{smi}]", flush=True)
    if not finite or l9b == 0 or l10b != l9b:
        raise AssertionError("route 7: bad image or launches")
    phase_done("50k-triangle sphere, sorted")

    # 28. kernel times at the slice's shapes
    vtbl_s, _ = volume_tables(smoke.volumes)
    kw_s = crossing_kw(smoke.volumes, s_s.t_min)
    rays_s = tuple(smoke_rays[0][0].unbind(0))
    call11 = lambda: pallas_volume_crossings(vtbl_s, *rays_s, **kw_s)
    ms11 = _device_ms(call11, "volume_crossings_kernel", 50)
    back11 = _time_ms(call11, 50)
    plain11 = _time_ms(lambda: volume_crossings_plain(vtbl_s, *rays_s,
                                                      **kw_s), 5, 1)
    nv_s = smoke.volumes.n_volumes
    rows_s = vtbl_s.shape[0]
    bound11 = _bound_ms(4 * lanes_s * (7 + 3 * nv_s) + 4 * vtbl_s.numel(),
                        lanes_s * rows_s * VOL_ROW_OPS)
    print(f"[time] K11 {ms11:.4f} ms on the device ({back11:.4f} ms a call "
          f"back to back) vs volume_crossings_plain {plain11:.3f} ms at "
          f"{lanes_s} camera rays of cornell_smoke ({rows_s} boundary rows, "
          f"all tested); bound {bound11[0]:.4f} ms ({bound11[1]}) [{smi}]",
          flush=True)
    vtbl_p, cbox_p = volume_tables(pawn.volumes)
    kw_p = crossing_kw(pawn.volumes, s_p.t_min)
    rays_p = tuple(pawn_rays[0][0].unbind(0))
    _, tested = pallas_volume_crossings_bcast(vtbl_p, cbox_p, *rays_p,
                                              count_rows=True, **kw_p)
    call11b = lambda: pallas_volume_crossings_bcast(vtbl_p, cbox_p, *rays_p,
                                                    **kw_p)
    ms11b = _device_ms(call11b, "volume_chunked_kernel", 50)
    back11b = _time_ms(call11b, 50)
    plain11b = _time_ms(lambda: volume_crossings_plain(vtbl_p, *rays_p,
                                                       **kw_p), 2, 1)
    rows_t = float(tested.double().mean())
    n_chunks = sum(len(p) for p in _chunk_plans(kw_p["slices"]))
    bound11b = _bound_ms(4 * n_k * (7 + 3) + 4 * (vtbl_p.numel()
                                                  + cbox_p.numel()),
                         n_k * (VOL_ROW_OPS * rows_t + VOL_BOX_OPS * n_chunks))
    print(f"[time] K11b {ms11b:.4f} ms on the device ({back11b:.4f} ms a call "
          f"back to back) vs volume_crossings_plain {plain11b:.3f} ms at "
          f"{n_k} camera rays of the pawn stand-in; a ray tests "
          f"{rows_t:.2f} of {vtbl_p.shape[0]} rows and {n_chunks} chunk "
          f"boxes; bound {bound11b[0]:.5f} ms ({bound11b[1]}) [{smi}]",
          flush=True)
    phase_done("crossing kernel times")

    kernels = [
        {"name": "pallas_volume_crossings", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/volume_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/volume_kernel.py:594",
         "launches": l11, "max_abs_err": err11, "ms": ms11,
         "host_ms": back11, "plain_ms": plain11, "bound_ms": bound11[0],
         "bound_by": bound11[1], "library_ms": None},
        {"name": "pallas_volume_crossings_bcast", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/volume_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/volume_kernel.py:514",
         "launches": l11b, "max_abs_err": err11b, "ms": ms11b,
         "host_ms": back11b, "plain_ms": plain11b, "bound_ms": bound11b[0],
         "bound_by": bound11b[1], "library_ms": None},
    ]
    summary = dict(route5=route5, route6=route6, route7=route7,
                   k11b_rows_tested=rows_t)
    return dict(summary=summary, kernels=kernels, k8_launches=l8,
                k9_launches=l9 + l9b, shade_launches=l10 + l10p + l10b)


def _unfused_phases(smi, phase_done, dev) -> dict:
    """Phases 29-34 (the unfused differentiable wavefront and F8's
    17-medium forward) on ``dev``.  Returns the summary for the JSON line,
    the launches of kernel A, K8, K11, K11b and the shade kernel on routes
    8, 9 and the 17-medium renders, and the ``kernels`` entry of K7."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_bwd_kernel import (
        bounce_bwd_megakernel, bounce_bwd_megakernel_reduced,
        bounce_bwd_megakernel_reduced_plain,
    )
    from raytrace_tpu_torch.ops.row_reduce import row_tables
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.volume_kernel import pallas_volume_crossings
    from raytrace_tpu_torch.render.integrator import (
        lane_cost_estimate, trace_wavefront_diff,
    )
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        ALL_MATERIAL_TARGETS, BWD_RTOL, FWD_BWD_BAL4, FWD_BWD_ROT8,
        all_materials_scene, box_motion_scene, checked_launches, compare_k7,
        cornell_scene_and_settings, fwd_bwd_pixels, k7_inputs,
        many_media_settings, many_media_world, mesh_all_kinds_scene,
        per_lane_backward, plain_backward, reduced_args,
    )
    counters = (bounce_megakernel, bounce_bwd_megakernel_reduced,
                iter_megakernel, bounce_bwd_regen_pre_reduced,
                bounce_bwd_megakernel, bounce_bwd_regen_pre_megakernel)

    cornell, s_c = cornell_scene_and_settings(600, 200, 50, device=dev)
    n_pix = s_c.image_width * s_c.image_height
    s_fb = s_c.replace(rr_depth=FWD_BWD_ROT8["rr_depth"])
    key = rng.base_key(0, dev)
    params, statics = partition(cornell)

    # 29. K7 vs plain on 2^18 lanes of real mid-render states
    n_bwd = FWD_BWD_ROT8["lanes"]
    allm = all_materials_scene(device=dev)
    s_a6 = rt.CameraSettings(background=rt.const_background([0.5, 0.6, 0.7]),
                             image_width=600)
    box, s_box = box_motion_scene(device=dev)
    s_box = s_box.replace(image_width=600)
    mesh, s_mesh = mesh_all_kinds_scene(10, False, 600, device=dev)
    err_k7 = 0.0
    k7_args = None
    for name, sc, s, pixels in (
            ("cornell fwd+bwd", cornell, s_fb, fwd_bwd_pixels(n_pix, n_bwd)),
            ("all-materials", allm, s_a6, None),
            ("all-materials 2 targets", allm,
             s_a6.with_redirect_targets(ALL_MATERIAL_TARGETS), None),
            ("box/motion", box, s_box, None),
            ("box/motion 2 targets", box,
             s_box.with_redirect_targets(ALL_MATERIAL_TARGETS), None),
            ("mixed-kind mesh", mesh, s_mesh, None)):
        args, kw = k7_inputs(sc, s, n_bwd, 4, seed=31,
                             spp=FWD_BWD_ROT8["spp"], pixels=pixels)
        (err, excess), _ = compare_k7(args, kw)
        torch.cuda.synchronize()
        print(f"[K7 vs plain] {name}: {n_bwd} lanes x {kw['n_row'] + 18} "
              f"outputs, {int((args[5] > 0.5).sum())} alive, max |err| "
              f"{err:.3g}, worst excess {excess:.3g} (rtol {BWD_RTOL} of "
              "|plain| + output max + lane max)", flush=True)
        if not excess <= 0.0:
            raise AssertionError(f"K7 vs plain: {name}: out of tolerance")
        tables = row_tables(sc, kw["n_row"])
        err_k7 = max(err_k7, err, _check_reduced(
            f"K7 reduced vs plain: {name}", args, kw, tables))
        if k7_args is None:
            k7_args, k7_kw, k7_tables = args, kw, tables
    phase_done("K7 vs plain")

    # 30./31. routes 8 and 9 at full width, after one warm-up each
    pix = fwd_bwd_pixels(n_pix, n_bwd).to(dev)
    target = torch.zeros((n_bwd, 3), device=dev)

    def runner(cfg, remat=False):
        def run():
            cost = (lane_cost_estimate(cornell, s_fb, key, pix,
                                       spp_est=cfg["spp_est"])
                    if "spp_est" in cfg else None)
            return loss_and_grads(
                params, statics, s_fb, key, pix, target, spp=cfg["spp"],
                n_iters=cfg["n_iters"], remat=remat,
                rotate_k=cfg["rotate_k"], pixel_cost=cost)
        return run

    def route(cfg, remat=False):
        run = runner(cfg, remat)
        run()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        (loss, frac), grads = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        la, l7, lb, l5, l7_lane, l5_lane = (c.launches for c in counters)
        gnp = grads_to_numpy(grads)
        res = dict(seconds=wall, rays_per_s=n_bwd * cfg["spp"] / wall,
                   loss=float(loss), samples_completed=float(frac),
                   launches_a=la, launches_k7=l7,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   finite=all(bool(np.isfinite(v).all())
                              for v in gnp.values()))
        if (not res["finite"] or l7 == 0 or la == 0 or lb or l5 or l7_lane
                or l5_lane):
            raise AssertionError(f"unfused fwd+bwd {cfg}: bad gradients or "
                                 f"launches A={la} K7 reduced={l7} B={lb} "
                                 f"K5={l5} per lane K7={l7_lane} "
                                 f"K5={l5_lane}")
        return res

    def say(label, cfg, r, cost_iters=0):
        n_it = cfg["n_iters"]
        note = ("kernel A and K7 each equal the iteration count"
                if r["launches_a"] - cost_iters == r["launches_k7"] == n_it
                else f"NOT both equal to the {n_it} iterations")
        print(f"[{label}] cornell 600x600 depth 50 rr2, {n_bwd} lanes x "
              f"{cfg['spp']} spp, rotate_k {cfg['rotate_k']}, {n_it} "
              f"iterations: {r['seconds']:.3f} s, "
              f"{r['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
              f"{r['loss']:.6f}, samples_completed "
              f"{r['samples_completed']:.6f}, launches A={r['launches_a']} "
              f"K7 reduced={r['launches_k7']} ({note}; "
              f"{_row_mode_name(cornell)}; K7 per lane 0), peak memory "
              f"{r['peak_bytes'] / 2**30:.3f} GiB [{smi}]", flush=True)

    r8 = route(FWD_BWD_ROT8)
    say("route 8", FWD_BWD_ROT8, r8)
    phase_done("route 8")
    # route 9 runs lane_cost_estimate (kernel A, forward only) inside the
    # timed region: its launches are counted apart
    bounce_megakernel.launches = 0
    with torch.no_grad():
        lane_cost_estimate(cornell, s_fb, key, pix,
                           spp_est=FWD_BWD_BAL4["spp_est"])
    cost_iters = bounce_megakernel.launches
    r9 = route(FWD_BWD_BAL4)
    r9["cost_iterations"] = cost_iters
    say(f"route 9 ({cost_iters} of the kernel A launches are the cost "
        "estimate's)", FWD_BWD_BAL4, r9, cost_iters)
    r8m = route(FWD_BWD_ROT8, remat=True)
    print(f"[route 8 remat] peak memory {r8m['peak_bytes'] / 2**30:.3f} GiB "
          f"with remat=True against {r8['peak_bytes'] / 2**30:.3f} GiB "
          f"without; {r8m['seconds']:.3f} s, loss {r8m['loss']:.6f} (without"
          f" {r8['loss']:.6f}), launches A={r8m['launches_a']} (each "
          f"iteration's forward runs again in the backward) "
          f"K7={r8m['launches_k7']} [{smi}]", flush=True)
    if r8m["loss"] != r8["loss"]:
        raise AssertionError("route 8: remat changed the loss")
    phase_done("routes 9 and 8 remat")

    # route 8 with the backward before the reduction moved into K7 and with
    # the reduced K7, in turns
    turns = _in_turns("route 8", runner(FWD_BWD_ROT8),
                      FWD_BWD_ROT8["n_iters"], smi)
    phase_done("route 8 in turns")

    # 32. at 2^14 lanes: K7 against its plain version, the unfused route
    # against the fused one, a finite difference
    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=8, n_iters=40, remat=False, rotate_k=2)
    k0 = bounce_bwd_megakernel_reduced.launches
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
    with plain_backward():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max(float(np.abs(g_k[k] - g_p[k]).max())
                / max(float(np.abs(g_p[k]).max()), 1e-30) for k in g_p)
    print(f"[unfused fwd+bwd K7 vs plain] {n9} lanes, 8 spp, 40 iterations, "
          f"rotate_k 2: loss {float(l_k):.6f} vs {float(l_p):.6f}, samples "
          f"{float(f_k):.4f}, "
          f"{bounce_bwd_megakernel_reduced.launches - k0} K7 launches, worst "
          f"leaf max|diff|/max|plain| {worst:.3g} (bound {GRAD_RTOL})",
          flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst <= GRAD_RTOL \
            or bounce_bwd_megakernel_reduced.launches - k0 != kw9["n_iters"]:
        raise AssertionError("unfused fwd+bwd: K7 and its plain version "
                             "disagree")
    # rotate_k 2 against the fused rotate_k 1 where every sample completes
    kw_c = dict(spp=8, n_iters=200, remat=False)
    runs = {}
    for rk in (1, 2):
        (loss, frac), g = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, rotate_k=rk, **kw_c)
        with torch.no_grad():
            img, _ = trace_wavefront_diff(cornell, s_fb, key, pix9,
                                          rotate_k=rk, **kw_c)
        runs[rk] = (float(loss), float(frac), grads_to_numpy(g), img)
    (l1, f1, g1, img1), (l2, f2, g2, img2) = runs[1], runs[2]
    worst = max(float(np.abs(g2[k] - g1[k]).max())
                / max(float(np.abs(g1[k]).max()), 1e-30) for k in g1)
    n_diff = int(((img1 - img2).abs().amax(1) > 1e-5).sum())
    rel = abs(l2 / l1 - 1.0)
    print(f"[unfused vs fused] {n9} lanes, 8 spp, 200 iterations: "
          f"samples {f1:.6f} (fused) {f2:.6f} (rotate_k 2), loss rel diff "
          f"{rel:.3g} (bound 1e-4), worst leaf max|diff|/max|fused| "
          f"{worst:.3g} (bound {GRAD_RTOL}); {n_diff} of {n9} lanes resolve "
          "differently (kernels A and B may round the camera differently)",
          flush=True)
    if f1 != 1.0 or f2 != 1.0 or not rel <= 1e-4 or not worst <= GRAD_RTOL:
        raise AssertionError("the unfused and the fused routes disagree")
    # a central finite difference of the red wall's albedo, unfused
    s_fd = s_c.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=8, n_iters=80, remat=False, rotate_k=2)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex = cornell.textures
    red = int(torch.argmax(tex.c0[:, 0] - tex.c0[:, 1]))

    def loss_at(x):
        c0 = tex.c0.clone()
        c0[red, 0] = x[0]
        sc = dataclasses.replace(cornell,
                                 textures=dataclasses.replace(tex, c0=c0))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                         tgt_fd, **kw_fd)[0]
    fd = float(finite_difference(loss_at, tex.c0[red, 0:1].clone(), 1e-2)[0])
    gv = float(g_fd.textures.c0[red, 0])
    print(f"[finite difference, unfused] red wall albedo (texture {red}, red "
          f"channel), rotate_k 2: gradient {gv:.6g}, central difference "
          f"{fd:.6g} (eps 0.01), rel diff {abs(gv - fd) / abs(fd):.3g} "
          f"(bound {FD_RTOL})", flush=True)
    if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
        raise AssertionError("finite difference through the unfused route")
    phase_done("unfused checks at 2^14 lanes")

    # 33. 17 media (F8): renders with every crossing launch checked, of
    # fog balls and boxes (K11) and of rotated boxes (102 rows: K11b)
    k8_l = k11_l = k11b_l = shade_l = 0
    for rotated in (False, True):
        many = rt.compile_scene(many_media_world(rt, 17, rotated), device=dev)
        kname = ("pallas_volume_crossings_bcast" if rotated
                 else "pallas_volume_crossings")
        with checked_launches() as stats:
            acc, total = render_accumulate(many, many_media_settings(
                rt, 400, 4, 10), seed=0, spp=4)
        st_v, st8 = stats[kname], stats["pallas_nearest_record"]
        finite = bool(torch.isfinite(acc).all())
        print(f"[17 media] {many.volumes.n_volumes} media "
              f"({many.volumes.prims.kind.shape[0]} boundary rows) 400x400 "
              f"4 spp depth 10: {st_v['launches']} launches of {kname} (two "
              f"a bounce: 16 + 1 media) over {st8['launches']} iterations, "
              f"every one against its plain version: {st_v['n_int']} "
              f"differing front flags, max |err| {st_v['err']:.3g}; mean "
              f"{float((acc / total).mean()):.6f}, finite {finite}",
              flush=True)
        if (not finite or st_v["launches"] != 2 * st8["launches"]
                or st_v["n_int"] or st_v["err"] or st8["launches"] == 0):
            raise AssertionError("17 media: crossing launches disagree")
        k8_l += st8["launches"]
        shade_l += stats["shade_megakernel"]["launches"]
        if rotated:
            k11b_l += st_v["launches"]
        else:
            k11_l += st_v["launches"]
    phase_done("17 media")

    # 34. K7's time at 2^18 lanes (the Cornell state of phase 29), as
    # K5's in phase 12
    k7_red = lambda: bounce_bwd_megakernel_reduced(
        *reduced_args(k7_args, k7_tables), **k7_kw)
    ms_k7 = _device_ms(k7_red, ("bounce_bwd_replay_kernel", "row_sum_kernel",
                                "row_map_kernel"), 50)
    ms_k7_main = _device_ms(k7_red, "bounce_bwd_replay_kernel", 50)
    host_k7 = _time_ms(k7_red, 50)
    k7_lane = lambda: bounce_bwd_megakernel(*k7_args, **k7_kw)
    ms_k7_lane = _device_ms(k7_lane, "bounce_bwd_replay_kernel", 50)
    host_k7_lane = _time_ms(k7_lane, 50)
    with per_lane_backward():
        from raytrace_tpu_torch.ops import bounce_bwd_kernel as k7_mod
        old_k7 = k7_mod.bounce_bwd_megakernel_reduced
        old_call = lambda: old_k7(*reduced_args(k7_args, k7_tables),
                                  **k7_kw)
        total_old = _device_total_ms(old_call, 10)
        host_old = _time_ms(old_call, 10)
    plain_k7 = _time_ms(lambda: bounce_bwd_megakernel_reduced_plain(
        *reduced_args(k7_args, k7_tables), **k7_kw), 3, 1)
    bound_k7 = _bwd_bound(n_bwd, 32, 11, k7_tables, k7_kw["n_row"])
    print(f"[time] K7 reduced {ms_k7:.4f} ms on the device ({ms_k7_main:.4f}"
          f" ms the kernel, the rest the finishing launches; {host_k7:.4f} ms"
          f" a call back to back) vs its "
          f"plain version {plain_k7:.3f} ms at {n_bwd} lanes, bound "
          f"{bound_k7[0]:.4f} ms ({bound_k7[1]}: 32 columns in, 11 out, the "
          f"table and the reduced tables); before: the per-lane mode "
          f"{ms_k7_lane:.4f} ms on the device ({host_k7_lane:.4f} ms a call), "
          f"with the torch gather and index_add_ around it {total_old:.4f} ms "
          f"of device time a call ({host_old:.4f} ms a call back to back) "
          f"[{smi}]", flush=True)
    phase_done("K7 time")

    summary = dict(route8=r8, route9=r9, route8_remat=r8m,
                   unfused_vs_fused_lanes_differing=n_diff)
    kernel = {"name": "bounce_bwd_megakernel_reduced", "route": "cuda",
              "source": "raytrace_tpu_torch/csrc/bounce_bwd_kernel.cu",
              "replaces": "raytrace_tpu/ops/pallas/bounce_bwd_kernel.py:79",
              "launches": r8["launches_k7"] + r9["launches_k7"],
              "max_abs_err": err_k7, "ms": ms_k7, "host_ms": host_k7,
              "plain_ms": plain_k7, "bound_ms": bound_k7[0],
              "bound_by": bound_k7[1], "library_ms": None,
              "kernel_ms": ms_k7_main, "per_lane_ms": ms_k7_lane,
              "per_lane_host_ms": host_k7_lane,
              "per_lane_with_torch_reduction_ms": total_old,
              "per_lane_with_torch_reduction_host_ms": host_old}
    return dict(summary=summary, kernel=kernel, turns=turns,
                a_launches=r8["launches_a"] + r9["launches_a"],
                k8_launches=k8_l, k11_launches=k11_l, k11b_launches=k11b_l,
                shade_launches=shade_l)


if __name__ == "__main__":
    main()
