"""Drive the PyTorch/CUDA port's render paths once on one GPU: the
forward render and the differentiable forward + backward, on the Cornell
box, on a mesh of the Stanford bunny's size and on rich-textured scenes.

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
7. each kernel's time beside its plain version's at the main path's
   360,064 lanes;
8. the backward kernel K5 against its plain version (torch autograd over
   ``lane_math``) on 2^18 lanes of a real mid-render state (kernel B
   steps the fwd+bwd configuration four times; random cotangents): the
   Cornell box, the all-materials scene and the box/motion scene, with 0
   and 2 redirect targets;
9. ``render_loss_wavefront``'s value and gradient at 2^14 lanes, 8 spp,
   40 iterations, with K5 and with the backward forced to its plain
   version: equal losses, gradients within ``GRAD_RTOL``;
10. the second main path: the fwd+bwd of ``bench.py`` (Cornell 600 x
    600, depth 50, RR from depth 2, 2^18 lanes x 64 spp, 205 iterations
    then 25 at 2^14 and 100 at 2^12 lanes) after one warm-up run: wall,
    primary rays/s, loss, samples completed, launches of kernel B and
    K5, peak memory;
11. central finite differences of the loss on the card (2^14 lanes,
    exact estimator, same seed) for the light's emission and the red
    wall's albedo against their gradients;
12. K5's time beside its plain version's at 2^18 lanes.

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
    and K5) after one warm-up; at 2^14 lanes the fwd+bwd with every
    kernel against the one with every plain version; a finite difference
    of the mesh's albedo;
18. the three mesh kernels' times at the slice's shapes beside their
    plain versions' and their bounds (the BVH's operation count from the
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

Then a JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  The rendered images go to
chiprun_out/.  Tolerances (``raytrace_tpu_torch/testing.py``): exact rows
equal on every lane, floats within atol 2e-3 + rtol 1e-3 (the mesh
kernels, K8 and K12, built like the plain versions' arithmetic, are held
to equality: a max |err| of 0); K5 within ``testing.BWD_RTOL`` of each
gradient's scale (the hand-derived adjoint sums the chain-rule terms in
another order than autograd); K13 within ``testing.image_grad_errs`` of
its plain version and of a float64 sum (float atomics add in a varying
order).
"""
from __future__ import annotations

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


def _device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time in ms of the launches of ``kernel`` (a substring
    of its name) over ``reps`` calls of ``fn``, read from torch.profiler:
    a kernel shorter than its wrapper's host cost leaves the card idle
    between back-to-back launches, so CUDA events around them would time
    the host instead."""
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
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(us) != reps:
        raise AssertionError(f"{kernel}: {len(us)} profiled launches of "
                             f"{reps}")
    return sum(us) / reps / 1e3


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
        MEAN_RTOL, all_materials_scene, bounce_inputs, box_motion_scene,
        bwd_inputs, checked_launches, compare_bounce, compare_bwd,
        compare_iter, cornell_scene_and_settings, fresh_carry,
        fwd_bwd_pixels, max_errs, next_bounce_inputs, plain_backward,
        primary_bounce_inputs, stationary_lanes,
    )
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.materials.materials import MAT_LIGHT
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_plain,
    )

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

    # 7. kernel times at the main path's 360,064 lanes
    ms_a = _time_ms(lambda: bounce_megakernel(tb_c.ptbl, tb_c.mtbl,
                                              tb_c.ttbl, *a_args,
                                              **tb_c.kw), 50)
    plain_a = _time_ms(lambda: bounce_plain(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                            *a_args, **tb_c.kw), 5, 1)
    print(f"[time] kernel A {ms_a:.4f} ms vs bounce_plain {plain_a:.3f} ms "
          f"at {lanes} lanes (primary rays) [{smi}]", flush=True)
    b_tables, b_kw = iter_kernel_args(cornell, s_c, rng.base_key(1, dev), 199)
    b_lane = ((torch.from_numpy(lane_pix).to(dev, torch.int32),)
              + fresh_carry(lanes, dev))
    err_b = max(err_b, _check(
        "kernel B vs plain: cornell 600x600 every lane regenerating",
        max_errs(iter_plain(*b_tables, b_lane, **b_kw),
                 iter_megakernel(*b_tables, b_lane, **b_kw), ITER_INT_ROWS),
        lanes))
    ms_b = _time_ms(lambda: iter_megakernel(*b_tables, b_lane, **b_kw), 50)
    plain_b = _time_ms(lambda: iter_plain(*b_tables, b_lane, **b_kw), 5, 1)
    print(f"[time] kernel B {ms_b:.4f} ms vs iter_plain {plain_b:.3f} ms "
          f"at {lanes} lanes (regenerating every lane) [{smi}]", flush=True)

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
    for name, sc, s, pixels in (
            ("cornell fwd+bwd", cornell, s_fb,
             fwd_bwd_pixels(n_pix, n_bwd)),
            ("all-materials", allm, s_a6, None),
            ("all-materials 2 targets", allm,
             s_a6.with_redirect_targets(ALL_MATERIAL_TARGETS), None),
            ("box/motion", box, s_box, None),
            ("box/motion 2 targets", box,
             s_box.with_redirect_targets(ALL_MATERIAL_TARGETS), None)):
        args, kw = bwd_inputs(sc, s, n_bwd, 31, n_iters=4,
                              spp=FWD_BWD["spp"], pixels=pixels)
        (err, excess), _ = compare_bwd(args, kw)
        torch.cuda.synchronize()
        print(f"[K5 vs plain] {name}: {n_bwd} lanes x {kw['n_row'] + 20} "
              f"outputs, {int((args[6] > 0.5).sum())} alive, max |err| "
              f"{err:.3g}, worst excess {excess:.3g} (rtol {BWD_RTOL} of "
              "|plain| + output max + lane max) at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        if not excess <= 0.0:
            raise AssertionError(f"K5 vs plain: {name}: out of tolerance")
        err_k5 = max(err_k5, err)
        if k5_args is None:
            k5_args, k5_kw = args, kw

    phase_done("K5 vs plain")

    # 9. fwd+bwd with K5 against the same with its plain backward
    params, statics = partition(cornell)
    key = rng.base_key(0, dev)
    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=8, n_iters=40, remat=False)
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
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
    bounce_bwd_regen_pre_megakernel.launches = 0
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb_b = iter_megakernel.launches
    fb_k5 = bounce_bwd_regen_pre_megakernel.launches
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
          f" launches B={fb_b} K5={fb_k5}, peak memory {peak / 2**30:.3f} GiB,"
          f" gradients finite {finite} [{smi}]", flush=True)
    if not finite or fb["samples_completed"] < 0.9999 \
            or fb_b != n_expect or fb_k5 != n_expect:
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

    # 12. K5's time at 2^18 lanes (the Cornell fwd+bwd state of phase 8)
    ms_k5 = _time_ms(lambda: bounce_bwd_regen_pre_megakernel(*k5_args,
                                                             **k5_kw), 50)
    plain_k5 = _time_ms(lambda: bounce_bwd_regen_pre_plain(*k5_args,
                                                           **k5_kw), 3, 1)
    n_cols = len(k5_args[3]) + 1 + 3 + 1 + 7 + 3 + 1 + 13
    bound_k5 = _bound_ms(4 * n_bwd * (n_cols + k5_kw["n_row"] + 20),
                         n_bwd * 1000)
    print(f"[time] K5 {ms_k5:.4f} ms vs bounce_bwd_regen_pre_plain "
          f"{plain_k5:.3f} ms at {n_bwd} lanes, bound {bound_k5[0]:.4f} ms "
          f"({bound_k5[1]}: {n_cols} columns in, {k5_kw['n_row'] + 20} out)"
          f" [{smi}]", flush=True)

    phase_done("K5 time")

    mesh = _mesh_phases(smi, phase_done)
    rich = _rich_phases(smi, phase_done, dev)
    main_b += rich["iter_launches"]
    mesh["kernels"][1]["launches"] += rich["shade_launches"]
    mesh["kernels"][2]["launches"] += rich["mesh_iter_launches"]
    print(json.dumps({"main_path": runs, "fwd_bwd": fb,
                      "mesh": mesh["summary"], "rich": rich["summary"],
                      "build_seconds": build_s}), flush=True)
    no_lib = None   # no single PyTorch call computes a bounce
    print(json.dumps({"kernels": [
        {"name": "bounce_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/bounce_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:523",
         "launches": main_a, "max_abs_err": err_a, "ms": ms_a,
         "plain_ms": plain_a, "bound_ms": bound_a[0],
         "bound_by": bound_a[1], "library_ms": no_lib},
        {"name": "iter_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/iter_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/iter_kernel.py:328",
         "launches": main_b, "max_abs_err": err_b, "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bound_b[0],
         "bound_by": bound_b[1], "library_ms": no_lib},
        {"name": "bounce_bwd_regen_pre_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/bounce_bwd_kernel.cu",
         "replaces":
             "raytrace_tpu/ops/pallas/bounce_bwd_gather_kernel.py:497",
         "launches": fb_k5 + mesh["k5_launches"] + rich["k5_launches"],
         "max_abs_err": err_k5,
         "ms": ms_k5, "plain_ms": plain_k5, "bound_ms": bound_k5[0],
         "bound_by": bound_k5[1], "library_ms": no_lib},
    ] + mesh["kernels"] + rich["kernels"]}), flush=True)
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
        bounce_bwd_regen_pre_megakernel,
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
    bounce_bwd_regen_pre_megakernel.launches = 0
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r2_iter = iter_mega_ap.launches
    r2_k5 = bounce_bwd_regen_pre_megakernel.launches
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
          f"K5={r2_k5}, peak memory {peak / 2**30:.3f} GiB, gradients finite "
          f"{finite} [{smi}]", flush=True)
    if not finite or r2_iter != n_expect or r2_k5 != n_expect:
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
    ms_n = _time_ms(lambda: allpairs_nearest_record(tb_m.ptbl, tb_m.bvh,
                                                    *rays, **kw_n), 20)
    plain_n = _time_ms(lambda: allpairs_nearest_plain(tb_m.ptbl, *rays,
                                                      **kw_n), 2, 1)
    nodes_v = float(visits[0].double().mean())
    rows_v = float(visits[1].double().mean())
    tbl_bytes = 4 * (tb_m.ptbl.numel() + tb_m.bvh.nodes.numel()
                     + tb_m.bvh.leaf_rows.numel())
    bound_n = _bound_ms(4 * lanes * (7 + 9) + tbl_bytes,
                        lanes * (NODE_OPS * nodes_v + ROW_OPS * rows_v))
    print(f"[time] nearest kernel {ms_n:.4f} ms vs allpairs_nearest_plain "
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
    ms_s = _time_ms(lambda: shade_megakernel(tb_m.mtbl, tb_m.ttbl, hit, None,
                                             sh_lanes, uni, **kw_s), 50)
    plain_s = _time_ms(lambda: shade_plain(tb_m.mtbl, tb_m.ttbl, hit, None,
                                           sh_lanes, uni, **kw_s), 5, 1)
    bound_s = _bound_ms(4 * lanes * (10 + 10 + 8 + 15), lanes * 300)
    print(f"[time] shade kernel {ms_s:.4f} ms vs shade_plain {plain_s:.3f} ms"
          f" at {lanes} lanes; bound {bound_s[0]:.4f} ms ({bound_s[1]}) "
          f"[{smi}]", flush=True)

    # the mesh variant with every lane regenerating: its rays are the
    # camera rays of sample 0 of its pixels
    n_i = cfg["lanes"]
    tables, kw_i = iter_kernel_args(standin, s_fb, rng.base_key(1, dev), 15)
    lane_in = (pix_fb,) + fresh_carry(n_i, dev)
    c_i, _ = camera_rays(standin, s_m, n_i, 1, pixels=pix_fb)
    _, vis_i = allpairs_nearest_record(tb_m.ptbl, tb_m.bvh, *c_i.unbind(0),
                                       count_visits=True, **kw_n)
    ms_i = _time_ms(lambda: iter_megakernel(*tables, lane_in, **kw_i), 20)
    plain_i = _time_ms(lambda: iter_plain(*tables, lane_in, **kw_i), 2, 1)
    nodes_i = float(vis_i[0].double().mean())
    rows_i = float(vis_i[1].double().mean())
    bound_i = _bound_ms(4 * n_i * (17 + 19) + tbl_bytes,
                        n_i * (450 + NODE_OPS * nodes_i + ROW_OPS * rows_i))
    print(f"[time] mesh iteration kernel {ms_i:.4f} ms vs iter_plain "
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
         "plain_ms": plain_n, "bound_ms": bound_n[0],
         "bound_by": bound_n[1], "library_ms": no_lib},
        {"name": "shade_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/shade_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:616",
         "launches": r1_shade, "max_abs_err": err_s, "ms": ms_s,
         "plain_ms": plain_s, "bound_ms": bound_s[0],
         "bound_by": bound_s[1], "library_ms": no_lib},
        {"name": "iter_mega_ap", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/iter_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/iter_kernel.py:445",
         "launches": r2_iter, "max_abs_err": err_m, "ms": ms_i,
         "plain_ms": plain_i, "bound_ms": bound_i[0],
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
        bounce_bwd_regen_pre_megakernel,
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
                bounce_bwd_regen_pre_megakernel, image_grad_pallas)

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
                  launches_bwd=r4["bounce_bwd_regen_pre_megakernel"],
                  launches_k13=l13, atlas_grad_l1=atlas_l1, peak_bytes=peak)
    print(f"[route 4] image fwd+bwd 512x512, {cfg['lanes']} lanes x "
          f"{cfg['spp']} spp, rr2, {cfg['n_iters']} iterations: {wall:.3f} s, "
          f"{route4['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
          f"{route4['loss']:.6f}, samples_completed {float(frac):.6f}, "
          f"launches B={r4['iter_megakernel']} "
          f"K5={r4['bounce_bwd_regen_pre_megakernel']} K13={l13}, atlas "
          f"gradient L1 {atlas_l1:.6g}, peak memory {peak / 2**30:.3f} GiB, "
          f"gradients finite {finite} [{smi}]", flush=True)
    n_it = cfg["n_iters"]
    if not finite or float(frac) < 0.9999 or atlas_l1 <= 0.0 \
            or l13 != n_it - 1 or r4["iter_megakernel"] != n_it \
            or r4["bounce_bwd_regen_pre_megakernel"] != n_it:
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
                    launches_bwd=rb["bounce_bwd_regen_pre_megakernel"],
                    launches_k13=rb["image_grad_pallas"])
    print(f"[textured mesh fwd+bwd] stand-in with a 128x256 image, "
          f"{cfg_b['lanes']} lanes x {cfg_b['spp']} spp: {wall_b:.3f} s, "
          f"{bunny_fb['rays_per_s'] / 1e6:.3f} M primary rays/s, "
          f"samples_completed {float(frac_b):.6f}, launches mesh iteration="
          f"{rb['iter_mega_ap']} K5={rb['bounce_bwd_regen_pre_megakernel']} "
          f"K13={rb['image_grad_pallas']}, atlas gradient L1 "
          f"{float(np.abs(gnp_b['textures.images']).sum()):.6g}, gradients "
          f"finite {finite_b} [{smi}]", flush=True)
    if not finite_b or rb["iter_mega_ap"] != n_exp \
            or rb["bounce_bwd_regen_pre_megakernel"] != n_exp \
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
         "launches": l8, "max_abs_err": err8, "ms": ms8,
         "plain_ms": plain8, "bound_ms": bound8[0], "bound_by": bound8[1],
         "library_ms": None},
        {"name": "marble_stripe_pallas", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/texture_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/texture_kernel.py:89",
         "launches": l12, "max_abs_err": err12, "ms": ms12,
         "plain_ms": plain12, "bound_ms": bound12[0],
         "bound_by": bound12[1], "library_ms": None},
        {"name": "image_grad_pallas", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/image_grad_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/image_grad_kernel.py:110",
         "launches": l13 + rb["image_grad_pallas"],
         "max_abs_err": max(err13, e64), "ms": ms13, "plain_ms": plain13,
         "bound_ms": bound13[0], "bound_by": bound13[1],
         "library_ms": lib13},
    ]
    summary = dict(route3=route3, route4=route4, textured_mesh=bunny_fb)
    return dict(summary=summary, kernels=kernels, shade_launches=l10,
                iter_launches=r4["iter_megakernel"],
                mesh_iter_launches=rb["iter_mega_ap"],
                k5_launches=r4["bounce_bwd_regen_pre_megakernel"]
                + rb["bounce_bwd_regen_pre_megakernel"])


if __name__ == "__main__":
    main()
