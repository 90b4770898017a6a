"""Time and profile the main paths on one CUDA card.

Run from the repository root:

    python3 -m raytrace_tpu_torch.profile_render

For the Cornell box at 600 x 600, depth 50, and each of four runs (the
forward ``render_accumulate`` with seed 1 at 200 spp exact, at 200 spp
with Russian roulette from depth 2 and at 1 spp through the fused branch;
the fwd+bwd ``loss_and_grads`` of ``testing.FWD_BWD``, bench.py's
configuration), and for the bunny stand-in (``testing.bunny_standin_scene``,
4,992 rows, 600 x 600, depth 10) the split forward at 100 spp exact
(``scenes/bunny_test.py``'s sample count) and the mesh fwd+bwd of
``testing.MESH_FWD_BWD`` (``tools/prof_bunny_grad.py``'s configuration),
and for the rich textures ``scenes/noise_test.py``'s forward (400 x 225,
100 spp, depth 50, seed 0: the flat scan, the shade kernel and the
marble kernel) and ``tools/prof_texture_grad.py``'s image-textured
fwd+bwd (``testing.IMAGE_GRAD_FWD_BWD``), and for the constant-density
media ``scenes/cornell_smoke.py``'s forward (``smoke_fwd``: 600 x 600,
200 spp, depth 50, seed 0: the flat scan, the crossing kernel K11 and
the shade kernel) and the pawn stand-in's (``pawn_fwd``:
``testing.pawn_standin_scene`` at 500 x 500, depth 20, ``PAWN_SPP`` spp,
seed 0, through the sorted driver: the BVH walk, K11b and the shade
kernel), and for the unfused differentiable wavefront the Cornell fwd+bwd
at rotate_k 8 (``fwdbwd_rot8``: ``testing.FWD_BWD_ROT8``,
``tools/prof_diff_rot.py``'s configuration) and at rotate_k 4 balanced by
``lane_cost_estimate``, which each run includes (``fwdbwd_bal4``:
``testing.FWD_BWD_BAL4``, ``tools/prof_completion.py``'s), both through
kernel A forward and K7 backward, and at rotate_k 8 with each iteration
checkpointed (``fwdbwd_rot8_remat``), and for the two BVH walks at
``chip_smoke.py``'s shapes (``mesh_kernels``: 20 launches, in turns, of
the nearest kernel K9 on the stand-in's 360,064 camera rays and of the
mesh iteration kernel on ``MESH_FWD_BWD``'s 2^17 lanes, every lane
regenerating), and for the media crossings and the forward bounce at
``chip_smoke.py``'s shapes (``media_kernels``: 20 launches, in turns, of
K11b on the pawn stand-in's 2^17 camera rays and of K11 on
cornell_smoke's 360,064, through ``render/volumes.py:volume_crossings``,
and of kernel A on Cornell's 360,064 camera lanes, through
``integrator.bounce_mega_soa``; the calls take the same arguments in the
parent tree, so the two trees can be timed in one session; K11 is also
timed with the candidates in torch, ``volume_candidates_kernel``, and,
where the tree has them, in its planar and general instantiations and in
the route's candidate mode, ``medium_hit``), and for K11's general
instantiation (``k11_general``: 20 launches, in turns, on the 2^16
random rays of ``chip_smoke.py`` phase 24 through the fog ball and smoke
box, still and moving, through ``volume_crossings``; also in the parent
tree), and for the fused iteration and the marble stripe
at ``chip_smoke.py``'s shapes (``iter_marble_kernels``: 20 launches, in
turns, of kernel B on Cornell's 360,064 lanes, every lane regenerating,
with the tables of ``fused_iter.iter_kernel_args`` as the fused drivers
pass them, and of K12 on noise_test's 90,112 camera lanes; the calls take
the same arguments in the parent tree), and for the media's gradients
through the generic differentiable bounce the cornell_smoke fwd+bwd
(``smoke_fwdbwd``: ``testing.SMOKE_FWD_BWD``, chip_smoke.py phase 36's
configuration: K8 and the keyed K11 twice an iteration, once forward and
once in the checkpointed iteration's replay), the pawn stand-in's
(``pawn_fwdbwd``: ``testing.PAWN_FWD_BWD``: K9 and the keyed K11b) and
``grad_render`` on cornell_smoke (``smoke_grad_render``:
``testing.SMOKE_GRAD_RENDER``, depth 50, each bounce checkpointed), and
the keyed mode of K11 and K11b against their crossings mode
(``keyed_kernels``: 20 launches of each, in turns, at chip_smoke.py
phase 35's shapes), and for demo2 (``testing.demo2_scene``, the
reference's "everything at once" scene) its forward at the scene's own
settings (``demo2``: 400 x 400, 250 spp, depth 4, seed 1234: the BVH walk
K9 over 1,536 rows, K11's candidate mode for its fog and its blue medium,
the shade kernel, the earth's image and the marble stripes through K12)
and ``grad_render`` over 2^16 pixels spread evenly over the image x 4
samples (``demo2_grad_render``: the generic differentiable bounce, each bounce
checkpointed: K9, the keyed K11, the atlas gradient K13), and for
bigmesh-512 (``testing.bigmesh_scene`` at ``testing.BIGMESH``:
``tools/bench_bigmesh.py`` at 512 x 512 cells, 523,264 triangles, 523,328
kind-segmented rows) its forward at the tool's settings (``bigmesh_fwd``:
512 x 512, 16 spp, depth 8, seed 0: the sorted driver, the split path,
K9 and the shade kernel, with ``pack_bvh`` in every call) and
``grad_render`` over 2^16 pixels spread evenly over the image x 4 samples
(``bigmesh_grad``: ``testing.BIGMESH_GRAD``, the generic differentiable
bounce over K9, each bounce checkpointed), and for demo1
(``scenes/demo1.py``: 512 sphere rows, kernel A's general scan) its
forward at the reference's 1200 x 675, depth 50, seed 1234 and
``DEMO1_SPP`` spp (``demo1_fwd``), and the Cornell box at ``QUEUE_WIDTH``
(112 x 112, 200 spp, depth 50, seed 1: under ``render_accumulate``'s
16,384 pixels of the stationary drivers, so the work-queue driver on
2^17 lanes, kernel A; ``queue_fwd``), and the sharded train step at one rank
(``sharded_trainstep``: ``parallel/sharding.py:sharded_train_step_fn``
without a process group, Adam at lr 0.02, ``testing.FWD_BWD``'s lanes,
spp and iterations without its schedule: kernel B forward, K5 backward,
the update of every float leaf), it

1. runs it ``REPS`` times in one process and prints every wall time
   (``torch.cuda.synchronize()`` on both ends; the first run of the first
   estimator also warms the process up) with the forward kernels' launch
   counts, which are the iteration counts, and the peak device memory;
2. for a forward cell (``render_accumulate``'s: exact, rr2, spp1,
   mesh_fwd, noise_fwd, smoke_fwd, pawn_fwd, queue_fwd, demo2 and
   demo1_fwd) renders once more through ``utils/profiling.py:
   render_with_stats``, the drivers called with ``with_stats``, and
   prints their iterations, segments, lanes, the wavefront occupancy
   (segments / (iterations x lanes)), the mean path length and the ms an
   iteration (the best wall / iterations); it raises unless that image
   is ``render_accumulate``'s up to the order of each pixel's adds (bit
   for bit through the stationary driver; the queue's and the sorted
   driver's ``index_add_`` adds on the card in a varying order);
3. runs it once more under ``torch.profiler`` and prints the number of
   device operations per iteration, their summed device time, the
   device's busy share of the best unprofiled wall, the host's kernel
   launch calls, and the device operations that take the most time.

The iteration count is the number of forward kernel launches (kernel A
or B, or a nearest-hit kernel and the mesh iteration kernel; for
``fwdbwd_bal4`` it includes the cost estimate's kernel A launches; for
the checkpointed generic cells twice the iterations or bounces).
``mesh_kernels`` also prints the box tests and row tests of K9's rays
(all, and those that hit), and every run first prints the compiler's
register, stack and spill report of the two walks' kernels
(``-Xptxas -v``, from ``_build/build.log``).  ``media_kernels`` also
prints kernel A's device time with its 18 Cornell rows and with
``n_prims=0`` through the same wrapper (the shade and the lane I/O
alone), the ``-Xptxas -v`` report of kernel A and the crossing kernels,
and kernel A's SASS: each kernel's instruction count and the span of
each loop (``cuobjdump -sass`` of the build's object).

Names of estimators as arguments run only those, e.g.
``python3 -m raytrace_tpu_torch.profile_render fwdbwd_rot8 fwdbwd_bal4``.
The profiler's table of device operations goes to
``chiprun_out/profile_<estimator>.txt`` in the checkout; the last line is
a JSON object of all of the above.
"""
from __future__ import annotations

import collections
import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parent.parent / "chiprun_out"
REPS = 4            # unprofiled runs per estimator
# samples per pixel of pawn_fwd (scenes/pawn_test.py renders 400)
PAWN_SPP = 400
# samples per pixel of demo1_fwd (scenes/demo1.py renders 500: 47 s a
# run on an H100 80GB HBM3 at 700 W, PERF.md section 6)
DEMO1_SPP = 64
# width of queue_fwd, the Cornell box through the work-queue driver (under
# render_accumulate's 16,384 pixels of the stationary drivers)
QUEUE_WIDTH = 112


def _device_ops(prof):
    """``{name: [count, device us]}`` over the device-side events of a
    profile, and the host's kernel launch calls."""
    from torch.autograd import DeviceType
    ops = collections.defaultdict(lambda: [0, 0.0])
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops[e.name][0] += 1
            ops[e.name][1] += e.time_range.end - e.time_range.start
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    return ops, launches


def ptxas_report(names=("nearest_kernel", "iter_kernel")) -> list[str]:
    """The ``-Xptxas -v`` lines (registers, stack frame, spills) of the
    kernels whose mangled names contain one of ``names``, from the
    build's log."""
    from .ops._build import BUILD_DIR
    out, entry = [], None
    for line in (BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
            entry = name if any(n in name for n in names) else None
        elif entry is not None and ("stack frame" in line
                                    or "Used " in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def sass_text(stem: str) -> str | None:
    """``cuobjdump -sass`` of the build's object of ``csrc/<stem>.cu``, or
    None without the object or the tool."""
    from .ops._build import BUILD_DIR
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    objs = sorted(BUILD_DIR.glob(f"{stem}_*.o"))
    if not objs or not Path(tool).exists():
        return None
    return subprocess.run([tool, "-sass", str(objs[-1])], capture_output=True,
                          text=True, check=True).stdout


_BRA = re.compile(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)")
# what marks a slow path in SASS: a call (the IEEE division's and sqrt's),
# local memory, the constant table of the trigonometric functions'
# Payne-Hanek reduction, a double multiply
_SLOW = ("CALL", "LDL", "STL", "LDG.E.CONSTANT", "DMUL")


def sass_functions(stem: str) -> dict:
    """``{kernel name: [(address, instruction), ...]}`` of the build's
    object of ``csrc/<stem>.cu`` (empty without the object or
    cuobjdump)."""
    sass = sass_text(stem)
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass or "")[1:]:
        out[fn.split("\n", 1)[0].strip()] = [
            (int(a, 16), op) for a, op in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    return out


def sass_loop_spans(ins) -> list[tuple[int, int]]:
    """``(first, last)`` address of each loop: each backward branch and
    its target."""
    spans = []
    for addr, op in ins:
        m = _BRA.search(op)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    return spans


def fast_path_count(ins, lo: int, hi: int) -> int:
    """The instructions of ``ins`` in ``[lo, hi]`` that a thread runs on
    the fast path: those outside every predicated forward branch's span
    that holds a slow-path instruction (``_SLOW``)."""
    skip = []
    for addr, op in ins:
        m = _BRA.search(op)
        if lo <= addr <= hi and m and op.lstrip().startswith("@") \
                and int(m.group(1), 16) > addr:
            end = int(m.group(1), 16)
            if any(s in o for a, o in ins if addr < a < end for s in _SLOW):
                skip.append((addr, end))
    return sum(1 for a, _ in ins if lo <= a <= hi
               and not any(s < a < e for s, e in skip))


def sass_loops(stem: str = "bounce_kernel") -> list[str]:
    """For each kernel of ``csrc/<stem>.cu``: its SASS instruction count
    and, for each backward branch (a loop), the span it closes, its
    instruction count and whether it holds a call (the IEEE division's
    slow path) -- from ``cuobjdump -sass`` of the build's object."""
    fns = sass_functions(stem)
    if not fns:
        return [f"no object of {stem} or no cuobjdump"]
    out = []
    for name, ins in fns.items():
        loops = []
        for lo, addr in sass_loop_spans(ins):
            body = [o for a, o in ins if lo <= a <= addr]
            call = any("CALL" in o for o in body)
            loops.append(f"[{lo:#x}, {addr:#x}] {len(body)} instructions"
                         f"{' with a CALL' if call else ''}")
        out.append(f"{name}: {len(ins)} instructions; loops: "
                   f"{'; '.join(loops) or 'none'}")
    return out


def inner_loop_sizes(stem: str, name: str,
                     op: str = "LDS") -> list[tuple[str, int]]:
    """``(kernel, instructions)`` of the innermost loop that issues an
    ``op`` instruction (the shortest such backward branch's span; by
    default a shared-memory load, so a scan's row loop and not its
    staging loop) of each kernel of ``csrc/<stem>.cu`` whose mangled name
    contains ``name``."""
    out = []
    for fn, ins in sass_functions(stem).items():
        spans = [(lo, hi) for lo, hi in sass_loop_spans(ins)
                 if any(o.split()[0 if not o.startswith("@") else 1]
                        .startswith(op) for a, o in ins if lo <= a <= hi)]
        if name in fn and spans:
            lo, hi = min(spans, key=lambda sp: sp[1] - sp[0])
            out.append((fn, sum(1 for a, _ in ins if lo <= a <= hi)))
    return out


def source_constant(stem: str, name: str) -> int:
    """The value of ``constexpr int <name>`` in ``csrc/<stem>.cu``."""
    from .ops._build import CSRC
    src = (CSRC / f"{stem}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def kernel_ms(fn, kernel, reps: int = 20) -> float:
    """Mean device time in ms of one call of ``fn``'s launches of
    ``kernel`` (a substring of a kernel's name, or a tuple of them: the
    means of each summed) over ``reps`` calls, read from torch.profiler:
    a kernel shorter than its wrapper's host cost leaves the card idle
    between back-to-back launches, so CUDA events around them would time
    the host instead.  The profiler's device trace can drop some events
    of a burst of microsecond launches (31 of 50 seen on an H100), so each
    mean is over the launches it recorded, at least one a name; a session
    that recorded none of a name (seen on an H100 after several long
    sessions in one process) is run again, up to three times, and if
    none records it, a lone ``kernel`` is timed by CUDA events around
    ``reps`` calls (the larger of the host cost and the device time: an
    upper bound, said on stdout)."""
    import torch
    from torch.autograd import DeviceType
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {name: [e.time_range.end - e.time_range.start
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA and name in e.name]
              for name in names}
        if all(us.values()):
            break
    else:
        if len(names) == 1 and not us[names[0]]:
            ms = call_ms(fn, reps, 0)
            print(f"kernel_ms: torch.profiler recorded no launch of "
                  f"{names[0]} in 3 sessions; CUDA events: {ms:.4f} ms a "
                  f"call", flush=True)
            return ms
    total = 0.0
    for name in names:
        if not 0 < len(us[name]) <= reps:
            raise AssertionError(f"{name}: {len(us[name])} profiled launches "
                                 f"of {reps}")
        total += sum(us[name]) / len(us[name]) / 1e3
    return total


def call_ms(fn, reps: int = 50, warmup: int = 2) -> float:
    """Mean time in ms of ``fn``'s calls back to back, between CUDA events
    (after ``warmup`` calls): the larger of its host cost and its device
    time."""
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


def driver_stats(name: str, stats_call, acc, best_wall: float,
                 smi: str) -> dict:
    """The forward drivers' own counts of one render (``stats_call``:
    ``render_with_stats`` with ``render_accumulate``'s arguments):
    iterations, segments, lanes, the wavefront occupancy = segments /
    (iterations x lanes), the mean path length and ``best_wall`` /
    iterations; printed, and returned as a dict.  Raises unless its image
    is ``acc`` (``render_accumulate``'s) up to the order of each pixel's
    adds: on the card the queue and sorted drivers' ``index_add_`` adds
    the paths of a pixel that finish in one iteration in an order that
    varies from run to run, so a pixel's sum of ``spp`` non-negative
    terms may move by up to ``spp * 2^-23`` of itself (the stationary
    drivers' sums are bit-equal)."""
    import torch
    got, st = stats_call()
    spp = st.primary_rays / acc.shape[0]
    diff = (got - acc).abs()
    if not bool((diff <= spp * 2.0 ** -23 * acc.abs()).all()):
        raise AssertionError(f"{name}: render_with_stats' image is not "
                             "render_accumulate's")
    out = dict(iterations=st.iterations, segments=st.path_segments,
               lanes=st.lane_iterations / max(st.iterations, 1),
               occupancy=st.occupancy, mean_path_length=st.mean_path_length,
               ms_per_iteration=best_wall * 1e3 / max(st.iterations, 1),
               stats_wall_s=st.wall_s, bit_equal=bool(torch.equal(got, acc)),
               max_abs_diff=float(diff.max()))
    print(f"[stats] {name}: {out['iterations']} iterations, "
          f"{out['segments']} segments, {out['lanes']:.0f} lanes, occupancy "
          f"{out['occupancy']:.4f}, mean path length "
          f"{out['mean_path_length']:.3f}, {out['ms_per_iteration']:.4f} ms "
          f"an iteration (best wall / iterations; the counted run "
          f"{st.wall_s:.3f} s, its image render_accumulate's bit for bit: "
          f"{out['bit_equal']}, max |diff| {out['max_abs_diff']:.3g}) "
          f"[{smi}]", flush=True)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_render: needs a CUDA device")
    from .core import rng
    from .diff.gradients import loss_and_grads, partition
    from .ops._build import load_library
    from .ops.allpairs_kernel import allpairs_nearest_record
    from .ops.bounce_kernel import bounce_megakernel
    from .ops.intersect_kernel import pallas_nearest_record
    from .ops.iter_kernel import iter_mega_ap, iter_megakernel
    from .render.render import render_accumulate
    from .render.integrator import lane_cost_estimate
    from .utils.profiling import render_with_stats
    from .testing import (
        BIGMESH_GRAD, DEMO2_GRAD, DEMO2_SEED, FWD_BWD, FWD_BWD_BAL4, FWD_BWD_ROT8,
        IMAGE_GRAD_FWD_BWD,
        MESH_FWD_BWD, PAWN_FWD_BWD, SMOKE_FWD_BWD, SMOKE_GRAD_RENDER,
        bunny_standin_scene, cornell_scene_and_settings, cornell_smoke_scene,
        fwd_bwd_pixels, image_grad_scene, noise_test_scene,
        demo2_scene, pawn_standin_scene,
    )
    only = set(sys.argv[1:])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    load_library()
    for line in ptxas_report():
        print(f"[ptxas] {line}", flush=True)
    dev = torch.device("cuda", 0)
    scene, s = cornell_scene_and_settings(600, 200, 50, device=dev)
    n_pix = s.image_width * s.image_height
    OUT_DIR.mkdir(exist_ok=True)

    mesh, s_m = bunny_standin_scene(600, 100, 10, device=dev)
    noise, s_n = noise_test_scene(400, 100, 50, device=dev)
    image, s_i = image_grad_scene(512, device=dev)
    smoke, s_s = cornell_smoke_scene(600, 200, 50, device=dev)
    pawn, s_p = pawn_standin_scene(500, PAWN_SPP, 20, device=dev)
    demo2, s_d = demo2_scene(device=dev)
    queue, s_q = cornell_scene_and_settings(QUEUE_WIDTH, 200, 50, device=dev)
    forward_kernels = (bounce_megakernel, iter_megakernel,
                       allpairs_nearest_record, pallas_nearest_record,
                       iter_mega_ap)

    def fwd_bwd(sc, settings, cfg, remat=False):
        params, statics = partition(sc)
        pix = fwd_bwd_pixels(settings.image_width * settings.image_height,
                             cfg["lanes"]).to(dev)
        target = torch.zeros((cfg["lanes"], 3), device=dev)
        s_cfg = settings.replace(rr_depth=cfg.get("rr_depth",
                                                  settings.rr_depth))
        key = rng.base_key(0, dev)

        def run():
            cost = (lane_cost_estimate(sc, s_cfg, key, pix,
                                       spp_est=cfg["spp_est"])
                    if "spp_est" in cfg else None)
            return loss_and_grads(
                params, statics, s_cfg, key, pix, target, spp=cfg["spp"],
                n_iters=cfg["n_iters"], remat=remat,
                schedule=cfg.get("schedule"),
                rotate_k=cfg.get("rotate_k", 1), pixel_cost=cost)
        return run

    def run(fn):
        before = [k.launches for k in forward_kernels]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        iters = sum(k.launches - b for k, b in zip(forward_kernels, before))
        return time.perf_counter() - t0, iters, out

    def fwd(sc, settings, spp, seed=1):
        """``render_accumulate``'s call, with the same render through
        ``render_with_stats`` as its ``stats`` attribute."""
        call = lambda: render_accumulate(sc, settings, seed=seed, spp=spp)
        call.stats = lambda: render_with_stats(sc, settings, seed, spp=spp)
        return call

    @functools.cache
    def mesh_kernel_calls():
        """K9 and the mesh iteration kernel at chip_smoke.py's shapes: the
        call of 20 launches of each, its inputs made (and K9's visits
        printed) once."""
        from .diff.fused_iter import iter_kernel_args
        from .render.integrator import split_tables
        from .testing import camera_rays, fresh_carry
        tb = split_tables(mesh, s_m)
        n_r = -(-n_pix // 128) * 128
        rays = tuple(camera_rays(mesh, s_m, n_r, 61)[0].unbind(0))
        kw_n = dict(n_prims=tb.n_prims, t_min=tb.t_min,
                    has_motion=tb.has_motion)
        out, vis = allpairs_nearest_record(tb.ptbl, tb.bvh, *rays,
                                           count_visits=True, **kw_n)
        hit = out[1] >= 0
        v = vis.double()
        print(f"[visits] K9 on {n_r} camera rays of the stand-in: box tests "
              f"{float(v[0].mean()):.3f}, rows {float(v[1].mean()):.3f} a "
              f"ray; rays that hit ({float(hit.double().mean()):.4f}): box "
              f"tests {float(v[0][hit].mean()):.3f}, rows "
              f"{float(v[1][hit].mean()):.3f} [{smi}]", flush=True)
        n_i = MESH_FWD_BWD["lanes"]
        s_fb = s_m.replace(rr_depth=MESH_FWD_BWD["rr_depth"])
        tables, kw_i = iter_kernel_args(mesh, s_fb, rng.base_key(1, dev), 15)
        pix = (torch.arange(n_i) % n_pix).to(dev, torch.int32)
        lane_in = (pix,) + fresh_carry(n_i, dev)

        def run_kernels():
            # alternating: the profiler's trace can drop a burst's first
            # events, and each kernel's mean is over those it recorded
            for _ in range(20):
                allpairs_nearest_record(tb.ptbl, tb.bvh, *rays, **kw_n)
                iter_megakernel(*tables, lane_in, **kw_i)
        return run_kernels

    @functools.cache
    def media_kernel_calls():
        """K11b on the pawn stand-in's 2^17 camera rays (phase 24 of
        chip_smoke.py), K11 on cornell_smoke's 360,064 camera rays (its
        crossings through ``volume_crossings`` and, with the candidates
        in torch, through ``volume_candidates_kernel``) and kernel A on
        Cornell's 360,064 camera lanes (phase 3): the call of 20 launches
        of each, its inputs made (and kernel A's split and K11's designs
        printed) once."""
        from .ops.bounce_kernel import bounce_megakernel
        from .render import volumes
        from .render.integrator import bounce_mega_soa, bounce_tables
        from .render.volumes import (
            volume_candidates_kernel, volume_crossings, volume_tables,
        )
        from .testing import (
            media_bounce_rays, primary_bounce_inputs, stationary_lanes,
        )
        n_k = 1 << 17
        n_pix_p = s_p.image_width * s_p.image_height
        pix = (torch.arange(n_k) * n_pix_p // n_k).to(dev, torch.int32)
        rays = tuple(media_bounce_rays(pawn, s_p, 82, pixels=pix)[0][0]
                     .unbind(0))
        vt = volume_tables(pawn.volumes)
        comps_s = media_bounce_rays(smoke, s_s, 81)[0][0]
        rays_s = tuple(comps_s.unbind(0))
        vt_s = volume_tables(smoke.volumes)
        nv_s = smoke.volumes.n_volumes
        g = torch.Generator().manual_seed(91)
        u_s = (torch.randint(0, 1 << 16, (nv_s, comps_s.shape[1]),
                             generator=g) / 65536.0).to(dev)
        k11 = lambda: volume_crossings(smoke.volumes, rays_s, s_s.t_min,
                                       vt_s)
        k11_cand = lambda: volume_candidates_kernel(
            smoke.volumes, comps_s[0:3], comps_s[3:6], comps_s[6],
            s_s.t_min, u_s, tables=vt_s)
        tb = bounce_tables(scene, s)
        a = primary_bounce_inputs(scene, s, 1)
        comps = torch.stack(a[0:7])
        thr = torch.stack(a[7:10])
        rad = torch.zeros_like(thr)
        alive = a[10] > 0.5
        for line in ptxas_report(("bounce_kernel", "volume_")):
            print(f"[ptxas] {line}", flush=True)
        for line in sass_loops():
            print(f"[sass] {line}", flush=True)
        full = kernel_ms(lambda: bounce_mega_soa(
            scene, s, comps, a[11], rad, thr, alive, tables=tb),
            "bounce_kernel")
        no_rows = kernel_ms(lambda: bounce_megakernel(
            tb.ptbl, tb.mtbl, tb.ttbl, *a, **dict(tb.kw, n_prims=0)),
            "bounce_kernel")
        print(f"[split] kernel A at {comps.shape[1]} Cornell camera lanes: "
              f"{full:.4f} ms with its {tb.n_prims} rows, {no_rows:.4f} ms "
              f"with n_prims=0 (the shade and the lane I/O) [{smi}]",
              flush=True)
        n_s = comps_s.shape[1]
        for name, call, kernel in (
                ("K11 crossings", k11, "volume_crossings_kernel"),
                ("K11 crossings + torch candidates", k11_cand,
                 "volume_crossings_kernel")):
            print(f"[kernel] {name} at {n_s} cornell_smoke camera rays: "
                  f"{kernel_ms(call, kernel):.4f} ms on the device, "
                  f"{min(call_ms(call) for _ in range(5)):.4f} ms a call back "
                  f"to back (the least of 5 turns of 50) [{smi}]", flush=True)
        if hasattr(volumes, "medium_hit"):
            k11_designs(comps_s, u_s, vt_s, rays, vt)

        def run_kernels():
            for _ in range(20):
                volume_crossings(pawn.volumes, rays, s_p.t_min, vt)
                k11()
                bounce_mega_soa(scene, s, comps, a[11], rad, thr, alive,
                                tables=tb)
        return run_kernels

    def k11_designs(comps_s, u_s, vt_s, rays_p, vt_p):
        """K11 on cornell_smoke's camera rays (crossings mode, device ms)
        in its planar and general instantiations; then the route's
        candidate mode (``medium_hit``: device ms and a call back to back)
        of K11 and of K11b on the pawn stand-in's camera rays, and the
        SASS instructions of each K11 instantiation's row loop (also
        written to chiprun_out/sass_volume_kernel.txt)."""
        import dataclasses
        from .ops.volume_kernel import prepare_volume_launch
        from .render.volumes import medium_hit, volume_crossings
        rays_s = tuple(comps_s.unbind(0))
        x = vt_s.launches[0]
        for general in (False, True):
            launch = prepare_volume_launch(
                x.vtbl, None, slices=x.slices, has_motion=x.has_motion,
                has_box=x.has_box, density=x.density, mats=x.mats,
                general=general)
            tables = dataclasses.replace(vt_s, launches=(launch,))
            ms = kernel_ms(lambda: volume_crossings(
                smoke.volumes, rays_s, s_s.t_min, tables),
                "volume_crossings_kernel")
            print(f"[K11 design] {'general' if general else 'planar'}: "
                  f"{ms:.4f} ms on the device [{smi}]", flush=True)
        n_p = rays_p[0].shape[0]
        u_p = u_s[:pawn.volumes.n_volumes, :n_p].contiguous()
        for name, n, call, kernel in (
                ("K11 candidate mode", comps_s.shape[1],
                 lambda: medium_hit(smoke.volumes, rays_s, s_s.t_min, u_s,
                                    vt_s), "volume_crossings_kernel"),
                ("K11b candidate mode (pawn stand-in)", n_p,
                 lambda: medium_hit(pawn.volumes, rays_p, s_p.t_min, u_p,
                                    vt_p), "volume_bvh_kernel")):
            print(f"[kernel] {name} at {n} camera rays: "
                  f"{kernel_ms(call, kernel):.4f} ms on the device, "
                  f"{min(call_ms(call) for _ in range(5)):.4f} ms a call back "
                  f"to back (the least of 5 turns of 50) [{smi}]", flush=True)
        rays = source_constant("volume_kernel", "kRays")
        for name, count in inner_loop_sizes("volume_kernel",
                                            "volume_crossings_kernel"):
            print(f"[sass] {name}: its row loop {count} instructions for "
                  f"{rays} rays", flush=True)
        (OUT_DIR / "sass_volume_kernel.txt").write_text(
            sass_text("volume_kernel") or "")

    @functools.cache
    def k11_general_calls():
        """K11 on the fog ball and smoke box, still and moving (its
        general instantiation with box rows, and with motion), at the
        2^16 random rays of chip_smoke.py phase 24: the call of 20
        launches of each, its inputs made (and each call's device and
        back-to-back time, the kernels' registers and row-loop SASS
        printed) once."""
        import raytrace_tpu_torch as rt
        from .ops._build import CSRC
        from .render.volumes import volume_crossings, volume_tables
        from .testing import volume_rays, volume_test_world
        calls = []
        for moving in (False, True):
            world = rt.compile_scene(volume_test_world(rt, moving),
                                     device=dev)
            rays = tuple(volume_rays(1 << 16, 84 + moving, (-6.0, 6.0),
                                     ([0.0, 0.0, -3.0], [3.2, 0.0, -3.5]),
                                     device=dev).unbind(0))
            tables = volume_tables(world.volumes)
            calls.append((f"fog ball and smoke box{' moving' * moving} "
                          f"({world.volumes.counts} rows)",
                          lambda v=world.volumes, r=rays, t=tables:
                          volume_crossings(v, r, 1e-3, t)))
        # rays a thread (a tree without kRays runs one)
        m = re.search(r"constexpr int kRays = (\d+);",
                      (CSRC / "volume_kernel.cu").read_text())
        per = int(m.group(1)) if m else 1
        for line in ptxas_report(("volume_crossings_kernel",)):
            print(f"[ptxas] {line}", flush=True)
        for name, count in inner_loop_sizes("volume_kernel",
                                            "volume_crossings_kernel"):
            print(f"[sass] {name}: its row loop {count} instructions for "
                  f"{per} rays", flush=True)
        for name, call in calls:
            ms = kernel_ms(call, "volume_crossings_kernel")
            print(f"[kernel] K11 ({per} rays a thread) on {name}, 65536 "
                  f"random rays: {ms:.4f} ms on the device, "
                  f"{min(call_ms(call) for _ in range(5)):.4f} ms a call back "
                  f"to back (the least of 5 turns of 50) [{smi}]", flush=True)

        def run_kernels():
            for _ in range(20):
                for _, call in calls:
                    call()
        return run_kernels

    def smoke_grad_render():
        from .diff.gradients import grad_render
        n_t = SMOKE_GRAD_RENDER["pixels"]
        pix = torch.arange(n_t, dtype=torch.int32, device=dev)
        smp = torch.arange(SMOKE_GRAD_RENDER["samples"], dtype=torch.int32)
        target = torch.zeros((n_t, 3), device=dev)
        return lambda: grad_render(smoke, s_s, rng.base_key(2, dev), pix,
                                   smp, target)

    def demo2_grad_render():
        from .diff.gradients import grad_render
        n_img = s_d.image_width * s_d.image_height
        pix = (torch.arange(DEMO2_GRAD["pixels"], device=dev) * n_img
               // DEMO2_GRAD["pixels"]).to(torch.int32)
        smp = torch.arange(DEMO2_GRAD["samples"], dtype=torch.int32)
        target = torch.zeros((DEMO2_GRAD["pixels"], 3), device=dev)
        return lambda: grad_render(demo2, s_d, rng.base_key(3, dev), pix,
                                   smp, target)

    @functools.cache
    def bigmesh():
        from .testing import BIGMESH, bigmesh_scene
        return bigmesh_scene(BIGMESH["n_lat"], BIGMESH["n_lon"], device=dev)

    def bigmesh_grad():
        from .diff.gradients import grad_render
        sc, st = bigmesh()
        n_img = st.image_width * st.image_height
        pix = (torch.arange(BIGMESH_GRAD["pixels"], device=dev) * n_img
               // BIGMESH_GRAD["pixels"]).to(torch.int32)
        smp = torch.arange(BIGMESH_GRAD["samples"], dtype=torch.int32)
        target = torch.zeros((BIGMESH_GRAD["pixels"], 3), device=dev)
        return grad_render(sc, st, rng.base_key(5, dev), pix, smp, target)

    @functools.cache
    def keyed_kernel_calls():
        """K11 on cornell_smoke's 360,064 camera rays (planar) and K11b on
        the pawn stand-in's 2^17, each in the keyed mode and the crossings
        mode in turns, through ``render/volumes.py``
        (``volume_crossings_keyed``, ``volume_crossings``): the call of 20
        launches of each, its inputs made (and each call's device and
        back-to-back time printed) once."""
        from .render.volumes import (
            volume_crossings, volume_crossings_keyed, volume_tables,
        )
        from .testing import camera_rays, stationary_lanes
        _, lanes, lane_pix = stationary_lanes(s_s)
        rays_s = tuple(camera_rays(smoke, s_s, lanes, 101, pixels=torch
                                   .from_numpy(lane_pix))[0].unbind(0))
        n_k = 1 << 17
        n_pix_p = s_p.image_width * s_p.image_height
        pix = (torch.arange(n_k) * n_pix_p // n_k).to(torch.int32)
        rays_p = tuple(camera_rays(pawn, s_p, n_k, 102, pixels=pix)[0]
                       .unbind(0))
        vt_s, vt_p = volume_tables(smoke.volumes), volume_tables(pawn.volumes)
        calls = (
            ("K11 keyed", lambda: volume_crossings_keyed(
                smoke.volumes, rays_s, s_s.t_min, vt_s),
             "volume_crossings_kernel", lanes),
            ("K11 crossings", lambda: volume_crossings(
                smoke.volumes, rays_s, s_s.t_min, vt_s),
             "volume_crossings_kernel", lanes),
            ("K11b keyed", lambda: volume_crossings_keyed(
                pawn.volumes, rays_p, s_p.t_min, vt_p),
             "volume_bvh_kernel", n_k),
            ("K11b crossings", lambda: volume_crossings(
                pawn.volumes, rays_p, s_p.t_min, vt_p),
             "volume_bvh_kernel", n_k))
        for name, call, kernel, n in calls:
            print(f"[kernel] {name} at {n} camera rays: "
                  f"{kernel_ms(call, kernel):.4f} ms on the device, "
                  f"{min(call_ms(call) for _ in range(5)):.4f} ms a call back "
                  f"to back (the least of 5 turns of 50) [{smi}]", flush=True)

        def run_kernels():
            for _ in range(20):
                for _, call, _, _ in calls:
                    call()
        return run_kernels

    @functools.cache
    def iter_marble_calls():
        """Kernel B on Cornell's 360,064 lanes, every lane regenerating,
        through ``fused_iter.iter_kernel_args`` as the fused drivers call
        it (phase 7 of chip_smoke.py), and K12 on noise_test's 90,112
        camera lanes (phase 23): the call of 20 launches of each, its
        inputs made (and each kernel's device and back-to-back call time,
        registers and SASS printed) once."""
        from .diff.fused_iter import iter_kernel_args
        from .ops.texture_kernel import marble_stripe_pallas, marble_table
        from .render.integrator import split_tables
        from .testing import (
            camera_rays, fresh_carry, stationary_lanes, surface_points,
        )
        _, lanes, lane_pix = stationary_lanes(s)
        tables, kw = iter_kernel_args(scene, s, rng.base_key(1, dev), 199)
        lane_in = ((torch.from_numpy(lane_pix).to(dev, torch.int32),)
                   + fresh_carry(lanes, dev))
        _, lanes_n, lane_pix_n = stationary_lanes(s_n)
        comps, _ = camera_rays(noise, s_n, lanes_n, 71,
                               pixels=torch.from_numpy(lane_pix_n))
        pts, hit = surface_points(split_tables(noise, s_n), comps)
        tid = noise.materials.tex[hit[8].long()]
        mtbl = marble_table(noise.textures)
        n_m = int(torch.isin(tid.to(torch.float32), mtbl[:, 0]).sum())
        for line in ptxas_report(("iter_kernel", "marble_kernel")):
            print(f"[ptxas] {line}", flush=True)
        for stem in ("iter_kernel", "texture_kernel"):
            for line in sass_loops(stem):
                print(f"[sass] {line}", flush=True)
        b_call = lambda: iter_megakernel(*tables, lane_in, **kw)
        k12_call = lambda: marble_stripe_pallas(noise.textures, tid, pts,
                                                mtbl)
        for name, call, kernel, n in (
                ("kernel B", b_call, "iter_kernel",
                 f"{lanes} Cornell lanes"),
                ("K12", k12_call, "marble_kernel",
                 f"{lanes_n} noise_test camera lanes, {n_m} marble")):
            print(f"[kernel] {name} at {n}: {kernel_ms(call, kernel):.4f} ms "
                  f"on the device, {min(call_ms(call) for _ in range(5)):.4f}"
                  f" ms a call back to back (the least of 5 turns of 50) "
                  f"[{smi}]", flush=True)

        def run_kernels():
            for _ in range(20):
                b_call()
                k12_call()
        return run_kernels

    def demo1_fwd():
        from types import SimpleNamespace
        from .scenes import demo1
        sc, settings, seed = demo1.build(SimpleNamespace(
            width=1200, spp=DEMO1_SPP, depth=50, device=dev))
        return fwd(sc, settings, DEMO1_SPP, seed=seed)

    def sharded_trainstep():
        from .parallel.sharding import make_mesh, sharded_train_step_fn
        step = sharded_train_step_fn(
            make_mesh(), s.replace(rr_depth=FWD_BWD["rr_depth"]),
            spp=FWD_BWD["spp"], n_iters=FWD_BWD["n_iters"],
            optimizer=lambda ps: torch.optim.Adam(ps, lr=0.02))
        pix = fwd_bwd_pixels(n_pix, FWD_BWD["lanes"]).to(dev)
        target = torch.zeros((FWD_BWD["lanes"], 3), device=dev)
        state = step.init(scene)
        return lambda: step.with_state(scene, state, rng.base_key(0, dev),
                                       pix, None, target)

    report = {"device": smi, "estimators": {}}
    for name, fn, rays in (
            ("exact", fwd(scene, s, 200), n_pix * 200),
            ("rr2", fwd(scene, s.replace(rr_depth=2), 200), n_pix * 200),
            ("spp1", fwd(scene, s, 1), n_pix),
            ("fwd_bwd", fwd_bwd(scene, s, FWD_BWD),
             FWD_BWD["lanes"] * FWD_BWD["spp"]),
            ("mesh_fwd", fwd(mesh, s_m, 100), n_pix * 100),
            ("mesh_fwd_bwd", fwd_bwd(mesh, s_m, MESH_FWD_BWD),
             MESH_FWD_BWD["lanes"] * MESH_FWD_BWD["spp"]),
            ("noise_fwd", fwd(noise, s_n, 100, seed=0),
             s_n.image_width * s_n.image_height * 100),
            ("image_fwd_bwd", fwd_bwd(image, s_i, IMAGE_GRAD_FWD_BWD),
             IMAGE_GRAD_FWD_BWD["lanes"] * IMAGE_GRAD_FWD_BWD["spp"]),
            ("smoke_fwd", fwd(smoke, s_s, 200, seed=0), n_pix * 200),
            ("pawn_fwd", fwd(pawn, s_p, PAWN_SPP, seed=0),
             s_p.image_width * s_p.image_height * PAWN_SPP),
            ("queue_fwd", fwd(queue, s_q, 200), QUEUE_WIDTH ** 2 * 200),
            ("fwdbwd_rot8", fwd_bwd(scene, s, FWD_BWD_ROT8),
             FWD_BWD_ROT8["lanes"] * FWD_BWD_ROT8["spp"]),
            ("fwdbwd_bal4", fwd_bwd(scene, s, FWD_BWD_BAL4),
             FWD_BWD_BAL4["lanes"] * FWD_BWD_BAL4["spp"]),
            ("fwdbwd_rot8_remat", fwd_bwd(scene, s, FWD_BWD_ROT8, remat=True),
             FWD_BWD_ROT8["lanes"] * FWD_BWD_ROT8["spp"]),
            ("mesh_kernels", lambda: mesh_kernel_calls()(), 0),
            ("media_kernels", lambda: media_kernel_calls()(), 0),
            ("k11_general", lambda: k11_general_calls()(), 0),
            ("iter_marble_kernels", lambda: iter_marble_calls()(), 0),
            ("smoke_fwdbwd", fwd_bwd(smoke, s_s, SMOKE_FWD_BWD, remat=True),
             SMOKE_FWD_BWD["lanes"] * SMOKE_FWD_BWD["spp"]),
            ("pawn_fwdbwd", fwd_bwd(pawn, s_p, PAWN_FWD_BWD, remat=True),
             PAWN_FWD_BWD["lanes"] * PAWN_FWD_BWD["spp"]),
            ("smoke_grad_render", smoke_grad_render(),
             SMOKE_GRAD_RENDER["pixels"] * SMOKE_GRAD_RENDER["samples"]),
            ("keyed_kernels", lambda: keyed_kernel_calls()(), 0),
            ("demo2", fwd(demo2, s_d, s_d.samples_per_pixel,
                          seed=DEMO2_SEED),
             s_d.image_width * s_d.image_height * s_d.samples_per_pixel),
            ("demo2_grad_render", demo2_grad_render(),
             DEMO2_GRAD["pixels"] * DEMO2_GRAD["samples"]),
            ("bigmesh_fwd", lambda: render_accumulate(*bigmesh(), seed=0),
             512 * 512 * 16),
            ("bigmesh_grad", bigmesh_grad,
             BIGMESH_GRAD["pixels"] * BIGMESH_GRAD["samples"]),
            ("demo1_fwd", demo1_fwd(), 1200 * 675 * DEMO1_SPP),
            ("sharded_trainstep", sharded_trainstep(),
             FWD_BWD["lanes"] * FWD_BWD["spp"])):
        if only and name not in only:
            continue
        walls = []
        for _ in range(REPS):
            wall, iters, out = run(fn)
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated()
        rate = (f"{rays / min(walls) / 1e6:.3f} M primary rays/s at the "
                f"best, " if rays else "")
        print(f"[walls] {name}: {', '.join(f'{w:.3f}' for w in walls)} s "
              f"(in run order), {iters} iterations, {rate}peak memory "
              f"{peak / 2**30:.3f} GiB [{smi}]", flush=True)
        occ = (driver_stats(name, fn.stats, out[0], min(walls), smi)
               if hasattr(fn, "stats") else None)

        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_wall, _, _ = run(fn)
        ops, host_launches = _device_ops(prof)
        n_ops = sum(c for c, _ in ops.values())
        # a kernel cell that launches no forward kernel counts one
        # iteration a call
        iters = iters or 1
        dev_s = sum(us for _, us in ops.values()) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1][1])
        with open(OUT_DIR / f"profile_{name}.txt", "w") as f:
            f.write(f"# {name}: {smi}; profiled wall {prof_wall:.3f} s, "
                    f"{iters} iterations\n# count  device_ms  share  name\n")
            for op, (c, us) in top:
                f.write(f"{c:8d} {us / 1e3:10.3f} {us / 1e6 / dev_s:6.3f}  "
                        f"{op}\n")
        est = dict(walls_s=walls, iterations=iters, peak_bytes=peak,
                   profiled_wall_s=prof_wall,
                   device_ops=n_ops, device_ops_per_iter=n_ops / iters,
                   device_s=dev_s, busy_of_best_wall=dev_s / min(walls),
                   host_kernel_launches=host_launches,
                   top=[(op[:80], c, us / 1e3) for op, (c, us) in top[:8]],
                   driver_stats=occ)
        report["estimators"][name] = est
        print(f"[profile] {name}: profiled wall {prof_wall:.3f} s; "
              f"{n_ops} device ops ({n_ops / iters:.1f} per iteration), "
              f"{dev_s:.4f} s of device time = {dev_s / min(walls):.3f} of "
              f"the best unprofiled wall; {host_launches} host kernel "
              f"launches", flush=True)
        for op, (c, us) in top[:8]:
            print(f"    {us / 1e3:10.3f} ms {us / 1e6 / dev_s:6.1%} "
                  f"x{c:<7d} {op[:100]}", flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
