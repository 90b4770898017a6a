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
checkpointed (``fwdbwd_rot8_remat``), it

1. runs it ``REPS`` times in one process and prints every wall time
   (``torch.cuda.synchronize()`` on both ends; the first run of the first
   estimator also warms the process up) with the forward kernels' launch
   counts, which are the iteration counts, and the peak device memory;
2. runs it once more under ``torch.profiler`` and prints the number of
   device operations per iteration, their summed device time, the
   device's busy share of the best unprofiled wall, the host's kernel
   launch calls, and the device operations that take the most time.

The iteration count is the number of forward kernel launches (kernel A
or B, or a nearest-hit kernel and the mesh iteration kernel; for
``fwdbwd_bal4`` it includes the cost estimate's kernel A launches).

Names of estimators as arguments run only those, e.g.
``python3 -m raytrace_tpu_torch.profile_render fwdbwd_rot8 fwdbwd_bal4``.
The profiler's table of device operations goes to
``chiprun_out/profile_<estimator>.txt`` in the checkout; the last line is
a JSON object of all of the above.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parent.parent / "chiprun_out"
REPS = 4            # unprofiled runs per estimator
# samples per pixel of pawn_fwd (scenes/pawn_test.py renders 400)
PAWN_SPP = 400


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
    from .testing import (
        FWD_BWD, FWD_BWD_BAL4, FWD_BWD_ROT8, IMAGE_GRAD_FWD_BWD,
        MESH_FWD_BWD, bunny_standin_scene,
        cornell_scene_and_settings, cornell_smoke_scene, fwd_bwd_pixels,
        image_grad_scene, noise_test_scene, pawn_standin_scene,
    )
    only = set(sys.argv[1:])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    load_library()
    dev = torch.device("cuda", 0)
    scene, s = cornell_scene_and_settings(600, 200, 50, device=dev)
    n_pix = s.image_width * s.image_height
    OUT_DIR.mkdir(exist_ok=True)

    mesh, s_m = bunny_standin_scene(600, 100, 10, device=dev)
    noise, s_n = noise_test_scene(400, 100, 50, device=dev)
    image, s_i = image_grad_scene(512, device=dev)
    smoke, s_s = cornell_smoke_scene(600, 200, 50, device=dev)
    pawn, s_p = pawn_standin_scene(500, PAWN_SPP, 20, device=dev)
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
        fn()
        torch.cuda.synchronize()
        iters = sum(k.launches - b for k, b in zip(forward_kernels, before))
        return time.perf_counter() - t0, iters

    def fwd(sc, settings, spp, seed=1):
        return lambda: render_accumulate(sc, settings, seed=seed, spp=spp)

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
            ("fwdbwd_rot8", fwd_bwd(scene, s, FWD_BWD_ROT8),
             FWD_BWD_ROT8["lanes"] * FWD_BWD_ROT8["spp"]),
            ("fwdbwd_bal4", fwd_bwd(scene, s, FWD_BWD_BAL4),
             FWD_BWD_BAL4["lanes"] * FWD_BWD_BAL4["spp"]),
            ("fwdbwd_rot8_remat", fwd_bwd(scene, s, FWD_BWD_ROT8, remat=True),
             FWD_BWD_ROT8["lanes"] * FWD_BWD_ROT8["spp"])):
        if only and name not in only:
            continue
        walls = []
        for _ in range(REPS):
            wall, iters = run(fn)
            walls.append(wall)
        peak = torch.cuda.max_memory_allocated()
        print(f"[walls] {name}: {', '.join(f'{w:.3f}' for w in walls)} s "
              f"(in run order), {iters} iterations, "
              f"{rays / min(walls) / 1e6:.3f} M primary rays/s at the "
              f"best, peak memory {peak / 2**30:.3f} GiB [{smi}]", flush=True)

        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_wall, _ = run(fn)
        ops, host_launches = _device_ops(prof)
        n_ops = sum(c for c, _ in ops.values())
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
                   top=[(op[:80], c, us / 1e3) for op, (c, us) in top[:8]])
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
