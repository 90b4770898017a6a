"""Time and profile the main paths on one CUDA card.

Run from the repository root:

    python3 -m raytrace_tpu_torch.profile_render

For the Cornell box at 600 x 600, depth 50, and each of four runs (the
forward ``render_accumulate`` with seed 1 at 200 spp exact, at 200 spp
with Russian roulette from depth 2 and at 1 spp through the fused branch;
the fwd+bwd ``loss_and_grads`` of ``testing.FWD_BWD``, bench.py's
configuration) it

1. runs it ``REPS`` times in one process and prints every wall time
   (``torch.cuda.synchronize()`` on both ends; the first run of the first
   estimator also warms the process up) with the forward kernels' launch
   counts, which are the iteration counts;
2. runs it once more under ``torch.profiler`` and prints the number of
   device operations per iteration, their summed device time, the
   device's busy share of the best unprofiled wall, the host's kernel
   launch calls, and the device operations that take the most time.

The profiler's table of device operations goes to
``chiprun_out/profile_<estimator>.txt`` in the checkout; the last line is
a JSON object of all of the above.
"""
from __future__ import annotations

import collections
import json
import subprocess
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parent.parent / "chiprun_out"
REPS = 4            # unprofiled runs per estimator


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
    from .ops.bounce_kernel import bounce_megakernel
    from .ops.iter_kernel import iter_megakernel
    from .render.render import render_accumulate
    from .testing import FWD_BWD, cornell_scene_and_settings, fwd_bwd_pixels

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

    params, statics = partition(scene)
    fb_pix = fwd_bwd_pixels(n_pix, FWD_BWD["lanes"]).to(dev)
    fb_target = torch.zeros((FWD_BWD["lanes"], 3), device=dev)

    def fwd_bwd():
        loss_and_grads(params, statics, s.replace(rr_depth=2),
                       rng.base_key(0, dev), fb_pix, fb_target,
                       spp=FWD_BWD["spp"], n_iters=FWD_BWD["n_iters"],
                       remat=False, schedule=FWD_BWD["schedule"])

    def run(fn):
        a0, b0 = bounce_megakernel.launches, iter_megakernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iters = (bounce_megakernel.launches - a0
                 + iter_megakernel.launches - b0)
        return time.perf_counter() - t0, iters

    def fwd(settings, spp):
        return lambda: render_accumulate(scene, settings, seed=1, spp=spp)

    report = {"device": smi, "estimators": {}}
    for name, fn, rays in (
            ("exact", fwd(s, 200), n_pix * 200),
            ("rr2", fwd(s.replace(rr_depth=2), 200), n_pix * 200),
            ("spp1", fwd(s, 1), n_pix),
            ("fwd_bwd", fwd_bwd, FWD_BWD["lanes"] * FWD_BWD["spp"])):
        walls = []
        for _ in range(REPS):
            wall, iters = run(fn)
            walls.append(wall)
        print(f"[walls] {name}: {', '.join(f'{w:.3f}' for w in walls)} s "
              f"(in run order), {iters} iterations, "
              f"{rays / min(walls) / 1e6:.3f} M primary rays/s at the "
              f"best [{smi}]", flush=True)

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
        est = dict(walls_s=walls, iterations=iters, profiled_wall_s=prof_wall,
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
