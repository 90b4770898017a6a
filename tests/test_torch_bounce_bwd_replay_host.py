"""K7's CUDA source, compiled for the host, against its plain version.

The body of ``rt_bounce_bwd_replay`` in ``csrc/bounce_bwd_kernel.cu``
(``lane_adjoint.cuh``'s hand-derived adjoint over the saved inputs of one
unfused bounce) is plain C++ once ``__device__`` and the launch indices
are defined for the host (``testing.host_library``), so the host C++
compiler builds it and runs its per-lane mode lane by lane, one block of
one thread looping over the lanes.  On the CPU that holds the kernel's arithmetic against torch
autograd over ``lane_math`` (``bounce_bwd_megakernel_plain``) before any
card sees it; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
kernel itself against the same plain version on the card.

States (``testing.k7_inputs``): 2048 lanes of the unfused driver's
mid-render states, after 0 and 5 kernel-A steps, on the Cornell box (one
redirect target, RR from depth 2), the all-materials scene (two targets,
sky), the box/motion scene (no target, gray fade) and a 384-row mesh at
2 spp (ROADMAP F9: dead lanes parked at 3e18 read a sphere row).  Tolerance:
``testing.bwd_errs`` with ``BWD_RTOL`` on every lane and output (the
build uses ``-ffp-contract=off``, as the card's uses ``--fmad=false``;
the adjoint sums its chain-rule terms in another order than autograd);
the miss flag exactly.
"""
import ctypes

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import bounce_bwd_kernel as k7
from raytrace_tpu_torch.ops.row_reduce import per_lane_args
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, all_materials_scene, box_motion_scene, bwd_errs,
    cornell_scene_and_settings, host_library, k7_inputs,
    mesh_all_kinds_scene, torch_threads,
)

_RUN = r"""
extern "C" int run_replay(const ReplayArgs* a) {
  blockDim.x = gridDim.x = 1;
  threadIdx.x = blockIdx.x = 0;
  bounce_bwd_replay_kernel(*a);
  return 0;
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def host_k7(tmp_path_factory):
    lib = host_library("bounce_bwd_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("k7host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_replay.argtypes = [ctypes.c_void_p]

    def run(args, kw):
        r = args[5].shape[0]
        rows, cols = per_lane_args(args[1], r, torch.device("cpu"))
        out = torch.empty((kw["n_row"] + k7.N_OUT_EXTRA, r))
        lib.run_replay(ctypes.byref(k7.replay_args(args[0], rows, *args[2:],
                                                   out, **kw)))
        return tuple(out.unbind(0))
    return run


def _case(name):
    if name == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device="cpu")
        return scene, s.replace(rr_depth=2)
    if name == "all_materials":
        s = rt.CameraSettings(background=rt.sky, image_width=64,
                              max_depth=10)
        return (all_materials_scene(device="cpu"),
                s.with_redirect_targets(ALL_MATERIAL_TARGETS))
    if name == "mesh":
        return mesh_all_kinds_scene(10, False, 64, device="cpu")
    scene, s = box_motion_scene(device="cpu")
    return scene, s.replace(background=rt.gray_fade)


@pytest.mark.parametrize("steps", [0, 5])
@pytest.mark.parametrize("name", ["cornell", "all_materials", "box_motion",
                                  "mesh"])
def test_host_build_of_k7_matches_plain(host_k7, name, steps):
    scene, s = _case(name)
    # the mesh at 2 spp: lanes parked dead at 3e18 reading a sphere row
    args, kw = k7_inputs(scene, s, 2048, steps, seed=13 + steps,
                         spp=2 if name == "mesh" else 8)
    ref = k7.bounce_bwd_megakernel_plain(*args, **kw)
    out = host_k7(args, kw)
    err, excess = bwd_errs(ref, out)
    assert excess <= 0.0, (err, excess)
    assert torch.equal(ref[-1], out[-1])                   # the miss flag
    # the state has live lanes, and the open scenes misses
    live = int((args[5] > 0.5).sum())
    if name == "mesh":
        assert 2048 // 16 < live < 2048 // 2 or steps == 0, live
    else:
        assert live > 2048 // 8
    if name != "cornell":
        assert float(ref[-1].sum()) > 0
