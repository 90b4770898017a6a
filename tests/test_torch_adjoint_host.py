"""K5's CUDA source, compiled for the host, against its plain version.

The kernel body of ``csrc/bounce_bwd_kernel.cu`` (the regeneration of
``regen.cuh`` and the hand-derived adjoint of ``lane_adjoint.cuh``) is
plain C++ once ``__device__`` and the launch indices are defined for the
host, so the host C++ compiler can build it (the launcher after
``extern "C"`` is left out) and run its per-lane mode lane by lane, one
block of one thread looping over the lanes.  On the CPU that checks the adjoint's arithmetic against
torch autograd over ``lane_math`` (``bounce_bwd_regen_pre_plain``) before
any card sees it; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
the kernel itself against the same plain version on the card.

States: 2048 lanes of real mid-render states of the Cornell box, the
all-materials scene (two redirect targets, sky) and the box/motion scene
(gray fade).  Tolerance: ``testing.bwd_errs`` with ``BWD_RTOL``, on every
lane: the build uses ``-ffp-contract=off``, as the card's uses
``--fmad=false``; the host's ``sinf``/``cosf`` may differ from torch's in
the last bit, which moves no branch on these states.
"""
import ctypes

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import bounce_bwd_gather_kernel as k5
from raytrace_tpu_torch.ops.row_reduce import per_lane_args
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, all_materials_scene, box_motion_scene, bwd_errs,
    bwd_inputs, cornell_scene_and_settings, host_library,
)

_RUN = r"""
extern "C" int run_bwd(const BwdArgs* a) {
  blockDim.x = gridDim.x = 1;
  threadIdx.x = blockIdx.x = 0;
  bounce_bwd_kernel(*a);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_k5(tmp_path_factory):
    lib = host_library("bounce_bwd_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("k5host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_bwd.argtypes = [ctypes.c_void_p]

    def run(args, kw):
        gath, r = args[3], args[6].shape[0]
        rows, cols = per_lane_args(gath, r, torch.device("cpu"))
        out = torch.empty((kw["n_row"] + k5.N_OUT_EXTRA, r))
        a = k5.bwd_args(*args[:3], rows, *args[4:], out, **kw)
        lib.run_bwd(ctypes.byref(a))
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
    scene, s = box_motion_scene(device="cpu")
    return scene, s.replace(background=rt.gray_fade)


@pytest.mark.parametrize("n_iters", [0, 5])
@pytest.mark.parametrize("name", ["cornell", "all_materials", "box_motion"])
def test_host_build_of_k5_matches_plain(host_k5, name, n_iters):
    scene, s = _case(name)
    args, kw = bwd_inputs(scene, s, 2048, 13 + n_iters, n_iters=n_iters)
    ref = k5.bounce_bwd_regen_pre_plain(*args, **kw)
    err, excess = bwd_errs(ref, host_k5(args, kw))
    assert excess <= 0.0, (err, excess)
