"""K5's CUDA source, compiled for the host, against its plain version.

The kernel body of ``csrc/bounce_bwd_kernel.cu`` (the regeneration of
``regen.cuh`` and the hand-derived adjoint of ``lane_adjoint.cuh``) is
plain C++ once ``__device__`` and the launch indices are defined for the
host, so the host C++ compiler can build it (the launcher after
``extern "C"`` is left out) and run it lane by lane, one block of one
thread per lane.  On the CPU that checks the adjoint's arithmetic against
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
import shutil
import subprocess

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import bounce_bwd_gather_kernel as k5
from raytrace_tpu_torch.ops._build import CSRC
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, all_materials_scene, box_motion_scene, bwd_errs,
    bwd_inputs, cornell_scene_and_settings,
)

_SHIM = r"""
#include <math.h>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __shared__ static
struct Dim3 { unsigned x = 0; };
static Dim3 threadIdx, blockIdx, blockDim;
static inline void __syncthreads() {}
static inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
"""

_RUN = r"""
extern "C" int run_bwd(const BwdArgs* a) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long l = 0; l < a->n_lanes; ++l) {
    blockIdx.x = static_cast<unsigned>(l);
    bounce_bwd_kernel(*a);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_k5(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = (CSRC / "bounce_bwd_kernel.cu").read_text()
    src = src[:src.index('extern "C"')].replace("#include <cuda_runtime.h>",
                                                "")
    d = tmp_path_factory.mktemp("k5host")
    (d / "k5.cpp").write_text(_SHIM + src + _RUN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(CSRC), "-o", str(d / "k5.so"),
                    str(d / "k5.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "k5.so"))
    lib.run_bwd.argtypes = [ctypes.c_void_p]

    def run(args, kw):
        (ttbl, kt, cam, gath, bi, ints, al, comps_in, thr_in, scale,
         cts) = args
        n_row, r = kw["n_row"], al.shape[0]
        out = torch.empty((n_row + k5.N_OUT_EXTRA, r))
        ptrs = lambda xs, n: (ctypes.c_void_p * n)(
            *([x.data_ptr() for x in xs] + [0] * (n - len(xs))))
        a = k5._BwdArgs(
            ttbl.data_ptr(), cam.data_ptr(), kt.data_ptr(),
            ptrs(gath, k5.MAX_ROW + k5.N_GATH_EXTRA), bi.data_ptr(),
            *(x.data_ptr() for x in ints), al.data_ptr(), ptrs(comps_in, 7),
            ptrs(thr_in, 3), scale.data_ptr(), ptrs(cts, k5.N_CTS),
            out.data_ptr(), r, kw["n_targets"], int(kw["has_motion"]),
            int(kw["has_box"]), n_row, kw["width"], kw["bg_kind"],
            float(kw["t_min"]))
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
