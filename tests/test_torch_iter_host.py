"""Kernel B's CUDA source, compiled for the host, against the plain
version.

The body of ``csrc/iter_kernel.cu`` (regeneration, RNG and camera of
``csrc/regen.cuh``, the scan of ``csrc/prim_loop.cuh``, the shade of
``csrc/shade.cuh``, background, depth cap and Russian roulette) is plain
C++ once ``__device__``, the launch indices and the block's shared memory
are defined for the host (``testing.HOST_SHIM``), so the host C++
compiler builds it (the launcher after ``extern "C"`` is left out) and
runs its grid through ``rt_host_launch``: blocks of 32 host threads, one
lane a thread, each block staging the camera and the tables behind its
barrier.  That checks both flat instantiations on the CPU before any card
sees them: the planar one (``planar_loop``: columns 4-19 as float4, only
the planar branch, the scan carrying (t, row), the winner's record and
(u, v) built once afterwards) on the Cornell box, whose 18 rows are all
parallelograms, and the general one (``prim_loop``) on the Cornell box,
the all-materials scene (spheres, parallelograms, a triangle, every
material) with and without redirect targets, and the moving-box scene;
each from a fresh carry (every lane regenerating) and from the state
after 3 plain iterations, with the exact estimator and with Russian
roulette.

Tolerance: the winner index, alive, died, sample and depth equal on every
lane; the other floats within ``testing.ATOL`` + ``testing.RTOL`` |plain|
(the card's tolerance for kernel B), because the host's ``sinf``,
``cosf`` and ``sqrtf`` and torch's CPU kernels may round the camera and
scatter directions an ulp apart (on the card both are CUDA's, and the
smoke finds no difference).  The two instantiations of the host build
agree with each other bit for bit on the Cornell box: they differ only in
the scan.

The rotated mode (``kRotate``) is built the same way and held against
``iter_plain``'s over a few turns of a rotated band with padding slots,
planar on the Cornell box and general on the all-materials scene: the
exact rows equal, the other floats and the accumulation planes within
the same tolerance.
"""
import ctypes
import dataclasses

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
from raytrace_tpu_torch.ops import iter_kernel as ik
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, ITER_INT_ROWS, all_materials_scene,
    box_motion_scene, cornell_scene_and_settings, cornell_smoke_scene,
    fresh_carry, host_library, max_errs, torch_threads,
)

_RUN = r"""
// The grid on the host: blocks of 32 threads, one lane a thread.
extern "C" int run_iter(const IterArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + 31) / 32), 32, [&] {
    if (a->planar)
      iter_kernel<false, false, true>(*a);
    else
      iter_kernel<false, false, false>(*a);
  });
  return 0;
}
"""

_RUN_ROT = r"""
extern "C" int run_iter_rot(const IterArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + 31) / 32), 32, [&] {
    if (a->planar)
      iter_kernel<false, false, true, true>(*a);
    else
      iter_kernel<false, false, false, true>(*a);
  });
  return 0;
}
"""

N_LANES = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def host_iter(tmp_path_factory):
    lib = host_library("iter_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("iter_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_iter.argtypes = [ctypes.c_void_p]

    def run(tables, kw, lane_in, planar: bool):
        """The host build's outputs, in iter_megakernel's order."""
        r = lane_in[0].shape[0]
        launch = kw["prepared"]
        table = (launch.args if planar
                 else ik.table_args(tables, None, launch.kw, None))
        outf = torch.empty((19 if kw["with_uv"] else 17, r))
        outi = torch.empty((2, r), dtype=torch.int32)
        lib.run_iter(ctypes.byref(ik.lane_args(table, lane_in, outf, outi)))
        f = outf.unbind(0)
        out = f[:14] + (outi[0], outi[1]) + f[14:17]
        return out + f[17:19] if kw["with_uv"] else out
    return run


def _scene(case, rr: bool):
    if case == "cornell":
        sc, s = cornell_scene_and_settings(32, 4, 10, device="cpu")
    elif case == "box_motion":
        sc, s = box_motion_scene(device="cpu")
        s = s.replace(image_width=32)
    else:
        sc = all_materials_scene(device="cpu")
        s = rt.CameraSettings(image_width=32, max_depth=10,
                              background=rt.const_background([0.5, 0.6,
                                                              0.7]))
        if case == "all_materials_targets":
            s = s.with_redirect_targets(ALL_MATERIAL_TARGETS)
    return sc, s.replace(rr_depth=1 if rr else None)


def _args(sc, s, seed: int):
    """Kernel B's tables and keywords with the winner's uv, prepared as
    the drivers prepare them."""
    tables, kw = iter_kernel_args(sc, s, rng.base_key(seed, "cpu"), 3)
    kw = {k: v for k, v in kw.items() if k != "prepared"}
    kw["with_uv"] = True
    kw["prepared"] = ik.prepare_iter(*tables, **kw)
    return tables, kw


def _lanes(tables, kw, s, state: str):
    """17 lane tensors: a fresh carry, or the state after 3 plain
    iterations from it."""
    n_pix = s.image_width * s.image_height
    pix = (torch.arange(N_LANES) % n_pix).to(torch.int32)
    carry = fresh_carry(N_LANES, "cpu")
    if state == "after3":
        for _ in range(3):
            o = ik.iter_plain(*tables, (pix,) + carry, **kw)
            carry = ik.next_carry(o)
    return (pix,) + tuple(carry)


@pytest.mark.parametrize("rr", (False, True), ids=("exact", "rr"))
@pytest.mark.parametrize("state", ("fresh", "after3"))
@pytest.mark.parametrize("case", ("cornell", "all_materials",
                                  "all_materials_targets", "box_motion"))
def test_host_build_of_iter_kernel_matches_plain(host_iter, case, state,
                                                 rr):
    sc, s = _scene(case, rr)
    tables, kw = _args(sc, s, 3)
    planar = kw["prepared"].planar
    assert planar == (case == "cornell")
    lane_in = _lanes(tables, kw, s, state)
    ref = ik.iter_plain(*tables, lane_in, **kw)
    out = host_iter(tables, kw, lane_in, planar)
    n_int, _, excess = max_errs(ref, out, ITER_INT_ROWS)
    assert n_int == 0 and excess <= 0.0, (n_int, excess)
    assert int((ref[17] >= 0).sum()) > 50              # lanes that hit
    if state == "fresh":
        assert bool((ref[14] == 0).all())              # all regenerated
    if planar:
        # the general scan gives the same bits
        gen = host_iter(tables, kw, lane_in, False)
        for k, (a, b) in enumerate(zip(out, gen)):
            assert torch.equal(a, b), k


def test_prepared_iter_launch():
    """``prepare_iter`` sets the planar flag for the Cornell box's table
    only, fills the struct's table part once, and refuses tables or
    keywords it was not made for; the CPU wrapper ignores ``prepared``
    (the plain version)."""
    sc, s = _scene("cornell", False)
    tables, kw = iter_kernel_args(sc, s, rng.base_key(0, "cpu"), 3)
    launch = kw["prepared"]
    assert launch.planar and launch.args.planar == 1
    assert launch.args.n_prims == 18 and launch.args.rr_depth == -1
    for case in ("all_materials", "box_motion"):
        other = iter_kernel_args(*_scene(case, True),
                                 rng.base_key(0, "cpu"), 3)[1]
        assert not other["prepared"].planar
        assert other["prepared"].args.rr_depth == 1
    kw_np = {k: v for k, v in kw.items() if k not in ("prepared", "use_ap",
                                                      "bvh")}
    assert ik.table_args(tables, None, kw_np, launch) is launch.args
    general = ik.table_args(tables, None, kw_np, None)
    assert general.planar == 0 and general.ptbl == launch.args.ptbl
    with pytest.raises(ValueError, match="prepared"):
        ik.table_args((tables[0].clone(),) + tables[1:], None, kw_np, launch)
    with pytest.raises(ValueError, match="prepared"):
        ik.table_args(tables, None, dict(kw_np, max_depth=3), launch)
    with pytest.raises(ValueError, match="n_prims"):
        ik.prepare_iter(*tables, **dict(kw_np, n_prims=10 ** 6))
    # a media scene's 8 + V uniform columns are refused at the launch, not
    # when its tables are prepared
    smoke, s_s = cornell_smoke_scene(32, 1, 4, device="cpu")
    _, kw_s = iter_kernel_args(smoke, s_s, rng.base_key(0, "cpu"), 0)
    assert kw_s["n_u"] == 10 and kw_s["prepared"].kw["n_u"] == 10
    # the CPU wrapper is the plain version, prepared or not
    lane_in = _lanes(tables, kw, s, "fresh")
    n0 = ik.iter_megakernel.launches
    ref = ik.iter_plain(*tables, lane_in, **kw)
    out = ik.iter_megakernel(*tables, lane_in, **kw)
    assert ik.iter_megakernel.launches == n0
    for a, b in zip(ref, out):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def host_iter_rot(tmp_path_factory):
    lib = host_library("iter_kernel.cu", _RUN_ROT,
                       tmp_path_factory.mktemp("iter_host_rot"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_iter_rot.argtypes = [ctypes.c_void_p]
    return lib.run_iter_rot


@pytest.mark.parametrize("case", ("cornell", "all_materials"))
def test_host_build_of_rotated_iter_kernel_matches_plain(host_iter_rot,
                                                         case):
    sc, s = _scene(case, True)
    k_rot, spp_k, s0, off = 4, 2, 3, 50
    tables, kw = iter_kernel_args(sc, s, rng.base_key(5, "cpu"),
                                  s0 + k_rot * spp_k - 1)
    launch = kw["prepared"]
    assert launch.planar == (case == "cornell")
    n_pix = min(s.image_width * s.image_height - off, N_LANES - 64)
    rot = ik.Rotation(k_rot, spp_k, 256, s0, off, n_pix,
                      torch.zeros((k_rot, 3, N_LANES)))
    carry = fresh_carry(N_LANES, "cpu")
    carry = (carry[0] + s0,) + carry[1:]
    pix = torch.zeros(N_LANES, dtype=torch.int32)
    for _ in range(6):
        lane_in = (pix,) + tuple(carry)
        ref_planes = rot.planes.clone()
        ref = ik.iter_plain(*tables, lane_in, **kw, rotation=dataclasses
                            .replace(rot, planes=ref_planes))
        outf = torch.empty((17, N_LANES))
        outi = torch.empty((2, N_LANES), dtype=torch.int32)
        args = ik.lane_args(launch.args, lane_in, outf, outi)
        ik._rotation_args(args, rot, N_LANES, torch.device("cpu"))
        host_iter_rot(ctypes.byref(args))
        f = outf.unbind(0)
        out = f[:14] + (outi[0], outi[1]) + f[14:17]
        n_int, _, excess = max_errs(ref + (ref_planes,),
                                    out + (rot.planes,), ITER_INT_ROWS)
        assert n_int == 0 and excess <= 0.0, (n_int, excess)
        carry = ik.next_carry(out)
    assert bool((rot.planes != 0).any())
