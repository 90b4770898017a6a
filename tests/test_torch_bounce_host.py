"""Kernel A's CUDA source, compiled for the host, against the plain
version.

The body of ``csrc/bounce_kernel.cu`` (the scan of ``csrc/prim_loop.cuh``,
the shade of ``csrc/shade.cuh``) is plain C++ once ``__device__``, the
launch indices and the block's shared memory are defined for the host
(``testing.HOST_SHIM``), so the host C++ compiler builds it (the launcher
after ``extern "C"`` is left out) and runs its grid through
``rt_host_launch``: blocks of 32 host threads, one lane a thread, each
block staging the tables behind its barrier.  That checks both
instantiations on the CPU before any card sees them: the planar one
(``planar_loop``: columns 4-19 as float4, only the planar branch, the scan
carrying (t, row), the winner's record built once afterwards) on the
Cornell box, whose 18 rows are all parallelograms, and the general one
(``prim_loop``) on the Cornell box, the all-materials scene (spheres, a
box, every material) with and without redirect targets, and the moving
box scene.

Tolerance: the winner's row, alive and miss flags equal on every lane;
the other floats within ``testing.ATOL`` + ``testing.RTOL`` |plain| (the
card's tolerance for kernel A), because the host's ``sinf``, ``cosf`` and
``sqrtf`` and torch's CPU kernels may round the scatter directions an
ulp apart (on the card both are CUDA's, and the smoke finds no
difference).  The two instantiations of the host build agree with each
other bit for bit on the Cornell box: they differ only in the scan.
"""
import ctypes

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import bounce_kernel as bk
from raytrace_tpu_torch.render.integrator import bounce_tables
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, BOUNCE_INT_ROWS, all_materials_scene, bounce_inputs,
    box_motion_scene, cornell_scene_and_settings, host_library, max_errs,
    next_bounce_inputs, primary_bounce_inputs, torch_threads,
)

_RUN = r"""
// The grid on the host: blocks of 32 threads, one lane a thread.
extern "C" int run_bounce(const BounceArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + 31) / 32), 32, [&] {
    if (a->planar)
      bounce_kernel<true>(*a);
    else
      bounce_kernel<false>(*a);
  });
  return 0;
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def host_bounce(tmp_path_factory):
    lib = host_library("bounce_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("bounce_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_bounce.argtypes = [ctypes.c_void_p]

    def run(tb, lanes, planar: bool):
        r = lanes[0].shape[0]
        out = torch.empty((bk.N_OUT, r))
        launch = tb.launch
        table = bk._table_args(tb.ptbl, tb.mtbl, tb.ttbl, launch.kw, planar)
        lib.run_bounce(ctypes.byref(bk.lane_args(table, lanes[:11],
                                                 lanes[11], out)))
        return tuple(out.unbind(0))
    return run


def _cornell():
    return cornell_scene_and_settings(24, 1, 10, device="cpu")


def _cases():
    return ("cornell", "all_materials", "all_materials_targets",
            "box_motion")


def _scene(case):
    if case == "cornell":
        sc, s = _cornell()
        return sc, s, (0.0, 555.0)
    if case == "box_motion":
        sc, s = box_motion_scene(device="cpu")
        return sc, s, (-8.0, 8.0)
    sc = all_materials_scene(device="cpu")
    s = rt.CameraSettings(background=rt.const_background([0.5, 0.6, 0.7]))
    if case == "all_materials_targets":
        s = s.with_redirect_targets(ALL_MATERIAL_TARGETS)
    return sc, s, (-8.0, 8.0)


def _check(ref, out):
    n_int, _, excess = max_errs(ref, out, BOUNCE_INT_ROWS)
    assert n_int == 0 and excess <= 0.0, (n_int, excess)


@pytest.mark.parametrize("case", _cases())
def test_host_build_of_bounce_kernel_matches_plain(host_bounce, case):
    sc, s, box = _scene(case)
    tb = bounce_tables(sc, s)
    assert tb.launch.planar == (case == "cornell")
    groups = [bounce_inputs(sc, 2048, 5, box)]
    if case == "cornell":
        cam = primary_bounce_inputs(sc, s, 1)
        groups += [cam]
    for lanes in groups:
        ref = bk.bounce_plain(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw)
        out = host_bounce(tb, lanes, tb.launch.planar)
        _check(ref, out)
        assert int((ref[14] >= 0).sum()) > 100      # lanes that hit
        if tb.launch.planar:
            # the general scan gives the same bits
            gen = host_bounce(tb, lanes, False)
            for k, (a, b) in enumerate(zip(out, gen)):
                assert torch.equal(a, b), k


def test_host_build_of_planar_scan_on_second_bounce(host_bounce):
    """The Cornell box's second bounce (rays leaving the walls, dead lanes
    parked at 3e18) through the planar instantiation."""
    sc, s = _cornell()
    tb = bounce_tables(sc, s)
    cam = primary_bounce_inputs(sc, s, 1)
    first = bk.bounce_plain(tb.ptbl, tb.mtbl, tb.ttbl, *cam, **tb.kw)
    lanes = next_bounce_inputs(cam, first, 1, 1)
    ref = bk.bounce_plain(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw)
    out = host_bounce(tb, lanes, True)
    _check(ref, out)
    assert int((lanes[10] < 0.5).sum()) > 0          # parked lanes


def test_planar_flag_and_prepared_tables():
    """``planar_only`` holds for the Cornell box's table and not for a
    table with spheres or motion; ``prepare_bounce`` checks the tables
    once, and the CPU wrapper ignores ``prepared`` (the plain version)."""
    sc, s = _cornell()
    tb = bounce_tables(sc, s)
    assert tb.n_prims == 18 and tb.launch is tb.launch
    assert bk.planar_only(tb.ptbl, tb.n_prims, False)
    assert not bk.planar_only(tb.ptbl, tb.n_prims, True)
    allm = bounce_tables(all_materials_scene(device="cpu"),
                         rt.CameraSettings())
    assert not allm.launch.planar
    box, s_box = box_motion_scene(device="cpu")
    assert not bounce_tables(box, s_box).launch.planar
    lanes = bounce_inputs(sc, 256, 7, (0.0, 555.0))
    ref = bk.bounce_plain(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw)
    a0 = bk.bounce_megakernel.launches
    out = bk.bounce_megakernel(tb.ptbl, tb.mtbl, tb.ttbl, *lanes, **tb.kw,
                               prepared=tb.launch)
    assert bk.bounce_megakernel.launches == a0
    for a, b in zip(ref, out):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="n_prims"):
        bk.prepare_bounce(tb.ptbl, tb.mtbl, tb.ttbl,
                          **dict(tb.kw, n_prims=tb.ptbl.shape[0] + 1))
