"""The reduced backward kernels K5 and K7: the winner rows read by index
and the row gradients summed onto the scene's tables inside the kernel
(``csrc/row_reduce.cuh``, ``ops/row_reduce.py``).

* The plain reduced versions (``bounce_bwd_regen_pre_reduced_plain``,
  ``bounce_bwd_megakernel_reduced_plain``: the per-lane plain version,
  then a sum over the lanes onto the prims and a map of the prims onto
  the materials and textures) against the per-lane plain version
  followed by ``testing.reduce_row_grads`` (``index_add_`` over the lanes
  straight onto each table, as the fwd+bwd reduced before this design).
* The kernels' CUDA source built with the host C++ compiler
  (``testing.host_library``), its blocks run as host threads whose
  ``__syncthreads``, ``__match_any_sync``, ``__shfl_sync`` and
  ``__reduce_max_sync`` wait for each other: the reduced mode against
  the same source's per-lane mode and against the plain version.

States: 2^10 lanes of real mid-render states (``testing.bwd_inputs``,
``testing.k7_inputs``) of the Cornell box (RR from depth 2), the
all-materials scene with two redirect targets, the box/motion scene
(``n_row`` 15), for K5 the 4,992-row bunny stand-in (the tables too large
for shared memory: the global mode) and for K7 a 384-row mixed-kind mesh
(its global mode, within the unfused route's 512 rows); every state has
miss lanes, all but the mesh's dead lanes and, for K5, lanes that
regenerate.  The host runs use 1,000 lanes on 3 blocks, so
the blocks loop over several tiles and the last tile is partial.

Tolerances: each reduced table entry, a sum over ``n`` lanes, within
``n * 2^-23 * sum |g|`` of a float64 sum of the per-lane row gradients
that went into it (two summation orders of the same terms); the lane
outputs of the reduced and per-lane modes of one build equal, and within
``testing.BWD_RTOL`` of the plain version's; the reduced tables of a
host build within the per-lane tolerances' sum of the plain version's.
"""
import ctypes

import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import bounce_bwd_gather_kernel as k5
from raytrace_tpu_torch.ops import bounce_bwd_kernel as k7
from raytrace_tpu_torch.ops import row_reduce
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, all_materials_scene, box_motion_scene,
    bunny_standin_scene, bwd_bound, bwd_errs, bwd_inputs,
    cornell_scene_and_settings, host_library, k7_inputs,
    mesh_all_kinds_scene, reduce_row_grads, reduced_args, row_grads_errs,
    torch_threads,
)

R = 1 << 10
K5_STATES = ["cornell", "all_materials_targets", "box_motion", "bunny"]
K7_STATES = ["cornell", "all_materials_targets", "box_motion", "mesh"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _scene(name):
    if name == "cornell":
        scene, s = cornell_scene_and_settings(64, 8, 10, device="cpu")
        return scene, s.replace(rr_depth=2)
    if name == "all_materials_targets":
        s = rt.CameraSettings(background=rt.sky, image_width=64,
                              max_depth=10)
        return (all_materials_scene(device="cpu"),
                s.with_redirect_targets(ALL_MATERIAL_TARGETS))
    if name == "box_motion":
        scene, s = box_motion_scene(device="cpu")
        return scene, s.replace(background=rt.gray_fade)
    if name == "bunny":
        scene, s = bunny_standin_scene(64, 8, 10, device="cpu")
        return scene, s.replace(rr_depth=2)
    return mesh_all_kinds_scene(10, False, 64, device="cpu")


_CACHE = {}


def _state(kernel, name, lanes=R):
    """``(args, kw, tables)`` of a mid-render state, cached."""
    key = (kernel, name, lanes)
    if key not in _CACHE:
        scene, s = _scene(name)
        if kernel == "k5":
            args, kw = bwd_inputs(scene, s, lanes, 7, n_iters=1
                                  if name == "bunny" else 4)
        else:
            # 2 samples leave lanes dead after their last; the mesh state
            # takes 8: on its dead lanes the plain version's gradients are
            # NaN where the kernel's (either mode) are finite, an open
            # difference of the per-lane adjoint (ROADMAP F9)
            args, kw = k7_inputs(scene, s, lanes, 4, seed=7,
                                 spp=8 if name == "mesh" else 2)
        _CACHE[key] = (args, kw, row_reduce.row_tables(scene, kw["n_row"]))
    return _CACHE[key]


def _lane_kinds(kernel, args):
    """Counts of (miss, dead, regenerating) lanes."""
    if kernel == "k5":
        bi, al, smp, last = args[4], args[6], args[5][1], int(args[1][2])
        dead = al < 0.5
        return (int((bi < 0).sum()), int(dead.sum()),
                int((dead & (smp < last)).sum()))
    bi, al = args[2], args[5]
    return int((bi < 0).sum()), int((al < 0.5).sum()), 0


def _same(xs, ys):
    """Equal, NaN where NaN."""
    return all(torch.equal(x.isnan(), y.isnan())
               and torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0))
               for x, y in zip(xs, ys))


def test_row_mode_stages_small_tables():
    """The staged mode takes the tables whose rows and per-warp
    accumulators fit 40 KB of shared memory: 112 rows without motion, 84
    with."""
    assert row_reduce.row_mode(24, 9) == row_reduce.STAGED
    assert row_reduce.row_mode(112, 9) == row_reduce.STAGED
    assert row_reduce.row_mode(113, 9) == row_reduce.GLOBAL
    assert row_reduce.row_mode(84, 15) == row_reduce.STAGED
    assert row_reduce.row_mode(85, 15) == row_reduce.GLOBAL
    assert row_reduce.row_mode(4992, 9) == row_reduce.GLOBAL


@pytest.mark.parametrize("name", K5_STATES)
def test_plain_reduced_k5_matches_per_lane_plain(name):
    args, kw, tables = _state("k5", name)
    miss, dead, regen = _lane_kinds("k5", args)
    assert miss > 0 and dead > 0 and regen > 0, (miss, dead, regen)
    n = kw["n_row"] + 7
    ref = k5.bounce_bwd_regen_pre_plain(*args, **kw)
    lane, rows = k5.bounce_bwd_regen_pre_reduced(
        *reduced_args(args, tables), **kw)        # CPU: the plain version
    assert _same(lane, ref[n:])
    old = reduce_row_grads(tables, ref[:n], args[4], kw["n_row"])
    for a, b in zip(rows, old):
        assert a.shape == b.shape
    err, excess = row_grads_errs(tables, ref[:n], args[4], kw["n_row"], rows)
    assert excess <= 0.0, (err, excess)
    err, excess = row_grads_errs(tables, ref[:n], args[4], kw["n_row"], old)
    assert excess <= 0.0, (err, excess)


@pytest.mark.parametrize("name", K7_STATES)
def test_plain_reduced_k7_matches_per_lane_plain(name):
    args, kw, tables = _state("k7", name)
    miss, dead, _ = _lane_kinds("k7", args)
    assert miss > 0 and (dead > 0 or name == "mesh"), (miss, dead)
    n = kw["n_row"] + 7
    ref = k7.bounce_bwd_megakernel_plain(*args, **kw)
    lane, rows = k7.bounce_bwd_megakernel_reduced(
        *reduced_args(args, tables), **kw)        # CPU: the plain version
    assert _same(lane, ref[n:])
    old = reduce_row_grads(tables, ref[:n], args[2], kw["n_row"])
    for a, b in zip(rows, old):
        assert a.shape == b.shape
    err, excess = row_grads_errs(tables, ref[:n], args[2], kw["n_row"], rows)
    assert excess <= 0.0, (err, excess)


_RUN = r"""
// The launcher's sequence on the host: zero the global sums, the kernel's
// blocks, then the finishing kernels.
template <class Args>
static int run_blocks(void (*kernel)(const Args), const Args* a,
                      int n_blocks) {
  const rt::RowArgs& r = a->rows;
  const int nr = a->n_row, nc = nr + 7;
  if (r.mode == rt::kRowGlobal)
    std::memset(r.sums, 0, sizeof(float) * r.n_prims * nc);
  rt_host_launch(n_blocks, rt::kRowThreads, [&] { kernel(*a); });
  if (r.mode == rt::kRowPerLane) return 0;
  if (r.mode == rt::kRowStaged) {
    const long long pc = static_cast<long long>(r.n_prims) * nc;
    rt_host_launch(static_cast<int>((pc + 31) / 32), rt::kSumWarps * 32,
                   [&] { rt::row_sum_kernel(r, nc, n_blocks); });
  }
  rt_host_launch(r.n_mats + r.n_tex, rt::kMapThreads,
                 [&] { rt::row_map_kernel(r, nr); });
  return 0;
}
extern "C" int run_k5(const BwdArgs* a, int n_blocks) {
  return run_blocks(bounce_bwd_kernel, a, n_blocks);
}
extern "C" int run_k7(const ReplayArgs* a, int n_blocks) {
  return run_blocks(bounce_bwd_replay_kernel, a, n_blocks);
}
"""
HOST_LANES = 1000
HOST_BLOCKS = 3


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = host_library("bounce_bwd_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("bwd_reduce_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    for fn in (lib.run_k5, lib.run_k7):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _host_run(lib, kernel, args, kw, tables, monkeypatch):
    """The host build's per-lane outputs and reduced ``(lane, rows)``."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(row_reduce, "_n_sm", lambda index: 1)
    n_row = kw["n_row"]
    if kernel == "k5":
        make, run, gath, n_lane = k5.bwd_args, lib.run_k5, args[3], \
            k5.N_LANE_OUT
    else:
        make, run, gath, n_lane = k7.replay_args, lib.run_k7, args[1], \
            k7.N_LANE_OUT
    r = gath[0].shape[0]
    # the struct of the rows in place of the rows themselves
    rows, _ = row_reduce.per_lane_args(gath, r, cpu)   # gath's own rows
    per = torch.empty((n_row + 7 + n_lane, r))
    run(ctypes.byref(make(*reduced_args(args, rows), per, **kw)),
        HOST_BLOCKS)
    rows, grads = row_reduce.row_buffers(tables, n_row, cpu)
    assert rows.mode == row_reduce.row_mode(tables.n_prims, n_row)
    lane = torch.empty((n_lane, r))
    run(ctypes.byref(make(*reduced_args(args, rows), lane, **kw)),
        HOST_BLOCKS)
    return tuple(per.unbind(0)), tuple(lane.unbind(0)), grads


@pytest.mark.parametrize("kernel,name",
                         [("k5", s) for s in K5_STATES]
                         + [("k7", s) for s in K7_STATES])
def test_host_build_of_reduced_kernel(host, kernel, name, monkeypatch):
    args, kw, tables = _state(kernel, name, HOST_LANES)
    bi = args[4] if kernel == "k5" else args[2]
    n = kw["n_row"] + 7
    per, lane, rows = _host_run(host, kernel, args, kw, tables, monkeypatch)
    # the same device code per lane in both modes
    assert _same(per[n:], lane)
    # the in-kernel sums against a float64 sum of the per-lane rows
    err, excess = row_grads_errs(tables, per[:n], bi, kw["n_row"], rows)
    assert excess <= 0.0, (err, excess)
    # and against the plain version
    plain = (k5.bounce_bwd_regen_pre_plain if kernel == "k5"
             else k7.bounce_bwd_megakernel_plain)
    ref = plain(*args, **kw)
    err, excess = bwd_errs(ref[n:], lane)
    assert excess <= 0.0, (err, excess)
    err, excess = row_grads_errs(tables, ref[:n], bi, kw["n_row"], rows,
                                 bwd_bound(ref)[:n])
    assert excess <= 0.0, (err, excess)
    assert float(rows.g_ptab.abs().sum()) > 0.0
