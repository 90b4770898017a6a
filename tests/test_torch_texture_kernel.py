"""The marble kernel K12 (``ops/texture_kernel.py``) on the CPU.

* ``marble_stripe_plain`` against the JAX package's
  ``marble_stripe_pallas(..., interpret=True)`` (the scene table of
  ``tests/test_texture_kernel.py``): marble lanes within 2e-5 (the
  turbulence times 10 inside a sine; XLA's CPU backend contracts the
  noise blend's multiply-adds into FMAs), every other lane exactly 0, and
  a batch with no marble lane all 0.
* The CUDA source (``csrc/texture_kernel.cu`` over ``csrc/noise.cuh``)
  built for the host with g++ (``testing.host_library``) against the
  plain version: the lattice avalanche and the corner-hash avalanche bit
  for bit; the turbulence within 1e-6 and the stripe within 1e-5 (the
  host's ``sinf``/``cosf`` and torch's CPU ``sin``/``cos`` may differ in
  the last bit; on the card both are CUDA's, and the smoke holds the
  kernel to equality); non-marble lanes exactly 0.  The kernel's grid
  runs through ``rt_host_launch``: blocks of 256 host threads (8 a lane
  of the 32-lane tile) in warps of 32, so the tile's ``__ballot_sync``
  compaction and the groups' ``__shfl_sync`` run as on the card, on random lanes, on the patterns of
  ``testing.marble_patterns`` (alternating, all marble, none, a ragged
  lane count, 32 shuffled rows with a repeated id) and on the lanes the
  forward route hands the kernel (``testing.route_marble_lanes``).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops.pallas.texture_kernel import (
    marble_stripe_pallas as jmarble,
)
from raytrace_tpu.textures.textures import compile_textures as jcompile
from raytrace_tpu.textures.textures import constant_texture as jconst
from raytrace_tpu.textures.textures import marble_texture as jmarble_tex
from raytrace_tpu_torch.ops import texture_kernel as tk
from raytrace_tpu_torch.testing import (
    host_library, marble_patterns, noise_test_scene, route_marble_lanes,
    torch_threads,
)
from raytrace_tpu_torch.textures import noise as tn
from raytrace_tpu_torch.textures.textures import (
    TEX_MARBLE, compile_textures, constant_texture, marble_texture,
)


def _tables():
    def build(const, marble):
        return [const([1.0, 0.2, 0.3]), marble([0.0, 0.0, 1.0], 4.0),
                marble([1.0, 2.0, 0.0], 2.0, shift=(0.3, 0.1, 0.9))]
    return (jcompile(build(jconst, jmarble_tex)),
            compile_textures(build(constant_texture, marble_texture)))


def _lanes(r: int, seed: int):
    rg = np.random.default_rng(seed)
    pts = rg.uniform(-3, 3, (r, 3)).astype(np.float32)
    tid = rg.integers(0, 3, r).astype(np.int32)
    return pts, tid


def test_marble_table_layout():
    _, tt = _tables()
    m = tk.marble_table(tt)
    assert m.shape == (2, tk.N_MCOLS)
    np.testing.assert_array_equal(
        m.numpy(), [[1, 4, 0, 0, 1, 0, 0, 0],
                    [2, 2, 1, 2, 0, np.float32(0.3), np.float32(0.1),
                     np.float32(0.9)]])


def test_marble_plain_matches_jax_kernel():
    jt, tt = _tables()
    pts, tid = _lanes(512, 0)
    ref = np.asarray(jmarble(jt, jnp.asarray(tid), jnp.asarray(pts),
                             interpret=True))
    out = tk.marble_stripe_plain(tt, torch.from_numpy(tid),
                                 torch.from_numpy(pts)).numpy()
    is_marble = np.asarray(tt.kind)[tid] == TEX_MARBLE
    assert is_marble.any() and (~is_marble).any()
    np.testing.assert_allclose(out[is_marble], ref[is_marble], atol=2e-5,
                               rtol=0)
    assert np.all(out[~is_marble] == 0.0)
    assert np.all(ref[~is_marble] == 0.0)
    # the CPU wrapper is the plain version
    n0 = tk.marble_stripe_pallas.launches
    np.testing.assert_array_equal(
        tk.marble_stripe_pallas(tt, torch.from_numpy(tid),
                                torch.from_numpy(pts)).numpy(), out)
    assert tk.marble_stripe_pallas.launches == n0


def test_marble_all_skipped():
    jt, tt = _tables()
    r = 128
    pts = np.linspace(-2, 2, 3 * r).reshape(r, 3).astype(np.float32)
    tid = np.zeros(r, np.int32)
    ref = np.asarray(jmarble(jt, jnp.asarray(tid), jnp.asarray(pts),
                             interpret=True))
    out = tk.marble_stripe_plain(tt, torch.from_numpy(tid),
                                 torch.from_numpy(pts)).numpy()
    assert np.all(ref == 0.0) and np.all(out == 0.0)


_RUN = r"""
// The grid on the host: a block of kThreads host threads per tile.
extern "C" int run_marble(const MarbleArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + kTile - 1) / kTile),
                 kThreads, [&] { marble_kernel(*a); });
  return 0;
}

extern "C" void run_noise(const int* c, const unsigned* h, const float* p,
                          long long n, int depth, long long* ava,
                          long long* gh, float* turb) {
  const unsigned mul[3] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du};
  for (long long l = 0; l < n; ++l) {
    for (int a = 0; a < 3; ++a)
      ava[3 * l + a] = rt::noise_ava(static_cast<uint32_t>(c[l]), mul[a]);
    gh[l] = rt::noise_gradient_hash(h[l]);
    turb[l] = rt::turbulence(depth, p[3 * l], p[3 * l + 1], p[3 * l + 2]);
  }
}
"""


@pytest.fixture(scope="module")
def host_marble(tmp_path_factory):
    with torch_threads(1):
        yield _host_marble(tmp_path_factory)


def _host_marble(tmp_path_factory):
    lib = host_library("texture_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("marble_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_marble.argtypes = [ctypes.c_void_p]
    lib.run_noise.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64,
                              ctypes.c_int] + [ctypes.c_void_p] * 3)
    return lib


def test_host_build_of_noise_matches_plain(host_marble):
    rg = np.random.default_rng(5)
    n = 4096
    c = rg.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    h = rg.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    p = rg.uniform(-50, 50, (n, 3)).astype(np.float32)
    p[: n // 4] = np.round(p[: n // 4])
    ava = np.zeros((n, 3), np.int64)
    gh = np.zeros(n, np.int64)
    turb = np.zeros(n, np.float32)
    host_marble.run_noise(*(x.ctypes.data for x in (c, h, p)), n, 7,
                          *(x.ctypes.data for x in (ava, gh, turb)))
    tc = torch.from_numpy(c)
    for a, mul in enumerate(tn._AXIS_MUL):
        np.testing.assert_array_equal(ava[:, a], tn._ava(tc, mul).numpy())
    np.testing.assert_array_equal(
        gh, tn.gradient_hash(torch.from_numpy(h.astype(np.int64))).numpy())
    ref = tn.turbulence_soa(7, *torch.from_numpy(p).unbind(1)).numpy()
    np.testing.assert_allclose(turb, ref, atol=1e-6, rtol=0)


def _host_vs_plain(host_marble, table, tid, pts, mtbl):
    """Run the host build on the lanes and hold it against the plain
    version: marble lanes within 1e-5, every other lane exactly 0.
    Returns the number of marble lanes."""
    out = torch.full((pts.shape[0],), float("nan"))
    ttid = tid.to(torch.int32).contiguous()
    a = tk._MarbleArgs(mtbl.data_ptr(), ttid.data_ptr(), pts.data_ptr(),
                       out.data_ptr(), pts.shape[0], mtbl.shape[0])
    host_marble.run_marble(ctypes.byref(a))
    ref = tk.marble_stripe_plain(table, tid, pts, mtbl)
    is_marble = torch.isin(tid.to(torch.float32), mtbl[:, 0])
    np.testing.assert_allclose(out.numpy()[is_marble.numpy()],
                               ref.numpy()[is_marble.numpy()], atol=1e-5,
                               rtol=0)
    assert torch.all(out[~is_marble] == 0.0)
    return int(is_marble.sum())


def test_host_build_of_marble_kernel_matches_plain(host_marble):
    _, tt = _tables()
    pts, tid = _lanes(2048, 6)
    n = _host_vs_plain(host_marble, tt, torch.from_numpy(tid),
                       torch.from_numpy(pts), tk.marble_table(tt))
    assert n == int((np.asarray(tt.kind)[tid] == TEX_MARBLE).sum()) > 0


@pytest.mark.parametrize("pattern", ("alternating", "all", "none", "ragged",
                                     "rows32"))
def test_host_build_of_marble_kernel_on_patterns(host_marble, pattern):
    table, tid, pts, mtbl = marble_patterns(7, 512)[pattern]
    n = _host_vs_plain(host_marble, table, tid, pts, mtbl)
    r = tid.shape[0]
    assert n == {"alternating": (r + 1) // 2, "all": r, "none": 0,
                 "ragged": (r + 1) // 2}.get(pattern, n)
    if pattern == "ragged":
        assert r % 32 != 0
    if pattern == "rows32":
        # the repeated id takes the later row's stripe, as the plain
        # version's torch.where loop gives it
        rid = mtbl[20, 0]
        lanes = tid.to(torch.float32) == rid
        assert 0 < n < r and int(lanes.sum()) > 0
        r20 = mtbl[20]
        want = tk.marble_stripe_values(
            r20[1], r20[2], r20[3], r20[4], r20[5], r20[6], r20[7],
            pts[lanes, 0], pts[lanes, 1], pts[lanes, 2])
        ref = tk.marble_stripe_plain(table, tid, pts, mtbl)
        assert torch.equal(ref[lanes], want)


def test_host_build_of_marble_kernel_on_route_lanes(host_marble):
    """The lanes that the forward route hands K12 on noise_test (the rich
    lanes compacted by ``torch.nonzero``: noise ground and marble ball
    interleaved)."""
    scene, s = noise_test_scene(96, 1, 4, device="cpu")
    tid, pts = route_marble_lanes(scene, s, 3)
    n = _host_vs_plain(host_marble, scene.textures, tid, pts,
                       tk.marble_table(scene.textures))
    assert 0 < n < tid.shape[0]
