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
  kernel to equality); non-marble lanes exactly 0.
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
from raytrace_tpu_torch.testing import host_library
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
extern "C" int run_marble(const MarbleArgs* a) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long l = 0; l < a->n_lanes; ++l) {
    blockIdx.x = static_cast<unsigned>(l);
    marble_kernel(*a);
  }
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


def test_host_build_of_marble_kernel_matches_plain(host_marble):
    _, tt = _tables()
    pts, tid = _lanes(2048, 6)
    mtbl = tk.marble_table(tt)
    out = torch.full((pts.shape[0],), -1.0)
    tpts, ttid = torch.from_numpy(pts), torch.from_numpy(tid)
    a = tk._MarbleArgs(mtbl.data_ptr(), ttid.data_ptr(), tpts.data_ptr(),
                       out.data_ptr(), pts.shape[0], mtbl.shape[0])
    host_marble.run_marble(ctypes.byref(a))
    ref = tk.marble_stripe_plain(tt, ttid, tpts)
    is_marble = np.asarray(tt.kind)[tid] == TEX_MARBLE
    np.testing.assert_allclose(out.numpy()[is_marble],
                               ref.numpy()[is_marble], atol=1e-5, rtol=0)
    assert np.all(out.numpy()[~is_marble] == 0.0)
