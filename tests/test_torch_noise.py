"""The port's Perlin noise against the JAX package's
(``raytrace_tpu/textures/noise.py``).

Integer stages are held exactly: the lattice-coordinate avalanche
(``_ava``) for each axis multiplier on coordinates of both signs, and the
corner-hash avalanche through its low 16 bits, which fix JAX's gradient
``z`` bit for bit (the high 16 bits feed ``phi``, held against a numpy
uint32 transcription of ``_hash_gradient``).  Float stages: the noise of
seeded points (negative coordinates, points on lattice points and one ulp
either side) for 1-7 octaves, with the arithmetic hash and with the
reference tables.  Tolerance: every lane within ``ATOL = 1e-6`` (measured
1.2e-7): XLA's CPU backend contracts multiply-adds into FMAs in the blend,
which moves the last bits; no ``floor`` input is computed in a way the
contraction changes (the points and their doublings are exact), so no
lane takes another lattice cell and the share of lanes beyond ``ATOL`` is
held to 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.textures import noise as jn
from raytrace_tpu_torch.textures import noise as tn

ATOL = 1e-6


def _points(n: int, seed: int) -> np.ndarray:
    rg = np.random.default_rng(seed)
    p = rg.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)
    q = n // 4
    lattice = np.round(p[:q])
    p[:q] = lattice                                  # on lattice points
    p[q:2 * q] = np.nextafter(lattice, np.float32(np.inf))
    p[2 * q:3 * q] = np.nextafter(lattice, np.float32(-np.inf))
    return p


def test_lattice_avalanche_is_bit_exact():
    rg = np.random.default_rng(1)
    c = np.concatenate([rg.integers(-2 ** 31, 2 ** 31 - 1, 4000),
                        np.arange(-300, 300), [2 ** 31 - 1, -2 ** 31]])
    c = c.astype(np.int32)
    for mul in tn._AXIS_MUL:
        ref = np.asarray(jn._ava(jnp.asarray(c), mul)).view(np.uint32)
        out = tn._ava(torch.from_numpy(c), mul).numpy()
        np.testing.assert_array_equal(out, ref.astype(np.int64))


def _np_gradient_hash(h: np.ndarray) -> np.ndarray:
    """``_hash_gradient``'s integer stage, transcribed in numpy uint32."""
    u = h.astype(np.uint32)
    u = (u ^ (u >> np.uint32(4))) * np.uint32(0x21F0AAAD)
    u = u ^ (u >> np.uint32(15))
    u = u * np.uint32(0x735A2D97)
    return u ^ (u >> np.uint32(13))


def test_corner_hash_and_gradient():
    rg = np.random.default_rng(2)
    h = rg.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.int64)
    u = tn.gradient_hash(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(u, _np_gradient_hash(h).astype(np.int64))
    gx, gy, gz = (x.numpy() for x in tn._hash_gradient(torch.from_numpy(h)))
    jx, jy, jz = (np.asarray(x) for x in jn._hash_gradient(
        jnp.asarray(h.astype(np.uint32).view(np.int32))))
    # z comes from the low 16 bits alone: bit for bit
    np.testing.assert_array_equal(gz, jz)
    # x, y through cos/sin of phi: a few ulps of a unit vector
    np.testing.assert_allclose(gx, jx, atol=4e-7, rtol=0)
    np.testing.assert_allclose(gy, jy, atol=4e-7, rtol=0)


@pytest.mark.parametrize("use_tables", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7])
def test_fractal_noise_matches_jax(use_tables, depth):
    p = _points(4096, 10 + depth)
    ref = np.asarray(jn.fractal_noise(depth, jnp.asarray(p),
                                      use_tables=use_tables))
    out = tn.fractal_noise(depth, torch.from_numpy(p),
                           use_tables=use_tables).numpy()
    assert np.isfinite(out).all()
    diff = np.abs(out - ref)
    assert diff.max() <= ATOL, diff.max()
    assert np.abs(ref).max() > 0.1


def test_soa_and_turbulence_match_jax():
    p = _points(4096, 3)
    ref = np.asarray(jn.perlin_noise_soa(*(jnp.asarray(p[:, k])
                                            for k in range(3))))
    out = tn.perlin_noise_soa(*(torch.from_numpy(p[:, k])
                                for k in range(3))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the SoA form is the use_tables=False form, exactly
    np.testing.assert_array_equal(
        out, tn.perlin_noise(torch.from_numpy(p)).numpy())
    ref7 = np.asarray(jn.turbulence_soa(7, *(jnp.asarray(p[:, k])
                                             for k in range(3))))
    out7 = tn.turbulence_soa(7, *(torch.from_numpy(p[:, k])
                                  for k in range(3))).numpy()
    np.testing.assert_allclose(out7, ref7, atol=ATOL, rtol=0)
    assert (out7 >= 0).all()
    np.testing.assert_array_equal(
        out7, tn.turbulence(7, torch.from_numpy(p)).numpy())
