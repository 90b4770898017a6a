// 3-D Perlin gradient noise with the arithmetic lattice hash of
// raytrace_tpu/textures/noise.py (perlin_noise_soa, fractal_noise_soa,
// turbulence_soa), and the marble stripe built on it.  Plain version:
// textures/noise.py and ops/texture_kernel.py:marble_stripe_values.
//
// The hash is 32-bit unsigned arithmetic, bit for bit the JAX package's
// (_ava, _hash_gradient).  The float stages keep the plain version's
// association; the build uses --fmad=false.  A lattice coordinate is the
// floored coordinate converted to int32 as torch converts it on the card
// (round toward zero, saturating).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rt {

// Murmur avalanche of the period-256 lattice coordinate c (its bits).
__device__ __forceinline__ uint32_t noise_ava(uint32_t c, uint32_t mul) {
  uint32_t u = (c & 255u) * mul;
  u = (u ^ (u >> 4)) * 0x21F0AAADu;
  return u ^ (u >> 15);
}

// The avalanche of a corner hash that noise_gradient maps to a unit vector.
__device__ __forceinline__ uint32_t noise_gradient_hash(uint32_t h) {
  uint32_t u = (h ^ (h >> 4)) * 0x21F0AAADu;
  u = u ^ (u >> 15);
  u = u * 0x735A2D97u;
  return u ^ (u >> 13);
}

// Uniform unit vector of a corner hash: two 16-bit uniforms through the
// (z, phi) map.
__device__ __forceinline__ void noise_gradient(uint32_t h, float& gx,
                                               float& gy, float& gz) {
  const uint32_t u = noise_gradient_hash(h);
  const float u1 =
      static_cast<float>(static_cast<int>(u & 0xFFFFu)) * RT_F(1.0 / 65536.0);
  const float u2 =
      static_cast<float>(static_cast<int>(u >> 16)) * RT_F(1.0 / 65536.0);
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = RT_F(2.0 * kPiD) * u2;
  gx = r * cosf(phi);
  gy = r * sinf(phi);
  gz = z;
}

__device__ __forceinline__ float smoothstep(float x) {
  return x * x * (3.0f - 2.0f * x);
}

__device__ __forceinline__ float perlin_noise(float px, float py, float pz) {
  const float ipx = floorf(px), ipy = floorf(py), ipz = floorf(pz);
  const float fx = px - ipx, fy = py - ipy, fz = pz - ipz;
  const uint32_t cx = static_cast<uint32_t>(static_cast<int>(ipx));
  const uint32_t cy = static_cast<uint32_t>(static_cast<int>(ipy));
  const uint32_t cz = static_cast<uint32_t>(static_cast<int>(ipz));
  const uint32_t hx[2] = {noise_ava(cx, 0x9E3779B1u),
                          noise_ava(cx + 1u, 0x9E3779B1u)};
  const uint32_t hy[2] = {noise_ava(cy, 0x85EBCA77u),
                          noise_ava(cy + 1u, 0x85EBCA77u)};
  const uint32_t hz[2] = {noise_ava(cz, 0xC2B2AE3Du),
                          noise_ava(cz + 1u, 0xC2B2AE3Du)};
  const float sx = smoothstep(fx), sy = smoothstep(fy), sz = smoothstep(fz);
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float gx, gy, gz;
        noise_gradient(hx[i] ^ hy[j] ^ hz[k], gx, gy, gz);
        const float dot = gx * (fx - static_cast<float>(i)) +
                          gy * (fy - static_cast<float>(j)) +
                          gz * (fz - static_cast<float>(k));
        const float coef = (i ? sx : 1.0f - sx) * (j ? sy : 1.0f - sy) *
                           (k ? sz : 1.0f - sz);
        total = total + coef * dot;
      }
    }
  }
  return total;
}

__device__ __forceinline__ float fractal_noise(int depth, float px, float py,
                                               float pz) {
  float total = 0.0f, coef = 1.0f;
#pragma unroll 1
  for (int o = 0; o < depth; ++o) {
    total = total + coef * perlin_noise(px, py, pz);
    coef = coef * 0.5f;
    px = px * 2.0f;
    py = py * 2.0f;
    pz = pz * 2.0f;
  }
  return total;
}

__device__ __forceinline__ float turbulence(int depth, float px, float py,
                                            float pz) {
  return fabsf(fractal_noise(depth, px, py, pz));
}

// 0.5 + 0.5 sin(f (d . p) + 10 turb7(0.25 f p + s)) (Texture.hs:72-79).
__device__ __forceinline__ float marble_stripe(float freq, float dx, float dy,
                                               float dz, float sx, float sy,
                                               float sz, float px, float py,
                                               float pz) {
  const float q = 0.25f * freq;
  const float nz =
      10.0f * turbulence(7, q * px + sx, q * py + sy, q * pz + sz);
  const float sin_arg = freq * (dx * px + dy * py + dz * pz);
  return 0.5f + 0.5f * sinf(sin_arg + nz);
}

}  // namespace rt
