// 3-D Perlin gradient noise with the arithmetic lattice hash of
// raytrace_tpu/textures/noise.py (perlin_noise_soa, fractal_noise_soa,
// turbulence_soa), and the marble stripe built on it.  Plain version:
// textures/noise.py and ops/texture_kernel.py:marble_stripe_values.
// perlin_pair is two lattice corners' share of the noise; perlin_noise,
// fractal_noise and turbulence fold the corners and octaves one after
// another in one thread (the reference order), marble_stripe_group the
// same corners and octaves on several threads of a warp, in the same
// order.
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
// (z, phi) map.  sincosf gives the bits of separate sinf and cosf calls
// (held on the card by chip_smoke.py) with one range reduction.
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
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  gx = r * cos_phi;
  gy = r * sin_phi;
  gz = z;
}

__device__ __forceinline__ float smoothstep(float x) {
  return x * x * (3.0f - 2.0f * x);
}

// The terms of corners (i, j, 0) and (i, j, 1) (i, j each 0 or 1) of
// perlin_noise at p: each corner's gradient dotted with its offset, times
// its smoothstep weight, rounded as the plain version rounds them.
__device__ __forceinline__ void perlin_pair(float px, float py, float pz,
                                            int i, int j, float& t0,
                                            float& t1) {
  const float ipx = floorf(px), ipy = floorf(py), ipz = floorf(pz);
  const float fx = px - ipx, fy = py - ipy, fz = pz - ipz;
  const uint32_t cx = static_cast<uint32_t>(static_cast<int>(ipx));
  const uint32_t cy = static_cast<uint32_t>(static_cast<int>(ipy));
  const uint32_t cz = static_cast<uint32_t>(static_cast<int>(ipz));
  const uint32_t hxy =
      noise_ava(cx + static_cast<uint32_t>(i), 0x9E3779B1u) ^
      noise_ava(cy + static_cast<uint32_t>(j), 0x85EBCA77u);
  const float sx = smoothstep(fx), sy = smoothstep(fy), sz = smoothstep(fz);
  const float cxy = (i ? sx : 1.0f - sx) * (j ? sy : 1.0f - sy);
  const float ox = fx - static_cast<float>(i);
  const float oy = fy - static_cast<float>(j);
  float gx, gy, gz;
  noise_gradient(hxy ^ noise_ava(cz, 0xC2B2AE3Du), gx, gy, gz);
  t0 = (cxy * (1.0f - sz)) * (gx * ox + gy * oy + gz * fz);
  noise_gradient(hxy ^ noise_ava(cz + 1u, 0xC2B2AE3Du), gx, gy, gz);
  t1 = (cxy * sz) * (gx * ox + gy * oy + gz * (fz - 1.0f));
}

// The 8 corner terms summed in the plain order: i outer, then j, k inner.
__device__ __forceinline__ float perlin_noise(float px, float py, float pz) {
  float total = 0.0f;
  for (int p = 0; p < 4; ++p) {
    float t0, t1;
    perlin_pair(px, py, pz, p >> 1, p & 1, t0, t1);
    total = total + t0;
    total = total + t1;
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

// 0.5 + 0.5 sin(f (d . p) + 10 turb7(0.25 f p + s)) (Texture.hs:72-79),
// computed by a group of kSplit x kOct threads of a warp (threads
// kSplit kOct g .. kSplit kOct (g + 1) - 1, every thread of the warp
// calling it).  Thread ``part`` takes the octaves o = part / kSplit,
// part / kSplit + kOct, ... (the point scaled by 2^o, exactly as the plain
// version's doublings) and in each the corner pairs (i, j) p = (part %
// kSplit) 4 / kSplit .. + 4 / kSplit - 1 (i = p >> 1, j = p & 1); an
// octave's 8 terms meet by shuffles and are summed in perlin_noise's
// order, then the 7 octaves' noise meets and is folded in fractal_noise's
// order, so every thread returns the stripe, rounded as the plain version
// rounds it (an eighth octave slot, where 7 octaves do not fill the
// groups, is computed and dropped).
template <int kSplit, int kOct>
__device__ __forceinline__ float marble_stripe_group(
    float freq, float dx, float dy, float dz, float sx, float sy, float sz,
    float px, float py, float pz, int part) {
  static_assert(kSplit == 2 || kSplit == 4, "2 or 4 corner groups");
  static_assert(kOct == 1 || kOct == 2 || kOct == 4, "1, 2 or 4 octaves");
  constexpr int kTerms = 8 / kSplit;               // a thread's terms
  constexpr int kIters = (7 + kOct - 1) / kOct;   // a thread's octaves
  const int lead = static_cast<int>(threadIdx.x & 31u) & ~(kSplit * kOct - 1);
  const int og = part / kSplit;
  const float q = 0.25f * freq;
  const float x = q * px + sx, y = q * py + sy, z = q * pz + sz;
  float noise[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const float scale = static_cast<float>(1 << (og + kOct * it));
    float t[kTerms];
#pragma unroll
    for (int v = 0; v < kTerms / 2; ++v) {
      const int p = (part % kSplit) * (kTerms / 2) + v;
      perlin_pair(x * scale, y * scale, z * scale, p >> 1, p & 1, t[2 * v],
                  t[2 * v + 1]);
    }
    float perlin = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      perlin = perlin + __shfl_sync(0xffffffffu, t[c % kTerms],
                                    lead + og * kSplit + c / kTerms);
    noise[it] = perlin;
  }
  float total = 0.0f, coef = 1.0f;
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    total = total + coef * __shfl_sync(0xffffffffu, noise[o / kOct],
                                       lead + (o % kOct) * kSplit);
    coef = coef * 0.5f;
  }
  const float nz = 10.0f * fabsf(total);
  const float sin_arg = freq * (dx * px + dy * py + dz * pz);
  return 0.5f + 0.5f * sinf(sin_arg + nz);
}

}  // namespace rt
