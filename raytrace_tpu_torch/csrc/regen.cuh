// Regeneration of an idle lane, shared by kernel B (iter_kernel.cu) and the
// backward kernel K5 (bounce_bwd_kernel.cu): the counter-hash uniforms of
// the lane's (pixel, sample, depth) and, for a lane that starts its next
// sample, the thin-lens camera ray (thin_lens_ray, which the sorted
// driver's HEAD launch in sorted_turn.cu calls too).  Plain versions:
// ops/iter_kernel.py:iter_plain and ops/bounce_bwd_gather_kernel.py:
// regen_stage (render/camera.py:rays_from_table).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "rng.cuh"

namespace rt {

constexpr int kNCam = 24;             // camera table columns
constexpr int kNRegenCols = kNU + 6;  // bounce 8 + camera 5 + RR 1

struct Regen {
  bool can;        // the lane starts its next sample
  bool alive_pre;  // alive after regeneration
  int smp2, dep_pre;
  float us[kNRegenCols];
  float ray[7];  // regenerated origin (3), direction (3), time; 0 unless can
};

// The thin-lens camera ray of pixel `pix` (decoded with exact integer
// division) from the five uniforms `u5` (disk radius, disk angle, pixel
// jitter x2, time): origin (3), unit direction (3), time.  `cam`: the
// camera table's first 19 values (render/camera.py:camera_table).  Plain
// version: render/camera.py:rays_from_table.
__device__ __forceinline__ void thin_lens_ray(const float* cam, int width,
                                              int pix, const float* u5,
                                              float* ray) {
  const float i_f = static_cast<float>(pix % width);
  const float j_f = static_cast<float>(pix / width);
  const float r_l = sqrtf(u5[0]);
  const float th = RT_F(2.0 * kPiD) * u5[1];
  const float da = r_l * cosf(th) * cam[18];
  const float db = r_l * sinf(th) * cam[18];
  const float ii = i_f + u5[2];
  const float jj = j_f + u5[3];
  float n_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray[k] = cam[k] + da * cam[12 + k] + db * cam[15 + k];
    const float tk = cam[3 + k] + ii * cam[6 + k] + jj * cam[9 + k];
    n_d[k] = tk - ray[k];
  }
  const float inv = 1.0f / sqrtf(clamp_min(
      n_d[0] * n_d[0] + n_d[1] * n_d[1] + n_d[2] * n_d[2], RT_F(1e-24)));
#pragma unroll
  for (int k = 0; k < 3; ++k) ray[3 + k] = n_d[k] * inv;
  ray[6] = u5[4];
}

// kt: [4] i32 (key words, last sample); cam: [24] camera table.
__device__ __forceinline__ void regen(const int* kt, const float* cam,
                                      int width, int pix, int smp, int dep,
                                      bool alv, Regen& r) {
  r.can = !alv && smp < kt[2];
  r.smp2 = r.can ? smp + 1 : smp;
  r.dep_pre = r.can ? 0 : dep;
  r.alive_pre = alv || r.can;

  // RNG: ray_keys_fast + mix_depth + uniform_block (pair16)
  uint32_t k0, k1;
  ray_keys_fast(static_cast<uint32_t>(kt[0]), static_cast<uint32_t>(kt[1]),
                static_cast<uint32_t>(pix), static_cast<uint32_t>(r.smp2), k0,
                k1);
  mix_depth(k0, k1, static_cast<uint32_t>(r.dep_pre));
  uniform_cols_pair16<kNRegenCols>(k0, k1, r.us);

#pragma unroll
  for (int k = 0; k < 7; ++k) r.ray[k] = 0.0f;
  if (!r.can) return;
  thin_lens_ray(cam, width, pix, r.us + kNU, r.ray);
}

}  // namespace rt
