// The shade stage alone, fed a precomputed hit record (and, with a medium,
// each lane's nearest medium event).
//
// Replaces raytrace_tpu/ops/pallas/bounce_kernel.py:shade_megakernel (body
// _shade_only_kernel -> _shade -> _shade_values), the split path's shade
// after the nearest-hit kernel.  Plain PyTorch version:
// ops/bounce_kernel.py:shade_plain.
//
// What bounds it on an H100: bytes.  A lane reads 10 hit words, 2 medium
// words, 10 lane words and 8 uniforms and writes 15 words (~180 B) and
// spends a few hundred flops on the material switch, the scatter and the
// MIS pdf; at 67 TFLOP/s that is far below the time its bytes take at
// 3.35 TB/s.  The design: one thread per lane over 1-D SoA arrays
// (coalesced loads and stores), the material and target tables staged once
// per block in shared memory, the shade arithmetic of kernel A (shade.cuh)
// unchanged.  A medium event nearer than the surface replaces the record:
// the normal faces the ray, the front flag is set, uv is zero and the
// material is the medium's.  Lanes whose sphere flag is set evaluate the
// sphere uv in the kernel; a winner listed in the rotation table (rows of
// index and world->object rotation, read through the cache by those lanes
// only) has its outward normal turned into object space first.
#include <cuda_runtime.h>

#include "common.cuh"
#include "prim_loop.cuh"
#include "shade.cuh"

// Field order and types mirror ops/bounce_kernel.py:_ShadeArgs.
struct ShadeArgs {
  const float* mtbl;  // [>=n_mats, 12]
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float *t, *bi, *nx, *ny, *nz, *fr, *uu, *vv, *mat, *sph;  // [R]
  const float *tmed, *vmat;  // [R], read only with has_medium
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tr, *tg, *tb, *al;  // [R]
  const float* uni;   // [8, R]
  const float* rots;  // [n_rots, 10] sphere rotations, read with n_rots > 0
  float* out;         // [15, R]
  long long n_lanes;
  int n_mats, n_targets, has_medium, n_rots;
};

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) shade_kernel(const ShadeArgs a) {
  float* sm = rt::dyn_smem();
  float* st = sm + a.n_mats * rt::kMCols;
  rt::stage(sm, a.mtbl, a.n_mats * rt::kMCols);
  rt::stage(st, a.ttbl, a.n_targets * rt::kTCols);
  __syncthreads();

  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const long long R = a.n_lanes;
  const float ox = a.ox[l], oy = a.oy[l], oz = a.oz[l];
  const float dx = a.dx[l], dy = a.dy[l], dz = a.dz[l];
  float u[rt::kNU];
#pragma unroll
  for (int c = 0; c < rt::kNU; ++c) u[c] = a.uni[c * R + l];

  rt::HitRec hr = rt::miss_record();
  hr.t = a.t[l];
  hr.bi = a.bi[l];
  hr.nx = a.nx[l];
  hr.ny = a.ny[l];
  hr.nz = a.nz[l];
  hr.fr = a.fr[l];
  hr.uu = a.uu[l];
  hr.vv = a.vv[l];
  hr.mat = a.mat[l];
  hr.sph = a.sph[l];
  if (a.has_medium) {
    const float tmv = a.tmed[l];
    if (tmv < hr.t) {
      hr.t = tmv;
      hr.mat = a.vmat[l];
      hr.nx = -dx;
      hr.ny = -dy;
      hr.nz = -dz;
      hr.fr = 1.0f;
      hr.uu = 0.0f;
      hr.vv = 0.0f;
      hr.sph = 0.0f;
    }
  }
  const rt::ShadeOut s =
      rt::shade(hr, sm, a.n_mats, st, a.n_targets, false, ox, oy, oz, dx, dy,
                dz, a.tr[l], a.tg[l], a.tb[l], a.al[l] > 0.5f, u, a.rots,
                a.n_rots);

  float* o = a.out;
  o[0 * R + l] = s.o[0];
  o[1 * R + l] = s.o[1];
  o[2 * R + l] = s.o[2];
  o[3 * R + l] = s.d[0];
  o[4 * R + l] = s.d[1];
  o[5 * R + l] = s.d[2];
  o[6 * R + l] = s.thr[0];
  o[7 * R + l] = s.thr[1];
  o[8 * R + l] = s.thr[2];
  o[9 * R + l] = s.em[0];
  o[10 * R + l] = s.em[1];
  o[11 * R + l] = s.em[2];
  o[12 * R + l] = s.alive;
  o[13 * R + l] = s.miss;
  o[14 * R + l] = s.bi;
}

}  // namespace

extern "C" int rt_shade(const ShadeArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  const size_t smem = sizeof(float) * (a->n_mats * rt::kMCols +
                                       a->n_targets * rt::kTCols);
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  shade_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
