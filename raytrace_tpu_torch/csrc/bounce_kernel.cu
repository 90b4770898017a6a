// Kernel A: one full path-tracing bounce per lane.
//
// Replaces raytrace_tpu/ops/pallas/bounce_kernel.py:bounce_megakernel
// (body _kernel = prim_loop -> _prim_loop_flat + _shade_values).  Plain
// PyTorch version: ops/bounce_kernel.py:bounce_plain.
//
// What bounds it on an H100: instructions and latency, not bytes.  A lane
// reads 11 floats + 8 uniforms and writes 15 floats (~136 B), then tests
// every row of the table (~60 operations, an IEEE division) and shades
// (~300), with data-dependent branches.  One thread per lane over 1-D SoA
// arrays (coalesced loads and stores), the primitive, material and target
// tables staged in shared memory (every thread reads the same row at the
// same time, a broadcast), no block consensus, clustering or tiling.  What
// the design does about the instructions:
// * a planar instantiation (kPlanar) for tables whose rows are all
//   unmoving parallelograms and triangles (ops/bounce_kernel.py:
//   planar_only; the Cornell box): each row is four float4 loads from
//   shared memory and prim_test's planar branch only, the scan carries
//   only (t, row), and the winner's record is built once after the scan
//   (prim_loop.cuh:planar_loop); other tables (spheres, boxes, motion)
//   take prim_loop, which decides each row's kind and builds the record
//   of every row that wins;
// * one block of 128 lanes per 128 threads, each block staging the tables:
//   a persistent grid (as many blocks as the card holds, each staging once
//   and striding over the lanes) was measured 7% slower for kernel A on an
//   H100 (PERF.md section 6), so it went.
#include <cuda_runtime.h>

#include "common.cuh"
#include "prim_loop.cuh"
#include "shade.cuh"

// Field order and types mirror ops/bounce_kernel.py:_BounceArgs.
struct BounceArgs {
  const float* ptbl;  // [>=n_prims, 36]
  const float* mtbl;  // [>=n_mats, 12]
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm, *tr, *tg, *tb, *al;  // [R]
  const float* uni;   // [8, R]
  float* out;         // [15, R]
  long long n_lanes;
  int n_prims, n_mats, n_targets, has_motion, use_prim_albedo, planar;
  float t_min;
};

namespace {

constexpr int kThreads = 128;

template <bool kPlanar>
__global__ void __launch_bounds__(kThreads)
bounce_kernel(const BounceArgs a) {
  float* sp = rt::dyn_smem();  // 144-byte rows: each 16-byte aligned
  float* sm = sp + a.n_prims * rt::kCols;
  float* st = sm + a.n_mats * rt::kMCols;
  rt::stage(sp, a.ptbl, a.n_prims * rt::kCols);
  rt::stage(sm, a.mtbl, a.n_mats * rt::kMCols);
  rt::stage(st, a.ttbl, a.n_targets * rt::kTCols);
  __syncthreads();

  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const long long R = a.n_lanes;
  const bool albedo = a.use_prim_albedo != 0;
  const float ox = a.ox[l], oy = a.oy[l], oz = a.oz[l];
  const float dx = a.dx[l], dy = a.dy[l], dz = a.dz[l];
  float u[rt::kNU];
#pragma unroll
  for (int c = 0; c < rt::kNU; ++c) u[c] = a.uni[c * R + l];

  const rt::HitRec hr =
      kPlanar ? rt::planar_loop(sp, a.n_prims, ox, oy, oz, dx, dy, dz,
                                a.t_min, albedo)
              : rt::prim_loop(sp, a.n_prims, ox, oy, oz, dx, dy, dz, a.tm[l],
                              a.t_min, a.has_motion != 0, albedo);
  const rt::ShadeOut s = rt::shade(
      hr, sm, a.n_mats, st, a.n_targets, albedo, ox, oy, oz, dx, dy, dz,
      a.tr[l], a.tg[l], a.tb[l], a.al[l] > 0.5f, u);

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

#ifdef __CUDACC__
template <bool kPlanar>
int launch_bounce(const BounceArgs* a, cudaStream_t stream) {
  const auto kernel = bounce_kernel<kPlanar>;
  const int smem = static_cast<int>(
      sizeof(float) * (a->n_prims * rt::kCols + a->n_mats * rt::kMCols +
                       a->n_targets * rt::kTCols));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // namespace

extern "C" int rt_bounce(const BounceArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return a->planar ? launch_bounce<true>(a, s) : launch_bounce<false>(a, s);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
