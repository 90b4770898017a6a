// Kernels K11 and K11b: the boundary crossings of every ray with every
// constant-density medium, for the medium's free-flight candidate.
//
// Replace raytrace_tpu/ops/pallas/volume_kernel.py:pallas_volume_crossings
// (_kernel over _volume_loop: a scalar loop over the rows, the ray tile in
// vector registers) and pallas_volume_crossings_bcast (_bcast_kernel: the
// rows of a 256-row chunk against a row of rays as one broadcast tile,
// reduced with the fold's tie rules, a whole chunk skipped when no ray of
// the row can reach its box before its second crossing).  Plain PyTorch
// version: ops/volume_kernel.py:volume_crossings_plain.
//
// What bounds them on an H100: K11 operations (a ray reads 28 bytes and
// writes 12 per medium, then tests every row of a small boundary, about
// 60 operations a row: the sphere, plane or box roots and two folds);
// K11b neither, once it walks a tree: a few box tests and rows a ray are
// far below the card's float32 rate, and the walk's dependent loads and
// the warp's slowest lane bound it, as they bound the nearest walk K9.
// * rt_volume_crossings (K11, boundary tables under 64 rows) is one
//   thread per ray; it stages each medium's rows through shared memory in
//   tiles of 256 rows, as K8 does (every thread of a block reads the same
//   row at once, a broadcast), and folds them in row order;
// * rt_volume_crossings_bvh (K11b, mesh boundaries) walks each medium's
//   binned-SAH tree near child first (bvh_crossings.cuh), culling a node
//   the ray reaches only beyond its second crossing, with the fold made
//   independent of the visiting order, and a triangle-only row test for
//   boundaries of unmoving triangles; it runs on a persistent grid (as
//   many blocks as the card holds, a grid-stride loop over the rays), as
//   the nearest walk does (one thread per ray measured no faster).  The
//   TPU kernel's 256-row chunks tested 209 rows a camera ray of the pawn
//   stand-in (a chunk of a revolved mesh spans a band around the whole
//   pawn); the tree tests about 2.4 rows and 9 boxes (PERF.md section 6).
// K11 folds each row's entering root before its exit root with a strict
// <, which is the TPU tile reduction's order (lowest row first); K11b's
// keyed fold gives the same bits in any order.
#include <cuda_runtime.h>

#include "bvh_crossings.cuh"
#include "common.cuh"
#include "prim_loop.cuh"
#include "volume.cuh"

constexpr int kMaxVolumes = 16;

// Field order and types mirror ops/volume_kernel.py:_VolArgs.
struct VolArgs {
  const float* tbl;    // [rows, 36] packed boundary rows (K11)
  const float* nodes;  // [n_nodes, 16] the media's trees (K11b)
  const float* rows;   // [n_real, 36] leaf-ordered boundary rows (K11b)
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;  // [R]
  float* out;          // [3 n_vol, R]: t1, front1, t2 per medium
  int* visits;         // [2, R]: box tests and row tests (K11b), or null
  long long n_lanes;
  int n_vol, has_motion, has_box, tri_only;  // tri_only: K11b's rows
  float t_min;
  int starts[kMaxVolumes], counts[kMaxVolumes];  // each medium's rows
  int roots[kMaxVolumes];  // each medium's root node (K11b)
};

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 256;

__device__ __forceinline__ void write_out(const VolArgs& a, int v,
                                          long long l,
                                          const rt::Crossings& s) {
  const long long R = a.n_lanes;
  a.out[(3LL * v + 0) * R + l] = s.b1;
  a.out[(3LL * v + 1) * R + l] = s.f1;
  a.out[(3LL * v + 2) * R + l] = s.b2;
}

__global__ void __launch_bounds__(kThreads)
volume_crossings_kernel(const VolArgs a) {
  __shared__ float tile[kTileRows * rt::kCols];
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool live = l < a.n_lanes;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float tm = 0.0f;
  if (live) {
    ox = a.ox[l];
    oy = a.oy[l];
    oz = a.oz[l];
    dx = a.dx[l];
    dy = a.dy[l];
    dz = a.dz[l];
    tm = a.tm[l];
  }
  const float inv_dx = 1.0f / rt::safe_dir(dx);
  const float inv_dy = 1.0f / rt::safe_dir(dy);
  const float inv_dz = 1.0f / rt::safe_dir(dz);
  const bool motion = a.has_motion != 0, box = a.has_box != 0;
#pragma unroll 1
  for (int v = 0; v < a.n_vol; ++v) {
    rt::Crossings s = rt::no_crossings();
    const int end = a.starts[v] + a.counts[v];
#pragma unroll 1
    for (int base = a.starts[v]; base < end; base += kTileRows) {
      const int n = min(kTileRows, end - base);
      __syncthreads();  // every thread is done with the previous tile
      rt::stage(tile, a.tbl + static_cast<long long>(base) * rt::kCols,
                n * rt::kCols);
      __syncthreads();
      if (live) {
#pragma unroll 1
        for (int k = 0; k < n; ++k)
          rt::cross_row(rt::PtrRow{tile + k * rt::kCols}, ox, oy, oz, dx, dy,
                        dz, inv_dx, inv_dy, inv_dz, tm, a.t_min, motion, box,
                        s);
      }
    }
    if (live) write_out(a, v, l, s);
  }
}

// At least 8 blocks a SM: ptxas then keeps the walk in 64 registers,
// where it chose 48 and spilled (measured 2% faster on an H100).
template <bool kTriOnly, bool kCount>
__global__ void __launch_bounds__(kThreads, 8)
volume_bvh_kernel(const VolArgs a) {
  const rt::Bvh bvh{reinterpret_cast<const float4*>(a.nodes), a.rows};
  const long long R = a.n_lanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool motion = a.has_motion != 0, box = a.has_box != 0;
#pragma unroll 1
  for (long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       l < R; l += stride) {
    const float ox = a.ox[l], oy = a.oy[l], oz = a.oz[l];
    const float dx = a.dx[l], dy = a.dy[l], dz = a.dz[l];
    const float tm = a.tm[l];
    const float inv_dx = 1.0f / rt::safe_dir(dx);
    const float inv_dy = 1.0f / rt::safe_dir(dy);
    const float inv_dz = 1.0f / rt::safe_dir(dz);
    rt::Visits v;
#pragma unroll 1
    for (int m = 0; m < a.n_vol; ++m)
      write_out(a, m, l,
                rt::bvh_crossings<kTriOnly, kCount>(
                    bvh, a.roots[m], ox, oy, oz, dx, dy, dz, inv_dx, inv_dy,
                    inv_dz, tm, a.t_min, motion, box, &v));
    if (kCount) {
      a.visits[l] = v.nodes;
      a.visits[R + l] = v.rows;
    }
  }
}

#ifdef __CUDACC__
template <bool kTriOnly, bool kCount>
int launch_bvh(const VolArgs* a, cudaStream_t s) {
  static rt::Resident cache;
  const auto kernel = volume_bvh_kernel<kTriOnly, kCount>;
  int blocks = 0;
  cudaError_t e = rt::resident_blocks(reinterpret_cast<const void*>(kernel),
                                      kThreads, 0, cache, blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (a->n_lanes + kThreads - 1) / kThreads;
  if (need < blocks) blocks = static_cast<int>(need);
  kernel<<<blocks < 1 ? 1 : blocks, kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // namespace

extern "C" int rt_volume_crossings(const VolArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_vol <= 0 || a->n_vol > kMaxVolumes) return cudaErrorInvalidValue;
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  volume_crossings_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_volume_crossings_bvh(const VolArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_vol <= 0 || a->n_vol > kMaxVolumes) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool count = a->visits != nullptr;
  if (a->tri_only)
    return count ? launch_bvh<true, true>(a, s)
                 : launch_bvh<true, false>(a, s);
  return count ? launch_bvh<false, true>(a, s)
               : launch_bvh<false, false>(a, s);
}
