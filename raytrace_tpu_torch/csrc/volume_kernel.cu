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
// What bounds them on an H100: operations.  A ray reads 28 bytes and
// writes 12 per medium, then tests every row of a small boundary (about 60
// operations a row: the sphere, plane or box roots and two folds).  The
// design is the simple one, one thread per ray:
// * rt_volume_crossings (K11, boundary tables under 64 rows) stages each
//   medium's rows through shared memory in tiles of 256 rows, as K8 does
//   (every thread of a block reads the same row at once, a broadcast), and
//   folds them in row order;
// * rt_volume_crossings_chunked (K11b, mesh boundaries) walks each
//   medium's 256-row chunks (ops/volume_kernel.py:_chunk_plans) and tests
//   a chunk's box against [t_min, t2] first, exactly _bcast_kernel's box
//   test, skipping the chunk if the ray misses it: the per-ray form of the
//   TPU's per-row consensus.  A chunk the ray reaches only beyond its
//   second crossing cannot lower the first or second crossing, nor the
//   front flag that follows the first, so culling never changes the
//   result.  Rays of a warp skip different chunks, so rows are read
//   through the read-only cache instead of shared memory.
// Both fold each row's entering root before its exit root with a strict
// <, which is the TPU tile reduction's order (lowest row first).
#include <cuda_runtime.h>

#include "common.cuh"
#include "prim_loop.cuh"
#include "volume.cuh"

constexpr int kMaxVolumes = 16;

// Field order and types mirror ops/volume_kernel.py:_VolArgs.
struct VolArgs {
  const float* tbl;   // [rows, 36] packed boundary rows
  const float* cbox;  // [n_chunks, 8] chunk boxes (K11b)
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;  // [R]
  float* out;         // [3 n_vol, R]: t1, front1, t2 per medium
  int* rows_tested;   // [R] or null (K11b)
  long long n_lanes;
  int n_vol, has_motion, has_box;
  float t_min;
  int starts[kMaxVolumes], counts[kMaxVolumes];
};

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 256;
constexpr int kChunk = 256;   // ops/volume_kernel.py:BCAST_CHUNK
constexpr int kBoxCols = 8;

struct LdgRow {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const {
    return __ldg(p + k);
  }
};

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

__global__ void __launch_bounds__(kThreads)
volume_chunked_kernel(const VolArgs a) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const float ox = a.ox[l], oy = a.oy[l], oz = a.oz[l];
  const float dx = a.dx[l], dy = a.dy[l], dz = a.dz[l];
  const float tm = a.tm[l];
  const float inv_dx = 1.0f / rt::safe_dir(dx);
  const float inv_dy = 1.0f / rt::safe_dir(dy);
  const float inv_dz = 1.0f / rt::safe_dir(dz);
  const bool motion = a.has_motion != 0, box = a.has_box != 0;
  int tested = 0;
  int ci = 0;  // chunk index over all media, as pack_chunk_boxes
#pragma unroll 1
  for (int v = 0; v < a.n_vol; ++v) {
    rt::Crossings s = rt::no_crossings();
    const int start = a.starts[v];
    const int end = start + a.counts[v];
#pragma unroll 1
    for (int p = (start / 8) * 8; p < end; ++ci) {
      const int ln = min(kChunk, ((end - p + 7) / 8) * 8);
      // the chunk box against [t_min, b2] (_bcast_kernel's box_test)
      const float* bx = a.cbox + static_cast<long long>(ci) * kBoxCols;
      const float t0x = (__ldg(bx + 0) - ox) * inv_dx;
      const float t1x = (__ldg(bx + 3) - ox) * inv_dx;
      const float t0y = (__ldg(bx + 1) - oy) * inv_dy;
      const float t1y = (__ldg(bx + 4) - oy) * inv_dy;
      const float t0z = (__ldg(bx + 2) - oz) * inv_dz;
      const float t1z = (__ldg(bx + 5) - oz) * inv_dz;
      const float tn = rt::tmax(rt::tmax(rt::tmin(t0x, t1x),
                                         rt::tmin(t0y, t1y)),
                                rt::tmax(rt::tmin(t0z, t1z), a.t_min));
      const float tf = rt::tmin(rt::tmin(rt::tmax(t0x, t1x),
                                         rt::tmax(t0y, t1y)),
                                rt::tmin(rt::tmax(t0z, t1z), s.b2));
      if (tn <= tf) {
        const int r1 = min(p + ln, end);
#pragma unroll 1
        for (int r = max(p, start); r < r1; ++r)
          rt::cross_row(LdgRow{a.tbl + static_cast<long long>(r) * rt::kCols},
                        ox, oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, tm,
                        a.t_min, motion, box, s);
        tested += r1 - max(p, start);
      }
      p += ln;
    }
    write_out(a, v, l, s);
  }
  if (a.rows_tested) a.rows_tested[l] = tested;
}

}  // namespace

extern "C" int rt_volume_crossings(const VolArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_vol <= 0 || a->n_vol > kMaxVolumes) return cudaErrorInvalidValue;
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  volume_crossings_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_volume_crossings_chunked(const VolArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_vol <= 0 || a->n_vol > kMaxVolumes) return cudaErrorInvalidValue;
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  volume_chunked_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
