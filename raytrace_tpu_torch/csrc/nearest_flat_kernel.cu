// Kernel K8: the nearest hit record of every ray by a flat scan of a small
// or unsegmented packed table.
//
// Replaces raytrace_tpu/ops/pallas/intersect_kernel.py:pallas_nearest_record
// (_kernel over prim_loop: the flat, segmented and clustered scans).  Its
// clustered consensus (64-row cluster boxes tested once per block of
// lanes) keeps a TPU's vector unit busy and has no counterpart: the tables
// this kernel serves are small (under 192 rows, or unsegmented ones, which
// the compiler keeps under 65 rows), and mesh-scale tables take the BVH
// walk of nearest_kernel.cu.  Plain PyTorch version:
// ops/intersect_kernel.py:prim_loop_plain (through _record_contract).
//
// What bounds it on an H100: operations, at the table sizes it serves.  A
// ray reads 28 bytes and writes 36; it then tests every row of the table
// (about 45 operations a row).  The design is the simple one: one thread
// per ray, the table staged through shared memory in tiles of 256 rows (so
// no row cap applies; every thread of a block reads the same row at once,
// a broadcast), and the per-row test of prim_loop.cuh, whose rows visited
// in order give the lowest row on a tie.
#include <cuda_runtime.h>

#include "common.cuh"
#include "prim_loop.cuh"

// Field order and types mirror ops/intersect_kernel.py:_FlatArgs.
struct FlatArgs {
  const float* tbl;  // [>=n_prims, 36] packed table
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;  // [R]
  float* outf;       // [6, R]: t, nx, ny, nz, u, v
  int* outi;         // [3, R]: idx, front | sphere << 1, mat
  long long n_lanes;
  int n_prims, has_motion;
  float t_min;
};

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 256;

__global__ void __launch_bounds__(kThreads)
nearest_flat_kernel(const FlatArgs a) {
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
  rt::HitRec h = rt::miss_record();
  const float inv_dx = 1.0f / rt::safe_dir(dx);
  const float inv_dy = 1.0f / rt::safe_dir(dy);
  const float inv_dz = 1.0f / rt::safe_dir(dz);
#pragma unroll 1
  for (int base = 0; base < a.n_prims; base += kTileRows) {
    const int n = min(kTileRows, a.n_prims - base);
    __syncthreads();  // every thread is done with the previous tile
    rt::stage(tile, a.tbl + static_cast<long long>(base) * rt::kCols,
              n * rt::kCols);
    __syncthreads();
    if (live) {
#pragma unroll 1
      for (int k = 0; k < n; ++k)
        rt::prim_test(rt::PtrRow{tile + k * rt::kCols}, base + k, ox, oy, oz,
                      dx, dy, dz, inv_dx, inv_dy, inv_dz, tm, a.t_min,
                      a.has_motion != 0, false, h);
    }
  }
  if (!live) return;
  rt::face_ray(h);
  const long long R = a.n_lanes;
  float* o = a.outf;
  o[0 * R + l] = h.t;
  o[1 * R + l] = h.nx;
  o[2 * R + l] = h.ny;
  o[3 * R + l] = h.nz;
  o[4 * R + l] = h.uu;
  o[5 * R + l] = h.vv;
  int* oi = a.outi;
  oi[0 * R + l] = static_cast<int>(h.bi);
  oi[1 * R + l] = (h.fr > 0.5f ? 1 : 0) + (h.sph > 0.5f ? 2 : 0);
  oi[2 * R + l] = static_cast<int>(h.mat);
}

}  // namespace

extern "C" int rt_nearest_flat(const FlatArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  nearest_flat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
