// The nearest hit record of every ray over a mesh-scale table.
//
// Replaces raytrace_tpu/ops/pallas/allpairs_kernel.py:
// allpairs_nearest_record (static _kernel, dynamic _dyn_kernel and its
// row_phases), the all-pairs broadcast sweep that the TPU runs for
// kind-segmented tables of 192 rows and more.  Plain PyTorch version:
// ops/allpairs_kernel.py:allpairs_nearest_plain.
//
// What bounds it on an H100: neither bytes nor flops.  A ray reads 7 words
// and writes 9 (64 B), and does ~20 flops per node box and ~45 per row it
// tests; a few dozen of each per ray leave the card's float32 rate and
// memory rate far below their peaks.  The walk is a divergent loop of
// dependent loads (node, leaf list, row), so it is bound by latency and by
// the warp's divergence.  The design is the simple one: one thread per ray
// (bvh_nearest.cuh), nodes and rows read from global memory through the
// read-only cache (a mesh-scale table fits the 50 MB L2, not the 227 KB of
// shared memory), no ray sorting, no persistent threads.  Those are the
// levers for a later change.
#include <cuda_runtime.h>

#include "bvh_nearest.cuh"
#include "common.cuh"

// Field order and types mirror ops/allpairs_kernel.py:_NearestArgs.
struct NearestArgs {
  const float* tbl;        // [rows, 36] packed table
  const float* nodes;      // [n_nodes, 8]
  const int* leaf_rows;    // [n_leaf_rows]
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;  // [R]
  float* outf;             // [6, R]: t, nx, ny, nz, u, v
  int* outi;               // [3, R]: idx, front | sphere << 1, mat
  int* visits;             // [2, R]: nodes and rows tested, or null
  long long n_lanes;
  int n_nodes, has_motion;
  float t_min;
};

namespace {

constexpr int kThreads = 128;

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const NearestArgs a) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const long long R = a.n_lanes;
  rt::Visits v;
  const rt::HitRec h = rt::bvh_nearest<kCount>(
      a.nodes, a.n_nodes, a.leaf_rows, a.tbl, a.ox[l], a.oy[l], a.oz[l],
      a.dx[l], a.dy[l], a.dz[l], a.tm[l], a.t_min, a.has_motion != 0, false,
      &v);
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
  if (kCount) {
    a.visits[l] = v.nodes;
    a.visits[R + l] = v.rows;
  }
}

}  // namespace

extern "C" int rt_nearest(const NearestArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  if (a->visits != nullptr)
    nearest_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *a);
  else
    nearest_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        *a);
  return static_cast<int>(cudaGetLastError());
}
