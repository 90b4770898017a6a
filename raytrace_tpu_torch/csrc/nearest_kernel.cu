// The nearest hit record of every ray over a mesh-scale table.
//
// Replaces raytrace_tpu/ops/pallas/allpairs_kernel.py:
// allpairs_nearest_record (static _kernel, dynamic _dyn_kernel and its
// row_phases), the all-pairs broadcast sweep that the TPU runs for
// kind-segmented tables of 192 rows and more.  Plain PyTorch version:
// ops/allpairs_kernel.py:allpairs_nearest_plain.
//
// What bounds it on an H100: neither bytes nor flops.  A ray reads 7 words
// and writes 9 (64 B), and does ~20 flops per box test and ~45 per row it
// tests; a few dozen of each per ray leave the card's float32 rate and
// memory rate far below their peaks.  The walk is a divergent loop of
// dependent loads (node, then rows), so it is bound by latency and by the
// warp's slowest lane.  The design cuts both (bvh_nearest.cuh): a binned-
// SAH tree walked near child first, so a ray that hits culls what lies
// behind its hit; two boxes per 64-byte node in four float4 loads; the
// rows of a leaf contiguous; the triangle-only test for meshes; and a
// persistent grid (as many blocks as the card holds, a grid-stride loop
// over the rays).
#include <cuda_runtime.h>

#include "bvh_nearest.cuh"
#include "common.cuh"

// Field order and types mirror ops/allpairs_kernel.py:_NearestArgs.
struct NearestArgs {
  const float* nodes;      // [n_nodes, 16]
  const float* rows;       // [n_rows, 36] leaf-ordered
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;  // [R]
  float* outf;             // [6, R]: t, nx, ny, nz, u, v
  int* outi;               // [3, R]: idx, front | sphere << 1, mat
  int* visits;             // [2, R]: box tests and row tests, or null
  unsigned char* seen;     // [n_nodes + n_rows]: 1 where read, or null
  long long n_lanes;
  int n_nodes, has_motion, tri_only;
  float t_min;
};

namespace {

constexpr int kThreads = 128;

template <bool kTriOnly, bool kCount>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const NearestArgs a) {
  const rt::Bvh bvh{reinterpret_cast<const float4*>(a.nodes), a.rows};
  const long long R = a.n_lanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       l < R; l += stride) {
    rt::Visits v;
    if (kCount && a.seen != nullptr) {
      v.seen_nodes = a.seen;
      v.seen_rows = a.seen + a.n_nodes;
    }
    const rt::HitRec h = rt::bvh_nearest<kTriOnly, kCount>(
        bvh, a.ox[l], a.oy[l], a.oz[l], a.dx[l], a.dy[l], a.dz[l], a.tm[l],
        a.t_min, a.has_motion != 0, false, &v);
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
}

#ifdef __CUDACC__
template <bool kTriOnly, bool kCount>
int launch_nearest(const NearestArgs* a, cudaStream_t s) {
  static rt::Resident cache;
  const auto kernel = nearest_kernel<kTriOnly, kCount>;
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

extern "C" int rt_nearest(const NearestArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool count = a->visits != nullptr;
  if (a->tri_only)
    return count ? launch_nearest<true, true>(a, s)
                 : launch_nearest<true, false>(a, s);
  return count ? launch_nearest<false, true>(a, s)
               : launch_nearest<false, false>(a, s);
}
