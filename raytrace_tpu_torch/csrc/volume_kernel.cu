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
// What bounds them on an H100: K11 bytes or operations (a ray reads 24
// bytes, 28 with motion, and writes 12 per medium, or in the candidate
// mode reads 4 per medium, and 8 of the fold where an earlier launch
// started it, and writes 8; it tests every row of a small boundary);
// K11b neither, once it walks a tree: a few box tests and rows a ray are
// far below the card's float32 rate, and the walk's dependent loads and
// the warp's slowest lane bound it, as they bound the nearest walk K9.
// * rt_volume_crossings (K11, boundary tables under 64 rows) stages the
//   whole table once per block into dynamic shared memory (every thread
//   then reads the same row at once, a broadcast) and scans each medium's
//   rows after that one barrier, two rays a thread (measured faster than
//   one on the planar table, no slower on the general one; blocks of 128
//   faster than 64 or 256, PERF.md section 6).  Its planar
//   instantiation serves tables of unmoving parallelograms and triangles
//   (cornell_smoke's boxes): volume.cuh:planar_crossing, float4 reads and
//   one fold a row; the general one runs crossing_cand with the motion and
//   box flags as template parameters;
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
// Both have a candidate mode: instead of the crossings, each ray's
// nearest medium scatter candidate (volume.cuh:medium_candidate) folded
// into the [R] rows t_med and vmat, read and written in place, so the
// launches of a scene's groups of 16 media fold in medium order.
// Both have a keyed mode (the differentiable media path's): the crossings
// and, per medium, the keys 2 * row + slot of the candidates t1 and t2
// came from (volume.cuh), -1 where the crossing is +inf, which the
// backward reads to recompute those roots alone.
// K11 folds each row's entering root before its exit root with a strict
// <, which is the TPU tile reduction's order (lowest row first); K11b's
// keyed fold gives the same bits, and the same keys, in any order.
#include <cuda_runtime.h>

#include <type_traits>

#include "bvh_crossings.cuh"
#include "common.cuh"
#include "prim_loop.cuh"
#include "volume.cuh"

constexpr int kMaxVolumes = 16;

// Field order and types mirror ops/volume_kernel.py:_VolArgs.
struct VolArgs {
  const float* tbl;    // [n_tbl, 36] packed boundary rows (K11)
  const float* nodes;  // [n_nodes, 16] the media's trees (K11b)
  const float* rows;   // [n_real, 36] leaf-ordered boundary rows (K11b)
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;  // [R]
  float* out;          // [3 n_vol, R]: t1, front1, t2 per medium
  int* visits;         // [2, R]: box tests and row tests (K11b), or null
  int* keys;           // [2 n_vol, R]: k1, k2 per medium (keyed), or null
  // candidate mode (cand 1: fold into the rows, 2: start the fold afresh,
  // the rows written only): medium v's [R] draws at u + v * u_stride, the
  // media's densities [n_vol] and the [R] rows of the nearest candidate
  // and its material id
  const float* u;
  const float* density;
  float *t_med, *vmat;
  long long n_lanes, u_stride;
  int n_vol, n_tbl, has_motion, has_box;
  int tri_only;        // K11b's rows are all unmoving triangles
  int planar;          // K11's rows are all unmoving parallelograms/triangles
  int cand;            // 0: the crossings, 1 or 2: the candidate mode
  int keyed;           // the crossings with their keys
  float t_min;
  int starts[kMaxVolumes], counts[kMaxVolumes];  // each medium's rows
  int roots[kMaxVolumes];  // each medium's root node (K11b)
  float mats[kMaxVolumes];  // each medium's material id (cand)
};

namespace {

constexpr int kThreads = 128;  // K11's and K11b's block
constexpr int kRays = 2;       // K11's rays a thread
// K11's table: 221,184 bytes at most, above 48 KB by the opt-in (the
// routes give it under 64 rows, 9,072 bytes)
constexpr int kMaxStagedRows = 1536;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ void write_out(const VolArgs& a, int v,
                                          long long l,
                                          const rt::Crossings& s) {
  const long long R = a.n_lanes;
  a.out[(3LL * v + 0) * R + l] = s.b1;
  a.out[(3LL * v + 1) * R + l] = s.f1;
  a.out[(3LL * v + 2) * R + l] = s.b2;
}

// The keyed mode's keys of medium v for lane l: -1 where the crossing is
// +inf.
__device__ __forceinline__ void write_keys(const VolArgs& a, int v,
                                           long long l,
                                           const rt::KeyedCrossings& s) {
  const long long R = a.n_lanes;
  a.keys[(2LL * v + 0) * R + l] = s.b1 < rt::inf() ? s.k1 : -1;
  a.keys[(2LL * v + 1) * R + l] = s.b2 < rt::inf() ? s.k2 : -1;
}

__device__ __forceinline__ void write_out(const VolArgs& a, int v,
                                          long long l,
                                          const rt::KeyedCrossings& s) {
  write_out(a, v, l, rt::unkeyed(s));
  write_keys(a, v, l, s);
}

// The candidate mode's fold state of lane l: the rows', or none yet.
__device__ __forceinline__ void load_fold(const VolArgs& a, long long l,
                                          float& t_med, float& vmat) {
  t_med = a.cand == 2 ? rt::inf() : a.t_med[l];
  vmat = a.cand == 2 ? 0.0f : a.vmat[l];
}

// The candidate mode's epilogue of medium v for lane l.
__device__ __forceinline__ void fold_out(const VolArgs& a, int v, long long l,
                                         const rt::Crossings& s, float& t_med,
                                         float& vmat) {
  const float u = a.u[v * a.u_stride + l];
  rt::fold_medium(t_med, vmat,
                  rt::medium_candidate(s, a.t_min, a.density[v], u),
                  a.mats[v]);
}

// K11: kRays rays a thread, lanes base + k * blockDim.x (coalesced); the
// whole table staged once, 16-byte aligned for planar_crossing's float4.
// kKeys: the keyed mode (row keys counted beside the row pointer).
template <bool kPlanar, bool kMotion, bool kBox, bool kCand, bool kKeys>
__global__ void __launch_bounds__(kThreads)
volume_crossings_kernel(const VolArgs a) {
  using S = std::conditional_t<kKeys, rt::KeyedCrossings, rt::Crossings>;
  float* tbl = rt::dyn_smem();
  rt::stage(tbl, a.tbl, a.n_tbl * rt::kCols);
  __syncthreads();  // the only barrier: a thread may leave after it
  const long long base =
      static_cast<long long>(blockIdx.x) * blockDim.x * kRays + threadIdx.x;
  if (base >= a.n_lanes) return;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tm[kRays], t_med[kRays], vmat[kRays];
  bool live[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const long long l = base + static_cast<long long>(k) * blockDim.x;
    live[k] = l < a.n_lanes;
    const long long q = live[k] ? l : base;  // a dead ray repeats a live one
    ox[k] = a.ox[q];
    oy[k] = a.oy[q];
    oz[k] = a.oz[q];
    dx[k] = a.dx[q];
    dy[k] = a.dy[q];
    dz[k] = a.dz[q];
    tm[k] = kMotion ? a.tm[q] : 0.0f;
    if (kCand) load_fold(a, q, t_med[k], vmat[k]);
  }
  float inv_dx[kRays], inv_dy[kRays], inv_dz[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    inv_dx[k] = kBox ? 1.0f / rt::safe_dir(dx[k]) : 1.0f;
    inv_dy[k] = kBox ? 1.0f / rt::safe_dir(dy[k]) : 1.0f;
    inv_dz[k] = kBox ? 1.0f / rt::safe_dir(dz[k]) : 1.0f;
  }
#pragma unroll 1
  for (int v = 0; v < a.n_vol; ++v) {
    S s[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if constexpr (kKeys)
        s[k] = rt::no_keyed_crossings();
      else
        s[k] = rt::no_crossings();
    }
    const float* row = tbl + a.starts[v] * rt::kCols;
    const float* const end = row + a.counts[v] * rt::kCols;
    int key = 2 * a.starts[v];  // the row's entering root's key
#pragma unroll 1
    for (; row < end; row += rt::kCols, key += 2) {
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (kPlanar) {
          float cf;
          const float c = rt::planar_crossing(row, ox[k], oy[k], oz[k], dx[k],
                                              dy[k], dz[k], a.t_min, cf);
          rt::fold(s[k], c, cf, key);
        } else {
          rt::cross_row(rt::PtrRow{row}, key, ox[k], oy[k], oz[k], dx[k],
                        dy[k], dz[k], inv_dx[k], inv_dy[k], inv_dz[k], tm[k],
                        a.t_min, kMotion, kBox, s[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (!live[k]) continue;
      const long long l = base + static_cast<long long>(k) * blockDim.x;
      if constexpr (kCand)
        fold_out(a, v, l, s[k], t_med[k], vmat[k]);
      else
        write_out(a, v, l, s[k]);
    }
  }
  if (kCand) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (!live[k]) continue;
      const long long l = base + static_cast<long long>(k) * blockDim.x;
      a.t_med[l] = t_med[k];
      a.vmat[l] = vmat[k];
    }
  }
}

using VolKernel = void (*)(const VolArgs);

template <bool kPlanar, bool kMotion, bool kBox>
VolKernel scan_mode(const VolArgs& a) {
  if (a.keyed) return volume_crossings_kernel<kPlanar, kMotion, kBox, false,
                                              true>;
  return a.cand
             ? volume_crossings_kernel<kPlanar, kMotion, kBox, true, false>
             : volume_crossings_kernel<kPlanar, kMotion, kBox, false, false>;
}

// K11's instantiation for a's table and mode (the launcher's and the host
// build's choice).
VolKernel scan_kernel(const VolArgs& a) {
  if (a.planar) return scan_mode<true, false, false>(a);
  if (a.has_motion)
    return a.has_box ? scan_mode<false, true, true>(a)
                     : scan_mode<false, true, false>(a);
  return a.has_box ? scan_mode<false, false, true>(a)
                   : scan_mode<false, false, false>(a);
}

// At least 8 blocks a SM: ptxas then keeps the walk in 64 registers,
// where it chose 48 and spilled (measured 2% faster on an H100).
template <bool kTriOnly, bool kCount, bool kCand, bool kKeys>
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
    float t_med = 0.0f, vmat = 0.0f;
    if (kCand) load_fold(a, l, t_med, vmat);
    rt::Visits v;
#pragma unroll 1
    for (int m = 0; m < a.n_vol; ++m) {
      const rt::KeyedCrossings s = rt::bvh_crossings<kTriOnly, kCount>(
          bvh, a.roots[m], ox, oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz,
          tm, a.t_min, motion, box, &v);
      if (kCand)
        fold_out(a, m, l, rt::unkeyed(s), t_med, vmat);
      else if (kKeys)
        write_out(a, m, l, s);
      else
        write_out(a, m, l, rt::unkeyed(s));
    }
    if (kCand) {
      a.t_med[l] = t_med;
      a.vmat[l] = vmat;
    }
    if (kCount) {
      a.visits[l] = v.nodes;
      a.visits[R + l] = v.rows;
    }
  }
}

// f(tri_only, count, cand, keys) for K11b's instantiation for a's forest,
// counts and mode (counts only in the crossings mode), as
// std::bool_constant tags (the launcher's and the host build's choice).
template <class F>
auto with_walk(const VolArgs& a, F f) {
  using T = std::true_type;
  using N = std::false_type;
  if (a.visits != nullptr)
    return a.tri_only ? f(T{}, T{}, N{}, N{}) : f(N{}, T{}, N{}, N{});
  if (a.cand)
    return a.tri_only ? f(T{}, N{}, T{}, N{}) : f(N{}, N{}, T{}, N{});
  if (a.keyed)
    return a.tri_only ? f(T{}, N{}, N{}, T{}) : f(N{}, N{}, N{}, T{});
  return a.tri_only ? f(T{}, N{}, N{}, N{}) : f(N{}, N{}, N{}, N{});
}

// Are the media counted right, and does the candidate mode have its
// inputs, or the crossings mode its output?
bool mode_args_ok(const VolArgs* a) {
  if (a->n_vol <= 0 || a->n_vol > kMaxVolumes) return false;
  if (a->cand)
    return !a->keyed && a->u != nullptr && a->density != nullptr &&
           a->t_med != nullptr && a->vmat != nullptr && a->visits == nullptr;
  if (a->keyed) return a->out != nullptr && a->keys != nullptr &&
                       a->visits == nullptr;
  return a->out != nullptr;
}

#ifdef __CUDACC__
// A persistent grid of K11b's walk: as many blocks as the card holds, at
// most one a 128 rays; one occupancy cache per instantiation.
template <bool kTriOnly, bool kCount, bool kCand, bool kKeys>
int launch_walk(const VolArgs* a, cudaStream_t s) {
  static rt::Resident cache;
  const auto kernel = volume_bvh_kernel<kTriOnly, kCount, kCand, kKeys>;
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
  if (!mode_args_ok(a) || a->n_tbl <= 0 || a->n_tbl > kMaxStagedRows ||
      (a->planar && (a->has_motion || a->has_box)))
    return cudaErrorInvalidValue;
  for (int v = 0; v < a->n_vol; ++v)
    if (a->starts[v] < 0 || a->counts[v] < 0 ||
        a->starts[v] + a->counts[v] > a->n_tbl)
      return cudaErrorInvalidValue;
  const long long blocks = (a->n_lanes + kThreads * kRays - 1) /
                           (kThreads * kRays);
  const int smem = a->n_tbl * rt::kCols * static_cast<int>(sizeof(float));
  const VolKernel kernel = scan_kernel(*a);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_volume_crossings_bvh(const VolArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (!mode_args_ok(a)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_walk(*a, [&](auto tri, auto count, auto cand, auto keys) {
    return launch_walk<decltype(tri)::value, decltype(count)::value,
                       decltype(cand)::value, decltype(keys)::value>(a, s);
  });
}
