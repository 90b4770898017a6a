// Kernel B: one whole wavefront iteration per lane.
//
// Replaces raytrace_tpu/ops/pallas/iter_kernel.py:iter_megakernel (body
// _iter_kernel): regeneration of idle lanes, the counter-hash RNG
// (bit-identical to core/rng.py), the thin-lens camera, the bounce of
// kernel A (prim_loop.cuh + shade.cuh), the constant/sky/gray background,
// the depth cap, Russian roulette and the death bookkeeping.  Plain
// PyTorch version: ops/iter_kernel.py:iter_plain.
//
// What bounds it on an H100: as for kernel A, arithmetic and latency.  A
// lane moves ~19 words in and ~19 out per iteration (~150 B) and spends a
// few hundred flops per (ray, row) plus the hash (7 x ~10 integer ops),
// camera and shade; the iteration kernel saves the ~340 small elementwise
// launches per iteration, and their device-memory round trips, that the
// unfused body pays around kernel A (PERF.md).  Same simple design: one
// thread per lane, tables and camera in shared memory, no block consensus,
// and kernel A's two instantiations of the flat scan: the planar one
// (kPlanar) for tables whose rows are all unmoving parallelograms and
// triangles (ops/bounce_kernel.py:planar_only; the Cornell box) scans with
// prim_loop.cuh:planar_loop (four float4 loads a row from shared memory,
// the scan carrying (t, row), the winner's record built once afterwards),
// every other table with prim_loop.  The wrapper decides once per driver
// call which one serves the tables (ops/iter_kernel.py:prepare_iter).
//
// The mesh variant (rt_iter_bvh) replaces iter_kernel.py:_iter_mega_ap,
// the same iteration with the TPU's all-pairs intersect stage, taken for
// kind-segmented tables of 512 < rows <= 65,536
// (ops/iter_kernel.py:resolve_use_ap).  Its intersect stage is the BVH walk
// of bvh_nearest.cuh (the rows stay in global memory: a mesh-scale table
// does not fit shared memory); regeneration, RNG, camera, shade,
// background and Russian roulette are the same code.  It is bound, like
// the standalone nearest kernel (nearest_kernel.cu), by the latency and
// divergence of the walk, and takes the same design: a persistent grid
// whose blocks stage the camera, material and target tables once.  Plain
// version: iter_plain(use_ap=True).
//
// The rotated mode (kRotate, flat scan only) serves the stationary driver's
// pixel rotation (render/integrator.py:trace_wavefront_stationary at
// rotate_k > 1): lane l traces, for its sample smp2 of this turn, the
// pixel of slot (l + c * stride) % R, c = (smp2 - sample_offset) / spp_k
// clamped to [0, k_rot), and a dying lane adds its radiance to plane c of
// the [k_rot, 3, R] accumulator at that slot.  Within a plane the map of
// lanes to slots is one to one, so no two lanes write one address: no
// atomics, and the sums are deterministic.  The driver sums the planes once
// after its loop.  Plain version: iter_plain(rotation=...).
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_nearest.cuh"
#include "common.cuh"
#include "prim_loop.cuh"
#include "regen.cuh"
#include "shade.cuh"

// Field order and types mirror ops/iter_kernel.py:_IterArgs.
struct IterArgs {
  const float* ptbl;  // [>=n_prims, 36]
  const float* mtbl;  // [>=n_mats, 12]
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float* cam;   // [24]
  const int* kt;      // [4]: key words, last sample
  const int *pix, *smp, *dep;  // [R] i32
  const float *al, *ox, *oy, *oz, *dx, *dy, *dz, *tm, *rr, *rg, *rb, *tr,
      *tg, *tb;                // [R] f32
  float* outf;  // [17 (+2 uv), R]: comps 7, rad 3, thr 3, alive, died,
                //                   idx, rr scale (, u, v)
  int* outi;    // [2, R]: smp', dep'
  const float* nodes;  // mesh variant: [n_nodes, 16] BVH nodes
  const float* rows;   // mesh variant: [n_rows, 36] leaf-ordered rows
  long long n_lanes;
  int n_prims, n_mats, n_targets, has_motion, use_prim_albedo, n_u,
      rr_depth, max_depth, width, bg_kind, with_uv, n_nodes, tri_only,
      planar;
  float t_min;
  // rotated mode (k_rot > 1): the rotation's statics and the
  // [k_rot, 3, R] f32 accumulation planes
  int k_rot, spp_k, stride, sample_offset, pixel_offset, n_pix;
  float* acc;
};

namespace {

constexpr int kThreads = 128;
constexpr int kNCam = rt::kNCam;
constexpr int kBgSky = 1, kBgGray = 2;
// The table follows the camera in shared memory and planar_cand reads its
// rows as float4: 24 floats keep it at a 16-byte offset of the aligned base.
static_assert(kNCam % 4 == 0, "the staged table must stay 16-byte aligned");

// One iteration of lane l.  kBvh: the mesh variant (the table stays in
// global memory and the intersect stage walks the BVH); otherwise the flat
// scan of the table staged in shared memory (sp), planar_loop where
// kPlanar (every row an unmoving parallelogram or triangle).  kRotate: the
// lane's pixel and accumulation plane follow the rotation (see above).
template <bool kBvh, bool kTriOnly, bool kPlanar, bool kRotate>
__device__ __forceinline__ void iter_lane(const IterArgs& a, long long l,
                                          const float* cam, const float* sp,
                                          const float* sm, const float* st,
                                          const rt::Bvh& bvh) {
  const long long R = a.n_lanes;

  int pix;
  int rot_c = 0;
  long long slot = 0;
  if constexpr (kRotate) {
    // the sample this turn traces (regen's smp2) picks the chunk
    const int smp = a.smp[l];
    const int smp2 = (!(a.al[l] > 0.5f) && smp < a.kt[2]) ? smp + 1 : smp;
    rot_c = (smp2 - a.sample_offset) / a.spp_k;
    rot_c = rot_c < 0 ? 0 : (rot_c >= a.k_rot ? a.k_rot - 1 : rot_c);
    slot = (l + static_cast<long long>(rot_c) * a.stride) % R;
    pix = a.pixel_offset + static_cast<int>(slot < a.n_pix ? slot
                                                           : a.n_pix - 1);
  } else {
    pix = a.pix[l];
  }

  // regeneration of idle lanes with samples left: RNG and camera ray
  rt::Regen rg;
  rt::regen(a.kt, cam, a.width, pix, a.smp[l], a.dep[l], a.al[l] > 0.5f, rg);
  const bool can = rg.can;
  const bool alive_pre = rg.alive_pre;
  const int smp2 = rg.smp2;
  const int dep_pre = rg.dep_pre;
  const float* us = rg.us;

  float ox = a.ox[l], oy = a.oy[l], oz = a.oz[l];
  float dx = a.dx[l], dy = a.dy[l], dz = a.dz[l];
  float tmv = a.tm[l];
  if (can) {
    ox = rg.ray[0];
    oy = rg.ray[1];
    oz = rg.ray[2];
    dx = rg.ray[3];
    dy = rg.ray[4];
    dz = rg.ray[5];
    tmv = rg.ray[6];
  }
  float rad[3] = {a.rr[l], a.rg[l], a.rb[l]};
  float thr[3] = {a.tr[l], a.tg[l], a.tb[l]};
  if (can) {
    for (int k = 0; k < 3; ++k) {
      rad[k] = rad[k] * 0.0f;
      thr[k] = 1.0f;
    }
  }

  // dead lanes are parked far outside the scene
  const float far = RT_F(3e18);
  const float box = alive_pre ? ox : far;
  const float boy = alive_pre ? oy : far;
  const float boz = alive_pre ? oz : far;

  rt::HitRec hr;
  if constexpr (kBvh)
    hr = rt::bvh_nearest<kTriOnly, false>(
        bvh, box, boy, boz, dx, dy, dz, tmv, a.t_min, a.has_motion != 0,
        a.use_prim_albedo != 0, nullptr);
  else if constexpr (kPlanar)
    hr = rt::planar_loop(sp, a.n_prims, box, boy, boz, dx, dy, dz, a.t_min,
                         a.use_prim_albedo != 0);
  else
    hr = rt::prim_loop(sp, a.n_prims, box, boy, boz, dx, dy, dz, tmv,
                       a.t_min, a.has_motion != 0, a.use_prim_albedo != 0);
  const rt::ShadeOut s =
      rt::shade(hr, sm, a.n_mats, st, a.n_targets, a.use_prim_albedo != 0,
                box, boy, boz, dx, dy, dz, thr[0], thr[1], thr[2],
                alive_pre, us);

  // background on a miss
  float bg[3];
  if (a.bg_kind == kBgSky) {
    const float a_sky = 0.5f * (dy + 1.0f);
    bg[0] = (1.0f - a_sky) + a_sky * 0.5f;
    bg[1] = (1.0f - a_sky) + a_sky * RT_F(0.7);
    bg[2] = (1.0f - a_sky) + a_sky * 1.0f;
  } else if (a.bg_kind == kBgGray) {
    const float t_g = (dy + 1.0f) * 0.5f;
    bg[0] = bg[1] = bg[2] = t_g;
  } else {
    bg[0] = cam[20];
    bg[1] = cam[21];
    bg[2] = cam[22];
  }
  float rad2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rad2[k] = rad[k] + s.em[k] + s.miss * thr[k] * bg[k];

  // depth cap + Russian roulette
  const int dep2 = dep_pre + 1;
  const bool alive_b = s.alive > 0.5f;
  const bool capped = alive_b && dep2 >= a.max_depth;
  bool died = (alive_pre && !alive_b) || capped;
  bool alive2 = alive_b && !capped;
  float t2[3] = {s.thr[0], s.thr[1], s.thr[2]};
  float scale = 1.0f;
  if (a.rr_depth >= 0) {
    const float thr_max = rt::tmax(t2[0], rt::tmax(t2[1], t2[2]));
    const float p_srv = rt::clamp(thr_max, cam[19], 1.0f);
    const bool do_rr = dep2 >= a.rr_depth;
    const bool kill = do_rr && us[a.n_u + 5] >= p_srv;
    scale = (do_rr && !kill) ? 1.0f / p_srv : 1.0f;
    for (int k = 0; k < 3; ++k) t2[k] = t2[k] * scale;
    died = died || (alive2 && kill);
    alive2 = alive2 && !kill;
  }

  float* o = a.outf;
  o[0 * R + l] = s.o[0];
  o[1 * R + l] = s.o[1];
  o[2 * R + l] = s.o[2];
  o[3 * R + l] = s.d[0];
  o[4 * R + l] = s.d[1];
  o[5 * R + l] = s.d[2];
  o[6 * R + l] = tmv;
  o[7 * R + l] = rad2[0];
  o[8 * R + l] = rad2[1];
  o[9 * R + l] = rad2[2];
  o[10 * R + l] = t2[0];
  o[11 * R + l] = t2[1];
  o[12 * R + l] = t2[2];
  o[13 * R + l] = alive2 ? 1.0f : 0.0f;
  o[14 * R + l] = died ? 1.0f : 0.0f;
  o[15 * R + l] = s.bi;
  o[16 * R + l] = scale;
  if (a.with_uv) {
    o[17 * R + l] = s.uu;
    o[18 * R + l] = s.vv;
  }
  a.outi[l] = smp2;
  a.outi[R + l] = dep2;
  if constexpr (kRotate) {
    if (died) {
      float* p = a.acc + static_cast<long long>(rot_c) * 3 * R + slot;
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k * R] += rad2[k];
    }
  }
}

template <bool kBvh, bool kTriOnly, bool kPlanar, bool kRotate = false>
__global__ void __launch_bounds__(kThreads) iter_kernel(const IterArgs a) {
  float* cam = rt::dyn_smem();  // 16-byte aligned
  float* sp = cam + kNCam;      // so is the table (kNCam % 4 == 0)
  float* sm = kBvh ? sp : sp + a.n_prims * rt::kCols;
  float* st = sm + a.n_mats * rt::kMCols;
  rt::stage(cam, a.cam, kNCam);
  if (!kBvh) rt::stage(sp, a.ptbl, a.n_prims * rt::kCols);
  rt::stage(sm, a.mtbl, a.n_mats * rt::kMCols);
  rt::stage(st, a.ttbl, a.n_targets * rt::kTCols);
  __syncthreads();

  if constexpr (kBvh) {
    // persistent: a grid-stride loop over the lanes
    const rt::Bvh bvh{reinterpret_cast<const float4*>(a.nodes), a.rows};
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll 1
    for (long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         l < a.n_lanes; l += stride)
      iter_lane<true, kTriOnly, false, false>(a, l, cam, sp, sm, st, bvh);
  } else {
    const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (l >= a.n_lanes) return;
    iter_lane<false, false, kPlanar, kRotate>(a, l, cam, sp, sm, st,
                                              rt::Bvh{});
  }
}

#ifdef __CUDACC__
template <bool kBvh, bool kTriOnly, bool kPlanar, bool kRotate = false>
int launch_iter(const IterArgs* a, void* stream) {
  static rt::Resident cache;
  if (a->n_lanes <= 0) return 0;
  if (a->n_u != rt::kNU) return static_cast<int>(cudaErrorInvalidValue);
  if (kRotate && (a->acc == nullptr || a->spp_k < 1 || a->n_pix < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = iter_kernel<kBvh, kTriOnly, kPlanar, kRotate>;
  const int smem = static_cast<int>(
      sizeof(float) * (kNCam + (kBvh ? 0 : a->n_prims * rt::kCols) +
                       a->n_mats * rt::kMCols + a->n_targets * rt::kTCols));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  if (kBvh) {
    // persistent: at most as many blocks as the card holds
    int resident = 0;
    cudaError_t e = rt::resident_blocks(reinterpret_cast<const void*>(kernel),
                                        kThreads, smem, cache, resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks > resident) blocks = resident < 1 ? 1 : resident;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // namespace

extern "C" int rt_iter(const IterArgs* a, void* stream) {
  if (a->k_rot > 1)
    return a->planar ? launch_iter<false, false, true, true>(a, stream)
                     : launch_iter<false, false, false, true>(a, stream);
  return a->planar ? launch_iter<false, false, true>(a, stream)
                   : launch_iter<false, false, false>(a, stream);
}

extern "C" int rt_iter_bvh(const IterArgs* a, void* stream) {
  return a->tri_only ? launch_iter<true, true, false>(a, stream)
                     : launch_iter<true, false, false>(a, stream);
}
