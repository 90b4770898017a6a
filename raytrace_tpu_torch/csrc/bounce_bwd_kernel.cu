// The two backward kernels of the differentiable wavefront, K5 (the fused
// iteration, entry rt_bounce_bwd) and K7 (one unfused bounce, entry
// rt_bounce_bwd_replay), both over lane_adjoint.cuh:lane_math_adjoint and
// the winner-row gather and row-gradient reduction of row_reduce.cuh.
//
// K5 replaces raytrace_tpu/ops/pallas/bounce_bwd_gather_kernel.py:
// bounce_bwd_regen_pre_megakernel (body _kernel_regen_pre), and the
// one-hot gathers and reductions its caller runs around it.  Plain PyTorch
// versions: ops/bounce_bwd_gather_kernel.py:bounce_bwd_regen_pre_plain
// (per lane) and bounce_bwd_regen_pre_reduced_plain (reduced).
//
// K5, per lane: rebuild the detached regeneration stage of kernel B from the
// saved (pixel, sample, depth) (regen.cuh, bit-identical counter hash and
// camera), read the winner's row of the per-prim table by the saved winner
// index, form the replayed bounce's inputs (the regeneration selects, the
// far parking of dead lanes), and run lane_math's hand-derived adjoint
// (lane_adjoint.cuh) with the background term and the RR scale around it.
// It writes the 13 lane gradients autograd needs (comps_in, rad_in,
// thr_in) and sums the row gradients onto the tables (row_reduce.cuh).
// The per-lane mode, for checks, reads rows gathered per lane and writes
// every lane's row gradients instead.
//
// What bounds it on an H100: device-memory traffic.  A lane reads 29
// four-byte columns (the winner index, 3 ints, alive, 7 components, 3
// throughputs, the RR scale, 13 cotangents) and writes 13: 168 B a lane,
// 44 MB at 2^18 lanes, 13 us at 3.35 TB/s, besides the table and the
// blocks' partials (a few MB at most).  Its arithmetic, some thousand flops
// with branches per lane, is far below the card's float32 rate.  The
// design: a grid-stride loop over as many blocks of 128 threads as the card
// holds at once, one thread per lane over 1-D SoA columns (coalesced), the
// camera, the target rows and a small winner table in shared memory, the
// whole forward and reverse sweep in registers.
//
// K7 replaces raytrace_tpu/ops/pallas/bounce_bwd_kernel.py:
// bounce_bwd_megakernel (body _kernel).  Plain versions:
// ops/bounce_bwd_kernel.py:bounce_bwd_megakernel_plain (per lane) and
// bounce_bwd_megakernel_reduced_plain.  It is K5 without the regeneration
// stage, the far parking of dead lanes and the background term: the
// backward of the unfused step (diff/mega_bounce.py) saves the bounce's own
// inputs, so each lane reads its ray, throughput and 8 uniform columns and
// its winner's row, runs lane_math_adjoint, writes the 10 lane gradients
// and the miss flag (the caller adds the background term's VJP, so any
// background works) and sums the row gradients as K5 does.  Bound: device
// memory; a lane reads 32 columns (the winner index, 10 lane, 8 uniforms,
// alive, 12 cotangents) and writes 11: 172 B a lane.
#include <cuda_runtime.h>

#include "common.cuh"
#include "lane_adjoint.cuh"
#include "regen.cuh"
#include "row_reduce.cuh"

namespace {

constexpr int kThreads = rt::kRowThreads;
constexpr int kNCts = 13;         // o2 (3), d2 (3), time, rad2 (3), thr2 (3)
constexpr int kMaxTargets = 8;
constexpr int kBgSky = 1, kBgGray = 2;
// dead lanes' origin in the replay: far outside the scene, but small enough
// that the record math stays finite (kernel B parks them at 3e18)
constexpr double kFar = 3e9;
constexpr int kNLane = 10;        // o (3), d (3), time, thr (3)
constexpr int kNReplayCts = 12;   // o2 (3), d2 (3), rad (3), thr2 (3)

}  // namespace

// Field order and types mirror ops/bounce_bwd_gather_kernel.py:_BwdArgs.
struct BwdArgs {
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float* cam;   // [24]
  const int* kt;      // [4]: key words, last sample
  const float* bi;    // [R] winner index (-1 on a miss)
  const int *pix, *smp, *dep;  // [R]
  const float* al;             // [R] 0/1
  const float* comps[7];       // [R] each: the iteration's input ray
  const float* thr[3];         // [R] each: its input throughput
  const float* scale;          // [R] its RR factor
  const float* cts[kNCts];     // [R] each
  float* out;                  // per lane [n_row + 20, R], else [13, R]
  rt::RowArgs rows;
  long long n_lanes;
  int n_targets, has_motion, has_box, n_row, width, bg_kind;
  float t_min;
};

// K7's arguments.  Field order and types mirror
// ops/bounce_bwd_kernel.py:_ReplayArgs.
struct ReplayArgs {
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float* bi;    // [R] winner index (-1 on a miss)
  const float* lane[kNLane];      // [R] each: the bounce's input
  const float* u[rt::kNU];        // [R] each: its uniforms
  const float* al;                // [R] 0/1
  const float* cts[kNReplayCts];  // [R] each
  float* out;                     // per lane [n_row + 18, R], else [11, R]
  rt::RowArgs rows;
  long long n_lanes;
  int n_targets, has_motion, has_box, n_row;
  float t_min;
};

namespace {

// The target constants of the first n rows of ttbl, by one thread.
__device__ __forceinline__ void stage_targets(const float* ttbl, int n,
                                              rt::LaneTarget* tg) {
  if (threadIdx.x != 0) return;
  float acc = 0.0f;
  for (int t = 0; t < n; ++t)
    rt::target_consts(ttbl + t * rt::kTCols, acc, tg[t]);
}

// The winner row's columns into lane_math's inputs.
__device__ __forceinline__ void read_row(const rt::RowRef& row, int nr,
                                         bool has_motion, rt::LaneIn& x,
                                         rt::LaneDet& det) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.p0[k] = row(k);
    x.e1[k] = row(3 + k);
    x.e2[k] = row(6 + k);
    x.mv0[k] = has_motion ? row(9 + k) : 0.0f;
    x.mv1[k] = has_motion ? row(12 + k) : 0.0f;
    x.c0[k] = row(nr + k);
    x.c1[k] = row(nr + 3 + k);
  }
  x.param = row(nr + 6);
  det.kind_p = row(nr + 7);
  det.kind_m = row(nr + 8);
  det.texkind = row(nr + 9);
  det.f0 = row(nr + 10);
  det.f1 = row(nr + 11);
#pragma unroll
  for (int k = 0; k < 6; ++k) det.uv[k] = row(nr + 12 + k);
}

// The row gradients of the adjoint, in row_reduce.cuh's register order.
__device__ __forceinline__ void pack_row_grads(const rt::LaneIn& g,
                                               float (&rg)[rt::kMaxGradCols]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rg[k] = g.p0[k];
    rg[3 + k] = g.e1[k];
    rg[6 + k] = g.e2[k];
    rg[9 + k] = g.mv0[k];
    rg[12 + k] = g.mv1[k];
    rg[15 + k] = g.c0[k];
    rg[18 + k] = g.c1[k];
  }
  rg[21] = g.param;
}

// K5 for lane l with its winner row: the 13 lane gradients into
// lo[k * R + l] and the row gradients into rgo.
__device__ __forceinline__ void bwd_lane(const BwdArgs& a, long long l,
                                         const float* cam,
                                         const rt::LaneTarget* tg,
                                         const rt::RowRef& row, float* lo,
                                         float (&rgo)[rt::kMaxGradCols]) {
  const long long R = a.n_lanes;
  const bool has_motion = a.has_motion != 0;

  // the detached regeneration stage
  rt::Regen rg;
  rt::regen(a.kt, cam, a.width, a.pix[l], a.smp[l], a.dep[l], a.al[l] > 0.5f,
            rg);
  const float can_f = rg.can ? 1.0f : 0.0f;
  const float ap_f = rg.alive_pre ? 1.0f : 0.0f;

  // the replayed bounce's inputs: pre = can ? new : in, dead lanes parked
  float pre[7];
#pragma unroll
  for (int k = 0; k < 7; ++k)
    pre[k] = can_f * rg.ray[k] + (1.0f - can_f) * a.comps[k][l];
  rt::LaneIn x;
  rt::LaneDet det;
  read_row(row, a.n_row, has_motion, x, det);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.o[k] = ap_f * pre[k] + (1.0f - ap_f) * RT_F(kFar);
    x.d[k] = pre[3 + k];
    x.thr[k] = can_f + (1.0f - can_f) * a.thr[k][l];
  }
  x.time = pre[6];
#pragma unroll
  for (int k = 0; k < rt::kNU; ++k) det.u[k] = rg.us[k];
  det.alive = ap_f > 0.5f;
  det.idxv = a.bi[l] >= 0.0f;

  // cotangents: the RR scale multiplied into thr2 (its survival
  // probability is detached)
  const float sc = a.scale[l];
  float ct_all[kNCts];
#pragma unroll
  for (int k = 0; k < kNCts; ++k) ct_all[k] = a.cts[k][l];
  rt::LaneCt ct;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ct.o2[k] = ct_all[k];
    ct.d2[k] = ct_all[3 + k];
    ct.rad[k] = ct_all[7 + k];
    ct.thr2[k] = ct_all[10 + k] * sc;
  }

  rt::LaneIn g;
  const float miss = rt::lane_math_adjoint(
      x, det, tg, a.n_targets, has_motion, a.has_box != 0, a.t_min, ct, g);

  // background on a miss: rad += miss * thr * bg(d)
  float g_pre4 = 0.0f;
  float g_thr_bg[3];
  {
    float bgc[3], dbg[3] = {0.0f, 0.0f, 0.0f};
    if (a.bg_kind == kBgSky) {
      const float a_sky = 0.5f * (pre[4] + 1.0f);
      const float cs[3] = {0.5f, RT_F(0.7), 1.0f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bgc[k] = (1.0f - a_sky) + a_sky * cs[k];
        dbg[k] = 0.5f * (cs[k] - 1.0f);
      }
    } else if (a.bg_kind == kBgGray) {
      const float t_g = (pre[4] + 1.0f) * 0.5f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bgc[k] = t_g;
        dbg[k] = 0.5f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) bgc[k] = cam[20 + k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_thr_bg[k] = ct.rad[k] * bgc[k] * miss;
      g_pre4 += ct.rad[k] * (miss * x.thr[k]) * dbg[k];
    }
  }

  // back through the regeneration selects and the parking
  const float keep = 1.0f - can_f;
  float g_pre[7];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_pre[k] = g.o[k] * ap_f;
    g_pre[3 + k] = g.d[k];
  }
  g_pre[4] += g_pre4;
  g_pre[6] = g.time + ct_all[6];

#pragma unroll
  for (int k = 0; k < 7; ++k) lo[k * R + l] = g_pre[k] * keep;
#pragma unroll
  for (int k = 0; k < 3; ++k) lo[(7 + k) * R + l] = ct.rad[k] * keep;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    lo[(10 + k) * R + l] = (g.thr[k] + g_thr_bg[k]) * keep;
  pack_row_grads(g, rgo);
}

__global__ void __launch_bounds__(kThreads) bounce_bwd_kernel(
    const BwdArgs a) {
  __shared__ float cam[rt::kNCam];
  __shared__ rt::LaneTarget tg[kMaxTargets];
  const rt::RowArgs& r = a.rows;
  const int nr = a.n_row, ncol = nr + rt::kGathExtra;
  float* tab = r.mode == rt::kRowStaged ? rt::dyn_smem() : nullptr;
  float* acc = tab == nullptr ? nullptr : tab + r.n_prims * ncol;
  rt::stage(cam, a.cam, rt::kNCam);
  rt::row_begin(r, nr, tab, acc);
  stage_targets(a.ttbl, a.n_targets, tg);
  __syncthreads();

  const long long R = a.n_lanes;
  float* lo = a.out + (r.mode == rt::kRowPerLane ? (nr + 7) * R : 0);
  // every thread of a block takes the same number of turns, so the warps
  // meet in row_add and row_end
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < R; base += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long l = base + threadIdx.x;
    float rg[rt::kMaxGradCols] = {};
    int key = -1;
    if (l < R) {
      const float b = a.bi[l];
      bwd_lane(a, l, cam, tg, rt::winner_row(r, tab, ncol, l, R, b), lo, rg);
      key = rt::winner_key(b);
    }
    rt::row_add(r, nr, acc, a.out, l, R, key, rg);
  }
  rt::row_end(r, nr, acc);
}

// K7 for lane l with its winner row: the 10 lane gradients and the miss
// flag into lo[k * R + l] and the row gradients into rgo.
__device__ __forceinline__ void replay_lane(const ReplayArgs& a, long long l,
                                            const rt::LaneTarget* tg,
                                            const rt::RowRef& row, float* lo,
                                            float (&rgo)[rt::kMaxGradCols]) {
  const long long R = a.n_lanes;
  const bool has_motion = a.has_motion != 0;
  rt::LaneIn x;
  rt::LaneDet det;
  read_row(row, a.n_row, has_motion, x, det);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.o[k] = a.lane[k][l];
    x.d[k] = a.lane[3 + k][l];
    x.thr[k] = a.lane[7 + k][l];
  }
  x.time = a.lane[6][l];
#pragma unroll
  for (int k = 0; k < rt::kNU; ++k) det.u[k] = a.u[k][l];
  det.alive = a.al[l] > 0.5f;
  det.idxv = a.bi[l] >= 0.0f;
  rt::LaneCt ct;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ct.o2[k] = a.cts[k][l];
    ct.d2[k] = a.cts[3 + k][l];
    ct.rad[k] = a.cts[6 + k][l];
    ct.thr2[k] = a.cts[9 + k][l];
  }

  rt::LaneIn g;
  const float miss = rt::lane_math_adjoint(
      x, det, tg, a.n_targets, has_motion, a.has_box != 0, a.t_min, ct, g);

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k * R + l] = g.o[k];
    lo[(3 + k) * R + l] = g.d[k];
    lo[(7 + k) * R + l] = g.thr[k];
  }
  lo[6 * R + l] = g.time;
  lo[10 * R + l] = miss;
  pack_row_grads(g, rgo);
}

// K7: lane_math's adjoint over the saved inputs of one bounce.
__global__ void __launch_bounds__(kThreads) bounce_bwd_replay_kernel(
    const ReplayArgs a) {
  __shared__ rt::LaneTarget tg[kMaxTargets];
  const rt::RowArgs& r = a.rows;
  const int nr = a.n_row, ncol = nr + rt::kGathExtra;
  float* tab = r.mode == rt::kRowStaged ? rt::dyn_smem() : nullptr;
  float* acc = tab == nullptr ? nullptr : tab + r.n_prims * ncol;
  rt::row_begin(r, nr, tab, acc);
  stage_targets(a.ttbl, a.n_targets, tg);
  __syncthreads();

  const long long R = a.n_lanes;
  float* lo = a.out + (r.mode == rt::kRowPerLane ? (nr + 7) * R : 0);
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < R; base += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long l = base + threadIdx.x;
    float rg[rt::kMaxGradCols] = {};
    int key = -1;
    if (l < R) {
      const float b = a.bi[l];
      replay_lane(a, l, tg, rt::winner_row(r, tab, ncol, l, R, b), lo, rg);
      key = rt::winner_key(b);
    }
    rt::row_add(r, nr, acc, a.out, l, R, key, rg);
  }
  rt::row_end(r, nr, acc);
}

#ifdef __CUDACC__
// Launch `kernel` over n_lanes lanes with the row mode of `r`, then the
// reduction's finishing launches.
template <class Args>
int launch_bwd(void (*kernel)(const Args), const Args& a,
                   const rt::RowArgs& r, rt::RowGrid& grid,
                   cudaStream_t st) {
  if (a.n_lanes <= 0) return 0;
  if (a.n_targets < 0 || a.n_targets > kMaxTargets ||
      (a.n_row != 9 && a.n_row != 15) || !rt::row_args_ok(r, a.n_row))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(rt::row_smem_bytes(r, a.n_row));
  int blocks = 0;
  cudaError_t e = rt::row_grid(reinterpret_cast<const void*>(kernel), r, smem,
                               a.n_lanes, grid, blocks);
  if (e == cudaSuccess) e = rt::row_prepare(r, a.n_row, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = rt::row_finish(r, a.n_row, blocks, st);
  return static_cast<int>(e);
}

rt::RowGrid bwd_grid, replay_grid;
#endif  // __CUDACC__

}  // namespace

extern "C" int rt_bounce_bwd(const BwdArgs* a, void* stream) {
  return launch_bwd(bounce_bwd_kernel, *a, a->rows, bwd_grid,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int rt_bounce_bwd_replay(const ReplayArgs* a, void* stream) {
  return launch_bwd(bounce_bwd_replay_kernel, *a, a->rows, replay_grid,
                        static_cast<cudaStream_t>(stream));
}
