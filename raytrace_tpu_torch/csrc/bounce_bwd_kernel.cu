// The two backward kernels of the differentiable wavefront, K5 (the fused
// iteration, entry rt_bounce_bwd) and K7 (one unfused bounce, entry
// rt_bounce_bwd_replay), both over lane_adjoint.cuh:lane_math_adjoint.
//
// K5 replaces raytrace_tpu/ops/pallas/bounce_bwd_gather_kernel.py:
// bounce_bwd_regen_pre_megakernel (body _kernel_regen_pre).  Plain PyTorch
// version: ops/bounce_bwd_gather_kernel.py:bounce_bwd_regen_pre_plain.
//
// K5, per lane: rebuild the detached regeneration stage of kernel B from the
// saved (pixel, sample, depth) (regen.cuh, bit-identical counter hash and
// camera), form the replayed bounce's inputs (the regeneration selects, the
// far parking of dead lanes), and run lane_math's hand-derived adjoint
// (lane_adjoint.cuh) with the background term and the RR scale around it.
// The winner, material and texture rows arrive gathered per lane; the
// caller reduces the per-lane row gradients onto the tables.
//
// What bounds it on an H100: device-memory traffic.  A lane reads 56
// four-byte columns (27 gathered, the winner index, 3 ints, alive, 7
// components, 3 throughputs, the RR scale, 13 cotangents) and writes 29
// gradients: about 340 B a lane, 85 MiB at 2^18 lanes, 27 us at 3.35 TB/s.
// Its arithmetic, a few thousand flops with branches per lane, is far
// below the card's float32 rate.  The design is the simple one: one thread
// per lane over 1-D SoA columns (coalesced), the camera and target rows in
// shared memory, the whole forward and reverse sweep in registers.
//
// K7 replaces raytrace_tpu/ops/pallas/bounce_bwd_kernel.py:
// bounce_bwd_megakernel (body _kernel).  Plain PyTorch version:
// ops/bounce_bwd_kernel.py:bounce_bwd_megakernel_plain.  It is K5 without
// the regeneration stage, the far parking of dead lanes and the background
// term: the backward of the unfused step (diff/mega_bounce.py) saves the
// bounce's own inputs, so each lane reads its ray, throughput, the 8
// uniform columns and the gathered rows, runs lane_math_adjoint and writes
// the gradients and the miss flag (the caller adds the background term's
// VJP, so any background works).  Bound: device memory, as K5; a lane reads
// 59 columns (27 gathered, the winner index, 10 lane, 8 uniforms, alive,
// 12 cotangents) and writes 27 (26 gradients, miss): 344 B a lane.  One
// thread per lane over 1-D SoA columns, the target rows in shared memory.
#include <cuda_runtime.h>

#include "common.cuh"
#include "lane_adjoint.cuh"
#include "regen.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRow = 15;       // p0 e1 e2 mv0 mv1
constexpr int kGathExtra = 18;    // c0 c1 param kind_p kind_m texkind f0 f1 uvs
constexpr int kNCts = 13;         // o2 (3), d2 (3), time, rad2 (3), thr2 (3)
constexpr int kMaxTargets = 8;
constexpr int kBgSky = 1, kBgGray = 2;
// dead lanes' origin in the replay: far outside the scene, but small enough
// that the record math stays finite (kernel B parks them at 3e18)
constexpr double kFar = 3e9;

}  // namespace

// Field order and types mirror ops/bounce_bwd_gather_kernel.py:_BwdArgs.
struct BwdArgs {
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float* cam;   // [24]
  const int* kt;      // [4]: key words, last sample
  const float* gath[kMaxRow + kGathExtra];  // n_row + 18 used, [R] each
  const float* bi;    // [R] winner index (-1 on a miss)
  const int *pix, *smp, *dep;  // [R]
  const float* al;             // [R] 0/1
  const float* comps[7];       // [R] each: the iteration's input ray
  const float* thr[3];         // [R] each: its input throughput
  const float* scale;          // [R] its RR factor
  const float* cts[kNCts];     // [R] each
  float* out;                  // [n_row + 20, R]
  long long n_lanes;
  int n_targets, has_motion, has_box, n_row, width, bg_kind;
  float t_min;
};

constexpr int kNLane = 10;        // o (3), d (3), time, thr (3)
constexpr int kNReplayCts = 12;   // o2 (3), d2 (3), rad (3), thr2 (3)

// K7's arguments.  Field order and types mirror
// ops/bounce_bwd_kernel.py:_ReplayArgs.
struct ReplayArgs {
  const float* ttbl;  // [>=max(n_targets, 1), 16]
  const float* gath[kMaxRow + kGathExtra];  // n_row + 18 used, [R] each
  const float* bi;                          // [R] winner index (-1 on a miss)
  const float* lane[kNLane];                // [R] each: the bounce's input
  const float* u[rt::kNU];                  // [R] each: its uniforms
  const float* al;                          // [R] 0/1
  const float* cts[kNReplayCts];            // [R] each
  float* out;                               // [n_row + 18, R]
  long long n_lanes;
  int n_targets, has_motion, has_box, n_row;
  float t_min;
};

namespace {

__global__ void __launch_bounds__(kThreads) bounce_bwd_kernel(
    const BwdArgs a) {
  __shared__ float cam[rt::kNCam];
  __shared__ rt::LaneTarget tg[kMaxTargets];
  rt::stage(cam, a.cam, rt::kNCam);
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int t = 0; t < a.n_targets; ++t)
      rt::target_consts(a.ttbl + t * rt::kTCols, acc, tg[t]);
  }
  __syncthreads();

  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const long long R = a.n_lanes;
  const int nr = a.n_row;
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
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.p0[k] = a.gath[k][l];
    x.e1[k] = a.gath[3 + k][l];
    x.e2[k] = a.gath[6 + k][l];
    x.mv0[k] = has_motion ? a.gath[9 + k][l] : 0.0f;
    x.mv1[k] = has_motion ? a.gath[12 + k][l] : 0.0f;
    x.c0[k] = a.gath[nr + k][l];
    x.c1[k] = a.gath[nr + 3 + k][l];
    x.o[k] = ap_f * pre[k] + (1.0f - ap_f) * RT_F(kFar);
    x.d[k] = pre[3 + k];
    x.thr[k] = can_f + (1.0f - can_f) * a.thr[k][l];
  }
  x.param = a.gath[nr + 6][l];
  x.time = pre[6];
  rt::LaneDet det;
  det.kind_p = a.gath[nr + 7][l];
  det.kind_m = a.gath[nr + 8][l];
  det.texkind = a.gath[nr + 9][l];
  det.f0 = a.gath[nr + 10][l];
  det.f1 = a.gath[nr + 11][l];
#pragma unroll
  for (int k = 0; k < 6; ++k) det.uv[k] = a.gath[nr + 12 + k][l];
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

  float* o = a.out;
  int row = 0;
  const float* rows[5] = {g.p0, g.e1, g.e2, g.mv0, g.mv1};
  for (int j = 0; j < nr / 3; ++j)
    for (int k = 0; k < 3; ++k) o[(row++) * R + l] = rows[j][k];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.c0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.c1[k];
  o[(row++) * R + l] = g.param;
#pragma unroll
  for (int k = 0; k < 7; ++k) o[(row++) * R + l] = g_pre[k] * keep;
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = ct.rad[k] * keep;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    o[(row++) * R + l] = (g.thr[k] + g_thr_bg[k]) * keep;
}

// K7: lane_math's adjoint over the saved inputs of one bounce.
__global__ void __launch_bounds__(kThreads) bounce_bwd_replay_kernel(
    const ReplayArgs a) {
  __shared__ rt::LaneTarget tg[kMaxTargets];
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int t = 0; t < a.n_targets; ++t)
      rt::target_consts(a.ttbl + t * rt::kTCols, acc, tg[t]);
  }
  __syncthreads();

  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const long long R = a.n_lanes;
  const int nr = a.n_row;
  const bool has_motion = a.has_motion != 0;

  rt::LaneIn x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.p0[k] = a.gath[k][l];
    x.e1[k] = a.gath[3 + k][l];
    x.e2[k] = a.gath[6 + k][l];
    x.mv0[k] = has_motion ? a.gath[9 + k][l] : 0.0f;
    x.mv1[k] = has_motion ? a.gath[12 + k][l] : 0.0f;
    x.c0[k] = a.gath[nr + k][l];
    x.c1[k] = a.gath[nr + 3 + k][l];
    x.o[k] = a.lane[k][l];
    x.d[k] = a.lane[3 + k][l];
    x.thr[k] = a.lane[7 + k][l];
  }
  x.param = a.gath[nr + 6][l];
  x.time = a.lane[6][l];
  rt::LaneDet det;
  det.kind_p = a.gath[nr + 7][l];
  det.kind_m = a.gath[nr + 8][l];
  det.texkind = a.gath[nr + 9][l];
  det.f0 = a.gath[nr + 10][l];
  det.f1 = a.gath[nr + 11][l];
#pragma unroll
  for (int k = 0; k < 6; ++k) det.uv[k] = a.gath[nr + 12 + k][l];
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

  float* o = a.out;
  int row = 0;
  const float* rows[5] = {g.p0, g.e1, g.e2, g.mv0, g.mv1};
  for (int j = 0; j < nr / 3; ++j)
    for (int k = 0; k < 3; ++k) o[(row++) * R + l] = rows[j][k];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.c0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.c1[k];
  o[(row++) * R + l] = g.param;
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.o[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.d[k];
  o[(row++) * R + l] = g.time;
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(row++) * R + l] = g.thr[k];
  o[row * R + l] = miss;
}

}  // namespace

extern "C" int rt_bounce_bwd(const BwdArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_targets < 0 || a->n_targets > kMaxTargets ||
      (a->n_row != 9 && a->n_row != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  bounce_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_bounce_bwd_replay(const ReplayArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_targets < 0 || a->n_targets > kMaxTargets ||
      (a->n_row != 9 && a->n_row != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  bounce_bwd_replay_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
