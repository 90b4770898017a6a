// Kernel K12: the marble texture's stripe for the lanes that sample one.
//
// Replaces raytrace_tpu/ops/pallas/texture_kernel.py:marble_stripe_pallas
// (_marble_call, _kernel).  Plain PyTorch version:
// ops/texture_kernel.py:marble_stripe_plain.
//
// What bounds it on an H100: operations, and the latency of their
// dependent chains.  A lane reads 16 bytes and writes 4; a marble lane then
// evaluates 7 octaves of 8 hash-gradient corners (three avalanches, the
// gradient's hash, an accurate sqrt, sine and cosine, a dot and a weight
// at each), a non-marble lane nothing.  The marble lanes are a minority
// of a render's (the ball of noise_test is a fifth of its camera lanes),
// so one thread a lane leaves a few hundred warps doing all the work, a
// warp or two a scheduler, stalled on each corner's chain.  The design:
// * compaction in the kernel: a block takes a tile of kTile lanes; its
//   first warps read them, one a thread, write 0 to every lane that
//   samples no marble row at once, and pack the marble lanes and their row
//   (the last row of the staged table whose id matches, as the plain
//   version's torch.where loop gives it) into a shared list by
//   __ballot_sync and __popc;
// * a group of kSplit x kOct = 8 threads for each listed lane
//   (noise.cuh:marble_stripe_group): 2 corner groups (4 corners each) x 4
//   octave groups (octaves o, o + 4), so a thread runs 2 octaves of 4
//   independent corners instead of 7 of 8; the terms of an octave meet by
//   shuffles and are summed in the plain order, then the octaves are
//   folded in the plain order.  Four marble lanes fill a warp, a warp
//   whose groups have no lane exits, and a lane's dependent chain is
//   2/7 of one thread's.  Measured on an H100 (PERF.md section 6): the
//   one-thread-a-lane kernel, 8 or 4 threads a lane without octave
//   groups, 2 x 2, 4 x 2 and 4 x 4, tiles of 16, 64, 128 and 256 lanes, a
//   persistent grid and the table read from global memory were slower or
//   no faster on noise_test's camera and route lanes.
#include <cuda_runtime.h>

#include "common.cuh"
#include "noise.cuh"

// Field order and types mirror ops/texture_kernel.py:_MarbleArgs.
struct MarbleArgs {
  const float* mtbl;  // [n_marble, 8]: row id, freq, direction (3), shift (3)
  const int* tid;     // [R] texture id of each lane
  const float* pts;   // [R, 3] points
  float* out;         // [R]
  long long n_lanes;
  int n_marble;
};

namespace {

constexpr int kMarbleCols = 8;
constexpr int kMaxMarble = 32;  // ops/texture_kernel.py:MAX_MARBLE
constexpr int kTile = 32;       // lanes a block takes, one a thread
constexpr int kSplit = 2;       // corner groups a marble lane
constexpr int kOct = 4;         // octave groups a marble lane
constexpr int kWidth = kSplit * kOct;  // threads a marble lane
constexpr int kThreads = kTile * kWidth;
constexpr int kGroups = 32 / kWidth;   // marble lanes a warp
static_assert(kTile % 32 == 0, "whole warps read the tile");

__global__ void __launch_bounds__(kThreads) marble_kernel(const MarbleArgs a) {
  __shared__ float rows[kMaxMarble * kMarbleCols];
  __shared__ int list[kTile];  // the tile's marble lanes, packed
  __shared__ int list_row[kTile];
  __shared__ int warp_n[kTile / 32];
  rt::stage(rows, a.mtbl, a.n_marble * kMarbleCols);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int w = static_cast<int>(threadIdx.x) / 32;
  const unsigned lane = threadIdx.x % 32u;
  int m = -1;
  unsigned mask = 0;
  if (threadIdx.x < kTile) {
    const long long l = base + threadIdx.x;
    if (l < a.n_lanes) {
      const float t = static_cast<float>(a.tid[l]);
#pragma unroll 1
      for (int r = 0; r < a.n_marble; ++r)
        if (t == rows[r * kMarbleCols]) m = r;  // the last match wins
      if (m < 0) a.out[l] = 0.0f;
    }
    mask = __ballot_sync(0xffffffffu, m >= 0);
    if (lane == 0) warp_n[w] = __popc(mask);
  }
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int v = 0; v < kTile / 32; ++v) {
    before += v < w ? warp_n[v] : 0;
    n += warp_n[v];
  }
  if (m >= 0) {
    const int slot = before + __popc(mask & ((1u << lane) - 1u));
    list[slot] = static_cast<int>(threadIdx.x);
    list_row[slot] = m;
  }
  __syncthreads();
  const int g = static_cast<int>(threadIdx.x) / kWidth;  // the group
  if (g - g % kGroups >= n) return;  // the warp's groups have no lane
  // a group past the list repeats its last lane (the warp's shuffles need
  // every thread) and writes nothing
  const int e = g < n ? g : n - 1;
  const long long l = base + list[e];
  const float* r = rows + list_row[e] * kMarbleCols;
  const int part = static_cast<int>(threadIdx.x) % kWidth;
  const float v = rt::marble_stripe_group<kSplit, kOct>(
      r[1], r[2], r[3], r[4], r[5], r[6], r[7], a.pts[3 * l],
      a.pts[3 * l + 1], a.pts[3 * l + 2], part);
  if (g < n && part == 0) a.out[l] = v;
}

}  // namespace

extern "C" int rt_marble(const MarbleArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_marble <= 0 || a->n_marble > kMaxMarble)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (a->n_lanes + kTile - 1) / kTile;
  marble_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
