// Kernel K12: the marble texture's stripe for the lanes that sample one.
//
// Replaces raytrace_tpu/ops/pallas/texture_kernel.py:marble_stripe_pallas
// (_marble_call, _kernel).  Plain PyTorch version:
// ops/texture_kernel.py:marble_stripe_plain.
//
// What bounds it on an H100: operations.  A lane reads 16 bytes and writes
// 4; a marble lane then evaluates 7 octaves of 8 hash-gradient corners
// (about 4,600 operations, a sine and a cosine of some 20 each at every
// corner), a non-marble lane nothing.  The design is the simple one: one
// thread per lane, the scene's marble rows (a handful of 8-float rows)
// staged in shared memory, the turbulence computed only for the row the
// lane's texture id names.  Neighbouring lanes of a render mostly share a
// texture, so a warp diverges only where a marble object's edge crosses
// it.
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

constexpr int kThreads = 128;
constexpr int kMarbleCols = 8;
constexpr int kMaxMarble = 32;  // ops/texture_kernel.py:MAX_MARBLE

__global__ void __launch_bounds__(kThreads) marble_kernel(const MarbleArgs a) {
  __shared__ float rows[kMaxMarble * kMarbleCols];
  rt::stage(rows, a.mtbl, a.n_marble * kMarbleCols);
  __syncthreads();
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const float t = static_cast<float>(a.tid[l]);
  float acc = 0.0f;
#pragma unroll 1
  for (int m = 0; m < a.n_marble; ++m) {
    const float* r = rows + m * kMarbleCols;
    if (t == r[0])
      acc = rt::marble_stripe(r[1], r[2], r[3], r[4], r[5], r[6], r[7],
                              a.pts[3 * l], a.pts[3 * l + 1],
                              a.pts[3 * l + 2]);
  }
  a.out[l] = acc;
}

}  // namespace

extern "C" int rt_marble(const MarbleArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  if (a->n_marble <= 0 || a->n_marble > kMaxMarble)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  marble_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
