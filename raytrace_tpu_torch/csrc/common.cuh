// Shared helpers of the render kernels.
//
// The kernels are built with --fmad=false and without --use_fast_math, and
// every expression keeps the association of its plain PyTorch version
// (ops/*.py), so kernel and plain version round alike.  Constants are
// written as double literals cast to float, the way PyTorch casts a Python
// float to f32.
#pragma once

#include <cstdint>

#define RT_F(x) static_cast<float>(x)

namespace rt {

constexpr int kCols = 36;     // packed primitive table columns
constexpr int kMCols = 12;    // material (behaviour) table columns
constexpr int kTCols = 16;    // redirect target table columns
constexpr int kNU = 8;        // uniform columns of one bounce

constexpr double kPiD = 3.14159265358979323846;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// NaN-propagating max/min/clamp (torch.maximum, torch.clamp semantics)
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan_(x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

#ifdef __CUDACC__
// The block's dynamic shared memory, 16-byte aligned (the host build's shim
// has its own).
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float rt_dyn_smem[];
  return rt_dyn_smem;
}

// The number of blocks of `threads` threads with `smem` bytes of dynamic
// shared memory that the card holds at once, for a persistent grid; one
// cache per kernel, refreshed when the device or the size changes.
struct Resident {
  int dev = -1, smem = -1, blocks = 0;
};

inline cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                                   Resident& cache, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cache.dev != dev || cache.smem != smem) {
    int n_sm = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) return e;
    cache.dev = dev;
    cache.smem = smem;
    cache.blocks = n_sm * per_sm;
  }
  blocks = cache.blocks;
  return cudaSuccess;
}
#endif

// Copy n floats from global to shared memory with the whole block.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace rt
