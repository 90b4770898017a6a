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
// The block's dynamic shared memory (the host build's shim has its own).
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float rt_dyn_smem[];
  return rt_dyn_smem;
}
#endif

// Copy n floats from global to shared memory with the whole block.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace rt
