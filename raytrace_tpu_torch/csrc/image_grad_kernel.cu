// Kernel K13: the image atlas's gradient, a scatter-add of per-lane texel
// cotangents into the [I, H, W, 3] atlas.
//
// Replaces raytrace_tpu/ops/pallas/image_grad_kernel.py:image_grad_pallas
// (_kernel), whose row x column one-hot products exist because a TPU
// scatter is slow.  Plain PyTorch version:
// ops/image_grad_kernel.py:image_grad_plain.
//
// What bounds it on an H100: bytes, and contention on the atomics.  A lane
// reads 3 indices and 3 cotangents (24 bytes); each lane with a nonzero
// cotangent adds 3 floats into the atlas (L2 atomics).  The design is the
// simple one: one thread per lane, an atomicAdd per channel.  A lane whose
// cotangent is zero in all three channels writes nothing, as the TPU
// kernel's zero skip does: the image-only deferred multiply sends every
// lane that does not sample the atlas to texel (0, 0) with a zero
// cotangent, and without the skip most lanes would queue on one address.
// The caller zeroes the output.
#include <cuda_runtime.h>

#include "common.cuh"

// Field order and types mirror ops/image_grad_kernel.py:_ImageGradArgs.
struct ImageGradArgs {
  const int *img, *j, *i;  // [R] image, row and column of each lane's texel
  const float* g;          // [R, 3] texel cotangent
  float* out;              // [n_img, h, w, 3], zeroed by the caller
  long long n_lanes;
  int n_img, h, w;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
image_grad_kernel(const ImageGradArgs a) {
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (l >= a.n_lanes) return;
  const float g0 = a.g[3 * l], g1 = a.g[3 * l + 1], g2 = a.g[3 * l + 2];
  if (g0 == 0.0f && g1 == 0.0f && g2 == 0.0f) return;
  const long long t =
      ((static_cast<long long>(a.img[l]) * a.h + a.j[l]) * a.w + a.i[l]) * 3;
  atomicAdd(a.out + t, g0);
  atomicAdd(a.out + t + 1, g1);
  atomicAdd(a.out + t + 2, g2);
}

}  // namespace

extern "C" int rt_image_grad(const ImageGradArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  const long long blocks = (a->n_lanes + kThreads - 1) / kThreads;
  image_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
