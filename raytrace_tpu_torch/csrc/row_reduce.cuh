// The winner-row gather and the row-gradient reduction of the backward
// kernels K5 and K7 (bounce_bwd_kernel.cu).
//
// The TPU kernels are handed each lane's winner, material and texture rows
// gathered by one-hot matmuls, and their caller reduces the per-lane row
// gradients onto the scene's tables by one-hot-transpose matmuls
// (raytrace_tpu/diff/fused_iter.py:192-260): a TPU has no fast gather or
// scatter.  On the H100 each lane reads its winner's row by index from the
// per-prim column table (ops/row_reduce.py:row_tables: p0 e1 e2 [mv0 mv1],
// c0 c1 param, kind_p kind_m texkind f0 f1 uvs), and the lanes'
// row gradients (p0 e1 e2 [mv0 mv1], c0 c1 param: n_row + 7 columns) are
// summed onto the table inside the kernel, so no per-lane row column
// reaches device memory and no atomic index_add_ over lanes runs.  A miss
// lane reads and adds to row 0, as the plain version does.
//
// The modes (RowArgs::mode; the wrapper picks staged or global from the
// table's bytes, ops/row_reduce.py:row_mode):
//  * staged, when the table and kRowWarps accumulators of [P, n_row + 7]
//    fit kStageBytes of shared memory (Cornell: 24 rows, 8.7 KB): the table
//    is copied to shared memory.  The lanes of a warp with the same winner
//    are summed by a shuffle tree in the order of their ranks in the group
//    (__match_any_sync), and the group's lowest lane adds the sum into its
//    warp's accumulator.  The block sums its warps in order into its
//    partial, and row_sum_kernel sums the blocks' partials in a fixed
//    order.  The grid is set by the lane count and the card alone, so the
//    sums are the same from run to run on one card.
//  * global, for larger tables (the meshes' up to 8192 rows): rows are read
//    from device memory (L2-resident), and each group's sum goes to the
//    [P, n_row + 7] sums by float atomics.  Mesh winners spread over
//    thousands of rows, so atomics rarely meet; the order of the adds, and
//    so the last bits of the sums, change from run to run.
//  * per lane (checks only): the rows arrive gathered per lane as
//    [n_row + 18, R] columns and every lane's row gradients are written out.
// row_map_kernel then maps the prim sums onto the materials (param, by
// mat[p]) and textures (c0 and c1, by tex[p]): one block for each material
// and texture row, looping over the prims, not the lanes.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kRowThreads = 128;               // threads of a backward block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxRow = 15;                    // p0 e1 e2 mv0 mv1
constexpr int kGathExtra = 18;                 // table columns after the rows
constexpr int kMaxGradCols = kMaxRow + 7;      // + c0 c1 param
// dynamic shared memory of the staged mode; with the kernels' own ~1 KB of
// static shared memory it stays under the 48 KB a launch gets by default
constexpr int kStageBytes = 40 * 1024;
constexpr int kSumWarps = 16;                  // row_sum_kernel: 512 threads
constexpr int kMapThreads = 256;               // row_map_kernel
enum RowMode { kRowPerLane = 0, kRowStaged = 1, kRowGlobal = 2 };

// Field order and types mirror ops/row_reduce.py:_RowArgs.
struct RowArgs {
  const float* cols;     // [P, n_row + 18] table; per lane [n_row + 18, R]
  const int *mat, *tex;  // [P] material and texture row of each prim
  float* part;           // staged: [n_part, P, n_row + 7] block partials
  float* sums;           // [P, n_row + 7] row gradients summed per prim
  float* g_mparam;       // [n_mats] material param gradients
  float* g_tex;          // [n_tex, 6] texture c0 (3), c1 (3) gradients
  long long n_part;
  int n_prims, n_mats, n_tex, mode;
};

// One lane's winner row: element k at p[k * s].
struct RowRef {
  const float* p;
  long long s;
  __device__ __forceinline__ float operator()(int k) const {
    return p[k * s];
  }
};

// The prim whose row a lane reads and whose sums it adds to.
__device__ __forceinline__ int winner_key(float bi) {
  return bi >= 0.0f ? static_cast<int>(bi) : 0;
}

// Lane l's row: in the staged table `tab`, in the device table, or in the
// per-lane gathered columns.
__device__ __forceinline__ RowRef winner_row(const RowArgs& r,
                                             const float* tab, int ncol,
                                             long long l, long long n_lanes,
                                             float bi) {
  if (r.mode == kRowPerLane) return RowRef{r.cols + l, n_lanes};
  const float* t = r.mode == kRowStaged ? tab : r.cols;
  return RowRef{t + static_cast<long long>(winner_key(bi)) * ncol, 1};
}

// The column in [P, n_row + 7] of register j of a lane's row gradients
// (p0 e1 e2 mv0 mv1 c0 c1 param, kMaxGradCols registers); -1 for the
// motion rows of a table without motion.
__device__ __forceinline__ int grad_col(int j, int nr) {
  return j < nr ? j : (j < kMaxRow ? -1 : j - (kMaxRow - nr));
}

// Staged mode, before the lanes: the table `tab` and the warps' zeroed
// accumulators `acc` in shared memory.  The caller syncs the block.
__device__ __forceinline__ void row_begin(const RowArgs& r, int nr,
                                          float* tab, float* acc) {
  if (r.mode != kRowStaged) return;
  const int nt = r.n_prims * (nr + kGathExtra);
  for (int i = threadIdx.x; i < nt; i += blockDim.x) tab[i] = r.cols[i];
  const int na = kRowWarps * r.n_prims * (nr + 7);
  for (int i = threadIdx.x; i < na; i += blockDim.x) acc[i] = 0.0f;
}

// The k-th (from 0) set bit of m.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  for (int i = 0; i < k; ++i) m &= m - 1u;
  return __ffs(static_cast<int>(m)) - 1;
}

// One lane's row gradients g (key: its winner, -1 past the last lane).
// Per lane: written to out[col * R + l].  Staged and global: every lane of
// the warp calls this; the lanes with one key are summed by a shuffle tree
// over their ranks in the group, and the group's lowest lane adds the sum
// to its warp's accumulator in `acc` (staged) or atomically to r.sums.
__device__ __forceinline__ void row_add(const RowArgs& r, int nr, float* acc,
                                        float* out, long long l,
                                        long long n_lanes, int key,
                                        float (&g)[kMaxGradCols]) {
  if (r.mode == kRowPerLane) {
    if (l < n_lanes) {
#pragma unroll
      for (int j = 0; j < kMaxGradCols; ++j) {
        const int c = grad_col(j, nr);
        if (c >= 0) out[c * n_lanes + l] = g[j];
      }
    }
    return;
  }
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(kAll, key);
  const int rank = __popc(grp & ((1u << lane) - 1u));
  const int n = __popc(grp);
  const int n_max = static_cast<int>(
      __reduce_max_sync(kAll, static_cast<unsigned>(n)));
  for (int s = 1; s < n_max; s <<= 1) {
    const bool take = (rank & (2 * s - 1)) == 0 && rank + s < n;
    const int src = take ? nth_set_bit(grp, rank + s) : lane;
#pragma unroll
    for (int j = 0; j < kMaxGradCols; ++j) {
      if (grad_col(j, nr) >= 0) {
        const float v = __shfl_sync(kAll, g[j], src);
        if (take) g[j] += v;
      }
    }
  }
  if (rank == 0 && key >= 0) {
    const int nc = nr + 7;
    const bool staged = r.mode == kRowStaged;
    float* dst = (staged ? acc + (threadIdx.x >> 5) * r.n_prims * nc
                         : r.sums) +
                 static_cast<long long>(key) * nc;
#pragma unroll
    for (int j = 0; j < kMaxGradCols; ++j) {
      const int c = grad_col(j, nr);
      if (c < 0) continue;
      if (staged)
        dst[c] += g[j];
      else
        atomicAdd(dst + c, g[j]);
    }
  }
  __syncwarp();
}

// Staged mode, after the lanes: the block's partial, its warps'
// accumulators summed in order.
__device__ __forceinline__ void row_end(const RowArgs& r, int nr,
                                        const float* acc) {
  if (r.mode != kRowStaged) return;
  __syncthreads();
  const int pc = r.n_prims * (nr + 7);
  float* dst = r.part + static_cast<long long>(blockIdx.x) * pc;
  for (int e = threadIdx.x; e < pc; e += blockDim.x) {
    float s = acc[e];
    for (int w = 1; w < kRowWarps; ++w) s += acc[w * pc + e];
    dst[e] = s;
  }
}

// Staged mode: sums[e] = the sum of entry e over the n_blk partials, in a
// fixed order.  A block takes 32 entries, one per lane; warp w sums
// partials w, w + kSumWarps, ..., and the block adds its warps in order.
__global__ void __launch_bounds__(kSumWarps * 32)
    row_sum_kernel(const RowArgs r, int nc, int n_blk) {
  __shared__ float s[kSumWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long pc = static_cast<long long>(r.n_prims) * nc;
  const long long e = static_cast<long long>(blockIdx.x) * 32 + lane;
  float acc = 0.0f;
  if (e < pc)
    for (int b = w; b < n_blk; b += kSumWarps) acc += r.part[b * pc + e];
  s[w][lane] = acc;
  __syncthreads();
  if (w == 0 && e < pc) {
    float t = s[0][lane];
    for (int k = 1; k < kSumWarps; ++k) t += s[k][lane];
    r.sums[e] = t;
  }
}

// Block b < n_mats: g_mparam[b], the param column summed over the prims of
// material b; block n_mats + t: g_tex[t], the c0 and c1 columns summed
// over the prims of texture t.  The threads stride over the prims and the
// block adds their sums as a tree, in a fixed order.
__global__ void __launch_bounds__(kMapThreads)
    row_map_kernel(const RowArgs r, int nr) {
  __shared__ float s[6][kMapThreads];
  const int nc = nr + 7;
  const bool is_mat = static_cast<int>(blockIdx.x) < r.n_mats;
  const int id = is_mat ? blockIdx.x : blockIdx.x - r.n_mats;
  const int nk = is_mat ? 1 : 6;
  const int c0 = is_mat ? nr + 6 : nr;
  const int* owner = is_mat ? r.mat : r.tex;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < r.n_prims; p += blockDim.x) {
    if (owner[p] != id) continue;
    const float* row = r.sums + static_cast<long long>(p) * nc + c0;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < nk) acc[k] += row[k];
  }
  for (int k = 0; k < 6; ++k) s[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int h = kMapThreads / 2; h > 0; h >>= 1) {
    if (static_cast<int>(threadIdx.x) < h)
      for (int k = 0; k < nk; ++k) s[k][threadIdx.x] += s[k][threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (is_mat)
    r.g_mparam[id] = s[0][0];
  else
    for (int k = 0; k < 6; ++k) r.g_tex[id * 6 + k] = s[k][0];
}

#ifdef __CUDACC__
// Host side of a launch.

// Dynamic shared memory of the staged mode: the table, then the warps'
// accumulators.
inline long long row_smem_bytes(const RowArgs& r, int nr) {
  if (r.mode != kRowStaged) return 0;
  return 4LL * r.n_prims * ((nr + kGathExtra) + kRowWarps * (nr + 7));
}

inline bool row_args_ok(const RowArgs& r, int nr) {
  if (r.cols == nullptr) return false;
  if (r.mode == kRowPerLane) return true;
  if (r.mode != kRowStaged && r.mode != kRowGlobal) return false;
  if (r.n_prims < 1 || r.n_mats < 1 || r.n_tex < 0 || r.mat == nullptr ||
      r.tex == nullptr || r.sums == nullptr || r.g_mparam == nullptr ||
      (r.n_tex > 0 && r.g_tex == nullptr))
    return false;
  return r.mode == kRowGlobal ||
         (r.part != nullptr && r.n_part >= 1 &&
          row_smem_bytes(r, nr) <= kStageBytes);
}

// The occupancy of one kernel on the current card, cached.
struct RowGrid {
  int dev = -1, smem = -1, blocks = 0;
};

// A grid of as many blocks of kRowThreads as fit on the card at once, at
// most one for each 128 lanes and, staged, at most n_part.
inline cudaError_t row_grid(const void* kernel, const RowArgs& r, int smem,
                            long long n_lanes, RowGrid& cache, int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cache.dev != dev || cache.smem != smem) {
    int n_sm = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kRowThreads, smem);
    if (e != cudaSuccess) return e;
    cache.dev = dev;
    cache.smem = smem;
    cache.blocks = n_sm * per_sm;
  }
  long long b = (n_lanes + kRowThreads - 1) / kRowThreads;
  if (b > cache.blocks) b = cache.blocks;
  if (r.mode == kRowStaged && b > r.n_part) b = r.n_part;
  blocks = b < 1 ? 1 : static_cast<int>(b);
  return cudaSuccess;
}

// Before the kernel: the global mode's sums start at zero.
inline cudaError_t row_prepare(const RowArgs& r, int nr, cudaStream_t st) {
  if (r.mode != kRowGlobal) return cudaSuccess;
  return cudaMemsetAsync(r.sums, 0, 4LL * r.n_prims * (nr + 7), st);
}

// After the kernel's `blocks` blocks: the staged partials summed, then the
// sums mapped onto the materials and textures.
inline cudaError_t row_finish(const RowArgs& r, int nr, int blocks,
                              cudaStream_t st) {
  if (r.mode == kRowPerLane) return cudaSuccess;
  if (r.mode == kRowStaged) {
    const long long pc = static_cast<long long>(r.n_prims) * (nr + 7);
    row_sum_kernel<<<static_cast<unsigned>((pc + 31) / 32), kSumWarps * 32,
                     0, st>>>(r, nr + 7, blocks);
  }
  row_map_kernel<<<static_cast<unsigned>(r.n_mats + r.n_tex), kMapThreads,
                   0, st>>>(r, nr);
  return cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace rt
