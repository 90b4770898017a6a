// The sorted driver's turn around its bounce (render/integrator.py:
// trace_wavefront_sorted): HEAD before the split bounce and TAIL after it,
// one thread a lane each.  Plain PyTorch versions: ops/sorted_turn.py:
// sorted_head_plain and sorted_tail_plain (the driver's torch lines).
//
// HEAD reads lane perm[l]'s state through the re-bin's permutation (the
// stable argsort of TAIL's keys), gives the dead lanes fresh work items,
// draws the counter-hash uniforms of every lane (rng.cuh) and the thin-lens
// ray of each lane that starts a sample (regen.cuh:thin_lens_ray).  TAIL
// takes the bounce's results through the depth cap and Russian roulette,
// adds the finished paths into their pixels, writes the lane state in place
// and the next turn's sort key, and counts.
//
// The queue without a scan: a dead lane's key is 8 * 256^3, above every
// live key, so after the stable argsort the dead lanes are the suffix
// [n_live, R) and the exclusive count of dead lanes before lane l is
// l - n_live.  Dead lane l takes work item next_w + l - n_live if that is
// below total_work: the item the driver's cumsum gave it.  n_live is the
// previous TAIL's count.
//
// The control words ctl (int64): next_w in ctl[par], the live count in
// ctl[2 + par], both read this turn; HEAD's first thread writes next turn's
// next_w into ctl[1 - par], zeroes the live count ctl[3 - par] that TAIL
// adds into, and sets the flag ctl[4] to next_w < total_work; TAIL sets it
// to 1 if a lane stays alive.  The host reads the flag as the loop's
// condition.  The two slots keep a word from being read and written by
// one launch.
//
// What bounds them on an H100: bytes.  HEAD moves ~200 B a lane (the
// gathered state, 76 B, read at random; the lanes' 7 + 3 + 3 floats, the
// N uniform columns, 3 ints and the alive byte written), TAIL ~140 B and
// 12 B of float atomics a finished path.  The hash (ceil(N / 2) avalanches)
// and the camera are a few hundred operations a lane.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "regen.cuh"
#include "rng.cuh"

// Field order and types mirror ops/sorted_turn.py:_HeadArgs.
struct HeadArgs {
  const long long* perm;  // [R] the re-bin's permutation
  const float* fstate;    // [13, R] comps 7, rad 3, thr 3
  const int* istate;      // [4, R] pixel, sample, depth, alive
  long long* ctl;         // [5] control words (above)
  const int* key;         // [2] base key words
  const float* cam;       // [19] camera table
  float *comps, *rad, *thr;  // [7, R], [3, R], [3, R]
  float* u;                  // [n_cols, R] uniform columns
  int* lane;                 // [3, R] pixel, sample, depth
  bool* alive;               // [R]
  long long n_lanes, total_work, n_pix;
  int width, n_cols, n_u, sample_offset, pixel_offset, par;
};

// Field order and types mirror ops/sorted_turn.py:_TailArgs.
struct TailArgs {
  const float *comps, *rad, *thr;  // the bounce's [7, R], [3, R], [3, R]
  const bool *alive, *died;        // the bounce's [R]
  const int* lane;                 // HEAD's [3, R]
  const float* u_rr;               // [R] uniform column n_u + 5
  const float* box;                // [6] the scene box's low corner, 1 / extent
  float* fstate;                   // [13, R]
  int* istate;                     // [4, R]
  int* key;                        // [R] the next turn's sort key
  long long* ctl;                  // [5]
  float* acc;                      // [3, n_pix] radiance sums
  long long* segments;             // [1] or null
  long long n_lanes, n_pix;
  int max_depth, rr_depth, par;  // rr_depth < 0: no Russian roulette
  float rr_min;
};

namespace {

constexpr int kThreads = 128;
constexpr int kSortCells = 256;  // ops/sorted_turn.py:SORT_CELLS
constexpr int kDeadKey = 8 * kSortCells * kSortCells * kSortCells;

// The low 10 bits of x spread to every third bit (the 3-D Morton
// interleave; ops/sorted_turn.py:_spread3).
__device__ __forceinline__ uint32_t spread3(uint32_t x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__device__ __forceinline__ float half_word(uint32_t h) {
  return static_cast<float>(h & 0xFFFFu) * RT_F(1.0 / 65536.0);
}

__global__ void __launch_bounds__(kThreads) sorted_head_kernel(HeadArgs a) {
  const long long R = a.n_lanes;
  const long long l =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long next_w = a.ctl[a.par];
  const long long n_live = a.ctl[2 + a.par];
  if (l == 0) {
    const long long w = next_w + (R - n_live);
    const long long next = w < a.total_work ? w : a.total_work;
    a.ctl[1 - a.par] = next;
    a.ctl[3 - a.par] = 0;
    a.ctl[4] = next < a.total_work ? 1 : 0;
  }
  if (l >= R) return;

  // gather through the permutation
  const long long src = a.perm[l];
  float f[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) f[k] = a.fstate[k * R + src];
  int pix = a.istate[src];
  int smp = a.istate[R + src];
  int dep = a.istate[2 * R + src];
  bool alv = a.istate[3 * R + src] > 0;

  // queue regeneration: dead lanes pull fresh work items
  bool can = false;
  if (!alv) {
    const long long wi = next_w + (l - n_live);
    can = wi < a.total_work;
    if (can) {
      pix = static_cast<int>(wi % a.n_pix);
      smp = static_cast<int>(wi / a.n_pix + a.sample_offset);
      dep = 0;
    }
  }
  alv = alv || can;

  // counter hash: ray_keys_fast + mix_depth + the pair16 columns
  const uint32_t apix =
      static_cast<uint32_t>(a.pixel_offset) + static_cast<uint32_t>(pix);
  uint32_t k0, k1;
  rt::ray_keys_fast(static_cast<uint32_t>(a.key[0]),
                    static_cast<uint32_t>(a.key[1]), apix,
                    static_cast<uint32_t>(smp), k0, k1);
  rt::mix_depth(k0, k1, static_cast<uint32_t>(dep));
  const int n = a.n_cols;
  const int m = (n + 1) / 2;
  float u5[5];  // the camera's columns n_u .. n_u + 4
  for (int c = 0; c < m; ++c) {
    const uint32_t h = rt::finalize2(k0 + static_cast<uint32_t>(c) *
                                              0x9E3779B9u, k1);
    const float lo = half_word(h);
    const float hi = half_word(h >> 16);
    a.u[c * R + l] = lo;
    if (c + m < n) a.u[(c + m) * R + l] = hi;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (c == a.n_u + j) u5[j] = lo;
      if (c + m == a.n_u + j) u5[j] = hi;
    }
  }

  if (can) {
    float ray[7];
    rt::thin_lens_ray(a.cam, a.width, static_cast<int>(apix), u5, ray);
#pragma unroll
    for (int k = 0; k < 7; ++k) f[k] = ray[k];
  }
  const float keep = can ? 0.0f : 1.0f;  // rad * (1 - can)
#pragma unroll
  for (int k = 0; k < 7; ++k) a.comps[k * R + l] = f[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.rad[k * R + l] = f[7 + k] * keep;
    a.thr[k * R + l] = can ? 1.0f : f[10 + k];
  }
  a.lane[l] = pix;
  a.lane[R + l] = smp;
  a.lane[2 * R + l] = dep;
  a.alive[l] = alv;
}

__global__ void __launch_bounds__(kThreads) sorted_tail_kernel(TailArgs a) {
  const long long R = a.n_lanes;
  const long long l =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool alv = false, died = false;
  if (l < R) {
    float c[7], r[3], t[3];
#pragma unroll
    for (int k = 0; k < 7; ++k) c[k] = a.comps[k * R + l];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[k] = a.rad[k * R + l];
      t[k] = a.thr[k * R + l];
    }
    alv = a.alive[l];
    died = a.died[l];
    const int pix = a.lane[l];
    const int smp = a.lane[R + l];
    const int dep = a.lane[2 * R + l] + 1;

    // the depth cap, then Russian roulette
    const bool capped = alv && dep >= a.max_depth;
    died = died || capped;
    alv = alv && !capped;
    if (a.rr_depth >= 0) {
      const float thr_max = rt::tmax(t[0], rt::tmax(t[1], t[2]));
      const float p = rt::clamp(thr_max, a.rr_min, 1.0f);
      const bool roll = dep >= a.rr_depth;
      const bool kill = roll && a.u_rr[l] >= p;
      const float scale = (roll && !kill) ? 1.0f / p : 1.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = t[k] * scale;
      died = died || (alv && kill);
      alv = alv && !kill;
    }

    // flush: the finished path into its pixel
    if (died) {
#pragma unroll
      for (int k = 0; k < 3; ++k) atomicAdd(a.acc + k * a.n_pix + pix, r[k]);
    }

    // the lane state, in place
#pragma unroll
    for (int k = 0; k < 7; ++k) a.fstate[k * R + l] = c[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.fstate[(7 + k) * R + l] = r[k];
      a.fstate[(10 + k) * R + l] = t[k];
    }
    a.istate[l] = pix;
    a.istate[R + l] = smp;
    a.istate[2 * R + l] = dep;
    a.istate[3 * R + l] = alv ? 1 : 0;

    // the next re-bin's key: direction octant, then the Morton code of the
    // origin's cell over the scene box; dead lanes after every live one
    int key = kDeadKey;
    if (alv) {
      const int octant = (c[3] < 0.0f ? 4 : 0) + (c[4] < 0.0f ? 2 : 0) +
                         (c[5] < 0.0f ? 1 : 0);
      uint32_t q[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        q[k] = static_cast<uint32_t>(static_cast<int>(rt::clamp(
            (c[k] - a.box[k]) * a.box[3 + k] * RT_F(kSortCells), 0.0f,
            RT_F(kSortCells - 1))));
      const uint32_t cell =
          spread3(q[0]) | (spread3(q[1]) << 1) | (spread3(q[2]) << 2);
      key = octant * kSortCells * kSortCells * kSortCells +
            static_cast<int>(cell);
    }
    a.key[l] = key;
  }

  // the live count for the next HEAD, the segments and the loop's flag:
  // one atomic a warp
  const unsigned live = __ballot_sync(0xffffffffu, alv);
  const unsigned seg = __ballot_sync(0xffffffffu, alv || died);
  if ((threadIdx.x & 31) == 0) {
    if (live) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.ctl + 3 - a.par),
                static_cast<unsigned long long>(__popc(live)));
      a.ctl[4] = 1;
    }
    if (a.segments != nullptr && seg)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.segments),
                static_cast<unsigned long long>(__popc(seg)));
  }
}

int grid(long long n_lanes) {
  return static_cast<int>((n_lanes + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int rt_sorted_head(const HeadArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  sorted_head_kernel<<<grid(a->n_lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_sorted_tail(const TailArgs* a, void* stream) {
  if (a->n_lanes <= 0) return 0;
  sorted_tail_kernel<<<grid(a->n_lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
