// Nearest hit of one ray over a packed primitive table of any size (up to
// the dense cap of 65,536 rows) by a stackless walk of a threaded BVH.
// The Hopper form of raytrace_tpu/ops/pallas/allpairs_kernel.py:
// allpairs_nearest_record (and of the intersect stage of
// iter_kernel.py:_iter_mega_ap), whose chunk plans, W-wide relabelling,
// batched chunk visibility and sub-cluster consensus exist to keep a TPU's
// vector unit busy; on the card each thread walks its own ray.  Plain
// version: ops/allpairs_kernel.py:allpairs_nearest_plain (the all-pairs
// broadcast of the same per-row arithmetic).
//
// Layout (ops/allpairs_kernel.py:pack_bvh): nodes [n_nodes, 8] f32 in
// depth-first order: lo xyz, hi xyz, then two int32 words: an interior
// node holds (escape index, 0), a leaf (first entry in leaf_rows, count).
// The next node after a visited one is i + 1 (first child, or the next
// subtree after a leaf); a culled interior node jumps to its escape index.
// leaf_rows indexes the packed table, whose rows are read through the
// read-only data cache (the table does not fit shared memory at mesh
// scale; it stays in L2).
//
// The walk must never cull a node holding a hit the flat scan finds:
// * node boxes are padded outward at pack time (the per-row tests accept
//   hits a rounding error outside a primitive's exact bounds);
// * 1/d comes from the same safe_dir as the box rows' slab test;
// * the slab interval is widened by a few ulps, and a NaN slab never
//   culls (every cull test is a comparison that a NaN fails);
// * a node is entered while its near distance is <= the best t (not <),
//   so an equally near hit in a lower row is still reached.
// Ties go to the lowest row whatever the visiting order (prim_test).
#pragma once

#include "common.cuh"
#include "prim_loop.cuh"

namespace rt {

constexpr int kNodeCols = 8;

// A row in global memory, read through the read-only data cache.
struct LdgRow {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const {
    return __ldg(p + k);
  }
};

// Counts of the work one ray did (nodes whose box was tested, rows whose
// primitive was tested); the plain walk passes none.
struct Visits {
  int nodes = 0, rows = 0;
};

template <bool kCount>
__device__ __forceinline__ HitRec bvh_nearest(
    const float* __restrict__ nodes, int n_nodes,
    const int* __restrict__ leaf_rows, const float* __restrict__ tbl,
    float ox, float oy, float oz, float dx, float dy, float dz, float tm,
    float t_min, bool has_motion, bool with_albedo, Visits* visits) {
  HitRec h = miss_record();
  const float inv_dx = 1.0f / safe_dir(dx);
  const float inv_dy = 1.0f / safe_dir(dy);
  const float inv_dz = 1.0f / safe_dir(dz);
  const float widen = RT_F(1e-6);
  int i = 0;
#pragma unroll 1
  while (i < n_nodes) {
    const float* nd = nodes + i * kNodeCols;
    const float t0x = (__ldg(nd + 0) - ox) * inv_dx;
    const float t0y = (__ldg(nd + 1) - oy) * inv_dy;
    const float t0z = (__ldg(nd + 2) - oz) * inv_dz;
    const float t1x = (__ldg(nd + 3) - ox) * inv_dx;
    const float t1y = (__ldg(nd + 4) - oy) * inv_dy;
    const float t1z = (__ldg(nd + 5) - oz) * inv_dz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fmaxf(t0z, t1z));
    tn = tn - widen * fabsf(tn);
    tf = tf + widen * fabsf(tf);
    const bool cull = (tn > tf) || (tn > h.t) || (tf < t_min);
    const int w6 = __float_as_int(__ldg(nd + 6));
    const int count = __float_as_int(__ldg(nd + 7));
    if (kCount) visits->nodes += 1;
    if (!cull && count > 0) {
#pragma unroll 1
      for (int k = 0; k < count; ++k) {
        const int r = __ldg(leaf_rows + w6 + k);
        prim_test(LdgRow{tbl + static_cast<long long>(r) * kCols}, r, ox, oy,
                  oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, tm, t_min,
                  has_motion, with_albedo, h);
      }
      if (kCount) visits->rows += count;
    }
    i = (cull && count == 0) ? w6 : i + 1;
  }
  face_ray(h);
  return h;
}

}  // namespace rt
