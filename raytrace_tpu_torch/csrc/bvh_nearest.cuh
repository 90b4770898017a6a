// Nearest hit of one ray over a packed primitive table of any size (up to
// 2^24 rows: a row's index travels as f32, ops/allpairs_kernel.py:
// MAX_BVH_ROWS) by a near-child-first walk of a binned-SAH BVH of two-box
// nodes.  The Hopper form of
// raytrace_tpu/ops/pallas/allpairs_kernel.py:allpairs_nearest_record (and
// of the intersect stage of iter_kernel.py:_iter_mega_ap), whose chunk
// plans, W-wide relabelling, batched chunk visibility and sub-cluster
// consensus exist to keep a TPU's vector unit busy; on the card each
// thread walks its own ray.  Plain version:
// ops/allpairs_kernel.py:allpairs_nearest_plain (the all-pairs broadcast
// of the same per-row arithmetic).
//
// Layout (ops/allpairs_kernel.py:pack_bvh, scene/bvh.py:build_sah_bvh):
// nodes [n_nodes, 16] f32 breadth-first from the root, fetched as four
// float4: the left child's box lo, hi, the right child's lo, hi, then the
// words (left, right) and counts (left, right) as int32 bits.  A child of
// count 0 is the interior node of that index, a leaf gives its first row
// and count in `rows`, a copy of the table's real rows in leaf order whose
// column kOrigCol holds each row's index in the packed table.  Leaves read
// contiguous rows; ties and outputs use the original index.
//
// The walk tests both children of a node, enters the nearer (by entry
// distance) and pushes the farther with its entry distance onto a fixed
// stack of kStack entries (pack_bvh refuses a deeper tree); a popped entry
// whose distance is beyond the best hit is dropped unread.  Nodes and rows
// come through the read-only cache (the stand-in's 1,543 nodes and 4,992
// rows, 0.8 MB, stay in L2).  Staging the top 512 nodes in shared memory
// once per block of the persistent kernels was measured 11-40% slower on
// an H100 (PERF.md §6): the 32 KB a block cut the resident warps, and
// every block copied them before its first ray.
//
// The walk must never cull a node holding a hit the flat scan finds:
// * node boxes are padded outward at pack time (the per-row tests accept
//   hits a rounding error outside a primitive's exact bounds);
// * 1/d comes from the same safe_dir as the box rows' slab test;
// * the slab interval is widened by a few ulps, and a NaN slab never
//   culls (every cull test is a comparison that a NaN fails);
// * a child is entered while its near distance is <= the best t (not <),
//   so an equally near hit in a lower row is still reached.
// Ties go to the lowest row whatever the visiting order (prim_test).
//
// kTriOnly: every row is an unmoving triangle (the bunny-scale meshes), so
// each row runs only prim_test's triangle branch, in the same association,
// reading the columns it needs as float4; other tables run prim_test.
#pragma once

#include "common.cuh"
#include "prim_loop.cuh"

namespace rt {

constexpr int kStack = 32;    // ops/allpairs_kernel.py:STACK_SIZE
constexpr int kOrigCol = 35;  // ops/allpairs_kernel.py:ORIG_COL

// Counts of the work one ray did (box tests: two a node; rows whose
// primitive was tested); the plain walk passes none.
struct Visits {
  int nodes = 0, rows = 0;
  // where not null, set to 1 at each node and row read
  unsigned char* seen_nodes = nullptr;
  unsigned char* seen_rows = nullptr;
};

// The tree as a walk reads it.
struct Bvh {
  const float4* nodes;  // [n_nodes * 4]
  const float* rows;    // [n_rows, kCols] leaf-ordered
};

// A row in global memory, read through the read-only data cache.
struct LdgRow {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const {
    return __ldg(p + k);
  }
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The widened slab interval of the ray against box (lo, hi).
__device__ __forceinline__ void slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float ox, float oy, float oz,
                                     float inv_dx, float inv_dy,
                                     float inv_dz, float& tn, float& tf) {
  const float widen = RT_F(1e-6);
  const float t0x = (lox - ox) * inv_dx;
  const float t0y = (loy - oy) * inv_dy;
  const float t0z = (loz - oz) * inv_dz;
  const float t1x = (hix - ox) * inv_dx;
  const float t1y = (hiy - oy) * inv_dy;
  const float t1z = (hiz - oz) * inv_dz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tn = tn - widen * fabsf(tn);
  tf = tf + widen * fabsf(tf);
}

// prim_test's triangle branch (kind 2, no motion) on a leaf-ordered row:
// the same arithmetic in the same association, the columns read as float4.
__device__ __forceinline__ void tri_test(const float* __restrict__ r,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float t_min, bool with_albedo,
                                         HitRec& h) {
  const float4 c4 = ldg4(r + 4), c8 = ldg4(r + 8), c12 = ldg4(r + 12);
  const float nxs = c4.x, nys = c4.y, nzs = c4.z;
  const float wax = c4.w, way = c8.x, waz = c8.y;
  const float wbx = c8.z, wby = c8.w, wbz = c12.x;
  const float qn = c12.y, qwa = c12.z, qwb = c12.w;
  const float den = dx * nxs + dy * nys + dz * nzs;
  const bool den_ok = fabsf(den) > RT_F(1e-8);
  const float den_safe = den_ok ? den : 1.0f;
  const float on = ox * nxs + oy * nys + oz * nzs;
  const float t_p = (qn - on) / den_safe;
  const float owa = ox * wax + oy * way + oz * waz;
  const float dwa = dx * wax + dy * way + dz * waz;
  const float owb = ox * wbx + oy * wby + oz * wbz;
  const float dwb = dx * wbx + dy * wby + dz * wbz;
  const float a = owa - qwa + t_p * dwa;
  const float b = owb - qwb + t_p * dwb;
  const float bound = a + b;
  const bool ok = den_ok && (a >= 0.0f) && (b >= 0.0f) && (bound <= 1.0f) &&
                  (t_p > t_min);
  // a missed row never wins (prim_test's rule on cand = inf)
  if (!ok || !(t_p <= h.t)) return;
  const float cand = t_p;
  const float4 c32 = ldg4(r + 32);  // cols 32-34 and the original index
  const float ci_f = c32.w;
  if (!(cand < h.t || ci_f < h.bi)) return;  // as near: the lower row wins
  const float4 c16 = ldg4(r + 16), c20 = ldg4(r + 20);
  h.t = cand;
  h.nx = nxs;
  h.ny = nys;
  h.nz = nzs;
  h.fr = den < 0.0f ? 1.0f : 0.0f;
  const float w0 = 1.0f - a - b;
  h.uu = w0 * c16.z + a * c20.x + b * c20.z;
  h.vv = w0 * c16.w + a * c20.y + b * c20.w;
  h.bi = ci_f;
  h.mat = c16.y;
  h.sph = 0.0f;
  if (with_albedo) {
    h.ar = ldg4(r + 28).w;
    h.ag = c32.x;
    h.ab = c32.y;
    h.prm = c32.z;
  }
}

template <bool kTriOnly, bool kCount>
__device__ __forceinline__ HitRec bvh_nearest(
    const Bvh& bvh, float ox, float oy, float oz, float dx, float dy,
    float dz, float tm, float t_min, bool has_motion, bool with_albedo,
    Visits* visits) {
  HitRec h = miss_record();
  const float inv_dx = 1.0f / safe_dir(dx);
  const float inv_dy = 1.0f / safe_dir(dy);
  const float inv_dz = 1.0f / safe_dir(dz);
  // the far children not yet walked: word << 3 | count, entry distance
  int st_w[kStack];
  float st_t[kStack];
  int sp = 0;
  int w = 0, n = 0;  // the current child: the root node
#pragma unroll 1
  while (true) {
    if (n > 0) {
      // a leaf: its rows are contiguous
      const float* r = bvh.rows + static_cast<long long>(w) * kCols;
#pragma unroll 1
      for (int k = 0; k < n; ++k, r += kCols) {
        if (kTriOnly)
          tri_test(r, ox, oy, oz, dx, dy, dz, t_min, with_albedo, h);
        else
          prim_test(LdgRow{r}, static_cast<int>(__ldg(r + kOrigCol)), ox,
                    oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, tm, t_min,
                    has_motion, with_albedo, h);
      }
      if (kCount) {
        visits->rows += n;
        if (visits->seen_rows != nullptr)
          for (int k = 0; k < n; ++k) visits->seen_rows[w + k] = 1;
      }
    } else {
      // an interior node: both children's boxes
      const float4* p = bvh.nodes + 4 * w;
      const float4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2),
                   q3 = __ldg(p + 3);
      float tn0, tf0, tn1, tf1;
      slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy, oz, inv_dx, inv_dy,
           inv_dz, tn0, tf0);
      slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ox, oy, oz, inv_dx, inv_dy,
           inv_dz, tn1, tf1);
      if (kCount) {
        visits->nodes += 2;
        if (visits->seen_nodes != nullptr) visits->seen_nodes[w] = 1;
      }
      const bool in0 = !((tn0 > tf0) || (tn0 > h.t) || (tf0 < t_min));
      const bool in1 = !((tn1 > tf1) || (tn1 > h.t) || (tf1 < t_min));
      // the right child first when it starts strictly nearer
      const bool swap = tn1 < tn0;
      const int wn = __float_as_int(swap ? q3.y : q3.x);
      const int nn = __float_as_int(swap ? q3.w : q3.z);
      const int wf = __float_as_int(swap ? q3.x : q3.y);
      const int nf = __float_as_int(swap ? q3.z : q3.w);
      const bool enter_near = swap ? in1 : in0;
      const bool enter_far = swap ? in0 : in1;
      if (enter_near) {
        if (enter_far) {
          st_w[sp] = (wf << 3) | nf;
          st_t[sp] = swap ? tn0 : tn1;
          ++sp;
        }
        w = wn;
        n = nn;
        continue;
      }
      if (enter_far) {
        w = wf;
        n = nf;
        continue;
      }
    }
    // the last pushed child that is still as near as the best hit
    bool found = false;
#pragma unroll 1
    while (sp > 0) {
      --sp;
      if (!(st_t[sp] > h.t)) {
        w = st_w[sp] >> 3;
        n = st_w[sp] & 7;
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  face_ray(h);
  return h;
}

}  // namespace rt
