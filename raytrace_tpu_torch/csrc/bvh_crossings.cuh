// The boundary crossings of one ray with one medium by a near-child-first
// walk of the medium's binned-SAH tree (kernel K11b).  The Hopper form of
// raytrace_tpu/ops/pallas/volume_kernel.py:pallas_volume_crossings_bcast,
// whose 256-row chunks against a row of rays, each skipped when no ray of
// the row reaches its box before its second crossing, keep a TPU's vector
// unit busy; on the card each thread walks its own ray.  Plain version:
// ops/volume_kernel.py:volume_crossings_plain.
//
// Layout (ops/volume_kernel.py:pack_volume_bvh): one tree per medium in
// bvh_nearest.cuh's two-box node format, all in one node array whose
// interior words are global node indices, over a leaf-ordered copy of the
// boundary rows whose column kOrigCol holds each row's index in the
// packed boundary table.
//
// The walk tests both children of a node and drops a child whose widened
// slab interval, clipped to [t_min, b2], is empty: the chunk test of the
// TPU kernel, applied per node.  A row whose roots all lie beyond the
// second crossing b2 changes neither crossing nor the front flag, and b2
// only falls, so culling never changes the result.  It enters the nearer
// child and pushes the farther; a popped entry whose entry distance is
// beyond b2 is dropped unread.
//
// The fold is independent of the visiting order.  The row-order fold
// (volume.cuh:merge, rows in table order, a row's entering root before its
// exit root, strict <) gives b1 = the least candidate, b2 = the least
// candidate strictly beyond b1 -- both independent of the order -- and
// the front flag of the first candidate in that order equal to a finite
// b1.  So the walk carries the key 2 * row + slot of b1 (slot 0: the
// entering or planar root, 1: the exit root) and a candidate equal to b1
// takes the flag only with a lower key; a candidate of +inf never takes
// it (a ray without crossings keeps front 0).  The keyed mode's b2 takes
// the lowest key the same way (the row-order fold's first attainment).
// Folding a candidate twice
// changes nothing, so a root whose two children are one leaf (a medium of
// at most LEAF_SIZE rows) is still right; its rows are walked once.
//
// kTriOnly: every boundary row is an unmoving triangle (mesh media such as
// the pawn), so each row runs only crossing_cand's triangle branch, in the
// same association, reading the columns it needs as float4; a triangle
// has no exit root.  Measured 35% faster than crossing_cand on the pawn's
// camera rays on an H100 (PERF.md section 6).  Other tables run
// crossing_cand.
#pragma once

#include "bvh_nearest.cuh"
#include "common.cuh"
#include "volume.cuh"

namespace rt {

// Fold candidate (c, cf) of key ``key`` in any order: b1 and b2 keep the
// lowest key of the candidates equal to them, and the flag of b1's.
__device__ __forceinline__ void fold_keyed(KeyedCrossings& s, float c,
                                           float cf, int key) {
  if (c < s.b1) {
    s.b2 = s.b1;  // every earlier candidate is >= the old b1
    s.k2 = s.k1;
    s.b1 = c;
    s.f1 = cf;
    s.k1 = key;
  } else if (c == s.b1) {
    if (c < inf() && key < s.k1) {
      s.f1 = cf;
      s.k1 = key;
    }
  } else if (c < s.b2) {
    s.b2 = c;
    s.k2 = key;
  } else if (c == s.b2) {
    if (c < inf() && key < s.k2) s.k2 = key;
  }
}

// crossing_cand's triangle branch (kind 2, no motion) on a leaf-ordered
// row, 16-byte aligned: the candidate (+inf where it misses) and its front
// flag.
__device__ __forceinline__ float tri_crossing(const float* __restrict__ r,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float t_min, float& front) {
  const float4 c4 = ldg4(r + 4), c8 = ldg4(r + 8), c12 = ldg4(r + 12);
  const float nx = c4.x, ny = c4.y, nz = c4.z;
  const float wax = c4.w, way = c8.x, waz = c8.y;
  const float wbx = c8.z, wby = c8.w, wbz = c12.x;
  const float qn = c12.y, qwa = c12.z, qwb = c12.w;
  const float den = nx * dx + ny * dy + nz * dz;
  const bool den_ok = fabsf(den) > RT_F(1e-8);
  const float t_p = (qn - (nx * ox + ny * oy + nz * oz)) /
                    (den_ok ? den : 1.0f);
  const float a = (wax * ox + way * oy + waz * oz) - qwa +
                  t_p * (wax * dx + way * dy + waz * dz);
  const float b = (wbx * ox + wby * oy + wbz * oz) - qwb +
                  t_p * (wbx * dx + wby * dy + wbz * dz);
  const bool ok = den_ok && a >= 0.0f && b >= 0.0f && a + b <= 1.0f;
  front = den < 0.0f ? 1.0f : 0.0f;
  return ok && t_p > t_min ? t_p : inf();
}

template <bool kTriOnly, bool kCount>
__device__ __forceinline__ KeyedCrossings bvh_crossings(
    const Bvh& bvh, int root, float ox, float oy, float oz, float dx,
    float dy, float dz, float inv_dx, float inv_dy, float inv_dz, float tm,
    float t_min, bool has_motion, bool has_box, Visits* visits) {
  KeyedCrossings s = no_keyed_crossings();
  // the far children not yet walked: word << 3 | count, entry distance
  int st_w[kStack];
  float st_t[kStack];
  int sp = 0;
  int w = root, n = 0;  // the current child: the medium's root node
#pragma unroll 1
  while (true) {
    if (n > 0) {
      // a leaf: its rows are contiguous
      const float* r = bvh.rows + static_cast<long long>(w) * kCols;
#pragma unroll 1
      for (int k = 0; k < n; ++k, r += kCols) {
        const int row = static_cast<int>(__ldg(r + kOrigCol));
        float c1, cf1, c2;
        if (kTriOnly) {
          c1 = tri_crossing(r, ox, oy, oz, dx, dy, dz, t_min, cf1);
        } else {
          crossing_cand(LdgRow{r}, ox, oy, oz, dx, dy, dz, inv_dx, inv_dy,
                        inv_dz, tm, t_min, has_motion, has_box, c1, cf1,
                        c2);
        }
        fold_keyed(s, c1, cf1, 2 * row);
        if (!kTriOnly) fold_keyed(s, c2, 0.0f, 2 * row + 1);
      }
      if (kCount) visits->rows += n;
    } else {
      // an interior node: both children's boxes against [t_min, b2]
      const float4* p = bvh.nodes + 4 * w;
      const float4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2),
                   q3 = __ldg(p + 3);
      float tn0, tf0, tn1, tf1;
      slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy, oz, inv_dx, inv_dy,
           inv_dz, tn0, tf0);
      slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ox, oy, oz, inv_dx, inv_dy,
           inv_dz, tn1, tf1);
      if (kCount) visits->nodes += 2;
      const bool in0 = !((tn0 > tf0) || (tn0 > s.b2) || (tf0 < t_min));
      const bool in1 = !((tn1 > tf1) || (tn1 > s.b2) || (tf1 < t_min));
      // the right child first when it starts strictly nearer
      const bool swap = tn1 < tn0;
      const int wn = __float_as_int(swap ? q3.y : q3.x);
      const int nn = __float_as_int(swap ? q3.w : q3.z);
      const int wf = __float_as_int(swap ? q3.x : q3.y);
      const int nf = __float_as_int(swap ? q3.z : q3.w);
      const bool enter_near = swap ? in1 : in0;
      // a root whose two children are one leaf is walked once
      const bool enter_far = (swap ? in0 : in1) && !(wf == wn && nf == nn);
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
    // the last pushed child that still starts before b2
    bool found = false;
#pragma unroll 1
    while (sp > 0) {
      --sp;
      if (!(st_t[sp] > s.b2)) {
        w = st_w[sp] >> 3;
        n = st_w[sp] & 7;
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  return s;
}

}  // namespace rt
