// Boundary crossings of a constant-density medium: the per-row candidates
// and the fold of raytrace_tpu/ops/pallas/volume_kernel.py (_volume_loop,
// _crossing_cand, _merge).  Plain version:
// ops/volume_kernel.py:volume_crossings_plain.
//
// A row gives up to two candidates: a sphere's or box's near root (it
// enters: front 1) and far root (it exits), or a parallelogram's or
// triangle's one root (front iff the ray meets it from the normal side).
// Candidates are strictly beyond t_min; the others are +inf.  The nearest
// hit of prim_loop.cuh keeps one root of a row; here both count, so the
// crossing scan has its own candidate function over the same row layout
// (ops/intersect_kernel.py:pack_prims) and the same association.
//
// The keyed mode (the differentiable media path's) also carries, for b1
// and b2, the key 2 * row + slot of the candidate each came from (row in
// the packed boundary table; slot 0 the entering or planar root, 1 the
// exit root), the lowest key on a tie; its backward recomputes that root
// alone (render/volumes.py:DiffCrossings).  merge's keyed overload folds
// in row order (K11), where keys rise with the order;
// bvh_crossings.cuh:fold_keyed in any order (K11b).
//
// planar_crossing is crossing_cand's parallelogram / triangle branch for
// tables of unmoving planar rows (K11's planar instantiation), and
// medium_candidate / fold_medium the candidate mode's epilogue shared by
// K11 and K11b: render/volumes.py:candidate_from_crossings and the strict-<
// fold of the media in medium order.
#pragma once

#include "common.cuh"

namespace rt {

// The carried (first crossing, its front flag, strictly second crossing).
struct Crossings {
  float b1, f1, b2;
};

__device__ __forceinline__ Crossings no_crossings() {
  return Crossings{inf(), 0.0f, inf()};
}

// The triple with the keys of the candidates b1 and b2 came from.
struct KeyedCrossings {
  float b1, f1, b2;
  int k1, k2;
};

__device__ __forceinline__ KeyedCrossings no_keyed_crossings() {
  return KeyedCrossings{inf(), 0.0f, inf(), 0x7fffffff, 0x7fffffff};
}

__device__ __forceinline__ Crossings unkeyed(const KeyedCrossings& s) {
  return Crossings{s.b1, s.f1, s.b2};
}

// Fold candidate (c, cf) into the triple (_merge): the strict < keeps an
// earlier candidate's flag on a tie; the second crossing is the smallest
// value strictly beyond the new first.  _merge's form, b1' = min(b1, c),
// b2' = the least of b1, b2, c strictly beyond b1', reduces to the
// branches below because a candidate is never NaN (a root strictly above
// t_min, or +inf) and b2 is +inf or strictly beyond b1: c < b1 gives
// (c, b1); c == b1 changes nothing; c > b1 gives (b1, min(b2, c)).
__device__ __forceinline__ void merge(Crossings& s, float c, float cf) {
  if (c < s.b1) {
    s.b2 = s.b1;
    s.b1 = c;
    s.f1 = cf;
  } else if (c > s.b1 && c < s.b2) {
    s.b2 = c;
  }
}

// merge with the keys, in row order: a key is never below an earlier
// candidate's, so a tie keeps the earlier (lower) key as it keeps the flag.
__device__ __forceinline__ void merge(KeyedCrossings& s, float c, float cf,
                                      int key) {
  if (c < s.b1) {
    s.b2 = s.b1;
    s.k2 = s.k1;
    s.b1 = c;
    s.f1 = cf;
    s.k1 = key;
  } else if (c > s.b1 && c < s.b2) {
    s.b2 = c;
    s.k2 = key;
  }
}

// Fold (c, cf) of key ``key`` into s: merge for Crossings, with the key
// for KeyedCrossings.
__device__ __forceinline__ void fold(Crossings& s, float c, float cf, int) {
  merge(s, c, cf);
}
__device__ __forceinline__ void fold(KeyedCrossings& s, float c, float cf,
                                     int key) {
  merge(s, c, cf, key);
}

// Candidates of row ``row`` for ray (o, d) at time tm; inv_d* = 1 /
// safe_dir(d*) (prim_loop.cuh).  Rows of kind -1 (pad, degenerate) give
// none.  Box rows are read only when the table has any (has_box).
template <class Row>
__device__ __forceinline__ void crossing_cand(
    const Row& row, float ox, float oy, float oz, float dx, float dy,
    float dz, float inv_dx, float inv_dy, float inv_dz, float tm,
    float t_min, bool has_motion, bool has_box, float& c1, float& cf1,
    float& c2) {
  c1 = inf();
  cf1 = 0.0f;
  c2 = inf();
  const float kind = row[16];
  float px = row[0], py = row[1], pz = row[2];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (has_motion) {
    sx = row[24] + tm * row[27];
    sy = row[25] + tm * row[28];
    sz = row[26] + tm * row[29];
    px = px + sx;
    py = py + sy;
    pz = pz + sz;
  }
  if (kind == 0.0f) {
    // sphere: both roots
    const float ocx = px - ox, ocy = py - oy, ocz = pz - oz;
    const float h = ocx * dx + ocy * dy + ocz * dz;
    const float disc = h * h - (ocx * ocx + ocy * ocy + ocz * ocz - row[3]);
    const float sq = sqrtf(clamp_min(disc, 0.0f));
    const bool ok = disc >= 0.0f;
    const float s1 = h - sq;
    const float s2 = h + sq;
    c1 = ok && s1 > t_min ? s1 : inf();
    cf1 = 1.0f;
    c2 = ok && s2 > t_min ? s2 : inf();
  } else if (kind == 1.0f || kind == 2.0f) {
    // parallelogram / triangle: one root inside the edges
    const float nx = row[4], ny = row[5], nz = row[6];
    const float wax = row[7], way = row[8], waz = row[9];
    const float wbx = row[10], wby = row[11], wbz = row[12];
    float qn = row[13], qwa = row[14], qwb = row[15];
    if (has_motion) {
      qn = qn + sx * nx + sy * ny + sz * nz;
      qwa = qwa + sx * wax + sy * way + sz * waz;
      qwb = qwb + sx * wbx + sy * wby + sz * wbz;
    }
    const float den = nx * dx + ny * dy + nz * dz;
    const bool den_ok = fabsf(den) > RT_F(1e-8);
    const float t_p = (qn - (nx * ox + ny * oy + nz * oz)) /
                      (den_ok ? den : 1.0f);
    const float a = (wax * ox + way * oy + waz * oz) - qwa +
                    t_p * (wax * dx + way * dy + waz * dz);
    const float b = (wbx * ox + wby * oy + wbz * oz) - qwb +
                    t_p * (wbx * dx + wby * dy + wbz * dz);
    const float bound = kind == 2.0f ? a + b : tmax(a, b);
    const bool ok = den_ok && a >= 0.0f && b >= 0.0f && bound <= 1.0f;
    c1 = ok && t_p > t_min ? t_p : inf();
    cf1 = den < 0.0f ? 1.0f : 0.0f;
  } else if (has_box && kind == 3.0f) {
    // axis-aligned box: slab roots, the entry enters and the exit exits
    float hix = row[7], hiy = row[8], hiz = row[9];
    if (has_motion) {
      hix = hix + sx;
      hiy = hiy + sy;
      hiz = hiz + sz;
    }
    const float t0x = (px - ox) * inv_dx, t1x = (hix - ox) * inv_dx;
    const float t0y = (py - oy) * inv_dy, t1y = (hiy - oy) * inv_dy;
    const float t0z = (pz - oz) * inv_dz, t1z = (hiz - oz) * inv_dz;
    const float tn = tmax(tmax(tmin(t0x, t1x), tmin(t0y, t1y)),
                          tmin(t0z, t1z));
    const float tf = tmin(tmin(tmax(t0x, t1x), tmax(t0y, t1y)),
                          tmax(t0z, t1z));
    const bool ok = tn <= tf;
    c1 = ok && tn > t_min ? tn : inf();
    cf1 = 1.0f;
    c2 = ok && tf > t_min ? tf : inf();
  }
}

// Fold row ``row`` (keys 2 * row_index + slot) into the triple: its
// entering (or planar) root first, then its exit root.
template <class Row, class S>
__device__ __forceinline__ void cross_row(
    const Row& row, int key, float ox, float oy, float oz, float dx,
    float dy, float dz, float inv_dx, float inv_dy, float inv_dz, float tm,
    float t_min, bool has_motion, bool has_box, S& s) {
  float c1, cf1, c2;
  crossing_cand(row, ox, oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, tm,
                t_min, has_motion, has_box, c1, cf1, c2);
  fold(s, c1, cf1, key);
  fold(s, c2, 0.0f, key + 1);
}

// crossing_cand's parallelogram / triangle branch of an unmoving row, in
// its association, the columns 4-15 read as float4 (the row 16-byte
// aligned): the root (+inf where it misses) and its front flag.  A planar
// row has no exit root, and folding +inf changes no triple (b2 is +inf or
// beyond b1), so such a row folds this candidate alone.
__device__ __forceinline__ float planar_crossing(const float* __restrict__ r,
                                                 float ox, float oy, float oz,
                                                 float dx, float dy, float dz,
                                                 float t_min, float& front) {
  const float4 c4 = *reinterpret_cast<const float4*>(r + 4);
  const float4 c8 = *reinterpret_cast<const float4*>(r + 8);
  const float4 c12 = *reinterpret_cast<const float4*>(r + 12);
  const float kind = r[16];
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
  // fmaxf, not the NaN-propagating tmax: a NaN a or b fails a >= 0 or
  // b >= 0 whatever the bound, so the test is crossing_cand's
  const float bound = kind == 2.0f ? a + b : fmaxf(a, b);
  const bool ok = den_ok && a >= 0.0f && b >= 0.0f && bound <= 1.0f;
  front = den < 0.0f ? 1.0f : 0.0f;
  return ok && t_p > t_min ? t_p : inf();
}

// The scatter candidate of a medium of ``density`` from its crossings and
// the draw u (+inf where the ray does not scatter): the entry is the
// first crossing if it enters, else t_min; the exit the next crossing;
// the flight -(1/density) * log(u), which is what torch's -1.0 / density
// computes (the reciprocal, times -1); a draw of 0 never scatters.
__device__ __forceinline__ float medium_candidate(const Crossings& s,
                                                  float t_min, float density,
                                                  float u) {
  const bool front = s.f1 > 0.5f;
  const float entry = front ? s.b1 : t_min;
  const float exit_t = front ? s.b2 : s.b1;
  // no crossing is NaN, so "finite" is "below +inf"
  const bool has_segment = s.b1 < inf() && exit_t < inf();
  const float dist_in = exit_t - entry;
  const float neg_inv_density = -(1.0f / density);
  const float hit_dist = u > 0.0f ? neg_inv_density * logf(u) : inf();
  const bool scatter = has_segment && hit_dist < dist_in;
  return scatter ? entry + hit_dist : inf();
}

// Keep the nearer of the carried (t_med, vmat) and medium candidate t of
// material mat: a strict <, so the earlier medium wins a tie.
__device__ __forceinline__ void fold_medium(float& t_med, float& vmat,
                                            float t, float mat) {
  if (t < t_med) {
    t_med = t;
    vmat = mat;
  }
}

}  // namespace rt
