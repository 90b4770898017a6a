// Nearest hit over the packed primitive table: the flat scan of
// raytrace_tpu/ops/pallas/intersect_kernel.py:_prim_loop_flat, one thread
// per ray.  Plain version: ops/intersect_kernel.py:prim_loop_plain.
//
// prim_test is the per-row test and record of one (ray, row) pair, shared
// by the flat scan below (rows in shared memory) and the BVH traversal of
// bvh_nearest.cuh (rows read from global memory), so both round alike.
// Each row runs only the branch of its kind and pad rows (kind -1) are
// skipped; the record of a candidate is built only when it beats the
// running best.  Ties go to the lowest row: a candidate wins if it is
// nearer, or as near and of a lower row.  The flat scan visits rows in
// order, so there the second clause never fires.
//
// planar_loop is the flat scan of a table whose rows are all unmoving
// parallelograms and triangles (kernel A's planar instantiation): it reads
// each row's columns 4-19 as four float4 from shared memory, runs only
// prim_test's planar branch, carries only (t, row) and builds the winner's
// record once, after the scan, by prim_test on that row (same association,
// so the same bits).
#pragma once

#include "common.cuh"

namespace rt {

struct HitRec {
  float t, bi, nx, ny, nz, fr, uu, vv, mat, sph;  // normal faces the ray
  float ar, ag, ab, prm;  // winner's per-prim albedo and param (cols 31-34)
};

// A row in shared (or any) memory (bvh_nearest.cuh reads its rows through
// the read-only data cache instead).
struct PtrRow {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const { return p[k]; }
};

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < RT_F(1e-20) ? (d < 0.0f ? RT_F(-1e-20) : RT_F(1e-20)) : d;
}

// Box record from the hit point (ops/intersect_kernel.py:_box_attrs).
__device__ __forceinline__ void box_attrs(
    float lox, float loy, float loz, float hix, float hiy, float hiz,
    float hx, float hy, float hz, float dx, float dy, float dz,
    float& nx, float& ny, float& nz, float& front, float& uu, float& vv) {
  const float szx = clamp_min(hix - lox, RT_F(1e-12));
  const float szy = clamp_min(hiy - loy, RT_F(1e-12));
  const float szz = clamp_min(hiz - loz, RT_F(1e-12));
  const float relx = (hx - 0.5f * (lox + hix)) / szx;
  const float rely = (hy - 0.5f * (loy + hiy)) / szy;
  const float relz = (hz - 0.5f * (loz + hiz)) / szz;
  const float ax = fabsf(relx), ay = fabsf(rely), az = fabsf(relz);
  const bool on_x = (ax >= ay) && (ax >= az);
  const bool on_y = !on_x && (ay >= az);
  const bool on_z = !on_x && !on_y;
  nx = on_x ? (relx >= 0.0f ? 1.0f : -1.0f) : 0.0f;
  ny = on_y ? (rely >= 0.0f ? 1.0f : -1.0f) : 0.0f;
  nz = on_z ? (relz >= 0.0f ? 1.0f : -1.0f) : 0.0f;
  front = (dx * nx + dy * ny + dz * nz < 0.0f) ? 1.0f : 0.0f;
  const float fx = (hx - lox) / szx;
  const float fy = (hy - loy) / szy;
  const float fz = (hz - loz) / szz;
  uu = on_z ? (relz >= 0.0f ? fx : 1.0f - fx)
            : (on_x ? (relx >= 0.0f ? 1.0f - fz : fz) : fx);
  vv = on_y ? (rely >= 0.0f ? 1.0f - fz : fz) : fy;
}

// The record of a ray that hits nothing (before the normal flip).
__device__ __forceinline__ HitRec miss_record() {
  HitRec h;
  h.t = inf();
  h.bi = -1.0f;
  h.nx = 0.0f; h.ny = 0.0f; h.nz = 1.0f;
  h.fr = 0.0f; h.uu = 0.0f; h.vv = 0.0f; h.mat = 0.0f; h.sph = 1.0f;
  h.ar = 0.0f; h.ag = 0.0f; h.ab = 0.0f; h.prm = 0.0f;
  return h;
}

// Test row ``ci`` (accessor ``row``) against ray (o, d) at time tm and
// take it into ``h`` if it wins.  inv_d* = 1 / safe_dir(d*).
template <class Row>
__device__ __forceinline__ void prim_test(
    const Row& row, int ci, float ox, float oy, float oz, float dx, float dy,
    float dz, float inv_dx, float inv_dy, float inv_dz, float tm,
    float t_min, bool has_motion, bool with_albedo, HitRec& h) {
  const float kind_f = row[16];
  if (!(kind_f == 0.0f || kind_f == 1.0f || kind_f == 2.0f ||
        kind_f == 3.0f))
    return;  // pad (and degenerate) rows are never hit
  const int kind = static_cast<int>(kind_f);
  const float ci_f = static_cast<float>(ci);
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
  if (kind == 0) {
    // sphere: two roots against the open interval
    const float r2 = row[3];
    const float ocx = px - ox, ocy = py - oy, ocz = pz - oz;
    const float hh = dx * ocx + dy * ocy + dz * ocz;
    const float cterm = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const float disc = hh * hh - cterm;
    const float sq = sqrtf(clamp_min(disc, 0.0f));
    const float r1 = hh - sq;
    const float rr2 = hh + sq;
    float cand = r1 > t_min ? r1 : (rr2 > t_min ? rr2 : inf());
    if (!(disc >= 0.0f)) cand = inf();
    if (!(cand < h.t || (cand == h.t && ci_f < h.bi))) return;
    const float inv_r =
        (1.0f / sqrtf(tmax(r2, RT_F(1e-30)))) * sgn(row[30]);
    h.t = cand;
    h.nx = (ox + cand * dx - px) * inv_r;
    h.ny = (oy + cand * dy - py) * inv_r;
    h.nz = (oz + cand * dz - pz) * inv_r;
    h.fr = cand <= hh ? 1.0f : 0.0f;
    h.uu = 0.0f;
    h.vv = 0.0f;
  } else if (kind == 3) {
    // axis-aligned box: slab test
    float hix = row[7], hiy = row[8], hiz = row[9];
    if (has_motion) {
      hix = hix + sx;
      hiy = hiy + sy;
      hiz = hiz + sz;
    }
    const float bx0 = (px - ox) * inv_dx, bx1 = (hix - ox) * inv_dx;
    const float by0 = (py - oy) * inv_dy, by1 = (hiy - oy) * inv_dy;
    const float bz0 = (pz - oz) * inv_dz, bz1 = (hiz - oz) * inv_dz;
    const float btn = tmax(tmax(tmin(bx0, bx1), tmin(by0, by1)),
                           tmin(bz0, bz1));
    const float btf = tmin(tmin(tmax(bx0, bx1), tmax(by0, by1)),
                           tmax(bz0, bz1));
    float cand = btn > t_min ? btn : (btf > t_min ? btf : inf());
    if (!(btn <= btf)) cand = inf();
    if (!(cand < h.t || (cand == h.t && ci_f < h.bi))) return;
    h.t = cand;
    box_attrs(px, py, pz, hix, hiy, hiz, ox + cand * dx, oy + cand * dy,
              oz + cand * dz, dx, dy, dz, h.nx, h.ny, h.nz, h.fr, h.uu,
              h.vv);
  } else {
    // parallelogram / triangle: scalar triple products
    const float nxs = row[4], nys = row[5], nzs = row[6];
    const float den = dx * nxs + dy * nys + dz * nzs;
    const bool den_ok = fabsf(den) > RT_F(1e-8);
    const float den_safe = den_ok ? den : 1.0f;
    const float on = ox * nxs + oy * nys + oz * nzs;
    float qn = row[13], qwa = row[14], qwb = row[15];
    const float wax = row[7], way = row[8], waz = row[9];
    const float wbx = row[10], wby = row[11], wbz = row[12];
    if (has_motion) {
      qn = qn + sx * nxs + sy * nys + sz * nzs;
      qwa = qwa + sx * wax + sy * way + sz * waz;
      qwb = qwb + sx * wbx + sy * wby + sz * wbz;
    }
    const float t_p = (qn - on) / den_safe;
    const float owa = ox * wax + oy * way + oz * waz;
    const float dwa = dx * wax + dy * way + dz * waz;
    const float owb = ox * wbx + oy * wby + oz * wbz;
    const float dwb = dx * wbx + dy * wby + dz * wbz;
    const float a = owa - qwa + t_p * dwa;
    const float b = owb - qwb + t_p * dwb;
    const float bound = kind == 2 ? a + b : tmax(a, b);
    const bool ok = den_ok && (a >= 0.0f) && (b >= 0.0f) &&
                    (bound <= 1.0f) && (t_p > t_min);
    const float cand = ok ? t_p : inf();
    if (!(cand < h.t || (cand == h.t && ci_f < h.bi))) return;
    h.t = cand;
    h.nx = nxs;
    h.ny = nys;
    h.nz = nzs;
    h.fr = den < 0.0f ? 1.0f : 0.0f;
    if (kind == 2) {
      const float w0 = 1.0f - a - b;
      h.uu = w0 * row[18] + a * row[20] + b * row[22];
      h.vv = w0 * row[19] + a * row[21] + b * row[23];
    } else {
      h.uu = a;
      h.vv = b;
    }
  }
  h.bi = ci_f;
  h.mat = row[17];
  h.sph = kind == 0 ? 1.0f : 0.0f;
  if (with_albedo) {
    h.ar = row[31];
    h.ag = row[32];
    h.ab = row[33];
    h.prm = row[34];
  }
}

// The normal faces the ray.
__device__ __forceinline__ void face_ray(HitRec& h) {
  const float flip = h.fr > 0.5f ? 1.0f : -1.0f;
  h.nx = h.nx * flip;
  h.ny = h.ny * flip;
  h.nz = h.nz * flip;
}

// prim_test's parallelogram / triangle candidate of an unmoving row
// (+inf where it misses), the columns read as float4 (the row must be
// 16-byte aligned: a table of 36-float rows at an aligned base).
__device__ __forceinline__ float planar_cand(const float* __restrict__ r,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_min) {
  const float4 c4 = *reinterpret_cast<const float4*>(r + 4);
  const float4 c8 = *reinterpret_cast<const float4*>(r + 8);
  const float4 c12 = *reinterpret_cast<const float4*>(r + 12);
  const float kind = r[16];
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
  // fmaxf, not the NaN-propagating tmax: a NaN a or b fails a >= 0 or
  // b >= 0 whatever the bound, so the test is prim_test's
  const float bound = kind == 2.0f ? a + b : fmaxf(a, b);
  const bool ok = den_ok && (a >= 0.0f) && (b >= 0.0f) && (bound <= 1.0f) &&
                  (t_p > t_min);
  return ok ? t_p : inf();
}

// The flat scan of rows [0, n_prims) of tbl, every one an unmoving
// parallelogram or triangle (kind 1 or 2); tbl 16-byte aligned.
__device__ __forceinline__ HitRec planar_loop(
    const float* __restrict__ tbl, int n_prims, float ox, float oy, float oz,
    float dx, float dy, float dz, float t_min, bool with_albedo) {
  float bt = inf();
  int bi = -1;
#pragma unroll 1
  for (int ci = 0; ci < n_prims; ++ci) {
    const float c = planar_cand(tbl + ci * kCols, ox, oy, oz, dx, dy, dz,
                                t_min);
    if (c < bt) {  // rows in order: a tie never goes to a later row
      bt = c;
      bi = ci;
    }
  }
  HitRec h = miss_record();
  if (bi >= 0) {
    const float inv = 1.0f;  // the planar branch reads no 1/d
    prim_test(PtrRow{tbl + bi * kCols}, bi, ox, oy, oz, dx, dy, dz, inv,
              inv, inv, 0.0f, t_min, false, with_albedo, h);
  }
  face_ray(h);
  return h;
}

// Scan rows [0, n_prims) of tbl (row-major [*, 36], usually in shared
// memory) for the nearest hit of ray (o, d) at time tm.
__device__ __forceinline__ HitRec prim_loop(
    const float* __restrict__ tbl, int n_prims, float ox, float oy, float oz,
    float dx, float dy, float dz, float tm, float t_min, bool has_motion,
    bool with_albedo) {
  HitRec h = miss_record();
  const float inv_dx = 1.0f / safe_dir(dx);
  const float inv_dy = 1.0f / safe_dir(dy);
  const float inv_dz = 1.0f / safe_dir(dz);
#pragma unroll 1
  for (int ci = 0; ci < n_prims; ++ci)
    prim_test(PtrRow{tbl + ci * kCols}, ci, ox, oy, oz, dx, dy, dz, inv_dx,
              inv_dy, inv_dz, tm, t_min, has_motion, with_albedo, h);
  face_ray(h);
  return h;
}

}  // namespace rt
