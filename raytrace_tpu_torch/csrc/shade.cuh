// Material, texture, emission, scatter and MIS stage after the nearest hit:
// raytrace_tpu/ops/pallas/bounce_kernel.py:_shade_values for one lane.
// Plain version: ops/bounce_kernel.py:shade_values.
#pragma once

#include "common.cuh"
#include "prim_loop.cuh"

namespace rt {

// material kinds (materials/materials.py)
constexpr float kMatLight = 0.f, kMatPitchBlack = 1.f, kMatLambertian = 2.f,
                kMatLommel = 3.f, kMatMirror = 4.f, kMatMetal = 5.f,
                kMatDielectric = 6.f, kMatTransparent = 7.f,
                kMatAnisotropic = 9.f;
// texture kinds (textures/textures.py)
constexpr float kTexConstant = 0.f, kTexChecker = 1.f;

struct ShadeOut {
  float o[3], d[3], thr[3], em[3];
  float alive, miss, bi, uu, vv;
};

// a row of the sphere rotation table: the winner index it applies to (as
// a float, as the hit record holds it) and its world->object rotation,
// row-major
constexpr int kRotCols = 10;

// arctan on [0, 1], |err| ~ 1e-5 rad (the TPU kernel's polynomial)
__device__ __forceinline__ float poly_atan(float t) {
  const float z = t * t;
  return t * (RT_F(0.9998660) +
              z * (RT_F(-0.3302995) +
                   z * (RT_F(0.1801410) +
                        z * (RT_F(-0.0851330) + z * RT_F(0.0208351)))));
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = tmin(ax, ay) / clamp_min(tmax(ax, ay), RT_F(1e-30));
  float a = poly_atan(t);
  a = ay > ax ? RT_F(kPiD / 2) - a : a;
  a = x < 0.0f ? RT_F(kPiD) - a : a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float acos_poly(float x) {
  return atan2_poly(sqrtf(clamp_min(1.0f - x * x, 0.0f)), x);
}

__device__ __forceinline__ float rsqrt3(float x, float y, float z) {
  return 1.0f / sqrtf(clamp_min(x * x + y * y + z * z, RT_F(1e-30)));
}

__device__ __forceinline__ void unit_from_uniforms(float u, float v, float& x,
                                                   float& y, float& z) {
  z = 1.0f - 2.0f * u;
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = RT_F(2.0 * kPiD) * v;
  x = r * cosf(phi);
  y = r * sinf(phi);
}

// mtbl: [n_mats, 12] rows; ttbl: [n_targets, 16] rows; u: the 8 bounce
// uniforms (spec0, spec1, dielectric, dir0, dir1, choice, tgt_i, tgt_j);
// rots: [n_rots, kRotCols] sphere rotations, read only by lanes whose
// sphere flag is set (kernels A and B pass none).
__device__ __forceinline__ ShadeOut shade(
    const HitRec& hr, const float* __restrict__ mtbl, int n_mats,
    const float* __restrict__ ttbl, int n_targets, bool use_prim_albedo,
    float ox, float oy, float oz, float dx, float dy, float dz, float tr,
    float tg, float tb, bool alive, const float* u,
    const float* __restrict__ rots = nullptr, int n_rots = 0) {
  const float nx = hr.nx, ny = hr.ny, nz = hr.nz;
  const bool hit = hr.t < inf();
  const float t_safe = hit ? hr.t : 1.0f;
  const float px = ox + t_safe * dx;
  const float py = oy + t_safe * dy;
  const float pz = oz + t_safe * dz;
  const bool front = hr.fr > 0.5f;

  // sphere uv from the outward normal, turned into object space first
  // where the winner is a listed rotated sphere
  float uu = hr.uu, vv = hr.vv;
  if (hr.sph > 0.5f) {
    const float flip = front ? 1.0f : -1.0f;
    float owx = nx * flip, owy = ny * flip, owz = nz * flip;
    for (int k = 0; k < n_rots; ++k) {
      const float* r = rots + k * kRotCols;
      if (hr.bi == r[0]) {
        const float rx = r[1] * owx + r[2] * owy + r[3] * owz;
        const float ry = r[4] * owx + r[5] * owy + r[6] * owz;
        const float rz = r[7] * owx + r[8] * owy + r[9] * owz;
        owx = rx;
        owy = ry;
        owz = rz;
        break;
      }
    }
    uu = atan2_poly(owx, owz) * RT_F(0.5 / kPiD) + 0.5f;
    vv = acos_poly(clamp(-owy, -1.0f, 1.0f)) * RT_F(1.0 / kPiD);
  }

  // material + texture of the winner's material (behaviour) row
  float kind = 0.0f, param = 0.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
  const int mi = static_cast<int>(hr.mat);
  if (mi >= 0 && mi < n_mats && hr.mat == static_cast<float>(mi)) {
    const float* m = mtbl + mi * kMCols;
    kind = m[0];
    if (!use_prim_albedo) param = m[1];
    const float tex_kind = m[2];
    const bool even =
        fmodf(floorf(uu * m[9]) + floorf(vv * m[10]), 2.0f) == 0.0f;
    const bool use_c1 = tex_kind == kTexChecker && !even;
    float cr = use_c1 ? m[6] : m[3];
    float cg = use_c1 ? m[7] : m[4];
    float cb = use_c1 ? m[8] : m[5];
    if (use_prim_albedo) {
      const float cf = tex_kind == kTexConstant ? 1.0f : 0.0f;
      cr = cf * hr.ar + (1.0f - cf) * cr;
      cg = cf * hr.ag + (1.0f - cf) * cg;
      cb = cf * hr.ab + (1.0f - cf) * cb;
    }
    if (tex_kind != kTexConstant && tex_kind != kTexChecker) {
      cr = 1.0f;  // rich textures are deferred to the caller
      cg = 1.0f;
      cb = 1.0f;
    }
    ar = cr;
    ag = cg;
    ab = cb;
  }
  if (use_prim_albedo) param = hr.prm;

  const bool live_hit = alive && hit;
  ShadeOut out;

  // emission
  const float emit = (live_hit && kind == kMatLight) ? 1.0f : 0.0f;
  out.em[0] = tr * ar * emit;
  out.em[1] = tg * ag * emit;
  out.em[2] = tb * ab * emit;

  const bool is_absorb = kind == kMatLight || kind == kMatPitchBlack;
  const bool is_hemi = kind == kMatLambertian || kind == kMatLommel;
  const bool is_spec = kind == kMatMirror || kind == kMatMetal ||
                       kind == kMatDielectric || kind == kMatTransparent;

  // specular family
  const float ddn = dx * nx + dy * ny + dz * nz;
  const float rfx = dx - 2.0f * ddn * nx;
  const float rfy = dy - 2.0f * ddn * ny;
  const float rfz = dz - 2.0f * ddn * nz;
  float sx = dx, sy = dy, sz = dz;
  bool spec_dead = false;
  if (kind == kMatMirror) {
    sx = rfx;
    sy = rfy;
    sz = rfz;
  } else if (kind == kMatMetal) {
    float fx, fy, fz;
    unit_from_uniforms(u[0], u[1], fx, fy, fz);
    float mx = rfx + param * fx;
    float my = rfy + param * fy;
    float mz = rfz + param * fz;
    spec_dead = !((mx * nx + my * ny + mz * nz) > 0.0f);
    const float inv = rsqrt3(mx, my, mz);
    sx = mx * inv;
    sy = my * inv;
    sz = mz * inv;
  } else if (kind == kMatDielectric) {
    const float ior = clamp_min(param, RT_F(1e-6));
    const float ior_ratio = front ? 1.0f / ior : ior;
    const float cos_t = clamp_max(-ddn, 1.0f);
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = ior_ratio * sin_t > 1.0f;
    float r0 = (1.0f - ior_ratio) / (1.0f + ior_ratio);
    r0 = r0 * r0;
    const float one_c = 1.0f - cos_t;
    const float oc2 = one_c * one_c;
    const float schlick = r0 + (1.0f - r0) * (oc2 * oc2 * one_c);
    const bool di_reflect = cannot || (u[2] < schlick);
    const float qx = ior_ratio * (dx + cos_t * nx);
    const float qy = ior_ratio * (dy + cos_t * ny);
    const float qz = ior_ratio * (dz + cos_t * nz);
    const float par = sqrtf(
        clamp_min(fabsf(1.0f - (qx * qx + qy * qy + qz * qz)), RT_F(1e-12)));
    const float di_r = di_reflect ? 1.0f : 0.0f;
    sx = di_r * rfx + (1.0f - di_r) * (qx - par * nx);
    sy = di_r * rfy + (1.0f - di_r) * (qy - par * ny);
    sz = di_r * rfz + (1.0f - di_r) * (qz - par * nz);
  }
  const bool is_diel = kind == kMatDielectric;

  // diffuse family + redirection
  float ux, uy, uz;
  unit_from_uniforms(u[3], u[4], ux, uy, uz);
  const float cdx = nx + ux, cdy = ny + uy, cdz = nz + uz;
  const float inv_c = rsqrt3(cdx, cdy, cdz);
  const float hemi_f = is_hemi ? 1.0f : 0.0f;
  float bx = hemi_f * (cdx * inv_c) + (1.0f - hemi_f) * ux;
  float by = hemi_f * (cdy * inv_c) + (1.0f - hemi_f) * uy;
  float bz = hemi_f * (cdz * inv_c) + (1.0f - hemi_f) * uz;

  float cdf_last = 0.0f;
  if (n_targets > 0) {
    cdf_last = ttbl[(n_targets - 1) * kTCols + 13];
    const float x_t = u[5];
    // the first target with x < cdf
    float l[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int ti = 0; ti < n_targets; ++ti) {
      const float* tt = ttbl + ti * kTCols;
      if (x_t < tt[13]) {
        for (int k = 0; k < 9; ++k) l[k] = tt[k];
        break;
      }
    }
    const float tgx = l[0] + u[6] * l[3] + u[7] * l[6] - px;
    const float tgy = l[1] + u[6] * l[4] + u[7] * l[7] - py;
    const float tgz = l[2] + u[6] * l[5] + u[7] * l[8] - pz;
    const float inv_t = rsqrt3(tgx, tgy, tgz);
    const float use_f = x_t < cdf_last ? 1.0f : 0.0f;
    bx = use_f * (tgx * inv_t) + (1.0f - use_f) * bx;
    by = use_f * (tgy * inv_t) + (1.0f - use_f) * by;
    bz = use_f * (tgz * inv_t) + (1.0f - use_f) * bz;
  }

  const float mu1 = bx * nx + by * ny + bz * nz;
  const float pdf_base =
      is_hemi ? mu1 * RT_F(1.0 / kPiD) : RT_F(0.25 / kPiD);
  const bool hemi_dead = is_hemi && pdf_base <= 0.0f;

  float pdf_mix;
  if (n_targets > 0) {
    float pdf_sum = (1.0f - cdf_last) * pdf_base;
    for (int ti = 0; ti < n_targets; ++ti) {
      const float* tt = ttbl + ti * kTCols;
      const float cpx = tt[9], cpy = tt[10], cpz = tt[11];
      const float inv_cp =
          1.0f / tmax(cpx * cpx + cpy * cpy + cpz * cpz, RT_F(1e-30));
      const float s = sqrtf(inv_cp);
      const float nxs = cpx * s, nys = cpy * s, nzs = cpz * s;
      const float qn = tt[0] * nxs + tt[1] * nys + tt[2] * nzs;
      const float nsx = cpx * inv_cp, nsy = cpy * inv_cp, nsz = cpz * inv_cp;
      const float wax = tt[7] * nsz - tt[8] * nsy;
      const float way = tt[8] * nsx - tt[6] * nsz;
      const float waz = tt[6] * nsy - tt[7] * nsx;
      const float wbx = nsy * tt[5] - nsz * tt[4];
      const float wby = nsz * tt[3] - nsx * tt[5];
      const float wbz = nsx * tt[4] - nsy * tt[3];
      const float den = bx * nxs + by * nys + bz * nzs;
      const bool den_ok = fabsf(den) > RT_F(1e-8);
      const float den_s = den_ok ? den : 1.0f;
      const float tq = (qn - (px * nxs + py * nys + pz * nzs)) / den_s;
      const float rx = px + tq * bx - tt[0];
      const float ry = py + tq * by - tt[1];
      const float rz = pz + tq * bz - tt[2];
      const float aa = rx * wax + ry * way + rz * waz;
      const float bb = rx * wbx + ry * wby + rz * wbz;
      const bool hit_t = den_ok && tq > 0.0f && aa >= 0.0f && aa <= 1.0f &&
                         bb >= 0.0f && bb <= 1.0f;
      const float cross_dot = fabsf(bx * cpx + by * cpy + bz * cpz);
      const float pdf_i =
          hit_t ? tq * tq / clamp_min(cross_dot, RT_F(1e-12)) : 0.0f;
      pdf_sum = pdf_sum + tt[12] * pdf_i;
    }
    pdf_mix = clamp_min(pdf_sum, RT_F(1e-12));
  } else {
    pdf_mix = clamp_min(pdf_base, RT_F(1e-12));
  }

  float brdf = 1.0f;
  if (kind == kMatAnisotropic) {
    // Henyey-Greenstein: (1-g^2) / (1+g^2-2g mu)^1.5
    const float g = param;
    const float hg_mu = dx * bx + dy * by + dz * bz;
    const float hg_den = clamp_min(1.0f + g * g - 2.0f * g * hg_mu,
                                   RT_F(1e-12));
    brdf = (1.0f - g * g) / (hg_den * sqrtf(hg_den));
  } else if (kind == kMatLommel) {
    const float mu0 = -ddn;
    brdf = 0.25f / clamp_min(mu0 + mu1, RT_F(1e-8));
  }
  const float dw = brdf * pdf_base / pdf_mix;

  const float spec_f = is_spec ? 1.0f : 0.0f;
  const float ndx = spec_f * sx + (1.0f - spec_f) * bx;
  const float ndy = spec_f * sy + (1.0f - spec_f) * by;
  const float ndz = spec_f * sz + (1.0f - spec_f) * bz;
  const float w_r = is_spec ? (is_diel ? 1.0f : ar) : ar * dw;
  const float w_g = is_spec ? (is_diel ? 1.0f : ag) : ag * dw;
  const float w_b = is_spec ? (is_diel ? 1.0f : ab) : ab * dw;
  const bool next_alive = live_hit && !is_absorb && !spec_dead && !hemi_dead;

  out.o[0] = next_alive ? px : ox;
  out.o[1] = next_alive ? py : oy;
  out.o[2] = next_alive ? pz : oz;
  out.d[0] = next_alive ? ndx : dx;
  out.d[1] = next_alive ? ndy : dy;
  out.d[2] = next_alive ? ndz : dz;
  out.thr[0] = next_alive ? tr * w_r : tr;
  out.thr[1] = next_alive ? tg * w_g : tg;
  out.thr[2] = next_alive ? tb * w_b : tb;
  out.alive = next_alive ? 1.0f : 0.0f;
  out.miss = (alive && !hit) ? 1.0f : 0.0f;
  out.bi = hr.bi;
  out.uu = uu;
  out.vv = vv;
  return out;
}

}  // namespace rt
