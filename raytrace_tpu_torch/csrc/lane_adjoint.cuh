// Hand-derived adjoint of one bounce from a known winner row: the reverse
// of raytrace_tpu_torch/diff/lane_replay.py:lane_math (the JAX package's
// diff/lane_replay.py:lane_math), for one lane.
//
// The TPU kernels get this adjoint through jax.vjp; CUDA has no
// autodiff, so the function below recomputes lane_math's forward in
// registers and runs its reverse sweep by hand.  It follows JAX's (and
// torch's) rules, not textbook calculus:
//   * where(c, a, b) sends the cotangent only to the taken branch: the code
//     branches on c and never multiplies a mask into a gradient that may be
//     infinite;
//   * maximum/minimum split the cotangent half and half on a tie (dmax,
//     dmin, dsel);
//   * abs'(0) = 0;
//   * the sampled direction b and the MIS mixture pdf are detached; the
//     surface (u, v) only picks a checker cell (floor: zero gradient).
// The forward keeps lane_math's association (the build uses --fmad=false),
// so every branch decision equals the plain version's on the card; the
// gradients sum the chain-rule terms in another order than torch autograd.
// Used by bounce_bwd_kernel.cu (K5); the unfused backward kernels (K6, K7)
// are to reuse it.
#pragma once

#include "common.cuh"
#include "shade.cuh"

namespace rt {

constexpr float kPrimSphere = 0.f, kPrimPar = 1.f, kPrimTri = 2.f,
                kPrimBox = 3.f;

// Float32 constants of one redirect target (lane_replay.py:target_consts).
struct LaneTarget {
  float cdf, prob, q[3], u[3], v[3], cp[3], nt[3], qn, wa[3], wb[3];
};

// From a packed target row (q u v cross prob cdf) and the running CDF.
__device__ __forceinline__ void target_consts(const float* row, float& acc,
                                              LaneTarget& t) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.q[k] = row[k];
    t.u[k] = row[3 + k];
    t.v[k] = row[6 + k];
  }
  t.prob = row[12];
  acc = acc + t.prob;
  t.cdf = acc;
  t.cp[0] = t.u[1] * t.v[2] - t.u[2] * t.v[1];
  t.cp[1] = t.u[2] * t.v[0] - t.u[0] * t.v[2];
  t.cp[2] = t.u[0] * t.v[1] - t.u[1] * t.v[0];
  const float cp2 = tmax(t.cp[0] * t.cp[0] + t.cp[1] * t.cp[1] +
                             t.cp[2] * t.cp[2],
                         RT_F(1e-30));
  const float inv = 1.0f / sqrtf(cp2);
  float ns[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.nt[k] = t.cp[k] * inv;
    ns[k] = t.cp[k] / cp2;
  }
  t.qn = t.q[0] * t.nt[0] + t.q[1] * t.nt[1] + t.q[2] * t.nt[2];
  t.wa[0] = t.v[1] * ns[2] - t.v[2] * ns[1];
  t.wa[1] = t.v[2] * ns[0] - t.v[0] * ns[2];
  t.wa[2] = t.v[0] * ns[1] - t.v[1] * ns[0];
  t.wb[0] = ns[1] * t.u[2] - ns[2] * t.u[1];
  t.wb[1] = ns[2] * t.u[0] - ns[0] * t.u[2];
  t.wb[2] = ns[0] * t.u[1] - ns[1] * t.u[0];
}

// lane_math's differentiable inputs; with has_motion false mv0/mv1 are
// unused.  The gradient has the same layout.
struct LaneIn {
  float p0[3], e1[3], e2[3], mv0[3], mv1[3], c0[3], c1[3], param;
  float o[3], d[3], time, thr[3];
};
// The detached inputs: winner prim kind, material kind, texture kind,
// checker counts, triangle corner uvs, the 8 bounce uniforms.
struct LaneDet {
  float kind_p, kind_m, texkind, f0, f1, uv[6], u[kNU];
  bool alive, idxv;
};
// Cotangents of the outputs o2, d2, emitted radiance, thr2.
struct LaneCt {
  float o2[3], d2[3], rad[3], thr2[3];
};

// d max(x, c) / dx times g (c a constant), and the same for min.
__device__ __forceinline__ float dmax(float x, float c, float g) {
  return x > c ? g : (x == c ? 0.5f * g : 0.0f);
}
__device__ __forceinline__ float dmin(float x, float c, float g) {
  return x < c ? g : (x == c ? 0.5f * g : 0.0f);
}
// The share of g that max(a, b) (min(a, b) with is_max false) sends to a.
__device__ __forceinline__ float dsel(float a, float b, float g,
                                      bool is_max) {
  const bool wins = is_max ? a > b : a < b;
  return wins ? g : (a == b ? 0.5f * g : 0.0f);
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Runs lane_math forward and back: writes into g the gradient of
// <ct, outputs> with respect to x, and returns the miss flag (1 for an
// alive lane whose winner is not hit), which the caller's background term
// needs.
__device__ __forceinline__ float lane_math_adjoint(
    const LaneIn& x, const LaneDet& det, const LaneTarget* tg, int n_targets,
    bool has_motion, bool has_box, float t_min, const LaneCt& ct,
    LaneIn& g) {
  const float INF = inf();
  const float* d = x.d;
  const float* p0 = x.p0;
  const float* e1 = x.e1;
  const float* e2 = x.e2;

  // ================= forward =================
  float os[3];
  const float mt = 1.0f - x.time;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    os[k] = has_motion ? x.o[k] - (x.mv0[k] * mt + x.time * x.mv1[k])
                       : x.o[k];
  }
  const bool is_sphere = det.kind_p == kPrimSphere;
  const bool is_par = det.kind_p == kPrimPar;
  const bool is_tri = det.kind_p == kPrimTri;
  const bool is_box = has_box && det.kind_p == kPrimBox;

  // sphere roots
  float oc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) oc[k] = p0[k] - os[k];
  const float h = dot(d, oc);
  const float cc = dot(oc, oc) - e1[0] * e1[0];
  const float disc = h * h - cc;
  const bool disc_ge = disc >= 0.0f;
  const float sq = sqrtf(disc_ge ? tmax(disc, RT_F(1e-20)) : 1.0f);
  const float s_r1 = h - sq;
  const float s_r2 = h + sq;

  // plane roots
  float cp[3];
  cross(e1, e2, cp);
  const float cp_sq_raw = dot(cp, cp);
  const bool degen = cp_sq_raw < RT_F(1e-24);
  if (degen) {
    cp[0] = 0.0f;
    cp[1] = 0.0f;
    cp[2] = 1.0f;
  }
  const float cp_sq = degen ? 1.0f : cp_sq_raw;
  const float s_cp = sqrtf(cp_sq);
  const float inv_cp = 1.0f / s_cp;
  float nu[3], ns[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    nu[k] = cp[k] * inv_cp;
    ns[k] = cp[k] / cp_sq;
  }
  const float denom = dot(nu, d);
  const bool denom_ok = fabsf(denom) > RT_F(1e-8);
  const float num = dot(nu, oc);
  const float t_plane = num / (denom_ok ? denom : 1.0f);
  float pr[3], c1[3], c2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pr[k] = (os[k] + t_plane * d[k]) - p0[k];
  cross(pr, e2, c1);
  cross(e1, pr, c2);
  const float a = dot(ns, c1);
  const float b = dot(ns, c2);
  const bool member =
      is_par ? (0.0f <= a && a <= 1.0f && 0.0f <= b && b <= 1.0f)
             : (a >= 0.0f && b >= 0.0f && a + b <= 1.0f);
  const bool plane_ok = denom_ok && !degen && member;

  // the two roots and where each comes from: 1 sphere near, 2 sphere far,
  // 3 plane, 4 box entry, 5 box exit, 0 none
  float r1, r2;
  int src1, src2;
  if (is_sphere) {
    r1 = disc_ge ? s_r1 : INF;
    src1 = disc_ge ? 1 : 0;
  } else {
    r1 = plane_ok ? t_plane : INF;
    src1 = plane_ok ? 3 : 0;
  }
  r2 = (is_sphere && disc_ge) ? s_r2 : INF;
  src2 = (is_sphere && disc_ge) ? 2 : 0;
  // slab test (p0 = lo, e1 = hi): tn = max over axes of min(t0, t1)
  float bt0[3], bt1[3], bsf[3], tn_in[3], tf_in[3], bmn[3], bmx[3];
  bool bsmall[3];
  if (is_box) {
    float tn = -INF, tf = INF;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bsmall[c] = fabsf(d[c]) < RT_F(1e-20);
      bsf[c] = bsmall[c] ? (d[c] < 0.0f ? RT_F(-1e-20) : RT_F(1e-20)) : d[c];
      bt0[c] = (p0[c] - os[c]) / bsf[c];
      bt1[c] = (e1[c] - os[c]) / bsf[c];
      bmn[c] = tmin(bt0[c], bt1[c]);
      bmx[c] = tmax(bt0[c], bt1[c]);
      tn_in[c] = tn;
      tf_in[c] = tf;
      tn = tmax(tn, bmn[c]);
      tf = tmin(tf, bmx[c]);
    }
    if (tn <= tf) {
      r1 = tn;
      src1 = 4;
      r2 = tf;
      src2 = 5;
    }
  }
  const bool ok1 = t_min < r1 && r1 < INF;
  const bool ok2 = t_min < r2 && r2 < INF;
  const float t_roots = ok1 ? r1 : (ok2 ? r2 : INF);
  const int src = ok1 ? src1 : (ok2 ? src2 : 0);
  const bool valid = det.idxv && t_roots < INF;
  const float t_safe = valid ? t_roots : 1.0f;
  float p[3], r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = x.o[k] + t_safe * d[k];
    r[k] = (os[k] + t_safe * d[k]) - p0[k];
  }

  // hit record: the normal faces the ray
  const bool radius_ok = fabsf(e1[0]) > 0.0f;
  const float radius = radius_ok ? e1[0] : 1.0f;
  const float inv_r = 1.0f / radius;
  float ow[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ow[k] = r[k] * inv_r;
  const bool s_front = dot(d, ow) <= 0.0f;
  const float sgn_s = s_front ? 1.0f : -1.0f;
  const bool p_front = denom < 0.0f;
  const float sgn_p = p_front ? 1.0f : -1.0f;
  float n[3];
  bool front;
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = is_sphere ? ow[k] * sgn_s : nu[k] * sgn_p;
  front = is_sphere ? s_front : p_front;
  float box_u = 0.0f, box_v = 0.0f;
  if (is_box) {
    float sz[3], rel[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sz[k] = tmax(e1[k] - p0[k], RT_F(1e-12));
      rel[k] = r[k] / sz[k] - 0.5f;
    }
    const bool ax_x = fabsf(rel[0]) >= fabsf(rel[1]) &&
                      fabsf(rel[0]) >= fabsf(rel[2]);
    const bool ax_y = !ax_x && fabsf(rel[1]) >= fabsf(rel[2]);
    const bool ax_z = !ax_x && !ax_y;
    const float sg[3] = {rel[0] >= 0.0f ? 1.0f : -1.0f,
                         rel[1] >= 0.0f ? 1.0f : -1.0f,
                         rel[2] >= 0.0f ? 1.0f : -1.0f};
    const float bow[3] = {ax_x ? sg[0] : 0.0f, ax_y ? sg[1] : 0.0f,
                          ax_z ? sg[2] : 0.0f};
    const bool b_front = dot(d, bow) < 0.0f;
    const float sgn_b = b_front ? 1.0f : -1.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = bow[k] * sgn_b;
    front = b_front;
    const float fx = r[0] / sz[0], fy = r[1] / sz[1], fz = r[2] / sz[2];
    box_u = ax_z ? (sg[2] > 0.0f ? fx : 1.0f - fx)
                 : (ax_x ? (sg[0] > 0.0f ? 1.0f - fz : fz) : fx);
    box_v = ax_y ? (sg[1] > 0.0f ? 1.0f - fz : fz) : fy;
  }

  // texture: the checker cell of the surface (u, v) picks c0 or c1
  bool use_c1 = false;
  if (det.texkind == kTexChecker) {
    float uu, vv;
    if (is_box) {
      uu = box_u;
      vv = box_v;
    } else if (is_sphere) {
      const bool xz_ok = ow[0] * ow[0] + ow[2] * ow[2] > RT_F(1e-12);
      uu = atan2_poly(xz_ok ? ow[0] : 0.0f, xz_ok ? ow[2] : 1.0f) *
               RT_F(0.5 / kPiD) +
           0.5f;
      vv = acos_poly(clamp(-ow[1], RT_F(-1.0 + 1e-6), RT_F(1.0 - 1e-6))) *
           RT_F(1.0 / kPiD);
    } else {
      float c1r[3], c2r[3];
      cross(r, e2, c1r);
      cross(e1, r, c2r);
      const float ra = dot(ns, c1r);
      const float rb = dot(ns, c2r);
      if (is_tri) {
        const float w0 = 1.0f - ra - rb;
        uu = w0 * det.uv[0] + ra * det.uv[2] + rb * det.uv[4];
        vv = w0 * det.uv[1] + ra * det.uv[3] + rb * det.uv[5];
      } else {
        uu = ra;
        vv = rb;
      }
    }
    use_c1 = fmodf(floorf(uu * det.f0) + floorf(vv * det.f1), 2.0f) != 0.0f;
  }
  const bool rich = det.texkind > kTexChecker;
  float al[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    al[k] = rich ? 1.0f : (use_c1 ? x.c1[k] : x.c0[k]);

  const bool live_hit = det.alive && valid;
  const float kind = det.kind_m;
  const bool emit = live_hit && kind == kMatLight;
  const bool is_absorb = kind == kMatLight || kind == kMatPitchBlack;
  const bool is_hemi = kind == kMatLambertian || kind == kMatLommel;
  const bool is_metal = kind == kMatMetal;
  const bool is_diel = kind == kMatDielectric;
  const bool is_mirror = kind == kMatMirror;
  const bool is_spec = is_mirror || is_metal || is_diel ||
                       kind == kMatTransparent;

  // specular family
  const float ddn = dot(d, n);
  const float two_ddn = 2.0f * ddn;
  float rf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rf[k] = d[k] - two_ddn * n[k];
  float fu[3] = {0.f, 0.f, 0.f}, mxv[3] = {0.f, 0.f, 0.f};
  float m_q2 = 1.0f, m_s = 1.0f, m_inv = 1.0f;
  bool spec_dead = false;
  if (is_metal) {
    unit_from_uniforms(det.u[0], det.u[1], fu[0], fu[1], fu[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) mxv[k] = rf[k] + x.param * fu[k];
    spec_dead = !(dot(mxv, n) > 0.0f);
    m_q2 = dot(mxv, mxv);
    m_s = sqrtf(tmax(m_q2, RT_F(1e-12)));
    m_inv = 1.0f / m_s;
  }
  float ior = 1.0f, ir = 1.0f, cos_raw = 0.0f, cos_t = 0.0f, q_inner = 0.0f,
        par = 1.0f;
  float qv[3] = {0.f, 0.f, 0.f};
  bool di_reflect = false;
  if (is_diel) {
    ior = tmax(x.param, RT_F(1e-6));
    ir = front ? 1.0f / ior : ior;
    cos_raw = n[0] * (-d[0]) + n[1] * (-d[1]) + n[2] * (-d[2]);
    cos_t = tmin(cos_raw, 1.0f);
    const float sin_t = sqrtf(tmax(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = ir * sin_t > 1.0f;
    float r0 = (1.0f - ir) / (1.0f + ir);
    r0 = r0 * r0;
    const float one_c = 1.0f - cos_t;
    const float oc2 = one_c * one_c;
    const float schlick = r0 + (1.0f - r0) * (oc2 * oc2 * one_c);
    di_reflect = cannot || det.u[2] < schlick;
#pragma unroll
    for (int k = 0; k < 3; ++k) qv[k] = ir * (d[k] + cos_t * n[k]);
    q_inner = 1.0f - dot(qv, qv);
    par = sqrtf(tmax(fabsf(q_inner), RT_F(1e-12)));
  }

  // diffuse family with redirection (the sampled direction is detached)
  float bv[3];
  {
    float uv_[3];
    unit_from_uniforms(det.u[3], det.u[4], uv_[0], uv_[1], uv_[2]);
    float cd[3] = {n[0] + uv_[0], n[1] + uv_[1], n[2] + uv_[2]};
    const float cinv = 1.0f / sqrtf(tmax(dot(cd, cd), RT_F(1e-12)));
#pragma unroll
    for (int k = 0; k < 3; ++k) bv[k] = is_hemi ? cd[k] * cinv : uv_[k];
  }
  if (n_targets > 0 && det.u[5] < tg[n_targets - 1].cdf) {
    int ti = 0;
    while (!(det.u[5] < tg[ti].cdf)) ++ti;
    const LaneTarget& t = tg[ti];
    float tv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tv[k] = t.q[k] + det.u[6] * t.u[k] + det.u[7] * t.v[k] - p[k];
    const float tinv = 1.0f / sqrtf(tmax(dot(tv, tv), RT_F(1e-12)));
#pragma unroll
    for (int k = 0; k < 3; ++k) bv[k] = tv[k] * tinv;
  }
  const float mu1 = dot(bv, n);
  const float pdf_base = is_hemi ? mu1 * RT_F(1.0 / kPiD) : RT_F(0.25 / kPiD);
  const bool hemi_dead = is_hemi && pdf_base <= 0.0f;
  float pdf_mix;
  if (n_targets > 0) {
    float pdf_sum = (1.0f - tg[n_targets - 1].cdf) * pdf_base;
    for (int ti = 0; ti < n_targets; ++ti) {
      const LaneTarget& t = tg[ti];
      const float den = dot(bv, t.nt);
      const bool den_ok = fabsf(den) > RT_F(1e-8);
      const float tt = (t.qn - dot(p, t.nt)) / (den_ok ? den : 1.0f);
      float hv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) hv[k] = p[k] + tt * bv[k] - t.q[k];
      const float aa = dot(hv, t.wa);
      const float bb = dot(hv, t.wb);
      const bool hit_t = den_ok && tt > 0.0f && 0.0f <= aa && aa <= 1.0f &&
                         0.0f <= bb && bb <= 1.0f;
      const float cross_dot = fabsf(dot(bv, t.cp));
      const float pdf_i =
          hit_t ? tt * tt / tmax(cross_dot, RT_F(1e-12)) : 0.0f;
      pdf_sum = pdf_sum + t.prob * pdf_i;
    }
    pdf_mix = tmax(pdf_sum, RT_F(1e-12));
  } else {
    pdf_mix = tmax(pdf_base, RT_F(1e-12));
  }
  const float mu0 = -ddn;
  const float lom_x = mu0 + mu1;
  const float lom_l = tmax(lom_x, RT_F(1e-8));
  const float lommel = 0.25f / lom_l;
  const float gg = x.param;
  const float hg_mu = dot(d, bv);
  const float hden_raw = 1.0f + gg * gg - 2.0f * gg * hg_mu;
  const float hden = tmax(hden_raw, RT_F(1e-12));
  const float hs = sqrtf(hden);
  const float den3 = hden * hs;
  const float hnum = 1.0f - gg * gg;
  const float hg = hnum / den3;
  const float brdf =
      kind == kMatAnisotropic ? hg : (kind == kMatLommel ? lommel : 1.0f);
  const float dw = brdf * pdf_base / pdf_mix;
  const bool next_alive = live_hit && !is_absorb && !spec_dead && !hemi_dead;

  // ================= reverse =================
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.p0[k] = g.e1[k] = g.e2[k] = g.mv0[k] = g.mv1[k] = 0.0f;
    g.c0[k] = g.c1[k] = g.o[k] = g.d[k] = g.thr[k] = 0.0f;
  }
  g.param = 0.0f;
  g.time = 0.0f;
  float g_p[3] = {0.f, 0.f, 0.f}, g_n[3] = {0.f, 0.f, 0.f};
  float g_al[3] = {0.f, 0.f, 0.f}, g_rf[3] = {0.f, 0.f, 0.f};
  float g_ddn = 0.0f;

  if (next_alive) {
    float g_w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float w = is_spec ? (is_diel ? 1.0f : al[k]) : al[k] * dw;
      g.thr[k] += ct.thr2[k] * w;
      g_w[k] = ct.thr2[k] * x.thr[k];
      g_p[k] += ct.o2[k];
    }
    const float* g_nd = ct.d2;
    if (is_spec) {
      if (!is_diel) {
#pragma unroll
        for (int k = 0; k < 3; ++k) g_al[k] += g_w[k];
      }
      if (is_mirror || (is_diel && di_reflect)) {
#pragma unroll
        for (int k = 0; k < 3; ++k) g_rf[k] += g_nd[k];
      } else if (is_metal) {
        // m = mx / sqrt(max(|mx|^2, eps)), mx = rf + param * fu
        float g_mx[3];
        float g_inv = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_mx[k] = g_nd[k] * m_inv;
          g_inv += g_nd[k] * mxv[k];
        }
        const float g_s = -g_inv / (m_s * m_s);
        const float g_q2 = dmax(m_q2, RT_F(1e-12), g_s * 0.5f / m_s);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_mx[k] += 2.0f * mxv[k] * g_q2;
          g_rf[k] += g_mx[k];
          g.param += g_mx[k] * fu[k];
        }
      } else if (is_diel) {
        // refraction f = q - par * n, q = ir * (d + cos_t * n)
        float g_q[3];
        float g_par = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_q[k] = g_nd[k];
          g_par -= g_nd[k] * n[k];
          g_n[k] -= par * g_nd[k];
        }
        const float g_abs = dmax(fabsf(q_inner), RT_F(1e-12),
                                 g_par * 0.5f / par);
        const float g_qq = -(g_abs * sgn(q_inner));
        float g_ir = 0.0f, g_cos = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_q[k] += 2.0f * qv[k] * g_qq;
          g_ir += g_q[k] * (d[k] + cos_t * n[k]);
          const float g_sv = g_q[k] * ir;
          g.d[k] += g_sv;
          g_cos += g_sv * n[k];
          g_n[k] += g_sv * cos_t;
        }
        const float g_ior = front ? -g_ir / (ior * ior) : g_ir;
        g.param += dmax(x.param, RT_F(1e-6), g_ior);
        const float g_cr = dmin(cos_raw, 1.0f, g_cos);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_n[k] -= d[k] * g_cr;
          g.d[k] -= n[k] * g_cr;
        }
      } else {
        // transparent: the ray goes on unchanged
#pragma unroll
        for (int k = 0; k < 3; ++k) g.d[k] += g_nd[k];
      }
    } else {
      // diffuse: w = al * brdf * pdf_base / pdf_mix; the new direction is
      // the detached sample
      float g_dw = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_dw += g_w[k] * al[k];
        g_al[k] += g_w[k] * dw;
      }
      const float g_bp = g_dw / pdf_mix;
      const float g_brdf = g_bp * pdf_base;
      float g_mu1 = 0.0f;
      if (kind == kMatAnisotropic) {
        // Henyey-Greenstein (1 - g^2) / (den * sqrt(den))
        const float g_den3 = -g_brdf * hnum / (den3 * den3);
        const float g_hden = g_den3 * hs + g_den3 * hden * 0.5f / hs;
        const float g_raw = dmax(hden_raw, RT_F(1e-12), g_hden);
        g.param += g_raw * (2.0f * gg - 2.0f * hg_mu) +
                   (g_brdf / den3) * (-2.0f * gg);
        const float g_mu = g_raw * (-2.0f * gg);
#pragma unroll
        for (int k = 0; k < 3; ++k) g.d[k] += bv[k] * g_mu;
      } else if (kind == kMatLommel) {
        const float g_x =
            dmax(lom_x, RT_F(1e-8), -g_brdf * 0.25f / (lom_l * lom_l));
        g_mu1 += g_x;
        g_ddn -= g_x;
      }
      if (is_hemi) g_mu1 += g_bp * brdf * RT_F(1.0 / kPiD);
#pragma unroll
      for (int k = 0; k < 3; ++k) g_n[k] += bv[k] * g_mu1;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g.thr[k] += ct.thr2[k];
      g.o[k] += ct.o2[k];
      g.d[k] += ct.d2[k];
    }
  }
  if (emit) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g.thr[k] += ct.rad[k] * al[k];
      g_al[k] += ct.rad[k] * x.thr[k];
    }
  }
  // reflection rf = d - 2 (d.n) n
  {
    float g_two = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g.d[k] += g_rf[k];
      g_two -= g_rf[k] * n[k];
      g_n[k] -= two_ddn * g_rf[k];
    }
    g_ddn += 2.0f * g_two;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.d[k] += n[k] * g_ddn;
    g_n[k] += d[k] * g_ddn;
  }
  if (!rich) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (use_c1)
        g.c1[k] += g_al[k];
      else
        g.c0[k] += g_al[k];
    }
  }

  // normal -> geometry (a box normal is an axis: no gradient)
  float g_os[3] = {0.f, 0.f, 0.f}, g_nu[3] = {0.f, 0.f, 0.f};
  float g_ts = 0.0f;
  if (live_hit && !is_box) {
    if (is_sphere) {
      float g_inv_r = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float g_ow = g_n[k] * sgn_s;
        const float g_r = g_ow * inv_r;
        g_inv_r += g_ow * r[k];
        g_os[k] += g_r;
        g_ts += g_r * d[k];
        g.d[k] += g_r * t_safe;
        g.p0[k] -= g_r;
      }
      if (radius_ok) g.e1[0] -= g_inv_r / (radius * radius);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) g_nu[k] += g_n[k] * sgn_p;
    }
  }
  // hit point p = o + t d
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.o[k] += g_p[k];
    g_ts += g_p[k] * d[k];
    g.d[k] += g_p[k] * t_safe;
  }

  // t -> the root it came from
  if (valid && (src == 1 || src == 2)) {
    const float g_h0 = g_ts;  // both roots have d/dh = 1
    const float g_sq = src == 2 ? g_ts : -g_ts;
    const float g_disc = dmax(disc, RT_F(1e-20), g_sq * 0.5f / sq);
    const float g_h = g_h0 + 2.0f * h * g_disc;
    const float g_cc = -g_disc;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float g_oc = 2.0f * oc[k] * g_cc + d[k] * g_h;
      g.d[k] += oc[k] * g_h;
      g.p0[k] += g_oc;
      g_os[k] -= g_oc;
    }
    g.e1[0] -= 2.0f * e1[0] * g_cc;
  } else if (valid && src == 3) {
    const float g_num = g_ts / denom;
    const float g_den = -g_ts * num / (denom * denom);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_nu[k] += oc[k] * g_num + d[k] * g_den;
      g.p0[k] += nu[k] * g_num;
      g_os[k] -= nu[k] * g_num;
      g.d[k] += nu[k] * g_den;
    }
  } else if (valid && (src == 4 || src == 5)) {
    float g_tn = src == 4 ? g_ts : 0.0f;
    float g_tf = src == 5 ? g_ts : 0.0f;
#pragma unroll
    for (int c = 2; c >= 0; --c) {
      // tn = max(tn_in, min(t0, t1)), tf = min(tf_in, max(t0, t1))
      const float g_mn = dsel(bmn[c], tn_in[c], g_tn, true);
      const float g_mx = dsel(bmx[c], tf_in[c], g_tf, false);
      g_tn = dsel(tn_in[c], bmn[c], g_tn, true);
      g_tf = dsel(tf_in[c], bmx[c], g_tf, false);
      const float g_t0 = dsel(bt0[c], bt1[c], g_mn, false) +
                         dsel(bt0[c], bt1[c], g_mx, true);
      const float g_t1 = dsel(bt1[c], bt0[c], g_mn, false) +
                         dsel(bt1[c], bt0[c], g_mx, true);
      g.p0[c] += g_t0 / bsf[c];
      g.e1[c] += g_t1 / bsf[c];
      g_os[c] -= g_t0 / bsf[c] + g_t1 / bsf[c];
      if (!bsmall[c])
        g.d[c] -= g_t0 * (p0[c] - os[c]) / (bsf[c] * bsf[c]) +
                  g_t1 * (e1[c] - os[c]) / (bsf[c] * bsf[c]);
    }
  }
  // unit normal nu = cp / |cp|, cp = e1 x e2
  if (!degen) {
    float g_cp[3];
    float g_inv = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_cp[k] = g_nu[k] * inv_cp;
      g_inv += g_nu[k] * cp[k];
    }
    const float g_cpsq = (-g_inv / (s_cp * s_cp)) * 0.5f / s_cp;
#pragma unroll
    for (int k = 0; k < 3; ++k) g_cp[k] += 2.0f * cp[k] * g_cpsq;
    float ge1[3], ge2[3];
    cross(e2, g_cp, ge1);
    cross(g_cp, e1, ge2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g.e1[k] += ge1[k];
      g.e2[k] += ge2[k];
    }
  }
  // shifted origin os = o - (mv0 (1 - time) + time mv1)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.o[k] += g_os[k];
    if (has_motion) {
      g.mv0[k] -= g_os[k] * mt;
      g.mv1[k] -= g_os[k] * x.time;
      g.time -= g_os[k] * (x.mv1[k] - x.mv0[k]);
    }
  }
  return (det.alive && !valid) ? 1.0f : 0.0f;
}

}  // namespace rt
