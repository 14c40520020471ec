// The reverse adjoint (VJP) of one march step, written by hand in float:
// the gradient kernel's per-step derivative (march_grad.cu).
//
// Counterpart of jax.vjp of blackhole_simulation_tpu/ops/pallas_grad.py::
// make_composite (:71), which the Pallas gradient kernel traces at build
// time, and, for the jets' march, of jax.grad through the jets' term of
// the jnp march's step (render/march.py:555-569, which the JAX package
// differentiates by jnp AD; its gradient kernel has no jets). march_step_vjp takes the step's inputs x[11] (t, r, u, ph, pr, pu,
// pph, m, a, r_h, r_ph) and returns J^T cto for the output cotangents
// cto[10] (the six state rows, r_c, phi_c, t_c, dmin). It first recomputes
// the step forward with march_step.cuh's own float functions, so the
// forward's values, masks and crossing decisions are the replay's bit for
// bit, keeping what the reverse reads (the stepped y, the unclipped u, the
// last midpoint input, dlam); that recompute also gives crossed, advance
// and dmin, from which the caller's inject() forms cto. Then it walks back
// through the step: the renormalization, the advance/freeze select, the
// crossing record, the midpoint rounds (each ks_rhs_vjp recomputes its own
// forward: no tape) and the step size. On the approx_recip route the
// forward recompute contracts the step's multiply-adds as the forward does
// (march_step.cuh::madd, with its decisions the forward's); the reverse
// stays uncontracted, its derivatives held at relative bars. The plain
// PyTorch mirror, function for function, is ops/march_adjoint.py (the
// exact route).
//
// The derivative rules are the forward-mode Dual step's (march_step.cuh),
// which JAX's rules fix: ties of jmax, jmin and jclip split the cotangent
// half and half; d|x| uses sign(0) = 0; the approximate reciprocal's
// derivative is -y^2 of the approximate y; a branch chosen by value (the
// renormalization's valid and nearest, the crossing record's 1e-12 guard)
// passes nothing to the side not taken. A zero cotangent contributes
// nothing, even where a discarded partial is not finite (the dual pass
// skipped outputs whose cotangent was 0): a branch whose incoming cotangent
// is exactly 0 is not reversed, and on a step that does not advance the
// carry passes straight through, only a nonzero crossing cotangent
// reversing the step's values.

#pragma once

#include "march_step.cuh"

#define NIN 11   // t, r, u, ph, pr, pu, pph, m, a, r_h, r_ph
#define NOUT 10  // 6 state rows, r_c, phi_c, t_c, dmin

// (gx, gy) of jmax(x, y) / jmin(x, y) for the cotangent g.
__device__ __forceinline__ void max_vjp(float x, float y, float g, float& gx,
                                        float& gy) {
  if (x == y) {
    gx = gy = 0.5f * g;
  } else if (x > y || x != x) {
    gx = g;
    gy = 0.0f;
  } else {
    gx = 0.0f;
    gy = g;
  }
}
__device__ __forceinline__ void min_vjp(float x, float y, float g, float& gx,
                                        float& gy) {
  if (x == y) {
    gx = gy = 0.5f * g;
  } else if (x < y || x != x) {
    gx = g;
    gy = 0.0f;
  } else {
    gx = 0.0f;
    gy = g;
  }
}
__device__ __forceinline__ float max_vjp_x(float x, float y, float g) {
  float gx, gy;
  max_vjp(x, y, g, gx, gy);
  return gx;
}
__device__ __forceinline__ float min_vjp_x(float x, float y, float g) {
  float gx, gy;
  min_vjp(x, y, g, gx, gy);
  return gx;
}
// gx of jclip(x, lo, hi) = jmin(jmax(x, lo), hi), constant bounds.
__device__ __forceinline__ float clip_vjp(float x, float lo, float hi,
                                          float g) {
  return max_vjp_x(x, lo, min_vjp_x(jmax(x, lo), hi, g));
}
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
// gx of y = recip<APPROX>(x).
template <bool APPROX>
__device__ __forceinline__ float recip_vjp(float x, float y, float g) {
  if constexpr (APPROX)
    return -y * y * g;
  else
    return -(y * g) / x;
}

// The kernel's per-step cotangent clip of the six carry rows.
__device__ __forceinline__ void clip_carry(float c[6], float limit) {
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) ss = ss + c[k] * c[k];
  const float norm = sqrtf(ss);
  const float scale = jmin(1.0f, limit / jmax(norm, F(1e-30)));
#pragma unroll
  for (int k = 0; k < 6; ++k) c[k] = c[k] * scale;
}

// VJP of ks_rhs (p_t = -1) with the cotangents g[6] of its derivatives:
// d[6] receives the primal, gp the cotangents of (m, a, r, u, pr, pu, pph)
// (overwritten). Its own forward, uncontracted: it reads derivatives, held
// at relative bars, and branches on nothing but w's floor, which both
// routes compute uncontracted.
template <bool APPROX>
__device__ __forceinline__ void ks_rhs_vjp(float m, float a, float r, float u,
                                           float pr, float pu, float pph,
                                           const float g[6], float d[6],
                                           float gp[7]) {
  const float pt = -1.0f;
  const float one_uu = 1.0f - u * u;
  const float w = jmax(one_uu, F(1e-6));
  const float S = r * r + a * a * u * u;
  const float D = r * r - 2.0f * m * r + a * a;
  const float inv_S = recip<APPROX>(S);
  const float h = 2.0f * m * r * inv_S;
  const float inv_S2 = inv_S * inv_S;
  const float inv_w = recip<APPROX>(w);

  const float S_r = 2.0f * r;
  const float D_r = 2.0f * r - 2.0f * m;
  const float h_r = 2.0f * m * (S - 2.0f * r * r) * inv_S2;
  const float DS_r = (D_r * S - D * S_r) * inv_S2;
  const float invS_r = -S_r * inv_S2;
  const float wS_r = -w * S_r * inv_S2;
  const float invSw_r = -S_r * inv_S2 * inv_w;
  const float S_u = 2.0f * a * a * u;
  const float w_u = -2.0f * u;
  const float h_u = -2.0f * m * r * S_u * inv_S2;
  const float DS_u = -D * S_u * inv_S2;
  const float invS_u = -S_u * inv_S2;
  const float wS_u = (w_u * S - w * S_u) * inv_S2;
  const float iw2 = inv_w * inv_w;
  const float R = S_u * w + S * w_u;
  const float invSw_u = -R * inv_S2 * iw2;

  d[0] = -(1.0f + h) * pt + h * pr;
  d[1] = h * pt + D * inv_S * pr + a * inv_S * pph;
  d[2] = w * inv_S * pu;
  d[3] = a * inv_S * pr + pph * inv_S * inv_w;
  d[4] = -0.5f * (-h_r * pt * pt + 2.0f * h_r * pt * pr + DS_r * pr * pr +
                  2.0f * a * invS_r * pr * pph + wS_r * pu * pu +
                  invSw_r * pph * pph);
  d[5] = -0.5f * (-h_u * pt * pt + 2.0f * h_u * pt * pr + DS_u * pr * pr +
                  2.0f * a * invS_u * pr * pph + wS_u * pu * pu +
                  invSw_u * pph * pph);

  // dH/dr and dH/du: d4 = -dH_dr, d5 = -dH_du
  const float e = -0.5f * g[4];
  const float f = -0.5f * g[5];
  const float g_hr = e * (2.0f * pt * pr - pt * pt);
  const float g_DSr = e * pr * pr;
  const float g_invSr = e * 2.0f * a * pr * pph;
  const float g_wSr = e * pu * pu;
  const float g_invSwr = e * pph * pph;
  const float g_hu = f * (2.0f * pt * pr - pt * pt);
  const float g_DSu = f * pr * pr;
  const float g_invSu = f * 2.0f * a * pr * pph;
  const float g_wSu = f * pu * pu;
  const float g_invSwu = f * pph * pph;
  float gpr = e * (2.0f * h_r * pt + 2.0f * DS_r * pr + 2.0f * a * invS_r * pph) +
              f * (2.0f * h_u * pt + 2.0f * DS_u * pr + 2.0f * a * invS_u * pph);
  float gpph = e * (2.0f * a * invS_r * pr + 2.0f * invSw_r * pph) +
               f * (2.0f * a * invS_u * pr + 2.0f * invSw_u * pph);
  float gpu = e * 2.0f * wS_r * pu + f * 2.0f * wS_u * pu;
  float ga = e * 2.0f * invS_r * pr * pph + f * 2.0f * invS_u * pr * pph;

  // the first-order terms d0 .. d3
  const float g_h = g[0] * (pr - pt) + g[1] * pt;
  gpr = gpr + g[0] * h + g[1] * D * inv_S + g[3] * a * inv_S;
  float g_D = g[1] * inv_S * pr;
  float g_invS = g[1] * (D * pr + a * pph) + g[2] * w * pu +
                 g[3] * (a * pr + pph * inv_w);
  ga = ga + g[1] * inv_S * pph + g[3] * inv_S * pr;
  gpph = gpph + g[1] * a * inv_S + g[3] * inv_S * inv_w;
  float g_w = g[2] * inv_S * pu;
  gpu = gpu + g[2] * w * inv_S;
  float g_invw = g[3] * pph * inv_S;

  // the r-derivative terms
  const float g_Sr = -g_DSr * D * inv_S2 - g_invSr * inv_S2 -
                     g_wSr * w * inv_S2 - g_invSwr * inv_S2 * inv_w;
  const float g_Dr = g_DSr * S * inv_S2;
  float g_S = g_hr * 2.0f * m * inv_S2 + g_DSr * D_r * inv_S2;
  g_D = g_D - g_DSr * S_r * inv_S2;
  float g_invS2 = g_hr * 2.0f * m * (S - 2.0f * r * r) +
                  g_DSr * (D_r * S - D * S_r) - g_invSr * S_r -
                  g_wSr * w * S_r - g_invSwr * S_r * inv_w;
  float gm = g_hr * 2.0f * (S - 2.0f * r * r) * inv_S2;
  float gr = -g_hr * 8.0f * m * r * inv_S2;
  g_w = g_w - g_wSr * S_r * inv_S2;
  g_invw = g_invw - g_invSwr * S_r * inv_S2;

  // the u-derivative terms
  const float g_Su = -g_hu * 2.0f * m * r * inv_S2 - g_DSu * D * inv_S2 -
                     g_invSu * inv_S2 - g_wSu * w * inv_S2 -
                     g_invSwu * w * inv_S2 * iw2;
  const float g_wu = g_wSu * S * inv_S2 - g_invSwu * S * inv_S2 * iw2;
  gm = gm - g_hu * 2.0f * r * S_u * inv_S2;
  gr = gr - g_hu * 2.0f * m * S_u * inv_S2;
  g_D = g_D - g_DSu * S_u * inv_S2;
  g_S = g_S + g_wSu * w_u * inv_S2 - g_invSwu * w_u * inv_S2 * iw2;
  g_w = g_w - g_wSu * S_u * inv_S2 - g_invSwu * S_u * inv_S2 * iw2;
  g_invS2 = g_invS2 - g_hu * 2.0f * m * r * S_u - g_DSu * D * S_u -
            g_invSu * S_u + g_wSu * (w_u * S - w * S_u) - g_invSwu * R * iw2;
  g_invw = g_invw - g_invSwu * R * inv_S2 * 2.0f * inv_w;

  // S_u = 2 a^2 u, w_u = -2 u, S_r = 2 r, D_r = 2 r - 2 m
  ga = ga + g_Su * 4.0f * a * u;
  float gu = g_Su * 2.0f * a * a - 2.0f * g_wu;
  gr = gr + 2.0f * g_Sr + 2.0f * g_Dr;
  gm = gm - 2.0f * g_Dr;

  // inv_S2, h, the reciprocals, D, S, w
  g_invS = g_invS + 2.0f * inv_S * g_invS2;
  gm = gm + 2.0f * r * inv_S * g_h;
  gr = gr + 2.0f * m * inv_S * g_h;
  g_invS = g_invS + 2.0f * m * r * g_h;
  g_w = g_w + recip_vjp<APPROX>(w, inv_w, g_invw);
  g_S = g_S + recip_vjp<APPROX>(S, inv_S, g_invS);
  gr = gr + (2.0f * r - 2.0f * m) * g_D + 2.0f * r * g_S;
  gm = gm - 2.0f * r * g_D;
  ga = ga + 2.0f * a * g_D + 2.0f * a * u * u * g_S;
  gu = gu + 2.0f * a * a * u * g_S;
  gu = gu - 2.0f * u * max_vjp_x(one_uu, F(1e-6), g_w);
  gp[0] = gm;
  gp[1] = ga;
  gp[2] = gr;
  gp[3] = gu;
  gp[4] = gpr;
  gp[5] = gpu;
  gp[6] = gpph;
}

// The (r, u, pr, pu) at which the midpoint step evaluates its right-hand
// side the e-th time (0: the start state), recomputed from the start as
// midpoint_step advances it.
template <bool APPROX>
__device__ __forceinline__ void midpoint_input(float m, float a, float dlam,
                                               const float x[6], float pph,
                                               int e, float mid[4]) {
  mid[0] = x[1];
  mid[1] = x[2];
  mid[2] = x[4];
  mid[3] = x[5];
  for (int k = 0; k < e; ++k) {
    float d[6];
    ks_rhs<APPROX>(m, a, mid[0], mid[1], mid[2], mid[3], pph, d);
    mid[0] = 0.5f * (x[1] + madd<APPROX>(dlam, d[1], x[1]));
    mid[1] = 0.5f * (x[2] + madd<APPROX>(dlam, d[2], x[2]));
    mid[2] = 0.5f * (x[4] + madd<APPROX>(dlam, d[4], x[4]));
    mid[3] = 0.5f * (x[5] + madd<APPROX>(dlam, d[5], x[5]));
  }
}

// VJP of midpoint_step (iters fixed-point rounds, then u clipped) with the
// cotangents gy[6] of the stepped rows (consumed). nu_raw: the unclipped
// stepped u; mid_last: the last evaluation's input (the forward keeps
// both); earlier inputs are recomputed. gx[6] receives the start state's
// cotangents (overwritten); g_dlam, gm, ga, gpph are added to.
template <bool APPROX>
__device__ __forceinline__ void midpoint_step_vjp(
    const MarchParams& mp, float m, float a, float dlam,
    const float x[6], float pph, float nu_raw, const float mid_last[4],
    float gy[6], float gx[6], float& g_dlam, float& gm, float& ga,
    float& gpph) {
  gy[2] = clip_vjp(nu_raw, F(-1.0 + 1e-7), F(1.0 - 1e-7), gy[2]);
#pragma unroll
  for (int k = 0; k < 6; ++k) gx[k] = 0.0f;
  for (int e = mp.midpoint_iters; e >= 0; --e) {
    float mid[4];
    if (e == mp.midpoint_iters) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mid[k] = mid_last[k];
    } else {
      midpoint_input<APPROX>(m, a, dlam, x, pph, e, mid);
    }
    float gd[6], d[6], gp[7];
#pragma unroll
    for (int k = 0; k < 6; ++k) gd[k] = dlam * gy[k];
    ks_rhs_vjp<APPROX>(m, a, mid[0], mid[1], mid[2], mid[3], pph, gd, d, gp);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      g_dlam = g_dlam + gy[k] * d[k];
      gx[k] = gx[k] + gy[k];
    }
    gm = gm + gp[0];
    ga = ga + gp[1];
    gpph = gpph + gp[6];
    // evaluation e > 0 reads 0.5 (x + n_{e-1}); evaluation 0 reads x
    const float s = e > 0 ? 0.5f : 1.0f;
    gx[1] = gx[1] + s * gp[2];
    gx[2] = gx[2] + s * gp[3];
    gx[4] = gx[4] + s * gp[4];
    gx[5] = gx[5] + s * gp[5];
    gy[0] = 0.0f;
    gy[1] = s * gp[2];
    gy[2] = s * gp[3];
    gy[3] = 0.0f;
    gy[4] = s * gp[4];
    gy[5] = s * gp[5];
  }
}

// VJP of step_size with the cotangent g of dlam: adds to ga, grh, grph,
// gr, gu, gpu. sig as step_size computes it (the min of the step and the
// pole limit reads it).
template <bool APPROX>
__device__ __forceinline__ void step_size_vjp(const MarchParams& mp,
                                              float a, float r_h,
                                              float r_ph, float r, float u,
                                              float pu, float g, float& ga,
                                              float& grh, float& grph,
                                              float& gr, float& gu,
                                              float& gpu) {
  const float rp = jmax(r_ph, F(1e-3));
  const float inv_rph = 1.0f / rp;
  const float base = (r - r_h) * mp.step_rate;
  const float rf = r / mp.far_boost_radius;
  const float far = jmax(rf, 1.0f);
  const float dr = r - r_ph;
  const float q = fabsf(dr) * inv_rph;
  const float qm = jmax(q, F(0.25));
  const float prox = jmin(qm, 1.0f);
  const float rr = mp.far_step_cap_rate * r;
  const float cap = mp.far_cap_on ? jmax(rr, mp.max_step) : mp.max_step;
  const float bf = base * far;
  const float v = bf * prox;
  const float vm = jmax(v, mp.min_step);
  const float dl1 = jmin(vm, cap);
  const float one_uu = 1.0f - u * u;
  const float w = jmax(one_uu, F(1e-6));
  const float sig = madd<APPROX>(r, r, a * a * u * u);
  const float wpu = w * pu;
  const float q2 = wpu / sig;
  const float du_rate = fabsf(q2) + F(1e-12);
  const float num = 0.5f * (1.0f - fabsf(u) + F(1e-6));
  const float rc = APPROX ? rcp_approx(du_rate) : 0.0f;
  const float q3 = APPROX ? num * rc : num / du_rate;
  const float lim = jmax(q3, mp.min_step);

  float g_dl1, g_lim;
  min_vjp(dl1, lim, g, g_dl1, g_lim);
  const float g_q3 = max_vjp_x(q3, mp.min_step, g_lim);
  float g_num, g_du;
  if constexpr (APPROX) {
    g_num = g_q3 * rc;
    g_du = -rc * rc * (g_q3 * num);
  } else {
    g_num = g_q3 / du_rate;
    g_du = -(q3 * g_q3) / du_rate;
  }
  gu = gu - sgn(u) * 0.5f * g_num;
  const float g_q2 = sgn(q2) * g_du;
  const float g_wpu = g_q2 / sig;
  const float g_sig = -(q2 * g_q2) / sig;
  const float g_w = g_wpu * pu;
  gpu = gpu + g_wpu * w;
  gr = gr + 2.0f * r * g_sig;
  ga = ga + 2.0f * a * u * u * g_sig;
  gu = gu + 2.0f * a * a * u * g_sig;
  gu = gu - 2.0f * u * max_vjp_x(one_uu, F(1e-6), g_w);

  float g_vm, g_cap;
  min_vjp(vm, cap, g_dl1, g_vm, g_cap);
  const float g_v = max_vjp_x(v, mp.min_step, g_vm);
  if (mp.far_cap_on)
    gr = gr + mp.far_step_cap_rate * max_vjp_x(rr, mp.max_step, g_cap);
  const float g_bf = g_v * prox;
  const float g_prox = g_v * bf;
  const float g_base = g_bf * far;
  const float g_far = g_bf * base;
  gr = gr + mp.step_rate * g_base;
  grh = grh - mp.step_rate * g_base;
  gr = gr + max_vjp_x(rf, 1.0f, g_far) / mp.far_boost_radius;
  const float g_q = max_vjp_x(q, F(0.25), min_vjp_x(qm, 1.0f, g_prox));
  const float g_abs = g_q * inv_rph;
  const float g_inv = g_q * fabsf(dr);
  const float sg = sgn(dr);
  gr = gr + sg * g_abs;
  grph = grph - sg * g_abs;
  grph = grph + max_vjp_x(r_ph, F(1e-3), recip_vjp<false>(rp, inv_rph, g_inv));
}

// VJP of crossing_record (the equator crossing interpolated between
// (t, r, u, ph) and the stepped, clipped y) with the cotangents of
// (r_c, phi_c, t_c): adds to gx[0..3] (t, r, u, ph) and gy[0..3]. The 1e-12
// guard is a constant.
template <bool APPROX>
__device__ __forceinline__ void crossing_record_vjp(
    float t, float r, float u, float ph, const float y[6],
    float g_rc, float g_pc, float g_tc, float gx[6], float gy[6]) {
  const float du = u - y[2];
  const bool guard = fabsf(du) < F(1e-12);
  const float den = guard ? F(1e-12) : du;
  const float rc = APPROX ? rcp_approx(den) : 0.0f;
  const float x = APPROX ? u * rc : u / den;
  const float xm = jmax(x, 0.0f);
  const float frac = jmin(xm, 1.0f);
  const float g_frac =
      g_rc * (y[1] - r) + g_pc * (y[3] - ph) + g_tc * (y[0] - t);
  gx[0] = gx[0] + (g_tc - g_tc * frac);
  gx[1] = gx[1] + (g_rc - g_rc * frac);
  gx[3] = gx[3] + (g_pc - g_pc * frac);
  gy[0] = gy[0] + g_tc * frac;
  gy[1] = gy[1] + g_rc * frac;
  gy[3] = gy[3] + g_pc * frac;
  const float g_x = max_vjp_x(x, 0.0f, min_vjp_x(xm, 1.0f, g_frac));
  float g_den;
  if constexpr (APPROX) {
    gx[2] = gx[2] + g_x * rc;
    g_den = -rc * rc * (g_x * u);
  } else {
    gx[2] = gx[2] + g_x / den;
    g_den = -(x * g_x) / den;
  }
  if (!guard) {
    gx[2] = gx[2] + g_den;
    gy[2] = gy[2] - g_den;
  }
}

// VJP of ks_renormalize_pr (exact divides) with the cotangent g of the
// projected p_r: gp receives the cotangents of (m, a, r, u, pr, pu, pph)
// (overwritten). Without a real root the projection is the identity on pr;
// with one, pr only picks the nearest root and gets nothing.
__device__ __forceinline__ void renormalize_pr_vjp(float m, float a, float r,
                                                   float u, float pr,
                                                   float pu, float pph,
                                                   float g, float gp[7]) {
  const float pt = -1.0f;
  const float one_uu = 1.0f - u * u;
  const float w = jmax(one_uu, F(1e-6));
  const float S = r * r + a * a * u * u;
  const float D = r * r - 2.0f * m * r + a * a;
  const float inv_S = 1.0f / S;
  const float h = 2.0f * m * r * inv_S;
  const float A = D * inv_S;
  const float B = 2.0f * (h * pt + a * inv_S * pph);
  const float C3 = pph * pph * inv_S / w;
  const float C = -(1.0f + h) * pt * pt + w * inv_S * pu * pu + C3;
  const float disc = B * B - 4.0f * A * C;
  const bool valid = (disc >= 0.0f) && (fabsf(A) > F(1e-12));
#pragma unroll
  for (int k = 0; k < 7; ++k) gp[k] = 0.0f;
  if (!valid) {
    gp[4] = g;
    return;
  }
  const float dm = jmax(disc, F(1e-30));
  const float sq = sqrtf(dm);
  const float denom = 2.0f * A;
  const float sol1 = (-B + sq) / denom;
  const float sol2 = (-B - sq) / denom;
  const bool first = fabsf(sol1 - pr) < fabsf(sol2 - pr);
  const float sol = first ? sol1 : sol2;
  const float pm = first ? 1.0f : -1.0f;

  const float g_num = g / denom;
  float g_A = 2.0f * (-(sol * g) / denom);
  float g_B = -g_num;
  const float g_sq = pm * g_num;
  const float g_disc = max_vjp_x(disc, F(1e-30), g_sq * 0.5f / sq);
  g_B = g_B + 2.0f * B * g_disc;
  g_A = g_A - 4.0f * C * g_disc;
  const float g_C = -4.0f * A * g_disc;
  const float g_h = -pt * pt * g_C + 2.0f * pt * g_B;
  const float g_w = inv_S * pu * pu * g_C - (C3 / w) * g_C;
  float g_invS = w * pu * pu * g_C + pph * pph / w * g_C;
  const float gpu = 2.0f * w * inv_S * pu * g_C;
  const float gpph = 2.0f * pph * inv_S / w * g_C + 2.0f * a * inv_S * g_B;
  float ga = 2.0f * inv_S * pph * g_B;
  g_invS = g_invS + 2.0f * a * pph * g_B + D * g_A;
  const float g_D = inv_S * g_A;
  float gm = 2.0f * r * inv_S * g_h;
  float gr = 2.0f * m * inv_S * g_h;
  g_invS = g_invS + 2.0f * m * r * g_h;
  const float g_S = recip_vjp<false>(S, inv_S, g_invS);
  gr = gr + (2.0f * r - 2.0f * m) * g_D + 2.0f * r * g_S;
  gm = gm - 2.0f * r * g_D;
  ga = ga + 2.0f * a * g_D + 2.0f * a * u * u * g_S;
  const float gu =
      2.0f * a * a * u * g_S - 2.0f * u * max_vjp_x(one_uu, F(1e-6), g_w);
  gp[0] = gm;
  gp[1] = ga;
  gp[2] = gr;
  gp[3] = gu;
  gp[5] = gpu;
  gp[6] = gpph;
}

// VJP of one step's jet emission (march_step.cuh::jet_emission and
// jet_beaming, the arguments jets_advance gives them) with the cotangents
// cj[3] of its three channels, at the pre-step t, r, u, ph = x[0..3], the
// stepped y (u clipped) and the step size dlam: adds to gx[1..3] (r, u,
// ph), gy[1..3] (the stepped r, the clipped u, the stepped ph) and g_dlam.
// Returns false, adding nothing, outside the cone or where the channels'
// cotangents sum to 0 (a zero cotangent contributes nothing). The forward
// is recomputed with the same float operations in the same order, so the
// cone test is the forward's. What has no derivative takes JAX's:
// in_cone and the live mask select, sign(z) is a constant, floor has
// derivative 0 (so the hashed lattice values are constants and fract's
// derivative is 1), the floored modulo's is 1; clip passes nothing outside
// its range and half at a tie (clip_vjp); |x| takes sign(0) = 0. The
// profile's exp and the beaming power are the forward's (float on the
// approx_recip route, through double on the exact one); their derivatives
// are formed from those values, exp(x) and p beam / delta.
template <bool APPROX>
__device__ __forceinline__ bool jet_emission_vjp(const JetParams& jp,
                                                 const float x[6],
                                                 const float y[6],
                                                 float dlam, const float cj[3],
                                                 float gx[6], float gy[6],
                                                 float& g_dlam) {
  const float r = x[1], u = x[2], ph = x[3];
  const float inv = recip<APPROX>(dlam);
  const float wj = jmax(1.0f - u * u, F(1e-6));
  const float st = sqrtf(wj);
  const float ct = u;
  const float ddr = y[1] - r;
  const float ddu = y[2] - u;
  const float ddp = y[3] - ph;
  const float dr = ddr * inv;
  const float dth = -ddu * inv / st;
  const float dph = ddp * inv;
  // jet_emission, kept
  const float z = r * ct;
  const float rs = r * st;
  const float rho = fabsf(rs);
  const float az = fabsf(z);
  const float cone_r = jp.core_radius + jp.opening_slope * az;
  const bool in_cone =
      (az > jp.z_min) && (az < jp.z_max) && (rho < F(2.5) * cone_r);
  const float g_mag = F(0.62) * cj[0] + F(0.74) * cj[1] + cj[2];
  if (!in_cone || g_mag == 0.0f) return false;
  const float crm = jmax(cone_r, F(1e-3));
  const float q = rho / crm;
  float profile;
  if constexpr (APPROX)
    profile = expf(-(q * q));
  else
    profile = (float)exp((double)(-(q * q)));
  const float v_z = dr * ct - r * st * dth;
  const float v_rho = dr * st + r * ct * dth;
  const float v_ph = r * st * dph;
  const float v_mag = sqrtf(v_z * v_z + v_rho * v_rho + v_ph * v_ph +
                            F(1e-12));
  const float sg = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float cos_psi = -sg * v_z / v_mag;
  const float den = jp.gamma * (1.0f - jp.beta * jclip(cos_psi, -1.0f, 1.0f));
  const float delta = 1.0f / den;
  const float nx = az * F(0.8);
  const float ny = fmod_floor(ph, F(6.283185307179586)) * 2.0f + az;
  const float xf = floorf(nx), yf = floorf(ny);
  const float fx = nx - xf, fy = ny - yf;
  const float tx = smooth(fx), ty = smooth(fy);
  const float c00 = hash21(xf, yf);
  const float c10 = hash21(xf + 1.0f, yf);
  const float c01 = hash21(xf, yf + 1.0f);
  const float c11 = hash21(xf + 1.0f, yf + 1.0f);
  const float noise = c00 * (1.0f - tx) * (1.0f - ty) +
                      c10 * tx * (1.0f - ty) + c01 * (1.0f - tx) * ty +
                      c11 * tx * ty;
  const float turb = jp.one_minus_turb + jp.turbulence * (0.5f + noise);
  const float dd = jp.density * dlam;
  const float pre = dd * profile * turb;
  float beam;
  if constexpr (APPROX)
    beam = powf(delta, jp.beaming_exponent);
  else
    beam = (float)pow((double)delta, (double)jp.beaming_exponent);

  // ---- reverse: mag = pre * beam, the channels 0.62, 0.74, 1 of mag ----
  const float g_pre = g_mag * beam;
  const float g_beam = g_mag * pre;
  const float g_delta = g_beam * (jp.beaming_exponent * beam / delta);
  const float g_den = -(delta * g_delta) / den;
  const float g_cc = -(jp.gamma * jp.beta) * g_den;
  const float g_cos = clip_vjp(cos_psi, -1.0f, 1.0f, g_cc);
  // cos_psi = (-sg v_z) / v_mag
  float g_vz = (-sg) * g_cos / v_mag;
  const float g_vmag = -(cos_psi * g_cos) / v_mag;
  const float g_vsum = g_vmag * 0.5f / v_mag;
  g_vz = g_vz + 2.0f * v_z * g_vsum;
  const float g_vrho = 2.0f * v_rho * g_vsum;
  const float g_vph = 2.0f * v_ph * g_vsum;
  // pre = density dlam profile turb
  g_dlam = g_dlam + g_pre * jp.density * profile * turb;
  const float g_profile = g_pre * dd * turb;
  const float g_turb = g_pre * dd * profile;
  // the noise octave: d/dtx, d/dty of the bilinear blend, smooth' = 6t(1-t)
  const float g_noise = g_turb * jp.turbulence;
  const float dn_tx = (c10 - c00) * (1.0f - ty) + (c11 - c01) * ty;
  const float dn_ty = (c01 - c00) * (1.0f - tx) + (c11 - c10) * tx;
  const float g_nx = g_noise * dn_tx * (6.0f * fx * (1.0f - fx));
  const float g_ny = g_noise * dn_ty * (6.0f * fy * (1.0f - fy));
  float g_az = F(0.8) * g_nx + g_ny;
  float g_ph = 2.0f * g_ny;
  // profile = exp(-q^2), q = rho / max(cone_r, 1e-3)
  const float g_q = -2.0f * q * profile * g_profile;
  float g_rho = g_q / crm;
  const float g_crm = -(q * g_q) / crm;
  g_az = g_az + jp.opening_slope * max_vjp_x(cone_r, F(1e-3), g_crm);
  // the ray's direction: v_z, v_rho, v_ph of (dr, dth, dph) at (r, st, ct)
  const float g_dr = g_vz * ct + g_vrho * st;
  float g_ct = g_vz * dr + g_vrho * r * dth;
  float g_r = -g_vz * st * dth + g_vrho * ct * dth + g_vph * st * dph;
  float g_st = -g_vz * r * dth + g_vrho * dr + g_vph * r * dph;
  const float g_dth = -g_vz * r * st + g_vrho * r * ct;
  const float g_dph = g_vph * r * st;
  // z = r ct, az = |z|; rho = |r st|
  const float g_z = sgn(z) * g_az;
  g_r = g_r + g_z * ct;
  g_ct = g_ct + g_z * r;
  g_rho = sgn(rs) * g_rho;
  g_r = g_r + g_rho * st;
  g_st = g_st + g_rho * r;
  // dth = (-(y_u - u) inv) / st, dr = (y_r - r) inv, dph = (y_ph - ph) inv
  const float g_num = g_dth / st;
  g_st = g_st - (dth * g_dth) / st;
  float g_inv = g_num * (-ddu) + g_dr * ddr + g_dph * ddp;
  gy[1] = gy[1] + g_dr * inv;
  g_r = g_r - g_dr * inv;
  gy[2] = gy[2] - g_num * inv;
  float g_u = g_ct + g_num * inv;
  gy[3] = gy[3] + g_dph * inv;
  g_ph = g_ph - g_dph * inv;
  g_dlam = g_dlam + recip_vjp<APPROX>(dlam, inv, g_inv);
  // st = sqrt(max(1 - u^2, 1e-6))
  const float g_wj = g_st * 0.5f / st;
  g_u = g_u - 2.0f * u * max_vjp_x(1.0f - u * u, F(1e-6), g_wj);
  gx[1] = gx[1] + g_r;
  gx[2] = gx[2] + g_u;
  gx[3] = gx[3] + g_ph;
  return true;
}

// J^T cto of one live march step (march_step at step i with the pre-step
// crossing count nc) at x[NIN]. After the forward recompute,
// inject(crossed, advance, dmin, cto) fills the output cotangents cto[NOUT],
// as the gradient kernel injects its crossing and r_min cotangents there.
// cin[NIN] receives the input cotangents. With JETS the step is the jets'
// (jets_advance: the same state update, plus the emission from the
// pre-step state, the stepped one and dlam, on every live step, also one
// that the sanity test freezes): cj[3], the jet radiance's cotangent, adds
// the emission's VJP (jet_emission_vjp, jp its configuration).
template <bool APPROX, bool JETS = false, class Inject>
__device__ __forceinline__ void march_step_vjp(const MarchParams& mp,
                                               const float x[NIN], float thr,
                                               int i, int nc, Inject inject,
                                               float cin[NIN],
                                               const JetParams* jp = nullptr,
                                               const float* cj = nullptr) {
  const float t = x[0], r = x[1], u = x[2], ph = x[3], pr = x[4], pu = x[5];
  const float pph = x[6], m = x[7], a = x[8], r_h = x[9], r_ph = x[10];

  // ---- forward, keeping what the reverse reads ----
  const float dlam =
      step_size<APPROX>(mp, a, r_h, r_ph, inv_rph_of(r_ph), r, u, pu);
  float d[6], y[6];
  ks_rhs<APPROX>(m, a, r, u, pr, pu, pph, d);
  advance_rows<APPROX>(dlam, t, r, u, ph, pr, pu, d, y);
  float mid[4] = {r, u, pr, pu};
  for (int it = 0; it < mp.midpoint_iters; ++it) {
    mid[0] = 0.5f * (r + y[1]);
    mid[1] = 0.5f * (u + y[2]);
    mid[2] = 0.5f * (pr + y[4]);
    mid[3] = 0.5f * (pu + y[5]);
    ks_rhs<APPROX>(m, a, mid[0], mid[1], mid[2], mid[3], pph, d);
    advance_rows<APPROX>(dlam, t, r, u, ph, pr, pu, d, y);
  }
  const float nu_raw = y[2];
  y[2] = jclip(nu_raw, F(-1.0 + 1e-7), F(1.0 - 1e-7));
  float r_c, phi_c, t_c;
  crossing_record<APPROX>(t, r, u, ph, y, r_c, phi_c, t_c);
  float s[6] = {t, r, u, ph, pr, pu};
  int hit = HIT_NONE;
  bool crossed, advance;
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  const bool renorm = (i + 1) % mp.renormalize_every == 0 && hit == HIT_NONE;
  // (the renormalization changes p_r only: s[1], s[2], s[5] are final)
  const float dmin = fabsf(s[1] - r_ph);
  float cto[NOUT];
  inject(crossed, advance, dmin, cto);

  // ---- reverse ----
  float c[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) c[k] = cto[k];
  float g_pph = 0.0f, g_m = 0.0f, g_a = 0.0f, g_rh = 0.0f, g_rph = 0.0f;
  // dmin = |s'[1] - r_ph|
  if (cto[9] != 0.0f) {
    const float sg = sgn(s[1] - r_ph);
    c[1] = c[1] + cto[9] * sg;
    g_rph = -cto[9] * sg;
  }
  // the renormalization of p_r, after the advance
  if (renorm && c[4] != 0.0f) {
    float gp[7];
    renormalize_pr_vjp(m, a, s[1], s[2], y[4], s[5], pph, c[4], gp);
    g_m = gp[0];
    g_a = gp[1];
    c[1] = c[1] + gp[2];
    c[2] = c[2] + gp[3];
    c[4] = gp[4];
    c[5] = c[5] + gp[5];
    g_pph = gp[6];
  }
  // the advance / freeze select: a frozen step is the identity
  float cy[6], cx[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    cy[k] = advance ? c[k] : 0.0f;
    cx[k] = advance ? 0.0f : c[k];
  }
  // the crossing record, where its cotangent is not 0
  const bool xc = cto[6] != 0.0f || cto[7] != 0.0f || cto[8] != 0.0f;
  if (xc) crossing_record_vjp<APPROX>(t, r, u, ph, y, cto[6], cto[7], cto[8],
                                      cx, cy);
  // the jets' emission, from the pre-step state, the stepped one and dlam
  float g_dlam_jet = 0.0f;
  bool jet_on = false;
  if constexpr (JETS) {
    const float x6[6] = {t, r, u, ph, pr, pu};
    jet_on = jet_emission_vjp<APPROX>(*jp, x6, y, dlam, cj, cx, cy,
                                      g_dlam_jet);
  }
  // the midpoint step and its size, where the step's values got any
  if (advance || xc || jet_on) {
    const float x6[6] = {t, r, u, ph, pr, pu};
    float gx[6], g_dlam = JETS ? g_dlam_jet : 0.0f;
    midpoint_step_vjp<APPROX>(mp, m, a, dlam, x6, pph, nu_raw, mid, cy, gx,
                              g_dlam, g_m, g_a, g_pph);
    step_size_vjp<APPROX>(mp, a, r_h, r_ph, r, u, pu, g_dlam, g_a, g_rh,
                          g_rph, gx[1], gx[2], gx[5]);
#pragma unroll
    for (int k = 0; k < 6; ++k) cx[k] = cx[k] + gx[k];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) cin[k] = cx[k];
  cin[6] = g_pph;
  cin[7] = g_m;
  cin[8] = g_a;
  cin[9] = g_rh;
  cin[10] = g_rph;
}
