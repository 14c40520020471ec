// The reverse adjoint (VJP) of one march step, written by hand in float
// and in double (the float64 march's): the gradient kernel's per-step
// derivative (march_grad.cu).
//
// Counterpart of jax.vjp of blackhole_simulation_tpu/ops/pallas_grad.py::
// make_composite (:71), which the Pallas gradient kernel traces at build
// time, and, for the jets' march, of jax.grad through the jets' term of
// the jnp march's step (render/march.py:555-569, which the JAX package
// differentiates by jnp AD; its gradient kernel has no jets).
// march_step_vjp takes the step's inputs x[11] (t, r, u, ph, pr, pu, pph,
// m, a, r_h, r_ph) and returns J^T cto for the output cotangents cto[10]
// (the six state rows, r_c, phi_c, t_c, dmin). It is two halves,
// which the float64 gradient kernel calls apart: step_tape, the step's
// forward with march_step.cuh's own functions, so the forward's values,
// masks and crossing decisions are the replay's bit for bit, keeping in a
// StepTape what the reverse reads (the stepped y, the unclipped u, the last
// midpoint input, dlam, the decisions), from which the caller's inject()
// forms cto; and march_step_vjp_tape, the walk back through the step from
// the tape: the renormalization, the advance/freeze select, the crossing
// record, the midpoint rounds (each ks_rhs_vjp recomputes its own right-
// hand side; rounds before the last recompute their inputs) and the step
// size. On the approx_recip route the forward contracts the step's
// multiply-adds as the forward does (march_step.cuh::madd, with its
// decisions the forward's); the reverse stays uncontracted, its
// derivatives held at relative bars. The plain PyTorch mirror, function for
// function, is ops/march_adjoint.py (the exact route).
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

// Every function here is templated on its scalar R, float or double
// (the float64 march's gradient); the double instantiations take the
// exact route only. A helper's type is its first argument's (same_t: the
// other arguments convert to it, so a float literal passes as a bound).
template <class T>
struct Same {
  typedef T type;
};
template <class T>
using same_t = typename Same<T>::type;

__device__ __forceinline__ float dfloor(float x) { return floorf(x); }
__device__ __forceinline__ double dfloor(double x) { return floor(x); }

// The approximate reciprocal of x on the approx_recip route (APPROX), 0
// (unused) on the exact one, which has none in double.
template <bool APPROX, class R>
__device__ __forceinline__ R rcp_if(R x) {
  if constexpr (APPROX)
    return rcp_approx(x);
  else
    return R(0.0f);
}

// (gx, gy) of jmax(x, y) / jmin(x, y) for the cotangent g.
template <class R>
__device__ __forceinline__ void max_vjp(R x, same_t<R> y, same_t<R> g, R& gx,
                                        R& gy) {
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
template <class R>
__device__ __forceinline__ void min_vjp(R x, same_t<R> y, same_t<R> g, R& gx,
                                        R& gy) {
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
template <class R>
__device__ __forceinline__ R max_vjp_x(R x, same_t<R> y, same_t<R> g) {
  R gx, gy;
  max_vjp(x, y, g, gx, gy);
  return gx;
}
template <class R>
__device__ __forceinline__ R min_vjp_x(R x, same_t<R> y, same_t<R> g) {
  R gx, gy;
  min_vjp(x, y, g, gx, gy);
  return gx;
}
// gx of jclip(x, lo, hi) = jmin(jmax(x, lo), hi), constant bounds.
template <class R>
__device__ __forceinline__ R clip_vjp(R x, same_t<R> lo, same_t<R> hi,
                                          R g) {
  return max_vjp_x(x, lo, min_vjp_x(jmax(x, lo), hi, g));
}
template <class R>
__device__ __forceinline__ R sgn(R x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
// gx of y = recip<APPROX>(x).
template <bool APPROX, class R>
__device__ __forceinline__ R recip_vjp(R x, same_t<R> y, same_t<R> g) {
  if constexpr (APPROX)
    return -y * y * g;
  else
    return -(y * g) / x;
}

// The kernel's per-step cotangent clip of the six carry rows.
template <class R>
__device__ __forceinline__ void clip_carry(R c[6], same_t<R> limit) {
  R ss = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) ss = ss + c[k] * c[k];
  const R norm = dsqrt(ss);
  const R scale = jmin(R(1.0f), limit / jmax(norm, K<R>(1e-30)));
#pragma unroll
  for (int k = 0; k < 6; ++k) c[k] = c[k] * scale;
}

// VJP of ks_rhs (p_t = -1) with the cotangents g[6] of its derivatives:
// d[6] receives the primal, gp the cotangents of (m, a, r, u, pr, pu, pph)
// (overwritten). Its own forward, uncontracted: it reads derivatives, held
// at relative bars, and branches on nothing but w's floor, which both
// routes compute uncontracted.
template <bool APPROX, class R>
__device__ __forceinline__ void ks_rhs_vjp(R m, R a, R r, R u,
                                           R pr, R pu, R pph,
                                           const R g[6], R d[6],
                                           R gp[7]) {
  const R pt = -1.0f;
  const R one_uu = 1.0f - u * u;
  const R w = jmax(one_uu, w_floor<R>());
  const R S = r * r + a * a * u * u;
  const R D = r * r - 2.0f * m * r + a * a;
  const R inv_S = recip<APPROX>(S);
  const R h = 2.0f * m * r * inv_S;
  const R inv_S2 = inv_S * inv_S;
  const R inv_w = recip<APPROX>(w);

  const R S_r = 2.0f * r;
  const R D_r = 2.0f * r - 2.0f * m;
  const R h_r = 2.0f * m * (S - 2.0f * r * r) * inv_S2;
  const R DS_r = (D_r * S - D * S_r) * inv_S2;
  const R invS_r = -S_r * inv_S2;
  const R wS_r = -w * S_r * inv_S2;
  const R invSw_r = -S_r * inv_S2 * inv_w;
  const R S_u = 2.0f * a * a * u;
  const R w_u = -2.0f * u;
  const R h_u = -2.0f * m * r * S_u * inv_S2;
  const R DS_u = -D * S_u * inv_S2;
  const R invS_u = -S_u * inv_S2;
  const R wS_u = (w_u * S - w * S_u) * inv_S2;
  const R iw2 = inv_w * inv_w;
  const R Rw = S_u * w + S * w_u;
  const R invSw_u = -Rw * inv_S2 * iw2;

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
  const R e = -0.5f * g[4];
  const R f = -0.5f * g[5];
  const R g_hr = e * (2.0f * pt * pr - pt * pt);
  const R g_DSr = e * pr * pr;
  const R g_invSr = e * 2.0f * a * pr * pph;
  const R g_wSr = e * pu * pu;
  const R g_invSwr = e * pph * pph;
  const R g_hu = f * (2.0f * pt * pr - pt * pt);
  const R g_DSu = f * pr * pr;
  const R g_invSu = f * 2.0f * a * pr * pph;
  const R g_wSu = f * pu * pu;
  const R g_invSwu = f * pph * pph;
  R gpr = e * (2.0f * h_r * pt + 2.0f * DS_r * pr + 2.0f * a * invS_r * pph) +
              f * (2.0f * h_u * pt + 2.0f * DS_u * pr + 2.0f * a * invS_u * pph);
  R gpph = e * (2.0f * a * invS_r * pr + 2.0f * invSw_r * pph) +
               f * (2.0f * a * invS_u * pr + 2.0f * invSw_u * pph);
  R gpu = e * 2.0f * wS_r * pu + f * 2.0f * wS_u * pu;
  R ga = e * 2.0f * invS_r * pr * pph + f * 2.0f * invS_u * pr * pph;

  // the first-order terms d0 .. d3
  const R g_h = g[0] * (pr - pt) + g[1] * pt;
  gpr = gpr + g[0] * h + g[1] * D * inv_S + g[3] * a * inv_S;
  R g_D = g[1] * inv_S * pr;
  R g_invS = g[1] * (D * pr + a * pph) + g[2] * w * pu +
                 g[3] * (a * pr + pph * inv_w);
  ga = ga + g[1] * inv_S * pph + g[3] * inv_S * pr;
  gpph = gpph + g[1] * a * inv_S + g[3] * inv_S * inv_w;
  R g_w = g[2] * inv_S * pu;
  gpu = gpu + g[2] * w * inv_S;
  R g_invw = g[3] * pph * inv_S;

  // the r-derivative terms
  const R g_Sr = -g_DSr * D * inv_S2 - g_invSr * inv_S2 -
                     g_wSr * w * inv_S2 - g_invSwr * inv_S2 * inv_w;
  const R g_Dr = g_DSr * S * inv_S2;
  R g_S = g_hr * 2.0f * m * inv_S2 + g_DSr * D_r * inv_S2;
  g_D = g_D - g_DSr * S_r * inv_S2;
  R g_invS2 = g_hr * 2.0f * m * (S - 2.0f * r * r) +
                  g_DSr * (D_r * S - D * S_r) - g_invSr * S_r -
                  g_wSr * w * S_r - g_invSwr * S_r * inv_w;
  R gm = g_hr * 2.0f * (S - 2.0f * r * r) * inv_S2;
  R gr = -g_hr * 8.0f * m * r * inv_S2;
  g_w = g_w - g_wSr * S_r * inv_S2;
  g_invw = g_invw - g_invSwr * S_r * inv_S2;

  // the u-derivative terms
  const R g_Su = -g_hu * 2.0f * m * r * inv_S2 - g_DSu * D * inv_S2 -
                     g_invSu * inv_S2 - g_wSu * w * inv_S2 -
                     g_invSwu * w * inv_S2 * iw2;
  const R g_wu = g_wSu * S * inv_S2 - g_invSwu * S * inv_S2 * iw2;
  gm = gm - g_hu * 2.0f * r * S_u * inv_S2;
  gr = gr - g_hu * 2.0f * m * S_u * inv_S2;
  g_D = g_D - g_DSu * S_u * inv_S2;
  g_S = g_S + g_wSu * w_u * inv_S2 - g_invSwu * w_u * inv_S2 * iw2;
  g_w = g_w - g_wSu * S_u * inv_S2 - g_invSwu * S_u * inv_S2 * iw2;
  g_invS2 = g_invS2 - g_hu * 2.0f * m * r * S_u - g_DSu * D * S_u -
            g_invSu * S_u + g_wSu * (w_u * S - w * S_u) - g_invSwu * Rw * iw2;
  g_invw = g_invw - g_invSwu * Rw * inv_S2 * 2.0f * inv_w;

  // S_u = 2 a^2 u, w_u = -2 u, S_r = 2 r, D_r = 2 r - 2 m
  ga = ga + g_Su * 4.0f * a * u;
  R gu = g_Su * 2.0f * a * a - 2.0f * g_wu;
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
  gu = gu - 2.0f * u * max_vjp_x(one_uu, w_floor<R>(), g_w);
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
template <bool APPROX, class R>
__device__ __forceinline__ void midpoint_input(R m, R a, R dlam,
                                               const R x[6], R pph,
                                               int e, R mid[4]) {
  mid[0] = x[1];
  mid[1] = x[2];
  mid[2] = x[4];
  mid[3] = x[5];
  for (int k = 0; k < e; ++k) {
    R d[6];
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
template <bool APPROX, class R>
__device__ __forceinline__ void midpoint_step_vjp(
    const MarchParamsT<R>& mp, R m, R a, R dlam,
    const R x[6], R pph, R nu_raw, const R mid_last[4],
    R gy[6], R gx[6], R& g_dlam, R& gm, R& ga,
    R& gpph) {
  gy[2] = clip_vjp(nu_raw, K<R>(-1.0 + 1e-7), K<R>(1.0 - 1e-7), gy[2]);
#pragma unroll
  for (int k = 0; k < 6; ++k) gx[k] = 0.0f;
  for (int e = mp.midpoint_iters; e >= 0; --e) {
    R mid[4];
    if (e == mp.midpoint_iters) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mid[k] = mid_last[k];
    } else {
      midpoint_input<APPROX>(m, a, dlam, x, pph, e, mid);
    }
    R gd[6], d[6], gp[7];
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
    const R s = e > 0 ? 0.5f : 1.0f;
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
template <bool APPROX, class R>
__device__ __forceinline__ void step_size_vjp(const MarchParamsT<R>& mp,
                                              R a, R r_h,
                                              R r_ph, R r, R u,
                                              R pu, R g, R& ga,
                                              R& grh, R& grph,
                                              R& gr, R& gu,
                                              R& gpu) {
  const R rp = jmax(r_ph, K<R>(1e-3));
  const R inv_rph = 1.0f / rp;
  const R base = (r - r_h) * mp.step_rate;
  const R rf = r / mp.far_boost_radius;
  const R far = jmax(rf, R(1.0f));
  const R dr = r - r_ph;
  const R q = dabs(dr) * inv_rph;
  const R qm = jmax(q, K<R>(0.25));
  const R prox = jmin(qm, R(1.0f));
  const R rr = mp.far_step_cap_rate * r;
  const R cap = mp.far_cap_on ? jmax(rr, mp.max_step) : mp.max_step;
  const R bf = base * far;
  const R v = bf * prox;
  const R vm = jmax(v, mp.min_step);
  const R dl1 = jmin(vm, cap);
  const R one_uu = 1.0f - u * u;
  const R w = jmax(one_uu, w_floor<R>());
  const R sig = madd<APPROX>(r, r, a * a * u * u);
  const R wpu = w * pu;
  const R q2 = wpu / sig;
  const R du_rate = dabs(q2) + K<R>(1e-12);
  const R num = 0.5f * (1.0f - dabs(u) + K<R>(1e-6));
  const R rc = rcp_if<APPROX>(du_rate);
  const R q3 = APPROX ? num * rc : num / du_rate;
  const R lim = jmax(q3, mp.min_step);

  R g_dl1, g_lim;
  min_vjp(dl1, lim, g, g_dl1, g_lim);
  const R g_q3 = max_vjp_x(q3, mp.min_step, g_lim);
  R g_num, g_du;
  if constexpr (APPROX) {
    g_num = g_q3 * rc;
    g_du = -rc * rc * (g_q3 * num);
  } else {
    g_num = g_q3 / du_rate;
    g_du = -(q3 * g_q3) / du_rate;
  }
  gu = gu - sgn(u) * 0.5f * g_num;
  const R g_q2 = sgn(q2) * g_du;
  const R g_wpu = g_q2 / sig;
  const R g_sig = -(q2 * g_q2) / sig;
  const R g_w = g_wpu * pu;
  gpu = gpu + g_wpu * w;
  gr = gr + 2.0f * r * g_sig;
  ga = ga + 2.0f * a * u * u * g_sig;
  gu = gu + 2.0f * a * a * u * g_sig;
  gu = gu - 2.0f * u * max_vjp_x(one_uu, w_floor<R>(), g_w);

  R g_vm, g_cap;
  min_vjp(vm, cap, g_dl1, g_vm, g_cap);
  const R g_v = max_vjp_x(v, mp.min_step, g_vm);
  if (mp.far_cap_on)
    gr = gr + mp.far_step_cap_rate * max_vjp_x(rr, mp.max_step, g_cap);
  const R g_bf = g_v * prox;
  const R g_prox = g_v * bf;
  const R g_base = g_bf * far;
  const R g_far = g_bf * base;
  gr = gr + mp.step_rate * g_base;
  grh = grh - mp.step_rate * g_base;
  gr = gr + max_vjp_x(rf, 1.0f, g_far) / mp.far_boost_radius;
  const R g_q = max_vjp_x(q, K<R>(0.25), min_vjp_x(qm, 1.0f, g_prox));
  const R g_abs = g_q * inv_rph;
  const R g_inv = g_q * dabs(dr);
  const R sg = sgn(dr);
  gr = gr + sg * g_abs;
  grph = grph - sg * g_abs;
  grph = grph + max_vjp_x(r_ph, K<R>(1e-3), recip_vjp<false>(rp, inv_rph, g_inv));
}

// VJP of crossing_record (the equator crossing interpolated between
// (t, r, u, ph) and the stepped, clipped y) with the cotangents of
// (r_c, phi_c, t_c): adds to gx[0..3] (t, r, u, ph) and gy[0..3]. The 1e-12
// guard is a constant.
template <bool APPROX, class R>
__device__ __forceinline__ void crossing_record_vjp(
    R t, R r, R u, R ph, const R y[6],
    R g_rc, R g_pc, R g_tc, R gx[6], R gy[6]) {
  const R du = u - y[2];
  const bool guard = dabs(du) < K<R>(1e-12);
  const R den = guard ? K<R>(1e-12) : du;
  const R rc = rcp_if<APPROX>(den);
  const R x = APPROX ? u * rc : u / den;
  const R xm = jmax(x, R(0.0f));
  const R frac = jmin(xm, R(1.0f));
  const R g_frac =
      g_rc * (y[1] - r) + g_pc * (y[3] - ph) + g_tc * (y[0] - t);
  gx[0] = gx[0] + (g_tc - g_tc * frac);
  gx[1] = gx[1] + (g_rc - g_rc * frac);
  gx[3] = gx[3] + (g_pc - g_pc * frac);
  gy[0] = gy[0] + g_tc * frac;
  gy[1] = gy[1] + g_rc * frac;
  gy[3] = gy[3] + g_pc * frac;
  const R g_x = max_vjp_x(x, 0.0f, min_vjp_x(xm, 1.0f, g_frac));
  R g_den;
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
template <class R>
__device__ __forceinline__ void renormalize_pr_vjp(R m, R a, R r,
                                                   R u, R pr,
                                                   R pu, R pph,
                                                   R g, R gp[7]) {
  const R pt = -1.0f;
  const R one_uu = 1.0f - u * u;
  const R w = jmax(one_uu, w_floor<R>());
  const R S = r * r + a * a * u * u;
  const R D = r * r - 2.0f * m * r + a * a;
  const R inv_S = 1.0f / S;
  const R h = 2.0f * m * r * inv_S;
  const R A = D * inv_S;
  const R B = 2.0f * (h * pt + a * inv_S * pph);
  const R C3 = pph * pph * inv_S / w;
  const R C = -(1.0f + h) * pt * pt + w * inv_S * pu * pu + C3;
  const R disc = B * B - 4.0f * A * C;
  const bool valid = (disc >= 0.0f) && (dabs(A) > K<R>(1e-12));
#pragma unroll
  for (int k = 0; k < 7; ++k) gp[k] = 0.0f;
  if (!valid) {
    gp[4] = g;
    return;
  }
  const R dm = jmax(disc, K<R>(1e-30));
  const R sq = dsqrt(dm);
  const R denom = 2.0f * A;
  const R sol1 = (-B + sq) / denom;
  const R sol2 = (-B - sq) / denom;
  const bool first = dabs(sol1 - pr) < dabs(sol2 - pr);
  const R sol = first ? sol1 : sol2;
  const R pm = first ? 1.0f : -1.0f;

  const R g_num = g / denom;
  R g_A = 2.0f * (-(sol * g) / denom);
  R g_B = -g_num;
  const R g_sq = pm * g_num;
  const R g_disc = max_vjp_x(disc, K<R>(1e-30), g_sq * 0.5f / sq);
  g_B = g_B + 2.0f * B * g_disc;
  g_A = g_A - 4.0f * C * g_disc;
  const R g_C = -4.0f * A * g_disc;
  const R g_h = -pt * pt * g_C + 2.0f * pt * g_B;
  const R g_w = inv_S * pu * pu * g_C - (C3 / w) * g_C;
  R g_invS = w * pu * pu * g_C + pph * pph / w * g_C;
  const R gpu = 2.0f * w * inv_S * pu * g_C;
  const R gpph = 2.0f * pph * inv_S / w * g_C + 2.0f * a * inv_S * g_B;
  R ga = 2.0f * inv_S * pph * g_B;
  g_invS = g_invS + 2.0f * a * pph * g_B + D * g_A;
  const R g_D = inv_S * g_A;
  R gm = 2.0f * r * inv_S * g_h;
  R gr = 2.0f * m * inv_S * g_h;
  g_invS = g_invS + 2.0f * m * r * g_h;
  const R g_S = recip_vjp<false>(S, inv_S, g_invS);
  gr = gr + (2.0f * r - 2.0f * m) * g_D + 2.0f * r * g_S;
  gm = gm - 2.0f * r * g_D;
  ga = ga + 2.0f * a * g_D + 2.0f * a * u * u * g_S;
  const R gu =
      2.0f * a * a * u * g_S - 2.0f * u * max_vjp_x(one_uu, w_floor<R>(), g_w);
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
// is recomputed with the same operations in the same order, so the
// cone test is the forward's. What has no derivative takes JAX's:
// in_cone and the live mask select, sign(z) is a constant, floor has
// derivative 0 (so the hashed lattice values are constants and fract's
// derivative is 1), the floored modulo's is 1; clip passes nothing outside
// its range and half at a tie (clip_vjp); |x| takes sign(0) = 0. The
// profile's exp and the beaming power are the forward's (float on the
// approx_recip route, through double on the exact one); their derivatives
// are formed from those values, exp(x) and p beam / delta.
template <bool APPROX, class R>
__device__ __forceinline__ bool jet_emission_vjp(const JetParamsT<R>& jp,
                                                 const R x[6],
                                                 const R y[6],
                                                 R dlam, const R cj[3],
                                                 R gx[6], R gy[6],
                                                 R& g_dlam) {
  const R r = x[1], u = x[2], ph = x[3];
  const R inv = recip<APPROX>(dlam);
  const R wj = jmax(1.0f - u * u, w_floor<R>());
  const R st = dsqrt(wj);
  const R ct = u;
  const R ddr = y[1] - r;
  const R ddu = y[2] - u;
  const R ddp = y[3] - ph;
  const R dr = ddr * inv;
  const R dth = -ddu * inv / st;
  const R dph = ddp * inv;
  // jet_emission, kept
  const R z = r * ct;
  const R rs = r * st;
  const R rho = dabs(rs);
  const R az = dabs(z);
  const R cone_r = jp.core_radius + jp.opening_slope * az;
  const bool in_cone =
      (az > jp.z_min) && (az < jp.z_max) && (rho < K<R>(2.5) * cone_r);
  const R g_mag = K<R>(0.62) * cj[0] + K<R>(0.74) * cj[1] + cj[2];
  if (!in_cone || g_mag == 0.0f) return false;
  const R crm = jmax(cone_r, K<R>(1e-3));
  const R q = rho / crm;
  R profile;
  if constexpr (APPROX)
    profile = expf(-(q * q));
  else
    profile = exact_exp(-(q * q));
  const R v_z = dr * ct - r * st * dth;
  const R v_rho = dr * st + r * ct * dth;
  const R v_ph = r * st * dph;
  const R v_mag = dsqrt(v_z * v_z + v_rho * v_rho + v_ph * v_ph +
                            K<R>(1e-12));
  const R sg = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const R cos_psi = -sg * v_z / v_mag;
  const R den =
      jp.gamma * (1.0f - jp.beta * jclip(cos_psi, R(-1.0f), R(1.0f)));
  const R delta = 1.0f / den;
  const R nx = az * K<R>(0.8);
  const R ny =
      shade::remainder_(shade::val(ph), 6.283185307179586).v * 2.0f + az;
  const R xf = dfloor(nx), yf = dfloor(ny);
  const R fx = nx - xf, fy = ny - yf;
  const R tx = shade::smooth_(shade::val(fx)).v;
  const R ty = shade::smooth_(shade::val(fy)).v;
  // the lattice hash of float32 inputs (shade::value_noise2's)
  const R c00 = shade::hash21((float)xf, (float)yf);
  const R c10 = shade::hash21((float)(xf + 1.0f), (float)yf);
  const R c01 = shade::hash21((float)xf, (float)(yf + 1.0f));
  const R c11 = shade::hash21((float)(xf + 1.0f), (float)(yf + 1.0f));
  const R noise = c00 * (1.0f - tx) * (1.0f - ty) +
                      c10 * tx * (1.0f - ty) + c01 * (1.0f - tx) * ty +
                      c11 * tx * ty;
  const R turb = jp.one_minus_turb + jp.turbulence * (0.5f + noise);
  const R dd = jp.density * dlam;
  const R pre = dd * profile * turb;
  R beam;
  if constexpr (APPROX)
    beam = powf(delta, jp.beaming_exponent);
  else
    beam = exact_pow(delta, jp.beaming_exponent);

  // ---- reverse: mag = pre * beam, the channels 0.62, 0.74, 1 of mag ----
  const R g_pre = g_mag * beam;
  const R g_beam = g_mag * pre;
  const R g_delta = g_beam * (jp.beaming_exponent * beam / delta);
  const R g_den = -(delta * g_delta) / den;
  const R g_cc = -(jp.gamma * jp.beta) * g_den;
  const R g_cos = clip_vjp(cos_psi, -1.0f, 1.0f, g_cc);
  // cos_psi = (-sg v_z) / v_mag
  R g_vz = (-sg) * g_cos / v_mag;
  const R g_vmag = -(cos_psi * g_cos) / v_mag;
  const R g_vsum = g_vmag * 0.5f / v_mag;
  g_vz = g_vz + 2.0f * v_z * g_vsum;
  const R g_vrho = 2.0f * v_rho * g_vsum;
  const R g_vph = 2.0f * v_ph * g_vsum;
  // pre = density dlam profile turb
  g_dlam = g_dlam + g_pre * jp.density * profile * turb;
  const R g_profile = g_pre * dd * turb;
  const R g_turb = g_pre * dd * profile;
  // the noise octave: d/dtx, d/dty of the bilinear blend, smooth' = 6t(1-t)
  const R g_noise = g_turb * jp.turbulence;
  const R dn_tx = (c10 - c00) * (1.0f - ty) + (c11 - c01) * ty;
  const R dn_ty = (c01 - c00) * (1.0f - tx) + (c11 - c10) * tx;
  const R g_nx = g_noise * dn_tx * (6.0f * fx * (1.0f - fx));
  const R g_ny = g_noise * dn_ty * (6.0f * fy * (1.0f - fy));
  R g_az = K<R>(0.8) * g_nx + g_ny;
  R g_ph = 2.0f * g_ny;
  // profile = exp(-q^2), q = rho / max(cone_r, 1e-3)
  const R g_q = -2.0f * q * profile * g_profile;
  R g_rho = g_q / crm;
  const R g_crm = -(q * g_q) / crm;
  g_az = g_az + jp.opening_slope * max_vjp_x(cone_r, K<R>(1e-3), g_crm);
  // the ray's direction: v_z, v_rho, v_ph of (dr, dth, dph) at (r, st, ct)
  const R g_dr = g_vz * ct + g_vrho * st;
  R g_ct = g_vz * dr + g_vrho * r * dth;
  R g_r = -g_vz * st * dth + g_vrho * ct * dth + g_vph * st * dph;
  R g_st = -g_vz * r * dth + g_vrho * dr + g_vph * r * dph;
  const R g_dth = -g_vz * r * st + g_vrho * r * ct;
  const R g_dph = g_vph * r * st;
  // z = r ct, az = |z|; rho = |r st|
  const R g_z = sgn(z) * g_az;
  g_r = g_r + g_z * ct;
  g_ct = g_ct + g_z * r;
  g_rho = sgn(rs) * g_rho;
  g_r = g_r + g_rho * st;
  g_st = g_st + g_rho * r;
  // dth = (-(y_u - u) inv) / st, dr = (y_r - r) inv, dph = (y_ph - ph) inv
  const R g_num = g_dth / st;
  g_st = g_st - (dth * g_dth) / st;
  R g_inv = g_num * (-ddu) + g_dr * ddr + g_dph * ddp;
  gy[1] = gy[1] + g_dr * inv;
  g_r = g_r - g_dr * inv;
  gy[2] = gy[2] - g_num * inv;
  R g_u = g_ct + g_num * inv;
  gy[3] = gy[3] + g_dph * inv;
  g_ph = g_ph - g_dph * inv;
  g_dlam = g_dlam + recip_vjp<APPROX>(dlam, inv, g_inv);
  // st = sqrt(max(1 - u^2, 1e-6))
  const R g_wj = g_st * 0.5f / st;
  g_u = g_u - 2.0f * u * max_vjp_x(1.0f - u * u, w_floor<R>(), g_wj);
  gx[1] = gx[1] + g_r;
  gx[2] = gx[2] + g_u;
  gx[3] = gx[3] + g_ph;
  return true;
}

// What the reverse of one live march step reads of its forward (the
// gradient kernel's tape): the step size, the last midpoint evaluation's
// input, the stepped rows with u clipped, the unclipped u, and the step's
// decisions (crossed, advance, and whether the renormalization of p_r is
// due after it).
template <class R>
struct StepTape {
  R dlam;
  R mid[4];
  R y[6];
  R nu_raw;
  bool crossed, advance, renorm;
};

// The forward of one live step at step index i from the state x[6] =
// (t, r, u, ph, pr, pu) with the pre-step crossing count nc: march_step's
// functions in march_step's order (step_size, the midpoint rounds, the
// clip, crossing_record, advance_step), so its values and decisions are
// the march's bit for bit. Fills the tape tp and returns the post-step
// state s[6] (x advanced, or x where the step froze) and hit, before the
// renormalization, which tp.renorm says is due: a caller that marches on
// applies it (ks_renormalize_pr on s).
template <bool APPROX, class R>
__device__ __forceinline__ void step_tape(const MarchParamsT<R>& mp, R m,
                                          R a, R r_h, R r_ph, R inv_rph,
                                          R pph, R thr, int i,
                                          const R x[6], int nc,
                                          StepTape<R>& tp, R s[6],
                                          int& hit) {
  const R t = x[0], r = x[1], u = x[2], ph = x[3], pr = x[4], pu = x[5];
  tp.dlam = step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, r, u, pu);
  R d[6];
  ks_rhs<APPROX>(m, a, r, u, pr, pu, pph, d);
  advance_rows<APPROX>(tp.dlam, t, r, u, ph, pr, pu, d, tp.y);
  tp.mid[0] = r;
  tp.mid[1] = u;
  tp.mid[2] = pr;
  tp.mid[3] = pu;
  for (int it = 0; it < mp.midpoint_iters; ++it) {
    tp.mid[0] = 0.5f * (r + tp.y[1]);
    tp.mid[1] = 0.5f * (u + tp.y[2]);
    tp.mid[2] = 0.5f * (pr + tp.y[4]);
    tp.mid[3] = 0.5f * (pu + tp.y[5]);
    ks_rhs<APPROX>(m, a, tp.mid[0], tp.mid[1], tp.mid[2], tp.mid[3], pph, d);
    advance_rows<APPROX>(tp.dlam, t, r, u, ph, pr, pu, d, tp.y);
  }
  tp.nu_raw = tp.y[2];
  tp.y[2] = jclip(tp.nu_raw, K<R>(-1.0 + 1e-7), K<R>(1.0 - 1e-7));
  R r_c, phi_c, t_c;
  crossing_record<APPROX>(t, r, u, ph, tp.y, r_c, phi_c, t_c);
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = x[k];
  hit = HIT_NONE;
  advance_step(mp, thr, s, tp.y, r_c, hit, nc, tp.crossed, tp.advance);
  tp.renorm = (i + 1) % mp.renormalize_every == 0 && hit == HIT_NONE;
}

// The photon-ring proximity |r' - r_ph| after a step, r' the stepped
// radius, or r where the step froze (the renormalization moves p_r only).
template <class R>
__device__ __forceinline__ R step_dmin(const StepTape<R>& tp, R r, R r_ph) {
  return dabs((tp.advance ? tp.y[1] : r) - r_ph);
}

// J^T cto of one live march step from its tape (step_tape's, at the
// step's inputs x[NIN] = (t, r, u, ph, pr, pu, pph, m, a, r_h, r_ph)),
// with the output cotangents cto[NOUT]: the renormalization, the
// advance/freeze select, the crossing record, the jets' emission (JETS:
// jet_emission_vjp with cj[3], the jet radiance's cotangent, jp its
// configuration) and the midpoint step and its size, walked back. Nothing
// of the step's forward is recomputed: each ks_rhs_vjp recomputes its own
// right-hand side, the midpoint rounds before the last their inputs. cin[NIN]
// receives the input cotangents.
template <bool APPROX, bool JETS = false, class R>
__device__ __forceinline__ void march_step_vjp_tape(
    const MarchParamsT<R>& mp, const R x[NIN], const StepTape<R>& tp,
    const R cto[NOUT], R cin[NIN], const JetParamsT<R>* jp = nullptr,
    const R* cj = nullptr) {
  const R t = x[0], r = x[1], u = x[2], ph = x[3], pr = x[4], pu = x[5];
  const R pph = x[6], m = x[7], a = x[8], r_h = x[9], r_ph = x[10];
  const R* y = tp.y;
  R c[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) c[k] = cto[k];
  R g_pph = 0.0f, g_m = 0.0f, g_a = 0.0f, g_rh = 0.0f, g_rph = 0.0f;
  // dmin = |s'[1] - r_ph|
  if (cto[9] != 0.0f) {
    const R sg = sgn((tp.advance ? y[1] : r) - r_ph);
    c[1] = c[1] + cto[9] * sg;
    g_rph = -cto[9] * sg;
  }
  // the renormalization of p_r, after the advance (renorm implies it: the
  // post-step state is y)
  if (tp.renorm && c[4] != 0.0f) {
    R gp[7];
    renormalize_pr_vjp(m, a, y[1], y[2], y[4], y[5], pph, c[4], gp);
    g_m = gp[0];
    g_a = gp[1];
    c[1] = c[1] + gp[2];
    c[2] = c[2] + gp[3];
    c[4] = gp[4];
    c[5] = c[5] + gp[5];
    g_pph = gp[6];
  }
  // the advance / freeze select: a frozen step is the identity
  R cy[6], cx[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    cy[k] = tp.advance ? c[k] : 0.0f;
    cx[k] = tp.advance ? 0.0f : c[k];
  }
  // the crossing record, where its cotangent is not 0
  const bool xc = cto[6] != 0.0f || cto[7] != 0.0f || cto[8] != 0.0f;
  if (xc) crossing_record_vjp<APPROX>(t, r, u, ph, y, cto[6], cto[7], cto[8],
                                      cx, cy);
  // the jets' emission, from the pre-step state, the stepped one and dlam
  R g_dlam_jet = 0.0f;
  bool jet_on = false;
  if constexpr (JETS) {
    const R x6[6] = {t, r, u, ph, pr, pu};
    jet_on = jet_emission_vjp<APPROX>(*jp, x6, y, tp.dlam, cj, cx, cy,
                                      g_dlam_jet);
  }
  // the midpoint step and its size, where the step's values got any
  if (tp.advance || xc || jet_on) {
    const R x6[6] = {t, r, u, ph, pr, pu};
    R gx[6], g_dlam = JETS ? g_dlam_jet : 0.0f;
    midpoint_step_vjp<APPROX>(mp, m, a, tp.dlam, x6, pph, tp.nu_raw, tp.mid,
                              cy, gx, g_dlam, g_m, g_a, g_pph);
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

// J^T cto of one live march step (march_step at step i with the pre-step
// crossing count nc) at x[NIN]: its forward (step_tape), then
// inject(crossed, advance, dmin, cto), which fills the output cotangents
// cto[NOUT] as the gradient kernel injects its crossing and r_min
// cotangents there, then the reverse from the tape (march_step_vjp_tape).
// cin[NIN] receives the input cotangents. With JETS the step is the jets'
// (jets_advance: the same state update, plus the emission from the
// pre-step state, the stepped one and dlam, on every live step, also one
// that the sanity test freezes): cj[3], the jet radiance's cotangent, adds
// the emission's VJP (jet_emission_vjp, jp its configuration).
template <bool APPROX, bool JETS = false, class Inject, class R>
__device__ __forceinline__ void march_step_vjp(const MarchParamsT<R>& mp,
                                               const R x[NIN], R thr,
                                               int i, int nc, Inject inject,
                                               R cin[NIN],
                                               const JetParamsT<R>* jp = nullptr,
                                               const R* cj = nullptr) {
  const R r = x[1], r_ph = x[10];
  StepTape<R> tp;
  R s[6];
  int hit;
  step_tape<APPROX>(mp, x[7], x[8], x[9], r_ph, inv_rph_of(r_ph), x[6], thr,
                    i, x, nc, tp, s, hit);
  R cto[NOUT];
  inject(tp.crossed, tp.advance, step_dmin(tp, r, r_ph), cto);
  march_step_vjp_tape<APPROX, JETS>(mp, x, tp, cto, cin, jp, cj);
}
