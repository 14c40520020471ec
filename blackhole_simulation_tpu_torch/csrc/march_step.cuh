// The geodesic march step, shared by every kernel of the port: the render
// kernel (render.cu), the march kernel (march.cu) and the gradient kernel
// (march_grad.cu). One source for the step is what keeps the three in step
// with each other: the gradient kernel's replay lands its masks, crossing
// slots and freeze points on the same steps as the forward march, and the
// render kernel's march is the march kernel's.
//
// A ray is marched in one loop (march_ray, march_ray_ab3: the render
// kernel's one thread per pixel) or a step at a time (MarchRay, ray_begin,
// ray_step: the march kernel's persistent warps, which hand a lane the next
// ray when its own ends). Both run the same step bodies (march_step with
// record_step, jets_advance, ab3_step) in the same order; the step-level
// form carries what the loops keep in locals, AB3's right-hand-side
// histories and step sizes among them, as per-lane state.
//
// Why two forms: each writes its own prologue (the records cleared) and
// end-of-march rule (AB3's tail renormalization, then hit = HIT_HORIZON),
// so a change to either must be made in both (march_ray and march_ray_ab3
// against ray_begin and ray_close). The render kernel built on the step
// form alone (ray_begin, then one step at a time until the ray ends)
// compiled to more registers than on the loops, nvcc for sm_90a: with the
// end-of-march rule in the loop, 61 against 56 on the flagship
// instantiation; with it once after the loop, 56, but 16 + 24 bytes of
// spill on the AB3 instantiation and 10 + 12 on jets with extras, where
// the loops have none (every MarchRay field order and loop shape tried
// read the same). chip_smoke.py fails on a spill and pins the flagship at
// 56, so the render kernel keeps the loops.
//
// Counterpart of blackhole_simulation_tpu/ops/ks_kernel.py (ks_rhs_rows,
// ks_symplectic_step_rows, ks_renormalize_pr), ops/pallas_march.py
// (diff_step_values, start_offset_rows, march_tile with its jets,
// march_tile_ab3), ops/pallas_grad.py (make_composite) and
// render/shading.py (hash21, value_noise2, jet_emission_step).
// The plain PyTorch versions are ops/ks_kernel.py and ops/march.py; every
// expression here is written in their order, so the two round alike.
//
// The step math is templated on its scalar type: float for the forward
// march, Dual<N> (a value and N forward-mode tangents) for the per-step
// Jacobian of step_vjp_check.cu, the card's check of the gradient kernel's
// hand-written reverse adjoint (march_adjoint.cuh). A Dual's value is
// computed by the same float operations in the same order as the float
// instantiation, so a dual pass reproduces the forward's values bit for
// bit.
//
// jnp semantics: maximum/minimum/clip propagate NaN (the march's sanity
// freeze relies on NaN reaching isfinite) and, for tangents, split the
// derivative half and half at ties, as JAX's rules do. The floored modulo
// is jnp.mod's own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Constants are written as (float)(double literal): rounded to float32 from
// the double value, as PyTorch and JAX round a Python float.
#define F(x) ((float)(x))

#define HIT_NONE 0
#define HIT_HORIZON 1
#define HIT_ESCAPE 2
#define KMAX 4

// The static march configuration. Must match ops/pallas_march.py::
// _CMarchParams field for field. multistep selects the AB3 march;
// ab3_renorm_every and ab3_tail_renorm are its renormalization cadence
// (ops/march.py::ab3_renorm_plan).
struct MarchParams {
  int max_steps, renormalize_every, max_crossings, midpoint_iters,
      approx_recip, far_cap_on, multistep, ab3_renorm_every, ab3_tail_renorm;
  float step_rate, min_step, max_step, far_step_cap_rate, far_boost_radius,
      escape_radius, escape_sanity_r, record_r_min, record_r_max;
};

// The jets' static configuration (shading.JetParams, each field rounded to
// float32; gamma and one_minus_turb rounded from float64). Must match
// ops/pallas_march.py::_CJetParams field for field.
struct JetParams {
  float core_radius, opening_slope, z_min, z_max, density, turbulence,
      one_minus_turb, gamma, beta, beaming_exponent;
};

// ---------------------------------------------------------------------------
// Forward-mode dual numbers
// ---------------------------------------------------------------------------

template <int N>
struct Dual {
  float v;
  float d[N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
  }
};

#define DUAL_LOOP _Pragma("unroll") for (int i = 0; i < N; ++i)

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> o;
  o.v = -a.v;
  DUAL_LOOP o.d[i] = -a.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a.v + b.v;
  DUAL_LOOP o.d[i] = a.d[i] + b.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> o;
  o.v = a.v + b;
  DUAL_LOOP o.d[i] = a.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a + b.v;
  DUAL_LOOP o.d[i] = b.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a.v - b.v;
  DUAL_LOOP o.d[i] = a.d[i] - b.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> o;
  o.v = a.v - b;
  DUAL_LOOP o.d[i] = a.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a - b.v;
  DUAL_LOOP o.d[i] = -b.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a.v * b.v;
  DUAL_LOOP o.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> o;
  o.v = a.v * b;
  DUAL_LOOP o.d[i] = a.d[i] * b;
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a * b.v;
  DUAL_LOOP o.d[i] = a * b.d[i];
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a.v / b.v;
  DUAL_LOOP o.d[i] = (a.d[i] - o.v * b.d[i]) / b.v;
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> o;
  o.v = a.v / b;
  DUAL_LOOP o.d[i] = a.d[i] / b;
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a / b.v;
  DUAL_LOOP o.d[i] = -(o.v * b.d[i]) / b.v;
  return o;
}

// ---------------------------------------------------------------------------
// jnp semantics, for float and for Dual
// ---------------------------------------------------------------------------

__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
// Ties split the tangent half and half (JAX's rule for max and min).
template <int N>
__device__ __forceinline__ Dual<N> jtie(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> o;
  o.v = a.v;
  DUAL_LOOP o.d[i] = 0.5f * (a.d[i] + b.d[i]);
  return o;
}
template <int N>
__device__ __forceinline__ Dual<N> jmax(const Dual<N>& a, const Dual<N>& b) {
  if (a.v == b.v) return jtie(a, b);
  return (a.v > b.v || a.v != a.v) ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> jmin(const Dual<N>& a, const Dual<N>& b) {
  if (a.v == b.v) return jtie(a, b);
  return (a.v < b.v || a.v != a.v) ? a : b;
}
template <int N>
__device__ __forceinline__ Dual<N> jclip(const Dual<N>& x, const Dual<N>& lo,
                                         const Dual<N>& hi) {
  return jmin(jmax(x, lo), hi);
}

__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
template <int N>
__device__ __forceinline__ Dual<N> dabs(const Dual<N>& x) {
  // d|x| = sign(x) dx, with sign(0) = 0 (jnp.sign)
  const float s = x.v > 0.0f ? 1.0f : (x.v < 0.0f ? -1.0f : 0.0f);
  Dual<N> o;
  o.v = fabsf(x.v);
  DUAL_LOOP o.d[i] = s * x.d[i];
  return o;
}

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
template <int N>
__device__ __forceinline__ Dual<N> dsqrt(const Dual<N>& x) {
  Dual<N> o;
  o.v = sqrtf(x.v);
  DUAL_LOOP o.d[i] = x.d[i] * 0.5f / o.v;
  return o;
}

__device__ __forceinline__ float fmod_floor(float x, float y) {
  float md = fmodf(x, y);
  if (md != 0.0f && ((md < 0.0f) != (y < 0.0f))) md += y;
  return md;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// d(1/x) = -y^2 dx with the approximate y itself (pallas_march.py:127-133).
template <int N>
__device__ __forceinline__ Dual<N> rcp_approx(const Dual<N>& x) {
  Dual<N> o;
  o.v = rcp_approx(x.v);
  const float g = -o.v * o.v;
  DUAL_LOOP o.d[i] = g * x.d[i];
  return o;
}
template <class T>
__device__ __forceinline__ T recip(const T& x, bool approx) {
  return approx ? rcp_approx(x) : 1.0f / x;
}
template <class T>
__device__ __forceinline__ T divr(const T& num, const T& den, bool approx) {
  return approx ? num * rcp_approx(den) : num / den;
}

// ---------------------------------------------------------------------------
// Lattice hash noise (render/shading.py): the starfield, the disk's
// turbulence, the jets' noise and the start offset's hash
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fract(float x) { return x - floorf(x); }

__device__ float hash21(float x, float y) {
  x = x + 0.5f;
  y = y + 0.5f;
  float px = fract(x * F(0.1031));
  float py = fract(y * F(0.1030));
  float pz = fract((x + y) * F(0.0973));
  float d = px * (py + F(33.33)) + py * (pz + F(33.33)) + pz * (px + F(33.33));
  return fract((px + py + 2.0f * d) * (pz + d));
}

__device__ __forceinline__ float smooth(float t) {
  return t * t * (3.0f - 2.0f * t);
}

__device__ float value_noise2(float x, float y) {
  float xf = floorf(x), yf = floorf(y);
  float tx = smooth(x - xf), ty = smooth(y - yf);
  float c00 = hash21(xf, yf);
  float c10 = hash21(xf + 1.0f, yf);
  float c01 = hash21(xf, yf + 1.0f);
  float c11 = hash21(xf + 1.0f, yf + 1.0f);
  return c00 * (1.0f - tx) * (1.0f - ty) + c10 * tx * (1.0f - ty) +
         c01 * (1.0f - tx) * ty + c11 * tx * ty;
}

// ---------------------------------------------------------------------------
// Step math (ops/ks_kernel.py), p_t = -1
// ---------------------------------------------------------------------------

template <class T>
__device__ __forceinline__ void ks_rhs(const T& m, const T& a, const T& r,
                                       const T& u, const T& pr, const T& pu,
                                       const T& pph, bool approx, T d[6]) {
  const float pt = -1.0f;
  T w = jmax(1.0f - u * u, T(F(1e-6)));
  T S = r * r + a * a * u * u;
  T D = r * r - 2.0f * m * r + a * a;
  T inv_S = recip(S, approx);
  T h = 2.0f * m * r * inv_S;
  T inv_S2 = inv_S * inv_S;
  T inv_w = recip(w, approx);

  d[0] = -(1.0f + h) * pt + h * pr;
  d[1] = h * pt + D * inv_S * pr + a * inv_S * pph;
  d[2] = w * inv_S * pu;
  d[3] = a * inv_S * pr + pph * inv_S * inv_w;

  T S_r = 2.0f * r;
  T D_r = 2.0f * r - 2.0f * m;
  T h_r = 2.0f * m * (S - 2.0f * r * r) * inv_S2;
  T DS_r = (D_r * S - D * S_r) * inv_S2;
  T invS_r = -S_r * inv_S2;
  T wS_r = -w * S_r * inv_S2;
  T invSw_r = -S_r * inv_S2 * inv_w;
  T dH_dr = 0.5f * (-h_r * pt * pt + 2.0f * h_r * pt * pr +
                    DS_r * pr * pr + 2.0f * a * invS_r * pr * pph +
                    wS_r * pu * pu + invSw_r * pph * pph);

  T S_u = 2.0f * a * a * u;
  T w_u = -2.0f * u;
  T h_u = -2.0f * m * r * S_u * inv_S2;
  T DS_u = -D * S_u * inv_S2;
  T invS_u = -S_u * inv_S2;
  T wS_u = (w_u * S - w * S_u) * inv_S2;
  T invSw_u = -(S_u * w + S * w_u) * inv_S2 * inv_w * inv_w;
  T dH_du = 0.5f * (-h_u * pt * pt + 2.0f * h_u * pt * pr +
                    DS_u * pr * pr + 2.0f * a * invS_u * pr * pph +
                    wS_u * pu * pu + invSw_u * pph * pph);
  d[4] = -dH_dr;
  d[5] = -dH_du;
}

// Null projection of p_r (exact divides always).
template <class T>
__device__ __forceinline__ T ks_renormalize_pr(const T& m, const T& a,
                                               const T& r, const T& u,
                                               const T& pr, const T& pu,
                                               const T& pph) {
  const float pt = -1.0f;
  T w = jmax(1.0f - u * u, T(F(1e-6)));
  T S = r * r + a * a * u * u;
  T D = r * r - 2.0f * m * r + a * a;
  T inv_S = 1.0f / S;
  T h = 2.0f * m * r * inv_S;
  T A = D * inv_S;
  T B = 2.0f * (h * pt + a * inv_S * pph);
  T C = -(1.0f + h) * pt * pt + w * inv_S * pu * pu + pph * pph * inv_S / w;
  T disc = B * B - 4.0f * A * C;
  bool valid = (val(disc) >= 0.0f) && (fabsf(val(A)) > F(1e-12));
  T sqrt_d = dsqrt(valid ? jmax(disc, T(F(1e-30))) : T(1.0f));
  T denom = valid ? 2.0f * A : T(1.0f);
  T sol1 = (-B + sqrt_d) / denom;
  T sol2 = (-B - sqrt_d) / denom;
  T nearest = fabsf(val(sol1) - val(pr)) < fabsf(val(sol2) - val(pr)) ? sol1
                                                                      : sol2;
  return valid ? nearest : pr;
}

// ---------------------------------------------------------------------------
// One march step (pallas_march.py::diff_step_values and the body of
// march_tile / pallas_grad.py::make_composite)
// ---------------------------------------------------------------------------

// The curvature-adaptive, pole-throttled step size.
template <class T>
__device__ __forceinline__ T step_size(const MarchParams& mp, bool approx,
                                       const T& a, const T& r_h,
                                       const T& r_ph, const T& r, const T& u,
                                       const T& pu) {
  T inv_rph = 1.0f / jmax(r_ph, T(F(1e-3)));
  T base = (r - r_h) * mp.step_rate;
  T far = jmax(r / mp.far_boost_radius, T(1.0f));
  T prox = jclip(dabs(r - r_ph) * inv_rph, T(F(0.25)), T(1.0f));
  T cap = mp.far_cap_on ? jmax(mp.far_step_cap_rate * r, T(mp.max_step))
                        : T(mp.max_step);
  T dlam = jclip(base * far * prox, T(mp.min_step), cap);
  T w = jmax(1.0f - u * u, T(F(1e-6)));
  T sig = r * r + a * a * u * u;
  T du_rate = dabs(w * pu / sig) + F(1e-12);
  T margin = 1.0f - dabs(u) + F(1e-6);
  return jmin(dlam, jmax(divr(0.5f * margin, du_rate, approx), T(mp.min_step)));
}

// The implicit-midpoint step of size dlam, u clipped off the poles.
template <class T>
__device__ __forceinline__ void midpoint_step(
    const MarchParams& mp, bool approx, const T& m, const T& a,
    const T& dlam, const T& t, const T& r, const T& u, const T& ph,
    const T& pr, const T& pu, const T& pph, T y[6]) {
  T d[6];
  ks_rhs(m, a, r, u, pr, pu, pph, approx, d);
  T nt = t + dlam * d[0];
  T nr = r + dlam * d[1];
  T nu = u + dlam * d[2];
  T nph = ph + dlam * d[3];
  T npr = pr + dlam * d[4];
  T npu = pu + dlam * d[5];
  for (int it = 0; it < mp.midpoint_iters; ++it) {
    ks_rhs(m, a, 0.5f * (r + nr), 0.5f * (u + nu), 0.5f * (pr + npr),
           0.5f * (pu + npu), pph, approx, d);
    nt = t + dlam * d[0];
    nr = r + dlam * d[1];
    nu = u + dlam * d[2];
    nph = ph + dlam * d[3];
    npr = pr + dlam * d[4];
    npu = pu + dlam * d[5];
  }
  y[0] = nt;
  y[1] = nr;
  y[2] = jclip(nu, T(F(-1.0 + 1e-7)), T(F(1.0 - 1e-7)));
  y[3] = nph;
  y[4] = npr;
  y[5] = npu;
}

// The equator-crossing record interpolated between (t, r, u, ph) and the
// stepped y.
template <class T>
__device__ __forceinline__ void crossing_record(bool approx, const T& t,
                                                const T& r, const T& u,
                                                const T& ph, const T y[6],
                                                T& r_c, T& phi_c, T& t_c) {
  const T& nu = y[2];
  T frac = jclip(
      divr(u, fabsf(val(u - nu)) < F(1e-12) ? T(F(1e-12)) : u - nu, approx),
      T(0.0f), T(1.0f));
  r_c = r + frac * (y[1] - r);
  phi_c = ph + frac * (y[3] - ph);
  t_c = t + frac * (y[0] - t);
}

// The stepped state and the interpolated equator-crossing record.
template <class T>
__device__ __forceinline__ void step_values(
    const MarchParams& mp, bool approx, const T& m, const T& a, const T& r_h,
    const T& r_ph, const T& t, const T& r, const T& u, const T& ph,
    const T& pr, const T& pu, const T& pph, T y[6], T& r_c, T& phi_c,
    T& t_c) {
  T dlam = step_size(mp, approx, a, r_h, r_ph, r, u, pu);
  midpoint_step(mp, approx, m, a, dlam, t, r, u, ph, pr, pu, pph, y);
  crossing_record(approx, t, r, u, ph, y, r_c, phi_c, t_c);
}

// The step's epilogue on a live ray: the crossing test against the pre-step
// crossing count nc, the sanity freeze, the advance of s to y and the
// termination tests.
template <class T>
__device__ __forceinline__ void advance_step(const MarchParams& mp, float thr,
                                             T s[6], const T y[6],
                                             const T& r_c, int& hit, int nc,
                                             bool& crossed, bool& advance) {
  crossed = ((val(s[2]) * val(y[2])) < 0.0f) && (nc < mp.max_crossings) &&
            (val(r_c) > mp.record_r_min) && (val(r_c) < mp.record_r_max);
  advance = isfinite(val(y[1])) && isfinite(val(y[3])) &&
            isfinite(val(y[4])) && isfinite(val(y[5])) &&
            (fabsf(val(y[4])) < F(1e7)) && (fabsf(val(y[5])) < F(1e7)) &&
            (val(y[1]) < mp.escape_sanity_r);
  if (advance) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = y[k];
  } else {
    hit = HIT_HORIZON;
  }
  if (val(s[1]) < thr) hit = HIT_HORIZON;
  if (val(s[1]) > mp.escape_radius) hit = HIT_ESCAPE;
}

// One step of a live ray (hit == HIT_NONE on entry), step index i: the
// step values, the crossing test against the pre-step crossing count nc,
// the sanity freeze, the advance, the termination tests and the periodic
// null renormalization after step i when (i + 1) % renormalize_every == 0
// on a ray still live. s = (t, r, u, ph, pr, pu) is updated in place.
template <class T>
__device__ __forceinline__ void march_step(
    const MarchParams& mp, bool approx, const T& m, const T& a, const T& r_h,
    const T& r_ph, const T& pph, float thr, int i, T s[6], int& hit, int nc,
    bool& crossed, bool& advance, T& r_c, T& phi_c, T& t_c) {
  T y[6];
  step_values(mp, approx, m, a, r_h, r_ph, s[0], s[1], s[2], s[3], s[4], s[5],
              pph, y, r_c, phi_c, t_c);
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  if ((i + 1) % mp.renormalize_every == 0 && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
}

// A finished step's records: the crossing slot nc (then the count), the
// step count and the photon-ring proximity, from the advanced radius r.
__device__ __forceinline__ void record_step(bool crossed, bool advance,
                                            float r_c, float phi_c, float t_c,
                                            float r, float r_ph, int& nc,
                                            float cr[KMAX], float cp[KMAX],
                                            float ct[KMAX], int& steps,
                                            float& rmin) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (crossed && nc == k) {
      cr[k] = r_c;
      cp[k] = phi_c;
      ct[k] = t_c;
    }
  }
  nc += crossed ? 1 : 0;
  if (advance) {
    ++steps;
    rmin = jmin(rmin, fabsf(r - r_ph));
  }
}

// The start-jittered ray (ops/march.py::start_offset_rows): s advances by
// one implicit-midpoint step of xi * jitter * dlam0, xi in [0, 1) hashed
// from the conserved momenta, u clipped as the march clips it.
__device__ __forceinline__ void start_offset(const MarchParams& mp,
                                             bool approx, float m, float a,
                                             float r_h, float r_ph,
                                             float jitter, float pph,
                                             float s[6]) {
  const float xi = hash21(pph * F(977.0), s[4] * F(991.0)) * jitter;
  const float dlam = step_size(mp, approx, a, r_h, r_ph, s[1], s[2], s[5]);
  float y[6];
  midpoint_step(mp, approx, m, a, dlam * xi, s[0], s[1], s[2], s[3], s[4],
                s[5], pph, y);
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = y[k];
}

// One step's optically thin jet sample (shading.jet_emission_step): cone
// test, Gaussian profile, one noise octave, Doppler beaming; exp and the
// beaming power through double, as the plain version computes them.
__device__ __forceinline__ void jet_emission(const JetParams& jp, float r,
                                             float st, float ct, float ph,
                                             float dr, float dth, float dph,
                                             float dlam, float out[3]) {
  const float z = r * ct;
  const float rho = fabsf(r * st);
  const float az = fabsf(z);
  const float cone_r = jp.core_radius + jp.opening_slope * az;
  const bool in_cone = (az > jp.z_min) && (az < jp.z_max) &&
                       (rho < F(2.5) * cone_r);
  const float q = rho / jmax(cone_r, F(1e-3));
  const float profile = (float)exp((double)(-(q * q)));
  const float v_z = dr * ct - r * st * dth;
  const float v_rho = dr * st + r * ct * dth;
  const float v_ph = r * st * dph;
  const float v_mag = sqrtf(v_z * v_z + v_rho * v_rho + v_ph * v_ph +
                            F(1e-12));
  const float sgn = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float cos_psi = -sgn * v_z / v_mag;
  const float delta =
      1.0f / (jp.gamma * (1.0f - jp.beta * jclip(cos_psi, -1.0f, 1.0f)));
  const float beam = (float)pow((double)delta, (double)jp.beaming_exponent);
  const float noise = value_noise2(
      az * F(0.8), fmod_floor(ph, F(6.283185307179586)) * 2.0f + az);
  const float turb = jp.one_minus_turb + jp.turbulence * (0.5f + noise);
  const float mag =
      in_cone ? jp.density * dlam * profile * turb * beam : 0.0f;
  out[0] = F(0.62) * mag;
  out[1] = F(0.74) * mag;
  out[2] = mag;
}

// The jets' step of a live ray at step index i (march_tile's jet term,
// the body of march_ray<true>): the midpoint step, the crossing record, the
// jets' emission summed into jet from the pre-step state, the stepped one
// and 1 / dlam (even on a step the sanity test then rejects), the advance
// and the renormalization.
__device__ __forceinline__ void jets_advance(
    const MarchParams& mp, bool approx, float m, float a, float r_h,
    float r_ph, float pph, float thr, int i, float s[6], int& hit, int nc,
    const JetParams& jp, float jet[3], bool& crossed, bool& advance,
    float& r_c, float& phi_c, float& t_c) {
  float y[6], c[3];
  const float dlam = step_size(mp, approx, a, r_h, r_ph, s[1], s[2], s[5]);
  midpoint_step(mp, approx, m, a, dlam, s[0], s[1], s[2], s[3], s[4], s[5],
                pph, y);
  crossing_record(approx, s[0], s[1], s[2], s[3], y, r_c, phi_c, t_c);
  const float inv = recip(dlam, approx);
  const float st = sqrtf(jmax(1.0f - s[2] * s[2], F(1e-6)));
  jet_emission(jp, s[1], st, s[2], s[3], (y[1] - s[1]) * inv,
               -(y[2] - s[2]) * inv / st, (y[3] - s[3]) * inv, dlam, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) jet[k] = jet[k] + c[k];
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  if ((i + 1) % mp.renormalize_every == 0 && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
}

// March one ray to horizon or escape (ops/march.py::march_tile, one ray;
// its prologue and end-of-march rule are ray_begin's and ray_close's):
// s = (t, r, u, ph, pr, pu) in, final state out; records up to
// mp.max_crossings equator crossings and the photon-ring proximity
// min |r - r_ph| over the marched path. With JETS, jet (3 values) receives
// the jets' emission summed over the live steps (jp: their configuration;
// jets_advance).
template <bool JETS>
__device__ __forceinline__ void march_ray(const MarchParams& mp, bool approx,
                                          float m, float a, float r_h,
                                          float r_ph, float pph, float thr,
                                          float s[6], int& hit, int& steps,
                                          int& nc, float cr[KMAX],
                                          float cp[KMAX], float ct[KMAX],
                                          float& rmin, const JetParams* jp,
                                          float jet[3]) {
  hit = s[1] < thr ? HIT_HORIZON : HIT_NONE;
  nc = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) cr[k] = cp[k] = ct[k] = 0.0f;
  rmin = fabsf(s[1] - r_ph);
  steps = 0;
  if (JETS) jet[0] = jet[1] = jet[2] = 0.0f;
  for (int i = 0; i < mp.max_steps && hit == HIT_NONE; ++i) {
    bool crossed, advance;
    float r_c, phi_c, t_c;
    if (JETS) {
      jets_advance(mp, approx, m, a, r_h, r_ph, pph, thr, i, s, hit, nc, *jp,
                   jet, crossed, advance, r_c, phi_c, t_c);
    } else {
      march_step(mp, approx, m, a, r_h, r_ph, pph, thr, i, s, hit, nc,
                 crossed, advance, r_c, phi_c, t_c);
    }
    record_step(crossed, advance, r_c, phi_c, t_c, s[1], r_ph, nc, cr, cp, ct,
                steps, rmin);
  }
  if (hit == HIT_NONE) hit = HIT_HORIZON;
}

// One AB3 step of a live ray at step index i (ops/march.py::
// march_tile_ab3; the body of march_ray_ab3's loop). One right-hand side
// per step: y_{n+1} = y_n + c0 f_n + c1 f_{n-1} + c2 f_{n-2} with the
// variable-step Lagrange-integral coefficients of the step history
// (h = dlam, h1, h2), the step growth bounded by dlam <= 2 h1, two
// midpoint bootstrap steps that seed the history, the history (f1, f2, h1,
// h2) shifted only when the ray advances, and the renormalization at the
// per-ray cadence mp.ab3_renorm_every.
__device__ __forceinline__ void ab3_step(
    const MarchParams& mp, bool approx, float m, float a, float r_h,
    float r_ph, float pph, float thr, int i, float s[6], float f1[6],
    float f2[6], float& h1, float& h2, int& hit, int& nc, float cr[KMAX],
    float cp[KMAX], float ct[KMAX], int& steps, float& rmin) {
  const float third = F(1.0 / 3.0);
  float f0[6], y[6], dlam;
  ks_rhs(m, a, s[1], s[2], s[4], s[5], pph, approx, f0);
  if (i < 2) {
    dlam = step_size(mp, approx, a, r_h, r_ph, s[1], s[2], s[5]);
    midpoint_step(mp, approx, m, a, dlam, s[0], s[1], s[2], s[3], s[4],
                  s[5], pph, y);
  } else {
    dlam = jmin(step_size(mp, approx, a, r_h, r_ph, s[1], s[2], s[5]),
                2.0f * h1);
    const float h12 = h1 + h2;
    const float hh2 = dlam * dlam;
    const float hh3 = hh2 * dlam;
    const float c0 = divr(hh3 * third + (2.0f * h1 + h2) * hh2 * 0.5f +
                              h1 * h12 * dlam,
                          h1 * h12, approx);
    const float c1 = -divr(hh3 * third + h12 * hh2 * 0.5f, h1 * h2, approx);
    const float c2 = divr(hh3 * third + h1 * hh2 * 0.5f, h2 * h12, approx);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      y[k] = s[k] + c0 * f0[k] + c1 * f1[k] + c2 * f2[k];
    y[2] = jclip(y[2], F(-1.0 + 1e-7), F(1.0 - 1e-7));
  }
  float r_c, phi_c, t_c;
  crossing_record(approx, s[0], s[1], s[2], s[3], y, r_c, phi_c, t_c);
  bool crossed, advance;
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  record_step(crossed, advance, r_c, phi_c, t_c, s[1], r_ph, nc, cr, cp, ct,
              steps, rmin);
  if (advance) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      f2[k] = f1[k];
      f1[k] = f0[k];
    }
    h2 = h1;
    h1 = dlam;
  }
  if (i >= 2 && mp.ab3_renorm_every > 0 &&
      (i + 1) % mp.ab3_renorm_every == 0 && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
}

// The AB3 march of one ray (ops/march.py::march_tile_ab3; the JAX package's
// pallas_march.py::march_tile_ab3), march_ray's inputs and outputs, a loop
// of ab3_step (prologue and end-of-march rule as ray_begin and ray_close
// have them for MARCH_AB3). The Pallas tile loop shares its step counter
// across a tile, but every ray's steps depend on that ray alone, so one
// thread per ray reproduces it; its renormalization at tile-exit block
// boundaries becomes the per-ray cadence mp.ab3_renorm_every /
// mp.ab3_tail_renorm. Float only: the AB3 march has no gradient path.
__device__ __forceinline__ void march_ray_ab3(
    const MarchParams& mp, bool approx, float m, float a, float r_h,
    float r_ph, float pph, float thr, float s[6], int& hit, int& steps,
    int& nc, float cr[KMAX], float cp[KMAX], float ct[KMAX], float& rmin) {
  hit = s[1] < thr ? HIT_HORIZON : HIT_NONE;
  nc = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) cr[k] = cp[k] = ct[k] = 0.0f;
  rmin = fabsf(s[1] - r_ph);
  steps = 0;
  float f1[6], f2[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) f1[k] = f2[k] = 0.0f;
  float h1 = mp.min_step, h2 = mp.min_step;
  for (int i = 0; i < mp.max_steps && hit == HIT_NONE; ++i)
    ab3_step(mp, approx, m, a, r_h, r_ph, pph, thr, i, s, f1, f2, h1, h2, hit,
             nc, cr, cp, ct, steps, rmin);
  if (mp.ab3_tail_renorm && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
  if (hit == HIT_NONE) hit = HIT_HORIZON;
}

// ---------------------------------------------------------------------------
// One ray's march, one step at a time (the march kernel's persistent warps)
// ---------------------------------------------------------------------------

// The march variants: the midpoint march, the AB3 march and the midpoint
// march with the jets' emission.
#define MARCH_MIDPOINT 0
#define MARCH_AB3 1
#define MARCH_JETS 2

// What one ray carries from one step to the next, march_ray's loop state
// made lane state: the state s = (t, r, u, ph, pr, pu), its conserved p_phi
// and termination radius, the step index i (the renormalization cadence
// counts it), hit, the live step count, the crossing slots and their
// count, the photon-ring proximity; with jets the emission summed over the
// live steps; with AB3 the two right-hand-side histories and step sizes.
// The march kernel keeps one in registers per lane and marches it a step
// at a time, so that a lane whose ray has ended takes the next ray while
// the rest of its warp marches on; fields a variant does not use cost it
// no register.
template <int MARCH>
struct MarchRay {
  float s[6];
  float pph, thr;
  int hit, steps, nc, i;
  float cr[KMAX], cp[KMAX], ct[KMAX], rmin;
  float jet[3];
  float f1[6], f2[6], h1, h2;
};

// The end of the march on a ray still live after max_steps steps: AB3's
// tail renormalization, then hit = HIT_HORIZON (march_ray's own rule).
template <int MARCH>
__device__ __forceinline__ void ray_close(const MarchParams& mp, float m,
                                          float a, MarchRay<MARCH>& q) {
  if (q.hit == HIT_NONE && q.i >= mp.max_steps) {
    if (MARCH == MARCH_AB3 && mp.ab3_tail_renorm)
      q.s[4] = ks_renormalize_pr(m, a, q.s[1], q.s[2], q.s[4], q.s[5], q.pph);
    q.hit = HIT_HORIZON;
  }
}

// Birth of the march: q.s, q.pph and q.thr set by the caller; march_ray's
// prologue (a ray born inside its termination radius has ended).
template <int MARCH>
__device__ __forceinline__ void ray_begin(const MarchParams& mp, float m,
                                          float a, float r_ph,
                                          MarchRay<MARCH>& q) {
  q.hit = q.s[1] < q.thr ? HIT_HORIZON : HIT_NONE;
  q.nc = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) q.cr[k] = q.cp[k] = q.ct[k] = 0.0f;
  q.rmin = fabsf(q.s[1] - r_ph);
  q.steps = 0;
  q.i = 0;
  if (MARCH == MARCH_JETS) q.jet[0] = q.jet[1] = q.jet[2] = 0.0f;
  if (MARCH == MARCH_AB3) {
#pragma unroll
    for (int k = 0; k < 6; ++k) q.f1[k] = q.f2[k] = 0.0f;
    q.h1 = q.h2 = mp.min_step;
  }
  ray_close(mp, m, a, q);
}

// One step of a live ray (q.hit == HIT_NONE, q.i < mp.max_steps): one
// iteration of march_ray's or march_ray_ab3's loop, the same functions in
// the same order. Every ray's steps depend on that ray alone, so marching
// it a step at a time, in any lane and beside any other ray, gives the
// results of marching it in one loop.
template <int MARCH>
__device__ __forceinline__ void ray_step(const MarchParams& mp, bool approx,
                                         float m, float a, float r_h,
                                         float r_ph, const JetParams& jp,
                                         MarchRay<MARCH>& q) {
  if (MARCH == MARCH_AB3) {
    ab3_step(mp, approx, m, a, r_h, r_ph, q.pph, q.thr, q.i, q.s, q.f1, q.f2,
             q.h1, q.h2, q.hit, q.nc, q.cr, q.cp, q.ct, q.steps, q.rmin);
  } else {
    bool crossed, advance;
    float r_c, phi_c, t_c;
    if (MARCH == MARCH_JETS)
      jets_advance(mp, approx, m, a, r_h, r_ph, q.pph, q.thr, q.i, q.s, q.hit,
                   q.nc, jp, q.jet, crossed, advance, r_c, phi_c, t_c);
    else
      march_step(mp, approx, m, a, r_h, r_ph, q.pph, q.thr, q.i, q.s, q.hit,
                 q.nc, crossed, advance, r_c, phi_c, t_c);
    record_step(crossed, advance, r_c, phi_c, t_c, q.s[1], r_ph, q.nc, q.cr,
                q.cp, q.ct, q.steps, q.rmin);
  }
  ++q.i;
  ray_close(mp, m, a, q);
}

// ---------------------------------------------------------------------------
// The persistent warps' ray pool (march.cu)
// ---------------------------------------------------------------------------

#define FULL_MASK 0xffffffffu

// The warp's lanes in ``want`` take the next popc(want) indices of the pool
// together: one atomicAdd by the lowest such lane, the base broadcast, each
// lane its rank among them. Returns this lane's index (meaningful in
// ``want`` only) and sets ``end`` to the first index no lane took. Called
// by all 32 lanes with the same nonzero ``want``.
__device__ __forceinline__ int pool_take(int* pool, unsigned want, int lane,
                                         int& end) {
  const int leader = __ffs(want) - 1;
  const int count = __popc(want);
  int base = 0;
  if (lane == leader) base = atomicAdd(pool, count);
  base = __shfl_sync(FULL_MASK, base, leader);
  end = base + count;
  return base + __popc(want & ((1u << lane) - 1u));
}

// The block's retirement: the last block of the launch to finish resets
// the pool ([next index, retired blocks]) to zero for the next launch on
// the stream, so that a launch needs no separate reset. Called by every
// thread of the block once its warps have left their loops.
__device__ __forceinline__ void pool_retire(int* pool) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(pool + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(pool, 0);
      atomicExch(pool + 1, 0);
    }
  }
}
