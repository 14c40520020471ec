// The geodesic march step, shared by every kernel of the port: the render
// kernel (render.cu), the march kernel (march.cu) and the gradient kernel
// (march_grad.cu). One source for the step is what keeps the three in step
// with each other: the gradient kernel's replay lands its masks, crossing
// slots and freeze points on the same steps as the forward march, and the
// render kernel's march is the march kernel's.
//
// A ray is marched in one loop (march_ray, march_ray_ab3: the render
// kernel's one thread per pixel) or a step at a time (MarchRay, ray_begin,
// ray_boot, ray_step: the march kernel's persistent warps, which hand a
// lane the next ray when its own ends). Both run the same step bodies
// (march_step with record_step, jets_advance, ab3_boot_step and ab3_step)
// in the same order; the step-level form carries what the loops keep in
// locals, AB3's right-hand-side histories and step sizes and the
// renormalization countdown among them, as per-lane state. The float64
// AB3 march's step form keeps its history in a ring in shared memory
// instead (Ab3Ring, ab3_ring_boot_step, ab3_ring_step: the same
// expressions in the same order as ab3_boot_step and ab3_step).
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
// read the same; nvcc for sm_90a, before the step below). chip_smoke.py
// fails on a spill and pins the flagship's registers, so the render kernel
// keeps the loops.
//
// Counterpart of blackhole_simulation_tpu/ops/ks_kernel.py (ks_rhs_rows,
// ks_symplectic_step_rows, ks_renormalize_pr), ops/pallas_march.py
// (diff_step_values, start_offset_rows, march_tile with its jets,
// march_tile_ab3), ops/pallas_grad.py (make_composite) and
// render/shading.py (jet_emission_step, whose lattice hash and value noise
// are csrc/shade.cuh's).
// The plain PyTorch versions are ops/ks_kernel.py and ops/march.py; every
// expression here is written in their order, so the two round alike.
//
// The step math is templated on its scalar type: float for the forward
// march, double for the float64 march (the JAX package's jnp march with
// dtype=float64), Dual<N> (a value and N forward-mode tangents) for the
// per-step Jacobian of step_vjp_check.cu, the card's check of the gradient
// kernel's hand-written reverse adjoint (march_adjoint.cuh). A Dual's value
// is computed by the same float operations in the same order as the float
// instantiation, so a dual pass reproduces the forward's values bit for
// bit. The march loops and the per-ray state above the step (record_step,
// jets_advance, march_ray, MarchRay, ray_step and the rest) are templated
// on float or double (R). Constants are rounded once from their double
// literal to the scalar type (K<T>), so a float instantiation holds the
// same float constants as before and a double one the double values, as
// the plain versions' Python numbers take the tensors' dtype; the pole
// guard's floor is the plain version's by dtype (w_floor: 1e-6 in float,
// 1e-12 in double). The double instantiations take the exact route only:
// the JAX package's float64 march divides exactly (its jnp march has no
// approximate reciprocal).
//
// Two routes, chosen at compile time (APPROX, every kernel instantiated
// for both and picked at launch from MarchConfig.approx_recip):
// * the exact route (APPROX false) divides in IEEE and rounds every
//   product and sum on its own: bit-equal to the plain PyTorch versions;
// * the approx_recip route (APPROX true), the one the flagship, jets, AB3
//   and training configurations run on the card, takes rcp.approx.ftz for
//   the step's reciprocals and contracts the step's multiply-adds through
//   madd: __fmaf_rn, one rounding where two operations round twice. The
//   contraction is explicit (the build keeps --fmad=false), so the render
//   kernel, the march kernel and the gradient kernel's replay contract the
//   same terms and land on the same steps. This route is held to
//   statistical bars against the plain version (chip_smoke.py phase 3).
//
// What bounds the step on the H100 is its instruction count, not its
// lanes (chip_smoke.py phase 12: 0.92-0.94 lane efficiency in the render
// kernel). The SASS census of the march loops (tools/sass_census.py,
// chip_smoke.py phase 13; PERF.md) found that a midpoint step ran
// ~1.6x its counted operations: three instructions per NaN-propagating
// min/max, a ~20-instruction integer modulo for the renormalization
// cadence, IEEE divides (each a reciprocal, Newton steps, a range check and
// a branch around a slow-path call) and the separate product and sum of
// every multiply-add. The design against each:
// * jmax/jmin on a float are one FMNMX (PTX max.NaN / min.NaN);
// * the renormalization cadence is a per-ray countdown (renorm_start,
//   renorm_due), reset where it lands: the same steps as
//   (i + 1) % renormalize_every == 0, AB3's i >= 2 start and its tail rule
//   (ops/march.py::ab3_renorm_plan) included;
// * 1 / max(r_ph, 1e-3) is computed once per ray (inv_rph_of), and the
//   far-boost divide r / far_boost_radius only where it can exceed 1
//   (far_boost), bit-equal to the plain max(r / fbr, 1);
// * the AB3 march's two midpoint bootstrap steps are peeled out of its
//   loop (ab3_boot_step; march_ray_ab3 runs them ahead of a loop whose body
//   evaluates one right-hand side), so that the loop carries none of the
//   midpoint step's registers; the step form runs them in ray_boot, which
//   the march kernel calls where it births a ray, outside its step loop.
//
// jnp semantics: maximum/minimum/clip propagate NaN (the march's sanity
// freeze relies on NaN reaching isfinite) and, for tangents, split the
// derivative half and half at ties, as JAX's rules do. The floored modulo
// is jnp.mod's own.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "shade.cuh"

// Constants are written as (float)(double literal): rounded to float32 from
// the double value, as PyTorch and JAX round a Python float.
#define F(x) ((float)(x))

#define HIT_NONE 0
#define HIT_HORIZON 1
#define HIT_ESCAPE 2
// The crossing slots a ray carries: 4 (MarchConfig.max_crossings 1 to 4) in
// the default build; ops/build.py builds a separate library with -DKMAX=8,
// 16, ... for more (ops/build.py::kmax_for), whose slots past the fourth
// are indexed (record_step).
#ifndef KMAX
#define KMAX 4
#endif

// The static march configuration, its lengths in the scalar type S of the
// march (float or double). Must match ops/pallas_march.py::_CMarchParams
// (S float) and _CMarchParams64 (S double) field for field. multistep
// selects the AB3 march; ab3_renorm_every and ab3_tail_renorm are its
// renormalization cadence (ops/march.py::ab3_renorm_plan).
template <class S>
struct MarchParamsT {
  int max_steps, renormalize_every, max_crossings, midpoint_iters,
      approx_recip, far_cap_on, multistep, ab3_renorm_every, ab3_tail_renorm;
  S step_rate, min_step, max_step, far_step_cap_rate, far_boost_radius,
      escape_radius, escape_sanity_r, record_r_min, record_r_max;
};
typedef MarchParamsT<float> MarchParams;

// The jets' static configuration (shading.JetParams, each field rounded to
// S; gamma and one_minus_turb rounded from float64). Must match
// ops/pallas_march.py::_CJetParams (S float) and _CJetParams64 (S double)
// field for field.
template <class S>
struct JetParamsT {
  S core_radius, opening_slope, z_min, z_max, density, turbulence,
      one_minus_turb, gamma, beta, beaming_exponent;
};
typedef JetParamsT<float> JetParams;

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
// The scalar type of a step type, and its constants
// ---------------------------------------------------------------------------

// The scalar a step type T computes in: double for double, float for float
// and for the derivative types (Dual<N>, step_vjp_check.cu's Mag<N>).
template <class T>
struct Scalar {
  typedef float type;
};
template <>
struct Scalar<double> {
  typedef double type;
};
template <class T>
using scalar_t = typename Scalar<T>::type;

// A constant of T's scalar type, rounded once from its double literal: on
// float what F(x) gives, on double the literal's own value.
template <class T>
__host__ __device__ constexpr scalar_t<T> K(double x) {
  return (scalar_t<T>)x;
}

// The pole guard's floor of w = 1 - u^2 (ops/ks_kernel.py::w_floor): 1e-6
// in float, where 1/w^2 must not overflow inside a step, 1e-12 in double.
template <class T>
__host__ __device__ constexpr scalar_t<T> w_floor() {
  return (scalar_t<T>)(sizeof(scalar_t<T>) == 8 ? 1e-12 : 1e-6);
}

// ---------------------------------------------------------------------------
// jnp semantics, for float, double and Dual
// ---------------------------------------------------------------------------

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ double val(double x) { return x; }
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

// On a float, one FMNMX each: PTX's max.NaN / min.NaN (sm_80 and later)
// return NaN when either input is NaN, as the compare-compare-select form
// (a > b || a != a) ? a : b did in three instructions. Against that form on
// planted pairs on the card (chip_smoke.py phase 13) they agree bit for bit
// but in two cases: a NaN result is the canonical NaN, where the old form
// passed the NaN operand through (isfinite reads both alike), and a tie of
// opposite-sign zeros follows IEEE 754's -0 < +0 (max(+0, -0) = +0,
// min(-0, +0) = -0) where the old form returned b. No call here meets such
// a tie: every call's second operand is a nonzero constant, or +0 as max's
// (where the two agree), or both operands are magnitudes, sums of squares
// or positive step sizes, which are never -0. Keeping the old tie rule
// would take back the compare and the select.
__device__ __forceinline__ float jmax(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ float jmin(float a, float b) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
// On a double, compare and select (PTX has no max.NaN.f64): NaN in either
// operand gives NaN, as jnp.maximum / jnp.minimum do.
__device__ __forceinline__ double jmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double jmin(double a, double b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ double jclip(double x, double lo, double hi) {
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
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
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
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
template <int N>
__device__ __forceinline__ Dual<N> dsqrt(const Dual<N>& x) {
  Dual<N> o;
  o.v = sqrtf(x.v);
  DUAL_LOOP o.d[i] = x.d[i] * 0.5f / o.v;
  return o;
}

// exp and pow on the exact route: a float's through double, rounded once
// (as the plain version computes them), a double's its own.
__device__ __forceinline__ float exact_exp(float x) {
  return (float)exp((double)x);
}
__device__ __forceinline__ double exact_exp(double x) { return exp(x); }
__device__ __forceinline__ float exact_pow(float x, float p) {
  return (float)pow((double)x, (double)p);
}
__device__ __forceinline__ double exact_pow(double x, double p) {
  return pow(x, p);
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
// The step's reciprocals and divides: on the approx_recip route (APPROX)
// rcp.approx.ftz, else IEEE.
template <bool APPROX, class T>
__device__ __forceinline__ T recip(const T& x) {
  if constexpr (APPROX)
    return rcp_approx(x);
  else
    return 1.0f / x;
}
template <bool APPROX, class T>
__device__ __forceinline__ T divr(const T& num, const T& den) {
  if constexpr (APPROX)
    return num * rcp_approx(den);
  else
    return num / den;
}

// a * b + c: one fused multiply-add, rounded once, on the approx_recip route
// (APPROX); a product and a sum, each rounded, on the exact route, so that
// it rounds as the plain version does. Explicit, because --fmad=false keeps
// nvcc from contracting anything: the render kernel, the march kernel and
// the gradient kernel's replay contract the same terms of the same step.
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
// A Dual's value by the same fused operation (so that a dual pass
// reproduces the float forward bit for bit), its tangents by the product
// and sum rules.
template <int N>
__device__ __forceinline__ Dual<N> fmadd(const Dual<N>& a, const Dual<N>& b,
                                         const Dual<N>& c) {
  Dual<N> o;
  o.v = __fmaf_rn(a.v, b.v, c.v);
  DUAL_LOOP o.d[i] = a.d[i] * b.v + a.v * b.d[i] + c.d[i];
  return o;
}
template <bool APPROX, class A, class B, class C>
__device__ __forceinline__ auto madd(const A& a, const B& b, const C& c) {
  using R = decltype(a * b + c);
  if constexpr (APPROX)
    return fmadd(R(a), R(b), R(c));
  else
    return a * b + c;
}

// ---------------------------------------------------------------------------
// Step math (ops/ks_kernel.py), p_t = -1
// ---------------------------------------------------------------------------

// The right-hand side of the Kerr-Schild Hamiltonian. Every sum of products
// goes through madd, in the plain version's association, so the exact route
// rounds as it does; w = max(1 - u^2, 1e-6) stays two roundings in both
// routes (the adjoint reads its tie with the floor from the same value).
template <bool APPROX, class T>
__device__ __forceinline__ void ks_rhs(const T& m, const T& a, const T& r,
                                       const T& u, const T& pr, const T& pu,
                                       const T& pph, T d[6]) {
  const float pt = -1.0f;
  T w = jmax(1.0f - u * u, T(w_floor<T>()));
  T S = madd<APPROX>(r, r, a * a * u * u);
  T D = madd<APPROX>(a, a, madd<APPROX>(r, r, -(2.0f * m * r)));
  T inv_S = recip<APPROX>(S);
  T h = 2.0f * m * r * inv_S;
  T inv_S2 = inv_S * inv_S;
  T inv_w = recip<APPROX>(w);
  T a_iS = a * inv_S;

  d[0] = madd<APPROX>(h, pr, -(1.0f + h) * pt);
  d[1] = madd<APPROX>(a_iS, pph, madd<APPROX>(D * inv_S, pr, h * pt));
  d[2] = w * inv_S * pu;
  d[3] = madd<APPROX>(a_iS, pr, pph * inv_S * inv_w);

  T S_r = 2.0f * r;
  T D_r = 2.0f * r - 2.0f * m;
  T h_r = 2.0f * m * madd<APPROX>(-(2.0f * r), r, S) * inv_S2;
  T DS_r = madd<APPROX>(D_r, S, -(D * S_r)) * inv_S2;
  T invS_r = -S_r * inv_S2;
  T wS_r = -w * S_r * inv_S2;
  T invSw_r = -S_r * inv_S2 * inv_w;
  T sr = madd<APPROX>(2.0f * h_r * pt, pr, -h_r * pt * pt);
  sr = madd<APPROX>(DS_r * pr, pr, sr);
  sr = madd<APPROX>(2.0f * a * invS_r * pr, pph, sr);
  sr = madd<APPROX>(wS_r * pu, pu, sr);
  sr = madd<APPROX>(invSw_r * pph, pph, sr);
  T dH_dr = 0.5f * sr;

  T S_u = 2.0f * a * a * u;
  T w_u = -2.0f * u;
  T h_u = -2.0f * m * r * S_u * inv_S2;
  T DS_u = -D * S_u * inv_S2;
  T invS_u = -S_u * inv_S2;
  T wS_u = madd<APPROX>(w_u, S, -(w * S_u)) * inv_S2;
  T invSw_u = -madd<APPROX>(S, w_u, S_u * w) * inv_S2 * inv_w * inv_w;
  T su = madd<APPROX>(2.0f * h_u * pt, pr, -h_u * pt * pt);
  su = madd<APPROX>(DS_u * pr, pr, su);
  su = madd<APPROX>(2.0f * a * invS_u * pr, pph, su);
  su = madd<APPROX>(wS_u * pu, pu, su);
  su = madd<APPROX>(invSw_u * pph, pph, su);
  T dH_du = 0.5f * su;
  d[4] = -dH_dr;
  d[5] = -dH_du;
}

// Null projection of p_r (exact divides always, uncontracted in both
// routes: the adjoint's renormalize_pr_vjp recomputes its branches, a real
// root and the nearest one, from this arithmetic, so a contracted forward
// could part from it at a radial turning point; it runs once per
// renormalize_every steps).
template <class T>
__device__ __forceinline__ T ks_renormalize_pr(const T& m, const T& a,
                                               const T& r, const T& u,
                                               const T& pr, const T& pu,
                                               const T& pph) {
  const float pt = -1.0f;
  T w = jmax(1.0f - u * u, T(w_floor<T>()));
  T S = r * r + a * a * u * u;
  T D = r * r - 2.0f * m * r + a * a;
  T inv_S = 1.0f / S;
  T h = 2.0f * m * r * inv_S;
  T A = D * inv_S;
  T B = 2.0f * (h * pt + a * inv_S * pph);
  T C = -(1.0f + h) * pt * pt + w * inv_S * pu * pu + pph * pph * inv_S / w;
  T disc = B * B - 4.0f * A * C;
  bool valid = (val(disc) >= 0.0f) && (dabs(val(A)) > K<T>(1e-12));
  T sqrt_d = dsqrt(valid ? jmax(disc, T(K<T>(1e-30))) : T(1.0f));
  T denom = valid ? 2.0f * A : T(1.0f);
  T sol1 = (-B + sqrt_d) / denom;
  T sol2 = (-B - sqrt_d) / denom;
  T nearest = dabs(val(sol1) - val(pr)) < dabs(val(sol2) - val(pr)) ? sol1
                                                                    : sol2;
  return valid ? nearest : pr;
}

// ---------------------------------------------------------------------------
// One march step (pallas_march.py::diff_step_values and the body of
// march_tile / pallas_grad.py::make_composite)
// ---------------------------------------------------------------------------

// The renormalization cadence, counted down: rn holds the steps left until
// the next one; renorm_due counts one step and says whether the
// renormalization is due after it, (i + 1) % every == 0 for the step index
// i at which rn was renorm_start(i, every). One decrement and a compare per
// step where the modulo by a runtime divisor took about twenty
// instructions.
__device__ __forceinline__ int renorm_start(int i, int every) {
  return every - i % every;
}
__device__ __forceinline__ bool renorm_due(int& rn, int every) {
  if (--rn > 0) return false;
  rn = every;
  return true;
}

// 1 / max(r_ph, 1e-3): constant per launch, computed once by the caller of
// the step.
template <class T>
__device__ __forceinline__ T inv_rph_of(const T& r_ph) {
  return 1.0f / jmax(r_ph, T(K<T>(1e-3)));
}

// max(r / fbr, 1): on a float, the divide only where it can exceed 1. A
// correctly rounded r / fbr is at most 1 when r <= fbr, and a NaN r still
// divides, so the two forms are equal bit for bit; most steps lie inside
// fbr. On a Dual the plain form, whose tie at r = fbr splits the tangent.
__device__ __forceinline__ float far_boost(float r, float fbr) {
  return !(r <= fbr) ? r / fbr : 1.0f;
}
__device__ __forceinline__ double far_boost(double r, double fbr) {
  return !(r <= fbr) ? r / fbr : 1.0;
}
template <class T>
__device__ __forceinline__ T far_boost(const T& r, float fbr) {
  return jmax(r / fbr, T(1.0f));
}

// The curvature-adaptive, pole-throttled step size (inv_rph: inv_rph_of).
template <bool APPROX, class T>
__device__ __forceinline__ T step_size(const MarchParamsT<scalar_t<T>>& mp,
                                       const T& a,
                                       const T& r_h, const T& r_ph,
                                       const T& inv_rph, const T& r,
                                       const T& u, const T& pu) {
  T base = (r - r_h) * mp.step_rate;
  T far = far_boost(r, mp.far_boost_radius);
  T prox = jclip(dabs(r - r_ph) * inv_rph, T(K<T>(0.25)), T(1.0f));
  T cap = mp.far_cap_on ? jmax(mp.far_step_cap_rate * r, T(mp.max_step))
                        : T(mp.max_step);
  T dlam = jclip(base * far * prox, T(mp.min_step), cap);
  T w = jmax(1.0f - u * u, T(w_floor<T>()));
  T sig = madd<APPROX>(r, r, a * a * u * u);
  T du_rate = dabs(w * pu / sig) + K<T>(1e-12);
  T margin = 1.0f - dabs(u) + K<T>(1e-6);
  return jmin(dlam, jmax(divr<APPROX>(0.5f * margin, du_rate),
                         T(mp.min_step)));
}

// The six rows advanced by dlam along the derivatives d: y = x + dlam d.
template <bool APPROX, class T>
__device__ __forceinline__ void advance_rows(const T& dlam, const T& t,
                                             const T& r, const T& u,
                                             const T& ph, const T& pr,
                                             const T& pu, const T d[6],
                                             T y[6]) {
  y[0] = madd<APPROX>(dlam, d[0], t);
  y[1] = madd<APPROX>(dlam, d[1], r);
  y[2] = madd<APPROX>(dlam, d[2], u);
  y[3] = madd<APPROX>(dlam, d[3], ph);
  y[4] = madd<APPROX>(dlam, d[4], pr);
  y[5] = madd<APPROX>(dlam, d[5], pu);
}

// The implicit-midpoint step of size dlam, u clipped off the poles.
template <bool APPROX, class T>
__device__ __forceinline__ void midpoint_step(
    const MarchParamsT<scalar_t<T>>& mp, const T& m, const T& a, const T& dlam, const T& t,
    const T& r, const T& u, const T& ph, const T& pr, const T& pu,
    const T& pph, T y[6]) {
  T d[6];
  ks_rhs<APPROX>(m, a, r, u, pr, pu, pph, d);
  advance_rows<APPROX>(dlam, t, r, u, ph, pr, pu, d, y);
  for (int it = 0; it < mp.midpoint_iters; ++it) {
    ks_rhs<APPROX>(m, a, 0.5f * (r + y[1]), 0.5f * (u + y[2]),
                   0.5f * (pr + y[4]), 0.5f * (pu + y[5]), pph, d);
    advance_rows<APPROX>(dlam, t, r, u, ph, pr, pu, d, y);
  }
  y[2] = jclip(y[2], T(K<T>(-1.0 + 1e-7)), T(K<T>(1.0 - 1e-7)));
}

// The equator-crossing record interpolated between (t, r, u, ph) and the
// stepped y.
template <bool APPROX, class T>
__device__ __forceinline__ void crossing_record(const T& t, const T& r,
                                                const T& u, const T& ph,
                                                const T y[6], T& r_c,
                                                T& phi_c, T& t_c) {
  const T& nu = y[2];
  T frac = jclip(
      divr<APPROX>(u, dabs(val(u - nu)) < K<T>(1e-12) ? T(K<T>(1e-12))
                                                       : u - nu),
      T(0.0f), T(1.0f));
  r_c = madd<APPROX>(frac, y[1] - r, r);
  phi_c = madd<APPROX>(frac, y[3] - ph, ph);
  t_c = madd<APPROX>(frac, y[0] - t, t);
}

// The stepped state and the interpolated equator-crossing record.
template <bool APPROX, class T>
__device__ __forceinline__ void step_values(
    const MarchParamsT<scalar_t<T>>& mp, const T& m, const T& a, const T& r_h,
    const T& r_ph, const T& inv_rph, const T& t, const T& r, const T& u,
    const T& ph, const T& pr, const T& pu, const T& pph, T y[6], T& r_c,
    T& phi_c, T& t_c) {
  T dlam = step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, r, u, pu);
  midpoint_step<APPROX>(mp, m, a, dlam, t, r, u, ph, pr, pu, pph, y);
  crossing_record<APPROX>(t, r, u, ph, y, r_c, phi_c, t_c);
}

// The step's epilogue on a live ray: the crossing test against the pre-step
// crossing count nc, the sanity freeze, the advance of s to y and the
// termination tests.
template <class T>
__device__ __forceinline__ void advance_step(
    const MarchParamsT<scalar_t<T>>& mp, scalar_t<T> thr, T s[6],
    const T y[6], const T& r_c, int& hit, int nc, bool& crossed,
    bool& advance) {
  crossed = ((val(s[2]) * val(y[2])) < 0.0f) && (nc < mp.max_crossings) &&
            (val(r_c) > mp.record_r_min) && (val(r_c) < mp.record_r_max);
  advance = isfinite(val(y[1])) && isfinite(val(y[3])) &&
            isfinite(val(y[4])) && isfinite(val(y[5])) &&
            (dabs(val(y[4])) < K<T>(1e7)) && (dabs(val(y[5])) < K<T>(1e7)) &&
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

// One step of a live ray (hit == HIT_NONE on entry): the step values, the
// crossing test against the pre-step crossing count nc, the sanity freeze,
// the advance, the termination tests and the periodic null renormalization
// after the step when the countdown rn says it is due (renorm_due; (i + 1)
// % renormalize_every == 0 for step index i) on a ray still live.
// s = (t, r, u, ph, pr, pu) is updated in place.
template <bool APPROX, class T>
__device__ __forceinline__ void march_step(
    const MarchParamsT<scalar_t<T>>& mp, const T& m, const T& a,
    const T& r_h, const T& r_ph, const T& inv_rph, const T& pph,
    scalar_t<T> thr, int& rn,
    T s[6], int& hit, int nc, bool& crossed, bool& advance, T& r_c, T& phi_c,
    T& t_c) {
  T y[6];
  step_values<APPROX>(mp, m, a, r_h, r_ph, inv_rph, s[0], s[1], s[2], s[3],
                      s[4], s[5], pph, y, r_c, phi_c, t_c);
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  if (renorm_due(rn, mp.renormalize_every) && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
}

// A finished step's records: the crossing slot nc (then the count), the
// step count and the photon-ring proximity, from the advanced radius r.
// With LOCAL (the loop forms, the render kernel's), the slots are indexed
// by the count (crossed implies nc < max_crossings <= KMAX), so they live
// in local memory, cached in L1, and not in 12 of the loop's registers: a
// ray writes them a few times in its march and reads them once, in its
// composite (the flagship instantiation compiles to 48 registers against
// 64 with the slots in registers). Without it (the step form, whose
// MarchRay the march kernel keeps across its refill loop), each slot is a
// register written under a compile-time index: indexed slots there made
// the march kernel slower. Above four slots (KMAX > 4, a build of its own)
// both forms index them. The double march's step form passes LOCAL for
// its midpoint and jets variants (ray_step): there the slots in registers
// cost occupancy (106 registers and 4 resident blocks per SM on the H100,
// against 72 and 7 indexed, and a third of the time on the 1080p rays).
// Its AB3 variant indexes them too, in an array apart from its lane state
// (MarchRay<MARCH_AB3, double>, ray_step_ring). R: float or double.
template <bool LOCAL, class R>
__device__ __forceinline__ void record_step(bool crossed, bool advance,
                                            R r_c, R phi_c, R t_c, R r,
                                            R r_ph, int& nc, R cr[KMAX],
                                            R cp[KMAX], R ct[KMAX],
                                            int& steps, R& rmin) {
  if constexpr (LOCAL || KMAX > 4) {
    if (crossed) {
      cr[nc] = r_c;
      cp[nc] = phi_c;
      ct[nc] = t_c;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (crossed && nc == k) {
        cr[k] = r_c;
        cp[k] = phi_c;
        ct[k] = t_c;
      }
    }
  }
  nc += crossed ? 1 : 0;
  if (advance) {
    ++steps;
    rmin = jmin(rmin, dabs(r - r_ph));
  }
}

// The start-jittered ray (ops/march.py::start_offset_rows): s advances by
// one implicit-midpoint step of xi * jitter * dlam0, xi in [0, 1) hashed
// from the conserved momenta, u clipped as the march clips it.
template <bool APPROX>
__device__ __forceinline__ void start_offset(const MarchParams& mp, float m,
                                             float a, float r_h, float r_ph,
                                             float jitter, float pph,
                                             float s[6]) {
  const float xi = shade::hash21(pph * F(977.0), s[4] * F(991.0)) * jitter;
  const float dlam = step_size<APPROX>(mp, a, r_h, r_ph, inv_rph_of(r_ph),
                                       s[1], s[2], s[5]);
  float y[6];
  midpoint_step<APPROX>(mp, m, a, dlam * xi, s[0], s[1], s[2], s[3], s[4],
                        s[5], pph, y);
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = y[k];
}

// One step's optically thin jet sample (shading.jet_emission_step): cone
// test, Gaussian profile, one noise octave, Doppler beaming. exp and the
// beaming power in float on the approx_recip route (JAX's own float32
// jnp.exp and **), through double on the exact route, as the plain version
// computes them. In two parts: jet_emission everything but the beaming
// power (pre, zero outside the cone, and the Doppler factor delta), then
// jet_beaming the power and the three channels, which jets_advance runs
// once the step's other values are dead (the double pow's slow path is a
// subroutine, and every value live across its call is saved around it).
// In double both are double's own (exact_exp, exact_pow) and the noise the
// double value_noise2, as the JAX twin computes them on float64 rows.
template <bool APPROX, class R>
__device__ __forceinline__ void jet_emission(const JetParamsT<R>& jp, R r,
                                             R st, R ct, R ph, R dr, R dth,
                                             R dph, R dlam, bool& in_cone,
                                             R& pre, R& delta) {
  const R z = r * ct;
  const R rho = dabs(r * st);
  const R az = dabs(z);
  const R cone_r = jp.core_radius + jp.opening_slope * az;
  in_cone = (az > jp.z_min) && (az < jp.z_max) && (rho < K<R>(2.5) * cone_r);
  const R q = rho / jmax(cone_r, K<R>(1e-3));
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
  const R sgn = z > 0.0f ? R(1.0f) : (z < 0.0f ? R(-1.0f) : R(0.0f));
  const R cos_psi = -sgn * v_z / v_mag;
  delta = 1.0f /
          (jp.gamma * (1.0f - jp.beta * jclip(cos_psi, R(-1.0f), R(1.0f))));
  // the lattice noise of csrc/shade.cuh, at phi mod 2 pi
  const R ph_mod = shade::remainder_(shade::val(ph), 6.283185307179586).v;
  const R noise =
      shade::value_noise2(shade::val(az * K<R>(0.8)),
                          shade::val(ph_mod * 2.0f + az)).v;
  const R turb = jp.one_minus_turb + jp.turbulence * (0.5f + noise);
  pre = jp.density * dlam * profile * turb;
}
template <bool APPROX, class R>
__device__ __forceinline__ void jet_beaming(const JetParamsT<R>& jp,
                                            bool in_cone, R pre, R delta,
                                            R out[3]) {
  // the power inside the cone only: off the path of most steps, the double
  // pow's call saves no registers around it there
  R mag = 0.0f;
  if (in_cone) {
    R beam;
    if constexpr (APPROX)
      beam = powf(delta, jp.beaming_exponent);
    else
      beam = exact_pow(delta, jp.beaming_exponent);
    mag = pre * beam;
  }
  out[0] = K<R>(0.62) * mag;
  out[1] = K<R>(0.74) * mag;
  out[2] = mag;
}

// The jets' step of a live ray (march_tile's jet term, the body of
// march_ray<true>): the midpoint step, the crossing record, the jets'
// emission from the pre-step state, the stepped one and 1 / dlam (even on a
// step the sanity test then rejects), the advance, the renormalization
// (countdown rn, as march_step's), the step's records (record_step, LOCAL
// its), and last the emission's beaming, summed into jet.
template <bool APPROX, bool LOCAL, class R>
__device__ __forceinline__ void jets_advance(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph, R pph,
    R thr, int& rn, R s[6], int& hit, int& nc, const JetParamsT<R>& jp,
    R jet[3], R cr[KMAX], R cp[KMAX], R ct[KMAX], int& steps, R& rmin) {
  R y[6], c[3], r_c, phi_c, t_c;
  bool crossed, advance;
  const R dlam =
      step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, s[1], s[2], s[5]);
  midpoint_step<APPROX>(mp, m, a, dlam, s[0], s[1], s[2], s[3], s[4], s[5],
                        pph, y);
  crossing_record<APPROX>(s[0], s[1], s[2], s[3], y, r_c, phi_c, t_c);
  const R inv = recip<APPROX>(dlam);
  const R st = dsqrt(jmax(1.0f - s[2] * s[2], w_floor<R>()));
  bool in_cone;
  R pre, delta;
  jet_emission<APPROX>(jp, s[1], st, s[2], s[3], (y[1] - s[1]) * inv,
                       -(y[2] - s[2]) * inv / st, (y[3] - s[3]) * inv, dlam,
                       in_cone, pre, delta);
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  if (renorm_due(rn, mp.renormalize_every) && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
  record_step<LOCAL>(crossed, advance, r_c, phi_c, t_c, s[1], r_ph, nc, cr,
                     cp, ct, steps, rmin);
  jet_beaming<APPROX>(jp, in_cone, pre, delta, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) jet[k] = jet[k] + c[k];
}

// March one ray to horizon or escape (ops/march.py::march_tile, one ray;
// its prologue and end-of-march rule are ray_begin's and ray_close's):
// s = (t, r, u, ph, pr, pu) in, final state out; records up to
// mp.max_crossings equator crossings and the photon-ring proximity
// min |r - r_ph| over the marched path. With JETS, jet (3 values) receives
// the jets' emission summed over the live steps (jp: their configuration;
// jets_advance).
template <bool JETS, bool APPROX, class R>
__device__ __forceinline__ void march_ray(const MarchParamsT<R>& mp, R m,
                                          R a, R r_h, R r_ph, R pph, R thr,
                                          R s[6], int& hit, int& steps,
                                          int& nc, R cr[KMAX], R cp[KMAX],
                                          R ct[KMAX], R& rmin,
                                          const JetParamsT<R>* jp, R jet[3]) {
  hit = s[1] < thr ? HIT_HORIZON : HIT_NONE;
  nc = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) cr[k] = cp[k] = ct[k] = 0.0f;
  rmin = dabs(s[1] - r_ph);
  steps = 0;
  if (JETS) jet[0] = jet[1] = jet[2] = 0.0f;
  const R inv_rph = inv_rph_of(r_ph);
  int rn = mp.renormalize_every;
  for (int i = 0; i < mp.max_steps && hit == HIT_NONE; ++i) {
    if (JETS) {
      jets_advance<APPROX, true>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s,
                                 hit, nc, *jp, jet, cr, cp, ct, steps, rmin);
    } else {
      bool crossed, advance;
      R r_c, phi_c, t_c;
      march_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, hit,
                         nc, crossed, advance, r_c, phi_c, t_c);
      record_step<true>(crossed, advance, r_c, phi_c, t_c, s[1], r_ph, nc, cr,
                        cp, ct, steps, rmin);
    }
  }
  if (hit == HIT_NONE) hit = HIT_HORIZON;
}

// The records of an AB3 step (bootstrap or not) from the stepped values
// y: the crossing record, the advance and the step's records. LOCAL:
// record_step's.
template <bool APPROX, bool LOCAL, class R>
__device__ __forceinline__ void ab3_record(
    const MarchParamsT<R>& mp, R r_ph, R thr, R s[6], const R y[6], int& hit,
    int& nc, R cr[KMAX], R cp[KMAX], R ct[KMAX], int& steps, R& rmin) {
  R r_c, phi_c, t_c;
  crossing_record<APPROX>(s[0], s[1], s[2], s[3], y, r_c, phi_c, t_c);
  bool crossed, advance;
  advance_step(mp, thr, s, y, r_c, hit, nc, crossed, advance);
  record_step<LOCAL>(crossed, advance, r_c, phi_c, t_c, s[1], r_ph, nc, cr,
                     cp, ct, steps, rmin);
}

// The end of an AB3 step (bootstrap or not): its records (ab3_record) and
// the history (f1, f2, h1, h2) shifted. The Pallas kernel shifts it only
// when the ray advances; a ray that does not advance has ended
// (advance_step sets its hit), so no later step reads the history and the
// shift needs no predicate. LOCAL: record_step's.
template <bool APPROX, bool LOCAL, class R>
__device__ __forceinline__ void ab3_finish(
    const MarchParamsT<R>& mp, R r_ph, R thr, R s[6], const R y[6],
    const R f0[6], R dlam, R f1[6], R f2[6], R& h1, R& h2, int& hit, int& nc,
    R cr[KMAX], R cp[KMAX], R ct[KMAX], int& steps, R& rmin) {
  ab3_record<APPROX, LOCAL>(mp, r_ph, thr, s, y, hit, nc, cr, cp, ct, steps,
                            rmin);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    f2[k] = f1[k];
    f1[k] = f0[k];
  }
  h2 = h1;
  h1 = dlam;
}

// One of the AB3 march's two bootstrap steps (step index 0 or 1): a
// midpoint step that seeds the history with the start's right-hand side. No
// renormalization follows it (the cadence starts at step 2). Peeled out of
// ab3_step, so that the loop's body holds one right-hand side and no
// midpoint step.
template <bool APPROX, bool LOCAL, class R>
__device__ __forceinline__ void ab3_boot_step(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph, R pph,
    R thr, R s[6], R f1[6], R f2[6], R& h1, R& h2, int& hit, int& nc,
    R cr[KMAX], R cp[KMAX], R ct[KMAX], int& steps, R& rmin) {
  R f0[6], y[6];
  ks_rhs<APPROX>(m, a, s[1], s[2], s[4], s[5], pph, f0);
  const R dlam =
      step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, s[1], s[2], s[5]);
  midpoint_step<APPROX>(mp, m, a, dlam, s[0], s[1], s[2], s[3], s[4], s[5],
                        pph, y);
  ab3_finish<APPROX, LOCAL>(mp, r_ph, thr, s, y, f0, dlam, f1, f2, h1, h2,
                            hit, nc, cr, cp, ct, steps, rmin);
}

// The first value of the AB3 renormalization countdown, at step 2 (the
// first step after the bootstrap; ops/march.py::ab3_renorm_plan's cadence
// every, 0 for none, which no countdown from INT_MAX reaches).
__device__ __forceinline__ int ab3_renorm_start(int every) {
  return every > 0 ? renorm_start(2, every) : 0x7fffffff;
}

// The AB3 step's variable-step Lagrange-integral coefficients (c0, c1, c2)
// of the step dlam after the steps h1 and h2.
template <bool APPROX, class R>
__device__ __forceinline__ void ab3_coefficients(R dlam, R h1, R h2, R& c0,
                                                 R& c1, R& c2) {
  const R third = K<R>(1.0 / 3.0);
  const R h12 = h1 + h2;
  const R hh2 = dlam * dlam;
  const R hh3 = hh2 * dlam;
  // The coefficients' shared terms; x * hh2 * 0.5 = x * (hh2 * 0.5) bit for
  // bit (halving is exact).
  const R t3 = hh3 * third;
  const R t2 = hh2 * 0.5f;
  c0 = divr<APPROX>(
      madd<APPROX>(h1 * h12, dlam, madd<APPROX>(2.0f * h1 + h2, t2, t3)),
      h1 * h12);
  c1 = -divr<APPROX>(madd<APPROX>(h12, t2, t3), h1 * h2);
  c2 = divr<APPROX>(madd<APPROX>(h1, t2, t3), h2 * h12);
}

// One AB3 step of a live ray after the bootstrap (ops/march.py::
// march_tile_ab3; the body of march_ray_ab3's loop). One right-hand side
// per step: y_{n+1} = y_n + c0 f_n + c1 f_{n-1} + c2 f_{n-2} with the
// variable-step Lagrange-integral coefficients of the step history
// (h = dlam, h1, h2), the step growth bounded by dlam <= 2 h1, and the
// renormalization at the per-ray cadence mp.ab3_renorm_every (countdown
// rn from ab3_renorm_start). LOCAL: record_step's.
template <bool APPROX, bool LOCAL, class R>
__device__ __forceinline__ void ab3_step(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph, R pph,
    R thr, int& rn, R s[6], R f1[6], R f2[6], R& h1, R& h2, int& hit,
    int& nc, R cr[KMAX], R cp[KMAX], R ct[KMAX], int& steps, R& rmin) {
  R f0[6], y[6];
  ks_rhs<APPROX>(m, a, s[1], s[2], s[4], s[5], pph, f0);
  const R dlam = jmin(
      step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, s[1], s[2], s[5]),
      2.0f * h1);
  R c0, c1, c2;
  ab3_coefficients<APPROX>(dlam, h1, h2, c0, c1, c2);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    y[k] = madd<APPROX>(c2, f2[k],
                        madd<APPROX>(c1, f1[k], madd<APPROX>(c0, f0[k], s[k])));
  y[2] = jclip(y[2], K<R>(-1.0 + 1e-7), K<R>(1.0 - 1e-7));
  ab3_finish<APPROX, LOCAL>(mp, r_ph, thr, s, y, f0, dlam, f1, f2, h1, h2,
                            hit, nc, cr, cp, ct, steps, rmin);
  if (renorm_due(rn, mp.ab3_renorm_every) && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
}

// AB3's right-hand-side history as a ring in shared memory (the float64
// march kernel's AB3 instantiation, march.cu): three slots of six rows in
// the lane's own column of the block's array, slot q's row k at
// col[(6 * q + k) * STRIDE] (STRIDE: the block's threads, so a warp's 32
// lanes touch 32 consecutive words). Step i's right-hand side lives in slot
// i mod 3: a step reads the slots of steps i - 1 and i - 2 and writes its
// own over step i - 3's, so that no step shifts the history (ab3_finish's
// twelve copies) and the history holds no register.
template <class R, int STRIDE>
struct Ab3Ring {
  R* col;
  __device__ __forceinline__ R& at(int slot, int k) const {
    return col[(6 * slot + k) * STRIDE];
  }
  __device__ __forceinline__ void put(int slot, const R f[6]) const {
#pragma unroll
    for (int k = 0; k < 6; ++k) at(slot, k) = f[k];
  }
};

// ab3_boot_step with the history in the ring: the right-hand side goes to
// slot ``slot`` (the step index, 0 or 1), the step sizes shift as there.
// The crossing slots are indexed (record_step's LOCAL).
template <bool APPROX, class R, int STRIDE>
__device__ __forceinline__ void ab3_ring_boot_step(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph, R pph,
    R thr, R s[6], const Ab3Ring<R, STRIDE>& ring, int slot, R& h1, R& h2,
    int& hit, int& nc, R cr[KMAX], R cp[KMAX], R ct[KMAX], int& steps,
    R& rmin) {
  R f0[6], y[6];
  ks_rhs<APPROX>(m, a, s[1], s[2], s[4], s[5], pph, f0);
  ring.put(slot, f0);
  const R dlam =
      step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, s[1], s[2], s[5]);
  midpoint_step<APPROX>(mp, m, a, dlam, s[0], s[1], s[2], s[3], s[4], s[5],
                        pph, y);
  ab3_record<APPROX, true>(mp, r_ph, thr, s, y, hit, nc, cr, cp, ct, steps,
                           rmin);
  h2 = h1;
  h1 = dlam;
}

// ab3_step with the history in the ring: the same expressions in the same
// order, f1 and f2 read from the slots before ``slot`` (step i mod 3), f0
// written to it. The crossing slots are indexed (record_step's LOCAL).
template <bool APPROX, class R, int STRIDE>
__device__ __forceinline__ void ab3_ring_step(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph, R pph,
    R thr, int& rn, R s[6], const Ab3Ring<R, STRIDE>& ring, int slot, R& h1,
    R& h2, int& hit, int& nc, R cr[KMAX], R cp[KMAX], R ct[KMAX],
    int& steps, R& rmin) {
  R f0[6], y[6];
  ks_rhs<APPROX>(m, a, s[1], s[2], s[4], s[5], pph, f0);
  const R dlam = jmin(
      step_size<APPROX>(mp, a, r_h, r_ph, inv_rph, s[1], s[2], s[5]),
      2.0f * h1);
  R c0, c1, c2;
  ab3_coefficients<APPROX>(dlam, h1, h2, c0, c1, c2);
  const int p1 = slot == 0 ? 2 : slot - 1;
  const int p2 = p1 == 0 ? 2 : p1 - 1;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    y[k] = madd<APPROX>(
        c2, ring.at(p2, k),
        madd<APPROX>(c1, ring.at(p1, k), madd<APPROX>(c0, f0[k], s[k])));
  y[2] = jclip(y[2], K<R>(-1.0 + 1e-7), K<R>(1.0 - 1e-7));
  ring.put(slot, f0);
  ab3_record<APPROX, true>(mp, r_ph, thr, s, y, hit, nc, cr, cp, ct, steps,
                           rmin);
  h2 = h1;
  h1 = dlam;
  if (renorm_due(rn, mp.ab3_renorm_every) && hit == HIT_NONE)
    s[4] = ks_renormalize_pr(m, a, s[1], s[2], s[4], s[5], pph);
}

// The AB3 march of one ray (ops/march.py::march_tile_ab3; the JAX package's
// pallas_march.py::march_tile_ab3), march_ray's inputs and outputs: the two
// bootstrap steps, then a loop of ab3_step (prologue and end-of-march rule
// as ray_begin and ray_close have them for MARCH_AB3). The Pallas tile loop
// shares its step counter across a tile, but every ray's steps depend on
// that ray alone, so one thread per ray reproduces it; its renormalization
// at tile-exit block boundaries becomes the per-ray cadence
// mp.ab3_renorm_every / mp.ab3_tail_renorm. No Dual: the AB3 march has no
// gradient path.
template <bool APPROX, class R>
__device__ __forceinline__ void march_ray_ab3(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R pph, R thr, R s[6],
    int& hit, int& steps, int& nc, R cr[KMAX], R cp[KMAX], R ct[KMAX],
    R& rmin) {
  hit = s[1] < thr ? HIT_HORIZON : HIT_NONE;
  nc = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) cr[k] = cp[k] = ct[k] = 0.0f;
  rmin = dabs(s[1] - r_ph);
  steps = 0;
  R f1[6], f2[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) f1[k] = f2[k] = 0.0f;
  R h1 = mp.min_step, h2 = mp.min_step;
  const R inv_rph = inv_rph_of(r_ph);
  int i = 0;
  // the bootstrap, unrolled: two copies of the midpoint step ahead of the
  // loop, none inside it
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (i < mp.max_steps && hit == HIT_NONE) {
      ab3_boot_step<APPROX, true>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, s,
                                  f1, f2, h1, h2, hit, nc, cr, cp, ct, steps,
                                  rmin);
      ++i;
    }
  }
  int rn = ab3_renorm_start(mp.ab3_renorm_every);
  for (; i < mp.max_steps && hit == HIT_NONE; ++i)
    ab3_step<APPROX, true>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, f1,
                           f2, h1, h2, hit, nc, cr, cp, ct, steps, rmin);
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
// and termination radius, the step index i, the renormalization countdown
// rn, hit, the live step count, the crossing slots and their count, the
// photon-ring proximity; with jets the emission summed over the live
// steps; with AB3 the two right-hand-side histories and step sizes. The
// march kernel keeps one in registers per lane and marches it a step at a
// time, so that a lane whose ray has ended takes the next ray while the
// rest of its warp marches on; fields a variant does not use cost it no
// register. R: float or double.
template <int MARCH, class R>
struct MarchRay {
  R s[6];
  R pph, thr;
  int hit, steps, nc, i, rn;
  R cr[KMAX], cp[KMAX], ct[KMAX], rmin;
  R jet[3];
  R f1[6], f2[6], h1, h2;
};

// The float64 AB3 march's lane state (march.cu's march_kernel_f64<
// MARCH_AB3>), which holds no array but the state: its history of
// right-hand sides lives in a ring in shared memory (Ab3Ring,
// ray_boot_ring, ray_step_ring), its crossing slots in an array of the
// kernel's own that cr, cp and ct point into (indexed by the crossing
// count, written on a crossing and read once, in local memory). The whole
// MarchRay in double (328 bytes) sat in a stack frame of that size, its
// fields stored to local memory every step (tools/march_census.py,
// PERF.md); this one stays in registers.
template <>
struct MarchRay<MARCH_AB3, double> {
  double s[6];
  double pph, thr;
  int hit, steps, nc, i, rn;
  double *cr, *cp, *ct;
  double rmin;
  double h1, h2;
};

// AB3's history at a ray's birth: no right-hand side yet (zeros, which no
// step reads: the bootstrap writes both before the first AB3 step) and
// both step sizes min_step. The ring's lane state has no f1, f2.
template <int MARCH, class R>
__device__ __forceinline__ void ab3_history_begin(const MarchParamsT<R>& mp,
                                                  MarchRay<MARCH, R>& q) {
#pragma unroll
  for (int k = 0; k < 6; ++k) q.f1[k] = q.f2[k] = 0.0f;
  q.h1 = q.h2 = mp.min_step;
}
__device__ __forceinline__ void ab3_history_begin(
    const MarchParamsT<double>& mp, MarchRay<MARCH_AB3, double>& q) {
  q.h1 = q.h2 = mp.min_step;
}

// The end of the march on a ray still live after max_steps steps: AB3's
// tail renormalization, then hit = HIT_HORIZON (march_ray's own rule).
template <int MARCH, class R>
__device__ __forceinline__ void ray_close(const MarchParamsT<R>& mp, R m, R a,
                                          MarchRay<MARCH, R>& q) {
  if (q.hit == HIT_NONE && q.i >= mp.max_steps) {
    if (MARCH == MARCH_AB3 && mp.ab3_tail_renorm)
      q.s[4] = ks_renormalize_pr(m, a, q.s[1], q.s[2], q.s[4], q.s[5], q.pph);
    q.hit = HIT_HORIZON;
  }
}

// Birth of the march: q.s, q.pph and q.thr set by the caller; march_ray's
// prologue (a ray born inside its termination radius has ended).
template <int MARCH, class R>
__device__ __forceinline__ void ray_begin(const MarchParamsT<R>& mp, R m, R a,
                                          R r_ph, MarchRay<MARCH, R>& q) {
  q.hit = q.s[1] < q.thr ? HIT_HORIZON : HIT_NONE;
  q.nc = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) q.cr[k] = q.cp[k] = q.ct[k] = 0.0f;
  q.rmin = dabs(q.s[1] - r_ph);
  q.steps = 0;
  q.i = 0;
  q.rn = MARCH == MARCH_AB3 ? ab3_renorm_start(mp.ab3_renorm_every)
                            : mp.renormalize_every;
  if constexpr (MARCH == MARCH_JETS) q.jet[0] = q.jet[1] = q.jet[2] = 0.0f;
  if constexpr (MARCH == MARCH_AB3) ab3_history_begin(mp, q);
  ray_close(mp, m, a, q);
}

// AB3's two bootstrap steps of a ray just born (ray_begin), each while the
// ray is live: march_ray_ab3's steps ahead of its loop, made lane state.
// The march kernel runs them where it births a ray, so that its step loop
// (ray_step) holds one right-hand side and no midpoint step. Nothing for
// the other variants.
template <int MARCH, bool APPROX, class R>
__device__ __forceinline__ void ray_boot(const MarchParamsT<R>& mp, R m, R a,
                                         R r_h, R r_ph, R inv_rph,
                                         MarchRay<MARCH, R>& q) {
  if (MARCH != MARCH_AB3) return;
  // unrolled, as march_ray_ab3's: no loop of its own beside the step loop
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (q.hit != HIT_NONE) break;
    ab3_boot_step<APPROX, false>(mp, m, a, r_h, r_ph, inv_rph, q.pph, q.thr,
                                 q.s, q.f1, q.f2, q.h1, q.h2, q.hit, q.nc,
                                 q.cr, q.cp, q.ct, q.steps, q.rmin);
    ++q.i;
    ray_close(mp, m, a, q);
  }
}

// One step of a live ray (q.hit == HIT_NONE, q.i < mp.max_steps): one
// iteration of march_ray's or march_ray_ab3's loops, the same functions in
// the same order (for AB3 after ray_boot, so a step past the bootstrap).
// Every ray's
// steps depend on that ray alone, so marching it a step at a time, in any
// lane and beside any other ray, gives the results of marching it in one
// loop. inv_rph: inv_rph_of(r_ph).
template <int MARCH, bool APPROX, class R>
__device__ __forceinline__ void ray_step(const MarchParamsT<R>& mp, R m, R a,
                                         R r_h, R r_ph, R inv_rph,
                                         const JetParamsT<R>& jp,
                                         MarchRay<MARCH, R>& q) {
  if (MARCH == MARCH_AB3) {
    ab3_step<APPROX, false>(mp, m, a, r_h, r_ph, inv_rph, q.pph, q.thr, q.rn,
                            q.s, q.f1, q.f2, q.h1, q.h2, q.hit, q.nc, q.cr,
                            q.cp, q.ct, q.steps, q.rmin);
  } else if (MARCH == MARCH_JETS) {
    jets_advance<APPROX, sizeof(R) == 8>(mp, m, a, r_h, r_ph, inv_rph, q.pph,
                                         q.thr, q.rn, q.s, q.hit, q.nc, jp,
                                         q.jet, q.cr, q.cp, q.ct, q.steps,
                                         q.rmin);
  } else {
    bool crossed, advance;
    R r_c, phi_c, t_c;
    march_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, q.pph, q.thr, q.rn, q.s,
                       q.hit, q.nc, crossed, advance, r_c, phi_c, t_c);
    record_step<sizeof(R) == 8>(crossed, advance, r_c, phi_c, t_c, q.s[1],
                                r_ph, q.nc, q.cr, q.cp, q.ct, q.steps,
                                q.rmin);
  }
  ++q.i;
  ray_close(mp, m, a, q);
}

// ray_boot and ray_step of an AB3 ray whose history lives in a ring
// (Ab3Ring) and whose crossing slots are indexed (the float64 lane state
// above): the bootstrap's right-hand sides go to ring slots 0 and 1, and
// ``slot``, the lane's step index mod 3, counts on from there. A ray born
// in a lane writes both bootstrap slots before its first AB3 step reads
// them, so nothing of the lane's previous ray is read.
template <bool APPROX, class R, int STRIDE>
__device__ __forceinline__ void ray_boot_ring(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph,
    MarchRay<MARCH_AB3, R>& q, const Ab3Ring<R, STRIDE>& ring, int& slot) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (q.hit != HIT_NONE) break;
    ab3_ring_boot_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, q.pph,
                                      q.thr, q.s, ring, b, q.h1, q.h2, q.hit,
                                      q.nc, q.cr, q.cp, q.ct, q.steps,
                                      q.rmin);
    ++q.i;
    ray_close(mp, m, a, q);
  }
  slot = 2;
}
template <bool APPROX, class R, int STRIDE>
__device__ __forceinline__ void ray_step_ring(
    const MarchParamsT<R>& mp, R m, R a, R r_h, R r_ph, R inv_rph,
    MarchRay<MARCH_AB3, R>& q, const Ab3Ring<R, STRIDE>& ring, int& slot) {
  ab3_ring_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, q.pph, q.thr,
                               q.rn, q.s, ring, slot, q.h1, q.h2, q.hit,
                               q.nc, q.cr, q.cp, q.ct, q.steps, q.rmin);
  slot = slot == 2 ? 0 : slot + 1;
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
