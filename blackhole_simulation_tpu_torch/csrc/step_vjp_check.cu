// A check of the gradient kernel's per-step derivative on the card: the
// hand-written reverse adjoint (march_adjoint.cuh::march_step_vjp) against
// the forward-mode Dual<N> pass over the same step (march_step.cuh's step on
// Dual<11> numbers, the gradient kernel's derivative before the adjoint),
// on the same states and cotangents. Not on any path of the port:
// chip_smoke.py and tests/test_torch_gpu.py launch it through
// ops/march_grad.py::step_vjp_check and renorm_vjp_check.
//
// step_vjp_check_kernel: one thread per ray marches the ray from its
// initial rows with the forward's float step and, at each of its first
// `steps` live steps, runs both derivatives on the pre-step state with the
// output cotangents the gradient kernel would form from cts: the six carry
// rows always, the crossing record's three where the step crossed, dmin's
// where it advanced. Besides both results it writes the pre-step state and,
// per input, the size of the derivative's terms: the step run on Mag<11>
// numbers, which carry for each input the sum of the absolute values of
// every term its derivative adds up (a forward-mode pass with |.| on every
// partial), dotted with |cotangent|. Float32 rounding moves either route's
// result by at most a small multiple of eps times that size, however much
// the terms cancel; a derivative rule that is wrong moves it by the size of
// a term.
//
// renorm_vjp_check_kernel: the renormalization's VJP alone
// (march_adjoint.cuh::renormalize_pr_vjp against ks_renormalize_pr on
// Dual<7>) on states the caller plants, such as a double root of its
// quadratic (a radial turning point), which a sample of real rays rarely
// holds at a renormalization step.
//
// minmax_check_kernel: march_step.cuh's float jmax and jmin (one FMNMX
// each) against the compare-compare-select form they replaced, on pairs
// the caller plants (signed zeros, NaN, infinities, denormals).

#include "march_adjoint.cuh"

#define THREADS 128

// A value and, per input, the sum of the absolute values of the terms of
// its derivative: the dual rules with each partial's magnitude.
template <int N>
struct Mag {
  float v;
  float m[N];
  __device__ __forceinline__ Mag() {}
  __device__ __forceinline__ Mag(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) m[i] = 0.0f;
  }
};

#define MAG_LOOP _Pragma("unroll") for (int i = 0; i < N; ++i)
#define MAG_OP(expr_v, expr_m) \
  Mag<N> o;                    \
  o.v = expr_v;                \
  MAG_LOOP o.m[i] = expr_m;    \
  return o;

template <int N>
__device__ __forceinline__ Mag<N> operator-(const Mag<N>& a) {
  MAG_OP(-a.v, a.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator+(const Mag<N>& a, const Mag<N>& b) {
  MAG_OP(a.v + b.v, a.m[i] + b.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator+(const Mag<N>& a, float b) {
  MAG_OP(a.v + b, a.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator+(float a, const Mag<N>& b) {
  MAG_OP(a + b.v, b.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator-(const Mag<N>& a, const Mag<N>& b) {
  MAG_OP(a.v - b.v, a.m[i] + b.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator-(const Mag<N>& a, float b) {
  MAG_OP(a.v - b, a.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator-(float a, const Mag<N>& b) {
  MAG_OP(a - b.v, b.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator*(const Mag<N>& a, const Mag<N>& b) {
  MAG_OP(a.v * b.v, a.m[i] * fabsf(b.v) + fabsf(a.v) * b.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator*(const Mag<N>& a, float b) {
  MAG_OP(a.v * b, a.m[i] * fabsf(b))
}
template <int N>
__device__ __forceinline__ Mag<N> operator*(float a, const Mag<N>& b) {
  MAG_OP(a * b.v, fabsf(a) * b.m[i])
}
template <int N>
__device__ __forceinline__ Mag<N> operator/(const Mag<N>& a, const Mag<N>& b) {
  MAG_OP(a.v / b.v, (a.m[i] + fabsf(o.v) * b.m[i]) / fabsf(b.v))
}
template <int N>
__device__ __forceinline__ Mag<N> operator/(const Mag<N>& a, float b) {
  MAG_OP(a.v / b, a.m[i] / fabsf(b))
}
template <int N>
__device__ __forceinline__ Mag<N> operator/(float a, const Mag<N>& b) {
  MAG_OP(a / b.v, fabsf(o.v) * b.m[i] / fabsf(b.v))
}
template <int N>
__device__ __forceinline__ float val(const Mag<N>& x) {
  return x.v;
}
// A tie of max or min takes half of each side's tangent.
template <int N>
__device__ __forceinline__ Mag<N> jmax(const Mag<N>& a, const Mag<N>& b) {
  if (a.v == b.v) { MAG_OP(a.v, 0.5f * (a.m[i] + b.m[i])) }
  return (a.v > b.v || a.v != a.v) ? a : b;
}
template <int N>
__device__ __forceinline__ Mag<N> jmin(const Mag<N>& a, const Mag<N>& b) {
  if (a.v == b.v) { MAG_OP(a.v, 0.5f * (a.m[i] + b.m[i])) }
  return (a.v < b.v || a.v != a.v) ? a : b;
}
template <int N>
__device__ __forceinline__ Mag<N> jclip(const Mag<N>& x, const Mag<N>& lo,
                                        const Mag<N>& hi) {
  return jmin(jmax(x, lo), hi);
}
template <int N>
__device__ __forceinline__ Mag<N> dabs(const Mag<N>& x) {
  MAG_OP(fabsf(x.v), x.v != 0.0f ? x.m[i] : 0.0f)
}
template <int N>
__device__ __forceinline__ Mag<N> dsqrt(const Mag<N>& x) {
  MAG_OP(sqrtf(x.v), x.m[i] * 0.5f / o.v)
}
template <int N>
__device__ __forceinline__ Mag<N> rcp_approx(const Mag<N>& x) {
  MAG_OP(rcp_approx(x.v), o.v * o.v * x.m[i])
}
// The value by the step's fused operation (march_step.cuh::madd).
template <int N>
__device__ __forceinline__ Mag<N> fmadd(const Mag<N>& a, const Mag<N>& b,
                                        const Mag<N>& c) {
  MAG_OP(__fmaf_rn(a.v, b.v, c.v),
         a.m[i] * fabsf(b.v) + fabsf(a.v) * b.m[i] + c.m[i])
}

// A number's tangent (Dual) or term size (Mag) along input k, and the
// seed of input k's direction.
template <int ND>
__device__ __forceinline__ float tangent(const Dual<ND>& x, int k) {
  return x.d[k];
}
template <int ND>
__device__ __forceinline__ float tangent(const Mag<ND>& x, int k) {
  return x.m[k];
}
template <int ND>
__device__ __forceinline__ void seed(Dual<ND>& x, int k) { x.d[k] = 1.0f; }
template <int ND>
__device__ __forceinline__ void seed(Mag<ND>& x, int k) { x.m[k] = 1.0f; }
__device__ __forceinline__ float weight(float c, bool size) {
  return size ? fabsf(c) : c;
}

// One forward pass of the step on D = Dual<NIN> (the Jacobian's columns)
// or Mag<NIN> (their term sizes), dotted with the output cotangents cto (by
// their absolute values for Mag) into cin. A zero cotangent contributes
// nothing, even where a discarded partial is not finite.
template <class D, bool SIZE, bool APPROX>
__device__ __forceinline__ void jvp_pass(const MarchParams& mp,
                                         const float x[NIN], float thr, int i,
                                         int nc, const float cto[NOUT],
                                         float cin[NIN]) {
  D xd[NIN];
#pragma unroll
  for (int q = 0; q < NIN; ++q) {
    xd[q] = D(x[q]);
    seed(xd[q], q);
  }
  D s[6] = {xd[0], xd[1], xd[2], xd[3], xd[4], xd[5]};
  int hit = HIT_NONE;
  bool crossed, advance;
  D r_c, phi_c, t_c;
  int rn = renorm_start(i, mp.renormalize_every);
  march_step<APPROX>(mp, xd[7], xd[8], xd[9], xd[10], inv_rph_of(xd[10]),
                     xd[6], thr, rn, s, hit, nc, crossed, advance, r_c, phi_c,
                     t_c);
  const D dmin = dabs(s[1] - xd[10]);
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    const float part[NOUT] = {
        tangent(s[0], k), tangent(s[1], k),   tangent(s[2], k),
        tangent(s[3], k), tangent(s[4], k),   tangent(s[5], k),
        tangent(r_c, k),  tangent(phi_c, k),  tangent(t_c, k),
        tangent(dmin, k)};
    float acc = 0.0f;
#pragma unroll
    for (int o = 0; o < NOUT; ++o)
      if (cto[o] != 0.0f) acc = acc + weight(cto[o], SIZE) * part[o];
    cin[k] = acc;
  }
}

// P: (4,) [m, a, r_h, r_ph]; y: (7, n) initial rows; thr: (n,); cts:
// (10, n) cotangents; adj, dual, mag: (11, steps, n) out, each live step's
// input cotangents by the two routes and their term sizes; st:
// (7, steps, n) out, the pre-step state (t, r, u, ph, pr, pu) and crossing
// count; live: (steps, n) out, 1 where step i ran. APPROX:
// MarchConfig.approx_recip, chosen at launch.
template <bool APPROX>
__global__ void __launch_bounds__(THREADS)
step_vjp_check_kernel(const float* __restrict__ P,
                      const float* __restrict__ y,
                      const float* __restrict__ thr_in,
                      const float* __restrict__ cts, float* __restrict__ adj,
                      float* __restrict__ dual, float* __restrict__ mag,
                      float* __restrict__ st, int* __restrict__ live, int n,
                      int steps, const MarchParams mp) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const size_t plane = (size_t)steps * N;
  const float m = P[0], a = P[1], r_h = P[2], r_ph = P[3];
  const float inv_rph = inv_rph_of(r_ph);
  const float thr = thr_in[j];
  const float pph = y[6 * N + j];
  float s[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = y[k * N + j];
  float ct[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) ct[k] = cts[k * N + j];
  int hit = s[1] < thr ? HIT_HORIZON : HIT_NONE;
  int nc = 0;
  int rn = mp.renormalize_every;
  for (int i = 0; i < steps; ++i) {
    const size_t at = (size_t)i * N + j;
    if (hit != HIT_NONE || i >= mp.max_steps) {
      live[at] = 0;
      continue;
    }
    live[at] = 1;
    const float x[NIN] = {s[0], s[1], s[2], s[3], s[4], s[5],
                          pph,  m,    a,    r_h,  r_ph};
#pragma unroll
    for (int k = 0; k < 6; ++k) st[k * plane + at] = s[k];
    st[6 * plane + at] = (float)nc;
    auto inject = [&](bool crossed, bool advance, float dmin, float* cto) {
#pragma unroll
      for (int k = 0; k < NOUT; ++k) cto[k] = ct[k];
      if (!crossed) cto[6] = cto[7] = cto[8] = 0.0f;
      if (!advance) cto[9] = 0.0f;
    };
    float cin[NIN], size[NIN];
    march_step_vjp<APPROX>(mp, x, thr, i, nc, inject, cin);
#pragma unroll
    for (int k = 0; k < NIN; ++k) adj[k * plane + at] = cin[k];

    bool crossed, advance;
    float r_c, phi_c, t_c;
    march_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, hit, nc,
                       crossed, advance, r_c, phi_c, t_c);
    float cto[NOUT];
    inject(crossed, advance, 0.0f, cto);
    jvp_pass<Dual<NIN>, false, APPROX>(mp, x, thr, i, nc, cto, cin);
    jvp_pass<Mag<NIN>, true, APPROX>(mp, x, thr, i, nc, cto, size);
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      dual[k * plane + at] = cin[k];
      mag[k * plane + at] = size[k];
    }
    nc += crossed ? 1 : 0;
  }
}

// q: (8, n) rows m, a, r, u, pr, pu, pph and the cotangent g of the
// projected p_r; adj, dual: (7, n) out, the cotangents of (m, a, r, u, pr,
// pu, pph) by the adjoint and by the Dual<7> pass (0 where g is 0).
__global__ void __launch_bounds__(THREADS)
renorm_vjp_check_kernel(const float* __restrict__ q, float* __restrict__ adj,
                        float* __restrict__ dual, int n) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const size_t N = (size_t)n;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = q[k * N + j];
  float gp[7];
  renormalize_pr_vjp(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], gp);
  typedef Dual<7> D;
  D xd[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    xd[k] = D(v[k]);
    xd[k].d[k] = 1.0f;
  }
  const D pr = ks_renormalize_pr(xd[0], xd[1], xd[2], xd[3], xd[4], xd[5],
                                 xd[6]);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    adj[k * N + j] = gp[k];
    dual[k * N + j] = v[7] != 0.0f ? v[7] * pr.d[k] : 0.0f;
  }
}

// out: (4, n), per pair (a, b): jmax(a, b), the old form of it, jmin(a, b),
// the old form of it.
__global__ void __launch_bounds__(THREADS)
minmax_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int n) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const float x = a[j], y = b[j];
  out[j] = jmax(x, y);
  out[N + j] = (x > y || x != x) ? x : y;
  out[2 * N + j] = jmin(x, y);
  out[3 * N + j] = (x < y || x != x) ? x : y;
}

extern "C" {

int bh_step_vjp_check_launch(const float* P, const float* y, const float* thr,
                             const float* cts, float* adj, float* dual,
                             float* mag, float* st, int* live, int n,
                             int steps, const MarchParams* mp, void* stream) {
  if (n > 0) {
    auto kernel = mp->approx_recip ? step_vjp_check_kernel<true>
                                   : step_vjp_check_kernel<false>;
    kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        P, y, thr, cts, adj, dual, mag, st, live, n, steps, *mp);
  }
  return (int)cudaGetLastError();
}

int bh_renorm_vjp_check_launch(const float* q, float* adj, float* dual,
                               int n, void* stream) {
  if (n > 0) {
    renorm_vjp_check_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                              (cudaStream_t)stream>>>(q, adj, dual, n);
  }
  return (int)cudaGetLastError();
}

int bh_minmax_check_launch(const float* a, const float* b, float* out, int n,
                           void* stream) {
  if (n > 0) {
    minmax_check_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(a, b, out, n);
  }
  return (int)cudaGetLastError();
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

}  // extern "C"
