// Gradient kernel for Hopper (sm_90a): the reverse-mode derivative (VJP) of
// the march kernel, one thread per ray.
//
// Replaces blackhole_simulation_tpu/ops/pallas_grad.py::_grad_kernel (the
// Pallas TPU kernel launched by pallas_march_grad). Given the cotangents of
// the march's outputs (final state rows, crossing records, r_min), it
// returns the cotangents of the 7 initial rows (t, r, u, ph, p_r, p_u,
// p_phi) and each ray's partials for (m, a, r_h, r_ph), which the wrapper
// (ops/march_grad.py::march_grad_kernel) sums. The plain PyTorch version is
// ops/march_grad.py::march_grad, written with the same structure. Built by
// ops/build.py like march.cu and loaded through ctypes.
//
// Checkpoint and replay, not reverse integration:
// 1. Replay the forward march from the initial rows and store the state
//    (6 floats, hit, crossing count) at the start of every block of CKPT
//    steps. The replay is march_step.cuh's step, the forward's own source,
//    so masks, crossing slots and freeze points land on the same steps.
// 2. Walk the blocks in reverse. Re-forward a live block from its
//    checkpoint into a CKPT-step stack, then run the per-step VJP backwards
//    through the stack. Steps of a ray that has stopped are the identity on
//    the carry and are skipped; with MarchConfig.cotangent_clip > 0 the
//    incoming carry cotangent is clipped once for them (the clip is
//    idempotent) and before each live step's VJP.
// 3. Cotangent injection: a crossing record's cotangent enters at the step
//    that recorded it (crossed and replayed count == slot); the r_min
//    cotangent enters at the last step whose |r - r_ph| equals the
//    forward's r_min, or at the initial radius when no step reached it.
//
// The per-step VJP: the step (march_step.cuh, with the advance/freeze
// selects and the boundary renormalization) runs on Dual<NDUAL> numbers,
// NDUAL forward-mode tangent directions at a time, over the 11 inputs
// (6 state rows, p_phi, m, a, r_h, r_ph). Each pass gives NDUAL columns of
// the step's Jacobian; their dot products with the output cotangents are
// NDUAL entries of J^T ct. ceil(11 / NDUAL) passes per live step. The
// forward and its derivative come from one source; the approximate
// reciprocal's derivative uses the approximate value (-y^2). NDUAL = 11
// (one pass) computes the primal once per live step instead of once per
// pass; it needs 255 registers and spills nothing (ptxas, sm_90a). Every
// width gives the same result bit for bit.
//
// What bounds it on the H100: FP32 arithmetic, as the march: per live step
// one replay step, one re-forward step and the dual passes (each a step
// with NDUAL tangent lanes), plus a float step for the primal test values.
// Memory: the checkpoints and the stack live in a global scratch buffer
// the wrapper allocates, (ceil(max_steps / CKPT) + CKPT) x 8 words per ray,
// laid out [slot][word][ray] so a warp's stores coalesce.

#include "march_step.cuh"

#define THREADS 128
#define CKPT 32
#define NIN 11   // t, r, u, ph, pr, pu, pph, m, a, r_h, r_ph
#define NOUT 10  // 6 state rows, r_c, phi_c, t_c, dmin
#define NDUAL 11

__device__ __forceinline__ void clip6(float c[6], float limit) {
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) ss = ss + c[k] * c[k];
  const float norm = sqrtf(ss);
  const float scale = jmin(1.0f, limit / jmax(norm, F(1e-30)));
#pragma unroll
  for (int k = 0; k < 6; ++k) c[k] = c[k] * scale;
}

// One dual pass: the Jacobian columns of inputs G .. G + ND - 1, dotted
// with the output cotangents cto into cin.
template <int ND, int G>
__device__ __forceinline__ void jvp_pass(const MarchParams& mp, bool approx,
                                         const float x[NIN], float thr, int i,
                                         int nc, const float cto[NOUT],
                                         float cin[NIN]) {
  typedef Dual<ND> D;
  D xd[NIN];
#pragma unroll
  for (int q = 0; q < NIN; ++q) {
    xd[q] = D(x[q]);
    if (q >= G && q < G + ND) xd[q].d[q - G] = 1.0f;
  }
  D s[6] = {xd[0], xd[1], xd[2], xd[3], xd[4], xd[5]};
  int hit = HIT_NONE;
  bool crossed, advance;
  D r_c, phi_c, t_c;
  march_step(mp, approx, xd[7], xd[8], xd[9], xd[10], xd[6], thr, i, s, hit,
             nc, crossed, advance, r_c, phi_c, t_c);
  const D dmin = dabs(s[1] - xd[10]);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    if (G + k < NIN) {
      // A zero cotangent contributes nothing, even where a discarded
      // partial is not finite.
      float acc = 0.0f;
#pragma unroll
      for (int o = 0; o < 6; ++o)
        if (cto[o] != 0.0f) acc = acc + cto[o] * s[o].d[k];
      if (cto[6] != 0.0f) acc = acc + cto[6] * r_c.d[k];
      if (cto[7] != 0.0f) acc = acc + cto[7] * phi_c.d[k];
      if (cto[8] != 0.0f) acc = acc + cto[8] * t_c.d[k];
      if (cto[9] != 0.0f) acc = acc + cto[9] * dmin.d[k];
      cin[G + k] = acc;
    }
  }
}

template <int ND, int G>
__device__ __forceinline__ void jvp_passes(const MarchParams& mp, bool approx,
                                           const float x[NIN], float thr,
                                           int i, int nc,
                                           const float cto[NOUT],
                                           float cin[NIN]) {
  if constexpr (G < NIN) {
    jvp_pass<ND, G>(mp, approx, x, thr, i, nc, cto, cin);
    jvp_passes<ND, G + ND>(mp, approx, x, thr, i, nc, cto, cin);
  }
}

__global__ void __launch_bounds__(THREADS)
march_grad_kernel(const float* __restrict__ P, const float* __restrict__ y,
                  const float* __restrict__ thr_in,
                  const float* __restrict__ ctf,
                  const float* __restrict__ ctc,
                  const float* __restrict__ ctr,
                  const float* __restrict__ rminf,
                  float* __restrict__ cty0, float* __restrict__ ctp,
                  float* __restrict__ scratch, int n, int n_blocks,
                  const MarchParams mp, float clip) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const bool approx = mp.approx_recip != 0;
  const int K = mp.max_crossings;
  const float m = __ldg(P + 0);
  const float a = __ldg(P + 1);
  const float r_h = __ldg(P + 2);
  const float r_ph = __ldg(P + 3);
  const float thr = thr_in[j];
  const float rmin_fin = rminf[j];
  float y0[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) y0[k] = y[k * N + j];
  const float pph = y0[6];
  float* ck = scratch;                               // [n_blocks][8][N]
  float* stack = scratch + (size_t)n_blocks * 8 * N;  // [CKPT][8][N]

  // ---- phase 1: replay, checkpoint at the start of every block ----
  float s[6] = {y0[0], y0[1], y0[2], y0[3], y0[4], y0[5]};
  int hit = y0[1] < thr ? HIT_HORIZON : HIT_NONE;
  int nc = 0;
  for (int b = 0; b < n_blocks; ++b) {
    float* slot = ck + (size_t)b * 8 * N + j;
#pragma unroll
    for (int k = 0; k < 6; ++k) slot[k * N] = s[k];
    slot[6 * N] = __int_as_float(hit);
    slot[7 * N] = __int_as_float(nc);
    const int i1 = min((b + 1) * CKPT, mp.max_steps);
    for (int i = b * CKPT; i < i1 && hit == HIT_NONE; ++i) {
      bool crossed, advance;
      float r_c, phi_c, t_c;
      march_step(mp, approx, m, a, r_h, r_ph, pph, thr, i, s, hit, nc,
                 crossed, advance, r_c, phi_c, t_c);
      nc += crossed ? 1 : 0;
    }
  }

  // ---- phase 2: reverse sweep over blocks ----
  float c6[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) c6[k] = ctf[k * N + j];
  float c_pph = ctf[6 * N + j];
  float c_m = 0.0f, c_a = 0.0f, c_rh = 0.0f, c_rph = 0.0f;
  const float ct_rmin = ctr[j];
  bool injected = false;
  // The steps after the ray stopped (the identity) clip the carry once.
  if (clip > 0.0f) clip6(c6, clip);

  for (int b = n_blocks - 1; b >= 0; --b) {
    const float* slot = ck + (size_t)b * 8 * N + j;
    if (__float_as_int(slot[6 * N]) != HIT_NONE) continue;
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = slot[k * N];
    hit = HIT_NONE;
    nc = __float_as_int(slot[7 * N]);
    // re-forward the block's live steps into the stack
    const int i0 = b * CKPT;
    const int i1 = min(i0 + CKPT, mp.max_steps);
    int n_live = 0;
    for (int i = i0; i < i1 && hit == HIT_NONE; ++i, ++n_live) {
      float* e = stack + (size_t)n_live * 8 * N + j;
#pragma unroll
      for (int k = 0; k < 6; ++k) e[k * N] = s[k];
      e[7 * N] = __int_as_float(nc);
      bool crossed, advance;
      float r_c, phi_c, t_c;
      march_step(mp, approx, m, a, r_h, r_ph, pph, thr, i, s, hit, nc,
                 crossed, advance, r_c, phi_c, t_c);
      nc += crossed ? 1 : 0;
    }
    // backward through the stack
    for (int q = n_live - 1; q >= 0; --q) {
      const int i = i0 + q;
      const float* e = stack + (size_t)q * 8 * N + j;
      float x[NIN];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = e[k * N];
      const int nc_q = __float_as_int(e[7 * N]);
      x[6] = pph;
      x[7] = m;
      x[8] = a;
      x[9] = r_h;
      x[10] = r_ph;
      if (clip > 0.0f) clip6(c6, clip);

      // Primal values of the step: which cotangents enter here.
      float sp[6] = {x[0], x[1], x[2], x[3], x[4], x[5]};
      int hit_q = HIT_NONE;
      bool crossed, advance;
      float r_c, phi_c, t_c;
      march_step(mp, approx, m, a, r_h, r_ph, pph, thr, i, sp, hit_q, nc_q,
                 crossed, advance, r_c, phi_c, t_c);
      const float dmin = fabsf(sp[1] - r_ph);
      float cto[NOUT];
#pragma unroll
      for (int k = 0; k < 6; ++k) cto[k] = c6[k];
      cto[6] = cto[7] = cto[8] = 0.0f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K && crossed && nc_q == k) {
          cto[6] = ctc[k * N + j];
          cto[7] = ctc[(K + k) * N + j];
          cto[8] = ctc[(2 * K + k) * N + j];
        }
      }
      const bool hitmin = advance && dmin == rmin_fin && !injected;
      cto[9] = hitmin ? ct_rmin : 0.0f;
      if (hitmin) injected = true;

      float cin[NIN];
      jvp_passes<NDUAL, 0>(mp, approx, x, thr, i, nc_q, cto, cin);
#pragma unroll
      for (int k = 0; k < 6; ++k) c6[k] = cin[k];
      c_pph = c_pph + cin[6];
      c_m = c_m + cin[7];
      c_a = c_a + cin[8];
      c_rh = c_rh + cin[9];
      c_rph = c_rph + cin[10];
    }
  }

  // r_min's initial-value case: no step came closer than |r0 - r_ph|.
  const float d0 = y0[1] - r_ph;
  if (!injected && fabsf(d0) == rmin_fin) {
    const float sgn = d0 > 0.0f ? 1.0f : (d0 < 0.0f ? -1.0f : 0.0f);
    c6[1] = c6[1] + ct_rmin * sgn;
    c_rph = c_rph + (-ct_rmin * sgn);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) cty0[k * N + j] = c6[k];
  cty0[6 * N + j] = c_pph;
  ctp[j] = c_m;
  ctp[N + j] = c_a;
  ctp[2 * N + j] = c_rh;
  ctp[3 * N + j] = c_rph;
}

extern "C" {

// Launches the gradient kernel on ``stream``; returns cudaGetLastError().
// P: (4,) [m, a, r_h, r_ph]; y: (7, n) initial rows (t, r, u, ph, pr, pu,
// pph) with p_t = -1; thr: (n,); ctf: (7, n); ctc: (3K, n); ctr, rminf:
// (n,); cty0: (7, n) out; ctp: (4, n) out; scratch: bh_march_grad_scratch
// words per ray.
int bh_march_grad_launch(const float* P, const float* y, const float* thr,
                         const float* ctf, const float* ctc, const float* ctr,
                         const float* rminf, float* cty0, float* ctp,
                         float* scratch, int n, const MarchParams* mp,
                         float clip, void* stream) {
  const int n_blocks = (mp->max_steps + CKPT - 1) / CKPT;
  if (n > 0) {
    march_grad_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        (cudaStream_t)stream>>>(P, y, thr, ctf, ctc, ctr,
                                                rminf, cty0, ctp, scratch, n,
                                                n_blocks, *mp, clip);
  }
  return (int)cudaGetLastError();
}

// Scratch words per ray: the checkpoints and the re-forward stack.
int bh_march_grad_scratch(int max_steps) {
  return ((max_steps + CKPT - 1) / CKPT + CKPT) * 8;
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

}  // extern "C"
