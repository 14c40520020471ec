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
//    (6 floats and the crossing count) at the start of every block of CKPT
//    steps that the ray enters live, in a global scratch buffer, written
//    once and read once. The replay is march_step.cuh's step, the
//    forward's own source, so masks, crossing slots and freeze points land
//    on the same steps.
// 2. Walk the ray's live blocks in reverse. Re-forward a block from its
//    checkpoint into a CKPT-step stack in shared memory, then run the
//    per-step VJP backwards through the stack. Steps of a ray that has
//    stopped are the identity on the carry and are skipped; with
//    MarchConfig.cotangent_clip > 0 the incoming carry cotangent is clipped
//    once for them (the clip is idempotent) and before each live step's VJP.
// 3. Cotangent injection: a crossing record's cotangent enters at the step
//    that recorded it (crossed and replayed count == slot); the r_min
//    cotangent enters at the last step whose |r - r_ph| equals the
//    forward's r_min, or at the initial radius when no step reached it.
//
// The per-step VJP is march_adjoint.cuh's hand-written reverse adjoint of
// the step (the forward recomputed, then walked back), which also gives the
// step's crossed, advance and dmin for the injection.
//
// Jets (the JETS instantiation, chosen when the caller passes JetParams):
// the march kernel's jets march sums the jets' emission of every live step
// into a (3, n) radiance, whose cotangent is the same at every step. The
// replay and the checkpoints are the midpoint march's (the emission does
// not feed the state); each live step's VJP adds the emission's
// (march_adjoint.cuh::jet_emission_vjp), as jax.grad of the JAX package's
// jnp march takes it. The JAX gradient kernel has no jets: the JAX package
// differentiates a jets march by jnp AD, never on its gradient kernel. The
// other instantiations compile without the jets' code.
//
// What bounds it on the H100: FP32 arithmetic, as the march: per live step
// one replay step, one re-forward step and the adjoint (a forward step and
// the reverse of its right-hand sides). The step is a long dependent FP32
// chain, so its latency hides only behind other warps: __launch_bounds__
// caps the registers at 65,536 / (THREADS x MIN_BLOCKS) and the stack of
// CKPT x 7 words per thread fits MIN_BLOCKS blocks in an SM's shared
// memory, for MIN_BLOCKS x THREADS / 32 resident warps. The stack is laid
// out [step][word][thread], so a warp's 32 accesses fall in 32 banks.

#include "march_adjoint.cuh"

#define THREADS 128
#define MIN_BLOCKS 4
#define CKPT 8
#define WORDS 7  // per checkpoint and stacked step: 6 state floats, nc
#define SMEM_BYTES (CKPT * WORDS * THREADS * 4)

// APPROX: MarchConfig.approx_recip, chosen at launch (the step's reciprocals
// and its contracted multiply-adds, march_step.cuh); JETS: the jets' march
// (ctj: the (3, n) cotangent of its radiance, jp: the jets' configuration).
template <bool APPROX, bool JETS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
march_grad_kernel(const float* __restrict__ P, const float* __restrict__ y,
                  const float* __restrict__ thr_in,
                  const float* __restrict__ ctf,
                  const float* __restrict__ ctc,
                  const float* __restrict__ ctr,
                  const float* __restrict__ rminf,
                  float* __restrict__ cty0, float* __restrict__ ctp,
                  float* __restrict__ scratch,
                  int* __restrict__ replay, int n, int n_blocks,
                  const MarchParams mp, float clip,
                  const float* __restrict__ ctj, const JetParams jp) {
  extern __shared__ float stack[];  // [CKPT][WORDS][THREADS]
  const int tid = threadIdx.x;
  const int j = blockIdx.x * THREADS + tid;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const int K = mp.max_crossings;
  const float m = __ldg(P + 0);
  const float a = __ldg(P + 1);
  const float r_h = __ldg(P + 2);
  const float r_ph = __ldg(P + 3);
  const float inv_rph = inv_rph_of(r_ph);
  const float thr = thr_in[j];
  const float rmin_fin = rminf[j];
  float y0[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) y0[k] = y[k * N + j];
  const float pph = y0[6];

  // ---- phase 1: replay, checkpoint at the start of every live block ----
  float s[6] = {y0[0], y0[1], y0[2], y0[3], y0[4], y0[5]};
  int hit = y0[1] < thr ? HIT_HORIZON : HIT_NONE;
  int nc = 0;
  int last = -1, steps = 0;
  int rn = mp.renormalize_every;
  for (int b = 0; b < n_blocks && hit == HIT_NONE; ++b) {
    float* slot = scratch + (size_t)b * WORDS * N + j;  // [b][WORDS][N]
#pragma unroll
    for (int k = 0; k < 6; ++k) slot[k * N] = s[k];
    slot[6 * N] = __int_as_float(nc);
    last = b;
    const int i1 = min((b + 1) * CKPT, mp.max_steps);
    for (int i = b * CKPT; i < i1 && hit == HIT_NONE; ++i) {
      bool crossed, advance;
      float r_c, phi_c, t_c;
      march_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, hit,
                         nc, crossed, advance, r_c, phi_c, t_c);
      nc += crossed ? 1 : 0;
      steps += advance ? 1 : 0;
    }
  }
  if (replay != nullptr) {
    // the replay's outcome, with the forward's end-of-march rule
    replay[j] = hit == HIT_NONE ? HIT_HORIZON : hit;
    replay[N + j] = steps;
    replay[2 * N + j] = nc;
  }

  // ---- phase 2: reverse sweep over the live blocks ----
  float c6[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) c6[k] = ctf[k * N + j];
  float c_pph = ctf[6 * N + j];
  float c_m = 0.0f, c_a = 0.0f, c_rh = 0.0f, c_rph = 0.0f;
  const float ct_rmin = ctr[j];
  float cj[3] = {0.0f, 0.0f, 0.0f};
  if (JETS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) cj[c] = ctj[c * N + j];
  }
  bool injected = false;
  // The steps after the ray stopped (the identity) clip the carry once.
  if (clip > 0.0f) clip_carry(c6, clip);

  for (int b = last; b >= 0; --b) {
    const float* slot = scratch + (size_t)b * WORDS * N + j;
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = slot[k * N];
    nc = __float_as_int(slot[6 * N]);
    hit = HIT_NONE;
    // re-forward the block's live steps into the stack
    const int i0 = b * CKPT;
    const int i1 = min(i0 + CKPT, mp.max_steps);
    int n_live = 0;
    rn = renorm_start(i0, mp.renormalize_every);
    for (int i = i0; i < i1 && hit == HIT_NONE; ++i, ++n_live) {
      float* e = stack + n_live * WORDS * THREADS + tid;
#pragma unroll
      for (int k = 0; k < 6; ++k) e[k * THREADS] = s[k];
      e[6 * THREADS] = __int_as_float(nc);
      bool crossed, advance;
      float r_c, phi_c, t_c;
      march_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, hit,
                         nc, crossed, advance, r_c, phi_c, t_c);
      nc += crossed ? 1 : 0;
    }
    // backward through the stack
    for (int q = n_live - 1; q >= 0; --q) {
      const float* e = stack + q * WORDS * THREADS + tid;
      float x[NIN];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = e[k * THREADS];
      const int nc_q = __float_as_int(e[6 * THREADS]);
      x[6] = pph;
      x[7] = m;
      x[8] = a;
      x[9] = r_h;
      x[10] = r_ph;
      if (clip > 0.0f) clip_carry(c6, clip);
      auto inject = [&](bool crossed, bool advance, float dmin, float* cto) {
#pragma unroll
        for (int k = 0; k < 6; ++k) cto[k] = c6[k];
        cto[6] = cto[7] = cto[8] = 0.0f;
        if (crossed && nc_q < K) {
          cto[6] = ctc[nc_q * N + j];
          cto[7] = ctc[(K + nc_q) * N + j];
          cto[8] = ctc[(2 * K + nc_q) * N + j];
        }
        const bool hitmin = advance && dmin == rmin_fin && !injected;
        cto[9] = hitmin ? ct_rmin : 0.0f;
        if (hitmin) injected = true;
      };
      float cin[NIN];
      if constexpr (JETS)
        march_step_vjp<APPROX, true>(mp, x, thr, i0 + q, nc_q, inject, cin,
                                     &jp, cj);
      else
        march_step_vjp<APPROX>(mp, x, thr, i0 + q, nc_q, inject, cin);
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
    const float sg = sgn(d0);
    c6[1] = c6[1] + ct_rmin * sg;
    c_rph = c_rph + (-ct_rmin * sg);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) cty0[k * N + j] = c6[k];
  cty0[6 * N + j] = c_pph;
  ctp[j] = c_m;
  ctp[N + j] = c_a;
  ctp[2 * N + j] = c_rh;
  ctp[3 * N + j] = c_rph;
}

typedef void (*GradKernel)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, float*, float*, float*, int*, int,
                           int, const MarchParams, float, const float*,
                           const JetParams);

static GradKernel grad_kernel_for(bool approx, bool jets) {
  if (jets)
    return approx ? march_grad_kernel<true, true>
                  : march_grad_kernel<false, true>;
  return approx ? march_grad_kernel<true, false>
                : march_grad_kernel<false, false>;
}

extern "C" {

// Launches the gradient kernel on ``stream``; returns cudaGetLastError()
// (a refused launch, such as too much shared memory, is an error here).
// P: (4,) [m, a, r_h, r_ph]; y: (7, n) initial rows (t, r, u, ph, pr, pu,
// pph) with p_t = -1; thr: (n,); ctf: (7, n); ctc: (3K, n); ctr, rminf:
// (n,); cty0: (7, n) out; ctp: (4, n) out; scratch: bh_march_grad_scratch
// words per ray; replay: null, or (3, n) int32 out, the replay's hit, live
// steps and crossing count (the forward march's own, when the two agree);
// jp: the jets' configuration, or null for no jets, with ctj (3, n), the
// cotangent of the jets' radiance (unused without jets).
int bh_march_grad_launch(const float* P, const float* y, const float* thr,
                         const float* ctf, const float* ctc, const float* ctr,
                         const float* rminf, float* cty0, float* ctp,
                         float* scratch, int* replay, int n,
                         const MarchParams* mp, float clip, const float* ctj,
                         const JetParams* jp, void* stream) {
  const int n_blocks = (mp->max_steps + CKPT - 1) / CKPT;
  const GradKernel kernel =
      grad_kernel_for(mp->approx_recip != 0, jp != nullptr);
  const JetParams none = {};
  const JetParams jets = jp != nullptr ? *jp : none;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    kernel<<<(n + THREADS - 1) / THREADS, THREADS, SMEM_BYTES,
             (cudaStream_t)stream>>>(P, y, thr, ctf, ctc, ctr, rminf, cty0,
                                     ctp, scratch, replay, n, n_blocks, *mp,
                                     clip, ctj, jets);
  }
  return (int)cudaGetLastError();
}

// Scratch words per ray: the block checkpoints.
int bh_march_grad_scratch(int max_steps) {
  return (max_steps + CKPT - 1) / CKPT * WORDS;
}

// The launch's shape: {threads per block, dynamic shared memory bytes per
// block, steps per checkpoint block, resident blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (-1 if it fails)} of the
// instantiation that ``approx`` (MarchConfig.approx_recip) and ``jets``
// select.
void bh_march_grad_shape(int approx, int jets, int out[4]) {
  const GradKernel kernel = grad_kernel_for(approx != 0, jets != 0);
  out[0] = THREADS;
  out[1] = SMEM_BYTES;
  out[2] = CKPT;
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, THREADS, SMEM_BYTES) != cudaSuccess)
    blocks = -1;
  out[3] = blocks;
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

int bh_jet_params_size() { return (int)sizeof(JetParams); }

}  // extern "C"
