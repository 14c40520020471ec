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
//
// Float64 (march_grad_kernel_f64, bh_march_grad_launch64): the same body on
// double rows, cotangents, checkpoints and stack, exact route only (the
// JAX package differentiates its float64 jnp march, which divides
// exactly). Its stack is twice the bytes (57,344 per 128-thread block, past
// the 48 KB that needs no opt-in) and a double step holds about twice the
// registers, so it asks for MIN_BLOCKS_F64 resident blocks (at most 255
// registers per thread).

#include "march_adjoint.cuh"

#define THREADS 128
#define MIN_BLOCKS 4
#define MIN_BLOCKS_F64 2
#define CKPT 8
#define WORDS 7  // per checkpoint and stacked step: 6 state words, nc
#define SMEM_BYTES (CKPT * WORDS * THREADS * 4)
#define SMEM_BYTES_F64 (CKPT * WORDS * THREADS * 8)

// The crossing count stored in a word of the scratch and the stack, by its
// bits.
__device__ __forceinline__ void put_count(float& w, int nc) {
  w = __int_as_float(nc);
}
__device__ __forceinline__ void put_count(double& w, int nc) {
  w = __longlong_as_double((long long)nc);
}
__device__ __forceinline__ int get_count(float w) { return __float_as_int(w); }
__device__ __forceinline__ int get_count(double w) {
  return (int)__double_as_longlong(w);
}

// The kernel's body. APPROX: MarchConfig.approx_recip, chosen at launch
// (the step's reciprocals and its contracted multiply-adds,
// march_step.cuh); JETS: the jets' march (ctj: the (3, n) cotangent of its
// radiance, jp: the jets' configuration); R: float, or double on the exact
// route.
template <bool APPROX, bool JETS, class R>
__device__ __forceinline__ void grad_body(
    const R* __restrict__ P, const R* __restrict__ y,
    const R* __restrict__ thr_in, const R* __restrict__ ctf,
    const R* __restrict__ ctc, const R* __restrict__ ctr,
    const R* __restrict__ rminf, R* __restrict__ cty0, R* __restrict__ ctp,
    R* __restrict__ scratch, int* __restrict__ replay, int n, int n_blocks,
    const MarchParamsT<R>& mp, R clip, const R* __restrict__ ctj,
    const JetParamsT<R>& jp) {
  static_assert(sizeof(R) == 4 || !APPROX,
                "the float64 gradient has the exact route only");
  extern __shared__ float smem[];
  R* stack = reinterpret_cast<R*>(smem);  // [CKPT][WORDS][THREADS]
  const int tid = threadIdx.x;
  const int j = blockIdx.x * THREADS + tid;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const int K = mp.max_crossings;
  const R m = __ldg(P + 0);
  const R a = __ldg(P + 1);
  const R r_h = __ldg(P + 2);
  const R r_ph = __ldg(P + 3);
  const R inv_rph = inv_rph_of(r_ph);
  const R thr = thr_in[j];
  const R rmin_fin = rminf[j];
  R y0[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) y0[k] = y[k * N + j];
  const R pph = y0[6];

  // ---- phase 1: replay, checkpoint at the start of every live block ----
  R s[6] = {y0[0], y0[1], y0[2], y0[3], y0[4], y0[5]};
  int hit = y0[1] < thr ? HIT_HORIZON : HIT_NONE;
  int nc = 0;
  int last = -1, steps = 0;
  int rn = mp.renormalize_every;
  for (int b = 0; b < n_blocks && hit == HIT_NONE; ++b) {
    R* slot = scratch + (size_t)b * WORDS * N + j;  // [b][WORDS][N]
#pragma unroll
    for (int k = 0; k < 6; ++k) slot[k * N] = s[k];
    put_count(slot[6 * N], nc);
    last = b;
    const int i1 = min((b + 1) * CKPT, mp.max_steps);
    for (int i = b * CKPT; i < i1 && hit == HIT_NONE; ++i) {
      bool crossed, advance;
      R r_c, phi_c, t_c;
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
  R c6[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) c6[k] = ctf[k * N + j];
  R c_pph = ctf[6 * N + j];
  R c_m = 0.0f, c_a = 0.0f, c_rh = 0.0f, c_rph = 0.0f;
  const R ct_rmin = ctr[j];
  R cj[3] = {0.0f, 0.0f, 0.0f};
  if (JETS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) cj[c] = ctj[c * N + j];
  }
  bool injected = false;
  // The steps after the ray stopped (the identity) clip the carry once.
  if (clip > 0.0f) clip_carry(c6, clip);

  for (int b = last; b >= 0; --b) {
    const R* slot = scratch + (size_t)b * WORDS * N + j;
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = slot[k * N];
    nc = get_count(slot[6 * N]);
    hit = HIT_NONE;
    // re-forward the block's live steps into the stack
    const int i0 = b * CKPT;
    const int i1 = min(i0 + CKPT, mp.max_steps);
    int n_live = 0;
    rn = renorm_start(i0, mp.renormalize_every);
    for (int i = i0; i < i1 && hit == HIT_NONE; ++i, ++n_live) {
      R* e = stack + n_live * WORDS * THREADS + tid;
#pragma unroll
      for (int k = 0; k < 6; ++k) e[k * THREADS] = s[k];
      put_count(e[6 * THREADS], nc);
      bool crossed, advance;
      R r_c, phi_c, t_c;
      march_step<APPROX>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, hit,
                         nc, crossed, advance, r_c, phi_c, t_c);
      nc += crossed ? 1 : 0;
    }
    // backward through the stack
    for (int q = n_live - 1; q >= 0; --q) {
      const R* e = stack + q * WORDS * THREADS + tid;
      R x[NIN];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = e[k * THREADS];
      const int nc_q = get_count(e[6 * THREADS]);
      x[6] = pph;
      x[7] = m;
      x[8] = a;
      x[9] = r_h;
      x[10] = r_ph;
      if (clip > 0.0f) clip_carry(c6, clip);
      auto inject = [&](bool crossed, bool advance, R dmin, R* cto) {
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
      R cin[NIN];
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
  const R d0 = y0[1] - r_ph;
  if (!injected && dabs(d0) == rmin_fin) {
    const R sg = sgn(d0);
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

// The float gradient (grad_body on float).
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
  grad_body<APPROX, JETS>(P, y, thr_in, ctf, ctc, ctr, rminf, cty0, ctp,
                          scratch, replay, n, n_blocks, mp, clip, ctj, jp);
}

// The float64 gradient (grad_body on double, exact route).
template <bool JETS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_F64)
march_grad_kernel_f64(const double* __restrict__ P,
                      const double* __restrict__ y,
                      const double* __restrict__ thr_in,
                      const double* __restrict__ ctf,
                      const double* __restrict__ ctc,
                      const double* __restrict__ ctr,
                      const double* __restrict__ rminf,
                      double* __restrict__ cty0, double* __restrict__ ctp,
                      double* __restrict__ scratch,
                      int* __restrict__ replay, int n, int n_blocks,
                      const MarchParamsT<double> mp, double clip,
                      const double* __restrict__ ctj,
                      const JetParamsT<double> jp) {
  grad_body<false, JETS>(P, y, thr_in, ctf, ctc, ctr, rminf, cty0, ctp,
                         scratch, replay, n, n_blocks, mp, clip, ctj, jp);
}

template <class R>
using GradKernelT = void (*)(const R*, const R*, const R*, const R*,
                             const R*, const R*, const R*, R*, R*, R*, int*,
                             int, int, const MarchParamsT<R>, R, const R*,
                             const JetParamsT<R>);
typedef GradKernelT<float> GradKernel;

static GradKernel grad_kernel_for(bool approx, bool jets) {
  if (jets)
    return approx ? march_grad_kernel<true, true>
                  : march_grad_kernel<false, true>;
  return approx ? march_grad_kernel<true, false>
                : march_grad_kernel<false, false>;
}

static GradKernelT<double> grad_kernel_f64_for(bool jets) {
  return jets ? march_grad_kernel_f64<true> : march_grad_kernel_f64<false>;
}

// The launch of either scalar type.
template <class R>
static int grad_launch(const R* P, const R* y, const R* thr, const R* ctf,
                       const R* ctc, const R* ctr, const R* rminf, R* cty0,
                       R* ctp, R* scratch, int* replay, int n,
                       const MarchParamsT<R>* mp, R clip, const R* ctj,
                       const JetParamsT<R>* jp, void* stream) {
  const int n_blocks = (mp->max_steps + CKPT - 1) / CKPT;
  GradKernelT<R> kernel;
  int smem;
  if constexpr (sizeof(R) == 8) {
    if (mp->approx_recip != 0) return (int)cudaErrorInvalidValue;
    kernel = grad_kernel_f64_for(jp != nullptr);
    smem = SMEM_BYTES_F64;
  } else {
    kernel = grad_kernel_for(mp->approx_recip != 0, jp != nullptr);
    smem = SMEM_BYTES;
  }
  const JetParamsT<R> none = {};
  const JetParamsT<R> jets = jp != nullptr ? *jp : none;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    kernel<<<(n + THREADS - 1) / THREADS, THREADS, smem,
             (cudaStream_t)stream>>>(P, y, thr, ctf, ctc, ctr, rminf, cty0,
                                     ctp, scratch, replay, n, n_blocks, *mp,
                                     clip, ctj, jets);
  }
  return (int)cudaGetLastError();
}

// The launch's shape of a kernel (see bh_march_grad_shape).
static void grad_shape(const void* kernel, int smem, int out[4]) {
  out[0] = THREADS;
  out[1] = smem;
  out[2] = CKPT;
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    smem) != cudaSuccess)
    blocks = -1;
  out[3] = blocks;
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
  return grad_launch(P, y, thr, ctf, ctc, ctr, rminf, cty0, ctp, scratch,
                     replay, n, mp, clip, ctj, jp, stream);
}

// The float64 gradient: bh_march_grad_launch's arguments in double (replay
// int32), with bh_march_grad_scratch double words per ray; exact route only
// (approx_recip set returns cudaErrorInvalidValue).
int bh_march_grad_launch64(const double* P, const double* y,
                           const double* thr, const double* ctf,
                           const double* ctc, const double* ctr,
                           const double* rminf, double* cty0, double* ctp,
                           double* scratch, int* replay, int n,
                           const MarchParamsT<double>* mp, double clip,
                           const double* ctj, const JetParamsT<double>* jp,
                           void* stream) {
  return grad_launch(P, y, thr, ctf, ctc, ctr, rminf, cty0, ctp, scratch,
                     replay, n, mp, clip, ctj, jp, stream);
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
  grad_shape((const void*)grad_kernel_for(approx != 0, jets != 0),
             SMEM_BYTES, out);
}

// bh_march_grad_shape of the float64 instantiation (exact route).
void bh_march_grad_shape64(int jets, int out[4]) {
  grad_shape((const void*)grad_kernel_f64_for(jets != 0), SMEM_BYTES_F64, out);
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

int bh_jet_params_size() { return (int)sizeof(JetParams); }

int bh_march_params64_size() { return (int)sizeof(MarchParamsT<double>); }

int bh_jet_params64_size() { return (int)sizeof(JetParamsT<double>); }

}  // extern "C"
