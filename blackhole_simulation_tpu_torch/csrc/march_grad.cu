// Gradient kernel for Hopper (sm_90a): the reverse-mode derivative (VJP) of
// the march kernel; in float one thread per ray, in double a replay kernel
// and a reverse kernel on persistent warps (below).
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
// the step: in float march_step_vjp (the step's forward recomputed into a
// tape in registers, step_tape, which also gives the step's crossed,
// advance and dmin for the injection, then the reverse from it,
// march_step_vjp_tape); in double the reverse alone, from the tape that
// the block's re-forward wrote.
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
// Float64 (bh_march_grad_launch64), exact route only (the JAX package
// differentiates its float64 jnp march, which divides exactly). The H100
// runs FP64 at half the FP32 rate, a double step holds twice the registers
// and its IEEE divides and square roots are long dependent DFMA chains:
// the float body on double takes about 250 registers (8 warps per SM),
// waits on latency and runs each live step about four times forward
// (PERF.md, the float64 gradient's census). The double design:
// * the replay (phase 1) is a kernel of its own, march_replay_kernel_f64,
//   at the registers of a march (64, 32 warps per SM) on persistent warps
//   that refill their lanes from the ray pool as the march kernel's do; it
//   writes the CKPT_F64-step checkpoints and each ray's count of live
//   blocks;
// * the reverse (phase 2), march_grad_kernel_f64, runs one forward per
//   reversed step: the block's re-forward (step_tape) writes a tape to
//   shared memory of what the reverse reads (the state, the stepped rows
//   with the unclipped u, dlam, the last midpoint input, the crossing count
//   and the step's decisions), and each step's reverse
//   (march_step_vjp_tape) reads it, without the forward that the float
//   body's per-step VJP recomputes. A step's input is the previous step's
//   stored rows with u clipped (and p_r renormalized where that was due),
//   the checkpoint for the block's first step, so a 4-step tape is 50
//   doubles and 4 ints a thread (26,624 bytes per 64-thread block);
// * the reverse kernel's registers are capped by MIN_BLOCKS_F64 blocks of
//   THREADS_F64 a SM: at 128, 16 warps fit the register file and the tape
//   the shared memory, and it spills; the jets instantiation, whose step
//   holds the emission's VJP too, ran faster at 12 warps and 168 registers
//   (MIN_BLOCKS_F64_JETS), the other one at 16 (PERF.md, the census's sweep);
// * its warps are persistent and refill their lanes from the ray pool: a
//   lane reverses its ray block by block, writes the ray's cty0 and ctp,
//   and takes the next ray once fewer than REFILL_F64 of the warp's lanes
//   hold one. A refill pass stalls the warp on the pool's atomic and the
//   new rays' loads, so refilling seldom (8 of 32 live) beat refilling
//   every free lane (32), although fewer lanes then work;
// * each ray's arithmetic, and the order of its sums, is the float body's:
//   the per-ray outputs are those of the one-thread-per-ray double kernel
//   bit for bit, whichever lane ran the ray (tools/grad_census.py --parent
//   checks it on the card).

#include "march_adjoint.cuh"

#define THREADS 128
#define MIN_BLOCKS 4
#define CKPT 8
#define WORDS 7  // per checkpoint and stacked step: 6 state words, nc
#define SMEM_BYTES (CKPT * WORDS * THREADS * 4)

// The float64 gradient's shape (see the header comment): the replay
// kernel's threads per block and the live lanes under which its warps
// refill; the reverse kernel's threads per block, the resident blocks per
// SM its register cap allows (65,536 / (THREADS_F64 x MIN_BLOCKS_F64)
// registers a thread; _JETS: of the jets instantiation), its steps per
// checkpoint block, and the live lanes under which a warp refills. The tape of one thread: the
// block's CKPT_F64 + 1 states (6 words each: the checkpoint, then each
// step's stepped rows with its unclipped u), each step's dlam and last
// midpoint input (5 words), and each step's crossing count and decisions
// (one int).
#define REPLAY_THREADS 128
#define REPLAY_REFILL 16
#define THREADS_F64 64
#define MIN_BLOCKS_F64 8
#define MIN_BLOCKS_F64_JETS 6
#define CKPT_F64 4
#define REFILL_F64 8
#define REFILL_F64_JETS 8
#define TAPE_STATES (CKPT_F64 + 1)
#define TAPE_STEP_WORDS 5
#define TAPE_WORDS (6 * TAPE_STATES + TAPE_STEP_WORDS * CKPT_F64)
#define SMEM_BYTES_F64 \
  (TAPE_WORDS * THREADS_F64 * 8 + CKPT_F64 * THREADS_F64 * 4)

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

// The float kernel's body. APPROX: MarchConfig.approx_recip, chosen at
// launch (the step's reciprocals and its contracted multiply-adds,
// march_step.cuh); JETS: the jets' march (ctj: the (3, n) cotangent of its
// radiance, jp: the jets' configuration); R: float (the float64 gradient
// is the replay and reverse kernels below).
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

// ---- The float64 gradient: the replay kernel, then the reverse kernel ----

// The replay (phase 1) of the float64 gradient at the float64 march's
// registers, on persistent warps whose lanes take their rays from the pool
// as the march kernel's do: march_step.cuh's step from the initial rows,
// a block of CKPT_F64 steps at a time, the state and crossing count stored
// at the start of every block the ray enters live ([b][WORDS][N] of the
// scratch); where its ray has ended a lane writes the number of those
// blocks (scratch[n_blocks * WORDS * N + j], by its bits) and, where
// replay is not null, the replay's outcome. A warp refills once fewer than
// REPLAY_REFILL of its lanes are live.
__global__ void __launch_bounds__(REPLAY_THREADS)
march_replay_kernel_f64(const double* __restrict__ P,
                        const double* __restrict__ y,
                        const double* __restrict__ thr_in,
                        double* __restrict__ scratch,
                        int* __restrict__ replay, int* __restrict__ pool,
                        int n, int n_blocks, const MarchParamsT<double> mp) {
  const size_t N = (size_t)n;
  const int lane = threadIdx.x & 31;
  const double m = __ldg(P + 0);
  const double a = __ldg(P + 1);
  const double r_h = __ldg(P + 2);
  const double r_ph = __ldg(P + 3);
  const double inv_rph = inv_rph_of(r_ph);
  int j = -1;          // the lane's ray, -1 for none
  bool live = false;   // the lane's ray is still marching
  bool empty = false;  // the pool has no ray left (the same in every lane)
  double s[6], pph, thr;
  int hit, nc, steps, i, rn;
  while (true) {
    const unsigned lm = __ballot_sync(FULL_MASK, live);
    const bool done = empty && lm == 0u;
    if (done || (!empty && __popc(lm) < REPLAY_REFILL)) {
      if (j >= 0 && !live) {
        // blocks entered live: every block that began at a step < i
        put_count(scratch[(size_t)n_blocks * WORDS * N + j],
                  (i + CKPT_F64 - 1) / CKPT_F64);
        if (replay != nullptr) {
          // the replay's outcome, with the forward's end-of-march rule
          replay[j] = hit == HIT_NONE ? HIT_HORIZON : hit;
          replay[N + j] = steps;
          replay[2 * N + j] = nc;
        }
        j = -1;
      }
      if (done) break;
      int end;
      const int k = pool_take(pool, ~lm, lane, end);
      if (!live && k < n) {
        j = k;
#pragma unroll
        for (int q = 0; q < 6; ++q) s[q] = y[q * N + j];
        pph = y[6 * N + j];
        thr = thr_in[j];
        hit = s[1] < thr ? HIT_HORIZON : HIT_NONE;
        nc = steps = i = 0;
        rn = mp.renormalize_every;
        live = hit == HIT_NONE && mp.max_steps > 0;
      }
      empty = end >= n;
      continue;
    }
    if (!live) continue;
    // one block: its checkpoint, then its steps
    double* slot = scratch + (size_t)(i / CKPT_F64) * WORDS * N + j;
#pragma unroll
    for (int q = 0; q < 6; ++q) slot[q * N] = s[q];
    put_count(slot[6 * N], nc);
    const int i1 = min(i + CKPT_F64, mp.max_steps);
    for (; i < i1 && hit == HIT_NONE; ++i) {
      bool crossed, advance;
      double r_c, phi_c, t_c;
      march_step<false>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, rn, s, hit,
                        nc, crossed, advance, r_c, phi_c, t_c);
      nc += crossed ? 1 : 0;
      steps += advance ? 1 : 0;
    }
    live = hit == HIT_NONE && i < mp.max_steps;
  }
  pool_retire(pool);
}

// A step's crossing count and decisions in one tape word.
#define TAPE_CROSSED (1 << 16)
#define TAPE_ADVANCE (1 << 17)
#define TAPE_RENORM (1 << 18)

// The reverse (phase 2) of the float64 gradient, on persistent warps whose
// lanes take their rays from the pool (pool_take; pool_retire sets it back
// to zero): a lane walks its ray's live blocks from the last, each block
// re-forwarded from its checkpoint into the lane's tape in shared memory
// (step_tape: one forward per step) and reversed from it
// (march_step_vjp_tape), then writes the ray's cty0 and ctp and takes the
// next ray. A warp refills once fewer than REFILL_F64 of its lanes hold a
// live ray. Each ray's arithmetic is the one-thread-per-ray kernel's, in
// its order, so outputs do not depend on the lane.
template <bool JETS>
__global__ void __launch_bounds__(THREADS_F64,
                                  JETS ? MIN_BLOCKS_F64_JETS : MIN_BLOCKS_F64)
march_grad_kernel_f64(const double* __restrict__ P,
                      const double* __restrict__ y,
                      const double* __restrict__ thr_in,
                      const double* __restrict__ ctf,
                      const double* __restrict__ ctc,
                      const double* __restrict__ ctr,
                      const double* __restrict__ rminf,
                      double* __restrict__ cty0, double* __restrict__ ctp,
                      const double* __restrict__ scratch,
                      int* __restrict__ pool, int n, int n_blocks,
                      const MarchParamsT<double> mp, double clip,
                      const double* __restrict__ ctj,
                      const JetParamsT<double> jp) {
  extern __shared__ double tape_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // this thread's tape: word w at T[w * THREADS_F64] ([word][thread], a
  // warp's accesses in consecutive banks)
  double* T = tape_smem + tid;
  int* meta = reinterpret_cast<int*>(tape_smem + TAPE_WORDS * THREADS_F64)
              + tid;
  const size_t N = (size_t)n;
  const int k_slots = mp.max_crossings;
  const double m = __ldg(P + 0);
  const double a = __ldg(P + 1);
  const double r_h = __ldg(P + 2);
  const double r_ph = __ldg(P + 3);
  const double inv_rph = inv_rph_of(r_ph);
  const double* blocks_of = scratch + (size_t)n_blocks * WORDS * N;
  const double lo = K<double>(-1.0 + 1e-7), hi = K<double>(1.0 - 1e-7);

  int j = -1;          // the lane's ray, -1 for none
  int b = -1;          // its next block to reverse, -1 when none is left
  bool empty = false;  // the pool has no ray left (the same in every lane)
  double c6[6], c_pph, c_m, c_a, c_rh, c_rph, cj[3];
  double thr, rmin_fin, ct_rmin, pph;
  bool injected;
  while (true) {
    const bool live = b >= 0;
    const unsigned lm = __ballot_sync(FULL_MASK, live);
    const bool done = empty && lm == 0u;
    if (done || (!empty &&
                 __popc(lm) < (JETS ? REFILL_F64_JETS : REFILL_F64))) {
      // The refill pass: the lanes whose rays are done write them out,
      // then take the next rays together.
      if (j >= 0 && !live) {
        // r_min's initial-value case: no step came closer than |r0 - r_ph|.
        const double d0 = y[N + j] - r_ph;
        if (!injected && dabs(d0) == rmin_fin) {
          const double sg = sgn(d0);
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
        j = -1;
      }
      if (done) break;
      int end;
      const int k = pool_take(pool, ~lm, lane, end);
      if (!live && k < n) {
        j = k;
        thr = thr_in[j];
        rmin_fin = rminf[j];
        ct_rmin = ctr[j];
        pph = y[6 * N + j];
#pragma unroll
        for (int q = 0; q < 6; ++q) c6[q] = ctf[q * N + j];
        c_pph = ctf[6 * N + j];
        c_m = c_a = c_rh = c_rph = 0.0;
        if (JETS) {
#pragma unroll
          for (int c = 0; c < 3; ++c) cj[c] = ctj[c * N + j];
        }
        injected = false;
        // The steps after the ray stopped (the identity) clip the carry
        // once.
        if (clip > 0.0) clip_carry(c6, clip);
        b = get_count(blocks_of[j]) - 1;
      }
      empty = end >= n;
      continue;
    }
    if (!live) continue;

    // ---- re-forward block b from its checkpoint into the tape ----
    const double* slot = scratch + (size_t)b * WORDS * N + j;
    double s[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      s[k] = slot[k * N];
      T[k * THREADS_F64] = s[k];
    }
    int nc = get_count(slot[6 * N]);
    int hit = HIT_NONE;
    const int i0 = b * CKPT_F64;
    const int i1 = min(i0 + CKPT_F64, mp.max_steps);
    int n_live = 0;
    for (int i = i0; i < i1 && hit == HIT_NONE; ++i, ++n_live) {
      StepTape<double> tp;
      double sn[6];
      step_tape<false>(mp, m, a, r_h, r_ph, inv_rph, pph, thr, i, s, nc, tp,
                       sn, hit);
      double* e = T + 6 * (n_live + 1) * THREADS_F64;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        e[k * THREADS_F64] = k == 2 ? tp.nu_raw : tp.y[k];
      double* w = T + (6 * TAPE_STATES + TAPE_STEP_WORDS * n_live)
                          * THREADS_F64;
      w[0] = tp.dlam;
#pragma unroll
      for (int k = 0; k < 4; ++k) w[(1 + k) * THREADS_F64] = tp.mid[k];
      meta[n_live * THREADS_F64] = nc | (tp.crossed ? TAPE_CROSSED : 0)
                                   | (tp.advance ? TAPE_ADVANCE : 0)
                                   | (tp.renorm ? TAPE_RENORM : 0);
      if (tp.renorm)
        sn[4] = ks_renormalize_pr(m, a, sn[1], sn[2], sn[4], sn[5], pph);
#pragma unroll
      for (int k = 0; k < 6; ++k) s[k] = sn[k];
      nc += tp.crossed ? 1 : 0;
    }

    // ---- backward through the tape ----
    for (int q = n_live - 1; q >= 0; --q) {
      // the step's input: the checkpoint, or the previous step's stepped
      // rows with u clipped and p_r renormalized where that was due
      double x[NIN];
      const double* xs = T + 6 * q * THREADS_F64;
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = xs[k * THREADS_F64];
      if (q > 0) {
        x[2] = jclip(x[2], lo, hi);
        if (meta[(q - 1) * THREADS_F64] & TAPE_RENORM)
          x[4] = ks_renormalize_pr(m, a, x[1], x[2], x[4], x[5], pph);
      }
      x[6] = pph;
      x[7] = m;
      x[8] = a;
      x[9] = r_h;
      x[10] = r_ph;
      StepTape<double> tp;
      const double* ys = xs + 6 * THREADS_F64;
#pragma unroll
      for (int k = 0; k < 6; ++k) tp.y[k] = ys[k * THREADS_F64];
      tp.nu_raw = tp.y[2];
      tp.y[2] = jclip(tp.nu_raw, lo, hi);
      const double* w = T + (6 * TAPE_STATES + TAPE_STEP_WORDS * q)
                                * THREADS_F64;
      tp.dlam = w[0];
#pragma unroll
      for (int k = 0; k < 4; ++k) tp.mid[k] = w[(1 + k) * THREADS_F64];
      const int mq = meta[q * THREADS_F64];
      const int nc_q = mq & 0xffff;
      tp.crossed = (mq & TAPE_CROSSED) != 0;
      tp.advance = (mq & TAPE_ADVANCE) != 0;
      tp.renorm = (mq & TAPE_RENORM) != 0;
      if (clip > 0.0) clip_carry(c6, clip);
      // the output cotangents: the carry, the crossing record's where the
      // step recorded slot nc_q, r_min's at the last step that reached it
      double cto[NOUT];
#pragma unroll
      for (int k = 0; k < 6; ++k) cto[k] = c6[k];
      cto[6] = cto[7] = cto[8] = 0.0;
      if (tp.crossed && nc_q < k_slots) {
        cto[6] = ctc[nc_q * N + j];
        cto[7] = ctc[(k_slots + nc_q) * N + j];
        cto[8] = ctc[(2 * k_slots + nc_q) * N + j];
      }
      const bool hitmin = tp.advance && step_dmin(tp, x[1], r_ph) == rmin_fin
                          && !injected;
      cto[9] = hitmin ? ct_rmin : 0.0;
      if (hitmin) injected = true;
      double cin[NIN];
      march_step_vjp_tape<false, JETS>(mp, x, tp, cto, cin, &jp, cj);
#pragma unroll
      for (int k = 0; k < 6; ++k) c6[k] = cin[k];
      c_pph = c_pph + cin[6];
      c_m = c_m + cin[7];
      c_a = c_a + cin[8];
      c_rh = c_rh + cin[9];
      c_rph = c_rph + cin[10];
    }
    --b;
  }
  pool_retire(pool);
}

typedef void (*GradKernel)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, float*, float*, float*, int*, int,
                           int, const MarchParams, float, const float*,
                           const JetParams);
typedef void (*GradKernel64)(const double*, const double*, const double*,
                             const double*, const double*, const double*,
                             const double*, double*, double*, const double*,
                             int*, int, int, const MarchParamsT<double>,
                             double, const double*,
                             const JetParamsT<double>);

static GradKernel grad_kernel_for(bool approx, bool jets) {
  if (jets)
    return approx ? march_grad_kernel<true, true>
                  : march_grad_kernel<false, true>;
  return approx ? march_grad_kernel<true, false>
                : march_grad_kernel<false, false>;
}

static GradKernel64 grad_kernel_f64_for(bool jets) {
  return jets ? march_grad_kernel_f64<true> : march_grad_kernel_f64<false>;
}

// The float gradient's launch.
static int grad_launch(const float* P, const float* y, const float* thr,
                       const float* ctf, const float* ctc, const float* ctr,
                       const float* rminf, float* cty0, float* ctp,
                       float* scratch, int* replay, int n,
                       const MarchParams* mp, float clip, const float* ctj,
                       const JetParams* jp, void* stream) {
  const int n_blocks = (mp->max_steps + CKPT - 1) / CKPT;
  GradKernel kernel = grad_kernel_for(mp->approx_recip != 0, jp != nullptr);
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

// Resident blocks per SM of the float64 reverse kernel (without, with the
// jets) and of the replay kernel, and the SM count, per device (queried
// once).
static int g_blocks64[16][3];
static int g_sms64[16];

// The resident grid of float64 kernel k (0, 1: the reverse kernel without,
// with the jets; 2: the replay kernel): blocks per SM x SMs, fewer where
// the n rays need fewer blocks.
static int resident_grid64(int k, int n, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  const int threads = k == 2 ? REPLAY_THREADS : THREADS_F64;
  if (g_blocks64[dev][k] == 0) {
    int b = 0, s = 0;
    err = k == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &b, march_replay_kernel_f64, REPLAY_THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &b, grad_kernel_f64_for(k == 1), THREADS_F64,
                       SMEM_BYTES_F64);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_blocks64[dev][k] = b;
    g_sms64[dev] = s;
  }
  *grid = g_blocks64[dev][k] * g_sms64[dev];
  const int need = (n + threads - 1) / threads;
  if (*grid > need) *grid = need;
  return *grid < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// The float64 gradient's launch: the replay kernel, then the reverse
// kernel, each on its resident grid, on one stream; both take their rays
// from the pool, which each leaves at zero.
static int grad_launch64(const double* P, const double* y, const double* thr,
                         const double* ctf, const double* ctc,
                         const double* ctr, const double* rminf, double* cty0,
                         double* ctp, double* scratch, int* replay, int* pool,
                         int n, const MarchParamsT<double>* mp, double clip,
                         const double* ctj, const JetParamsT<double>* jp,
                         void* stream) {
  if (mp->approx_recip != 0) return (int)cudaErrorInvalidValue;
  const int n_blocks = (mp->max_steps + CKPT_F64 - 1) / CKPT_F64;
  GradKernel64 kernel = grad_kernel_f64_for(jp != nullptr);
  const JetParamsT<double> none = {};
  const JetParamsT<double> jets = jp != nullptr ? *jp : none;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES_F64);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    int grid = 0;
    int e = resident_grid64(2, n, &grid);
    if (e != 0) return e;
    march_replay_kernel_f64<<<grid, REPLAY_THREADS, 0,
                              (cudaStream_t)stream>>>(
        P, y, thr, scratch, replay, pool, n, n_blocks, *mp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    e = resident_grid64(jp != nullptr ? 1 : 0, n, &grid);
    if (e != 0) return e;
    kernel<<<grid, THREADS_F64, SMEM_BYTES_F64, (cudaStream_t)stream>>>(
        P, y, thr, ctf, ctc, ctr, rminf, cty0, ctp, scratch, pool, n,
        n_blocks, *mp, clip, ctj, jets);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a kernel at ``threads`` threads and ``smem``
// bytes of dynamic shared memory per block (-1 if the query fails).
static int resident_blocks(const void* kernel, int threads, int smem) {
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    blocks = -1;
  return blocks;
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

// The float64 gradient (the replay kernel, then the reverse kernel):
// bh_march_grad_launch's arguments in double (replay int32), with
// bh_march_grad_scratch64 double words per ray of scratch and pool, the
// ray pool (two int32 words, zero, which the launch leaves zero); exact
// route only (approx_recip set returns cudaErrorInvalidValue).
int bh_march_grad_launch64(const double* P, const double* y,
                           const double* thr, const double* ctf,
                           const double* ctc, const double* ctr,
                           const double* rminf, double* cty0, double* ctp,
                           double* scratch, int* replay, int* pool, int n,
                           const MarchParamsT<double>* mp, double clip,
                           const double* ctj, const JetParamsT<double>* jp,
                           void* stream) {
  return grad_launch64(P, y, thr, ctf, ctc, ctr, rminf, cty0, ctp, scratch,
                       replay, pool, n, mp, clip, ctj, jp, stream);
}

// Scratch words per ray of the float gradient: the block checkpoints.
int bh_march_grad_scratch(int max_steps) {
  return (max_steps + CKPT - 1) / CKPT * WORDS;
}

// Scratch words per ray of the float64 gradient: its block checkpoints and
// the count of its live blocks.
int bh_march_grad_scratch64(int max_steps) {
  return (max_steps + CKPT_F64 - 1) / CKPT_F64 * WORDS + 1;
}

// The launch's shape: {threads per block, dynamic shared memory bytes per
// block, steps per checkpoint block, resident blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (-1 if it fails)} of the
// instantiation that ``approx`` (MarchConfig.approx_recip) and ``jets``
// select.
void bh_march_grad_shape(int approx, int jets, int out[4]) {
  const void* kernel = (const void*)grad_kernel_for(approx != 0, jets != 0);
  out[0] = THREADS;
  out[1] = SMEM_BYTES;
  out[2] = CKPT;
  out[3] = resident_blocks(kernel, THREADS, SMEM_BYTES);
}

// bh_march_grad_shape of the float64 reverse kernel (exact route), then
// {threads per block, resident blocks per SM} of its replay kernel.
void bh_march_grad_shape64(int jets, int out[6]) {
  out[0] = THREADS_F64;
  out[1] = SMEM_BYTES_F64;
  out[2] = CKPT_F64;
  out[3] = resident_blocks((const void*)grad_kernel_f64_for(jets != 0),
                           THREADS_F64, SMEM_BYTES_F64);
  out[4] = REPLAY_THREADS;
  out[5] = resident_blocks((const void*)march_replay_kernel_f64,
                           REPLAY_THREADS, 0);
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

int bh_jet_params_size() { return (int)sizeof(JetParams); }

int bh_march_params64_size() { return (int)sizeof(MarchParamsT<double>); }

int bh_jet_params64_size() { return (int)sizeof(JetParamsT<double>); }

}  // extern "C"
