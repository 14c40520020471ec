// March kernel for Hopper (sm_90a): march a batch of rays to horizon or
// escape on persistent warps that refill their finished lanes, recording
// the final state, the termination code, the step count, up to K equator
// crossings (r, phi, t), their count and the photon-ring proximity
// min |r - r_ph|.
//
// Replaces blackhole_simulation_tpu/ops/pallas_march.py::_march_kernel (the
// Pallas TPU march-only kernel launched by pallas_march_u) with both of its
// bodies, march_tile and, when MarchConfig.multistep is set, the AB3 march
// march_tile_ab3. The plain PyTorch versions of the same functions are
// ops/march.py::march_tile and march_tile_ab3; the wrapper is
// ops/pallas_march.py::march_u. Built by ops/build.py with nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (no
// --use_fast_math) and loaded through ctypes.
//
// What bounds it on the H100: FP32 arithmetic. It reads 9 words per ray (8
// state rows and the termination radius) and writes 8 + 3 + 3K + 1 words;
// each march step costs a few hundred FP32 operations (march_step.cuh), so
// the least time is (operations per step) x (sum of steps over all rays) /
// (the card's FP32 rate), far above the bytes' time. chip_smoke.py computes
// both from the run.
//
// What holds it back (chip_smoke.py phase 12 on the one-thread-per-ray
// kernel this design replaced, H100 80GB HBM3 at 700 W): divergence, less
// than hoped. A warp of 32 consecutive rays marched until its slowest ray
// ended, and lost 11-13% of its lanes that way on the 1080p training,
// staged AB3 and staged jets marches (lane efficiency 0.87-0.89). Most of
// the rest of the gap to the bound is instructions the hand count leaves
// out (copies of one ray on every lane run at 1.64x the counted operations
// per step; the jets' double-precision exp and pow make a jets step cost
// two midpoint steps). The certified render's refinement re-march (16,384
// rays, one wave) is the latency of its longest ray (3,428 steps) and
// nothing else.
//
// Design for the card:
// * A resident grid of persistent warps (resident blocks per SM x SMs,
//   from the occupancy API, once per instantiation; fewer blocks where the
//   rays are fewer). Each lane holds at most one ray, taken from a pool: an
//   int32 counter in device memory that the warp's lanes advance together
//   with one atomicAdd (pool_take), and that the launch's last block to
//   retire sets back to zero (pool_retire), so a launch is one launch.
// * The loop (the "while-while" traversal of Aila & Laine, Understanding
//   the Efficiency of Ray Traversal on GPUs, HPG 2009, for a march): each
//   lane marches its ray up to CHECK_STEPS steps (march_step.cuh's
//   ray_step: the body of march_ray's or march_ray_ab3's loop, so every
//   ray's arithmetic is unchanged), then the warp counts its live lanes
//   with __ballot_sync; when fewer than REFILL are live, the lanes whose
//   rays ended write them out and take the next rays together. A ray's
//   outputs are written once, by the lane that finished it, so results do
//   not depend on which lane ran which ray.
// * REFILL and CHECK_STEPS, from builds with other values on the 1080p
//   marches: refilling a few lanes at a time costs more than it saves (a
//   pass stalls the warp's live lanes on the atomic and the loads), and a
//   count after every step adds its ballot and a copy of the lane state to
//   every step; 16 of 32 and every 16 steps did best on the training,
//   AB3 and jets marches together.
// * Per-ray state lives in registers (march_step.cuh's MarchRay; in
//   double, a stack frame but for AB3's, below); for AB3 it carries the
//   two right-hand-side histories and step sizes, which a birth resets.
//   The midpoint instantiation carries none of AB3's or the jets'
//   registers.
// * Layout: every input and output is row-major [row][ray]; a refill's rays
//   are consecutive, so its loads and stores stay in few lines. The
//   caller orders rays in 64 x 64 pixel blocks (ops/pallas_march.py::
//   to_block_order) when MarchConfig.use_pallas is set.
// * The step is march_step.cuh's, inherited as the render kernel has it:
//   one FMNMX per min/max, the renormalization counted down per ray (a
//   MarchRay field), the per-ray invariants computed once per launch, and
//   AB3's two bootstrap steps run in the refill pass, where a lane births
//   its ray (ray_boot), so that the step loop holds only the AB3 step.
// * approx_recip (the APPROX instantiations, chosen at launch):
//   rcp.approx.ftz.f32 for 1/S, 1/w and the step's divides and the step's
//   multiply-adds contracted (march_step.cuh::madd); IEEE divides and no
//   contraction otherwise, bit-equal to the plain version.
// * Float64 (march_kernel_f64, bh_march_launch64): the same
//   three variants on double rays, rows, records and lengths, on the exact
//   route only, as the JAX package marches float64 in jnp (exact divides);
//   the hit, steps and crossing counts stay int32. The wrapper picks them
//   by the rays' dtype. The H100 runs FP64 at half its FP32 rate, and a
//   double ray holds twice the registers.
// * The float64 AB3 march (march_kernel_f64<MARCH_AB3>) keeps its history
//   of right-hand sides in a ring in shared memory (march_step.cuh's
//   Ab3Ring, 18,432 bytes per block: a step reads two slots and writes the
//   third, so nothing shifts) and its crossing slots in an indexed array of
//   their own, so that its lane state (MarchRay<MARCH_AB3, double>) holds
//   no array and stays in registers. The whole double MarchRay (328
//   bytes), as the midpoint and jets variants still have it, sits in a
//   stack frame whose fields the step loop stores every step: on the AB3
//   march at 168 registers and 12 warps per SM, 11 LDL and 35 STL a step;
//   the redesign runs at ptxas's own 80 registers, 24 warps per SM, and no
//   local memory in its loop outside a crossing (PERF.md: 1.72 against
//   2.17 ms on the 1080p flagship rays, bit-identical).
// * Jets (a third instantiation, chosen when the caller passes JetParams):
//   the midpoint march with the jets' emission summed per live step into
//   three more registers and written as three more rows. The JAX package
//   runs this march in jnp (render/march.py:555-569, the same term as
//   pallas_march.py::march_tile's jets); the port runs it here. With jets
//   the wrapper's caller asks for exact divides and the midpoint march, as
//   the jnp march has them.

#include "march_step.cuh"

#define THREADS 128
// A warp refills its lanes once fewer than REFILL of its 32 rays are live;
// it counts them every CHECK_STEPS steps (see the header comment).
#define REFILL 16
#define CHECK_STEPS 16

template <int MARCH, class R>
__device__ __forceinline__ void march_birth(const R* __restrict__ y,
                                            const R* __restrict__ thr,
                                            size_t N, int j,
                                            const MarchParamsT<R>& mp, R m,
                                            R a, R r_ph,
                                            MarchRay<MARCH, R>& q) {
  q.s[0] = y[j];
  q.s[1] = y[N + j];
  q.s[2] = y[2 * N + j];
  q.s[3] = y[3 * N + j];
  q.s[4] = y[5 * N + j];
  q.s[5] = y[6 * N + j];
  q.pph = y[7 * N + j];
  q.thr = thr[j];
  ray_begin(mp, m, a, r_ph, q);
}

template <int MARCH, class R>
__device__ __forceinline__ void march_finish(
    const MarchRay<MARCH, R>& q, size_t N, int j, int max_crossings,
    R* __restrict__ yo, int* __restrict__ hit_o, int* __restrict__ steps_o,
    R* __restrict__ cr_o, R* __restrict__ cp_o, R* __restrict__ ct_o,
    int* __restrict__ nc_o, R* __restrict__ rmin_o, R* __restrict__ jet_o) {
  yo[j] = q.s[0];
  yo[N + j] = q.s[1];
  yo[2 * N + j] = q.s[2];
  yo[3 * N + j] = q.s[3];
  yo[4 * N + j] = -1.0f;
  yo[5 * N + j] = q.s[4];
  yo[6 * N + j] = q.s[5];
  yo[7 * N + j] = q.pph;
  hit_o[j] = q.hit;
  steps_o[j] = q.steps;
  nc_o[j] = q.nc;
  rmin_o[j] = q.rmin;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < max_crossings) {
      cr_o[k * N + j] = q.cr[k];
      cp_o[k * N + j] = q.cp[k];
      ct_o[k * N + j] = q.ct[k];
    }
  }
  if constexpr (MARCH == MARCH_JETS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) jet_o[c * N + j] = q.jet[c];
  }
}

// Resident blocks per SM that each instantiation must allow, which caps
// its registers at 65536 / (THREADS x blocks) (nvcc for sm_90a). With AB3's
// bootstrap in the refill pass, ptxas's own choice put AB3 at 72 registers
// and spilled 68 bytes on the exact route: the exact route must allow 6
// blocks (at most 85 registers, no spill), the approx route 7 (72; at 64
// it spilled 140 bytes). The others keep ptxas's own choice (0: no
// bound): a register cap moved them (midpoint 64 -> 70, jets 72 -> 85).
// The double instantiations (march_kernel_f64) keep ptxas's own choice.
__host__ __device__ constexpr int march_min_blocks(int march, bool approx) {
  return march == MARCH_AB3 ? (approx ? 7 : 6) : 0;
}

// The float64 AB3 march's ring of right-hand sides (march_step.cuh's
// Ab3Ring: 3 slots x 6 rows x THREADS doubles, 18,432 bytes per block):
// this thread's column of the block's shared array (march_body on double
// with MARCH_AB3 only).
template <class R>
__device__ __forceinline__ Ab3Ring<R, THREADS> ab3_ring() {
  __shared__ R ring[3 * 6 * THREADS];
  return {ring + threadIdx.x};
}

// The kernel's body. MARCH: MARCH_MIDPOINT, MARCH_AB3 or MARCH_JETS;
// APPROX: MarchConfig.approx_recip; R: float, or double on the exact
// route. A resident grid of persistent warps; each lane marches one ray at
// a time, taken from the pool (pool[0]: the next ray index, pool[1]:
// retired blocks).
template <int MARCH, bool APPROX, class R>
__device__ __forceinline__ void march_body(
    const R* __restrict__ P, const R* __restrict__ y,
    const R* __restrict__ thr, R* __restrict__ yo, int* __restrict__ hit_o,
    int* __restrict__ steps_o, R* __restrict__ cr_o, R* __restrict__ cp_o,
    R* __restrict__ ct_o, int* __restrict__ nc_o, R* __restrict__ rmin_o,
    R* __restrict__ jet_o, int n, int* __restrict__ pool,
    const MarchParamsT<R>& mp, const JetParamsT<R>& jp) {
  static_assert(sizeof(R) == 4 || !APPROX,
                "the float64 march has the exact route only");
  // the float64 AB3 march keeps its history in a ring in shared memory
  constexpr bool RING = MARCH == MARCH_AB3 && sizeof(R) == 8;
  const size_t N = (size_t)n;
  const int lane = threadIdx.x & 31;
  const R m = __ldg(P + 0);
  const R a = __ldg(P + 1);
  const R r_h = __ldg(P + 2);
  const R r_ph = __ldg(P + 3);
  const R inv_rph = inv_rph_of(r_ph);
  MarchRay<MARCH, R> q;
  Ab3Ring<R, THREADS> ring{nullptr};
  R slots[3][KMAX];    // with the ring, the crossing slots q.cr, q.cp, q.ct
  int slot = 0;        // with the ring, the ray's step index mod 3
  if constexpr (RING) {
    ring = ab3_ring<R>();
    q.cr = slots[0];
    q.cp = slots[1];
    q.ct = slots[2];
  }
  int j = -1;          // the lane's ray, -1 for none
  bool live = false;   // the lane's ray is still marching
  bool empty = false;  // the pool has no ray left (the same in every lane)
  while (true) {
    const unsigned lm = __ballot_sync(FULL_MASK, live);
    const bool done = empty && lm == 0u;
    if (done || (!empty && __popc(lm) < REFILL)) {
      // The refill pass: the lanes whose rays ended write them out, then
      // take the next rays together and birth them.
      if (j >= 0 && !live) {
        march_finish(q, N, j, mp.max_crossings, yo, hit_o, steps_o, cr_o,
                     cp_o, ct_o, nc_o, rmin_o, jet_o);
        j = -1;
      }
      if (done) break;
      int end;
      const int k = pool_take(pool, ~lm, lane, end);
      if (!live && k < n) {
        j = k;
        march_birth(y, thr, N, j, mp, m, a, r_ph, q);
        if constexpr (RING)
          ray_boot_ring<APPROX>(mp, m, a, r_h, r_ph, inv_rph, q, ring,
                                slot);
        else
          ray_boot<MARCH, APPROX>(mp, m, a, r_h, r_ph, inv_rph, q);
        live = q.hit == HIT_NONE;
      }
      empty = end >= n;
      continue;
    }
#pragma unroll 1
    for (int rep = 0; rep < CHECK_STEPS && live; ++rep) {
      if constexpr (RING)
        ray_step_ring<APPROX>(mp, m, a, r_h, r_ph, inv_rph, q, ring, slot);
      else
        ray_step<MARCH, APPROX>(mp, m, a, r_h, r_ph, inv_rph, jp, q);
      live = q.hit == HIT_NONE;
    }
  }
  pool_retire(pool);
}

// The float march (march_body on float).
template <int MARCH, bool APPROX>
__global__ void __launch_bounds__(THREADS, march_min_blocks(MARCH, APPROX))
march_kernel(const float* __restrict__ P, const float* __restrict__ y,
             const float* __restrict__ thr, float* __restrict__ yo,
             int* __restrict__ hit_o, int* __restrict__ steps_o,
             float* __restrict__ cr_o, float* __restrict__ cp_o,
             float* __restrict__ ct_o, int* __restrict__ nc_o,
             float* __restrict__ rmin_o, float* __restrict__ jet_o, int n,
             int* __restrict__ pool, const MarchParams mp,
             const JetParams jp) {
  march_body<MARCH, APPROX>(P, y, thr, yo, hit_o, steps_o, cr_o, cp_o, ct_o,
                            nc_o, rmin_o, jet_o, n, pool, mp, jp);
}

// The float64 march (march_body on double, exact route).
template <int MARCH>
__global__ void __launch_bounds__(THREADS)
march_kernel_f64(const double* __restrict__ P, const double* __restrict__ y,
                 const double* __restrict__ thr, double* __restrict__ yo,
                 int* __restrict__ hit_o, int* __restrict__ steps_o,
                 double* __restrict__ cr_o, double* __restrict__ cp_o,
                 double* __restrict__ ct_o, int* __restrict__ nc_o,
                 double* __restrict__ rmin_o, double* __restrict__ jet_o,
                 int n, int* __restrict__ pool,
                 const MarchParamsT<double> mp,
                 const JetParamsT<double> jp) {
  march_body<MARCH, false>(P, y, thr, yo, hit_o, steps_o, cr_o, cp_o, ct_o,
                           nc_o, rmin_o, jet_o, n, pool, mp, jp);
}

// Resident blocks per SM of each instantiation (variant x approx, then the
// three double variants), its static shared memory per block, and the SM
// count, per device (queried once).
static int g_blocks[16][9];
static int g_smem[16][9];
static int g_sms[16];

template <class R>
using MarchKernelT = void (*)(const R*, const R*, const R*, R*, int*, int*,
                              R*, R*, R*, int*, R*, R*, int, int*,
                              const MarchParamsT<R>, const JetParamsT<R>);
typedef MarchKernelT<float> MarchKernel;

template <bool APPROX>
static MarchKernel march_kernel_fn(int variant) {
  return variant == MARCH_JETS   ? march_kernel<MARCH_JETS, APPROX>
         : variant == MARCH_AB3 ? march_kernel<MARCH_AB3, APPROX>
                                : march_kernel<MARCH_MIDPOINT, APPROX>;
}

static MarchKernel march_kernel_fn(int variant, bool approx) {
  return approx ? march_kernel_fn<true>(variant)
                : march_kernel_fn<false>(variant);
}

static MarchKernelT<double> march_kernel_f64_fn(int variant) {
  return variant == MARCH_JETS   ? march_kernel_f64<MARCH_JETS>
         : variant == MARCH_AB3 ? march_kernel_f64<MARCH_AB3>
                                : march_kernel_f64<MARCH_MIDPOINT>;
}

// The kernel of (variant, approx) for R = float, of variant for double
// (approx is refused before: the double march is exact only).
template <class R>
static MarchKernelT<R> march_kernel_for(int variant, bool approx) {
  if constexpr (sizeof(R) == 8)
    return march_kernel_f64_fn(variant);
  else
    return march_kernel_fn(variant, approx);
}

template <class R>
static int march_shape(int variant, bool approx, int* blocks, int* sms,
                       int* smem = nullptr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  const int k = sizeof(R) == 8 ? 6 + variant : variant * 2 + (approx ? 1 : 0);
  if (g_blocks[dev][k] == 0) {
    int b = 0, s = 0;
    cudaFuncAttributes attr;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, march_kernel_for<R>(variant, approx), THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncGetAttributes(&attr, march_kernel_for<R>(variant, approx));
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_blocks[dev][k] = b;
    g_smem[dev][k] = (int)attr.sharedSizeBytes;
    g_sms[dev] = s;
  }
  *blocks = g_blocks[dev][k];
  *sms = g_sms[dev];
  if (smem != nullptr) *smem = g_smem[dev][k];
  return 0;
}

template <class R>
static int march_variant(const MarchParamsT<R>* mp, const JetParamsT<R>* jp) {
  return jp != nullptr ? MARCH_JETS
         : mp->multistep ? MARCH_AB3 : MARCH_MIDPOINT;
}

// The launch of either scalar type (bh_march_launch, bh_march_launch64).
template <class R>
static int march_launch(const R* P, const R* y, const R* thr, R* yo, int* hit,
                        int* steps, R* cr, R* cp, R* ct, int* nc, R* rmin,
                        R* jet, int n, int* pool, const MarchParamsT<R>* mp,
                        const JetParamsT<R>* jp, void* stream) {
  const bool approx = mp->approx_recip != 0;
  if (sizeof(R) == 8 && approx) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int variant = march_variant(mp, jp);
    int blocks = 0, sms = 0;
    const int err = march_shape<R>(variant, approx, &blocks, &sms);
    if (err != 0) return err;
    int grid = blocks * sms;
    const int need = (n + THREADS - 1) / THREADS;
    if (grid > need) grid = need;
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    const JetParamsT<R> none = {};
    const JetParamsT<R> jets = jp != nullptr ? *jp : none;
    march_kernel_for<R>(variant, approx)<<<grid, THREADS, 0,
                                           (cudaStream_t)stream>>>(
        P, y, thr, yo, hit, steps, cr, cp, ct, nc, rmin, jet, n, pool, *mp,
        jets);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Launches the march kernel on ``stream``; returns a CUDA error code (0 on
// success). P: (4,) [m, a, r_h, r_ph]; y: (8, n) rows with p_t = -1; thr:
// (n,). jp: the jets' configuration, or null for no jets; jet: (3, n) rows
// that receive the jets' radiance (unused without jets). pool: two int32
// words, zero, which the launch leaves zero. The grid is the resident one
// (blocks per SM x SMs), fewer blocks where n is smaller.
int bh_march_launch(const float* P, const float* y, const float* thr,
                    float* yo, int* hit, int* steps, float* cr, float* cp,
                    float* ct, int* nc, float* rmin, float* jet, int n,
                    int* pool, const MarchParams* mp, const JetParams* jp,
                    void* stream) {
  return march_launch(P, y, thr, yo, hit, steps, cr, cp, ct, nc, rmin, jet, n,
                      pool, mp, jp, stream);
}

// The float64 march: bh_march_launch's arguments in double (the hit, steps
// and crossing counts int32), exact route only (approx_recip set returns
// cudaErrorInvalidValue).
int bh_march_launch64(const double* P, const double* y, const double* thr,
                      double* yo, int* hit, int* steps, double* cr,
                      double* cp, double* ct, int* nc, double* rmin,
                      double* jet, int n, int* pool,
                      const MarchParamsT<double>* mp,
                      const JetParamsT<double>* jp, void* stream) {
  return march_launch(P, y, thr, yo, hit, steps, cr, cp, ct, nc, rmin, jet, n,
                      pool, mp, jp, stream);
}

// The launch shape of the instantiation that (mp, jp) selects: out =
// {threads per block, resident blocks per SM, SMs, static shared memory
// bytes per block}; returns a CUDA error code.
int bh_march_shape(const MarchParams* mp, const JetParams* jp, int* out) {
  int blocks = 0, sms = 0, smem = 0;
  const int err = march_shape<float>(march_variant(mp, jp),
                                     mp->approx_recip != 0, &blocks, &sms,
                                     &smem);
  out[0] = THREADS;
  out[1] = blocks;
  out[2] = sms;
  out[3] = smem;
  return err;
}

// bh_march_shape of the float64 instantiation that (mp, jp) selects.
int bh_march_shape64(const MarchParamsT<double>* mp,
                     const JetParamsT<double>* jp, int* out) {
  int blocks = 0, sms = 0, smem = 0;
  const int err = march_shape<double>(march_variant(mp, jp), false, &blocks,
                                      &sms, &smem);
  out[0] = THREADS;
  out[1] = blocks;
  out[2] = sms;
  out[3] = smem;
  return err;
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

int bh_jet_params_size() { return (int)sizeof(JetParams); }

int bh_march_params64_size() { return (int)sizeof(MarchParamsT<double>); }

int bh_jet_params64_size() { return (int)sizeof(JetParamsT<double>); }

}  // extern "C"
