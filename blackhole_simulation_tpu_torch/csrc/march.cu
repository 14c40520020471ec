// March kernel for Hopper (sm_90a): march a batch of rays to horizon or
// escape, one thread per ray, recording the final state, the termination
// code, the step count, up to K equator crossings (r, phi, t), their count
// and the photon-ring proximity min |r - r_ph|.
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
// Design for the card:
// * One thread per ray, a 1-D launch over N rays with the tail masked;
//   nothing is padded in memory. The ray state, the crossing slots, hit,
//   steps, the count and r_min live in registers.
// * Layout: every input and output is row-major [row][ray], so consecutive
//   threads read and write consecutive words.
// * The caller orders rays in 64 x 64 pixel blocks (ops/pallas_march.py::
//   to_block_order) when MarchConfig.use_pallas is set, so a warp of 32
//   consecutive rays is a compact strip of one block and retires with its
//   slowest ray: the GPU form of the Pallas kernel's per-tile early exit.
// * The loop is march_step.cuh's march_ray, the render kernel's own loop:
//   while (i < max_steps && hit == NONE), renormalization after step i when
//   (i + 1) % renormalize_every == 0 on live rays.
// * The AB3 march (march_step.cuh's march_ray_ab3) is the kernel's other
//   instantiation, chosen at launch: the midpoint instantiation carries none
//   of its registers (two 6-word right-hand-side histories and two step
//   sizes). It evaluates one right-hand side per step instead of two.
// * approx_recip: rcp.approx.ftz.f32 for 1/S, 1/w and the step's divides,
//   IEEE divides otherwise.
// * Jets (a third instantiation, chosen when the caller passes JetParams):
//   the midpoint march with the jets' emission summed per live step into
//   three more registers and written as three more rows. The JAX package
//   runs this march in jnp (render/march.py:555-569, the same term as
//   pallas_march.py::march_tile's jets); the port runs it here. With jets
//   the wrapper's caller asks for exact divides and the midpoint march, as
//   the jnp march has them.

#include "march_step.cuh"

#define THREADS 128

// MARCH: 0 the midpoint march, 1 AB3, 2 the midpoint march with jets.
template <int MARCH>
__global__ void __launch_bounds__(THREADS)
march_kernel(const float* __restrict__ P, const float* __restrict__ y,
             const float* __restrict__ thr, float* __restrict__ yo,
             int* __restrict__ hit_o, int* __restrict__ steps_o,
             float* __restrict__ cr_o, float* __restrict__ cp_o,
             float* __restrict__ ct_o, int* __restrict__ nc_o,
             float* __restrict__ rmin_o, float* __restrict__ jet_o, int n,
             const MarchParams mp, const JetParams jp) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const float m = __ldg(P + 0);
  const float a = __ldg(P + 1);
  const float r_h = __ldg(P + 2);
  const float r_ph = __ldg(P + 3);
  float s[6] = {y[j], y[N + j], y[2 * N + j], y[3 * N + j], y[5 * N + j],
                y[6 * N + j]};
  const float pph = y[7 * N + j];
  int hit, steps, nc;
  float cr[KMAX], cp[KMAX], ct[KMAX], rmin, jet[3];
  if (MARCH == 1)
    march_ray_ab3(mp, mp.approx_recip != 0, m, a, r_h, r_ph, pph, thr[j], s,
                  hit, steps, nc, cr, cp, ct, rmin);
  else {
    const JetParams jets = jp;
    march_ray<MARCH == 2>(mp, mp.approx_recip != 0, m, a, r_h, r_ph, pph,
                          thr[j], s, hit, steps, nc, cr, cp, ct, rmin, &jets,
                          jet);
  }
  yo[j] = s[0];
  yo[N + j] = s[1];
  yo[2 * N + j] = s[2];
  yo[3 * N + j] = s[3];
  yo[4 * N + j] = -1.0f;
  yo[5 * N + j] = s[4];
  yo[6 * N + j] = s[5];
  yo[7 * N + j] = pph;
  hit_o[j] = hit;
  steps_o[j] = steps;
  nc_o[j] = nc;
  rmin_o[j] = rmin;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < mp.max_crossings) {
      cr_o[k * N + j] = cr[k];
      cp_o[k * N + j] = cp[k];
      ct_o[k * N + j] = ct[k];
    }
  }
  if (MARCH == 2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) jet_o[c * N + j] = jet[c];
  }
}

extern "C" {

// Launches the march kernel on ``stream``; returns cudaGetLastError().
// P: (4,) [m, a, r_h, r_ph]; y: (8, n) rows with p_t = -1; thr: (n,).
// jp: the jets' configuration, or null for no jets; jet: (3, n) rows that
// receive the jets' radiance (unused without jets).
int bh_march_launch(const float* P, const float* y, const float* thr,
                    float* yo, int* hit, int* steps, float* cr, float* cp,
                    float* ct, int* nc, float* rmin, float* jet, int n,
                    const MarchParams* mp, const JetParams* jp,
                    void* stream) {
  if (n > 0) {
    auto kernel = jp != nullptr ? march_kernel<2>
                  : mp->multistep ? march_kernel<1>
                                  : march_kernel<0>;
    const JetParams none = {};
    kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        P, y, thr, yo, hit, steps, cr, cp, ct, nc, rmin, jet, n, *mp,
        jp != nullptr ? *jp : none);
  }
  return (int)cudaGetLastError();
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_march_params_size() { return (int)sizeof(MarchParams); }

int bh_jet_params_size() { return (int)sizeof(JetParams); }

}  // extern "C"
