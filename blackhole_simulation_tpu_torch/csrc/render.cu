// Fused render kernel for Hopper (sm_90a): ray birth -> null projection ->
// Chebyshev shadow precull and critical-band metric -> geodesic march ->
// disk / starfield / photon-ring composite, one thread per pixel.
//
// Replaces blackhole_simulation_tpu/ops/pallas_render.py::_render_kernel
// (the Pallas TPU megakernel, with the march loop of
// ops/pallas_march.py::march_tile). The plain PyTorch version of the same
// function is ops/render.py::render_planes; every expression below is
// written in its order, so the two round alike. The composite's shading
// (the disk's crossings, the starfield, the glow) is csrc/shade.cuh's, the
// staged composite kernel's own (csrc/composite.cu), at D = 0, with the
// numbers of ops/shade.py::shade_args. Built by ops/build.py with
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (no
// --use_fast_math: divides, sqrtf, expf and logf stay IEEE/full precision;
// the compiler contracts nothing, so each operation rounds as the plain
// version's does, and the approx_recip route's fused multiply-adds are the
// step's own, explicit ones) and loaded through ctypes.
//
// What bounds it on the H100: FP32 arithmetic. Its only memory traffic is a
// 4 KB parameter row (every thread reads the same words, served by the L1)
// and three float32 output planes, 12 bytes per pixel (16 with the band
// plane). Each march step costs a few hundred FP32 operations per ray (two
// right-hand sides of the Kerr-Schild Hamiltonian with midpoint_iters = 1,
// one with AB3, the adaptive step size and the crossing record), so the
// least time is (operations per step) x (sum of steps over all rays) / (the
// card's FP32 rate); chip_smoke.py computes it from the step counts of the
// run and the rate measured by tools/vpu_peak.py.
//
// What holds it back (chip_smoke.py phase 12, H100 80GB HBM3 at 700 W):
// not divergence. An 8 x 4 patch's rays take nearly equal step counts, so
// the warps lose 5-8% of their lanes to waiting (lane efficiency 0.92-0.94
// on every 1080p path); the rest of the gap to the bound is instructions
// the hand count leaves out, the per-pixel birth and composite, and on the
// full-featured frame the NRS background and the overlay. The SASS census
// of the march loop (tools/sass_census.py, chip_smoke.py phase 13) showed
// where a step's uncounted instructions went: three per NaN-propagating
// min/max, a ~20-instruction modulo for the renormalization cadence, IEEE
// divides with their range checks and slow-path branches, and a separate
// product and sum for every multiply-add. The step (march_step.cuh) now
// takes one FMNMX per min/max, a per-ray renormalization countdown, the
// per-ray invariants out of the loop, the far-boost divide only beyond
// far_boost_radius, the AB3 bootstrap peeled out of its loop, and on the
// approx_recip route a fused multiply-add for each contracted term: the
// flagship loop fell from 629 instructions to 421 (PERF.md).
// Persistent warps that refill finished lanes (the march kernel's design,
// march.cu) were built and timed in several forms (refill thresholds,
// whole-warp refills, register caps, the state parked in shared memory):
// each was slower than this launch on the flagship, AB3, jets and
// full-featured 1080p frames, even this kernel's own body looping over
// patches taken from a pool. The loop's state costs registers beyond this
// kernel's and so resident warps, and a lane refill cannot win back more
// than the 6% the patches lose.
//
// Design for the card:
// * One thread per pixel. The ray state (7 values), hit, steps, the crossing
//   count and r_min live in registers; the K <= 4 crossing slots, indexed
//   by the count, in local memory (written a few times per ray, read once
//   by the composite), which keeps the flagship at 48 registers and 40
//   resident warps per SM.
// * Each warp covers an 8 x 4 pixel patch (a block of 4 warps covers 16 x 8
//   pixels). A warp retires when its slowest ray does, so compact patches
//   keep sky and shadow-interior warps short: the GPU form of the Pallas
//   kernel's per-tile early exit. Each thread runs
//   while (i < max_steps && hit == NONE), so no overshoot steps exist.
// * The periodic null renormalization runs after step i when
//   (i + 1) % renormalize_every == 0 and the ray is still live, the cadence
//   of the Pallas kernel's block-boundary hoist, counted down per ray
//   (march_step.cuh::renorm_due) rather than by a modulo.
// * The march loop and its step are march_step.cuh's, the same source as
//   the march kernel (march.cu) and the gradient kernel's replay.
// * The parameter row stays in device memory; the static configuration
//   comes by value in RenderStatic. Ragged frame edges are masked here;
//   nothing is padded in memory.
// * With MarchConfig.refine_band > 0 a fourth plane holds each pixel's
//   critical-band metric (precull.band_metric_values on the birth row's
//   eta = q, E = 1, and the Chebyshev curve without the cull's shift; the
//   pole criterion folded in when refine_pole_w > 0), which the refinement
//   pass (render/pipeline.py::refine_critical_band) selects from.
// * With MarchConfig.multistep the march is march_step.cuh's AB3 march
//   (march_ray_ab3: its two midpoint bootstrap steps, then a loop of
//   one-right-hand-side steps), the kernel's other instantiation, chosen
//   at launch.
// * approx_recip (the APPROX instantiations, chosen at launch): 1/S, 1/w
//   and the step's divides use rcp.approx.ftz.f32, as the Pallas kernel
//   uses the TPU's approximate reciprocal, and the step's multiply-adds are
//   contracted (march_step.cuh::madd), as XLA contracts them on a GPU; the
//   jets' exp and pow are float. Every other division is exact. Without it
//   the kernel is bit-equal to the plain version.
// * sqrtf is IEEE (correctly rounded); sin and cos go through double and
//   round once. The plain version computes these three the same way, so
//   that a last-bit difference cannot grow along a chaotic orbit or move a
//   sub-pixel star spot.
// * Every division is a division (IEEE), constants included: each JAX
//   operation on its own rounds so (XLA's whole-program rewrites aside).
// * NaN handling follows jnp: maximum/minimum/clip propagate NaN (fmaxf and
//   fminf would drop it, and the march's sanity freeze relies on NaN reaching
//   isfinite). The floored modulo is jnp.mod's own: fmodf, then shifted by
//   the divisor where the signs differ.

#include "march_step.cuh"

// A plain float in csrc/shade.cuh's number type.
using N0 = shade::Dual<float, 0>;

// Parameter-row layout (ops/render.py, pallas_render.py:62-110).
#define P_M 0
#define P_A 1
#define P_RH 2
#define P_RPH 3
#define P_ISCO 4
#define P_STOPR 5
#define P_HORTHR 6
#define P_R0 7
#define P_U0 8
#define P_S0 9
#define P_PH0 10
#define P_K1 11
#define P_K2 12
#define P_ROLLC 13
#define P_ROLLS 14
#define P_JX 15
#define P_JY 16
#define P_C0 17
#define P_CR 21
#define P_CTH 25
#define P_CPH 29
#define P_CHEB_MID 33
#define P_CHEB_HALF 34
#define P_LAM_LO 35
#define P_LAM_HI 36
#define P_FLIP 37
#define P_INV_LOGR 39
#define P_ETA 40
#define ETA_K 32
#define P_TSHAPE (P_ETA + ETA_K)
#define P_RGB (P_TSHAPE + shade::CHEB_K)
#define OVERLAY_N 32
#define P_OVW (P_RGB + 3 * shade::CHEB_K)
#define P_OAL (P_OVW + 1)
#define P_OBE (P_OAL + 2 * OVERLAY_N)
#define P_OVA (P_OBE + 2 * OVERLAY_N)
#define P_NRS_BMIN (P_OVA + 2 * OVERLAY_N)
#define P_NRS_TH (P_NRS_BMIN + 1)
#define P_NRS_W (P_NRS_TH + 1)
#define NRS_H 16
#define CHEB_ERR 0.03

#define PATCH_W 8
#define PATCH_H 4
#define BLOCK_W 16
#define BLOCK_H 8
#define THREADS 128

// Must match ops/render.py::_CRenderStatic field for field.
struct RenderStatic {
  int width, height, max_steps, renormalize_every, max_crossings,
      midpoint_iters, approx_recip, precull, disk_on, spectral, starfield,
      glow, far_cap_on, multistep, ab3_renorm_every, ab3_tail_renorm, jets,
      nrs_on, overlay;
  float step_rate, min_step, max_step, far_step_cap_rate, far_boost_radius,
      escape_radius, escape_sanity_r, record_r_min, record_r_max,
      refine_band, refine_pole_w, pole_scale, start_jitter;
  JetParams jet;
  shade::DiskArgsT<float> disk;   // ops/shade.py::shade_args
  shade::StarArgsT<float> stars;
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The NRS surrogate's deflection (models/nrs.py::nrs_apply, the
// deflection output only): the 3 -> 16 -> 16 -> 16 tanh MLP on
// (b / 40, theta_obs / pi, a), weights read from the row in the JAX
// kernel's summation order (pallas_render.py:362-379), tanh through double.
__device__ float nrs_deflection(const float* __restrict__ W, float bn,
                                float thn, float a) {
  float h[NRS_H];
#pragma unroll
  for (int j = 0; j < NRS_H; ++j) {
    const float acc = bn * __ldg(W + j) +
                      (thn * __ldg(W + NRS_H + j) +
                       a * __ldg(W + 2 * NRS_H + j) + __ldg(W + 48 + j));
    h[j] = (float)tanh((double)acc);
  }
  int off = 64;
#pragma unroll
  for (int layer = 0; layer < 2; ++layer) {
    float h2[NRS_H];
#pragma unroll
    for (int j = 0; j < NRS_H; ++j) {
      float acc = __ldg(W + off + 256 + j);
#pragma unroll
      for (int i = 0; i < NRS_H; ++i)
        acc = acc + h[i] * __ldg(W + off + i * NRS_H + j);
      h2[j] = (float)tanh((double)acc);
    }
#pragma unroll
    for (int j = 0; j < NRS_H; ++j) h[j] = h2[j];
    off += 272;
  }
  float alpha = __ldg(W + off + 48);
#pragma unroll
  for (int i = 0; i < NRS_H; ++i) alpha = alpha + h[i] * __ldg(W + off + i * 3);
  return alpha;
}

// Registers per thread of each instantiation (MARCH, EXTRAS), set for both
// routes, since ptxas's own choice spilled on some (nvcc for sm_90a:
// 72 registers and 8 bytes on the exact route's jets with extras; at 80,
// 8 bytes on AB3 with extras, which takes 96, as it compiled to 95 before
// the step's redesign); chip_smoke.py fails on a spill. The others are what
// ptxas chooses on its own; the flagship's 48 come from the crossing slots
// kept in local memory (record_step<true>).
__host__ __device__ constexpr int render_registers(int march, bool extras) {
  return extras ? (march == 1 ? 96 : 80) : (march == 0 ? 48 : 64);
}

// MARCH: 0 the midpoint march, 1 AB3, 2 the midpoint march with jets.
// EXTRAS: the start offset, the NRS far field and the shadow overlay, each
// then on as RenderStatic says; without EXTRAS none of their code is built,
// so the flagship instantiations (0, false, *) carry none of it. APPROX:
// MarchConfig.approx_recip, the march's reciprocals and contracted
// multiply-adds (march_step.cuh); the flagship runs (0, false, true).
template <int MARCH, bool EXTRAS, bool APPROX>
__global__ void __launch_bounds__(THREADS)
    __maxnreg__(render_registers(MARCH, EXTRAS))
render_kernel(const float* __restrict__ P, float* __restrict__ out,
              int* __restrict__ steps_out, const RenderStatic st) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * BLOCK_W + (warp & 1) * PATCH_W + (lane % PATCH_W);
  const int y = blockIdx.y * BLOCK_H + (warp >> 1) * PATCH_H + (lane / PATCH_W);
  if (x >= st.width || y >= st.height) return;

  const float m = __ldg(P + P_M);
  const float a = __ldg(P + P_A);
  const float r_h = __ldg(P + P_RH);
  const float r_ph = __ldg(P + P_RPH);
  const float r_in = __ldg(P + P_ISCO);

  // --- camera ray (camera_scalars from the row) ---
  const float ix = (float)x, iy = (float)y;
  float nx = (ix + 0.5f + __ldg(P + P_JX)) / (float)st.width * 2.0f - 1.0f;
  float ny = 1.0f - (iy + 0.5f + __ldg(P + P_JY)) / (float)st.height * 2.0f;
  float cx = nx * __ldg(P + P_K1);
  float cy = ny * __ldg(P + P_K2);
  const float rc = __ldg(P + P_ROLLC), rs = __ldg(P + P_ROLLS);
  float cx2 = cx * rc - cy * rs;
  float cy2 = cx * rs + cy * rc;
  cx = cx2;
  cy = cy2;
  float inv_norm = 1.0f / sqrtf(1.0f + cx * cx + cy * cy);
  float n_r = -inv_norm;
  float n_th = -cy * inv_norm;
  float n_ph = -cx * inv_norm;
  float p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p[j] = __ldg(P + P_C0 + j) + n_r * __ldg(P + P_CR + j) +
           n_th * __ldg(P + P_CTH + j) + n_ph * __ldg(P + P_CPH + j);
  float inv = 1.0f / (-p[0]);
  float pr = p[1] * inv;
  float pu = -(p[2] * inv) / __ldg(P + P_S0);
  const float pph = p[3] * inv;
  float t = 0.0f;
  float r = __ldg(P + P_R0);
  float u = __ldg(P + P_U0);
  float ph = __ldg(P + P_PH0);
  pr = ks_renormalize_pr(m, a, r, u, pr, pu, pph);
  const size_t plane = (size_t)st.width * st.height;
  const size_t idx = (size_t)y * st.width + x;

  const MarchParams mp = {st.max_steps, st.renormalize_every,
                          st.max_crossings, st.midpoint_iters,
                          st.approx_recip, st.far_cap_on, st.multistep,
                          st.ab3_renorm_every, st.ab3_tail_renorm,
                          st.step_rate,
                          st.min_step, st.max_step, st.far_step_cap_rate,
                          st.far_boost_radius, st.escape_radius,
                          st.escape_sanity_r, st.record_r_min,
                          st.record_r_max};
  // --- start offset (ops/march.py::start_offset_rows) ---
  if (EXTRAS && st.start_jitter > 0.0f) {
    float s0[6] = {t, r, u, ph, pr, pu};
    start_offset<APPROX>(mp, m, a, r_h, r_ph, st.start_jitter, pph, s0);
    t = s0[0];
    r = s0[1];
    u = s0[2];
    ph = s0[3];
    pr = s0[4];
    pu = s0[5];
  }

  // --- shadow precull, the critical-band metric and the NRS skip ---
  float thr = __ldg(P + P_HORTHR);
  const bool band_on = st.refine_band > 0.0f;
  const bool nrs_on = EXTRAS && st.nrs_on;
  float b_tot = 0.0f;
  bool far = false;
  if (st.precull || band_on || nrs_on) {
    const float pt = -1.0f;
    float lam = __ldg(P + P_FLIP) * pph;
    float w0 = 1.0f - u * u;
    float s2 = jmax(w0, F(1e-12));
    float c2 = u * u;
    float eta = pu * pu * w0 + c2 * (pph * pph / s2 - a * a);
    float t_dom = jclip((lam - __ldg(P + P_CHEB_MID)) / __ldg(P + P_CHEB_HALF),
                        -1.0f, 1.0f);
    float cheb_raw = shade::clenshaw<ETA_K>(P + P_ETA, N0{t_dom}).v;
    const float lam_lo = __ldg(P + P_LAM_LO), lam_hi = __ldg(P + P_LAM_HI);
    if (band_on) {
      // precull.band_metric_values, fold_pole_metric, pole_w_min_values
      float m2 = m * m;
      float d_eta = fabsf(eta - cheb_raw) / m2;
      float excess = jmax(lam - lam_hi, lam_lo - lam);
      float d_band = d_eta + jmax(excess, 0.0f) * (4.0f / m);
      if (st.refine_pole_w > 0.0f) {
        float a2 = jmax(a * a, F(1e-12));
        float b2 = a2 - eta - lam * lam;
        float disc = sqrtf(jmax(b2 * b2 + 4.0f * a2 * eta, 0.0f));
        float umax2 = jclip((b2 + disc) / (2.0f * a2), 0.0f, 1.0f);
        d_band = jmin(d_band, (1.0f - umax2) * st.pole_scale);
      }
      out[3 * plane + idx] = d_band;
    }
    if (st.precull) {
      float eta_crit = cheb_raw - F(CHEB_ERR) * m * m;
      const float margin = F(0.04);
      bool inside = eta < eta_crit * (1.0f - margin) - margin * m * m;
      bool in_range = (lam > lam_lo) && (lam < lam_hi);
      float ssq = r * r + a * a * c2;
      float delta = r * r - 2.0f * m * r + a * a;
      float dr_dlam = (2.0f * m * r * pt + delta * pr + a * pph) / ssq;
      bool dead = in_range && inside && (eta >= 0.0f) && (dr_dlam < 0.0f);
      if (dead) thr = __ldg(P + P_STOPR);
    }
    if (nrs_on) {
      // models/nrs.nrs_far_field_rows' skip: b = sqrt(eta + lam^2).
      b_tot = sqrtf(jmax(eta + lam * lam, F(1e-12)));
      far = b_tot > __ldg(P + P_NRS_BMIN);
      if (far) thr = F(1e9);
    }
  }

  // --- march (march_step.cuh, the march kernel's own loop) ---
  const int K = st.max_crossings;
  float s[6] = {t, r, u, ph, pr, pu};
  int hit, steps, nc;
  float cr[KMAX], cp[KMAX], ct[KMAX], rmin, jet[3];
  if (MARCH == 1) {
    march_ray_ab3<APPROX>(mp, m, a, r_h, r_ph, pph, thr, s, hit, steps, nc,
                          cr, cp, ct, rmin);
  } else {
    const JetParams jp = st.jet;
    march_ray<MARCH == 2, APPROX>(mp, m, a, r_h, r_ph, pph, thr, s, hit,
                                  steps, nc, cr, cp, ct, rmin, &jp, jet);
  }

  // --- composite (csrc/shade.cuh, the staged composite's own) ---
  const bool escaped = hit == HIT_ESCAPE;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float trans = 1.0f;
  if (st.disk_on) {
    const shade::ChebTables tab = {P + P_TSHAPE, P + P_RGB, P + P_INV_LOGR};
    // Not unrolled: four inlined copies of a slot's shading left the
    // capped instantiations short of registers (ptxas spilled).
#pragma unroll 1
    for (int k = 0; k < KMAX; ++k) {
      // Slots past the crossing count add nothing (the plain version
      // evaluates and masks them).
      if (k < K && k < nc) {
        const shade::Slot<float, 0> sl = shade::disk_slot(
            st.spectral, st.disk, tab, N0{m}, N0{a}, N0{r_in}, N0{cr[k]},
            N0{cp[k]}, N0{ct[k]}, N0{pph}, k == 0 ? 3 : 1,
            shade::K<float>(st.disk.dens), shade::K<float>(1.0));
        float wgt = sl.valid ? trans * sl.alpha.v : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + wgt * sl.c[c].v;
        trans = sl.valid ? trans * (1.0f - sl.alpha.v) : trans;
      }
    }
  }
  // The plain version adds 0 * (the starfield of a fixed finite dummy state)
  // to captured rays; skipping them here gives the same values.
  if (st.starfield && escaped) {
    const N0 rows[7] = {{s[1]}, {s[2]}, {s[3]}, {-1.0f}, {s[4]}, {s[5]},
                        {pph}};
    N0 dir[3];
    shade::escape_direction_u(rows, N0{m}, N0{a}, dir);
    const shade::Rgb<float, 0> bg =
        shade::starfield(dir[0], dir[1], dir[2], st.stars);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + trans * bg.c[c].v;
  }
  if (MARCH == 2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + jet[c];
  }
  if (st.glow) {
    const float glow = escaped ? shade::glow_of(N0{rmin}, N0{r_ph}).v : 0.0f;
    const float order = shade::glow_order<float>(nc);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = rgb[c] + glow * shade::glow_weight(c, order);
  }
  // The NRS background of the far rays: the surrogate's deflection of the
  // birth direction (born from the possibly offset u and phi but the
  // camera's r, as in the JAX kernel), Rodrigues-rotated about the orbital
  // plane's normal, then the starfield. Computed for far pixels only; the
  // plain version computes it everywhere and selects.
  if (EXTRAS && st.nrs_on && st.starfield && far) {
    const float r0 = __ldg(P + P_R0), s0 = __ldg(P + P_S0),
                u0 = __ldg(P + P_U0);
    const N0 rows[7] = {{r0}, {u}, {ph}, {-1.0f}, {pr}, {pu}, {pph}};
    N0 dir[3];
    shade::escape_direction_u(rows, N0{m}, N0{a}, dir);
    const float v[3] = {dir[0].v, dir[1].v, dir[2].v};
    const float sph = (float)sin((double)ph), cph = (float)cos((double)ph);
    const float px = r0 * s0 * cph;
    const float py = r0 * s0 * sph;
    const float pz = r0 * u0;
    const float alpha_d = nrs_deflection(P + P_NRS_W, b_tot * F(1.0 / 40.0),
                                         __ldg(P + P_NRS_TH), a);
    float nxr = py * v[2] - pz * v[1];
    float nyr = pz * v[0] - px * v[2];
    float nzr = px * v[1] - py * v[0];
    const float inv_n =
        1.0f / sqrtf(jmax(nxr * nxr + nyr * nyr + nzr * nzr, F(1e-20)));
    nxr = nxr * inv_n;
    nyr = nyr * inv_n;
    nzr = nzr * inv_n;
    const float ca = (float)cos((double)alpha_d);
    const float sa = (float)sin((double)alpha_d);
    const float cxr = nyr * v[2] - nzr * v[1];
    const float cyr = nzr * v[0] - nxr * v[2];
    const float czr = nxr * v[1] - nyr * v[0];
    const shade::Rgb<float, 0> bg = shade::starfield(
        N0{v[0] * ca + cxr * sa}, N0{v[1] * ca + cyr * sa},
        N0{v[2] * ca + czr * sa}, st.stars);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = bg.c[c].v;
  }
  // The Bardeen critical-curve overlay: the birth ray's conserved
  // (lambda, eta) as celestial (alpha, beta), the squared distance to the
  // row's 64-point polyline, a Gaussian line weight (pallas_render.py:
  // 397-444).
  if (EXTRAS && st.overlay) {
    const float s0o = __ldg(P + P_S0), u0c = __ldg(P + P_U0);
    const float w0o = 1.0f - u * u;
    const float s2o = jmax(w0o, F(1e-12));
    const float etao = pu * pu * w0o + u * u * (pph * pph / s2o - a * a);
    const float alpha_p = -pph / s0o;
    const float cot0 = u0c / s0o;
    const float beta_sq = etao + a * a * u0c * u0c - pph * pph * cot0 * cot0;
    const float sgn = pu > 0.0f ? 1.0f : (pu < 0.0f ? -1.0f : 0.0f);
    const float beta_p = sgn * sqrtf(jmax(beta_sq, 0.0f));
    const float deficit = jmax(-beta_sq, 0.0f);
    const float big = F(1e30);
    float dmin = big;
    for (int i = 0; i < 2 * OVERLAY_N; ++i) {
      const int j = i + 1 == 2 * OVERLAY_N ? 0 : i + 1;
      const float ax = __ldg(P + P_OAL + i), ay = __ldg(P + P_OBE + i);
      const float bx = __ldg(P + P_OAL + j), by = __ldg(P + P_OBE + j);
      const bool ok =
          __ldg(P + P_OVA + i) > 0.5f && __ldg(P + P_OVA + j) > 0.5f;
      const float dx = bx - ax, dy = by - ay;
      const float len_sq = dx * dx + dy * dy;
      const float tt = jclip(((alpha_p - ax) * dx + (beta_p - ay) * dy) /
                                 jmax(len_sq, F(1e-20)),
                             0.0f, 1.0f);
      const float ex = alpha_p - (ax + tt * dx);
      const float ey = beta_p - (ay + tt * dy);
      const float d = ex * ex + ey * ey;
      dmin = jmin(dmin, ok ? d : big);
    }
    dmin = dmin + deficit;
    const float wdt = __ldg(P + P_OVW);
    const float wgt = F(1.2) * (float)exp((double)(-dmin / jmax(wdt * wdt,
                                                               F(1e-12))));
    const float line[3] = {F(0.15), 1.0f, F(0.35)};
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + wgt * line[c];
  }
  out[idx] = rgb[0];
  out[plane + idx] = rgb[1];
  out[2 * plane + idx] = rgb[2];
  if (steps_out != nullptr) steps_out[idx] = steps;
}

typedef void (*RenderKernel)(const float*, float*, int*, const RenderStatic);

template <bool APPROX>
static RenderKernel render_kernel_for(bool jets, bool multistep, bool extras) {
  return jets ? (extras ? render_kernel<2, true, APPROX>
                        : render_kernel<2, false, APPROX>)
         : multistep ? (extras ? render_kernel<1, true, APPROX>
                               : render_kernel<1, false, APPROX>)
                     : (extras ? render_kernel<0, true, APPROX>
                               : render_kernel<0, false, APPROX>);
}

// The instantiation ``st`` selects. Jets take the midpoint march, as in the
// JAX kernel (pallas_render.py:266).
static RenderKernel render_kernel_for(const RenderStatic* st) {
  const bool extras = st->start_jitter > 0.0f || st->nrs_on || st->overlay;
  return st->approx_recip
             ? render_kernel_for<true>(st->jets, st->multistep, extras)
             : render_kernel_for<false>(st->jets, st->multistep, extras);
}

extern "C" {

// Launches the render kernel on ``stream``; returns cudaGetLastError().
// ``out`` holds 3 planes, 4 with the band plane; ``steps`` (may be null)
// receives each ray's march step count.
int bh_render_launch(const float* params, float* out, int* steps,
                     const RenderStatic* st, void* stream) {
  dim3 block(THREADS);
  dim3 grid((st->width + BLOCK_W - 1) / BLOCK_W,
            (st->height + BLOCK_H - 1) / BLOCK_H);
  render_kernel_for(st)<<<grid, block, 0, (cudaStream_t)stream>>>(
      params, out, steps, *st);
  return (int)cudaGetLastError();
}

// The launch shape of the instantiation that ``st`` selects, on the
// current device: out = {threads per block, resident blocks per SM, SMs};
// returns a CUDA error code.
int bh_render_shape(const RenderStatic* st, int* out) {
  int dev = 0, blocks = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, render_kernel_for(st), THREADS, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = THREADS;
  out[1] = blocks;
  out[2] = sms;
  return (int)err;
}

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_render_static_size() { return (int)sizeof(RenderStatic); }

}  // extern "C"
