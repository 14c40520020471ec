// Fused render kernel for Hopper (sm_90a): ray birth -> null projection ->
// Chebyshev shadow precull and critical-band metric -> geodesic march ->
// disk / starfield / photon-ring composite, one thread per pixel.
//
// Replaces blackhole_simulation_tpu/ops/pallas_render.py::_render_kernel
// (the Pallas TPU megakernel, with the march loop of
// ops/pallas_march.py::march_tile). The plain PyTorch version of the same
// function is ops/render.py::render_planes; every expression below is
// written in its order, so the two round alike. Built by ops/build.py with
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
#define CHEB_K 32
#define P_TSHAPE (P_ETA + CHEB_K)
#define SPEC_K 16
#define P_RGB (P_TSHAPE + SPEC_K)
#define OVERLAY_N 32
#define P_OVW (P_RGB + 3 * SPEC_K)
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
      glow, artistic, far_cap_on, beam_k, beam_n, beam_neg, outer_k,
      outer_n, outer_neg, multistep, ab3_renorm_every, ab3_tail_renorm,
      jets, nrs_on, overlay;
  float step_rate, min_step, max_step, far_step_cap_rate, far_boost_radius,
      escape_radius, escape_sanity_r, record_r_min, record_r_max,
      disk_outer_radius, disk_density, disk_t_peak, disk_beaming, disk_turb,
      disk_one_minus_turb, disk_softness, disk_outer_pow, disk_edge_width,
      nt_peak, art_r, art_g, art_b, star_brightness, star_nebula, star_freq0,
      star_freq1, star_thr0, star_thr1, refine_band, refine_pole_w,
      pole_scale, start_jitter;
  JetParams jet;
};

// ---------------------------------------------------------------------------
// Shading (render/shading.py)
// ---------------------------------------------------------------------------

__device__ float fbm2(float x, float y, int octaves) {
  float total = 0.0f, amp = 0.5f, freq = 1.0f;
  for (int o = 0; o < octaves; ++o) {
    total = total + amp * value_noise2(x * freq, y * freq);
    amp *= 0.5f;
    freq *= 2.0f;
  }
  return total;
}

__device__ float atan2_approx(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float hi = jmax(ax, ay), lo = jmin(ax, ay);
  float z = lo / jmax(hi, F(1e-30));
  float z2 = z * z;
  float p = F(-0.0117212) * z2 + F(0.0526477);
  p = p * z2 + F(-0.1172626);
  p = p * z2 + F(0.1936999);
  p = p * z2 + F(-0.3326231);
  p = p * z2 + F(0.9999798);
  float t = p * z;
  t = ay > ax ? F(1.5707963267948966) - t : t;
  t = x < 0.0f ? F(3.141592653589793) - t : t;
  return y < 0.0f ? -t : t;
}

// x**p by the host's plan (shading._powi_plan): k square roots, then
// ^n by binary powers, reciprocal if negative; k < 0 means a plain powf.
__device__ float powi_plan(float x, int k, int n, int neg, float p) {
  if (k < 0) return powf(x, p);
  float base = x;
  for (int i = 0; i < k; ++i) base = sqrtf(base);
  float acc = 1.0f, bit = base;
  bool have = false;
  while (n) {
    if (n & 1) {
      acc = have ? acc * bit : bit;
      have = true;
    }
    bit = bit * bit;
    n >>= 1;
  }
  return neg ? 1.0f / acc : acc;
}

__device__ __forceinline__ float pow4(float x) {
  float x2 = x * x;
  return x2 * x2;
}

__device__ void blackbody_ramp(float t_kelvin, float c[3]) {
  float t = jclip(t_kelvin, 1000.0f, 40000.0f) / 100.0f;
  float red = t <= 66.0f
                  ? 255.0f
                  : F(329.698727446) * powf(jmax(t - 60.0f, F(1e-6)),
                                            F(-0.1332047592));
  float g_lo = F(99.4708025861) * logf(jmax(t, F(1e-6))) - F(161.1195681661);
  float g_hi = F(288.1221695283) * powf(jmax(t - 60.0f, F(1e-6)),
                                        F(-0.0755148492));
  float green = t <= 66.0f ? g_lo : g_hi;
  float b_lo = F(138.5177312231) * logf(jmax(t - 10.0f, F(1e-6))) -
               F(305.0447927307);
  float blue = t >= 66.0f ? 255.0f : (t <= 19.0f ? 0.0f : b_lo);
  float ch[3] = {red, green, blue};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float v = jclip(ch[i] / 255.0f, 0.0f, 1.0f);
    c[i] = v * v;
  }
}

__device__ float equatorial_g_factor(float m, float a, float r, float lam) {
  r = jmax(r, F(1.05));
  float two_mr = 2.0f * m * r;
  float sig = r * r;
  float g_tt = -(1.0f - two_mr / sig);
  float g_tph = -two_mr * a / sig;
  float g_phph = r * r + a * a + two_mr * a * a / sig;
  float sqrt_m = sqrtf(m);
  float omega = sqrt_m / (r * sqrtf(r) + a * sqrt_m);
  float ut_inv_sq = -(g_tt + 2.0f * omega * g_tph + omega * omega * g_phph);
  float u_t = 1.0f / sqrtf(jmax(ut_inv_sq, F(1e-6)));
  float doppler = 1.0f - lam * omega;
  doppler = fabsf(doppler) < F(1e-4) ? F(1e-4) : doppler;
  return 1.0f / (u_t * doppler);
}

__device__ float clenshaw(const float* __restrict__ c, int K, float t) {
  float b1 = 0.0f, b2 = 0.0f;
  for (int j = K - 1; j > 0; --j) {
    float nb1 = 2.0f * t * b1 - b2 + __ldg(c + j);
    b2 = b1;
    b1 = nb1;
  }
  return t * b1 - b2 + __ldg(c);
}

// One recorded disk crossing: colour * intensity into rgb, alpha, valid.
__device__ void disk_slot(const RenderStatic& st, const float* __restrict__ P,
                          float m, float a, float r_in, float r_c,
                          float phi_c, float t_c, float lam, int octaves,
                          float rgb[3], float* alpha, bool* valid_out) {
  bool valid = (r_c > r_in) && (r_c < st.disk_outer_radius);
  r_c = valid ? r_c : r_in * 2.0f;
  phi_c = valid ? phi_c : 0.0f;
  t_c = valid ? t_c : 0.0f;
  float g = equatorial_g_factor(m, a, jmax(r_c, r_in), lam);
  g = jclip(g, F(0.05), 5.0f);
  float rk = jmax(r_c, r_in);
  float omega_k = sqrtf(m) / (rk * sqrtf(rk) + a * sqrtf(m));
  float phase = phi_c - omega_k * t_c;
  phase = fmod_floor(phase, F(6.283185307179586));
  float noise = fbm2(r_c * F(1.7), phase * 3.0f, octaves);
  float turb = st.disk_one_minus_turb + st.disk_turb * (F(0.4) + F(1.2) * noise);
  float inner = jclip((r_c - r_in) / (st.disk_softness * r_in + F(1e-6)),
                      0.0f, 1.0f);
  float edge = smooth(inner) *
               jclip((st.disk_outer_radius - r_c) / st.disk_edge_width, 0.0f,
                     1.0f);
  float color[3];
  float intensity;
  if (st.spectral) {
    float x01 = logf(jmax(r_c / r_in, F(1e-6))) * __ldg(P + P_INV_LOGR);
    float xs = sqrtf(jclip(x01, 0.0f, 1.0f));
    float tx = jclip(2.0f * xs - 1.0f, -1.0f, 1.0f);
    float t_shape = jclip(clenshaw(P + P_TSHAPE, SPEC_K, tx), 0.0f, 1.0f);
    float t_obs = jclip(g * t_shape * st.disk_t_peak, 900.0f, 40000.0f);
    float y01 = powf((t_obs - 900.0f) / 39100.0f, F(0.4));
    float ty = jclip(2.0f * y01 - 1.0f, -1.0f, 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      color[c] = jmax(clenshaw(P + P_RGB + c * SPEC_K, SPEC_K, ty), 0.0f);
    intensity = pow4(g) * pow4(t_shape);
  } else {
    // nt_temperature_profile: _powi(q, 0.25) * _powi(x, -0.75) / peak
    float x = jmax(jmax(r_c, r_in * F(1 + 1e-4)) / r_in, F(1.0 + 1e-6));
    float q = 1.0f - sqrtf(1.0f / x);
    float bq = sqrtf(sqrtf(q));
    float bx = sqrtf(sqrtf(x));
    float t_shape = bq * (1.0f / (bx * (bx * bx))) / st.nt_peak;
    if (st.artistic) {
      color[0] = st.art_r;
      color[1] = st.art_g;
      color[2] = st.art_b;
    } else {
      blackbody_ramp(jclip(g * t_shape * st.disk_t_peak, 1000.0f, 40000.0f),
                     color);
    }
    float outer = powi_plan(jmax(r_in, r_c) / r_in, st.outer_k, st.outer_n,
                            st.outer_neg, st.disk_outer_pow);
    intensity = powi_plan(g, st.beam_k, st.beam_n, st.beam_neg,
                          st.disk_beaming) *
                pow4(t_shape) * outer;
  }
  float al = jclip(st.disk_density * edge * turb, 0.0f, 1.0f);
  *alpha = valid ? al : 0.0f;
  float masked = valid ? intensity : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = color[c] * masked;
  *valid_out = valid;
}

__device__ void escape_direction(float m, float a, float r, float u, float ph,
                                 float pr, float pu, float pph, float dir[3]) {
  const float pt = -1.0f;
  u = jclip(u, -1.0f, 1.0f);
  float w = jmax(1.0f - u * u, F(1e-12));
  float s = sqrtf(w);
  float sig = r * r + a * a * u * u;
  float delta = r * r - 2.0f * m * r + a * a;
  float inv_sig = 1.0f / sig;
  float h = 2.0f * m * r * inv_sig;
  float v_r = h * pt + delta * inv_sig * pr + a * inv_sig * pph;
  float v_th = -r * pu * s * inv_sig;
  float v_ph = r * s * (a * inv_sig * pr + pph * inv_sig / w);
  float st = s, ct = u;
  // sin/cos by way of double, rounded once, as the plain version.
  float sp = (float)sin((double)ph), cp = (float)cos((double)ph);
  float dx = v_r * st * cp + v_th * ct * cp - v_ph * sp;
  float dy = v_r * st * sp + v_th * ct * sp + v_ph * cp;
  float dz = v_r * ct - v_th * st;
  float inv_n = 1.0f / sqrtf(jmax(dx * dx + dy * dy + dz * dz, F(1e-30)));
  dir[0] = dx * inv_n;
  dir[1] = dy * inv_n;
  dir[2] = dz * inv_n;
}

__device__ void starfield(const RenderStatic& st, float dx, float dy, float dz,
                          float out[3]) {
  float u = atan2_approx(dy, dx);
  float v = jclip(dz, -1.0f, 1.0f);
  out[0] = out[1] = out[2] = 0.0f;
  const float freqs[2] = {st.star_freq0, st.star_freq1};
  const float thrs[2] = {st.star_thr0, st.star_thr1};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float freq = freqs[s];
    float cu = floorf(u * freq);
    float cv = floorf(v * freq);
    float hh = hash21(cu, cv);
    float star = hh < thrs[s] ? 1.0f : 0.0f;
    float fu = u * freq - cu - 0.5f;
    float fv = v * freq - cv - 0.5f;
    float spot = expf(-(fu * fu + fv * fv) * 40.0f);
    float temp = 3000.0f + 12000.0f * hash21(cu + 7.0f, cv + 13.0f);
    float color[3];
    blackbody_ramp(temp, color);
    float h_mag = hash21(cu + 31.0f, cv + 5.0f);
    float w = star * spot * (h_mag * h_mag * h_mag);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = out[c] + w * color[c];
  }
  float nebula = fbm2(u * 3.0f, v * 3.0f, 4);
  float neb2 = nebula * nebula;
  float neb[3] = {F(0.35) * neb2, F(0.2) * neb2,
                  0.5f * nebula * sqrtf(nebula)};
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = st.star_brightness * out[c] + st.star_nebula * neb[c];
}

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
    float cheb_raw = clenshaw(P + P_ETA, CHEB_K, t_dom);
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

  // --- composite ---
  const bool escaped = hit == HIT_ESCAPE;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float trans = 1.0f;
  if (st.disk_on) {
    UNROLL_SLOTS
    for (int k = 0; k < KMAX; ++k) {
      // Slots past the crossing count add nothing (the plain version
      // evaluates and masks them).
      if (k < K && k < nc) {
        float c_rgb[3], c_alpha;
        bool valid;
        disk_slot(st, P, m, a, r_in, cr[k], cp[k], ct[k], pph, k == 0 ? 3 : 1,
                  c_rgb, &c_alpha, &valid);
        bool on = valid;
        float wgt = on ? trans * c_alpha : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + wgt * c_rgb[c];
        trans = on ? trans * (1.0f - c_alpha) : trans;
      }
    }
  }
  // The plain version adds 0 * (the starfield of a fixed finite dummy state)
  // to captured rays; skipping them here gives the same values.
  if (st.starfield && escaped) {
    float dir[3];
    escape_direction(m, a, s[1], s[2], s[3], s[4], s[5], pph, dir);
    float bg[3];
    starfield(st, dir[0], dir[1], dir[2], bg);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + trans * bg[c];
  }
  if (MARCH == 2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + jet[c];
  }
  if (st.glow) {
    float near = expf(-14.0f * rmin / jmax(r_ph, F(1e-3)));
    float glow = escaped ? F(0.6) * near : 0.0f;
    float order = (float)min(max(nc, 0), 3) / 3.0f;
    const float warm[3] = {1.0f, F(0.82), F(0.55)};
    const float dwk[3] = {F(0.82 - 1.0), F(0.88 - 0.82), F(1.0 - 0.55)};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = rgb[c] + glow * (warm[c] + order * dwk[c]);
  }
  // The NRS background of the far rays: the surrogate's deflection of the
  // birth direction (born from the possibly offset u and phi but the
  // camera's r, as in the JAX kernel), Rodrigues-rotated about the orbital
  // plane's normal, then the starfield. Computed for far pixels only; the
  // plain version computes it everywhere and selects.
  if (EXTRAS && st.nrs_on && st.starfield && far) {
    const float r0 = __ldg(P + P_R0), s0 = __ldg(P + P_S0),
                u0 = __ldg(P + P_U0);
    float v[3];
    escape_direction(m, a, r0, u, ph, pr, pu, pph, v);
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
    starfield(st, v[0] * ca + cxr * sa, v[1] * ca + cyr * sa,
              v[2] * ca + czr * sa, rgb);
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
