// The staged composite and its VJP for Hopper (sm_90a): one thread a ray,
// the disk's crossings front to back (analytic or Chebyshev spectral), the
// starfield behind escaped rays, the jets' rows and the photon-ring glow,
// of u-chart MarchRows; and, for its backward, the cotangents of every
// per-ray row and fixed-order partial sums of the 0-d inputs' cotangents,
// reduced by a second pass.
//
// Replaces no TPU kernel: the JAX package's staged composite
// (blackhole_simulation_tpu/render/pipeline.py::shade_march_rows) is plain
// jnp, and so is the port's plain version, render/pipeline.py::_composite.
// Added because on the card that plain version, with its autograd
// backward, is ~7,400 elementwise launches of an inverse step and most of
// its device time. The wrapper is ops/composite.py (composite_kernel,
// composite_vjp_kernel, CompositeFn), launched from
// render/pipeline.py::shade_march_rows for CUDA rows; its plain twin of the
// derivative chain is ops/composite.py::composite_vjp_plain. Built by
// ops/build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3, nvcc's
// default --fmad=true: csrc/shade.cuh says why), one library for each
// instantiation: -DBH_F64, -DBH_DISK (0 none, 1 analytic, 2 Chebyshev),
// -DBH_STAR, -DBH_GLOW and -DKMAX select the templates' arguments, so an
// instantiation has no branch of a feature it lacks and a call builds only
// what it runs.
//
// What bounds it on the H100: the forward reads a ray's rows once (K
// crossings of 3 values, 7 state values, lam, r_min_ph, hit, n_crossings,
// 3 jet values) and writes 3 values: 23 + 3K values a ray, 2,073,600 rays
// at K = 4 about 290 MB in float32, 87 us at 3.35 TB/s. Its operations
// (the hashes, the ramp's logs and pows, sqrt and sin/cos by way of
// double, none contracted) are what it waits on; the VJP's more so: each
// disk slot is recomputed forward with 9 tangents, the starfield with 3,
// the escape direction with 9. Design for the card:
// * One thread a ray, 128 threads a block; the rows are structure of
//   arrays, (K, N) and (8, N), so a warp's loads are coalesced. A slot at
//   or past the ray's crossing count is skipped (its contribution is an
//   exact zero), as is the sky of a captured ray.
// * The VJP recomputes the forward in registers and saves nothing to
//   device memory: a first pass keeps each slot's alpha and the
//   transmittance before it (KMAX values each); the glow, the starfield and
//   the escape direction are differentiated; then the slots back to front,
//   each recomputed with its tangents. Autograd's graph of the plain
//   composite, which holds every intermediate row, is gone.
// * The 0-d cotangents (mass, spin, ISCO, photon sphere, the density and
//   intensity scales) are summed a block at a time in float64 in a fixed
//   tree, and the blocks' partial sums by one block in a fixed order: no
//   atomics, so two backward calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade.cuh"

using namespace shade;

#ifndef KMAX
#define KMAX 4
#endif
#ifndef BH_F64
#define BH_F64 0
#endif
#ifndef BH_DISK
#define BH_DISK 1
#endif
#ifndef BH_STAR
#define BH_STAR 1
#endif
#ifndef BH_GLOW
#define BH_GLOW 1
#endif

constexpr int THREADS = 128;
constexpr int REDUCE_THREADS = 256;
constexpr int N_SCALARS = 6;   // m, a, r_in, r_ph, density, intensity
constexpr int HIT_ESCAPE = 2;  // render/march.py::HIT_ESCAPE

// ops/composite.py::_CArgs.
struct CompositeArgs {
  long long n;      // rays
  int k;            // crossing slots, 1..KMAX
  int jets;         // add the jets' rows
  int ds_tensor;    // the density scale is a 0-d tensor (else in disk.dens)
  int is_tensor;    // the intensity scale is a 0-d tensor (else int_scale)
  double int_scale;
  DiskArgsT<double> disk;
  StarArgsT<double> stars;
  float t_coeffs[CHEB_K], rgb_coeffs[3 * CHEB_K], inv_logr;   // DISK 2
};

// The device pointers of a launch.
template <typename T> struct Rows {
  const T *m, *a, *r_in, *r_ph, *ds, *is;   // 0-d (ds / is may be null)
  const int *hit, *n_cross;
  const T *cross_r, *cross_phi, *cross_t, *r_min_ph, *lam, *state, *jets;
};

template <typename T> struct Grads {
  const T* g;                                  // (3, N) output cotangent
  T *cross_r, *cross_phi, *cross_t, *state, *r_min_ph, *lam;   // or null
  double* partials;                            // (blocks, N_SCALARS)
};

template <typename T> BH_D void state_rows(const Rows<T>& R, long long i,
                                           long long n, T (&out)[7]) {
#pragma unroll
  for (int j = 0; j < 7; ++j) out[j] = R.state[(j + 1) * n + i];
}

template <typename T, int DISK, bool STAR, bool GLOW>
__global__ void __launch_bounds__(THREADS)
composite_forward(CompositeArgs A, Rows<T> R, T* out) {
  const long long n = A.n;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  using N0 = Dual<T, 0>;
  const N0 m = val(R.m[0]), a = val(R.a[0]);
  const bool escaped = R.hit[i] == HIT_ESCAPE;
  const int nc = R.n_cross[i];
  N0 rgb[3] = {val(T(0)), val(T(0)), val(T(0))};
  N0 trans = val(op_add(T(0), T(1)));
  if constexpr (DISK != 0) {
    const DiskArgsT<double>& k = A.disk;
    const ChebTables tab = {A.t_coeffs, A.rgb_coeffs, &A.inv_logr};
    const N0 r_in = val(R.r_in[0]);
    const N0 dens = A.ds_tensor ? k.dens * val(R.ds[0]) : K<T>(k.dens);
    const N0 isc = A.is_tensor ? val(R.is[0]) : K<T>(A.int_scale);
    const N0 lam = val(R.lam[i]);
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s >= A.k || s >= nc) break;
      const Slot<T, 0> sl = disk_slot(
          DISK == 2, k, tab, m, a, r_in, val(R.cross_r[s * n + i]),
          val(R.cross_phi[s * n + i]), val(R.cross_t[s * n + i]), lam,
          s == 0 ? 3 : 1, dens, isc);
      if (!sl.valid) continue;
      const N0 w = trans * sl.alpha;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + w * sl.c[c];
      trans = trans * (1.0 - sl.alpha);
    }
  }
  if constexpr (STAR) {
    if (escaped) {
      T sv[7];
      state_rows(R, i, n, sv);
      N0 rows[7], dir[3];
#pragma unroll
      for (int j = 0; j < 7; ++j) rows[j] = val(sv[j]);
      escape_direction_u(rows, m, a, dir);
      const Rgb<T, 0> bg = starfield(dir[0], dir[1], dir[2], A.stars);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + trans * bg.c[c];
    }
  }
  if (A.jets) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + val(R.jets[c * n + i]);
  }
  if constexpr (GLOW) {
    if (escaped) {
      const N0 glow = glow_of(val(R.r_min_ph[i]), val(R.r_ph[0]));
      const T order = glow_order<T>(nc);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rgb[c] = rgb[c] + glow * val(glow_weight(c, order));
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * n + i] = rgb[c].v;
}

// Block-sum of each thread's N_SCALARS values in float64, in a fixed tree;
// thread 0 writes the block's partials.
BH_D void block_partials(const double (&v)[N_SCALARS], double* partials) {
  __shared__ double sh[N_SCALARS][THREADS];
#pragma unroll
  for (int j = 0; j < N_SCALARS; ++j) sh[j][threadIdx.x] = v[j];
  __syncthreads();
  for (int step = THREADS / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) {
#pragma unroll
      for (int j = 0; j < N_SCALARS; ++j)
        sh[j][threadIdx.x] =
            __dadd_rn(sh[j][threadIdx.x], sh[j][threadIdx.x + step]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N_SCALARS; ++j)
      partials[(long long)blockIdx.x * N_SCALARS + j] = sh[j][0];
  }
}

template <typename T, int DISK, bool STAR, bool GLOW>
__global__ void __launch_bounds__(THREADS)
composite_vjp(CompositeArgs A, Rows<T> R, Grads<T> G) {
  const long long n = A.n;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  double sums[N_SCALARS] = {0, 0, 0, 0, 0, 0};
  if (i < n) {
    using N0 = Dual<T, 0>;
    const T m0 = R.m[0], a0 = R.a[0];
    const bool escaped = R.hit[i] == HIT_ESCAPE;
    const int nc = R.n_cross[i];
    const int filled = nc < A.k ? (nc < 0 ? 0 : nc) : A.k;
    const T g[3] = {G.g[i], G.g[n + i], G.g[2 * n + i]};
    T g_m = T(0), g_a = T(0), g_rin = T(0), g_rph = T(0), g_ds = T(0),
      g_is = T(0), g_lam = T(0), g_rmin = T(0);

    // The forward's values: each slot's alpha and the transmittance
    // before it, and whether it composites.
    T alpha[KMAX], trans_k[KMAX];
    bool on[KMAX];
    T trans = op_add(T(0), T(1));
    const DiskArgsT<double>& k = A.disk;
    const ChebTables tab = {A.t_coeffs, A.rgb_coeffs, &A.inv_logr};
    if constexpr (DISK != 0) {
      const N0 r_in = val(R.r_in[0]);
      const N0 dens = A.ds_tensor ? k.dens * val(R.ds[0]) : K<T>(k.dens);
      const N0 isc = A.is_tensor ? val(R.is[0]) : K<T>(A.int_scale);
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        on[s] = false;
        trans_k[s] = trans;
        if (s >= filled) continue;
        const Slot<T, 0> sl = disk_slot(
            DISK == 2, k, tab, val(m0), val(a0), r_in,
            val(R.cross_r[s * n + i]), val(R.cross_phi[s * n + i]),
            val(R.cross_t[s * n + i]), val(R.lam[i]), s == 0 ? 3 : 1, dens,
            isc);
        if (!sl.valid) continue;
        on[s] = true;
        alpha[s] = sl.alpha.v;
        trans = op_mul(trans, op_sub(T(1), sl.alpha.v));
      }
    }

    // The glow, along (r_min_ph, r_ph).
    if constexpr (GLOW) {
      if (escaped) {
        const Dual<T, 2> glow = glow_of(seed<T, 2>(R.r_min_ph[i], 0),
                                        seed<T, 2>(R.r_ph[0], 1));
        const T order = glow_order<T>(nc);
        T g_glow = op_mul(g[0], glow_weight(0, order));
        g_glow = op_add(g_glow, op_mul(g[1], glow_weight(1, order)));
        g_glow = op_add(g_glow, op_mul(g[2], glow_weight(2, order)));
        g_rmin = op_mul(g_glow, glow.d[0]);
        g_rph = op_mul(g_glow, glow.d[1]);
      }
    }

    // The starfield: along its direction, then the direction along the
    // state rows and (m, a).
    T g_trans = T(0);
    T g_state[7] = {0, 0, 0, 0, 0, 0, 0};
    if constexpr (STAR) {
      if (escaped) {
        T sv[7];
        state_rows(R, i, n, sv);
        N0 rows0[7], dir0[3];
#pragma unroll
        for (int j = 0; j < 7; ++j) rows0[j] = val(sv[j]);
        escape_direction_u(rows0, val(m0), val(a0), dir0);
        const Rgb<T, 3> bg =
            starfield(seed<T, 3>(dir0[0].v, 0), seed<T, 3>(dir0[1].v, 1),
                      seed<T, 3>(dir0[2].v, 2), A.stars);
        const T g_bg[3] = {op_mul(g[0], trans), op_mul(g[1], trans),
                           op_mul(g[2], trans)};
        g_trans = op_add(op_add(op_mul(g[0], bg.c[0].v), op_mul(g[1], bg.c[1].v)),
                         op_mul(g[2], bg.c[2].v));
        T g_dir[3];
        contract(g_bg, bg.c, g_dir);
        Dual<T, 9> rows9[7], dir9[3];
#pragma unroll
        for (int j = 0; j < 7; ++j) rows9[j] = seed<T, 9>(sv[j], j);
        escape_direction_u(rows9, seed<T, 9>(m0, 7), seed<T, 9>(a0, 8), dir9);
        T d[9];
        contract(g_dir, dir9, d);
#pragma unroll
        for (int j = 0; j < 7; ++j) g_state[j] = d[j];
        g_m = op_add(g_m, d[7]);
        g_a = op_add(g_a, d[8]);
      }
    }

    // The slots back to front, each along (r, phi, t, lam, m, a, r_in,
    // density scale, intensity scale).
    if constexpr (DISK != 0) {
      const Dual<T, 9> m9 = seed<T, 9>(m0, 4), a9 = seed<T, 9>(a0, 5);
      const Dual<T, 9> r_in9 = seed<T, 9>(R.r_in[0], 6);
      const Dual<T, 9> dens9 = A.ds_tensor ? k.dens * seed<T, 9>(R.ds[0], 7)
                                           : lift<T, 9>(T(k.dens));
      const Dual<T, 9> is9 = A.is_tensor ? seed<T, 9>(R.is[0], 8)
                                         : lift<T, 9>(T(A.int_scale));
      const Dual<T, 9> lam9 = seed<T, 9>(R.lam[i], 3);
#pragma unroll
      for (int s = KMAX - 1; s >= 0; --s) {
        if (s >= A.k) continue;
        T d[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        if (on[s]) {
          const T tr = trans_k[s], al = alpha[s];
          const Slot<T, 9> sl = disk_slot(
              DISK == 2, k, tab, m9, a9, r_in9,
              seed<T, 9>(R.cross_r[s * n + i], 0),
              seed<T, 9>(R.cross_phi[s * n + i], 1),
              seed<T, 9>(R.cross_t[s * n + i], 2), lam9, s == 0 ? 3 : 1,
              dens9, is9);
          const T w = op_mul(tr, al);
          const T g_w = op_add(op_add(op_mul(g[0], sl.c[0].v),
                                      op_mul(g[1], sl.c[1].v)),
                               op_mul(g[2], sl.c[2].v));
          const T g_out[4] = {op_mul(g[0], w), op_mul(g[1], w),
                              op_mul(g[2], w),
                              op_sub(op_mul(g_w, tr), op_mul(g_trans, tr))};
          const Dual<T, 9> outs[4] = {sl.c[0], sl.c[1], sl.c[2], sl.alpha};
          contract(g_out, outs, d);
          g_trans = op_add(op_mul(g_w, al),
                           op_mul(g_trans, op_sub(T(1), al)));
          g_lam = op_add(g_lam, d[3]);
          g_m = op_add(g_m, d[4]);
          g_a = op_add(g_a, d[5]);
          g_rin = op_add(g_rin, d[6]);
          g_ds = op_add(g_ds, d[7]);
          g_is = op_add(g_is, d[8]);
        }
        if (G.cross_r) G.cross_r[s * n + i] = d[0];
        if (G.cross_phi) G.cross_phi[s * n + i] = d[1];
        if (G.cross_t) G.cross_t[s * n + i] = d[2];
      }
    } else {
      for (int s = 0; s < A.k; ++s) {
        if (G.cross_r) G.cross_r[s * n + i] = T(0);
        if (G.cross_phi) G.cross_phi[s * n + i] = T(0);
        if (G.cross_t) G.cross_t[s * n + i] = T(0);
      }
    }
    if (G.state) {
      G.state[i] = T(0);
#pragma unroll
      for (int j = 0; j < 7; ++j) G.state[(j + 1) * n + i] = g_state[j];
    }
    if (G.r_min_ph) G.r_min_ph[i] = g_rmin;
    if (G.lam) G.lam[i] = g_lam;
    sums[0] = double(g_m);
    sums[1] = double(g_a);
    sums[2] = double(g_rin);
    sums[3] = double(g_rph);
    sums[4] = double(g_ds);
    sums[5] = double(g_is);
  }
  block_partials(sums, G.partials);
}

// The blocks' partial sums of each 0-d cotangent, in a fixed order, by one
// block; rounded once to T.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const double* partials, long long blocks, T* out) {
  __shared__ double sh[N_SCALARS][REDUCE_THREADS];
  double acc[N_SCALARS] = {0, 0, 0, 0, 0, 0};
  for (long long b = threadIdx.x; b < blocks; b += REDUCE_THREADS) {
#pragma unroll
    for (int j = 0; j < N_SCALARS; ++j)
      acc[j] = __dadd_rn(acc[j], partials[b * N_SCALARS + j]);
  }
#pragma unroll
  for (int j = 0; j < N_SCALARS; ++j) sh[j][threadIdx.x] = acc[j];
  __syncthreads();
  for (int step = REDUCE_THREADS / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) {
#pragma unroll
      for (int j = 0; j < N_SCALARS; ++j)
        sh[j][threadIdx.x] =
            __dadd_rn(sh[j][threadIdx.x], sh[j][threadIdx.x + step]);
    }
    __syncthreads();
  }
  if (threadIdx.x < N_SCALARS) out[threadIdx.x] = T(sh[threadIdx.x][0]);
}

#if BH_F64
using Real = double;
#else
using Real = float;
#endif

static long long blocks_of(long long n) { return (n + THREADS - 1) / THREADS; }

static Rows<Real> rows_of(void* const* p) {
  Rows<Real> R;
  R.m = (const Real*)p[0];
  R.a = (const Real*)p[1];
  R.r_in = (const Real*)p[2];
  R.r_ph = (const Real*)p[3];
  R.ds = (const Real*)p[4];
  R.is = (const Real*)p[5];
  R.hit = (const int*)p[6];
  R.cross_r = (const Real*)p[7];
  R.cross_phi = (const Real*)p[8];
  R.cross_t = (const Real*)p[9];
  R.n_cross = (const int*)p[10];
  R.r_min_ph = (const Real*)p[11];
  R.lam = (const Real*)p[12];
  R.state = (const Real*)p[13];
  R.jets = (const Real*)p[14];
  return R;
}

static int check(const CompositeArgs* A) {
  if (A->n < 1 || A->k < 1 || A->k > KMAX) return (int)cudaErrorInvalidValue;
  if (blocks_of(A->n) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// The composite of the rows into the contiguous (3, N) ``out`` on
// ``stream``. Pointers, in order: m, a, r_in, r_ph, density scale,
// intensity scale (0-d; r_in null without a disk, r_ph without the glow,
// the scales null where they are numbers), hit, cross_r, cross_phi,
// cross_t (K, N), n_crossings, r_min_ph, lam (N), state (8, N), jets (3,
// N; null without jets). Returns a CUDA error code: cudaErrorInvalidValue
// for no rays or K outside 1..KMAX, else cudaGetLastError() after the
// launch.
int bh_composite_forward(const CompositeArgs* A, void* m, void* a, void* r_in,
                         void* r_ph, void* ds, void* is, void* hit,
                         void* cross_r, void* cross_phi, void* cross_t,
                         void* n_cross, void* r_min_ph, void* lam, void* state,
                         void* jets, void* out, void* stream) {
  if (int err = check(A)) return err;
  void* const p[] = {m, a, r_in, r_ph, ds, is, hit, cross_r, cross_phi,
                     cross_t, n_cross, r_min_ph, lam, state, jets};
  CompositeArgs args = *A;
  Rows<Real> rows = rows_of(p);
  Real* o = (Real*)out;
  void* kargs[] = {&args, &rows, &o};
  const cudaError_t err = cudaLaunchKernel(
      composite_forward<Real, BH_DISK, (bool)BH_STAR, (bool)BH_GLOW>,
      dim3((unsigned)blocks_of(A->n)), dim3(THREADS), kargs, 0,
      (cudaStream_t)stream);
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}

// The VJP: the per-ray cotangents into the contiguous outputs that are not
// null (cross_r, cross_phi, cross_t (K, N), state (8, N; its time row 0),
// r_min_ph, lam (N)) for the (3, N) output cotangent ``g``; the 0-d
// cotangents {m, a, r_in, r_ph, density, intensity} into ``scalars`` (6
// values of the rows' dtype) through ``partials`` (bh_composite_blocks(n)
// x 6 doubles of scratch). The rows' pointers as bh_composite_forward's.
// Two launches; returns a CUDA error code.
int bh_composite_vjp(const CompositeArgs* A, void* m, void* a, void* r_in,
                     void* r_ph, void* ds, void* is, void* hit, void* cross_r,
                     void* cross_phi, void* cross_t, void* n_cross,
                     void* r_min_ph, void* lam, void* state, void* g,
                     void* g_cross_r, void* g_cross_phi, void* g_cross_t,
                     void* g_state, void* g_r_min_ph, void* g_lam,
                     void* partials, void* scalars, void* stream) {
  if (int err = check(A)) return err;
  void* const p[] = {m, a, r_in, r_ph, ds, is, hit, cross_r, cross_phi,
                     cross_t, n_cross, r_min_ph, lam, state, nullptr};
  Grads<Real> G;
  G.g = (const Real*)g;
  G.cross_r = (Real*)g_cross_r;
  G.cross_phi = (Real*)g_cross_phi;
  G.cross_t = (Real*)g_cross_t;
  G.state = (Real*)g_state;
  G.r_min_ph = (Real*)g_r_min_ph;
  G.lam = (Real*)g_lam;
  G.partials = (double*)partials;
  const long long blocks = blocks_of(A->n);
  const cudaStream_t s = (cudaStream_t)stream;
  CompositeArgs args = *A;
  Rows<Real> rows = rows_of(p);
  void* kargs[] = {&args, &rows, &G};
  cudaError_t err = cudaLaunchKernel(
      composite_vjp<Real, BH_DISK, (bool)BH_STAR, (bool)BH_GLOW>,
      dim3((unsigned)blocks), dim3(THREADS), kargs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const double* part = (const double*)partials;
  long long nb = blocks;
  Real* sc = (Real*)scalars;
  void* rargs[] = {&part, &nb, &sc};
  err = cudaLaunchKernel(reduce_partials<Real>, dim3(1), dim3(REDUCE_THREADS),
                         rargs, 0, s);
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}

long long bh_composite_blocks(long long n) { return blocks_of(n); }

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_composite_args_size() { return (int)sizeof(CompositeArgs); }

}  // extern "C"
