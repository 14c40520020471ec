// Ray birth and its VJP for Hopper (sm_90a): the camera's KS-lowered ZAMO
// tetrad, then one thread a ray for the u-chart rows (t, r, u, phi, p_t,
// p_r, p_u, p_phi) of the whole frame or of pixel ids; and, for its
// backward, fixed-order partial sums of the camera's scalars' cotangents,
// reduced by a second pass that takes the tetrad back to mass, spin, r and
// theta.
//
// Replaces no TPU kernel: the JAX package's ray birth
// (blackhole_simulation_tpu/render/camera.py::camera_rays_u) is plain jnp,
// and so is the port's plain version, render/camera.py::camera_rays_u.
// Added because on the card that plain version is ~400 launches forward and
// ~600 under autograd, most of them 0-d work on the tetrad, each costing the
// host as much as a kernel over every ray, and five blocking copies of the
// camera's numbers: in the inverse step, the host's launch train set the
// pace. The wrapper is ops/birth.py (birth_kernel, birth_vjp_kernel,
// BirthFn), launched from render/camera.py::camera_rays_u for rays on a CUDA
// device; its plain twin of the derivative chain is
// ops/birth.py::birth_vjp_plain. Built by ops/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3, nvcc's default --fmad=true: every
// operation here is explicit, csrc/shade.cuh says why), one library with
// the four instantiations of (rays' dtype, tetrad's dtype).
//
// Rounding: the forward is the plain chain's, bit for bit. The tetrad in
// the dtype of the tensors among mass, spin and theta (camera_scalars), sin,
// cos and sqrt by way of double rounded once (_elementwise), the clamps
// torch.clamp's; the scalars cast to the rays' dtype; each ray's arithmetic
// in the plain version's order, a number over a tensor as PyTorch's
// reciprocal times the number. The fov's and roll's functions and the
// aspect ratio come as launch arguments (host values, as the plain version
// computes them), so no number is copied to the card.
//
// What bounds it on the H100: the forward reads a ray's id (8 B) and writes
// its 8 rows (32 B in float32): 83 MB at 1080p, 25 us at 3.35 TB/s, against
// ~40 operations a ray; the VJP reads the 6 cotangent rows that depend on
// the inputs. Design for the card:
// * A block's thread 0 forms the camera's scalars in shared memory (the
//   tetrad's ~150 operations and its double sin and cos), once a block; the
//   grid is at most MAX_BLOCKS blocks, each walking the rays in strides of
//   the grid, neighbouring threads on neighbouring rays, so the rows' stores
//   are coalesced and the prologue is paid ~1,000 times, not once a ray.
// * The VJP recomputes each ray's forward in registers, sweeps it back to
//   the cotangents of the 20 camera scalars, the constant rows (r, u0, phi)
//   and s0, and sums them in float64: per thread, then per warp and block in
//   a fixed tree. One block then reduces the blocks' partials in a fixed
//   order (no atomics: two calls give the same bits) and takes the tetrad
//   back to (m, a, r, theta) by forward duals (csrc/shade.cuh's Dual),
//   theta's rows u0 and s0 back to theta in theirs, with autograd's rule at
//   the clamps: the tangent passes where x >= the bound, a tie included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade.cuh"

using namespace shade;

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1056;   // 8 a streaming multiprocessor
constexpr int REDUCE_THREADS = 128;
// The VJP's sums: c0[4], c_r[4], c_th[4], c_ph[4], k1, k2, roll_c, roll_s,
// s0, and the rows r, u0, phi.
constexpr int N_SUMS = 24;
enum { S_K1 = 16, S_K2, S_RC, S_RS, S_S0, S_R, S_U0, S_PHI };
// The gradients: m, a, theta, r, phi, half, roll_c, roll_s.
constexpr int N_GRADS = 8;

// ops/birth.py::_BArgs.
struct BirthArgs {
  long long n;          // rays
  int width, height;
  int ids;              // 0: the whole frame, 1: int32 ids, 2: int64 ids
  int t64, c64;         // the rays' and the tetrad's dtype are double
  int th64;             // u0 and s0 in double (else in float)
  int f64;              // bits: m, a, theta, r, phi's tensor is double
  int grad64;           // bits: each gradient's tensor is double
  double jx, jy;        // the jitter (0 without), rounded to the rays' dtype
  double half, roll_c, roll_s, aspect;   // host values, rounded at use
  double m, a, th, r, phi;               // the fields that are numbers
};

// The device pointers: the 0-d tensors of mass, spin, theta (the override
// or the camera's), r and phi (null where the field is a number) and the
// ids.
struct Inputs { const void *m, *a, *th, *r, *phi, *ids; };
struct Grads { void* p[N_GRADS]; };

// The camera's scalars in the rays' dtype.
template <typename T> struct Cam {
  T c[4][4];            // c0, c_r, c_th, c_ph
  T k1, k2, rc, rs;
  T r, u0, phi, s0;
};

BH_D double scalar(const void* p, int f64, int bit, double number) {
  if (!p) return number;
  return (f64 >> bit) & 1 ? *(const double*)p : double(*(const float*)p);
}

// torch.clamp(x, min=lo): NaN stays; autograd passes the tangent where
// x >= lo.
template <typename T, int D>
BH_D Dual<T, D> clamp_min_(const Dual<T, D>& x, double lo) {
  const T l = T(lo);
  Dual<T, D> r;
  r.v = vmax(x.v, l);
  if constexpr (D > 0) {
    const bool pass = x.v >= l;
#pragma unroll
    for (int i = 0; i < D; ++i) r.d[i] = pass ? x.d[i] : T(0);
  }
  return r;
}

// render/camera.py::_zamo_tetrad_t, then _lower_to_ks of each leg:
// coef[leg][j], legs (u, e_r, e_th, e_ph).
template <typename C, int D>
BH_D void tetrad(const Dual<C, D>& m, const Dual<C, D>& a,
                 const Dual<C, D>& r, const Dual<C, D>& th,
                 Dual<C, D> (&coef)[4][4]) {
  using X = Dual<C, D>;
  const X s = sin_(th);
  const X s2c = clamp_min_(s * s, 1e-12);
  const X c = cos_(th);
  const X sig = r * r + a * a * c * c;
  const X delta = r * r - 2.0 * m * r + a * a;
  const X r2a2 = r * r + a * a;
  const X big_a = r2a2 * r2a2 - a * a * delta * s2c;
  const X alpha = sqrt_(clamp_min_(delta * sig / big_a, 1e-30));
  const X omega = 2.0 * m * a * r / big_a;
  const X zero = lift<C, D>(C(0));
  const X legs[4][4] = {
      {1.0 / alpha, zero, zero, omega / alpha},
      {zero, sqrt_(clamp_min_(delta / sig, 1e-30)), zero, zero},
      {zero, zero, 1.0 / sqrt_(sig), zero},
      {zero, zero, zero,
       sqrt_(clamp_min_(sig / big_a, 1e-30)) / sqrt_(s2c)}};
  const X s2 = s * s;
  const X two_mr = 2.0 * m * r;
  const X g_tt = -(1.0 - two_mr / sig);
  const X g_tph = -two_mr * a * s2 / sig;
  const X g_rr = sig / delta;
  const X g_phph = (r * r + a * a + two_mr * a * a * s2 / sig) * s2;
  const X shift_t = -(2.0 * m * r / delta), shift_ph = a / delta;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const X* v = legs[l];
    const X p0 = g_tt * v[0] + g_tph * v[3];
    const X p3 = g_tph * v[0] + g_phph * v[3];
    coef[l][0] = p0;
    coef[l][1] = g_rr * v[1] + (shift_t * p0 - shift_ph * p3);
    coef[l][2] = sig * v[2];
    coef[l][3] = p3;
  }
}

// camera_rays_u's u0 = cos(theta) and s0 = sqrt(max(1 - u0^2, 1e-12)), in
// theta's dtype U.
template <typename U, int D>
BH_D void theta_rows(const Dual<U, D>& th, Dual<U, D>& u0, Dual<U, D>& s0) {
  u0 = cos_(th);
  s0 = sqrt_(clamp_min_(1.0 - u0 * u0, 1e-12));
}

template <typename T, typename C>
BH_D Cam<T> camera(const BirthArgs& A, const Inputs& in) {
  using N0 = Dual<C, 0>;
  const double th = scalar(in.th, A.f64, 2, A.th);
  const double rv = scalar(in.r, A.f64, 3, A.r);
  Dual<C, 0> coef[4][4];
  tetrad(N0{C(scalar(in.m, A.f64, 0, A.m))}, N0{C(scalar(in.a, A.f64, 1, A.a))},
         N0{C(rv)}, N0{C(th)}, coef);
  Cam<T> k;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int j = 0; j < 4; ++j) k.c[l][j] = T(coef[l][j].v);
  }
  k.k2 = T(A.half);
  k.k1 = op_mul(k.k2, T(A.aspect));
  k.rc = T(A.roll_c);
  k.rs = T(A.roll_s);
  k.r = T(rv);
  k.phi = T(scalar(in.phi, A.f64, 4, A.phi));
  if (A.th64) {
    Dual<double, 0> u0, s0;
    theta_rows(Dual<double, 0>{th}, u0, s0);
    k.u0 = T(u0.v);
    k.s0 = T(s0.v);
  } else {
    Dual<float, 0> u0, s0;
    theta_rows(Dual<float, 0>{float(th)}, u0, s0);
    k.u0 = T(u0.v);
    k.s0 = T(s0.v);
  }
  return k;
}

// Python's floor division and remainder of an id by the width.
BH_D long long floor_div(long long x, long long w) {
  const long long q = x / w;
  return (x % w != 0 && (x < 0) != (w < 0)) ? q - 1 : q;
}

// The NDC coordinates of ray i: _ndc_of_ids, or pixel_grid's.
template <typename T>
BH_D void ndc(const BirthArgs& A, const void* ids, long long i, T& nx, T& ny) {
  const T w = T(A.width), h = T(A.height), half = T(0.5), two = T(2);
  if (A.ids) {
    const long long id =
        A.ids == 2 ? ((const long long*)ids)[i] : ((const int*)ids)[i];
    const long long iy = floor_div(id, A.width);
    const T ix = T(id - iy * A.width), fy = T(iy);
    const T x = op_div(op_add(op_add(ix, half), T(A.jx)), w);
    const T y = op_div(op_add(op_add(fy, half), T(A.jy)), h);
    nx = op_sub(op_mul(x, two), T(1));
    ny = op_sub(T(1), op_mul(y, two));
  } else {
    const long long iy = i / A.width;
    T xs = op_div(op_add(T(i - iy * A.width), half), w);
    T ys = op_div(op_add(T(iy), half), h);
    // pixel_grid's jitter; a zero one adds an exact 0
    xs = op_add(xs, op_div(T(A.jx), w));
    ys = op_add(ys, op_div(T(A.jy), h));
    nx = op_sub(op_mul(xs, two), T(1));
    ny = op_sub(T(1), op_mul(ys, two));
  }
}

// One ray's forward: _momenta_from_ndc, then camera_rays_u's normalization.
template <typename T> struct Ray {
  T nx, ny, cx0, cy0, cx, cy, q, inv_norm, n_r, n_th, n_ph, p[4], rp, inv;
};

template <typename T>
BH_D Ray<T> ray(const Cam<T>& k, T nx, T ny) {
  Ray<T> y;
  y.nx = nx;
  y.ny = ny;
  y.cx0 = op_mul(nx, k.k1);
  y.cy0 = op_mul(ny, k.k2);
  y.cx = op_sub(op_mul(y.cx0, k.rc), op_mul(y.cy0, k.rs));
  y.cy = op_add(op_mul(y.cx0, k.rs), op_mul(y.cy0, k.rc));
  y.q = op_add(op_add(T(1), op_mul(y.cx, y.cx)), op_mul(y.cy, y.cy));
  y.inv_norm = op_mul(op_div(T(1), sqrt_rn(y.q)), T(1));
  y.n_r = -y.inv_norm;
  y.n_th = op_mul(-y.cy, y.inv_norm);
  y.n_ph = op_mul(-y.cx, y.inv_norm);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y.p[j] = op_add(op_add(op_add(k.c[0][j], op_mul(y.n_r, k.c[1][j])),
                           op_mul(y.n_th, k.c[2][j])),
                    op_mul(y.n_ph, k.c[3][j]));
  y.rp = op_div(T(1), -y.p[0]);
  y.inv = op_mul(y.rp, T(1));
  return y;
}

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
birth_forward(BirthArgs A, Inputs in, T* out) {
  __shared__ Cam<T> cam;
  if (threadIdx.x == 0) cam = camera<T, C>(A, in);
  __syncthreads();
  const Cam<T> k = cam;
  const long long n = A.n;
  const T zero = T(0);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    T nx, ny;
    ndc(A, in.ids, i, nx, ny);
    const Ray<T> y = ray(k, nx, ny);
    out[i] = zero;
    out[n + i] = op_add(zero, k.r);
    out[2 * n + i] = op_add(zero, k.u0);
    out[3 * n + i] = op_add(zero, k.phi);
    out[4 * n + i] = op_sub(zero, T(1));
    out[5 * n + i] = op_mul(y.p[1], y.inv);
    out[6 * n + i] = op_div(-op_mul(y.p[2], y.inv), k.s0);
    out[7 * n + i] = op_mul(y.p[3], y.inv);
  }
}

// One ray's reverse sweep into the sums, with autograd's local derivatives
// (a quotient's: grad / y and -grad * ((x / y) / y); a reciprocal's:
// -grad * r * r; sqrt's: grad * 0.5 / sqrt(x) formed in double).
template <typename T>
BH_D void ray_vjp(const Cam<T>& k, const Ray<T>& y, const T (&g)[8],
                  double (&acc)[N_SUMS]) {
  const T out6 = op_div(-op_mul(y.p[2], y.inv), k.s0);
  const T g_w = op_div(g[6], k.s0);
  const T g_s0 = -op_mul(g[6], op_div(out6, k.s0));
  const T g_t2 = -g_w;
  T gp[4];
  gp[1] = op_mul(g[5], y.inv);
  gp[2] = op_mul(g_t2, y.inv);
  gp[3] = op_mul(g[7], y.inv);
  const T g_inv = op_add(op_add(op_mul(g[5], y.p[1]), op_mul(g[7], y.p[3])),
                         op_mul(g_t2, y.p[2]));
  gp[0] = op_mul(g_inv, op_mul(y.rp, y.rp));   // -(-grad r r)
  T g_nr = T(0), g_nth = T(0), g_nph = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j] = __dadd_rn(acc[j], double(gp[j]));
    acc[4 + j] = __dadd_rn(acc[4 + j], double(op_mul(gp[j], y.n_r)));
    acc[8 + j] = __dadd_rn(acc[8 + j], double(op_mul(gp[j], y.n_th)));
    acc[12 + j] = __dadd_rn(acc[12 + j], double(op_mul(gp[j], y.n_ph)));
    g_nr = op_add(g_nr, op_mul(gp[j], k.c[1][j]));
    g_nth = op_add(g_nth, op_mul(gp[j], k.c[2][j]));
    g_nph = op_add(g_nph, op_mul(gp[j], k.c[3][j]));
  }
  const T g_invn = op_add(op_sub(op_mul(g_nth, -y.cy), g_nr),
                          op_mul(g_nph, -y.cx));
  T g_cy = -op_mul(g_nth, y.inv_norm);
  T g_cx = -op_mul(g_nph, y.inv_norm);
  const T rq = op_div(T(1), sqrt_rn(y.q));
  const T g_sq = -op_mul(g_invn, op_mul(rq, rq));
  const T g_q = op_mul(g_sq, T(__ddiv_rn(0.5, __dsqrt_rn(double(y.q)))));
  g_cx = op_add(g_cx, op_add(op_mul(g_q, y.cx), op_mul(g_q, y.cx)));
  g_cy = op_add(g_cy, op_add(op_mul(g_q, y.cy), op_mul(g_q, y.cy)));
  const T g_cx0 = op_add(op_mul(g_cx, k.rc), op_mul(g_cy, k.rs));
  const T g_cy0 = op_sub(op_mul(g_cy, k.rc), op_mul(g_cx, k.rs));
  const T d[8] = {op_mul(g_cx0, y.nx), op_mul(g_cy0, y.ny),
                  op_add(op_mul(g_cx, y.cx0), op_mul(g_cy, y.cy0)),
                  op_sub(op_mul(g_cy, y.cx0), op_mul(g_cx, y.cy0)),
                  g_s0, g[1], g[2], g[3]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[S_K1 + j] = __dadd_rn(acc[S_K1 + j], double(d[j]));
}

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
birth_vjp(BirthArgs A, Inputs in, const T* g, double* partials) {
  __shared__ Cam<T> cam;
  __shared__ double sh[THREADS / 32][N_SUMS];
  if (threadIdx.x == 0) cam = camera<T, C>(A, in);
  __syncthreads();
  const Cam<T> k = cam;
  const long long n = A.n;
  double acc[N_SUMS];
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) acc[j] = 0.0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    T nx, ny;
    ndc(A, in.ids, i, nx, ny);
    const T gi[8] = {T(0), g[n + i], g[2 * n + i], g[3 * n + i], T(0),
                     g[5 * n + i], g[6 * n + i], g[7 * n + i]};
    ray_vjp(k, ray(k, nx, ny), gi, acc);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) {
    for (int off = 16; off > 0; off >>= 1)
      acc[j] = __dadd_rn(acc[j], __shfl_down_sync(0xffffffffu, acc[j], off));
    if (lane == 0) sh[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < N_SUMS) {
    double s = sh[0][threadIdx.x];
    for (int w = 1; w < THREADS / 32; ++w) s = __dadd_rn(s, sh[w][threadIdx.x]);
    partials[(long long)blockIdx.x * N_SUMS + threadIdx.x] = s;
  }
}

BH_D void put(const Grads& G, int grad64, int i, double v) {
  if (!G.p[i]) return;
  if ((grad64 >> i) & 1) *(double*)G.p[i] = v;
  else *(float*)G.p[i] = float(v);
}

// The blocks' partials in a fixed order, then the chain back to the
// camera's inputs by one thread. Each sum is rounded to the rays' dtype, as
// autograd's cotangent of a row's scalar is, then to the tetrad's.
template <typename T, typename C>
__global__ void __launch_bounds__(REDUCE_THREADS)
birth_reduce(BirthArgs A, Inputs in, const double* partials, long long blocks,
             Grads G) {
  __shared__ double sh[N_SUMS][REDUCE_THREADS];
  double acc[N_SUMS];
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) acc[j] = 0.0;
  for (long long b = threadIdx.x; b < blocks; b += REDUCE_THREADS) {
#pragma unroll
    for (int j = 0; j < N_SUMS; ++j)
      acc[j] = __dadd_rn(acc[j], partials[b * N_SUMS + j]);
  }
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) sh[j][threadIdx.x] = acc[j];
  __syncthreads();
  for (int step = REDUCE_THREADS / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) {
#pragma unroll
      for (int j = 0; j < N_SUMS; ++j)
        sh[j][threadIdx.x] =
            __dadd_rn(sh[j][threadIdx.x], sh[j][threadIdx.x + step]);
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  T s[N_SUMS];
#pragma unroll
  for (int j = 0; j < N_SUMS; ++j) s[j] = T(sh[j][0]);
  using X = Dual<C, 4>;
  const double th = scalar(in.th, A.f64, 2, A.th);
  const double rv = scalar(in.r, A.f64, 3, A.r);
  X coef[4][4];
  tetrad(seed<C, 4>(C(scalar(in.m, A.f64, 0, A.m)), 0),
         seed<C, 4>(C(scalar(in.a, A.f64, 1, A.a)), 1), seed<C, 4>(C(rv), 2),
         seed<C, 4>(C(th), 3), coef);
  C gt[4] = {C(0), C(0), C(0), C(0)};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const C gc = C(s[4 * l + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gt[i] = op_add(gt[i], op_mul(gc, coef[l][j].d[i]));
    }
  }
  double g_th;
  if (A.th64) {
    Dual<double, 1> u0, s0;
    theta_rows(seed<double, 1>(th, 0), u0, s0);
    g_th = op_add(op_mul(double(s[S_U0]), u0.d[0]),
                  op_mul(double(s[S_S0]), s0.d[0]));
  } else {
    Dual<float, 1> u0, s0;
    theta_rows(seed<float, 1>(float(th), 0), u0, s0);
    g_th = op_add(op_mul(float(s[S_U0]), u0.d[0]),
                  op_mul(float(s[S_S0]), s0.d[0]));
  }
  const int b = A.grad64;
  put(G, b, 0, double(gt[0]));
  put(G, b, 1, double(gt[1]));
  put(G, b, 2, __dadd_rn(double(gt[3]), g_th));
  put(G, b, 3, __dadd_rn(double(gt[2]), double(s[S_R])));
  put(G, b, 4, double(s[S_PHI]));
  put(G, b, 5, double(op_add(op_mul(s[S_K1], T(A.aspect)), s[S_K2])));
  put(G, b, 6, double(s[S_RC]));
  put(G, b, 7, double(s[S_RS]));
}

static long long blocks_of(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

static Inputs inputs_of(void* const* p) {
  return Inputs{p[0], p[1], p[2], p[3], p[4], p[5]};
}

template <typename T, typename C>
static cudaError_t launch_forward(BirthArgs A, Inputs in, void* out,
                                  cudaStream_t s) {
  T* o = (T*)out;
  void* kargs[] = {&A, &in, &o};
  return cudaLaunchKernel(birth_forward<T, C>, dim3((unsigned)blocks_of(A.n)),
                          dim3(THREADS), kargs, 0, s);
}

template <typename T, typename C>
static cudaError_t launch_vjp(BirthArgs A, Inputs in, const void* g,
                              double* partials, Grads G, cudaStream_t s) {
  const T* gt = (const T*)g;
  long long blocks = blocks_of(A.n);
  void* kargs[] = {&A, &in, &gt, &partials};
  cudaError_t err = cudaLaunchKernel(birth_vjp<T, C>, dim3((unsigned)blocks),
                                     dim3(THREADS), kargs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const double* part = partials;
  void* rargs[] = {&A, &in, &part, &blocks, &G};
  return cudaLaunchKernel(birth_reduce<T, C>, dim3(1), dim3(REDUCE_THREADS),
                          rargs, 0, s);
}

static int check(const BirthArgs* A) {
  if (A->n < 1 || A->width < 1 || A->height < 1 || A->ids < 0 || A->ids > 2)
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// The (8, N) rows into the contiguous ``out`` of the rays' dtype on
// ``stream``. Pointers, in order: mass, spin, theta, r, phi (0-d, of the
// dtype ``f64`` gives; null where a number), the ids (N; null for the whole
// frame). Returns a CUDA error code:
// cudaErrorInvalidValue for no rays or a frame of no pixels, else
// cudaGetLastError() after the launch.
int bh_birth_forward(const BirthArgs* A, void* m, void* a, void* th, void* r,
                     void* phi, void* ids, void* out, void* stream) {
  if (int err = check(A)) return err;
  void* const p[] = {m, a, th, r, phi, ids};
  const Inputs in = inputs_of(p);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (A->t64)
    err = A->c64 ? launch_forward<double, double>(*A, in, out, s)
                 : launch_forward<double, float>(*A, in, out, s);
  else
    err = A->c64 ? launch_forward<float, double>(*A, in, out, s)
                 : launch_forward<float, float>(*A, in, out, s);
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}

// The VJP of the (8, N) cotangent ``g`` (contiguous, the rays' dtype): the
// gradients of m, a, theta, r, phi, half (tan(fov / 2)), roll_c and roll_s
// into the 0-d tensors ``grads`` points to (null where not wanted; of the
// dtype ``grad64`` gives), through ``partials`` (bh_birth_blocks(n) x 24
// doubles of scratch). The inputs' pointers as bh_birth_forward's. Two
// launches; returns a CUDA error code.
int bh_birth_vjp(const BirthArgs* A, void* m, void* a, void* th, void* r,
                 void* phi, void* ids, void* g, void* partials,
                 void* const* grads, void* stream) {
  if (int err = check(A)) return err;
  void* const p[] = {m, a, th, r, phi, ids};
  const Inputs in = inputs_of(p);
  Grads G;
  for (int i = 0; i < N_GRADS; ++i) G.p[i] = grads[i];
  double* part = (double*)partials;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (A->t64)
    err = A->c64 ? launch_vjp<double, double>(*A, in, g, part, G, s)
                 : launch_vjp<double, float>(*A, in, g, part, G, s);
  else
    err = A->c64 ? launch_vjp<float, double>(*A, in, g, part, G, s)
                 : launch_vjp<float, float>(*A, in, g, part, G, s);
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}

long long bh_birth_blocks(long long n) { return blocks_of(n); }

int bh_birth_sums() { return N_SUMS; }

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_birth_args_size() { return (int)sizeof(BirthArgs); }

}  // extern "C"
