// Tone-map kernel for Hopper (sm_90a): exposure, bloom (bright pass,
// bloom_passes separable wrapping 9-tap Gaussian blurs, additive combine),
// ACES and gamma in one launch (a chain of launches past two bloom
// passes), on an (H, W, 3) image read through its
// strides, into a contiguous (H, W, 3) output. Every CUDA image that
// autograd does not differentiate takes it (render/post.py::tonemap), for
// any parameters that tonemap_plain takes.
//
// Replaces no TPU kernel: the JAX package's tone map
// (blackhole_simulation_tpu/render/post.py) is plain jnp, and so is the
// plain PyTorch version of this kernel, render/post.py::tonemap_plain.
// Added because that plain version is ~150 full-frame passes a call (the
// non-contiguous copy ahead of each torch.roll, the roll, a multiply and an
// add per tap), 3.84 ms of a 1080p frame on the H100 against ~15 us of
// least traffic. The wrapper is ops/tonemap.py::tonemap_kernel, launched
// from render/post.py::tonemap. Built by ops/build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 (nvcc's default --fmad=true, below) and
// loaded through ctypes.
//
// What bounds it on the H100: bytes (each pixel's three values read once
// and written once: 24 bytes a float pixel, 49.8 MB and 14.9 us for
// 1920x1080 at 3.35 TB/s); the counted operations bound it lower (208 a
// pixel, each add, multiply, divide, compare and pow one lane instruction,
// none contracted: 12.9 us at 33.5e12 a second). What holds it back is
// instructions: the blur's and the ACES/pow epilogue's exact
// operations, the halo's recomputation (a 32 x 32 tile blurs 5.7 outputs a
// pixel where 4 would do) and the phases a block runs in turn between its
// barriers. Edited copies timed on the 1080p frame (H100; PERF.md): without
// the blur a third less time, without ACES and pow a quarter less, the
// loads' addressing ~5%; a persistent, cp.async-pipelined
// form that loads the next tile under this one's blur was slower (the third
// buffer halved the resident warps).
//
// Design for the card:
// * One block of THREADS threads per Tile<T>::W x Tile<T>::H output tile.
//   It loads the bright pass of its tile and a halo of R = 4 x P pixels on
//   each side into shared memory, three planes of (H + 2R) rows of PITCH =
//   W + 2R + 1 values (odd, so a column walk is free of bank conflicts),
//   for the P <= FUSED_PASSES bloom passes of one launch. Blocks take the
//   tiles row-major from a one-dimensional grid. Halo indices wrap (y mod
//   H, x mod W) as torch.roll wraps, any number of times round a frame
//   smaller than the halo; a halo value is then the same function of the
//   same inputs as the value it stands for, so the blur needs no exchange
//   between blocks.
// * The 2P blur passes (axis 0, axis 1, axis 0, axis 1, the plain
//   version's order) run between two shared buffers; each pass shrinks the
//   window on its axis by 4 on each side, down to the tile. A thread
//   computes SEG consecutive outputs along the pass's axis from SEG + 8
//   values held in registers (~2 shared loads an output, not 9), and forms
//   each product once for the two taps that take it.
// * The epilogue takes each tile pixel's exposed value again from the
//   input (in L2 after the load phase), adds the bloom, runs ACES, the
//   clip and the gamma, and stages the tile in the second buffer so that
//   the stores are whole rows of 3 x W contiguous values.
// * More than FUSED_PASSES bloom passes would need a halo whose shared
//   memory outgrows the SM, so they run as a chain of one-pass launches
//   through two scratch images that the wrapper allocates: the bright pass
//   and its first blur, each further blur, and the last blur with the
//   epilogue. Each scratch value is the plain version's intermediate image
//   in the image's dtype, so the chain rounds as one launch does.
// * No allocation, no synchronisation with the host: the wrapper allocates
//   the output (and any scratch) with torch.empty and launches on
//   PyTorch's current stream.
//
// Rounding: the output is bit-identical to tonemap_plain on the card, NaNs
// included. Every product, sum, difference and quotient is one explicit
// IEEE operation (__fmul_rn and its kin: never contracted, whatever the
// build's flags), in the plain version's order and with its operands in
// the plain version's places: the luma (r L0 + g L1) + b L2; each blur
// output g4 x[i], then (out + g[4-k] x[i-k]) + g[4+k] x[i+k] for k = 1..4;
// ACES's (x (a x + b)) / (x (c x + d) + e). A sum a + b is fma(1, b, a)
// and a difference a - b is fma(-1, b, a), the form PyTorch's add kernel
// (self + alpha * other) compiles to: the same value, and where both terms
// are NaN the same one of them (float64 keeps NaN payloads). Each constant
// is the Python float rounded to the image's dtype, as a tensor times a
// Python number is on the card. maximum(v, 0) and clip(v, 0, 1) keep a NaN
// as torch.clamp does (isnan(v) ? v : min(max(v, lo), hi)). The gamma
// takes torch.pow's route for p = 1 / gamma (PowRoute, chosen by the
// wrapper): a fill or a copy for p = 0 or 1, sqrt, rsqrt or a reciprocal
// for p = 0.5, -0.5 or -1, products for p rounded to the dtype = 2, 3 or
// -2, else pow(v, p) with p rounded to the dtype. This source builds with
// nvcc's default --fmad=true (ops/build.py::FMAD_SOURCES), which moves
// none of the explicit operations above and lets the math library's pow
// and rsqrt contract as PyTorch's build of them does: at --fmad=false the
// float64 pow rounded 1 of 2,073,600 pixels of a 1080p frame one bit apart
// (H100).

#include <cuda_runtime.h>
#include <stdint.h>

// The block and each dtype's tile, from a census of launch shapes on the
// 1080p frame (H100, PERF.md): 512 threads and a 32 x 32 tile, 4 blocks
// (64 warps) an SM. The float64 tile halves the height for its shared
// memory (2 x 3 planes of 32 x 49 doubles).
constexpr int THREADS = 512;
template <typename T> struct Tile { static constexpr int W = 32, H = 32; };
template <> struct Tile<double> { static constexpr int W = 32, H = 16; };
constexpr int SEG = 8;   // outputs of one thread along a blur pass's axis
constexpr int FUSED_PASSES = 2;   // the most bloom passes of one launch
constexpr int STATIC_SMEM = 48 * 1024;

// What a launch loads into its first buffer: nothing (no bloom), the
// bright pass of the exposed image, or a scratch image of the chain.
enum Load { NO_BLOOM, BRIGHT, SCRATCH };

// torch.pow(v, p)'s routes on the card for a tensor and a Python number
// (ATen's Pow.cpp and cuda/PowKernel.cu), in the order it tests them; the
// first five compare p itself, the next three p rounded to the dtype.
enum PowRoute { POW, FILL_ONE, COPY, SQRT, RSQRT, RECIPROCAL, SQUARE, CUBE,
                INV_SQUARE };

// ops/tonemap.py::_CArgs. The numbers are the Python floats; the launch
// rounds them to the image's dtype.
struct TonemapArgs {
  double exposure, threshold, strength, inv_gamma;
  double gauss[5], luma[3], aces[5];   // gauss: the centre tap, then
                                       // the taps at distance 1..4
  int bloom;      // bloom_enabled
  int passes;     // bloom_passes (0 and up)
  int aces_on;    // tonemap
  int pow_route;  // PowRoute of 1 / gamma
  int f64;        // float64 image (else float32)
};

template <typename T>
struct Consts {
  T exposure, threshold, strength, inv_gamma, w[5], luma[3], aces[5];
  int pow_route;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fmaf_rn(1.0f, b, a); }
__device__ __forceinline__ double add(double a, double b) { return __fma_rn(1.0, b, a); }
__device__ __forceinline__ float sub(float a, float b) { return __fmaf_rn(-1.0f, b, a); }
__device__ __forceinline__ double sub(double a, double b) { return __fma_rn(-1.0, b, a); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float power(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double power(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return sqrt(a); }
__device__ __forceinline__ float rroot(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rroot(double a) { return rsqrt(a); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }

// torch.clamp on the card: a NaN passes, else fmax / fmin.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return isnan(v) ? v : vmax(v, lo);
}
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return isnan(v) ? v : vmin(vmax(v, lo), hi);
}

template <typename T>
__device__ __forceinline__ T aces(T x, const Consts<T>& k) {
  const T num = mul(x, add(mul(x, k.aces[0]), k.aces[1]));
  const T den = add(mul(x, add(mul(x, k.aces[2]), k.aces[3])), k.aces[4]);
  return clamp(quot(num, den), T(0), T(1));
}

// torch.pow(v, p) by the route the wrapper chose, as ATen computes each:
// out.fill_(1), out.copy_(v), ::sqrt, ::rsqrt, 1 / v, v * v, v * v * v,
// and 1.0 / (v * v) with the double literal (a double quotient, rounded
// to T).
template <typename T>
__device__ __forceinline__ T apply_gamma(T v, const Consts<T>& k) {
  if (k.pow_route == POW) return power(v, k.inv_gamma);   // the usual one
  switch (k.pow_route) {
    case FILL_ONE: return T(1);
    case COPY: return v;
    case SQRT: return root(v);
    case RSQRT: return rroot(v);
    case RECIPROCAL: return quot(T(1), v);
    case SQUARE: return mul(v, v);
    case CUBE: return mul(mul(v, v), v);
    case INV_SQUARE: return T(__ddiv_rn(1.0, double(mul(v, v))));
    default: return power(v, k.inv_gamma);
  }
}

// v mod n in [0, n) for any int v (n >= 1).
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  v %= n;
  return v < 0 ? v + n : v;
}

// The region a block holds: its tile and a halo of R on each side.
template <typename T, int R>
struct Region {
  static constexpr int TW = Tile<T>::W, TH = Tile<T>::H;
  static constexpr int W = TW + 2 * R, H = TH + 2 * R, PITCH = W + 1;
  static constexpr int PLANE = H * PITCH;
};

// Shared memory of an instantiation: with the bloom, two buffers of three
// Rg planes (the second stages the output tile); without it, the output
// tile alone.
template <typename T, int P, Load LOAD>
constexpr size_t smem_bytes() {
  using Rg = Region<T, LOAD == NO_BLOOM ? 0 : 4 * P>;
  return sizeof(T) * (LOAD == NO_BLOOM ? 3 * Rg::TW * Rg::TH
                                       : 2 * 3 * Rg::PLANE);
}

// One blur pass along AXIS (0: rows, y; 1: columns, x) from src to dst
// (three planes of Rg each), over the output window [Y0, Y1) x [X0, X1).
// A work item is SEG consecutive outputs along the axis: it holds the SEG
// + 8 inputs in registers and forms each product x[m] w[t] once for the
// two outputs m + t and m - t that take it (the weights are symmetric, so
// it is the plain version's g[4-t] x[i-t] and g[4+t] x[i+t] alike).
template <typename T, typename Rg, int AXIS, int Y0, int Y1, int X0, int X1>
__device__ __forceinline__ void blur_pass(const T* src, T* dst,
                                          const Consts<T>& k) {
  constexpr int ALONG = AXIS == 0 ? Y1 - Y0 : X1 - X0;
  constexpr int ACROSS = AXIS == 0 ? X1 - X0 : Y1 - Y0;
  constexpr int SEGS = ALONG / SEG;
  constexpr int ITEMS = 3 * SEGS * ACROSS;
  constexpr int STEP = AXIS == 0 ? Rg::PITCH : 1;
  static_assert(ALONG % SEG == 0, "a pass's window is a multiple of SEG");
  for (int i = threadIdx.x; i < ITEMS; i += THREADS) {
    const int c = i / (SEGS * ACROSS);
    const int r = i - c * (SEGS * ACROSS);
    const int seg = r / ACROSS, q = r - seg * ACROSS;
    const int y = AXIS == 0 ? Y0 + seg * SEG : Y0 + q;
    const int x = AXIS == 0 ? X0 + q : X0 + seg * SEG;
    const int at = c * Rg::PLANE + y * Rg::PITCH + x;
    T v[SEG + 8], o[SEG];
#pragma unroll
    for (int j = 0; j < SEG + 8; ++j) v[j] = src[at + (j - 4) * STEP];
#pragma unroll
    for (int j = 0; j < SEG; ++j) o[j] = mul(v[j + 4], k.w[0]);
#pragma unroll
    for (int t = 1; t <= 4; ++t) {
      T p[SEG + 8];
#pragma unroll
      for (int m = 4 - t; m < SEG + 4 + t; ++m) p[m] = mul(v[m], k.w[t]);
#pragma unroll
      for (int j = 0; j < SEG; ++j)
        o[j] = add(add(o[j], p[j + 4 - t]), p[j + 4 + t]);
    }
#pragma unroll
    for (int j = 0; j < SEG; ++j) dst[at + j * STEP] = o[j];
  }
}

// P bloom passes of the image loaded as LOAD; then with EPILOGUE the tone
// map into the (H, W, 3) out, else the blurred tile into the scratch image
// out. ``scratch`` is the chain's previous scratch image (LOAD == SCRATCH).
template <typename T, int P, Load LOAD, bool EPILOGUE, bool ACES>
__global__ void __launch_bounds__(THREADS)
tonemap_kernel(const T* __restrict__ img, int64_t sy, int64_t sx, int64_t sc,
               const T* __restrict__ scratch, int height, int width,
               T* __restrict__ out, const Consts<T> k) {
  constexpr int R = LOAD == NO_BLOOM ? 0 : 4 * P;
  using Rg = Region<T, R>;
  constexpr int TW = Rg::TW, TH = Rg::TH;
  static_assert(TW % SEG == 0 && TH % SEG == 0, "tile is a multiple of SEG");
  static_assert(P <= FUSED_PASSES, "one launch blurs FUSED_PASSES at most");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const a = reinterpret_cast<T*>(smem_raw);      // bright pass, blurred
  T* const stage = LOAD == NO_BLOOM ? a : a + 3 * Rg::PLANE;  // the second
  const int tiles_x = (width + TW - 1) / TW;
  const int x0 = (blockIdx.x % tiles_x) * TW, y0 = (blockIdx.x / tiles_x) * TH;

  if constexpr (LOAD != NO_BLOOM) {
    for (int i = threadIdx.x; i < Rg::H * Rg::W; i += THREADS) {
      const int ry = i / Rg::W, rx = i - ry * Rg::W;
      const int y = wrap(y0 - R + ry, height), x = wrap(x0 - R + rx, width);
      const int at = ry * Rg::PITCH + rx;
      if constexpr (LOAD == BRIGHT) {
        const T* p = img + y * sy + x * sx;
        const T e0 = mul(p[0], k.exposure), e1 = mul(p[sc], k.exposure),
                e2 = mul(p[2 * sc], k.exposure);
        const T luma = add(add(mul(e0, k.luma[0]), mul(e1, k.luma[1])),
                           mul(e2, k.luma[2]));
        const T m = clamp_min(sub(luma, k.threshold), T(0));
        a[at] = mul(e0, m);
        a[Rg::PLANE + at] = mul(e1, m);
        a[2 * Rg::PLANE + at] = mul(e2, m);
      } else {
        const T* p = scratch + ((int64_t)y * width + x) * 3;
        a[at] = p[0];
        a[Rg::PLANE + at] = p[1];
        a[2 * Rg::PLANE + at] = p[2];
      }
    }
    __syncthreads();
    if constexpr (P >= 1) {
      blur_pass<T, Rg, 0, 4, Rg::H - 4, 0, Rg::W>(a, stage, k);
      __syncthreads();
      blur_pass<T, Rg, 1, 4, Rg::H - 4, 4, Rg::W - 4>(stage, a, k);
      __syncthreads();
    }
    if constexpr (P >= 2) {
      blur_pass<T, Rg, 0, 8, Rg::H - 8, 4, Rg::W - 4>(a, stage, k);
      __syncthreads();
      blur_pass<T, Rg, 1, 8, Rg::H - 8, 8, Rg::W - 8>(stage, a, k);
      __syncthreads();
    }
  }

  if constexpr (!EPILOGUE) {
    for (int i = threadIdx.x; i < 3 * TW * TH; i += THREADS) {
      const int ty = i / (3 * TW), q = i - ty * (3 * TW);
      const int tx = q / 3, c = q - 3 * tx;
      if (y0 + ty < height && x0 + tx < width)
        out[((int64_t)(y0 + ty) * width + x0 + tx) * 3 + c] =
            a[c * Rg::PLANE + (ty + R) * Rg::PITCH + tx + R];
    }
  } else {
    for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
      const int ty = i / TW, tx = i - ty * TW;
      const int y = y0 + ty, x = x0 + tx;
      if (y >= height || x >= width) continue;
      const T* p = img + y * sy + x * sx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T v = mul(p[c * sc], k.exposure);
        if constexpr (LOAD != NO_BLOOM)
          v = add(v, mul(a[c * Rg::PLANE + (ty + R) * Rg::PITCH + tx + R],
                         k.strength));
        // ACES ends in the clip, and a second clip changes no bit
        v = ACES ? aces(v, k) : clamp(v, T(0), T(1));
        stage[3 * i + c] = apply_gamma(v, k);
      }
    }
    __syncthreads();
    const int row = 3 * min(TW, width - x0);
    for (int i = threadIdx.x; i < 3 * TW * TH; i += THREADS) {
      const int ty = i / (3 * TW), q = i - ty * (3 * TW);
      if (y0 + ty < height && q < row)
        out[((int64_t)(y0 + ty) * width + x0) * 3 + q] = stage[i];
    }
  }
}

struct Kernel {
  const void* fn;
  size_t smem;
};

template <typename T, int P, Load LOAD, bool EPILOGUE, bool ACES>
static Kernel kernel_of() {
  return {(const void*)tonemap_kernel<T, P, LOAD, EPILOGUE, ACES>,
          smem_bytes<T, P, LOAD>()};
}

template <typename T, bool ACES>
static Kernel fused(const TonemapArgs* a) {
  if (!a->bloom) return kernel_of<T, 0, NO_BLOOM, true, ACES>();
  if (a->passes == 0) return kernel_of<T, 0, BRIGHT, true, ACES>();
  if (a->passes == 1) return kernel_of<T, 1, BRIGHT, true, ACES>();
  return kernel_of<T, 2, BRIGHT, true, ACES>();
}

// The first launch of the tone map that ``a`` selects: the whole of it,
// or for more than FUSED_PASSES bloom passes the chain's first link.
template <typename T>
static Kernel first(const TonemapArgs* a) {
  if (a->bloom && a->passes > FUSED_PASSES)
    return kernel_of<T, 1, BRIGHT, false, false>();
  return a->aces_on ? fused<T, true>(a) : fused<T, false>(a);
}

// The last launch of a chain.
template <typename T>
static Kernel last(const TonemapArgs* a) {
  return a->aces_on ? kernel_of<T, 1, SCRATCH, true, true>()
                    : kernel_of<T, 1, SCRATCH, true, false>();
}

template <typename T>
static Consts<T> consts_of(const TonemapArgs* a) {
  Consts<T> k;
  k.exposure = (T)a->exposure;
  k.threshold = (T)a->threshold;
  k.strength = (T)a->strength;
  k.inv_gamma = (T)a->inv_gamma;
  for (int i = 0; i < 5; ++i) k.w[i] = (T)a->gauss[i];
  for (int i = 0; i < 3; ++i) k.luma[i] = (T)a->luma[i];
  for (int i = 0; i < 5; ++i) k.aces[i] = (T)a->aces[i];
  k.pow_route = a->pow_route;
  return k;
}

static cudaError_t allow_smem(const Kernel& kern) {
  if (kern.smem <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kern.fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kern.smem);
}

// One launch of ``kern``: one block a tile, row-major, in a
// one-dimensional grid (any height).
template <typename T>
static cudaError_t launch(const Kernel& kern, const T* img,
                          const long long* strides, const T* scratch,
                          int height, int width, T* out, const Consts<T>& k,
                          cudaStream_t stream) {
  cudaError_t err = allow_smem(kern);
  if (err != cudaSuccess) return err;
  int64_t sy = strides[0], sx = strides[1], sc = strides[2];
  Consts<T> kk = k;
  void* args[] = {&img, &sy, &sx, &sc, &scratch, &height, &width, &out, &kk};
  const dim3 grid(((width + Tile<T>::W - 1) / Tile<T>::W)
                  * ((height + Tile<T>::H - 1) / Tile<T>::H));
  err = cudaLaunchKernel(kern.fn, grid, dim3(THREADS), args, kern.smem,
                         stream);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// The tone map: one launch, or for more than FUSED_PASSES bloom passes a
// chain of ``passes`` one-pass launches through the two scratch images.
template <typename T>
static cudaError_t tonemap(const T* img, const long long* strides,
                           int height, int width, T* out, T* scratch,
                           const TonemapArgs* a, cudaStream_t stream) {
  const Consts<T> k = consts_of<T>(a);
  if (!a->bloom || a->passes <= FUSED_PASSES)
    return launch<T>(first<T>(a), img, strides, nullptr, height, width, out,
                     k, stream);
  T* const buf[2] = {scratch, scratch + (int64_t)height * width * 3};
  cudaError_t err = launch<T>(first<T>(a), img, strides, nullptr, height,
                              width, buf[0], k, stream);
  const Kernel middle = kernel_of<T, 1, SCRATCH, false, false>();
  for (int i = 1; err == cudaSuccess && i < a->passes - 1; ++i)
    err = launch<T>(middle, img, strides, buf[(i - 1) & 1], height, width,
                    buf[i & 1], k, stream);
  if (err == cudaSuccess)
    err = launch<T>(last<T>(a), img, strides, buf[(a->passes - 2) & 1],
                    height, width, out, k, stream);
  return err;
}

extern "C" {

// Tone-maps ``img`` ((H, W, 3) values at element strides ``strides`` =
// {y, x, channel}) into the contiguous (H, W, 3) ``out`` on ``stream``.
// ``scratch`` holds two contiguous (H, W, 3) images where the bloom runs
// more than FUSED_PASSES passes (bh_tonemap_fused_passes), else may be
// null. Returns a CUDA error code: cudaErrorInvalidValue for an empty
// image, negative passes or a missing scratch, else cudaGetLastError()
// after the last launch.
int bh_tonemap_launch(const void* img, const long long* strides, int height,
                      int width, void* out, void* scratch,
                      const TonemapArgs* a, void* stream) {
  const bool chain = a->bloom && a->passes > FUSED_PASSES;
  if (height < 1 || width < 1 || a->passes < 0 || (chain && !scratch))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(a->f64
      ? tonemap<double>((const double*)img, strides, height, width,
                        (double*)out, (double*)scratch, a, s)
      : tonemap<float>((const float*)img, strides, height, width,
                       (float*)out, (float*)scratch, a, s));
}

// The launch shape of the first launch that ``a`` selects, on the current
// device: out = {threads per block, tile width, tile height, dynamic shared
// bytes per block, resident blocks per SM, SMs}; returns a CUDA error code.
int bh_tonemap_shape(const TonemapArgs* a, int* out) {
  const Kernel kern = a->f64 ? first<double>(a) : first<float>(a);
  int dev = 0, blocks = 0, sms = 0;
  cudaError_t err = allow_smem(kern);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern.fn,
                                                        THREADS, kern.smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = THREADS;
  out[1] = a->f64 ? Tile<double>::W : Tile<float>::W;
  out[2] = a->f64 ? Tile<double>::H : Tile<float>::H;
  out[3] = (int)kern.smem;
  out[4] = blocks;
  out[5] = sms;
  return (int)err;
}

int bh_tonemap_fused_passes() { return FUSED_PASSES; }

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bh_tonemap_args_size() { return (int)sizeof(TonemapArgs); }

}  // extern "C"
