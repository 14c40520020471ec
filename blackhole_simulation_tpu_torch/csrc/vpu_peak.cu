// FP32 peak probe for Hopper (sm_90a): independent chains of fused
// multiply-adds, timed by tools/vpu_peak.py, whose measured rate of lane FMA
// instructions is the denominator of every operation bound in chip_smoke.py.
//
// Replaces the Pallas TPU kernel of blackhole_simulation_tpu/tools/
// vpu_peak.py (:65, defined inside its main()): C independent float32 chains
// x <- x * k + b, unrolled U times per loop iteration, for T iterations, then
// the chains summed into one output so that none of them is dead code. The
// plain PyTorch version of the same recurrence is tools/vpu_peak.py::
// fma_chains_plain, which rounds each step once as __fmaf_rn does and so
// agrees with this kernel bit for bit. Built by ops/build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 --fmad=false; the FMAs are explicit
// intrinsics, so --fmad=false leaves them fused.
//
// What bounds it: the FP32 pipes alone. It reads C words and writes one per
// thread; everything else is T x U x C dependent-by-chain FMAs in registers.
// C independent chains per thread hide the FMA latency; U amortizes the loop
// branch; the launch holds many blocks per SM so that every SM's four
// schedulers stay fed.

#include <cuda_runtime.h>

#define THREADS 256

template <int C, int U>
__global__ void __launch_bounds__(THREADS)
fma_chains_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int n, int iters) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  const float k = (float)1.0000001;
  const float b = (float)1e-7;
  float xs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xs[c] = x[(size_t)c * n + j];
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) xs[c] = __fmaf_rn(xs[c], k, b);
    }
  }
  float acc = xs[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = acc + xs[c];
  out[j] = acc;
}

template <int C>
static int launch_c(const float* x, float* out, int n, int iters, int unroll,
                    cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  switch (unroll) {
    case 1: fma_chains_kernel<C, 1><<<blocks, THREADS, 0, stream>>>(x, out, n, iters); break;
    case 2: fma_chains_kernel<C, 2><<<blocks, THREADS, 0, stream>>>(x, out, n, iters); break;
    case 4: fma_chains_kernel<C, 4><<<blocks, THREADS, 0, stream>>>(x, out, n, iters); break;
    case 8: fma_chains_kernel<C, 8><<<blocks, THREADS, 0, stream>>>(x, out, n, iters); break;
    case 16: fma_chains_kernel<C, 16><<<blocks, THREADS, 0, stream>>>(x, out, n, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Launches the probe on ``stream``: x (chains, n) float32, out (n,).
// chains and unroll take 1, 2, 4, 8 or 16; returns a cudaError_t code.
int bh_fma_chains_launch(const float* x, float* out, int n, int iters,
                         int chains, int unroll, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1: return launch_c<1>(x, out, n, iters, unroll, s);
    case 2: return launch_c<2>(x, out, n, iters, unroll, s);
    case 4: return launch_c<4>(x, out, n, iters, unroll, s);
    case 8: return launch_c<8>(x, out, n, iters, unroll, s);
    case 16: return launch_c<16>(x, out, n, iters, unroll, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bh_threads_per_block() { return THREADS; }

const char* bh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
