// Eq. 1 quality scores on Hopper: g[n] = sum_i [lse_c z[n,i,:] - z[n,i,y_i]],
// rows with y_i < 0 contributing 0.
//
// Replaces: src/repro/kernels/soft_ce.py::_kernel, the Pallas TPU kernel
// behind soft_ce.
//
// Bound on this card: bytes. Each logit is read once and costs a handful
// of flops; at the server-round shape (N = 4096, R = 240, C = 10, fp32)
// that is 39 MB, ~12 us at 3.35 TB/s.
//
// Design: one block per client n, so each score is one block's sum and no
// atomics are needed. Threads stride over the R reference rows; a thread
// keeps one row's max-subtracted logsumexp over C in registers (two
// passes over the row, the second hitting L1). The block's partial sums
// meet in a fixed shared-memory tree, so g[n] is the same on every run.
// C is looped, not unrolled: up to MAX_C (the wrapper raises above it),
// beyond which one thread per row would serialize too much.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
soft_ce_kernel(const T* __restrict__ z, const int* __restrict__ y,
               float* __restrict__ out, int R, int C) {
  __shared__ float buf[THREADS];
  const size_t base = (size_t)blockIdx.x * R * C;

  float part = 0.f;
  for (int i = threadIdx.x; i < R; i += THREADS) {
    const int yi = y[i];
    if (yi < 0) continue;
    const size_t row = base + (size_t)i * C;
    float m = -INFINITY;
    for (int c = 0; c < C; ++c) m = fmaxf(m, ld(z, row + c));
    float sum = 0.f;
    float picked = 0.f;
    for (int c = 0; c < C; ++c) {
      const float v = ld(z, row + c);
      sum += expf(v - m);
      if (c == yi) picked = v;
    }
    part += (logf(sum) + m) - picked;
  }

  buf[threadIdx.x] = part;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

}  // namespace

// z (N, R, C) fp32 (bf16 == 0) or bf16, y (R,) int32, out (N,) fp32, on
// the grid of gx blocks of ``block`` threads that kernels/soft_ce.py's
// launch_geometry gives (one block a client row). Returns
// cudaGetLastError() after the launch, or a refusal before it when the
// geometry is not one block a row.
extern "C" int soft_ce(const void* z, const void* y, void* out, int N, int R,
                       int C, int bf16, int gx, int gy, int block, int smem,
                       void* stream) {
  if (gx != N || gy != 1 || block != THREADS || smem != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    soft_ce_kernel<__nv_bfloat16><<<gx, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const int*>(y),
        static_cast<float*>(out), R, C);
  } else {
    soft_ce_kernel<float><<<gx, block, 0, s>>>(
        static_cast<const float*>(z), static_cast<const int*>(y),
        static_cast<float*>(out), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}
