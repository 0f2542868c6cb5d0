// Eq. 5 distillation targets on Hopper, the dense entry: T = W S, W
// (N x N) fp32 row-stochastic selection weights, S (N x RC) messenger
// probabilities.
//
// Replaces: src/repro/kernels/neighbor_mean.py::_kernel, the Pallas TPU
// kernel behind neighbor_mean, for a dense W. The policies' sparse graphs
// (<= K nonzeros a row) take neighbor_gather.cu instead; this entry is
// kept for graphs with ~N nonzeros a row (FedMD's complete graph) and is
// off the SQMD path.
//
// Bound on this card: bytes for a sparse W, operations for a dense one.
// A dense W is N^2 RC multiply-adds over N^2 + 2 N RC values: at N = 4096,
// RC = 2400 that is 80 GFLOP, ~1.2 ms at 67 TFLOP/s. With at most K
// nonzeros a row the work the data needs is 2 nnz(W) RC flops, while this
// interface still reads all of W (N^2 floats) plus S and writes T: ~145
// MB, ~43 us at 3.35 TB/s.
//
// Design: the TPU kernel's dense interface as a dense fp32 FFMA GEMM
// under the tiling of gemm_tile.cuh, with a plain store epilogue. It does
// N^2 RC multiply-adds whatever W holds; neighbor_gather.cu does the
// K N RC that a sparse W needs.
#include "gemm_tile.cuh"

namespace {

using namespace tile;

template <typename T>
__global__ void __launch_bounds__(THREADS)
neighbor_mean_kernel(const float* __restrict__ w, const T* __restrict__ s,
                     float* __restrict__ out, int N, int RC) {
  __shared__ float As[BK][LD];
  __shared__ float Bs[BK][LD];

  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < N; k0 += BK) {
    float a[4], b[4];
    load_kcontig(w, N, N, r0, k0, a);
    load_ncontig(s, N, RC, k0, c0, b);
    store_kcontig(As, a);
    store_ncontig(Bs, b);
    __syncthreads();
    mma(As, Bs, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < RC) out[(size_t)row * RC + col] = acc[i][j];
    }
  }
}

}  // namespace

// w (N, N) fp32, s (N, RC) fp32 (bf16 == 0) or bf16, out (N, RC) fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int neighbor_mean(const void* w, const void* s, void* out, int N,
                             int RC, int bf16, void* stream) {
  const dim3 grid((RC + tile::BN - 1) / tile::BN,
                  (N + tile::BM - 1) / tile::BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    neighbor_mean_kernel<__nv_bfloat16><<<grid, tile::THREADS, 0, st>>>(
        static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(s),
        static_cast<float*>(out), N, RC);
  } else {
    neighbor_mean_kernel<float><<<grid, tile::THREADS, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(s),
        static_cast<float*>(out), N, RC);
  }
  return static_cast<int>(cudaGetLastError());
}
