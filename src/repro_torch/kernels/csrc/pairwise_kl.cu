// Eq. 2 divergence strip on Hopper:
//   D[a,b] = (sum_k p_a l_a - sum_k p_a l_b) / R
// over the flattened K = R*C axis, with p_a = exp(l_a).
//
// Replaces: src/repro/kernels/pairwise_kl.py::_kernel (launched by
// _pair_call), the Pallas TPU kernel behind pairwise_kl and
// pairwise_kl_pair.
//
// Bound on this card: operations. A (U x M) strip costs 2 U M K flops
// against (U + M) K input values, so at the server-round shape
// (2048 x 4096 strip, K = 2400) it is ~1400 flop per byte read, far above
// the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte).
//
// Design: the shared fp32 tile GEMM of gemm_tile.cuh with FFMA (no TF32:
// rowterm - cross cancels and 1/d ranks neighbors). exp is applied to the
// A tile as it is loaded, and the row term sum_k p_a l_a accumulates in
// the same k loop from the values already in registers, then a fixed
// butterfly over the 16 lanes that share a row finishes it. Ragged edges
// are masked in the load (a masked element contributes p = 0), not
// zero-padded on the host. Simple first: no wgmma, TMA or pipelining yet.
#include "gemm_tile.cuh"

namespace {

using namespace tile;

template <typename T>
__global__ void __launch_bounds__(THREADS)
pairwise_kl_pair_kernel(const T* __restrict__ la, const T* __restrict__ lb,
                        float* __restrict__ out, int U, int M, int K,
                        float R) {
  __shared__ float As[BK][LD];
  __shared__ float Bs[BK][LD];
  __shared__ float rowterm[BM];

  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4] = {};
  float rt[4] = {};  // this thread's share of the row term of rows kc_row(e)

  for (int k0 = 0; k0 < K; k0 += BK) {
    float p[4], b[4];
    const int k = k0 + kc_k();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + kc_row(e);
      p[e] = 0.f;
      if (r < U && k < K) {
        const float l = ld(la, (size_t)r * K + k);
        p[e] = expf(l);
        rt[e] = fmaf(p[e], l, rt[e]);
      }
    }
    load_kcontig(lb, M, K, c0, k0, b);
    store_kcontig(As, p);
    store_kcontig(Bs, b);
    __syncthreads();
    mma(As, Bs, acc);
    __syncthreads();
  }

  // the 16 lanes holding parts of one row differ only in their low 4 bits
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rt[e] += __shfl_xor_sync(0xffffffffu, rt[e], off);
  if (kc_k() == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) rowterm[kc_row(e)] = rt[e];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= U) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < M)
        out[(size_t)row * M + col] = (rowterm[ty + 16 * i] - acc[i][j]) / R;
    }
  }
}

}  // namespace

// la (U, K), lb (M, K) row-major, fp32 (bf16 == 0) or bf16; out (U, M)
// fp32. Returns cudaGetLastError() after the launch.
extern "C" int pairwise_kl_pair(const void* la, const void* lb, void* out,
                                int U, int M, int K, int R, int bf16,
                                void* stream) {
  const dim3 grid((M + tile::BN - 1) / tile::BN,
                  (U + tile::BM - 1) / tile::BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    pairwise_kl_pair_kernel<__nv_bfloat16><<<grid, tile::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(la),
        static_cast<const __nv_bfloat16*>(lb), static_cast<float*>(out), U,
        M, K, static_cast<float>(R));
  } else {
    pairwise_kl_pair_kernel<float><<<grid, tile::THREADS, 0, s>>>(
        static_cast<const float*>(la), static_cast<const float*>(lb),
        static_cast<float*>(out), U, M, K, static_cast<float>(R));
  }
  return static_cast<int>(cudaGetLastError());
}
