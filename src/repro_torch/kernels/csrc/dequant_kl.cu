// Fused int8 dequant -> Eq. 2 divergence strip on Hopper, straight from
// the int8 wire form:
//   D[a,b] = (sum_k p_a l_a - sum_k p_a l_b) / R,
//   l[n,k] = q[n,k] * scale[n,r] - lse[n,r],  r = k / C,  p_a = exp(l_a)
// over the flattened K = R*C axis. The per-row zero point cancels in the
// softmax and is never read; lse[n,r] = logsumexp_c(q * scale) comes from
// the wrapper (a plain O(N R) pass).
//
// Replaces: src/repro/kernels/dequant_kl.py::_kernel (launched by
// _call_pair), the Pallas TPU kernel behind int8_pairwise_kl and
// int8_pairwise_kl_pair.
//
// Bound on this card: operations at the shapes the server runs. A
// (U x M) strip costs 2 U M K flops against (U + M) K code bytes,
// 8 (U + M) R bytes of scale/lse and 4 U M output bytes. The server-round
// strip (2048 x 4096, R = 240, C = 10) is ~800 flop per byte moved; the
// IVF oracle strip (64 x 131072, R = 8, C = 10) ~30, still above the
// H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte).
//
// Design: the fp32 FFMA tile of gemm_tile.cuh (no TF32: rowterm - cross
// cancels and 1/d ranks neighbors) with loaders that dequantize. Each
// thread reads the uint8 code at flat k and the scale/lse of (row, k / C)
// and forms l in registers; for A it applies exp and accumulates the row
// term in the same k loop. The fp32 (N, R, C)
// decode never exists in device memory, which is what the TPU kernel was
// written for. Ragged edges are masked in the load (a masked A element
// gives p = 0 and adds nothing to the row term, a masked B element is 0,
// so no 0 * -inf is ever formed), not padded with lse = 1e30 as on the
// TPU. An upload's forward (1 x m) or reverse (m x 1) strip fills one row
// or column of each 64 x 64 tile and wastes the rest: accepted in this
// first version, the times are in PERF.md.
#include <cstdint>

#include "gemm_tile.cuh"

namespace {

using namespace tile;

__global__ void __launch_bounds__(THREADS)
dequant_kl_pair_kernel(const uint8_t* __restrict__ qa,
                       const float* __restrict__ sa,
                       const float* __restrict__ la,
                       const uint8_t* __restrict__ qb,
                       const float* __restrict__ sb,
                       const float* __restrict__ lb,
                       float* __restrict__ out, int U, int M, int R, int C) {
  __shared__ float As[BK][LD];
  __shared__ float Bs[BK][LD];
  __shared__ float rowterm[BM];

  const int K = R * C;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4] = {};
  float rt[4] = {};  // this thread's share of the row term of rows kc_row(e)

  for (int k0 = 0; k0 < K; k0 += BK) {
    float p[4], b[4];
    const int k = k0 + kc_k();
    const int j = k / C;  // reference row of this thread's k
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ra = r0 + kc_row(e);
      p[e] = 0.f;
      if (ra < U && k < K) {
        const size_t s = (size_t)ra * R + j;
        const float l = fmaf((float)qa[(size_t)ra * K + k], sa[s], -la[s]);
        p[e] = expf(l);
        rt[e] = fmaf(p[e], l, rt[e]);
      }
      const int rb = c0 + kc_row(e);
      b[e] = 0.f;
      if (rb < M && k < K) {
        const size_t s = (size_t)rb * R + j;
        b[e] = fmaf((float)qb[(size_t)rb * K + k], sb[s], -lb[s]);
      }
    }
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

  const float inv_r = 1.f / static_cast<float>(R);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= U) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < M)
        out[(size_t)row * M + col] = (rowterm[ty + 16 * i] - acc[i][j]) * inv_r;
    }
  }
}

}  // namespace

// qa (U, R, C) / qb (M, R, C) uint8 codes; sa, la (U, R) and sb, lb
// (M, R) fp32 scale and lse; out (U, M) fp32. Every array row-major and
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int int8_pairwise_kl_pair(const void* qa, const void* sa,
                                     const void* la, const void* qb,
                                     const void* sb, const void* lb,
                                     void* out, int U, int M, int R, int C,
                                     void* stream) {
  const dim3 grid((M + tile::BN - 1) / tile::BN,
                  (U + tile::BM - 1) / tile::BM);
  dequant_kl_pair_kernel<<<grid, tile::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qa), static_cast<const float*>(sa),
      static_cast<const float*>(la), static_cast<const uint8_t*>(qb),
      static_cast<const float*>(sb), static_cast<const float*>(lb),
      static_cast<float*>(out), U, M, R, C);
  return static_cast<int>(cudaGetLastError());
}
