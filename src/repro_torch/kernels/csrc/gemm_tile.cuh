// Shared fp32 FFMA tiling of dequant_kl.cu (B4, the int8 Eq. 2 strip) and
// neighbor_mean.cu (the dense Eq. 5 entry). pairwise_kl.cu (B1) no longer
// uses it: it runs 3xTF32 on wgmma with its own TMA pipeline.
//
// A block owns one BM x BN output tile and walks the whole contraction
// axis itself in BK-deep steps (the Pallas grid's sequential k axis
// becomes this in-block loop), so blocks never share an output element:
// no atomics, and the order of every sum is fixed.
//
// 256 threads; each keeps a 4 x 4 accumulator at rows ty + 16 i and
// columns tx + 16 j (tx = t % 16, ty = t / 16), so the epilogue's stores
// are 16 consecutive floats per half-warp. Shared tiles are k-major and
// padded by one float per row, which spreads the transposing stores over
// the banks.
//
// Products are fp32 FFMA on the CUDA cores. No plain TF32 tensor-core
// path for B4: the divergence rowterm - cross cancels heavily and its
// reciprocal ranks the neighbors, so the inputs keep their full fp32
// mantissas (B1's split into TF32 hi and lo parts is the way to the
// tensor cores that keeps them).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int LD = BM + 1;  // padded shared row (BM == BN)

static_assert(BM == BN, "one padded row length serves both tiles");
static_assert(BK * BM == 4 * THREADS, "each thread moves 4 values a tile");

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Row r of the tile for slot e of this thread, when the source matrix
// keeps its contraction axis contiguous (rows x K, row-major). Lanes walk
// k, so a half-warp reads 16 consecutive elements of one row.
__device__ __forceinline__ int kc_row(int e) {
  return (threadIdx.x >> 4) + 16 * e;
}
__device__ __forceinline__ int kc_k() { return threadIdx.x & 15; }

template <typename T>
__device__ __forceinline__ void load_kcontig(const T* g, int rows, int K,
                                             int r0, int k0, float v[4]) {
  const int k = k0 + kc_k();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + kc_row(e);
    v[e] = (r < rows && k < K) ? ld(g, (size_t)r * K + k) : 0.f;
  }
}

__device__ __forceinline__ void store_kcontig(float s[BK][LD],
                                              const float v[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[kc_k()][kc_row(e)] = v[e];
}

// A (K x cols) row-major source whose column axis is contiguous: lanes
// walk the columns, so a warp reads 32 consecutive elements of one k row.
template <typename T>
__device__ __forceinline__ void load_ncontig(const T* g, int K, int cols,
                                             int k0, int c0, float v[4]) {
  const int c = c0 + (threadIdx.x & 63);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + (threadIdx.x >> 6) + 4 * e;
    v[e] = (k < K && c < cols) ? ld(g, (size_t)k * cols + c) : 0.f;
  }
}

__device__ __forceinline__ void store_ncontig(float s[BK][LD],
                                              const float v[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[(threadIdx.x >> 6) + 4 * e][threadIdx.x & 63] = v[e];
}

// acc[i][j] += sum_kk As[kk][ty + 16 i] * Bs[kk][tx + 16 j], kk ascending.
__device__ __forceinline__ void mma(float As[BK][LD], float Bs[BK][LD],
                                    float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace tile
