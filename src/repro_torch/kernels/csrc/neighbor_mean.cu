// Eq. 5 distillation targets on Hopper, the dense entry: T = W S, W
// (N x N) fp32 row-stochastic selection weights, S (N x RC) messenger
// probabilities, fp32 or bf16, T (N x RC) fp32. This file holds the
// route's transposing split; the route's other two launches are
// pairwise_kl.cu's.
//
// Replaces: src/repro/kernels/neighbor_mean.py::_kernel, the Pallas TPU
// kernel behind neighbor_mean, for a dense W (FedMD's complete graph).
// The policies' sparse graphs (<= K nonzeros a row) take
// neighbor_gather.cu instead.
//
// Bound on this card: operations. The product is 2 N^2 RC flops over
// N^2 + 2 N RC values; kept at fp32-level accuracy as three TF32
// tensor-core products (3xTF32), 6 N^2 RC flops: at N = 4096, RC = 2400,
// 0.488 ms at 495 TFLOP/s. FedMD's weights are 1/n_active, which TF32
// does not hold exactly, so W needs its lo plane as much as S does.
//
// Design, three launches over B1's machinery:
//
// 1. W's split: pairwise_kl.cu's split pass in its B-side mode (no exp,
//    no row term) writes tf32(W) and tf32(W - tf32(W)) as (N, Kp) planes,
//    K = N, K-major as W already is.
// 2. S's transposing split (neighbor_mean_split, below). wgmma takes
//    .tf32 operands K-major only (the transposed layouts exist for 16-bit
//    types alone), so the B operand must be S^T, (RC, Kp) and K-major. A
//    block reads a 32 (n) x 64 (j) tile of S with 16-byte loads (8-byte
//    for bf16; 16 threads cover a tile row's 256 contiguous bytes) into
//    shared memory, then writes the tile's 64 rows of S^T as 32
//    consecutive n each, 8 threads of 16-byte stores a row, hi and lo. The
//    tile's row stride of 65 floats makes the column reads of the second
//    phase conflict-free (lanes differ in n by 4 and in j by 1, banks
//    n + j). It rounds with the split pass's tf32() and writes zeros for
//    n in [N, Kp), Kp = N padded to the GEMM's 32-deep k-tile, so each
//    plane row is a multiple of 16 bytes long, as TMA requires. When RC is
//    not a multiple of 4, or S is not aligned for vector loads, the loads
//    are scalar.
// 3. pairwise_kl.cu's 3xTF32 wgmma GEMM (TMA ring, two consumer
//    warpgroups, each 32-deep k-tile summed into an fp32 register sum) in
//    its plain-store mode: no row term, no 1/R, T = hi(W) hi(S) +
//    hi(W) lo(S) + lo(W) hi(S), ragged edges masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TN = 32;         // n a tile: the GEMM's k-tile depth
constexpr int TJ = 64;         // j (a column of S, a row of S^T) a tile
constexpr int THREADS = 256;

static_assert(THREADS == 16 * (TN / 2), "16 threads a loaded row");
static_assert(THREADS == 8 * (TJ / 2), "8 threads a stored row");

// x rounded to TF32, to nearest with ties away from zero; low bits zero
// (pairwise_kl.cu's tf32(), which rounds W's planes)
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// v[0..4) = p[0..4) widened to fp32, in one 16-byte (fp32) or 8-byte
// (bf16) load; the caller guarantees the alignment
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  // a bf16 is the top half of the fp32 with the same value
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
split_t_kernel(const T* __restrict__ s, float* __restrict__ hi,
               float* __restrict__ lo, int N, int RC, int Kp) {
  __shared__ float tile[TN][TJ + 1];
  const int n0 = blockIdx.y * TN;
  const int j0 = blockIdx.x * TJ;

  // phase 1: S's rows n0.. into the tile, 4 consecutive j a thread
  const int tj = (threadIdx.x % 16) * 4;
  for (int tn = threadIdx.x / 16; tn < TN; tn += THREADS / 16) {
    const int n = n0 + tn;
    const int j = j0 + tj;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < N) {
      const T* src = s + (size_t)n * RC + j;
      if constexpr (VEC) {
        if (j < RC) load4(src, v);  // RC % 4 == 0: all four or none
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < RC) v[e] = widen(src[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[tn][tj + e] = v[e];
  }
  __syncthreads();

  // phase 2: S^T's rows j0.. (n0..n0+31 of each), 4 consecutive n a
  // thread
  const int tn = (threadIdx.x % 8) * 4;
  for (int r = threadIdx.x / 8; r < TJ; r += THREADS / 8) {
    const int j = j0 + r;
    if (j >= RC) break;
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = tile[tn + e][r];
      h[e] = tf32(x);
      l[e] = tf32(x - h[e]);
    }
    const size_t at = (size_t)j * Kp + n0 + tn;
    *reinterpret_cast<float4*>(hi + at) =
        make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + at) =
        make_float4(l[0], l[1], l[2], l[3]);
  }
}

template <typename T>
cudaError_t launch_split_t(const void* s, void* hi, void* lo, int N, int RC,
                           int Kp, int gx, int gy, int block,
                           cudaStream_t st) {
  const dim3 grid(gx, gy);
  const bool vec = RC % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % (4 * sizeof(T)) == 0;
  auto kernel = vec ? split_t_kernel<T, true> : split_t_kernel<T, false>;
  kernel<<<grid, block, 0, st>>>(static_cast<const T*>(s),
                                 static_cast<float*>(hi),
                                 static_cast<float*>(lo), N, RC, Kp);
  return cudaGetLastError();
}

}  // namespace

// s (N, RC) row-major, fp32 (bf16 == 0) or bf16 -> hi, lo (RC, Kp) fp32
// planes of S^T (Kp a multiple of 32 and >= N, zero past N; 16-byte
// aligned), on the grid kernels/neighbor_mean.py's split_geometry gives:
// gx blocks of TJ columns of S over RC, gy = Kp / TN blocks over the
// planes' k. Returns cudaGetLastError() after the launch, or a refusal
// before it.
extern "C" int neighbor_mean_split(const void* s, void* hi, void* lo, int N,
                                   int RC, int Kp, int bf16, int gx, int gy,
                                   int block, int smem, void* stream) {
  if (Kp % TN != 0 || Kp < N ||
      reinterpret_cast<uintptr_t>(hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lo) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (RC == 0 || Kp == 0) return static_cast<int>(cudaSuccess);
  if ((long)gx * TJ < RC || (long)(gx - 1) * TJ >= RC || gx < 1 ||
      (long)gy * TN != Kp || block != THREADS || smem != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_split_t<__nv_bfloat16>(s, hi, lo, N, RC, Kp, gx, gy,
                                           block, st)
           : launch_split_t<float>(s, hi, lo, N, RC, Kp, gx, gy, block, st));
}
