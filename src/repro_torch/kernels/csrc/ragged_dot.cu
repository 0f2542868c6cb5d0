// The grouped product of the dropless MoE on Hopper: the counterpart of
// jax.lax.ragged_dot, forward and backward, with the group sizes read on
// the device only.
//
//   ragged_dot:       out (M,N) = lhs (M,K) rows of group g times rhs[g],
//                     rhs (G,K,N), or (G,N,K) read transposed in place
//                     (the input gradient d_lhs = d_out rhs^T); rows at or
//                     past sum(sizes) come out 0;
//   ragged_dot_wgrad: out (G,K,N), out[g] = lhs rows of group g transposed
//                     times grad rows of group g (0 for an empty group).
//
// lhs's rows are sorted by group; sizes (G,) int32 on the device. fp32 or
// bf16 in, the output in the same type; sums in fp32, one rounding at the
// end. fp32 runs on IEEE FFMA (never TF32), bf16 on the tensor cores
// (WMMA 16x16x16, fp32 accumulators).
//
// Replaces: no Pallas kernel. jax.lax.ragged_dot is one XLA op in the
// reference (src/repro/models/ffn.py:133-160, moe_dropless_forward); the
// port ran one cuBLAS product an expert from Python after copying the
// group sizes to the host, a sync a layer and 3 G launches.
//
// Bound on this card: bytes. At an MoE layer's shapes every expert's
// weights are read (forward) or written (weight gradient) once, 0.94 GB
// a product for mixtral-8x7b (8 x 4096 x 14336 bf16) and 2.5 GB for
// deepseek-v2-236b (160 x 5120 x 1536), ~0.28 and ~0.75 ms at 3.35 TB/s;
// the products are 2 M K N flops, 60 GFLOP at mixtral's 512 prefill rows,
// ~0.06 ms at the bf16 peak.
//
// Design (simple first; wgmma and TMA are later work):
//   * forward: a block owns BM rows of ONE group and BN output columns.
//     The grid launches cdiv(M, BM) + G row tiles, an upper bound on the
//     tiles the groups and the zero tail need (cdiv(a) + cdiv(b) <=
//     cdiv(a + b) + 1, over G + 1 terms), so no size is read on the host.
//     Each block builds the groups' first rows and first tiles in shared
//     memory from sizes (one warp, two shuffle scans), finds its group by
//     binary search and exits past the last tile; the tiles just past the
//     groups write the zero tail;
//   * weight gradient: a block owns one group's (BM rows of K, BN columns
//     of N) and sums over that group's rows in steps of BK;
//   * both: BK-deep stages of both operands in a ring in dynamic shared
//     memory (the forward's 4 stages in bf16, 3 in fp32; the weight
//     gradient's 2), the next stages' cp.async
//     copies in flight while one stage is multiplied (the loop is bound
//     by the bytes in flight, the products are short); each stage tile
//     in its global layout, so a transposed operand is a column-major
//     WMMA fragment (or a strided FFMA read), never a copy; 16-byte
//     copies and stores only where the base is 16-byte aligned and the
//     row length a multiple of 16 bytes, else predicated scalar loads;
//     rows, columns and depth past the operands read as 0 and are never
//     written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;     // 8 warps
constexpr int BM = 64;           // output rows a block
constexpr int BN = 128;          // output columns a block
constexpr int BK = 32;           // reduction depth a stage
constexpr int MAX_GROUPS = 1024; // the group tables live in shared memory

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;    // elements in 16 bytes
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);    // round to nearest even
}

// The forward's ring depth: stages in flight (the last one being
// computed). The weight gradient's groups are often a stage or two deep
// (deepseek-v2-236b: ~10 rows a group), so its ring keeps 2 and leaves
// room for more resident blocks.
template <typename T>
struct Ring;
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int STAGES = 4;
};
template <>
struct Ring<float> {
  static constexpr int STAGES = 3;
};
constexpr int WGRAD_STAGES = 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  // 16 bytes global -> shared, the last 16 - bytes of them zero-filled
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage of an operand: R x C elements of a row-major global matrix
// (leading dimension ld), C contiguous, copied to shared memory as R rows
// of LD = C + one 16-byte chunk of padding, in its global layout.
// Elements at rows >= rmax or columns >= cmax read as 0. With ``vec``
// (base, ld and column start 16-byte aligned) each thread's chunks go by
// cp.async, zero-filled past the operand; else by predicated scalar loads
// and stores.
template <typename T, int R, int C>
struct Stage {
  static constexpr int V = Vec<T>::N;
  static constexpr int CHUNKS = R * C / V;
  static constexpr int PER = CHUNKS / THREADS;
  static constexpr int LD = C + V;
  static constexpr int ELEMS = R * LD;
  static_assert(C % V == 0 && CHUNKS % THREADS == 0, "whole chunks a thread");

  static __device__ __forceinline__ void copy(T* s, const T* g, size_t ld,
                                              int r0, int c0, int rmax,
                                              int cmax, bool vec) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int ch = threadIdx.x + i * THREADS;
      const int r = ch / (C / V), c = (ch % (C / V)) * V;
      const int gr = r0 + r, gc = c0 + c;
      T* dst = s + r * LD + c;
      if (vec) {
        const int n = gr < rmax ? max(0, min(V, cmax - gc)) : 0;
        cp_async16(dst, n ? g + gr * ld + gc : g, n * (int)sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          dst[e] = (gr < rmax && gc + e < cmax) ? g[gr * ld + gc + e]
                                                : from_float<T>(0.f);
      }
    }
  }
};

// a stage of both operands, rounded to 128 bytes; a ring's bytes
template <typename T, typename SA, typename SB>
__host__ __device__ constexpr int stage_elems() {
  return ((SA::ELEMS + SB::ELEMS) * (int)sizeof(T) + 127) / 128 * 128 /
         (int)sizeof(T);
}
template <typename T, typename SA, typename SB, int S>
__host__ __device__ constexpr int ring_bytes() {
  return S * stage_elems<T, SA, SB>() * (int)sizeof(T);
}

// The groups' first rows (clamped to M) and first row tiles, in shared
// memory: off[g], tile[g] for g <= G (off[G] = min(sum, M), tile[G] the
// groups' tiles). One warp; each lane takes cdiv(G, 32) groups in a row.
__device__ void group_tables(const int* __restrict__ sizes, int G, int M,
                             int* off, int* tile) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (G + 31) / 32;
  const int g0 = min(lane * per, G), g1 = min(g0 + per, G);
  long long rows = 0;
  for (int g = g0; g < g1; ++g) rows += max(sizes[g], 0);
  long long incl = rows;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  long long at = incl - rows;
  int tiles = 0;
  for (int g = g0; g < g1; ++g) {
    const long long a = min(at, (long long)M);
    at += max(sizes[g], 0);
    const long long b = min(at, (long long)M);
    off[g] = (int)a;
    tiles += (int)((b - a + BM - 1) / BM);
  }
  int tincl = tiles;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, tincl, d);
    if (lane >= d) tincl += v;
  }
  int t = tincl - tiles;
  at = incl - rows;
  for (int g = g0; g < g1; ++g) {
    const long long a = min(at, (long long)M);
    at += max(sizes[g], 0);
    const long long b = min(at, (long long)M);
    tile[g] = t;
    t += (int)((b - a + BM - 1) / BM);
  }
  if (lane == 31) {
    off[G] = (int)min(incl, (long long)M);
    tile[G] = tincl;
  }
}

// The block's BM x BN output tile: C[i][j] = sum_k A(i,k) B(k,j) over the
// stages. A_COL: the A stage is stored k-major ([BK][BM + pad], the weight
// gradient's lhs^T); B_COL: the B stage is stored n-major ([BN][BK + pad],
// the transposed rhs).
template <typename T, bool A_COL, bool B_COL>
struct Tile;

// bf16: 8 warps as 2 (rows) x 4 (columns), 32 x 32 outputs each in 2 x 2
// WMMA fragments with fp32 accumulators.
template <bool A_COL, bool B_COL>
struct Tile<__nv_bfloat16, A_COL, B_COL> {
  using T = __nv_bfloat16;
  using ALayout = typename std::conditional<A_COL, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<B_COL, wmma::col_major,
                                            wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ __forceinline__ void mma(const T* sA, int lda, const T* sB,
                                      int ldb) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm + 16 * i;
        wmma::load_matrix_sync(a[i], A_COL ? sA + kk * lda + row
                                           : sA + row * lda + kk, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn + 16 * j;
        wmma::load_matrix_sync(b[j], B_COL ? sB + col * ldb + kk
                                           : sB + kk * ldb + col, ldb);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // rows r0 + i < rmax and columns c0 + j < cmax of out (leading
  // dimension ld), rounded once to bf16; 16-byte stores where ``vec``
  __device__ __forceinline__ void write(T* out, size_t ld, int r0, int c0,
                                        int rmax, int cmax, bool vec,
                                        float* scratch) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
    float* s = scratch + warp * 16 * 20;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(s, acc[i][j], 20, wmma::mem_row_major);
        __syncwarp();
        const int r = r0 + wm + 16 * i + lane / 2;
        const int c = c0 + wn + 16 * j + (lane % 2) * 8;
        const float* src = s + (lane / 2) * 20 + (lane % 2) * 8;
        if (r < rmax) {
          if (vec && c + 8 <= cmax) {
            uint4 v;
            __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
            for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(src[e]);
            *reinterpret_cast<uint4*>(out + r * ld + c) = v;
          } else {
            for (int e = 0; e < 8; ++e)
              if (c + e < cmax) out[r * ld + c + e] = __float2bfloat16(src[e]);
          }
        }
        __syncwarp();
      }
  }
};

// fp32: IEEE FFMA, each thread 4 x 8 outputs (rows ty + 16 i, columns
// tx + 16 j), summed in ascending k.
template <bool A_COL, bool B_COL>
struct Tile<float, A_COL, B_COL> {
  float acc[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* sA, int lda,
                                      const float* sB, int ldb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
        a[i] = A_COL ? sA[k * lda + row] : sA[row * lda + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        b[j] = B_COL ? sB[col * ldb + k] : sB[k * ldb + col];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void write(float* out, size_t ld, int r0,
                                        int c0, int rmax, int cmax, bool,
                                        float*) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r >= rmax) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < cmax) out[r * ld + c] = acc[i][j];
      }
    }
  }
};

// the bf16 epilogue's per-warp 16 x 16 fp32 staging (row stride 20)
template <typename T>
struct Scratch {
  static constexpr int FLOATS = 1;
};
template <>
struct Scratch<__nv_bfloat16> {
  static constexpr int FLOATS = (THREADS / 32) * 16 * 20;
};

// The forward's and the weight gradient's operand stages
template <typename T, bool TRANS>
struct FwdStages {
  using A = Stage<T, BM, BK>;
  using B = typename std::conditional<TRANS, Stage<T, BN, BK>,
                                      Stage<T, BK, BN>>::type;
};
template <typename T>
struct WgradStages {
  using A = Stage<T, BK, BM>;      // lhs rows x K columns: A k-major
  using B = Stage<T, BK, BN>;
};

// The main loop over ``stages`` reduction stages: a ring of S stages in
// dynamic shared memory, the copies of the next S - 1 in flight while
// one is multiplied. ``issue(ring_slot, s)`` copies stage s of both
// operands into its slot.
template <typename T, typename SA, typename SB, int S, typename TileT,
          typename Issue>
__device__ __forceinline__ void main_loop(T* ring, int stages, TileT& acc,
                                          Issue issue) {
  constexpr int STAGE = stage_elems<T, SA, SB>();
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < stages) issue(ring + s * STAGE, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<S - 2>();        // this thread's copies of stage s
    __syncthreads();               // everyone's; slot (s - 1) % S is free
    const int next = s + S - 1;
    if (next < stages) issue(ring + (next % S) * STAGE, next);
    cp_async_commit();
    const T* slot = ring + (s % S) * STAGE;
    acc.mma(slot, SA::LD, slot + SA::ELEMS, SB::LD);
  }
  cp_async_wait<0>();
}

// out (M,N) = lhs (M,K) by rhs[g] (K,N), or by rhs[g]^T with rhs[g]
// (N,K) when TRANS; grid (cdiv(M, BM) + G, cdiv(N, BN)).
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
ragged_dot_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                  const int* __restrict__ sizes, T* __restrict__ out, int M,
                  int K, int N, int G, int vec) {
  using SA = typename FwdStages<T, TRANS>::A;
  using SB = typename FwdStages<T, TRANS>::B;
  extern __shared__ __align__(128) unsigned char dynamic_smem[];
  T* ring = reinterpret_cast<T*>(dynamic_smem);
  __shared__ __align__(128) float scratch[Scratch<T>::FLOATS];
  __shared__ int off[MAX_GROUPS + 1];
  __shared__ int tile[MAX_GROUPS + 1];
  group_tables(sizes, G, M, off, tile);
  __syncthreads();

  const int t = blockIdx.x;
  int lo = 0, hi = G;              // the last g with tile[g] <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const int g = lo;
  const int n0 = blockIdx.y * BN;
  const int r0 = off[g] + (t - tile[g]) * BM;
  if (g == G) {                    // the zero tail past the groups
    if (r0 >= M) return;
    const T z = from_float<T>(0.f);
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = r0 + e / BN, c = n0 + e % BN;
      if (r < M && c < N) out[(size_t)r * N + c] = z;
    }
    return;
  }
  const int rend = off[g + 1];
  const T* w = rhs + (size_t)g * K * N;
  Tile<T, false, TRANS> acc;
  acc.zero();
  main_loop<T, SA, SB, Ring<T>::STAGES>(ring, (K + BK - 1) / BK, acc,
                                        [&](T* slot, int s) {
    const int k0 = s * BK;
    SA::copy(slot, lhs, K, r0, k0, rend, K, vec);
    if (TRANS) SB::copy(slot + SA::ELEMS, w, K, n0, k0, N, K, vec);
    else SB::copy(slot + SA::ELEMS, w, N, k0, n0, K, N, vec);
  });
  acc.write(out, N, r0, n0, rend, N, vec, scratch);
}

// out[g] (K,N) = lhs rows of group g (M_g,K) transposed by grad rows of
// group g (M_g,N); grid (cdiv(N, BN), cdiv(K, BM), G).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ragged_dot_wgrad_kernel(const T* __restrict__ lhs,
                        const T* __restrict__ grad,
                        const int* __restrict__ sizes, T* __restrict__ out,
                        int M, int K, int N, int G, int vec) {
  using SA = typename WgradStages<T>::A;
  using SB = typename WgradStages<T>::B;
  extern __shared__ __align__(128) unsigned char dynamic_smem[];
  T* ring = reinterpret_cast<T*>(dynamic_smem);
  __shared__ __align__(128) float scratch[Scratch<T>::FLOATS];
  __shared__ int off[MAX_GROUPS + 1];
  __shared__ int tile[MAX_GROUPS + 1];
  group_tables(sizes, G, M, off, tile);
  __syncthreads();

  const int g = blockIdx.z;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int rbeg = off[g], rend = off[g + 1];
  Tile<T, true, false> acc;
  acc.zero();
  main_loop<T, SA, SB, WGRAD_STAGES>(ring, (rend - rbeg + BK - 1) / BK, acc,
                                     [&](T* slot, int s) {
    const int r = rbeg + s * BK;
    SA::copy(slot, lhs, K, r, k0, rend, K, vec);
    SB::copy(slot + SA::ELEMS, grad, N, r, n0, rend, N, vec);
  });
  acc.write(out + (size_t)g * K * N, N, k0, n0, K, N, vec, scratch);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a kernel's dynamic shared memory limit raised to its ring
template <typename Kernel>
cudaError_t allow_ring(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, bool TRANS>
constexpr int fwd_ring_bytes() {
  return ring_bytes<T, typename FwdStages<T, TRANS>::A,
                    typename FwdStages<T, TRANS>::B, Ring<T>::STAGES>();
}
template <typename T>
constexpr int wgrad_ring_bytes() {
  return ring_bytes<T, typename WgradStages<T>::A,
                    typename WgradStages<T>::B, WGRAD_STAGES>();
}

template <typename T, bool TRANS>
cudaError_t launch_fwd(const void* lhs, const void* rhs, const void* sizes,
                       void* out, int M, int K, int N, int G, int vec,
                       dim3 grid, int smem, cudaStream_t st) {
  if (smem != fwd_ring_bytes<T, TRANS>()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_ring(ragged_dot_kernel<T, TRANS>, smem);
  if (err != cudaSuccess) return err;
  ragged_dot_kernel<T, TRANS><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<const int*>(sizes), static_cast<T*>(out), M, K, N, G, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* lhs, const void* grad,
                         const void* sizes, void* out, int M, int K, int N,
                         int G, int vec, dim3 grid, int smem,
                         cudaStream_t st) {
  if (smem != wgrad_ring_bytes<T>()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_ring(ragged_dot_wgrad_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ragged_dot_wgrad_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(grad),
      static_cast<const int*>(sizes), static_cast<T*>(out), M, K, N, G, vec);
  return cudaGetLastError();
}

}  // namespace

// lhs (M, K), rhs (G, K, N) (transpose_rhs: (G, N, K)), sizes (G,) int32,
// out (M, N), all fp32 (bf16 == 0) or all bf16, contiguous; on the grid
// kernels/ragged_dot.py's launch_args gives: gx = cdiv(M, 64) + G row
// tiles, gy = cdiv(N, 128) column tiles, ``block`` threads, ``smem``
// bytes of dynamic shared memory (the ring: 4 stages in bf16, 3 in fp32).
// Returns cudaGetLastError() after the launch, or a refusal before it
// when the geometry is not that or G is outside 1..1024.
extern "C" int ragged_dot(const void* lhs, const void* rhs, const void* sizes,
                          void* out, int M, int K, int N, int G, int bf16,
                          int transpose_rhs, int gx, int gy, int block,
                          int smem, void* stream) {
  if (G < 1 || G > MAX_GROUPS || gx != (M + BM - 1) / BM + G ||
      gy != (N + BN - 1) / BN || block != THREADS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = bf16 ? 8 : 4;
  const int vec = aligned16(lhs) && aligned16(rhs) && aligned16(out) &&
                  K % v == 0 && N % v == 0;
  const dim3 grid(gx, gy);
  cudaError_t err;
  if (bf16)
    err = transpose_rhs
              ? launch_fwd<__nv_bfloat16, true>(lhs, rhs, sizes, out, M, K, N,
                                                G, vec, grid, smem, st)
              : launch_fwd<__nv_bfloat16, false>(lhs, rhs, sizes, out, M, K,
                                                 N, G, vec, grid, smem, st);
  else
    err = transpose_rhs
              ? launch_fwd<float, true>(lhs, rhs, sizes, out, M, K, N, G, vec,
                                        grid, smem, st)
              : launch_fwd<float, false>(lhs, rhs, sizes, out, M, K, N, G,
                                         vec, grid, smem, st);
  return static_cast<int>(err);
}

// lhs (M, K), grad (M, N), sizes (G,) int32, out (G, K, N), all fp32
// (bf16 == 0) or all bf16, contiguous; on the grid launch_args of the
// weight gradient gives: (cdiv(N, 128), cdiv(K, 64), G) blocks of
// ``block`` threads, ``smem`` bytes of dynamic shared memory (the ring of
// 2 stages).
extern "C" int ragged_dot_wgrad(const void* lhs, const void* grad,
                                const void* sizes, void* out, int M, int K,
                                int N, int G, int bf16, int gx, int gy,
                                int gz, int block, int smem, void* stream) {
  if (G < 1 || G > MAX_GROUPS || gx != (N + BN - 1) / BN ||
      gy != (K + BM - 1) / BM || gz != G || block != THREADS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = bf16 ? 8 : 4;
  const int vec = aligned16(lhs) && aligned16(grad) && aligned16(out) &&
                  K % v == 0 && N % v == 0;
  const dim3 grid(gx, gy, gz);
  const cudaError_t err =
      bf16 ? launch_wgrad<__nv_bfloat16>(lhs, grad, sizes, out, M, K, N, G,
                                         vec, grid, smem, st)
           : launch_wgrad<float>(lhs, grad, sizes, out, M, K, N, G, vec, grid,
                                 smem, st);
  return static_cast<int>(err);
}
