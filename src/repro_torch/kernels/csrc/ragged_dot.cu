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
// end. Here fp32 runs on IEEE FFMA (never TF32), bf16 on the tensor cores.
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
// the products are 2 M K N flops, 60 GFLOP at mixtral's 512 prefill rows
// (~0.06 ms at the bf16 peak), 240 GFLOP at its 2048 train rows (~0.24
// ms, level with the bytes).
//
// Three routes, chosen by shape in kernels/ragged_dot.py, each with its
// own C entry points and launch counters; two are in this file. The
// third, fp32 at K and N multiples of 4 (every published MoE width), is
// csrc/ragged_dot_tf32.cu: 3xTF32 on wgmma. It is a design of its own
// because TF32 wgmma takes both shared-memory operands K-major only (the
// transpose bits below exist for 16-bit types alone), so the forward
// there takes the weights as wgmma's A from registers (split into hi/lo
// there, never in HBM, whose bytes bound the forward) and the weight
// gradient splits its activations ahead into transposed planes.
//
// The Hopper route (bf16, K and N multiples of 8, every operand 16-byte
// aligned: every published MoE width), ragged_dot_tma and
// ragged_dot_wgrad_tma:
//   * operands through TMA: one producer thread (its warpgroup after
//     setmaxnreg down to 40 registers) keeps a ring of TMA_STAGES 48 KB
//     stages full, each BK = 64 deep (one 128-byte swizzle row of bf16),
//     completed on mbarriers. The tensor maps are encoded on the host
//     from shapes alone (no group size): lhs and grad 2-D over (M, .),
//     rhs 3-D over (G, K, N) (the input gradient's (G, N, K)), so a box
//     past K or N reads zeros inside its own expert; a box wholly past K
//     or N is not loaded;
//   * two consumer warpgroups run wgmma m64n256k16 (bf16, fp32
//     accumulators) on their 64-row halves of a 128 x 256 tile, straight
//     from the swizzled stages: the forward reads rhs N-major (transposed
//     B), the input gradient K-major, the weight gradient lhs M-major
//     (transposed A) and grad N-major; one wgmma group stays in flight
//     while the next stage's is issued;
//   * persistent blocks, one an SM: each builds the group tables once and
//     walks a linear tile index. The forward's tiles are (each group's
//     row tiles, the zero tail as one more group) x cdiv(N, 256) column
//     tiles, at most (cdiv(M, 128) + G) x cdiv(N, 256) (the host's bound),
//     ordered group, column, row tile, so one group's row tiles at one
//     column tile run side by side and each weight tile leaves HBM once;
//     the weight gradient's are G x cdiv(K, 128) x cdiv(N, 256). The
//     producer runs on into the next tile while the consumers store;
//   * the epilogue stores from registers: the four lanes of a row swap
//     bf16 pairs with shuffles so each stores 16 bytes. A forward tile's
//     rows of the next group are multiplied but never stored (the stores
//     are predicated on the group's last row; a warpgroup whose rows all
//     lie past it skips its products); the zero tail is written 0. The
//     weight gradient sums a group's rows from its first row on, so only
//     its last stage can hold the next group's rows: those rows of both
//     operands are zeroed in shared memory (then fence.proxy.async)
//     before the wgmma; an empty group stores 0;
//   * numerics as the first route's: bf16 in, fp32 sums, one
//     round-to-nearest-even at the end.
// Measured (PERF.md §6): at mixtral-8x7b's prefill and deepseek-v2's
// the forward streams the weights at 85-90 % of the bytes bound; at
// mixtral's 2048 train rows it stays above both bounds: groups of 257-274
// rows take a third, nearly empty row tile, and loads and products, each
// ~0.4 ms alone, overlap only in part.
//
// The first route (fp32 at odd shapes on IEEE FFMA, never TF32, and bf16
// at odd shapes on WMMA 16x16x16), ragged_dot and ragged_dot_wgrad:
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
#include <cuda.h>
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

// The groups' first rows (clamped to M) and first row tiles of ROWS rows,
// in shared memory: off[g], tile[g] for g <= G + 1 (off[G] = min(sum, M),
// tile[G] the groups' tiles; the zero tail as one more group: off[G + 1]
// = M, tile[G + 1] all tiles). One warp; each lane takes cdiv(G, 32)
// groups in a row.
template <int ROWS>
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
    tiles += (int)((b - a + ROWS - 1) / ROWS);
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
    t += (int)((b - a + ROWS - 1) / ROWS);
  }
  if (lane == 31) {
    const int sum = (int)min(incl, (long long)M);
    off[G] = sum;
    tile[G] = tincl;
    off[G + 1] = M;
    tile[G + 1] = tincl + (M - sum + ROWS - 1) / ROWS;
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
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  group_tables<BM>(sizes, G, M, off, tile);
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
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  group_tables<BM>(sizes, G, M, off, tile);
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

// ==================================================== the Hopper route

constexpr int TMA_BM = 128;       // rows a tile: two consumer warpgroups
constexpr int TMA_BN = 256;       // columns a tile: one m64n256k16 each
constexpr int TMA_BK = 64;        // depth a stage: one 128-byte swizzle row
constexpr int TMA_STAGES = 4;     // the ring
constexpr int TMA_CONSUMERS = 2;  // warpgroups running wgmma
constexpr int TMA_THREADS = 384;  // the producer's warpgroup + consumers
constexpr int BOX = 64;           // a TMA box edge: 64 x 64 bf16, 8 KB
constexpr uint32_t BOX_BYTES = BOX * BOX * 2;
constexpr uint32_t A_BYTES = TMA_BM * TMA_BK * 2;        // 16 KB
constexpr uint32_t B_BYTES = TMA_BK * TMA_BN * 2;        // 32 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;      // 48 KB
// the ring and 1024 bytes to align the swizzled tiles
constexpr int TMA_SMEM = 197632;
static_assert(TMA_THREADS == 128 * (1 + TMA_CONSUMERS), "one producer");
static_assert(TMA_BM == 64 * TMA_CONSUMERS, "m64 a consumer");
static_assert(TMA_SMEM == TMA_STAGES * STAGE_BYTES + 1024,
              "the dynamic shared memory");
static_assert(TMA_BK == BOX && TMA_BN % BOX == 0, "whole boxes");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0, c1[, c2]), innermost first, of map into
// dst, completing on bar; boxes past the tensor read zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
// a barrier of ``count`` threads (the consumers' own, not __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (the wgmma operands)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptors of tiles written by TMA with the
// 128-byte swizzle, on 1024-byte boundaries (base offset 0):
// K-major: rows of 64 k (128 bytes), 8-row groups 1024 bytes apart (SBO),
// the leading offset unused (1)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// MN-major: 64 boxes of 64 MN x 64 k, each k row 128 bytes; the next 8 k
// rows 1024 bytes on (SBO), the next 64 MN one box on (LBO)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(BOX_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A (64 x 16) * B (16 x 256), bf16 in, fp32 accumulators (scale_d
// == 0 overwrites d); TA / TB: A / B read MN-major from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to d across the async wgmmas
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One stage of four k16 steps on this warpgroup's 64 rows: A and B from
// their descriptors' starts, a k16 step 32 bytes on along a K-major row
// or 16 rows (2048 bytes) on in an MN-major box.
template <int TA, int TB>
__device__ __forceinline__ void stage_mma(float (&acc)[128], uint32_t a,
                                          uint32_t b, bool first) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TMA_BK / 16; ++kk) {
    const uint64_t da = TA ? desc_mn(a + kk * 2048) : desc_k(a + kk * 32);
    const uint64_t db = TB ? desc_mn(b + kk * 2048) : desc_k(b + kk * 32);
    wgmma_m64n256k16<TA, TB>(acc, da, db, (first && kk == 0) ? 0 : 1);
  }
  wgmma_commit();
  fence_acc(acc);
}

// The consumers' ring: wait for a stage, run ``mma`` on it (or not, for a
// warpgroup with nothing to compute), and hand the stage before it back
// to the producer once its products are done (one wgmma group stays in
// flight). ``finish`` waits for the last and hands it back.
struct ConsumerRing {
  uint64_t* full;
  uint64_t* empty;
  int it = 0;       // stages consumed by this warpgroup so far
  bool leader;      // the warpgroup's thread that arrives on ``empty``

  __device__ __forceinline__ int wait() {
    const int slot = it % TMA_STAGES;
    bar_wait(&full[slot], (it / TMA_STAGES) & 1);
    return slot;
  }
  // after this stage's wgmma group was committed (``issued``), or not
  __device__ __forceinline__ void release(int s, bool issued) {
    if (issued) {
      wgmma_wait<1>();
      if (s > 0 && leader) bar_arrive(&empty[(it - 1) % TMA_STAGES]);
    } else if (leader) {
      bar_arrive(&empty[it % TMA_STAGES]);
    }
    ++it;
  }
  __device__ __forceinline__ void finish(float (&acc)[128], int stages,
                                         bool issued) {
    if (!issued || stages == 0) return;
    wgmma_wait<0>();
    fence_acc(acc);
    if (leader) bar_arrive(&empty[(it - 1) % TMA_STAGES]);
  }
};

// The producer's ring: the next slot, once the consumers have handed it
// back, armed for the stage's ``bytes`` (boxes wholly past K or N are not
// loaded: what their slots hold reaches only outputs never stored).
struct ProducerRing {
  uint64_t* full;
  uint64_t* empty;
  int it = 0;

  __device__ __forceinline__ int next(uint32_t bytes) {
    const int slot = it % TMA_STAGES;
    if (it >= TMA_STAGES) bar_wait(&empty[slot], ((it / TMA_STAGES) - 1) & 1);
    bar_expect(&full[slot], bytes);
    ++it;
    return slot;
  }
};

// boxes of BOX columns from c0 that start below extent, of ``count``
__device__ __forceinline__ int boxes_in(int c0, int extent, int count) {
  return min(count, (extent - c0 + BOX - 1) / BOX);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator fragment of a warpgroup's 64 x 256 tile, rounded once to
// bf16 and stored 16 bytes a lane: acc[4j + 2h + e] is row 16 warp +
// lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e, so the four lanes of a
// row hold two columns of each 8; they swap them (a 4 x 4 transpose of
// bf16 pairs in two shuffle rounds) until lane q holds columns
// 8 (4 J + q) .. + 7. Rows from ``rend`` on and columns from ``cols`` on
// are not stored (a forward tile's rows of the next group, the edges).
__device__ __forceinline__ void store_tile(const float (&acc)[128],
                                           __nv_bfloat16* out, size_t ld,
                                           int row0, int rend, int col0,
                                           int cols) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  const bool hi = q & 2, odd = q & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int J = 0; J < TMA_BN / 32; ++J) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = bf16x2(acc[4 * (4 * J + i) + 2 * h],
                      acc[4 * (4 * J + i) + 2 * h + 1]);
      // lanes two apart swap the halves of w the other's row needs
      uint32_t s0 = hi ? w[0] : w[2], s1 = hi ? w[1] : w[3];
      s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
      if (hi) { w[0] = s0; w[1] = s1; } else { w[2] = s0; w[3] = s1; }
      // then neighbours swap one pair of each half
      uint32_t u0 = odd ? w[0] : w[1], u1 = odd ? w[2] : w[3];
      u0 = __shfl_xor_sync(0xffffffffu, u0, 1);
      u1 = __shfl_xor_sync(0xffffffffu, u1, 1);
      if (odd) { w[0] = u0; w[2] = u1; } else { w[1] = u0; w[3] = u1; }
      const int col = col0 + 8 * (4 * J + q);
      if (row < rend && col < cols)
        *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
}

// The forward's tile t of the walk: group g (G: the zero tail), its rows
// [r0, r0 + TMA_BM) of which those below rend are stored, columns from n0.
// Tiles run group by group, in a group column tile by column tile, in a
// column tile row tile by row tile (kernels/ragged_dot.py's tma_walk).
struct FwdTile {
  int g, r0, rend, n0;
};
__device__ __forceinline__ FwdTile fwd_tile(int t, int G, int ncol,
                                            const int* off, const int* tile) {
  int lo = 0, hi = G;              // the last g with tile[g] ncol <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile[mid] * ncol <= t) lo = mid; else hi = mid - 1;
  }
  const int local = t - tile[lo] * ncol;
  const int rows = tile[lo + 1] - tile[lo];
  return {lo, off[lo] + (local % rows) * TMA_BM, off[lo + 1],
          (local / rows) * TMA_BN};
}

// out (M,N) = lhs (M,K) by rhs[g] (K,N), or by rhs[g]^T with rhs[g] (N,K)
// when TRANS; lhs_map 2-D over (M, K), boxes of 64 k x 128 rows; rhs_map
// 3-D over (G, K, N) in 64 x 64 boxes, or over (G, N, K) in 64 k x 256 n
// boxes when TRANS. A persistent grid of the caller's size.
template <bool TRANS>
__global__ void __launch_bounds__(TMA_THREADS, 1)
ragged_dot_tma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                      const __grid_constant__ CUtensorMap rhs_map,
                      const int* __restrict__ sizes,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N,
                      int G) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[TMA_STAGES];
  __shared__ __align__(8) uint64_t empty[TMA_STAGES];
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  group_tables<TMA_BM>(sizes, G, M, off, tile);
  if (threadIdx.x == 32) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], TMA_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int ncol = (N + TMA_BN - 1) / TMA_BN;
  const int stages = (K + TMA_BK - 1) / TMA_BK;
  const int total = tile[G + 1] * ncol;

  if (threadIdx.x < 128) {         // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      ProducerRing ring{full, empty};
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const FwdTile f = fwd_tile(t, G, ncol, off, tile);
        if (f.g == G) continue;    // the zero tail reads nothing
        const int nb = TRANS ? 0 : boxes_in(f.n0, N, TMA_BN / BOX);
        const uint32_t bytes = A_BYTES + (TRANS ? B_BYTES : nb * BOX_BYTES);
        for (int s = 0; s < stages; ++s) {
          const int slot = ring.next(bytes);
          unsigned char* st = smem + slot * STAGE_BYTES;
          const int k0 = s * TMA_BK;
          tma_load(st, &lhs_map, &full[slot], k0, f.r0);
          if (TRANS)
            tma_load(st + A_BYTES, &rhs_map, &full[slot], k0, f.n0, f.g);
          for (int b = 0; b < nb; ++b)
            tma_load(st + A_BYTES + b * BOX_BYTES, &rhs_map, &full[slot],
                     f.n0 + b * BOX, k0, f.g);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int c = threadIdx.x / 128 - 1;   // this warpgroup's 64-row half
  ConsumerRing ring{full, empty, 0, threadIdx.x % 128 == 0};
  float acc[128];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const FwdTile f = fwd_tile(t, G, ncol, off, tile);
    const int row0 = f.r0 + 64 * c;      // this warpgroup's first row
    const bool active = row0 < f.rend;
    const int my_stages = f.g == G ? 0 : stages;
    if (my_stages == 0) zero_acc(acc);
    for (int s = 0; s < my_stages; ++s) {
      const int slot = ring.wait();
      if (active) {
        const uint32_t st = smem_u32(smem + slot * STAGE_BYTES);
        stage_mma<0, TRANS ? 0 : 1>(acc, st + c * (A_BYTES / 2),
                                    st + A_BYTES, s == 0);
      }
      ring.release(s, active);
    }
    ring.finish(acc, my_stages, active);
    if (active) store_tile(acc, out, N, row0, f.rend, f.n0, N);
  }
}

// out (G,K,N), out[g] = lhs rows of group g transposed by its grad rows;
// lhs_map 2-D over (M, K) and grad_map over (M, N), 64 x 64 boxes. A
// persistent grid of the caller's size walks G x cdiv(K, TMA_BM) x
// cdiv(N, TMA_BN) tiles.
__global__ void __launch_bounds__(TMA_THREADS, 1)
ragged_dot_wgrad_tma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                            const __grid_constant__ CUtensorMap grad_map,
                            const int* __restrict__ sizes,
                            __nv_bfloat16* __restrict__ out, int M, int K,
                            int N, int G) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[TMA_STAGES];
  __shared__ __align__(8) uint64_t empty[TMA_STAGES];
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  group_tables<BOX>(sizes, G, M, off, tile);
  if (threadIdx.x == 32) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], TMA_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nk = (K + TMA_BM - 1) / TMA_BM, nn = (N + TMA_BN - 1) / TMA_BN;
  const int per_group = nk * nn;
  const int total = G * per_group;

  if (threadIdx.x < 128) {         // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      ProducerRing ring{full, empty};
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int g = t / per_group, local = t % per_group;
        const int k0 = (local / nn) * TMA_BM, n0 = (local % nn) * TMA_BN;
        const int rbeg = off[g], rend = off[g + 1];
        const int na = boxes_in(k0, K, TMA_CONSUMERS);
        const int nb = boxes_in(n0, N, TMA_BN / BOX);
        for (int r = rbeg; r < rend; r += TMA_BK) {
          const int slot = ring.next((na + nb) * BOX_BYTES);
          unsigned char* st = smem + slot * STAGE_BYTES;
          for (int w = 0; w < na; ++w)
            tma_load(st + w * BOX_BYTES, &lhs_map, &full[slot], k0 + w * BOX,
                     r);
          for (int b = 0; b < nb; ++b)
            tma_load(st + A_BYTES + b * BOX_BYTES, &grad_map, &full[slot],
                     n0 + b * BOX, r);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int c = threadIdx.x / 128 - 1;   // this warpgroup's 64 rows of K
  const int t128 = threadIdx.x % 128;
  ConsumerRing ring{full, empty, 0, t128 == 0};
  float acc[128];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int g = t / per_group, local = t % per_group;
    const int k0 = (local / nn) * TMA_BM, n0 = (local % nn) * TMA_BN;
    const int rbeg = off[g], rend = off[g + 1];
    const int my_stages = (rend - rbeg + TMA_BK - 1) / TMA_BK;
    const bool active = k0 + BOX * c < K;
    if (my_stages == 0) zero_acc(acc);
    for (int s = 0; s < my_stages; ++s) {
      const int slot = ring.wait();
      unsigned char* st = smem + slot * STAGE_BYTES;
      const int valid = rend - (rbeg + s * TMA_BK);
      if (valid < TMA_BK) {
        // the group's last stage: rows from ``valid`` on are the next
        // group's (or past M: TMA's zeros); zero them in this warpgroup's
        // lhs box and in half of grad's boxes, then both warpgroups meet
        constexpr int PER_BOX = BOX_BYTES / 16;      // 16-byte chunks
        const int from = valid * (BOX * 2 / 16);
        for (int q = from + t128; q < PER_BOX; q += 128) {
          const uint4 z = make_uint4(0, 0, 0, 0);
          reinterpret_cast<uint4*>(st + c * BOX_BYTES)[q] = z;
#pragma unroll
          for (int b = 0; b < TMA_BN / BOX / TMA_CONSUMERS; ++b)
            reinterpret_cast<uint4*>(
                st + A_BYTES +
                (c * (TMA_BN / BOX / TMA_CONSUMERS) + b) * BOX_BYTES)[q] = z;
        }
        fence_async_smem();
        named_sync(3, 128 * TMA_CONSUMERS);
      }
      if (active) {
        const uint32_t a = smem_u32(st);
        stage_mma<1, 1>(acc, a + c * BOX_BYTES, a + A_BYTES, s == 0);
      }
      ring.release(s, active);
    }
    ring.finish(acc, my_stages, active);
    if (active)
      store_tile(acc, out + (size_t)g * K * N, N, k0 + BOX * c, K, n0, N);
  }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, fetched through the runtime (no
// link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 tensor of ``rank`` dims (innermost first, each row a
// multiple of 16 bytes), read in ``box`` boxes with the 128-byte swizzle;
// what lies past the tensor reads as zeros
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int rank, const uint64_t* dims, const uint32_t* box) {
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3], elem[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    stride *= dims[i];
    if (i + 1 < rank) strides[i] = stride;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), d, strides, b, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The Hopper route's terms: bf16 operands whose rows are whole 16-byte
// multiples (K, N % 8 == 0), 16-byte aligned, at most MAX_GROUPS groups;
// a persistent grid of 1..``tiles`` blocks (none past the last tile) of
// TMA_THREADS threads with TMA_SMEM bytes of dynamic shared memory.
cudaError_t tma_terms(const void* a, const void* b, const void* c, int M,
                      int K, int N, int G, long long tiles, int grid,
                      int block, int smem) {
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 8 || G < 1 ||
      G > MAX_GROUPS || !aligned16(a) || !aligned16(b) || !aligned16(c))
    return cudaErrorInvalidValue;
  if (tiles > 0x7FFFFFFF || grid < 1 || grid > tiles ||
      block != TMA_THREADS || smem != TMA_SMEM)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <bool TRANS>
cudaError_t launch_fwd_tma(const void* lhs, const void* rhs,
                           const void* sizes, void* out, int M, int K, int N,
                           int G, int grid, cudaStream_t st) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap lhs_map, rhs_map;
  const uint64_t lhs_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint32_t lhs_box[2] = {TMA_BK, TMA_BM};
  const uint64_t rhs_dims[3] = {(uint64_t)(TRANS ? K : N),
                                (uint64_t)(TRANS ? N : K), (uint64_t)G};
  const uint32_t rhs_box[3] = {BOX, TRANS ? TMA_BN : TMA_BK, 1};
  if (!bf16_map(encode, &lhs_map, lhs, 2, lhs_dims, lhs_box) ||
      !bf16_map(encode, &rhs_map, rhs, 3, rhs_dims, rhs_box))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_ring(ragged_dot_tma_kernel<TRANS>, TMA_SMEM);
  if (err != cudaSuccess) return err;
  ragged_dot_tma_kernel<TRANS><<<grid, TMA_THREADS, TMA_SMEM, st>>>(
      lhs_map, rhs_map, static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), M, K, N, G);
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

// The Hopper route of ragged_dot: lhs (M, K), rhs (G, K, N)
// (transpose_rhs: (G, N, K)), sizes (G,) int32, out (M, N), all bf16,
// contiguous, K and N multiples of 8, 16-byte aligned; ``grid``
// persistent blocks (kernels/ragged_dot.py's tma_args: at most one an SM
// and at most (cdiv(M, 128) + G) x cdiv(N, 256), the tiles' upper bound)
// of ``block`` = 384 threads with ``smem`` = TMA_SMEM bytes of dynamic
// shared memory. Returns cudaGetLastError() after the launch, or a
// refusal before it.
extern "C" int ragged_dot_tma(const void* lhs, const void* rhs,
                              const void* sizes, void* out, int M, int K,
                              int N, int G, int transpose_rhs, int grid,
                              int block, int smem, void* stream) {
  const long long tiles = ((long long)(M + TMA_BM - 1) / TMA_BM + G) *
                          ((N + TMA_BN - 1) / TMA_BN);
  cudaError_t err =
      tma_terms(lhs, rhs, out, M, K, N, G, tiles, grid, block, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = transpose_rhs
            ? launch_fwd_tma<true>(lhs, rhs, sizes, out, M, K, N, G, grid, st)
            : launch_fwd_tma<false>(lhs, rhs, sizes, out, M, K, N, G, grid,
                                    st);
  return static_cast<int>(err);
}

// The Hopper route of ragged_dot_wgrad: lhs (M, K), grad (M, N), sizes
// (G,) int32, out (G, K, N), all bf16, contiguous, K and N multiples of
// 8, 16-byte aligned; ``grid`` persistent blocks (tma_wgrad_args: at most
// one an SM and at most G x cdiv(K, 128) x cdiv(N, 256) tiles) of
// ``block`` = 384 threads with ``smem`` = TMA_SMEM bytes.
extern "C" int ragged_dot_wgrad_tma(const void* lhs, const void* grad,
                                    const void* sizes, void* out, int M,
                                    int K, int N, int G, int grid, int block,
                                    int smem, void* stream) {
  const long long tiles = (long long)G * ((K + TMA_BM - 1) / TMA_BM) *
                          ((N + TMA_BN - 1) / TMA_BN);
  cudaError_t err =
      tma_terms(lhs, grad, out, M, K, N, G, tiles, grid, block, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap lhs_map, grad_map;
  const uint64_t lhs_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t grad_dims[2] = {(uint64_t)N, (uint64_t)M};
  const uint32_t box[2] = {BOX, BOX};
  if (!bf16_map(encode, &lhs_map, lhs, 2, lhs_dims, box) ||
      !bf16_map(encode, &grad_map, grad, 2, grad_dims, box))
    return static_cast<int>(cudaErrorInvalidValue);
  err = allow_ring(ragged_dot_wgrad_tma_kernel, TMA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_dot_wgrad_tma_kernel<<<grid, TMA_THREADS, TMA_SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
      lhs_map, grad_map, static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
