// The grouped product's fp32 route on Hopper: jax.lax.ragged_dot and its
// weight gradient in 3xTF32 on wgmma, fed by TMA rings. The interface and
// the semantics are csrc/ragged_dot.cu's (its header says what the two
// products compute); this source holds the route kernels/ragged_dot.py
// takes for fp32 operands whose K and N are multiples of 4 and whose
// operands are 16-byte aligned (every published MoE width).
//
// Replaces: no Pallas kernel (jax.lax.ragged_dot is one XLA op of the
// reference's moe_dropless_forward, src/repro/models/ffn.py:151); it
// takes fp32 off ragged_dot.cu's first route, whose IEEE FFMA tile ran at
// 31-48 % of the 67 TFLOP/s FFMA bound and lost to torch._grouped_mm.
//
// Bound on this card. 3xTF32 is three TF32 products (hi hi + hi lo +
// lo hi; lo lo, ~2^-22 of a term, dropped), 3 x 2 M K N flops at 495
// TFLOP/s: 0.364 ms at mixtral-8x7b's 512 prefill rows, 1.458 ms at its
// 2048 train rows. The forward reads every expert's weights once, 1.88
// GB at mixtral's widths, 5.0 GB at deepseek-v2-236b's: 0.57 and 1.5 ms
// at 3.35 TB/s, so at prefill it is bound by bytes; the weight gradient
// at 2048 rows by operations.
//
// Why this shape. TF32 wgmma takes both shared-memory operands K-major
// only: the transpose bits exist for 16-bit types alone, so the bf16
// route's in-place transposed reads (rhs N-major in the forward, lhs
// M-major and grad N-major in the weight gradient) do not carry over.
// Splitting the weights into hi/lo planes in HBM would triple the bytes
// the forward is bound by. So:
//
// ragged_dot_tf32 (forward; the input gradient is the same kernel on rhs
// read transposed) computes each tile transposed, out^T = W[g]^T lhs^T:
//   * A, wgmma's 64 rows, is 64 output columns of the expert's weights:
//     its fp32 tile TMA-loaded into the ring as it lies in HBM (rhs
//     (G,K,N) in four 32 n x 32 k boxes; the input gradient's (G,N,K) in
//     one 128 n x 32 k box; 128-byte swizzle), read from shared memory
//     into registers in the order the register fragment needs and split
//     there, hi = tf32(x), lo = tf32(x - hi). The weights' read keeps
//     bank conflicts off: in the (K,N) layout a warp's rows are taken
//     as n = 32 (w/2) + 4 (w%2) + (l/4)%4 + 16 (l/16) + 8 h, a
//     permutation of the tile's rows that the epilogue undoes, so the 32
//     lanes of each load hit 32 banks through the swizzle; the (N,K)
//     layout needs none;
//   * B, wgmma's N, is the group's rows of lhs, K-major from hi/lo planes
//     (2, M, Kp) that B1's split pass writes (pairwise_kl.cu's
//     pairwise_kl_split in its B-side mode; 8 MB of lhs at 512 rows,
//     ~0.01 ms): a tile takes up to 144 rows of one group, rounded up to 16,
//     as one to three wgmma of n128, n64, n32, n16 over slices of one
//     accumulator. A deepseek-v2 group of ~10 rows costs an n16 product,
//     not a 128-row one; a mixtral prefill group of 57-72 rows one of 64
//     or 80; its train groups of 257-274 rows two tiles (144 rows and
//     113-130), where 128-row tiles took three, the third of 1-18 rows
//     reading the whole weight tile again. The running sum and the fresh
//     accumulator take 72 registers each at 144 rows, which fit beside
//     the 32 of the split fragments under setmaxnreg's 232;
//   * tiles: (group, 128 output columns, 144-row row tile), walked as the
//     bf16 route walks them (group, column tile, row tile; the zero tail
//     past sum(sizes) as one more group, stored 0), so one weight tile's
//     row tiles run side by side and each weight tile leaves HBM once;
//     persistent blocks, one an SM; rows of the next group in a tile are
//     multiplied and never stored.
// ragged_dot_wgrad_tf32 (weight gradient) is bound by operations and its
// operands are activations, so both are split ahead, transposed:
//   * ragged_dot_wgrad_tf32_split writes lhs (M,K) as lhs^T planes
//     (2, K, Mpad) and grad (M,N) as grad^T planes (2, N, Mpad), one
//     launch (z picks the operand), each group's rows starting on a
//     32-column boundary and its last stage padded with zeros: group g
//     takes columns [32 T(g), 32 T(g) + len(g)), T(g) its first 32-row
//     tile (Mpad = 32 (cdiv(M, 32) + G) bounds them without the sizes).
//     So no stage of the product holds a foreign row and nothing is
//     zeroed in shared memory;
//   * a grouped 3xTF32 product over each group's stages, both operands
//     K-major straight from the swizzled stages (B1's GEMM, pairwise_kl.cu,
//     walked over groups): 128 x 128 tiles of out[g], persistent blocks
//     walking G x cdiv(K, 128) x cdiv(N, 128); an empty group stores 0.
//     Each warp stages its part of a finished tile through shared memory
//     (16 x 32 at a time) so its stores write whole 128-byte rows, as
//     streaming stores (st.global.cs: the gradient is not read again
//     here, and the planes keep the L2).
// Both products: one producer thread (its warpgroup after setmaxnreg down
// to 40 registers) keeps the ring full (the forward's 4 stages of 52 KB,
// the weight gradient's 3 of 64 KB), completed on mbarriers; two consumer
// warpgroups run wgmma .tf32 on their 64-row halves. Numerics as B1's
// (pairwise_kl.cu): tf32() rounds to nearest, ties away; each 32-deep
// stage's 12 products (4 k8 steps x 3) go into a fresh accumulator, added
// with round-to-nearest into a running fp32 sum (the tensor core's adds
// truncate; the input gradient's depth is 14336); one rounding at the
// end; no split-K and no atomics, so every run gives the same result.
// No group size is read on the host: the grids are the bounds above.
// Measured (PERF.md §6; an H100 80GB HBM3 at 700 W): mixtral-8x7b's
// prefill forward 0.84 ms (68 % of its bytes bound), deepseek-v2's 1.69
// (90 %); at mixtral's 2048 train rows the forward, input and weight
// gradients 2.55-2.66 ms (55-57 % of the operations bound), held by L2
// traffic (every lhs stage is read by each column tile); deepseek-v2's
// weight gradient 2.53 (60 % of its bytes bound), its stores not
// overlapping the next tile.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int MAX_GROUPS = 1024;  // the group tables live in shared memory
constexpr int BK = 32;            // k a stage: one 128-byte swizzle row
constexpr int THREADS = 384;      // a producer warpgroup and two consumers
constexpr int CONSUMERS = 2;
// the forward
constexpr int FWD_BN = 128;       // output columns a tile, 64 a consumer
constexpr int FWD_BR = 144;       // lhs rows a tile at most (wgmma N)
constexpr int ROW_STEP = 16;      // a tile's rows rounded up to this
constexpr int FWD_STAGES = 4;
constexpr uint32_t W_BOX = 32 * BK * 4;            // 32 x 32 fp32, 4 KB
constexpr uint32_t W_BYTES = FWD_BN * BK * 4;      // 16 KB
constexpr uint32_t L_BYTES = FWD_BR * BK * 4;      // 18 KB a plane
constexpr uint32_t ROW_BOX = ROW_STEP * BK * 4;    // 2 KB
constexpr uint32_t FWD_STAGE_BYTES = W_BYTES + 2 * L_BYTES;  // 52 KB
constexpr int FWD_SMEM = 214016;  // the ring and 1024 bytes to align it
// the weight gradient
constexpr int WG_BM = 128;        // rows of K a tile, 64 a consumer
constexpr int WG_BN = 128;        // columns of N a tile (wgmma N)
constexpr int WG_STAGES = 3;
constexpr uint32_t PLANE_TILE = 128 * BK * 4;      // 16 KB
constexpr uint32_t WG_STAGE_BYTES = 4 * PLANE_TILE;  // 64 KB
constexpr int WG_SMEM = 197632;
// the weight gradient's epilogue: each consumer warp stages 16 rows x 32
// columns of its tile at a time, rows OUT_LD floats apart
constexpr int OUT_LD = 40;
// the transposing split's 32 x 64 tiles
constexpr int TN = 32;            // padded columns (rows of lhs) a tile
constexpr int TJ = 64;            // columns of the operand a tile
constexpr int SPLIT_T_THREADS = 256;

// Diagnostic copies (chip_smoke.py --ragged-variants fp32 builds one with
// each defined, to see which part holds the route; the build defines
// none): RAGGED_TF32_NO_PRODUCTS turns every wgmma into a PTX comment,
// RAGGED_TF32_NO_LOADS issues no TMA load (the ring armed for 0 bytes),
// RAGGED_TF32_NO_STORES stores no output, RAGGED_TF32_NO_SPLIT leaves
// the transposing split's planes unwritten.
#ifdef RAGGED_TF32_NO_PRODUCTS
#define WGMMA_TF32(shape) "// wgmma.mma_async.sync.aligned." shape \
                          ".f32.tf32.tf32 "
#else
#define WGMMA_TF32(shape) "wgmma.mma_async.sync.aligned." shape \
                          ".f32.tf32.tf32 "
#endif
#ifdef RAGGED_TF32_NO_LOADS
constexpr bool LOADS = false;
#else
constexpr bool LOADS = true;
#endif
#ifdef RAGGED_TF32_NO_STORES
constexpr bool STORES = false;
#else
constexpr bool STORES = true;
#endif
#ifdef RAGGED_TF32_NO_SPLIT
constexpr bool SPLIT = false;
#else
constexpr bool SPLIT = true;
#endif

static_assert(THREADS == 128 * (1 + CONSUMERS), "one producer warpgroup");
static_assert(FWD_BN == 64 * CONSUMERS && WG_BM == 64 * CONSUMERS,
              "m64 a consumer");
static_assert(FWD_SMEM == FWD_STAGES * FWD_STAGE_BYTES + 1024, "the ring");
static_assert(WG_SMEM == WG_STAGES * WG_STAGE_BYTES + 1024, "the ring");
static_assert(BK * 4 == 128, "a stage row is one 128-byte swizzle row");
static_assert(FWD_BR % ROW_STEP == 0 && FWD_BR / ROW_STEP == 9,
              "nine row steps: n16 .. n144");
static_assert(TN == BK, "a padded group is whole stages");
static_assert(SPLIT_T_THREADS == 16 * (TN / 2) &&
              SPLIT_T_THREADS == 8 * (TJ / 2), "the transposing tile");

// x rounded to TF32, to nearest with ties away from zero; low bits zero
// (pairwise_kl.cu's tf32())
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// The groups' first rows (clamped to M) and first tiles of ROWS rows, in
// shared memory: off[g], tile[g] for g <= G + 1 (off[G] = min(sum, M),
// tile[G] the groups' tiles; the zero tail as one more group: off[G + 1]
// = M, tile[G + 1] all tiles). One warp; each lane takes cdiv(G, 32)
// groups in a row (ragged_dot.cu's group_tables).
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

// the last g in [0, hi] with tile[g] * scale <= t
__device__ __forceinline__ int find_group(const int* tile, int hi, int t,
                                          int scale) {
  int lo = 0;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile[mid] * scale <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ------------------------------------------------- the transposing split

// x0 (M, C0) and x1 (M, C1) fp32, rows sorted by group -> planes p0 (2,
// C0, Mpad) and p1 (2, C1, Mpad) of their transposes (blockIdx.z picks
// the operand): group g's rows at columns 32 T(g) .. + len(g) - 1 and
// zeros up to the next multiple of 32 (T: the groups' first 32-row
// tiles). A block takes a 32-column tile of the planes (one group's, or
// past them all: it leaves) by 64 columns of the operand: 16-byte loads
// of the rows into a tile with a row stride of 65 floats (the column
// reads of the second phase hit 32 banks), then 16-byte stores of hi and
// lo, 32 consecutive columns a plane row (neighbor_mean.cu's split).
__global__ void __launch_bounds__(SPLIT_T_THREADS)
split_t_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
               float* __restrict__ p0, float* __restrict__ p1,
               const int* __restrict__ sizes, int M, int C0, int C1, int G,
               int Mpad) {
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  __shared__ float t[TN][TJ + 1];
  const bool second = blockIdx.z == 1;
  const float* x = second ? x1 : x0;
  float* hi = second ? p1 : p0;
  const int C = second ? C1 : C0;
  const int j0 = blockIdx.y * TJ;
  if (!SPLIT || j0 >= C) return;   // the narrower operand's blocks
  group_tables<TN>(sizes, G, M, off, tile);
  __syncthreads();
  const int y = blockIdx.x;        // x: Mpad / 32 may pass 65535
  if (y >= tile[G]) return;        // past every group's columns
  const int g = find_group(tile, G - 1, y, 1);
  const int src0 = off[g] + (y - tile[g]) * TN;
  const int rend = off[g + 1];

  // phase 1: rows src0.. of x (zero past the group), 4 consecutive
  // columns a thread
  const int tj = (threadIdx.x % 16) * 4;
  for (int tn = threadIdx.x / 16; tn < TN; tn += SPLIT_T_THREADS / 16) {
    const int r = src0 + tn, j = j0 + tj;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rend && j < C)         // C % 4 == 0: all four or none
      v = __ldg(reinterpret_cast<const float4*>(x + (size_t)r * C + j));
    t[tn][tj] = v.x;
    t[tn][tj + 1] = v.y;
    t[tn][tj + 2] = v.z;
    t[tn][tj + 3] = v.w;
  }
  __syncthreads();

  // phase 2: plane rows j0.. (columns 32 y .. + 31 of each), 4
  // consecutive columns a thread
  float* lo = hi + (size_t)C * Mpad;
  const int tn = (threadIdx.x % 8) * 4;
  for (int r = threadIdx.x / 8; r < TJ; r += SPLIT_T_THREADS / 8) {
    const int j = j0 + r;
    if (j >= C) break;
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = t[tn + e][r];
      h[e] = tf32(v);
      l[e] = tf32(v - h[e]);
    }
    const size_t at = (size_t)j * Mpad + (size_t)y * TN + tn;
    *reinterpret_cast<float4*>(hi + at) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + at) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// ---------------------------------------------------------- TMA, mbarriers

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

// TMA: the box at (c0, c1, c2), innermost first, of map into dst,
// completing on bar; what lies past the tensor reads as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  if (!LOADS) return;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// The producer's ring: the next slot, once the consumers have handed it
// back, armed for ``bytes``
template <int STAGES>
struct ProducerRing {
  uint64_t* full;
  uint64_t* empty;
  int it = 0;

  __device__ __forceinline__ int next(uint32_t bytes) {
    const int slot = it % STAGES;
    if (it >= STAGES) bar_wait(&empty[slot], ((it / STAGES) - 1) & 1);
    bar_expect(&full[slot], LOADS ? bytes : 0);
    ++it;
    return slot;
  }
};

// The consumers' ring: wait for the next stage; hand it back
template <int STAGES>
struct ConsumerRing {
  uint64_t* full;
  uint64_t* empty;
  int it = 0;
  bool leader;  // the warpgroup's thread that arrives on ``empty``

  __device__ __forceinline__ int wait() {
    const int slot = it % STAGES;
    bar_wait(&full[slot], (it / STAGES) & 1);
    return slot;
  }
  __device__ __forceinline__ void release() {
    if (leader) bar_arrive(&empty[it % STAGES]);
    ++it;
  }
};

// --------------------------------------------------------------- wgmma

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle on a 1024-byte boundary: rows of 32 fp32, 8-row groups 1024
// bytes apart (SBO), the leading offset unused (1); a k8 step is 32
// bytes on along the row
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses to these registers across the
// asynchronous wgmmas
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A (64 x 8, from this thread's four registers of the fragment)
// times B (8 x N, K-major in shared memory) in TF32 with fp32
// accumulators, N = 16, 32, 64 or 128, on d[OFF .. OFF + N / 2); scale_d
// == 0 overwrites
template <int OFF, int TOTAL>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[TOTAL],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 8 <= TOTAL, "the chunk's registers");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      WGMMA_TF32("m64n16k8") "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int OFF, int TOTAL>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[TOTAL],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 16 <= TOTAL, "the chunk's registers");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      WGMMA_TF32("m64n32k8") "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int OFF, int TOTAL>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[TOTAL],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 32 <= TOTAL, "the chunk's registers");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      WGMMA_TF32("m64n64k8") "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int OFF, int TOTAL>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[TOTAL],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  static_assert(OFF + 64 <= TOTAL, "the chunk's registers");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      WGMMA_TF32("m64n128k8") "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// d (+)= A (64 x 8) * B (128 x 8)^T, both K-major in shared memory, TF32
// with fp32 accumulators (pairwise_kl.cu's wgmma_tf32)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      WGMMA_TF32("m64n128k8")
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One product of a tile of NB x 16 rows: one wgmma a set bit of NB (n128,
// n64, n32, n16 on consecutive slices of d and of the B tile's rows); b
// is the B tile's row 0 at this k8 step
template <int NB, int R>
__device__ __forceinline__ void rs_product(float (&d)[R],
                                           const uint32_t (&a)[4],
                                           uint32_t b, int scale_d) {
  static_assert(R == NB * 8, "eight registers a 16-row step");
  constexpr int R64 = 16 * (NB & 8), R32 = 16 * (NB & 12),
                R16 = 16 * (NB & 14);  // rows before each chunk
  if constexpr ((NB & 8) != 0) wgmma_rs_n128<0>(d, a, desc_k(b), scale_d);
  if constexpr ((NB & 4) != 0)
    wgmma_rs_n64<R64 / 2>(d, a, desc_k(b + R64 * 128), scale_d);
  if constexpr ((NB & 2) != 0)
    wgmma_rs_n32<R32 / 2>(d, a, desc_k(b + R32 * 128), scale_d);
  if constexpr ((NB & 1) != 0)
    wgmma_rs_n16<R16 / 2>(d, a, desc_k(b + R16 * 128), scale_d);
}

// ------------------------------------------------------------ the forward

// The forward's tile t of the walk: group g (G: the zero tail), its rows
// [r0, r0 + FWD_BR) of which those below rend are stored, columns from
// n0. Tiles run group by group, in a group column tile by column tile, in
// a column tile row tile by row tile (kernels/ragged_dot.py's tf32_walk).
struct FwdTile {
  int g, r0, rend, n0;
};
__device__ __forceinline__ FwdTile fwd_tile(int t, int G, int ncol,
                                            const int* off, const int* tile) {
  const int g = find_group(tile, G, t, ncol);
  const int local = t - tile[g] * ncol;
  const int rows = tile[g + 1] - tile[g];
  return {g, off[g] + (local % rows) * FWD_BR, off[g + 1],
          (local / rows) * FWD_BN};
}

// This thread's row of the weights' tile for fragment row h (0: lane/4,
// 1: lane/4 + 8) of warp w: with the weights (K,N) in 32-column boxes the
// permuted row of the header, else the natural one
template <bool TRANS>
__device__ __forceinline__ int a_row(int w, int lane, int h) {
  const int q = lane / 4;
  return TRANS ? 16 * w + q + 8 * h
               : 32 * (w / 2) + 4 * (w % 2) + q % 4 + 16 * (q / 4) + 8 * h;
}

// Byte offset in a stage's weight tile of (row n of this consumer's 64,
// depth k of the stage's 32) for consumer c: (K,N) as four 32 n x 32 k
// boxes [k][n], (N,K) as one 128 n x 32 k box [n][k], 128-byte swizzle
// (the 16-byte chunk index XOR the row's index mod 8)
template <bool TRANS>
__device__ __forceinline__ uint32_t a_offset(int c, int n, int k) {
  const int col = 64 * c + n;
  if (TRANS)
    return col * 128 + (((k / 4) ^ (col % 8)) * 16) + (k % 4) * 4;
  return (col / 32) * W_BOX + k * 128 + ((((col % 32) / 4) ^ (k % 8)) * 16) +
         (col % 4) * 4;
}

// A consumer's part of one forward tile of NB x 16 rows: the stages
// through the ring, the products, the store of rows below rend
template <bool TRANS, int NB>
__device__ __forceinline__ void fwd_mma(unsigned char* smem,
                                        ConsumerRing<FWD_STAGES>& ring,
                                        int stages, int c, bool active,
                                        const FwdTile& f, float* out, int N) {
  constexpr int R = NB * 8;
  const int t128 = threadIdx.x % 128, w = t128 / 32, lane = t128 % 32;
  float acc[R], d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = d[i] = 0.f;
  uint32_t off[2][2];  // [h][q]: this thread's weights in a stage, k8 0
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      off[h][q] = a_offset<TRANS>(c, a_row<TRANS>(w, lane, h),
                                  lane % 4 + 4 * q);
  for (int s = 0; s < stages; ++s) {
    const int slot = ring.wait();
    unsigned char* st = smem + slot * FWD_STAGE_BYTES;
    if (active) {
      // the fragment (a0: row h 0 / k t, a1: h 1 / t, a2: h 0 / t + 4,
      // a3: h 1 / t + 4) of each k8 step, split into hi and lo
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // a k8 step is 8 rows of a (K,N) box or 32 bytes of an (N,K) row
          // (two 16-byte chunks: the swizzle XOR moves by 2 in the index)
          const uint32_t o = TRANS ? (off[r & 1][r >> 1] ^ (ks * 32))
                                   : off[r & 1][r >> 1] + ks * 8 * 128;
          const float x = *reinterpret_cast<const float*>(st + o);
          const float xh = tf32(x);
          ah[ks][r] = __float_as_uint(xh);
          al[ks][r] = __float_as_uint(tf32(x - xh));
        }
      fence_regs(d);
      wgmma_fence();
      const uint32_t bh = smem_u32(st + W_BYTES), bl = bh + L_BYTES;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        rs_product<NB>(d, al[ks], bh + ks * 32, ks > 0);
        rs_product<NB>(d, ah[ks], bl + ks * 32, 1);
        rs_product<NB>(d, ah[ks], bh + ks * 32, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(d);
      fence_regs(ah);
      fence_regs(al);
    }
    ring.release();
    if (active) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += d[i];
    }
  }
  if (!active) return;
  // acc[4j + 2h + e]: weight row a_row(h) of this consumer's 64, lhs row
  // r0 + 8j + 2 (lane % 4) + e; rows from rend on are the next group's
  const int r0 = f.r0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = f.n0 + 64 * c + a_row<TRANS>(w, lane, h);
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * j + e;
        if (STORES && r < f.rend)
          out[(size_t)r * N + n] = acc[4 * j + 2 * h + e];
      }
  }
}

// out (M,N) = lhs (M,K) by rhs[g] (K,N), or by rhs[g]^T with rhs[g]
// (N,K) when TRANS; lhs as its hi/lo planes (2, M, Kp), lhs_map 3-D over
// (Kp, M, 2) in 32 k x 16-row boxes; rhs_map 3-D over (N, K, G) in 32 x
// 32 boxes, or over (K, N, G) in 32 k x 128 n boxes when TRANS. A
// persistent grid of the caller's size.
template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap lhs_map,
           const __grid_constant__ CUtensorMap rhs_map,
           const int* __restrict__ sizes, float* __restrict__ out, int M,
           int K, int N, int G) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FWD_STAGES];
  __shared__ __align__(8) uint64_t empty[FWD_STAGES];
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  group_tables<FWD_BR>(sizes, G, M, off, tile);
  if (threadIdx.x == 32) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int ncol = (N + FWD_BN - 1) / FWD_BN;
  const int stages = (K + BK - 1) / BK;
  const int total = tile[G + 1] * ncol;

  if (threadIdx.x < 128) {         // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      ProducerRing<FWD_STAGES> ring{full, empty};
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const FwdTile f = fwd_tile(t, G, ncol, off, tile);
        if (f.g == G) continue;    // the zero tail reads nothing
        const int nrb =
            (min(FWD_BR, f.rend - f.r0) + ROW_STEP - 1) / ROW_STEP;
        // (K,N): the 32-column boxes that start below N
        const int nb = TRANS ? 1 : min(4, (N - f.n0 + 31) / 32);
        const uint32_t bytes =
            (TRANS ? W_BYTES : nb * W_BOX) + 2 * nrb * ROW_BOX;
        for (int s = 0; s < stages; ++s) {
          const int slot = ring.next(bytes);
          unsigned char* st = smem + slot * FWD_STAGE_BYTES;
          const int k0 = s * BK;
          if (TRANS) tma_load(st, &rhs_map, &full[slot], k0, f.n0, f.g);
          for (int b = 0; !TRANS && b < nb; ++b)
            tma_load(st + b * W_BOX, &rhs_map, &full[slot], f.n0 + 32 * b,
                     k0, f.g);
          for (int p = 0; p < 2; ++p)
            for (int b = 0; b < nrb; ++b)
              tma_load(st + W_BYTES + p * L_BYTES + b * ROW_BOX, &lhs_map,
                       &full[slot], k0, f.r0 + b * ROW_STEP, p);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int c = threadIdx.x / 128 - 1;   // this warpgroup's 64 columns
  ConsumerRing<FWD_STAGES> ring{full, empty, 0, threadIdx.x % 128 == 0};
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const FwdTile f = fwd_tile(t, G, ncol, off, tile);
    const bool active = f.n0 + 64 * c < N;
    if (f.g == G) {                // the zero tail past the groups
      for (int e = threadIdx.x % 128; active && e < FWD_BR * 64; e += 128) {
        const int r = f.r0 + e / 64, n = f.n0 + 64 * c + e % 64;
        if (r < M && n < N) out[(size_t)r * N + n] = 0.f;
      }
      continue;
    }
    switch ((min(FWD_BR, f.rend - f.r0) + ROW_STEP - 1) / ROW_STEP) {
      case 1: fwd_mma<TRANS, 1>(smem, ring, stages, c, active, f, out, N); break;
      case 2: fwd_mma<TRANS, 2>(smem, ring, stages, c, active, f, out, N); break;
      case 3: fwd_mma<TRANS, 3>(smem, ring, stages, c, active, f, out, N); break;
      case 4: fwd_mma<TRANS, 4>(smem, ring, stages, c, active, f, out, N); break;
      case 5: fwd_mma<TRANS, 5>(smem, ring, stages, c, active, f, out, N); break;
      case 6: fwd_mma<TRANS, 6>(smem, ring, stages, c, active, f, out, N); break;
      case 7: fwd_mma<TRANS, 7>(smem, ring, stages, c, active, f, out, N); break;
      case 8: fwd_mma<TRANS, 8>(smem, ring, stages, c, active, f, out, N); break;
      default: fwd_mma<TRANS, 9>(smem, ring, stages, c, active, f, out, N); break;
    }
  }
}

// ---------------------------------------------------- the weight gradient

// out (G,K,N), out[g] = lhs rows of group g transposed by its grad rows;
// a_map 3-D over lhs^T's planes (Mpad, K, 2) and b_map over grad^T's
// (Mpad, N, 2), 32 x 128 boxes. A persistent grid of the caller's size
// walks G x cdiv(K, WG_BM) x cdiv(N, WG_BN) tiles; group g's stages are
// its padded columns 32 T(g) ..
__global__ void __launch_bounds__(THREADS, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap a_map,
             const __grid_constant__ CUtensorMap b_map,
             const int* __restrict__ sizes, float* __restrict__ out, int M,
             int K, int N, int G) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  __shared__ __align__(8) uint64_t empty[WG_STAGES];
  __shared__ int off[MAX_GROUPS + 2];
  __shared__ int tile[MAX_GROUPS + 2];
  __shared__ __align__(16) float staged[4 * CONSUMERS][16 * OUT_LD];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  group_tables<TN>(sizes, G, M, off, tile);
  if (threadIdx.x == 32) {
    for (int s = 0; s < WG_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nk = (K + WG_BM - 1) / WG_BM, nn = (N + WG_BN - 1) / WG_BN;
  const int per_group = nk * nn;
  const int total = G * per_group;

  if (threadIdx.x < 128) {         // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      ProducerRing<WG_STAGES> ring{full, empty};
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int g = t / per_group, local = t % per_group;
        const int k0 = (local / nn) * WG_BM, n0 = (local % nn) * WG_BN;
        for (int s = tile[g]; s < tile[g + 1]; ++s) {
          const int slot = ring.next(WG_STAGE_BYTES);
          unsigned char* st = smem + slot * WG_STAGE_BYTES;
          for (int p = 0; p < 2; ++p) {
            tma_load(st + p * PLANE_TILE, &a_map, &full[slot], s * TN, k0,
                     p);
            tma_load(st + (2 + p) * PLANE_TILE, &b_map, &full[slot], s * TN,
                     n0, p);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int c = threadIdx.x / 128 - 1;   // this warpgroup's 64 rows of K
  const int t128 = threadIdx.x % 128, w = t128 / 32, lane = t128 % 32;
  ConsumerRing<WG_STAGES> ring{full, empty, 0, t128 == 0};
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int g = t / per_group, local = t % per_group;
    const int k0 = (local / nn) * WG_BM, n0 = (local % nn) * WG_BN;
    const bool active = k0 + 64 * c < K;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int s = tile[g]; s < tile[g + 1]; ++s) {
      const int slot = ring.wait();
      if (active) {
        const uint32_t ah = smem_u32(smem + slot * WG_STAGE_BYTES) +
                            c * 64 * 128;
        const uint32_t al = ah + PLANE_TILE;
        const uint32_t bh = smem_u32(smem + slot * WG_STAGE_BYTES) +
                            2 * PLANE_TILE;
        const uint32_t bl = bh + PLANE_TILE;
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          wgmma_ss_n128(d, desc_k(al + kk * 32), desc_k(bh + kk * 32),
                        kk > 0);
          wgmma_ss_n128(d, desc_k(ah + kk * 32), desc_k(bl + kk * 32), 1);
          wgmma_ss_n128(d, desc_k(ah + kk * 32), desc_k(bh + kk * 32), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(d);
      }
      ring.release();
      if (active) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
      }
    }
    if (!active) continue;
    // acc[4j + 2h + e]: row 16 w + lane / 4 + 8 h of this consumer's 64
    // (row k0 + 64 c + .. of out[g]), column n0 + 8 j + 2 (lane % 4) + e.
    // Each warp stages its 16 rows by 32 columns at a time in shared
    // memory (two 8-byte writes a lane, conflict-free at the OUT_LD
    // stride), then stores whole 128-byte rows, 16 bytes a lane; N % 4 ==
    // 0, so four columns lie wholly below N or past it
    float* dst = out + (size_t)g * K * N;
    float* buf = staged[threadIdx.x / 32 - 4];
    const int k_warp = k0 + 64 * c + 16 * w;
#pragma unroll
    for (int r = 0; r < WG_BN / 32; ++r) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(buf + (lane / 4 + 8 * h) * OUT_LD +
                                     8 * jj + 2 * (lane % 4)) =
              make_float2(acc[4 * (4 * r + jj) + 2 * h],
                          acc[4 * (4 * r + jj) + 2 * h + 1]);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * i + lane / 8, col = 4 * (lane % 8);
        const int k = k_warp + row, n = n0 + 32 * r + col;
        // streaming: the gradient is not read here
        if (STORES && k < K && n < N)
          __stcs(reinterpret_cast<float4*>(dst + (size_t)k * N + n),
                 *reinterpret_cast<const float4*>(buf + row * OUT_LD + col));
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------------ host

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ``g`` blocks of ``tile`` cover ``extent``, and none lies wholly past it
bool covers(long long g, long long tile, long long extent) {
  return g >= 1 && g * tile >= extent && (g - 1) * tile < extent;
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

// a row-major fp32 tensor of three dims (innermost first, each row a
// multiple of 16 bytes), read in ``box`` boxes with the 128-byte swizzle;
// what lies past the tensor reads as zeros
bool f32_map(EncodeTiled encode, CUtensorMap* map, const void* base,
             const uint64_t (&dims)[3], const uint32_t (&box)[3]) {
  const cuuint64_t d[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t strides[2] = {dims[0] * 4, dims[0] * dims[1] * 4};
  const cuuint32_t b[3] = {box[0], box[1], box[2]};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), d, strides, b, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The products' terms: fp32 operands whose rows are whole 16-byte
// multiples (K, N % 4 == 0), 16-byte aligned, 1..MAX_GROUPS groups; a
// persistent grid of 1..``tiles`` blocks of THREADS threads with
// ``want`` bytes of dynamic shared memory.
cudaError_t terms(const void* a, const void* b, const void* c, int M, int K,
                  int N, int G, long long tiles, int grid, int block,
                  int smem, int want) {
  if (M < 1 || K < 1 || N < 1 || K % 4 || N % 4 || G < 1 ||
      G > MAX_GROUPS || !aligned16(a) || !aligned16(b) || !aligned16(c))
    return cudaErrorInvalidValue;
  if (tiles > 0x7FFFFFFF || grid < 1 || grid > tiles || block != THREADS ||
      smem != want)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// the padded columns of the transposed planes: 32 (cdiv(M, 32) + G)
long long padded(int M, int G) { return 32LL * ((M + 31LL) / 32 + G); }

template <bool TRANS>
cudaError_t launch_fwd(const void* planes, const void* rhs, const void* sizes,
                       void* out, int M, int K, int N, int G, int grid,
                       cudaStream_t st) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap lhs_map, rhs_map;
  const uint64_t kp = (uint64_t)(K + BK - 1) / BK * BK;
  const uint64_t lhs_dims[3] = {kp, (uint64_t)M, 2};
  const uint32_t lhs_box[3] = {BK, ROW_STEP, 1};
  const uint64_t rhs_dims[3] = {(uint64_t)(TRANS ? K : N),
                                (uint64_t)(TRANS ? N : K), (uint64_t)G};
  const uint32_t rhs_box[3] = {TRANS ? (uint32_t)BK : 32u,
                               TRANS ? (uint32_t)FWD_BN : (uint32_t)BK, 1};
  if (!f32_map(encode, &lhs_map, planes, lhs_dims, lhs_box) ||
      !f32_map(encode, &rhs_map, rhs, rhs_dims, rhs_box))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (err != cudaSuccess) return err;
  fwd_kernel<TRANS><<<grid, THREADS, FWD_SMEM, st>>>(
      lhs_map, rhs_map, static_cast<const int*>(sizes),
      static_cast<float*>(out), M, K, N, G);
  return cudaGetLastError();
}

}  // namespace

// The fp32 route of ragged_dot: lhs as its planes (2, M, Kp) from B1's
// split pass (Kp = K rounded up to 32, zero past K), rhs (G, K, N)
// (transpose_rhs: (G, N, K)), sizes
// (G,) int32, out (M, N) fp32, contiguous, K and N multiples of 4,
// 16-byte aligned; ``grid`` persistent blocks (tf32_args: at most one an
// SM and at most (cdiv(M, 144) + G) x cdiv(N, 128), the tiles' bound) of
// ``block`` = 384 threads with ``smem`` = FWD_SMEM bytes.
extern "C" int ragged_dot_tf32(const void* planes, const void* rhs,
                               const void* sizes, void* out, int M, int K,
                               int N, int G, int transpose_rhs, int grid,
                               int block, int smem, void* stream) {
  const long long tiles = ((long long)(M + FWD_BR - 1) / FWD_BR + G) *
                          ((N + FWD_BN - 1) / FWD_BN);
  cudaError_t err = terms(planes, rhs, out, M, K, N, G, tiles, grid, block,
                          smem, FWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = transpose_rhs
            ? launch_fwd<true>(planes, rhs, sizes, out, M, K, N, G, grid, st)
            : launch_fwd<false>(planes, rhs, sizes, out, M, K, N, G, grid,
                                st);
  return static_cast<int>(err);
}

// lhs (M, K), grad (M, N) fp32, contiguous, 16-byte aligned, K and N
// multiples of 4, sizes (G,) int32 -> lhs^T planes (2, K, Mpad) and
// grad^T planes (2, N, Mpad), Mpad = 32 (cdiv(M, 32) + G), each group's
// rows from a 32-column boundary, zero to the next one (columns past the
// groups' are not written); on the grid tf32_wgrad_split_args gives:
// Mpad / 32 x cdiv(max(K, N), 64) x 2 blocks of ``block`` = 256 threads.
extern "C" int ragged_dot_wgrad_tf32_split(const void* lhs, const void* grad,
                                           const void* sizes, void* lhs_planes,
                                           void* grad_planes, int M, int K,
                                           int N, int G, int Mpad, int gx,
                                           int gy, int gz, int block,
                                           int smem, void* stream) {
  if (M < 1 || K < 1 || N < 1 || K % 4 || N % 4 || G < 1 ||
      G > MAX_GROUPS || Mpad != padded(M, G) || !aligned16(lhs) ||
      !aligned16(grad) || !aligned16(lhs_planes) || !aligned16(grad_planes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (gx != Mpad / TN || !covers(gy, TJ, K > N ? K : N) || gy > 65535 ||
      gz != 2 || block != SPLIT_T_THREADS || smem != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  split_t_kernel<<<dim3(gx, gy, gz), block, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(grad),
      static_cast<float*>(lhs_planes), static_cast<float*>(grad_planes),
      static_cast<const int*>(sizes), M, K, N, G, Mpad);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 route of ragged_dot_wgrad: lhs^T and grad^T planes from
// ragged_dot_wgrad_tf32_split, sizes (G,) int32, out (G, K, N) fp32,
// contiguous, 16-byte aligned; ``grid`` persistent blocks
// (tf32_wgrad_args: at most one an SM and at most G x cdiv(K, 128) x
// cdiv(N, 128) tiles) of ``block`` = 384 threads with ``smem`` = WG_SMEM
// bytes.
extern "C" int ragged_dot_wgrad_tf32(const void* lhs_planes,
                                     const void* grad_planes,
                                     const void* sizes, void* out, int M,
                                     int K, int N, int G, int Mpad, int grid,
                                     int block, int smem, void* stream) {
  const long long tiles = (long long)G * ((K + WG_BM - 1) / WG_BM) *
                          ((N + WG_BN - 1) / WG_BN);
  cudaError_t err = terms(lhs_planes, grad_planes, out, M, K, N, G, tiles,
                          grid, block, smem, WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Mpad != padded(M, G)) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap a_map, b_map;
  const uint64_t a_dims[3] = {(uint64_t)Mpad, (uint64_t)K, 2};
  const uint64_t b_dims[3] = {(uint64_t)Mpad, (uint64_t)N, 2};
  const uint32_t box[3] = {TN, 128, 1};
  if (!f32_map(encode, &a_map, lhs_planes, a_dims, box) ||
      !f32_map(encode, &b_map, grad_planes, b_dims, box))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_kernel<<<grid, THREADS, WG_SMEM, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<const int*>(sizes), static_cast<float*>(out),
      M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
