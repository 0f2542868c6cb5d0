// Eq. 2 divergence strip on Hopper:
//   D[a,b] = (rowterm[a] - sum_k p_a[k] l_b[k]) / R,
//   rowterm[a] = sum_k p_a[k] l_a[k],   p_a = exp(l_a),
// over the flattened K = R*C axis.
//
// Replaces: src/repro/kernels/pairwise_kl.py::_kernel (launched by
// _pair_call), the Pallas TPU kernel behind pairwise_kl and
// pairwise_kl_pair.
//
// Bound on this card: operations. A (U x M) strip is 2 U M K flops
// against (U + M) K input values: ~1400 flop a byte at the server-round
// shape (2048 x 4096, K = 2400), far above the ridge of any unit. The
// divergence rowterm - cross cancels heavily and 1/d ranks neighbors, so
// plain TF32 (10 mantissa bits) is not accurate enough; this kernel keeps
// fp32-level accuracy with three TF32 products on the tensor cores
// (3xTF32): 3 x 2 U M K flops at 495 TFLOP/s, 0.244 ms for that strip.
//
// Design, two kernels:
//
// 1. pairwise_kl_split streams each operand once, one warp a row, with
//    16-byte stores (and 16-byte fp32 or 8-byte bf16 loads when K % 4 ==
//    0, else scalar ones). On the A side it computes p = exp(l) and the
//    row term (each lane sums its k in ascending order, then a fixed
//    butterfly); it writes
//    hi(x) = tf32(x) and lo(x) = tf32(x - hi(x)) as two fp32 planes of
//    (rows, Kp), K-major, with x = p (A side) or l (B side). tf32() rounds
//    to nearest, ties away from zero (as cvt.rna.tf32.f32), on the bits,
//    so the 13 low mantissa bits are zero. Kp pads K to the GEMM's 32-deep
//    k-tile with zeros (a zero contributes 0), which also makes every row
//    stride a multiple of 16 bytes, as TMA requires.
//
// 2. pairwise_kl_pair is the GEMM over the planes. The cross term is
//    hi(p) hi(l) + hi(p) lo(l) + lo(p) hi(l): each product of two TF32
//    values is exact in fp32, and the only term dropped, lo lo, is ~2^-22
//    of the product. A block owns a 128 x 128 output tile and walks all of
//    K (no split-K, no atomics: every result is the same from run to run).
//    One producer thread keeps a 3-stage ring of 32-deep k-tiles filled by
//    TMA (hi and lo of A and of B, 64 KB a stage, 128-byte swizzle),
//    completed on mbarriers; two consumer warpgroups each run
//    wgmma m64n128k8 .tf32 on their 64-row half, both operands K-major
//    (A = P (U x Kp) and B = L (M x Kp) are row-major over k, so nothing
//    is transposed). The tensor core sums into its accumulator with
//    truncating adds, so each k-tile's 12 wgmmas (4 k-steps x 3 products)
//    go into a fresh accumulator that is then added, in fp32 with
//    round-to-nearest, into the block's running sum: the truncated sums
//    span 32 terms, not K. The epilogue writes (rowterm - acc) / R with
//    the ragged edge masked; TMA fills rows past U or M with zeros.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- split

constexpr int SPLIT_ROWS = 8;  // rows a block: one warp each

// v[0..V) = p[0..V), widened to fp32; V == 4 reads 16 bytes of fp32 or 8
// of bf16 at once (the caller guarantees the alignment)
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    // a bf16 is the top half of the fp32 with the same value
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xFFFF0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xFFFF0000u);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// x rounded to TF32, to nearest with ties away from zero; low bits zero
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// Lanes walk a row in chunks of V consecutive k (V = 4 when K % 4 == 0
// and the rows are aligned, else 1); a chunk lies wholly below K or
// wholly in the zero padding.
template <typename T, int V>
__global__ void __launch_bounds__(32 * SPLIT_ROWS)
split_kernel(const T* __restrict__ l, float* __restrict__ hi,
             float* __restrict__ lo, float* __restrict__ rowterm, int rows,
             int K, int Kp, int a_side) {
  const int row = blockIdx.x * SPLIT_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const T* src = l + (size_t)row * K;
  float* h = hi + (size_t)row * Kp;
  float* o = lo + (size_t)row * Kp;
  float rt = 0.f;
  for (int k = lane * V; k < Kp; k += 32 * V) {
    float x[V], xh[V], xl[V];
    if (k < K) {
      float v[V];
      load<V>(src + k, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (a_side) {
          x[e] = expf(v[e]);
          rt = fmaf(x[e], v[e], rt);
        } else {
          x[e] = v[e];
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xh[e] = tf32(x[e]);
      xl[e] = tf32(x[e] - xh[e]);
    }
    store<V>(h + k, xh);
    store<V>(o + k, xl);
  }
  if (a_side) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rt += __shfl_xor_sync(0xffffffffu, rt, off);
    if (lane == 0) rowterm[row] = rt;
  }
}

template <typename T>
cudaError_t launch_split(const void* l, void* hi, void* lo, void* rowterm,
                         int rows, int K, int Kp, int a_side,
                         cudaStream_t s) {
  const int grid = (rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const bool vec = K % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(l) % (4 * sizeof(T)) == 0;
  auto kernel = vec ? split_kernel<T, 4> : split_kernel<T, 1>;
  kernel<<<grid, 32 * SPLIT_ROWS, 0, s>>>(
      static_cast<const T*>(l), static_cast<float*>(hi),
      static_cast<float*>(lo), static_cast<float*>(rowterm), rows, K, Kp,
      a_side);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- GEMM

constexpr int BM = 128;            // A rows a block: two warpgroups of 64
constexpr int BN = 128;            // B rows a block: the wgmma N
constexpr int BK = 32;             // k a stage: one 128-byte swizzled row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;       // warpgroups running wgmma
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int TILE = BM * BK;      // floats in one plane's tile (16 KB)
constexpr uint32_t STAGE_BYTES = 4 * TILE * sizeof(float);  // 64 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;     // + alignment

static_assert(BM == BN, "one TMA box shape serves A and B");
static_assert(BK * sizeof(float) == 128, "a k-tile row is one swizzle row");

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

// TMA: the (BK x 128) box at (k, row) of map into dst, completing on bar
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// start address >> 4, leading offset unused (1), 1024 bytes between
// 8-row groups, swizzle mode 1 (128 B) in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  return ((uint64_t)(smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A (64 x 8) * B (128 x 8)^T in TF32 with fp32 accumulation;
// scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
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

// keeps the compiler from moving accesses to d across the async wgmmas
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_hi,
            const __grid_constant__ CUtensorMap a_lo,
            const __grid_constant__ CUtensorMap b_hi,
            const __grid_constant__ CUtensorMap b_lo,
            const float* __restrict__ rowterm, float* __restrict__ out,
            int U, int M, int nk, float R) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  // the swizzled tiles start on a 1024-byte boundary of shared memory
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) bar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        float* st = smem + s * 4 * TILE;
        bar_expect(&full[s], STAGE_BYTES);
        tma_load(st, &a_hi, &full[s], kt * BK, r0);
        tma_load(st + TILE, &a_lo, &full[s], kt * BK, r0);
        tma_load(st + 2 * TILE, &b_hi, &full[s], kt * BK, c0);
        tma_load(st + 3 * TILE, &b_lo, &full[s], kt * BK, c0);
      }
    }
    return;
  }

  const int g = wg - 1;  // this warpgroup's 64-row half of the tile
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    bar_wait(&full[s], (kt / STAGES) & 1);
    const float* ah = smem + s * 4 * TILE + g * 64 * BK;
    const float* al = ah + TILE;
    const float* bh = smem + s * 4 * TILE + 2 * TILE;
    const float* bl = bh + TILE;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {  // 8-deep k-steps, 32 bytes apart
      wgmma_tf32(d, smem_desc(al + kk), smem_desc(bh + kk), kk > 0);
      wgmma_tf32(d, smem_desc(ah + kk), smem_desc(bl + kk), 1);
      wgmma_tf32(d, smem_desc(ah + kk), smem_desc(bh + kk), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (threadIdx.x % 128 == 0) bar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  }

  // accumulator fragment: d[4j + 2h + e] is row 16 warp + lane / 4 + 8 h,
  // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile
  const int t = threadIdx.x % 128;
  const int row_base = r0 + g * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col_base = c0 + 2 * (t % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + 8 * h;
    if (row >= U) continue;
    const float rt = rowterm[row];
    float* dst = out + (size_t)row * M;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_base + 8 * j + e;
        if (col < M) dst[col] = (rt - acc[4 * j + 2 * h + e]) / R;
      }
    }
  }
}

// ---------------------------------------------------------------- host

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

// a (rows x Kp) fp32 row-major plane, read in (BK x 128) boxes with the
// 128-byte swizzle; rows past the end read as zeros
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int rows, int Kp) {
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp * sizeof(float)};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// l (rows, K) row-major, fp32 (bf16 == 0) or bf16 -> hi, lo (rows, Kp)
// fp32 planes of x = exp(l) (a_side != 0, with rowterm (rows,) fp32) or
// x = l (a_side == 0, rowterm unused). Returns cudaGetLastError().
extern "C" int pairwise_kl_split(const void* l, void* hi, void* lo,
                                 void* rowterm, int rows, int K, int Kp,
                                 int a_side, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_split<__nv_bfloat16>(l, hi, lo, rowterm, rows, K, Kp,
                                         a_side, s)
           : launch_split<float>(l, hi, lo, rowterm, rows, K, Kp, a_side,
                                 s));
}

// a_hi, a_lo (U, Kp) and b_hi, b_lo (M, Kp) fp32 planes from
// pairwise_kl_split (Kp a multiple of 32, rows 16-byte aligned), rowterm
// (U,) fp32 -> out (U, M) fp32. Returns cudaGetLastError() after the
// launch, or a refusal before it.
extern "C" int pairwise_kl_pair(const void* a_hi, const void* a_lo,
                                const void* b_hi, const void* b_lo,
                                const void* rowterm, void* out, int U, int M,
                                int Kp, int R, void* stream) {
  if (Kp % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  if (!make_map(encode, &maps[0], a_hi, U, Kp) ||
      !make_map(encode, &maps[1], a_lo, U, Kp) ||
      !make_map(encode, &maps[2], b_hi, M, Kp) ||
      !make_map(encode, &maps[3], b_lo, M, Kp))
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of dynamic shared memory; set on every call, so a call on
  // another device of the process finds it set too
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BN - 1) / BN, (U + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gemm_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(rowterm),
      static_cast<float*>(out), U, M, Kp / BK, static_cast<float>(R));
  return static_cast<int>(cudaGetLastError());
}
