// Eq. 2 divergence strips on Hopper, straight from the int8 wire form:
//   D[a,b] = (sum_k p_a l_a - sum_k p_a l_b) / R,
//   l[n,k] = q[n,k] * scale[n,r] - lse[n,r],  r = k / C,  p_a = exp(l_a)
// over the flattened K = R*C axis. The per-row zero point cancels in the
// softmax and is never read. lse[n,r] = logsumexp_c(q * scale) is read
// when the caller has it (the IVF index stores it) and computed in the
// same pass otherwise.
//
// Replaces: src/repro/kernels/dequant_kl.py::_kernel (launched by
// _call_pair), the Pallas TPU kernel behind int8_pairwise_kl and
// int8_pairwise_kl_pair.
//
// Two routes behind one interface (kernels/dequant_kl.py picks by shape):
//
// 1. Wide strips (both sides longer than THIN_ROWS, e.g. the server's
//    2048 x 4096 at K = 2400): int8_pairwise_kl_split decodes each
//    operand into the TF32 hi and lo planes that pairwise_kl_split writes
//    for fp32 log-probs (p = exp(l) and the row term on the A side, l on
//    the B side, K padded to 32 with zeros), and pairwise_kl.cu's 3xTF32
//    wgmma GEMM contracts them. Bound: operations, 3 x 2 U M K flops at
//    495 TFLOP/s (0.244 ms for that strip); the split itself is bytes-
//    bound (1 byte of code in, 8 bytes of planes out an element). The
//    planes are transient: the caller gathers each strip's codes anyway.
//    One warp a row, 4-byte code loads and 16-byte plane stores; l is
//    rounded as torch rounds q.float() * scale - lse (multiply, then
//    subtract, no FMA), so the B side's planes equal the plain version's
//    bit for bit when both read the same lse.
//
// 2. Thin strips (one side of at most THIN_ROWS = 16 rows: an upload's
//    1 x m forward and m x 1 reverse strips): int8_pairwise_kl_thin. Bound: bytes at the upload shape (K = 80:
//    each many-side row is 80 bytes of code and 64 of scale and lse,
//    against at most 16 multiply-adds an element). Every block decodes
//    the thin side (T rows) into shared memory, p and its row term if it
//    is the A side, l if it is the B side. A warp then takes many-side
//    rows, reads each code once with 4-byte loads, decodes in registers
//    (with exp and the row term when the many side is A) and
//    accumulates all T dot products in fp32 FFMA: lanes in ascending k,
//    then a fixed halving butterfly that leaves a lane at most one of
//    the T sums (no atomics, the same result every run). One row a warp
//    made each warp one dependent chain of loads, decode and shuffles;
//    a warp carries 4 rows at once (2 from 9 thin rows), so their loads
//    are in flight together and each thin value read from shared memory
//    feeds all of them.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;        // warps a block; each takes whole rows
constexpr int THIN_ROWS = 16;   // the thin kernel's largest thin side
constexpr unsigned FULL = 0xffffffffu;

// x rounded to TF32, to nearest with ties away from zero; low bits zero
// (as pairwise_kl.cu's tf32 and ref.tf32_round)
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// l = q * s - lse, each step rounded to nearest (no contraction to FMA)
__device__ __forceinline__ float decode(uint32_t q, float s, float lse) {
  return __fsub_rn(__fmul_rn(static_cast<float>(q), s), lse);
}

// c[0..V) = the codes at p; V == 4 reads 4 bytes at once (the caller
// guarantees the alignment)
template <int V>
__device__ __forceinline__ void load_codes(const uint8_t* p,
                                           uint32_t (&c)[V]) {
  if constexpr (V == 4) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    c[0] = x & 0xFF; c[1] = (x >> 8) & 0xFF;
    c[2] = (x >> 16) & 0xFF; c[3] = x >> 24;
  } else {
    c[0] = p[0];
  }
}

// lse[r] = logsumexp_c(q[r C + c] * s[r]) for one row, lanes over r, as
// torch.logsumexp computes it (max, then log of the sum of exp of the
// differences, plus the max). lse may be shared or global memory; the
// warp synchronizes before any lane reads another lane's entry.
__device__ __forceinline__ void row_lse(const uint8_t* q, const float* s,
                                        float* lse, int R, int C,
                                        int lane) {
  for (int r = lane; r < R; r += 32) {
    const float sr = s[r];
    const uint8_t* qr = q + (size_t)r * C;
    float mx = -INFINITY;
    for (int c = 0; c < C; ++c)
      mx = fmaxf(mx, __fmul_rn(static_cast<float>(qr[c]), sr));
    float sum = 0.f;
    for (int c = 0; c < C; ++c)
      sum += expf(__fmul_rn(static_cast<float>(qr[c]), sr) - mx);
    lse[r] = logf(sum) + mx;
  }
  __syncwarp();
}

// ---------------------------------------------------------------- split

// Lanes walk a row in chunks of V consecutive k (V = 4 when K % 4 == 0
// and the codes are 4-byte aligned, else 1); a chunk lies wholly below K
// or wholly in the zero padding. lse is read (have_lse) or computed into
// the same buffer first.
template <int V>
__global__ void __launch_bounds__(32 * WARPS)
split_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scale,
             float* lse, float* __restrict__ hi, float* __restrict__ lo,
             float* __restrict__ rowterm, int rows, int R, int C, int Kp,
             int a_side, int have_lse) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const int K = R * C;
  const uint8_t* src = q + (size_t)row * K;
  const float* s = scale + (size_t)row * R;
  float* ls = lse + (size_t)row * R;
  if (!have_lse) row_lse(src, s, ls, R, C, lane);
  float* h = hi + (size_t)row * Kp;
  float* o = lo + (size_t)row * Kp;
  float rt = 0.f;
  for (int k = lane * V; k < Kp; k += 32 * V) {
    float x[V];
    if (k < K) {
      uint32_t c[V];
      load_codes<V>(src + k, c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int r = (k + e) / C;
        const float l = decode(c[e], s[r], ls[r]);
        if (a_side) {
          x[e] = expf(l);
          rt = fmaf(x[e], l, rt);
        } else {
          x[e] = l;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
    float xh[V], xl[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xh[e] = tf32(x[e]);
      xl[e] = tf32(x[e] - xh[e]);
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(h + k) = make_float4(xh[0], xh[1], xh[2],
                                                      xh[3]);
      *reinterpret_cast<float4*>(o + k) = make_float4(xl[0], xl[1], xl[2],
                                                      xl[3]);
    } else {
      h[k] = xh[0];
      o[k] = xl[0];
    }
  }
  if (a_side) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rt += __shfl_xor_sync(FULL, rt, off);
    if (lane == 0) rowterm[row] = rt;
  }
}

// ----------------------------------------------------------------- thin

// Reduce acc[0..TB) over the warp's 32 lanes in a fixed order. Step j
// halves the values a lane holds: the lane whose bit j is set keeps the
// upper half and receives its partner's, the other the lower half; once
// one value is left, the remaining bits add plainly. Afterwards acc[0] is
// the warp's sum of index thin_index<TB>(lane).
template <int TB, int J = 0>
__device__ __forceinline__ void reduce_lanes(float (&acc)[TB], int lane) {
  if constexpr (J < 5) {
    constexpr int N = (TB >> J) > 0 ? (TB >> J) : 1;  // values held now
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane >> J) & 1;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? acc[i] : acc[i + H];
        const float keep = up ? acc[i + H] : acc[i];
        acc[i] = keep + __shfl_xor_sync(FULL, send, 1 << J);
      }
    } else {
      acc[0] += __shfl_xor_sync(FULL, acc[0], 1 << J);
    }
    reduce_lanes<TB, J + 1>(acc, lane);
  }
}

// which of the TB sums reduce_lanes left in acc[0] of this lane
template <int TB>
__device__ __forceinline__ int thin_index(int lane) {
  int t = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((TB >> (j + 1)) > 0 && ((lane >> j) & 1)) t += TB >> (j + 1);
  return t;
}

// lanes that write the reduced sums: one per distinct (lane bits) group
template <int TB>
__device__ __forceinline__ bool thin_writer(int lane) {
  constexpr int S = TB >= 16 ? 4 : (TB >= 8 ? 3 : (TB >= 4 ? 2 :
                    (TB >= 2 ? 1 : 0)));
  return (lane >> S) == 0;
}

// many-side rows a warp carries at once: RPI x TB accumulators a lane
template <int TB>
__host__ __device__ constexpr int rows_per_iter() {
  return TB <= 8 ? 4 : 2;
}

// The thin side (T <= TB rows: the A side if thin_is_a, else the B side)
// against M many-side rows. Shared memory: the thin side's x (p or l) as
// (T, K) fp32, its row terms (A side), and its lse when not given.
// out is (T, M) when the thin side is A, (M, T) when it is B.
template <int TB, int V>
__global__ void __launch_bounds__(32 * WARPS)
thin_kernel(const uint8_t* __restrict__ qt, const float* __restrict__ st,
            const float* __restrict__ lt, const uint8_t* __restrict__ qm,
            const float* __restrict__ sm, float* lm, float* __restrict__ out,
            int T, int M, int R, int C, int thin_is_a, int have_lt,
            int have_lm) {
  extern __shared__ __align__(16) float smem[];
  const int K = R * C;
  float* xs = smem;              // (T, K)
  float* rts = xs + (size_t)T * K;  // (T,)
  float* lts = rts + T;          // (T, R) when lse is computed here
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float fr = static_cast<float>(R);

  // decode the thin side, one warp a row
  for (int t = warp; t < T; t += WARPS) {
    const uint8_t* src = qt + (size_t)t * K;
    const float* s = st + (size_t)t * R;
    if (!have_lt) row_lse(src, s, lts + (size_t)t * R, R, C, lane);
    const float* ls = (have_lt ? lt : lts) + (size_t)t * R;
    float rt = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float l = decode(src[k], s[k / C], ls[k / C]);
      if (thin_is_a) {
        const float p = expf(l);
        rt = fmaf(p, l, rt);
        xs[(size_t)t * K + k] = p;
      } else {
        xs[(size_t)t * K + k] = l;
      }
    }
    if (thin_is_a) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rt += __shfl_xor_sync(FULL, rt, off);
      if (lane == 0) rts[t] = rt;
    }
  }
  __syncthreads();

  // the many side: each warp carries RPI rows at once (row, row + stride,
  // ...), so their loads are in flight together and each thin value read
  // from shared memory feeds RPI rows
  constexpr int RPI = rows_per_iter<TB>();
  const int stride = gridDim.x * WARPS;
  for (int base = blockIdx.x * WARPS + warp; base < M;
       base += stride * RPI) {
    const uint8_t* src[RPI];
    const float* s[RPI];
    const float* ls[RPI];
    bool live[RPI];
#pragma unroll
    for (int j = 0; j < RPI; ++j) {
      const int row = base + j * stride;
      live[j] = row < M;  // a dead slot reads row base and writes nothing
      const size_t rr = live[j] ? row : base;
      src[j] = qm + rr * K;
      s[j] = sm + rr * R;
      ls[j] = lm + rr * R;
      if (!have_lm && live[j]) row_lse(src[j], s[j], lm + rr * R, R, C, lane);
    }
    float acc[RPI][TB];
    float rt[RPI];
#pragma unroll
    for (int j = 0; j < RPI; ++j) {
      rt[j] = 0.f;
#pragma unroll
      for (int t = 0; t < TB; ++t) acc[j][t] = 0.f;
    }
    for (int k = lane * V; k < K; k += 32 * V) {
      int r[V];
#pragma unroll
      for (int e = 0; e < V; ++e) r[e] = (k + e) / C;
      float x[RPI][V];
#pragma unroll
      for (int j = 0; j < RPI; ++j) {
        uint32_t c[V];
        load_codes<V>(src[j] + k, c);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float l = decode(c[e], s[j][r[e]], ls[j][r[e]]);
          if (thin_is_a) {
            x[j][e] = l;
          } else {
            x[j][e] = expf(l);
            rt[j] = fmaf(x[j][e], l, rt[j]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        if (t < T) {
          float y[V];
          const float* p = xs + (size_t)t * K + k;
          if constexpr (V == 4) {
            const float4 v = *reinterpret_cast<const float4*>(p);
            y[0] = v.x; y[1] = v.y; y[2] = v.z; y[3] = v.w;
          } else {
            y[0] = p[0];
          }
#pragma unroll
          for (int j = 0; j < RPI; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[j][t] = fmaf(x[j][e], y[e], acc[j][t]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPI; ++j) {
      reduce_lanes<TB>(acc[j], lane);
      if (!thin_is_a) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rt[j] += __shfl_xor_sync(FULL, rt[j], off);
      }
      if (!live[j] || !thin_writer<TB>(lane)) continue;
      const int row = base + j * stride;
      const int t = thin_index<TB>(lane);
      if (t >= T) continue;
      if (thin_is_a)   // D[t, row] = (rowterm_t - <p_t, l_row>) / R
        out[(size_t)t * M + row] = (rts[t] - acc[j][0]) / fr;
      else             // D[row, t] = (rowterm_row - <p_row, l_t>) / R
        out[(size_t)row * T + t] = (rt[j] - acc[j][0]) / fr;
    }
  }
}

template <int TB, int V>
cudaError_t launch_thin(const void* qt, const void* st, const void* lt,
                        const void* qm, const void* sm, void* lm, void* out,
                        int T, int M, int R, int C, int thin_is_a,
                        int have_lt, int have_lm, int gx, int block,
                        int smem, cudaStream_t s) {
  auto kernel = thin_kernel<TB, V>;
  // the shared-memory grant, set again only when the device or the size
  // changes: a set costs the host microseconds, as much as the kernel of
  // an upload
  static int dev_seen = -1;
  static int smem_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != dev_seen || smem != smem_seen) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dev_seen = dev;
    smem_seen = smem;
  }
  kernel<<<gx, block, smem, s>>>(
      static_cast<const uint8_t*>(qt), static_cast<const float*>(st),
      static_cast<const float*>(lt), static_cast<const uint8_t*>(qm),
      static_cast<const float*>(sm), static_cast<float*>(lm),
      static_cast<float*>(out), T, M, R, C, thin_is_a, have_lt, have_lm);
  return cudaGetLastError();
}

template <int TB, int V>
cudaError_t thin_blocks(int smem, int* per_sm) {
  auto kernel = thin_kernel<TB, V>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       32 * WARPS, smem);
}

template <int V>
cudaError_t thin_by_size(const void* qt, const void* st, const void* lt,
                         const void* qm, const void* sm, void* lm,
                         void* out, int T, int M, int R, int C,
                         int thin_is_a, int have_lt, int have_lm, int gx,
                         int block, int smem, cudaStream_t s) {
#define THIN_CASE(TB)                                                     \
  if (T <= TB) {                                                          \
    if ((long)(gx - 1) * WARPS * rows_per_iter<TB>() >= M)                \
      return cudaErrorInvalidConfiguration;                               \
    return launch_thin<TB, V>(qt, st, lt, qm, sm, lm, out, T, M, R, C,    \
                              thin_is_a, have_lt, have_lm, gx, block,     \
                              smem, s);                                   \
  }
  THIN_CASE(1)
  THIN_CASE(2)
  THIN_CASE(4)
  THIN_CASE(8)
  THIN_CASE(16)
#undef THIN_CASE
  return cudaErrorInvalidValue;
}

bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

}  // namespace

// q (rows, R, C) uint8 codes, scale (rows, R) fp32, lse (rows, R) fp32 ->
// hi, lo (rows, Kp) fp32 planes of x = exp(l) (a_side != 0, with rowterm
// (rows,) fp32) or x = l (a_side == 0, rowterm unused), Kp a multiple of
// 4 at least R*C. lse is read when have_lse != 0, else written with the
// row statistics first. The grid is kernels/dequant_kl.py's
// split_geometry: gx blocks of WARPS rows. Returns cudaGetLastError(), or
// a refusal before the launch.
extern "C" int int8_pairwise_kl_split(const void* q, const void* scale,
                                      void* lse, void* hi, void* lo,
                                      void* rowterm, int rows, int R, int C,
                                      int Kp, int a_side, int have_lse,
                                      int gx, int gy, int block, int smem,
                                      void* stream) {
  const int K = R * C;
  if (Kp < K || Kp % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (gx < 1 || (long)gx * WARPS < rows || (long)(gx - 1) * WARPS >= rows ||
      gy != 1 || block != 32 * WARPS || smem != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = (K % 4 == 0 && aligned4(q)) ? split_kernel<4>
                                             : split_kernel<1>;
  kernel<<<gx, block, 0, s>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(lse), static_cast<float*>(hi),
      static_cast<float*>(lo), static_cast<float*>(rowterm), rows, R, C, Kp,
      a_side, have_lse);
  return static_cast<int>(cudaGetLastError());
}

// The thin kernel's resident blocks an SM at T thin rows, the vector
// width vec (4 when K % 4 == 0 and the many side's codes are 4-byte
// aligned, else 1) and smem bytes of dynamic shared memory, into
// *per_sm (a host int): the input of thin_geometry's persistent grid.
// The stream is unused. Returns a CUDA error code.
extern "C" int int8_pairwise_kl_thin_blocks(void* per_sm, int T, int vec,
                                            int smem, void* stream) {
  (void)stream;
  int* out = static_cast<int*>(per_sm);
#define BLOCKS_CASE(TB)                                                   \
  if (T <= TB)                                                            \
    return static_cast<int>(vec == 4 ? thin_blocks<TB, 4>(smem, out)      \
                                     : thin_blocks<TB, 1>(smem, out));
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  BLOCKS_CASE(1)
  BLOCKS_CASE(2)
  BLOCKS_CASE(4)
  BLOCKS_CASE(8)
  BLOCKS_CASE(16)
#undef BLOCKS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The thin side qt (T, R, C) with st, lt (T, R) against the many side qm
// (M, R, C) with sm, lm (M, R); all fp32 but the uint8 codes. thin_is_a
// says which side of D the thin one is: out is (T, M) if it is A, else
// (M, T). lt is read when have_lt != 0 (else computed in shared memory,
// lt unused); lm is read when have_lm != 0, else written with the many
// side's row statistics first. 1 <= T <= 16. The grid is
// thin_geometry's persistent one: gx blocks (at most the card's resident
// blocks) stride over the many side, each warp carrying rows_per_iter
// rows a pass, with ``smem`` bytes of dynamic shared memory for the thin
// side. Returns cudaGetLastError() after the launch, or a refusal before
// it.
extern "C" int int8_pairwise_kl_thin(const void* qt, const void* st,
                                     const void* lt, const void* qm,
                                     const void* sm, void* lm, void* out,
                                     int T, int M, int R, int C,
                                     int thin_is_a, int have_lt,
                                     int have_lm, int gx, int gy, int block,
                                     int smem, void* stream) {
  if (T < 1 || T > THIN_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const int K = R * C;
  const size_t need = sizeof(float) *
      ((size_t)T * K + T + (have_lt ? 0 : (size_t)T * R));
  if (gx < 1 || gy != 1 || block != 32 * WARPS || (size_t)smem != need)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && aligned4(qm);
  return static_cast<int>(
      vec ? thin_by_size<4>(qt, st, lt, qm, sm, lm, out, T, M, R, C,
                            thin_is_a, have_lt, have_lm, gx, block, smem, s)
          : thin_by_size<1>(qt, st, lt, qm, sm, lm, out, T, M, R, C,
                            thin_is_a, have_lt, have_lm, gx, block, smem,
                            s));
}
