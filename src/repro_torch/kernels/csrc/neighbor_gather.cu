// Eq. 5 distillation targets on Hopper, as a gather over the neighbor
// lists: T[n, :] = sum_{j<K} w[n,j] S[nbr[n,j], :], nbr (N x K) int32,
// w (N x K) fp32 slot weights (0 on unrealized slots), S (N x RC) fp32
// or bf16 messenger probabilities, T (N x RC) fp32.
//
// Replaces: src/repro/kernels/neighbor_mean.py::_kernel, the Pallas TPU
// kernel behind neighbor_mean, on the graphs the policies build (at most
// K nonzeros a row). On a dense W with exactly these nonzeros it computes
// the same function; neighbor_mean.cu keeps the dense interface.
//
// Bound on this card: bytes. The function reads the rows of S that some
// list references (each once; at N = 4096 all of S, 39 MB, fits the
// 50 MB L2, so a row gathered by several lists comes from HBM once),
// reads the lists (8 bytes a slot) and writes T once: ~79 MB at N = 4096,
// RC = 2400, K = 8, ~24 us at 3.35 TB/s. The products are 2 N K RC flops,
// far below any compute bound.
//
// Design: one block per row n, rows in index order with no staging copy,
// so the rows of S that neighboring rows share stay hot in L2. The
// block first copies its K slots (index and weight) into shared memory;
// its threads then walk the RC axis with 16-byte loads (4 fp32, or 8
// bf16 widened to fp32 in registers) and 16-byte stores, each summing
// its columns over the slots j = 0..K-1 in ascending order: one fixed
// sum order per element, no atomics. When RC is not a multiple of the
// vector width, or a base pointer is not 16-byte aligned, the rows do
// not start 16-byte aligned and the kernel takes scalar loads instead;
// it never casts a misaligned pointer to a vector type and never reads
// past a row's end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 128;

// v[0..V) = p[0..V), widened to fp32; V == 1 is the scalar path
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    static_assert(V == 1, "fp32 loads are 1 or 4 wide");
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of the fp32 with the same value
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
    static_assert(V == 1, "bf16 loads are 1 or 8 wide");
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
neighbor_gather_kernel(const int* __restrict__ nbr,
                       const float* __restrict__ w,
                       const T* __restrict__ s, float* __restrict__ out,
                       int K, int RC) {
  extern __shared__ unsigned char slots[];
  int* snbr = reinterpret_cast<int*>(slots);
  float* sw = reinterpret_cast<float*>(snbr + K);
  const size_t n = blockIdx.x;
  for (int j = threadIdx.x; j < K; j += THREADS) {
    snbr[j] = nbr[n * K + j];
    sw[j] = w[n * K + j];
  }
  __syncthreads();

  float* dst = out + n * RC;
  for (int c = threadIdx.x * V; c < RC; c += THREADS * V) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      float v[V];
      load<V>(s + (size_t)snbr[j] * RC + c, v);
      const float wj = sw[j];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(wj, v[e], acc[e]);
    }
    store<V>(dst + c, acc);
  }
}

template <typename T, int V>
cudaError_t launch(const void* nbr, const void* w, const void* s, void* out,
                   int N, int K, int RC, cudaStream_t st) {
  neighbor_gather_kernel<T, V>
      <<<N, THREADS, (size_t)K * (sizeof(int) + sizeof(float)), st>>>(
          static_cast<const int*>(nbr), static_cast<const float*>(w),
          static_cast<const T*>(s), static_cast<float*>(out), K, RC);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// nbr (N, K) int32 in [0, N), w (N, K) fp32, s (N, RC) fp32 (bf16 == 0)
// or bf16, out (N, RC) fp32. Returns cudaGetLastError() after the launch.
extern "C" int neighbor_gather(const void* nbr, const void* w, const void* s,
                               void* out, int N, int K, int RC, int bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(s) && aligned16(out);
  cudaError_t err;
  if (bf16) {
    err = vec && RC % 8 == 0
              ? launch<__nv_bfloat16, 8>(nbr, w, s, out, N, K, RC, st)
              : launch<__nv_bfloat16, 1>(nbr, w, s, out, N, K, RC, st);
  } else {
    err = vec && RC % 4 == 0 ? launch<float, 4>(nbr, w, s, out, N, K, RC, st)
                             : launch<float, 1>(nbr, w, s, out, N, K, RC, st);
  }
  return static_cast<int>(err);
}
