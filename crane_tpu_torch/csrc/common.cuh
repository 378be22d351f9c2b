// Helpers shared by the kernels: element conversion between the storage
// types (float32, bfloat16) and the float32 the kernels compute in, the
// int8 / packed-int4 code arithmetic, the head-dim tiling of the prefill
// and decode kernels, and the cross-warp softmax merge of the decode
// kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace crane {

// Storage type codes passed from Python (ops/cuda/build.py DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float softcap_logit(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// Signed byte k (0..3) of a 32-bit word, sign-extended.
__device__ __forceinline__ int byte_of(uint32_t w, int k) {
  return static_cast<int>(w << (24 - 8 * k)) >> 24;
}

// The reference's arithmetic int4 packing, byte = 16 * hi + lo with both
// codes in [-7, 7]: hi = floor((byte + 8) / 16), lo = byte - 16 * hi. The
// arithmetic shift is the floor, exact for every packed byte.
__device__ __forceinline__ int int4_hi(int byte) { return (byte + 8) >> 4; }
__device__ __forceinline__ int int4_lo(int byte) {
  return byte - 16 * int4_hi(byte);
}

// N (1, 2, 4 or 8) consecutive bytes as the low bytes of (N + 3) / 4
// words; p is N-aligned.
template <int N>
__device__ __forceinline__ void load_bytes(const int8_t* p,
                                           uint32_t (&w)[(N + 3) / 4]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "1, 2, 4 or 8 bytes");
  if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint8_t*>(p);
  }
}

// The head-dim policy of the prefill kernels (K2, K3, K5): a block owns
// kBlockQ query rows, kTPR threads share a row (each owning the dims c,
// c + kTPR, ...) and kBlockK keys are staged per tile. Up to D = 128 that
// is 4 threads and 32 keys; at D = 256, 8 threads and 16 keys, so a thread
// still holds 32 dims of q and of the accumulator and the float32 K/V
// staging stays at 32 KB, under the 48 KB static shared-memory limit.
template <int D>
struct RowTile {
  static constexpr int kBlockQ = 32;
  static constexpr int kTPR = D > 128 ? 8 : 4;
  static constexpr int kBlockK = D > 128 ? 16 : 32;
  static constexpr int kThreads = kBlockQ * kTPR;
};

// Tokens a decode warp (K1, K4) has in flight: 4, or 2 at D = 256, where a
// lane already holds 8 dims of q and of the accumulator per head.
template <int D>
__host__ __device__ constexpr int decode_unroll() {
  return D > 128 ? 2 : 4;
}

// Dynamic shared memory of a decode kernel's cross-warp merge: m and l
// [kWarps][G] and acc [kWarps][G][D], float32. At D = 256 and G >= 6 this
// passes the 48 KB a block gets without opting in.
template <int G, int D, int kWarps>
constexpr size_t merge_smem_bytes() {
  return sizeof(float) * kWarps * G * (D + 2);
}

// Opt a kernel into `bytes` of dynamic shared memory when that passes the
// default 48 KB (a refusal shows in cudaGetLastError, as a failed launch).
template <typename Kernel>
inline void allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

// The end of a decode kernel: kWarps warps each hold a partial online
// softmax state (max m, sum l, unnormalised output acc) for the G query
// heads of one (row, kv-head). Each warp stores its state into the dynamic
// shared memory `smem` (merge_smem_bytes), then the block merges them and
// writes out[g * D + d]; acc_at(e) is the head dim of the lane's e-th
// value. A head no warp saw (every m = -inf: an empty row) writes zeros.
// With stats (m_out, l_out non-null, the with-stats form) the merged
// running max M and sum L of head g go to m_out[g] and l_out[g]: M in
// natural-log units of the scaled, softcapped logits, L = sum exp(s - M).
// An empty head keeps M = -INFINITY (the TPU kernel writes -1e30) and
// L = 0; a merge across slabs weighs it by l > 0 ? ... : 0, never by M.
template <typename T, int G, int D, int E, int kWarps, typename DimOf>
__device__ __forceinline__ void merge_warp_states(
    float* smem, const float (&m)[G], const float (&l)[G],
    const float (&acc)[G][E], DimOf acc_at, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out) {
  float(&sm_m)[kWarps][G] = *reinterpret_cast<float(*)[kWarps][G]>(smem);
  float(&sm_l)[kWarps][G] =
      *reinterpret_cast<float(*)[kWarps][G]>(smem + kWarps * G);
  float(&sm_acc)[kWarps][G][D] =
      *reinterpret_cast<float(*)[kWarps][G][D]>(smem + 2 * kWarps * G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][acc_at(e)] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float res = 0.f, L = 0.f;
    if (M != -INFINITY) {
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = __expf(sm_m[w][g] - M);  // 0 for an idle warp
        L += sm_l[w][g] * c;
        A += sm_acc[w][g][d] * c;
      }
      res = A / L;
    }
    out[g * D + d] = from_float<T>(res);
    if (m_out != nullptr && d == 0) {
      m_out[g] = M;
      l_out[g] = L;
    }
  }
}

}  // namespace crane
