// Helpers shared by the kernels: element conversion between the storage
// types (float32, bfloat16) and the float32 the kernels compute in, the
// int8 / packed-int4 code arithmetic, and the cross-warp softmax merge of
// the decode kernels.
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

// N (1, 2 or 4) consecutive bytes as the low bytes of a word; p is
// N-aligned.
template <int N>
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p) {
  static_assert(N == 1 || N == 2 || N == 4, "1, 2 or 4 bytes");
  if constexpr (N == 4) return *reinterpret_cast<const uint32_t*>(p);
  if constexpr (N == 2) return *reinterpret_cast<const uint16_t*>(p);
  return *reinterpret_cast<const uint8_t*>(p);
}

// The end of a decode kernel: kWarps warps each hold a partial online
// softmax state (max m, sum l, unnormalised output acc) for the G query
// heads of one (row, kv-head), stored in shared memory. The block merges
// them and writes out[g * D + d]. A head no warp saw (every m = -inf: an
// empty row) writes zeros.
template <typename T, int G, int D, int kWarps>
__device__ __forceinline__ void merge_warp_states(
    const float (&sm_m)[kWarps][G], const float (&sm_l)[kWarps][G],
    const float (&sm_acc)[kWarps][G][D], T* __restrict__ out) {
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float res = 0.f;
    if (M != -INFINITY) {
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = __expf(sm_m[w][g] - M);  // 0 for an idle warp
        L += sm_l[w][g] * c;
        A += sm_acc[w][g][d] * c;
      }
      res = A / L;
    }
    out[g * D + d] = from_float<T>(res);
  }
}

}  // namespace crane
