// Helpers shared by the kernels: element conversion between the storage
// types (float32, bfloat16) and the float32 the kernels compute in, the
// int8 / packed-int4 code arithmetic, the head-dim tiling of the prefill
// kernels, and the log-sum-exp merge of the split-KV decode kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// Opt a kernel into `bytes` of dynamic shared memory when that, with up to
// 1 KB of static shared memory beside it, may pass the default 48 KB (a
// refusal shows in cudaGetLastError, as a failed launch).
template <typename Kernel>
inline void allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes + 1024 > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

// allow_dynamic_smem once per device for a kernel launched on the host's
// hot path: `devices` (one per kernel) holds a bit for each device the
// attribute is set on, which lasts for the process.
template <typename Kernel>
inline void allow_dynamic_smem_once(Kernel kernel, size_t bytes, std::atomic<uint64_t>& devices) {
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (devices.load(std::memory_order_relaxed) & bit)) return;
  allow_dynamic_smem(kernel, bytes);
  devices.fetch_or(bit, std::memory_order_relaxed);
}

// The log-sum-exp combine of the split-KV decode kernels (as
// parallel/sequence.py merge_partials combines slabs), by one block of at
// least 32 * G threads: head g's n partial states are max m[g * n + s], sum
// l[g * n + s] and unnormalised output acc[(g * n + s) * D + d], float32.
// With M = max_s m and c_s = exp(m_s - M), out[g * D + d] = sum_s acc_s c_s
// / L, L = sum_s l_s c_s. A part that saw no key (m = -inf, l = 0, acc = 0)
// weighs 0; a head no part saw writes 0, and with stats (m_out non-null)
// M = -inf and L = 0 to m_out[g] and l_out[g]. Warp g finds head g's M, L
// and weights c_s (into smem: G * (n + 2) floats), then every thread sums
// the parts of four (head, dim)s in split order. The parts are read through
// L2 (__ldcg): other blocks wrote them during this launch.
template <typename T>
__device__ void merge_split_states(const float* acc, const float* m, const float* l, int n,
                                   int G, int D, T* out, float* m_out, float* l_out,
                                   float* smem) {
  float* sm_M = smem;
  float* sm_L = smem + G;
  float* weight = smem + 2 * G;  // [G][n]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < G) {
    const float* mg = m + warp * n;
    float M = -INFINITY;
    for (int s = lane; s < n; s += 32) M = fmaxf(M, __ldcg(mg + s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float c = M == -INFINITY ? 0.f : __expf(__ldcg(mg + s) - M);
      weight[warp * n + s] = c;
      L += __ldcg(l + warp * n + s) * c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) {
      sm_M[warp] = M;
      sm_L[warp] = L;
    }
  }
  __syncthreads();
  // four dims a thread, one 16-byte load a part (D is a multiple of 4 and
  // acc 16-byte aligned)
  for (int i = 4 * threadIdx.x; i < G * D; i += 4 * blockDim.x) {
    const int g = i / D;
    const float4* a = reinterpret_cast<const float4*>(acc + (size_t)g * n * D + i % D);
    const float* w = weight + g * n;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float4 x = __ldcg(a + (size_t)s * (D / 4));
      A.x += x.x * w[s];
      A.y += x.y * w[s];
      A.z += x.z * w[s];
      A.w += x.w * w[s];
    }
    const bool empty = sm_M[g] == -INFINITY;
    const float L = sm_L[g];
    out[i] = from_float<T>(empty ? 0.f : A.x / L);
    out[i + 1] = from_float<T>(empty ? 0.f : A.y / L);
    out[i + 2] = from_float<T>(empty ? 0.f : A.z / L);
    out[i + 3] = from_float<T>(empty ? 0.f : A.w / L);
    if (m_out != nullptr && i % D == 0) {
      m_out[g] = sm_M[g];
      l_out[g] = L;
    }
  }
}

}  // namespace crane
