// K1: GQA decode attention (one query token per row) over an fp KV cache.
//
// Replaces crane_tpu/ops/pallas/quant_attention.py::_fp_decode_attention
// (kernel _fp_kernel), reached through quant_decode_attention(bits=16), and
// its with-stats form (K1-S, decode_attention_with_stats(bits=16),
// return_stats=True): the same launch with m_out/l_out non-null also writes
// each head's softmax max and sum [B, Hq] float32, which the sequence-
// parallel merge needs (parallel/sequence.py). A run-time pointer, not a
// template parameter, so the instance count does not double.
//
// What it computes: q [B, 1, Hq, D] against k/v [B, T, Hkv, D] read as
// stored. Row b attends the slots [max(0, valid - window), valid) with
// valid = min(kv_valid[b], T); logits are scale * q.k, optionally
// softcapped as c * tanh(s / c); the softmax is online and in float32. A
// row with no slot to attend (valid == 0) writes zeros.
//
// What bounds it on an H100: the KV bytes. Each decoded token reads
// 2 * valid * Hkv * D * sizeof(T) bytes per layer and does about 4 * G
// FLOPs per element read, far too few per byte for compute to be the limit.
//
// What the design does about it: one thread block per (b, kv-head), so the
// G = Hq / Hkv query heads of a group share every K/V row read (the cache
// is read once, not G times). Each warp walks every WARPS-th group of
// UNROLL tokens up to the row's live length only -- slots past kv_valid are
// never read, whatever the allocated T -- with each lane loading a
// contiguous D/32 slice of a row, so a warp's load of one row is one
// coalesced 128/256/512-byte transaction. UNROLL independent rows (4, or 2
// at D = 256, where each lane holds 8 dims of q and acc per head) are in
// flight per warp before the reductions. Warps merge their partial (max,
// sum, acc) states in dynamic shared memory at the end: 8 * G * (D + 2)
// floats, above the 48 KB default at D = 256 and G >= 6, so the launch opts
// in. Split-KV across blocks and TMA staging are later work.
#include "common.cuh"

namespace crane {
namespace {

constexpr int kWarps = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_valid, T* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int T_len, int Hkv, float scale, int window,
                        float softcap) {
  constexpr int E = D / 32;  // elements of a row owned by one lane
  constexpr int kUnroll = decode_unroll<D>();
  const int b = blockIdx.y;
  const int hk = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int Hq = Hkv * G;

  const int valid = min(max(kv_valid[b], 0), T_len);
  const int lo = window > 0 ? max(0, valid - window) : 0;

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * Hq + hk * G + g) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = to_float(qp[e]);
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * T_len * row_stride + (size_t)hk * D + lane * E;
  const T* vb = v + (size_t)b * T_len * row_stride + (size_t)hk * D + lane * E;

  for (int t0 = lo + warp * kUnroll; t0 < valid; t0 += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool ok = t < valid;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kf[u][e] = ok ? to_float(kb[(size_t)t * row_stride + e]) : 0.f;
        vf[u][e] = ok ? to_float(vb[(size_t)t * row_stride + e]) : 0.f;
      }
    }
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[g][e] * kf[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u][g] = (t0 + u < valid) ? softcap_logit(part * scale, softcap)
                                   : -INFINITY;
      }
    }
    // s[0][g] is always finite (t0 < valid), so m_new is finite below
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, s[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = __expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = __expf(s[u][g] - m_new);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vf[u][e];
      }
      m[g] = m_new;
    }
  }

  extern __shared__ float smem[];
  const size_t head0 = (size_t)b * Hq + hk * G;  // the group's first q-head
  merge_warp_states<T, G, D, E, kWarps>(
      smem, m, l, acc, [lane](int e) { return lane * E + e; }, out + head0 * D,
      m_out != nullptr ? m_out + head0 : nullptr,
      l_out != nullptr ? l_out + head0 : nullptr);
}

template <typename T, int D, int G>
void launch(const void* q, const void* k, const void* v, const int* kv_valid,
            void* out, float* m_out, float* l_out, int B, int T_len, int Hkv,
            float scale, int window, float softcap, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  constexpr size_t smem = merge_smem_bytes<G, D, kWarps>();
  allow_dynamic_smem(decode_attention_kernel<T, D, G>, smem);
  decode_attention_kernel<T, D, G><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_valid, static_cast<T*>(out), m_out, l_out,
      T_len, Hkv, scale, window, softcap);
}

template <typename T, int D>
bool dispatch_group(int G, const void* q, const void* k, const void* v,
                    const int* kv_valid, void* out, float* m_out, float* l_out,
                    int B, int T_len, int Hkv, float scale, int window,
                    float softcap, cudaStream_t stream) {
  switch (G) {
#define CRANE_CASE(g)                                                      \
  case g:                                                                  \
    launch<T, D, g>(q, k, v, kv_valid, out, m_out, l_out, B, T_len, Hkv,  \
                    scale, window, softcap, stream);                       \
    return true;
    CRANE_CASE(1) CRANE_CASE(2) CRANE_CASE(3) CRANE_CASE(4)
    CRANE_CASE(5) CRANE_CASE(6) CRANE_CASE(7) CRANE_CASE(8)
#undef CRANE_CASE
    default:
      return false;
  }
}

template <typename T>
bool dispatch_dim(int D, int G, const void* q, const void* k, const void* v,
                  const int* kv_valid, void* out, float* m_out, float* l_out,
                  int B, int T_len, int Hkv, float scale, int window,
                  float softcap, cudaStream_t stream) {
  if (D == 64)
    return dispatch_group<T, 64>(G, q, k, v, kv_valid, out, m_out, l_out, B,
                                 T_len, Hkv, scale, window, softcap, stream);
  if (D == 128)
    return dispatch_group<T, 128>(G, q, k, v, kv_valid, out, m_out, l_out, B,
                                  T_len, Hkv, scale, window, softcap, stream);
  if (D == 256)
    return dispatch_group<T, 256>(G, q, k, v, kv_valid, out, m_out, l_out, B,
                                  T_len, Hkv, scale, window, softcap, stream);
  return false;
}

}  // namespace
}  // namespace crane

// q [B,1,Hq,D], k/v [B,T,Hkv,D], kv_valid [B] int32, out [B,1,Hq,D]; all
// contiguous, on the device of `stream`. m_out/l_out [B,Hq] float32, both
// NULL (K1) or both set (K1-S). window <= 0 and softcap <= 0 mean "off".
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a dtype/head-dim/group the kernel does not take.
extern "C" int crane_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* kv_valid,
                                      void* out, void* m_out, void* l_out,
                                      int B, int T_len, int Hq, int Hkv, int D,
                                      float scale, int window, float softcap,
                                      void* stream) {
  using namespace crane;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int* valid = static_cast<const int*>(kv_valid);
  float* ms = static_cast<float*>(m_out);
  float* ls = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kBFloat16)
    ok = dispatch_dim<__nv_bfloat16>(D, G, q, k, v, valid, out, ms, ls, B,
                                     T_len, Hkv, scale, window, softcap, s);
  else if (dtype == kFloat32)
    ok = dispatch_dim<float>(D, G, q, k, v, valid, out, ms, ls, B, T_len, Hkv,
                             scale, window, softcap, s);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
