// K4: GQA decode attention over an int8 / packed-int4 KV cache, with the
// dequantization folded into the logits and the output sums.
//
// Replaces crane_tpu/ops/pallas/quant_attention.py::_quant_decode_attention
// (kernel _kernel), reached through quant_decode_attention with bits 8 and
// 4: one query token per row over the quantized cache; and its with-stats
// form (K4-S, decode_attention_with_stats(bits=8/4), return_stats=True): with
// m_out/l_out non-null the same launch also writes each head's softmax max
// and sum [B, Hq] float32 for the sequence-parallel merge. The pointers are
// run-time arguments, so the 96 instances do not double.
//
// Cache layout (ops/kv_cache.py QuantLayerKVCache): codes [B, T, Hkv *
// stored] int8, head h's bytes at columns [h * stored, (h + 1) * stored);
// stored = D for int8; stored = D / 2 for int4, byte j holding dim j (low)
// and dim j + D / 2 (high) as 16 * hi + lo. Scales [B, Hkv, T] float32, one
// per (token, kv-head). A key is code * scale; the kernel never writes it
// out: per token, s = (q . code) * k_scale * scale and
// acc += (p * v_scale) * code, the TPU kernel's fold (quant_attention.py
// :102-148). Everything is float32 after the load.
//
// What bounds it on an H100: the KV bytes (codes plus 4 bytes of scale per
// token and kv-head), as for K1; int8 halves bf16's bytes and int4 quarters
// them, which is why the cache exists.
//
// What the design does about it: K1's design. One block per (row,
// kv-head), so the G query heads of a group share every code row read; 8
// warps walk groups of 4 tokens (2 at D = 256) up to the row's live length
// only; each lane loads its D/32 bytes (int8) or D/64 bytes (int4) of a row
// as one or two words, a warp's load being one coalesced row. The scale of
// a token is one broadcast load from the (row, kv-head)'s contiguous scale
// row. The TPU kernel's block-diagonal q operand and 0/1 scale-expansion
// matrix (:316-332, :106-113) were MXU layout work-arounds and are gone.
// The warps merge in dynamic shared memory (above 48 KB at D = 256 and
// G >= 6). A row with no key to attend writes zeros (the TPU kernel's empty
// denominator guard, :153-154). Split-KV and TMA are later work.
#include "common.cuh"

namespace crane {
namespace {

constexpr int kWarps = 8;

template <int D, int BITS>
struct LaneSlice {
  static constexpr int kStored = BITS == 4 ? D / 2 : D;  // bytes a token-head
  static constexpr int kBytes = kStored / 32;            // bytes a lane loads
  static constexpr int kWords = (kBytes + 3) / 4;        // as 32-bit words
  static constexpr int kDims = D / 32;                   // dims a lane owns
  // the head dim of a lane's e-th value: int8 owns dims lane*kDims + e;
  // int4 owns the low and the high dims of its bytes
  static __device__ __forceinline__ int dim(int lane, int e) {
    if constexpr (BITS == 4)
      return e < kBytes ? lane * kBytes + e : D / 2 + lane * kBytes + e - kBytes;
    else
      return lane * kDims + e;
  }
  // the lane's codes of one token-head (a zero word when !ok), as floats,
  // in dim(lane, e) order
  static __device__ __forceinline__ void load(const int8_t* p, bool ok,
                                              float (&c)[kDims]) {
    uint32_t w[kWords] = {};
    if (ok) load_bytes<kBytes>(p, w);
#pragma unroll
    for (int e = 0; e < kBytes; ++e) {
      const int byte = byte_of(w[e / 4], e % 4);
      if constexpr (BITS == 4) {
        c[e] = static_cast<float>(int4_lo(byte));
        c[kBytes + e] = static_cast<float>(int4_hi(byte));
      } else {
        c[e] = static_cast<float>(byte);
      }
    }
  }
};

template <typename T, int D, int G, int BITS>
__global__ void __launch_bounds__(kWarps * 32)
quant_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                    const int8_t* __restrict__ vc,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ kv_valid, T* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int T_len, int Hkv, float scale, int window,
                    float softcap) {
  using L = LaneSlice<D, BITS>;
  constexpr int E = L::kDims;
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
    const T* qp = q + ((size_t)b * Hq + hk * G + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = to_float(qp[L::dim(lane, e)]);
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * L::kStored;
  const size_t base = (size_t)b * T_len * row_stride + (size_t)hk * L::kStored +
                      lane * L::kBytes;
  const float* ksr = ks + ((size_t)b * Hkv + hk) * T_len;
  const float* vsr = vs + ((size_t)b * Hkv + hk) * T_len;

  for (int t0 = lo + warp * kUnroll; t0 < valid; t0 += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E], ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool ok = t < valid;
      const size_t off = base + (size_t)t * row_stride;
      L::load(kc + off, ok, kf[u]);
      L::load(vc + off, ok, vf[u]);
      ksc[u] = ok ? ksr[t] : 0.f;
      vsc[u] = ok ? vsr[t] : 0.f;
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
        s[u][g] = (t0 + u < valid)
                      ? softcap_logit(part * ksc[u] * scale, softcap)
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
        const float pv = p * vsc[u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += pv * vf[u][e];
      }
      m[g] = m_new;
    }
  }

  extern __shared__ float smem[];
  const size_t head0 = (size_t)b * Hq + hk * G;  // the group's first q-head
  merge_warp_states<T, G, D, E, kWarps>(
      smem, m, l, acc, [lane](int e) { return L::dim(lane, e); },
      out + head0 * D, m_out != nullptr ? m_out + head0 : nullptr,
      l_out != nullptr ? l_out + head0 : nullptr);
}

struct DecodeArgs {
  const void* q;
  const int8_t* kc;
  const int8_t* vc;
  const float* ks;
  const float* vs;
  const int* kv_valid;
  void* out;
  float* m_out;  // NULL, or [B, Hq] float32 (the with-stats form)
  float* l_out;
  int B, T_len, Hkv;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int D, int G, int BITS>
void launch_decode(const DecodeArgs& a) {
  dim3 grid(a.Hkv, a.B);
  constexpr size_t smem = merge_smem_bytes<G, D, kWarps>();
  allow_dynamic_smem(quant_decode_kernel<T, D, G, BITS>, smem);
  quant_decode_kernel<T, D, G, BITS><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.kc, a.vc, a.ks, a.vs, a.kv_valid,
      static_cast<T*>(a.out), a.m_out, a.l_out, a.T_len, a.Hkv, a.scale,
      a.window, a.softcap);
}

template <typename T, int D, int BITS>
bool decode_group(int G, const DecodeArgs& a) {
  switch (G) {
#define CRANE_CASE(g)                  \
  case g:                              \
    launch_decode<T, D, g, BITS>(a);   \
    return true;
    CRANE_CASE(1) CRANE_CASE(2) CRANE_CASE(3) CRANE_CASE(4)
    CRANE_CASE(5) CRANE_CASE(6) CRANE_CASE(7) CRANE_CASE(8)
#undef CRANE_CASE
    default:
      return false;
  }
}

template <typename T>
bool decode_dispatch(int bits, int D, int G, const DecodeArgs& a) {
  if (D == 64 && bits == 8) return decode_group<T, 64, 8>(G, a);
  if (D == 64 && bits == 4) return decode_group<T, 64, 4>(G, a);
  if (D == 128 && bits == 8) return decode_group<T, 128, 8>(G, a);
  if (D == 128 && bits == 4) return decode_group<T, 128, 4>(G, a);
  if (D == 256 && bits == 8) return decode_group<T, 256, 8>(G, a);
  if (D == 256 && bits == 4) return decode_group<T, 256, 4>(G, a);
  return false;
}

}  // namespace
}  // namespace crane

// q [B,1,Hq,D]; k/v codes [B,T,Hkv*stored] int8; k/v scales [B,Hkv,T]
// float32; kv_valid [B] int32; out [B,1,Hq,D]; m_out/l_out [B,Hq] float32,
// both NULL (K4) or both set (K4-S); all contiguous, on the device of
// `stream`. window <= 0 and softcap <= 0 mean "off". Returns the CUDA error
// of the launch (0 on success), or cudaErrorInvalidValue for a dtype, bit
// width, head dim or group the kernel does not take.
extern "C" int crane_quant_decode_attention(
    int dtype, int bits, const void* q, const void* kc, const void* vc,
    const void* ks, const void* vs, const void* kv_valid, void* out,
    void* m_out, void* l_out, int B, int T_len, int Hq, int Hkv, int D,
    float scale, int window, float softcap, void* stream) {
  using namespace crane;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  const DecodeArgs a{q, static_cast<const int8_t*>(kc),
                     static_cast<const int8_t*>(vc),
                     static_cast<const float*>(ks),
                     static_cast<const float*>(vs),
                     static_cast<const int*>(kv_valid), out,
                     static_cast<float*>(m_out), static_cast<float*>(l_out),
                     B, T_len, Hkv, scale, window, softcap,
                     static_cast<cudaStream_t>(stream)};
  const int G = Hq / Hkv;
  bool ok = false;
  if (dtype == kBFloat16)
    ok = decode_dispatch<__nv_bfloat16>(bits, D, G, a);
  else if (dtype == kFloat32)
    ok = decode_dispatch<float>(bits, D, G, a);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
