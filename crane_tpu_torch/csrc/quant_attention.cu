// K4 and K5: GQA attention over an int8 / packed-int4 KV cache, with the
// dequantization folded into the logits and the output sums.
//
// Replaces crane_tpu/ops/pallas/quant_attention.py:
//   K4 _quant_decode_attention / _kernel (quant_decode_attention, bits 8
//      and 4): one query token per row over the quantized cache;
//   K5 _cached_attention / _cached_kernel (quant_cached_attention, bits 8
//      and 4): a continuation chunk of S queries at absolute positions.
//
// Cache layout (ops/kv_cache.py QuantLayerKVCache): codes [B, T, Hkv *
// stored] int8, head h's bytes at columns [h * stored, (h + 1) * stored);
// stored = D for int8; stored = D / 2 for int4, byte j holding dim j (low)
// and dim j + D / 2 (high) as 16 * hi + lo. Scales [B, Hkv, T] float32, one
// per (token, kv-head). A key is code * scale; the kernels never write it
// out: per token, s = (q . code) * k_scale * scale and
// acc += (p * v_scale) * code, the TPU kernels' fold (quant_attention.py
// :102-148). Everything is float32 after the load; nothing rounds p * vs
// to bf16 (the TPU kernel does, :529).
//
// What bounds them on an H100: the KV bytes (codes plus 4 bytes of scale
// per token and kv-head), as for K1 and K3; int8 halves bf16's bytes and
// int4 quarters them, which is why the cache exists.
//
// What the designs do about it:
//   K4 takes K1's design: one block per (row, kv-head), so the G query
//      heads of a group share every code row read; 8 warps walk groups of 4
//      tokens up to the row's live length only; each lane loads its D/32
//      bytes (int8) or D/64 bytes (int4) of a row as one word, a warp's load
//      being one coalesced 128- or 64-byte row. The scale of a token is one
//      broadcast load from the (row, kv-head)'s contiguous scale row. The
//      TPU kernel's block-diagonal q operand and 0/1 scale-expansion matrix
//      (:316-332, :106-113) were MXU layout work-arounds and are gone.
//   K5 takes K3's design: one block per (32 queries, q-head, row), looping
//      over 32-key tiles only inside the causal/window band of its rows;
//      each tile's codes are unpacked once into float32 shared memory, the
//      scales beside them, and read by all 32 rows. Positions past the
//      buffer (bucket-padded tail rows) are clamped to T - 1
//      (quant_attention.py:589).
// A row with no key to attend writes zeros (the TPU kernels' empty
// denominator guard, :153-154 and :553-555). mma/wgmma tiles, TMA and
// split-KV are later work.
#include "common.cuh"

namespace crane {
namespace {

// ---- K4: decode -----------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

template <int D, int BITS>
struct LaneSlice {
  static constexpr int kStored = BITS == 4 ? D / 2 : D;  // bytes a token-head
  static constexpr int kBytes = kStored / 32;            // bytes a lane loads
  static constexpr int kDims = D / 32;                   // dims a lane owns
  // the head dim of a lane's e-th value: int8 owns dims lane*kDims + e;
  // int4 owns the low and the high dims of its bytes
  static __device__ __forceinline__ int dim(int lane, int e) {
    if constexpr (BITS == 4)
      return e < kBytes ? lane * kBytes + e : D / 2 + lane * kBytes + e - kBytes;
    else
      return lane * kDims + e;
  }
  // the lane's codes of one token-head, as floats, in dim(lane, e) order
  static __device__ __forceinline__ void unpack(uint32_t word,
                                                float (&c)[kDims]) {
#pragma unroll
    for (int e = 0; e < kBytes; ++e) {
      const int byte = byte_of(word, e);
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
                    int T_len, int Hkv, float scale, int window,
                    float softcap) {
  using L = LaneSlice<D, BITS>;
  constexpr int E = L::kDims;
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
      L::unpack(ok ? load_bytes<L::kBytes>(kc + off) : 0u, kf[u]);
      L::unpack(ok ? load_bytes<L::kBytes>(vc + off) : 0u, vf[u]);
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

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][L::dim(lane, e)] = acc[g][e];
  }
  __syncthreads();
  merge_warp_states<T, G, D, kWarps>(sm_m, sm_l, sm_acc,
                                     out + ((size_t)b * Hq + hk * G) * D);
}

struct DecodeArgs {
  const void* q;
  const int8_t* kc;
  const int8_t* vc;
  const float* ks;
  const float* vs;
  const int* kv_valid;
  void* out;
  int B, T_len, Hkv;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int D, int G, int BITS>
void launch_decode(const DecodeArgs& a) {
  dim3 grid(a.Hkv, a.B);
  quant_decode_kernel<T, D, G, BITS><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), a.kc, a.vc, a.ks, a.vs, a.kv_valid,
      static_cast<T*>(a.out), a.T_len, a.Hkv, a.scale, a.window, a.softcap);
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
  return false;
}

// ---- K5: continuation chunk -----------------------------------------------

constexpr int kBlockQ = 32;            // query rows per block
constexpr int kBlockK = 32;            // keys per tile
constexpr int kThreadsC = kBlockQ * 4;  // four threads per query row

template <typename T, int D, int BITS>
__global__ void __launch_bounds__(kThreadsC)
quant_cached_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                    const int8_t* __restrict__ vc,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    T* __restrict__ out, const int* __restrict__ positions,
                    int S, int Tk, int Hkv, int G, float scale, int window,
                    float softcap) {
  constexpr int NE = D / 4;  // dims owned by one thread: c, c + 4, ...
  constexpr int kStored = BITS == 4 ? D / 2 : D;
  __shared__ float Ks[kBlockK][D];  // codes as floats, unscaled
  __shared__ float Vs[kBlockK][D];
  __shared__ float ksc[kBlockK], vsc[kBlockK];
  __shared__ int band_lo, band_hi;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int r = tid / 4;  // query row within the tile
  const int c = tid % 4;  // this thread's dim lane
  const int qi = q0 + r;
  const bool live = qi < S;
  const int p = live ? min(positions[(size_t)b * S + qi], Tk - 1) : 0;

  if (tid == 0) {
    band_lo = 0x7fffffff;
    band_hi = -1;
  }
  __syncthreads();
  if (live && c == 0) {
    atomicMin(&band_lo, p);
    atomicMax(&band_hi, p);
  }
  __syncthreads();
  const int kv_lo = window > 0 ? max(0, band_lo - window + 1) : 0;
  const int kv_hi = band_hi;  // inclusive

  float qr[NE], acc[NE];
  const T* qp = q + (((size_t)b * S + (live ? qi : 0)) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    qr[i] = live ? to_float(qp[c + 4 * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const size_t row_stride = (size_t)Hkv * kStored;
  const int8_t* kb = kc + (size_t)b * Tk * row_stride + (size_t)hk * kStored;
  const int8_t* vb = vc + (size_t)b * Tk * row_stride + (size_t)hk * kStored;
  const float* ksr = ks + ((size_t)b * Hkv + hk) * Tk;
  const float* vsr = vs + ((size_t)b * Hkv + hk) * Tk;

  for (int kt = (kv_lo / kBlockK) * kBlockK; kt <= kv_hi; kt += kBlockK) {
    for (int idx = tid; idx < kBlockK * kStored; idx += kThreadsC) {
      const int j = idx / kStored;
      const int byte_col = idx % kStored;
      const int t = kt + j;
      const bool in = t < Tk;
      const int kbyte = in ? kb[(size_t)t * row_stride + byte_col] : 0;
      const int vbyte = in ? vb[(size_t)t * row_stride + byte_col] : 0;
      if constexpr (BITS == 4) {
        Ks[j][byte_col] = static_cast<float>(int4_lo(kbyte));
        Ks[j][byte_col + D / 2] = static_cast<float>(int4_hi(kbyte));
        Vs[j][byte_col] = static_cast<float>(int4_lo(vbyte));
        Vs[j][byte_col + D / 2] = static_cast<float>(int4_hi(vbyte));
      } else {
        Ks[j][byte_col] = static_cast<float>(kbyte);
        Vs[j][byte_col] = static_cast<float>(vbyte);
      }
    }
    if (tid < kBlockK) {
      const int t = kt + tid;
      ksc[tid] = t < Tk ? ksr[t] : 0.f;
      vsc[tid] = t < Tk ? vsr[t] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NE; ++i) part += qr[i] * Ks[j][c + 4 * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int t = kt + j;
      const bool ok = live && t < Tk && t <= p && (window <= 0 || t > p - window);
      s[j] = ok ? softcap_logit(part * ksc[j] * scale, softcap) : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    if (m_new != -INFINITY) {
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NE; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __expf(s[j] - m_new);
        l += pj;
        const float pv = pj * vsc[j];
#pragma unroll
        for (int i = 0; i < NE; ++i) acc[i] += pv * Vs[j][c + 4 * i];
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (live) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = out + (((size_t)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NE; ++i) op[c + 4 * i] = from_float<T>(acc[i] * inv);
  }
}

template <typename T, int D, int BITS>
void launch_cached(const void* q, const int8_t* kc, const int8_t* vc,
                   const float* ks, const float* vs, void* out,
                   const int* positions, int B, int S, int Tk, int Hq,
                   int Hkv, float scale, int window, float softcap,
                   cudaStream_t stream) {
  dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  quant_cached_kernel<T, D, BITS><<<grid, kThreadsC, 0, stream>>>(
      static_cast<const T*>(q), kc, vc, ks, vs, static_cast<T*>(out),
      positions, S, Tk, Hkv, Hq / Hkv, scale, window, softcap);
}

template <typename T>
bool cached_dispatch(int bits, int D, const void* q, const int8_t* kc,
                     const int8_t* vc, const float* ks, const float* vs,
                     void* out, const int* pos, int B, int S, int Tk, int Hq,
                     int Hkv, float scale, int window, float softcap,
                     cudaStream_t st) {
#define CRANE_CACHED(d, bb)                                                  \
  if (D == d && bits == bb) {                                                \
    launch_cached<T, d, bb>(q, kc, vc, ks, vs, out, pos, B, S, Tk, Hq, Hkv, \
                            scale, window, softcap, st);                     \
    return true;                                                             \
  }
  CRANE_CACHED(64, 8) CRANE_CACHED(64, 4) CRANE_CACHED(128, 8)
  CRANE_CACHED(128, 4)
#undef CRANE_CACHED
  return false;
}

}  // namespace
}  // namespace crane

// q [B,1,Hq,D]; k/v codes [B,T,Hkv*stored] int8; k/v scales [B,Hkv,T]
// float32; kv_valid [B] int32; out [B,1,Hq,D]; all contiguous, on the
// device of `stream`. window <= 0 and softcap <= 0 mean "off". Returns the
// CUDA error of the launch (0 on success), or cudaErrorInvalidValue for a
// dtype, bit width, head dim or group the kernel does not take.
extern "C" int crane_quant_decode_attention(
    int dtype, int bits, const void* q, const void* kc, const void* vc,
    const void* ks, const void* vs, const void* kv_valid, void* out, int B,
    int T_len, int Hq, int Hkv, int D, float scale, int window, float softcap,
    void* stream) {
  using namespace crane;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const DecodeArgs a{q, static_cast<const int8_t*>(kc),
                     static_cast<const int8_t*>(vc),
                     static_cast<const float*>(ks),
                     static_cast<const float*>(vs),
                     static_cast<const int*>(kv_valid), out, B, T_len, Hkv,
                     scale, window, softcap,
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

// q [B,S,Hq,D] at absolute positions [B,S] int32; k/v codes and scales as
// above over the whole buffer (Tk tokens, the chunk already written); out
// [B,S,Hq,D]; all contiguous. Returns as crane_quant_decode_attention.
extern "C" int crane_quant_cached_attention(
    int dtype, int bits, const void* q, const void* kc, const void* vc,
    const void* ks, const void* vs, void* out, const void* positions, int B,
    int S, int Tk, int Hq, int Hkv, int D, float scale, int window,
    float softcap, void* stream) {
  using namespace crane;
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Tk <= 0) return cudaErrorInvalidValue;
  const int8_t* k8 = static_cast<const int8_t*>(kc);
  const int8_t* v8 = static_cast<const int8_t*>(vc);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kBFloat16)
    ok = cached_dispatch<__nv_bfloat16>(bits, D, q, k8, v8, kss, vss, out,
                                        pos, B, S, Tk, Hq, Hkv, scale, window,
                                        softcap, st);
  else if (dtype == kFloat32)
    ok = cached_dispatch<float>(bits, D, q, k8, v8, kss, vss, out, pos, B, S,
                                Tk, Hq, Hkv, scale, window, softcap, st);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
