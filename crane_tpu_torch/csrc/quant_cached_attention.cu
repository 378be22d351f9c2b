// K5: GQA continuation-chunk attention over an int8 / packed-int4 KV
// cache, with the dequantization folded into the logits and the output
// sums: the float32 route. bfloat16 queries go to the tensor-core kernel
// (quant_cached_attention_mma.cu), chosen here by dtype.
//
// Replaces crane_tpu/ops/pallas/quant_attention.py::_cached_attention
// (kernel _cached_kernel), reached through quant_cached_attention with
// bits 8 and 4: a chunk of S queries at absolute positions over the whole
// quantized buffer; and its with-stats form (K5-S,
// cached_attention_with_stats(bits=8/4), return_stats=True): with
// m_out/l_out non-null the same launch also writes each query row's softmax
// max and sum [B, Hq, S] float32 (as K3-S: m = -INFINITY and l = 0 for a row
// with no key, whose slab-local position may be negative), for the
// sequence-parallel merge.
//
// Cache layout as K4's (csrc/quant_decode_attention.cu): codes [B, T, Hkv *
// stored] int8 and scales [B, Hkv, T] float32. Per key, s = (q . code) *
// k_scale * scale and acc += (p * v_scale) * code; everything is float32
// after the load, and nothing rounds p * vs to bf16 (the TPU kernel does,
// :529).
//
// What bounds it on an H100: the KV bytes of the live context each chunk
// reads, as for K3.
//
// What the design does about it: one block per (32 queries, q-head, row),
// looping over key tiles only inside the causal/window band of its rows;
// each tile's codes are unpacked once into float32 shared memory, the
// scales beside them, and read by all 32 rows; TPR threads share a query
// row (common.cuh RowTile). Positions past the buffer (bucket-padded tail
// rows) are clamped to T - 1 (quant_attention.py:589). A row with no key to
// attend writes zeros (:553-555). Float32 stays on the CUDA cores in full
// float32, as K2/K3's float32 route does.
#include "common.cuh"

namespace crane {
namespace {

template <typename T, int D, int BITS>
__global__ void __launch_bounds__(RowTile<D>::kThreads)
quant_cached_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                    const int8_t* __restrict__ vc,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    T* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, const int* __restrict__ positions,
                    int S, int Tk, int Hkv, int G, float scale, int window,
                    float softcap) {
  constexpr int kBlockQ = RowTile<D>::kBlockQ;
  constexpr int kTPR = RowTile<D>::kTPR;
  constexpr int kBlockK = RowTile<D>::kBlockK;
  constexpr int kThreadsC = RowTile<D>::kThreads;
  constexpr int NE = D / kTPR;  // dims owned by one thread: c, c + kTPR, ...
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
  const int r = tid / kTPR;  // query row within the tile
  const int c = tid % kTPR;  // this thread's dim lane
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
  // inclusive; kv_lo >= 0 (C's `/` truncates), and a band wholly before
  // the buffer (every p < 0: a later slab's view of an earlier chunk) runs
  // no tile
  const int kv_lo = window > 0 ? max(0, band_lo - window + 1) : 0;
  const int kv_hi = band_hi;

  float qr[NE], acc[NE];
  const T* qp = q + (((size_t)b * S + (live ? qi : 0)) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    qr[i] = live ? to_float(qp[c + kTPR * i]) : 0.f;
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
      for (int i = 0; i < NE; ++i) part += qr[i] * Ks[j][c + kTPR * i];
#pragma unroll
      for (int off = 1; off < kTPR; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
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
        for (int i = 0; i < NE; ++i) acc[i] += pv * Vs[j][c + kTPR * i];
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (live) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = out + (((size_t)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NE; ++i)
      op[c + kTPR * i] = from_float<T>(acc[i] * inv);
    if (m_out != nullptr && c == 0) {
      const size_t si = ((size_t)b * Hq + h) * S + qi;  // [B, Hq, S]
      m_out[si] = m;
      l_out[si] = l;
    }
  }
}

template <typename T, int D, int BITS>
void launch_cached(const void* q, const int8_t* kc, const int8_t* vc,
                   const float* ks, const float* vs, void* out, float* m_out,
                   float* l_out, const int* positions, int B, int S, int Tk,
                   int Hq,
                   int Hkv, float scale, int window, float softcap,
                   cudaStream_t stream) {
  using Tl = RowTile<D>;
  dim3 grid((S + Tl::kBlockQ - 1) / Tl::kBlockQ, Hq, B);
  quant_cached_kernel<T, D, BITS><<<grid, Tl::kThreads, 0, stream>>>(
      static_cast<const T*>(q), kc, vc, ks, vs, static_cast<T*>(out), m_out,
      l_out, positions, S, Tk, Hkv, Hq / Hkv, scale, window, softcap);
}

bool cached_dispatch_f32(int bits, int D, const void* q, const int8_t* kc,
                        const int8_t* vc, const float* ks, const float* vs,
                        void* out, float* m_out, float* l_out, const int* pos,
                        int B, int S, int Tk, int Hq, int Hkv, float scale,
                        int window, float softcap, cudaStream_t st) {
#define CRANE_CACHED(d, bb)                                                      \
  if (D == d && bits == bb) {                                                    \
    launch_cached<float, d, bb>(q, kc, vc, ks, vs, out, m_out, l_out, pos, B, S, \
                                Tk, Hq, Hkv, scale, window, softcap, st);        \
    return true;                                                                 \
  }
  CRANE_CACHED(64, 8) CRANE_CACHED(64, 4) CRANE_CACHED(128, 8)
  CRANE_CACHED(128, 4) CRANE_CACHED(256, 8) CRANE_CACHED(256, 4)
#undef CRANE_CACHED
  return false;
}

}  // namespace

// quant_cached_attention_mma.cu
cudaError_t quant_cached_attention_mma_bf16(int bits, int D, const void* q, const int8_t* kc,
                                            const int8_t* vc, const float* ks, const float* vs,
                                            void* out, float* m_out, float* l_out,
                                            const int* positions, int B, int S, int Tk, int Hq,
                                            int Hkv, float scale, int window, float softcap,
                                            cudaStream_t stream);
}  // namespace crane

// q [B,S,Hq,D] at absolute positions [B,S] int32; k/v codes
// [B,T,Hkv*stored] int8 and scales [B,Hkv,T] float32 over the whole buffer
// (Tk tokens, the chunk already written); out [B,S,Hq,D]; m_out/l_out
// [B,Hq,S] float32, both NULL (K5) or both set (K5-S); all contiguous, on
// the device of `stream`. window <= 0 and softcap <= 0 mean "off". Returns
// the CUDA error of the launch (0 on success), or cudaErrorInvalidValue for
// a dtype, bit width or head dim the kernel does not take.
extern "C" int crane_quant_cached_attention(
    int dtype, int bits, const void* q, const void* kc, const void* vc,
    const void* ks, const void* vs, void* out, void* m_out, void* l_out,
    const void* positions, int B, int S, int Tk, int Hq, int Hkv, int D,
    float scale, int window, float softcap, void* stream) {
  using namespace crane;
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Tk <= 0) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  const int8_t* k8 = static_cast<const int8_t*>(kc);
  const int8_t* v8 = static_cast<const int8_t*>(vc);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* pos = static_cast<const int*>(positions);
  float* ms = static_cast<float*>(m_out);
  float* ls = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return quant_cached_attention_mma_bf16(bits, D, q, k8, v8, kss, vss, out, ms, ls, pos, B, S,
                                           Tk, Hq, Hkv, scale, window, softcap, st);
  bool ok = false;
  if (dtype == kFloat32)
    ok = cached_dispatch_f32(bits, D, q, k8, v8, kss, vss, out, ms, ls, pos,
                             B, S, Tk, Hq, Hkv, scale, window, softcap, st);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
