// K2 and K3: causal GQA flash attention for prefill.
//
// Replaces crane_tpu/ops/pallas/flash_attention.py:
//   K2 _flash_causal_impl / _flash_kernel  (flash_attention_causal): a fresh
//      prompt, q/k/v [B, S, H, D] at positions 0..S-1;
//   K3 _flash_cached_impl / _cached_kernel (flash_attention_cached): a
//      continuation chunk of S queries at absolute `positions` [B, S] over
//      the whole cache buffer k/v [B, T, Hkv, D]. The same K3 launch also
//      stands for quant_attention.py::quant_cached_attention(bits=16), which
//      computes the same function over the same storage layout.
//   K3-S quant_attention.py::cached_attention_with_stats(bits=16) (the
//      _cached_attention call with return_stats=True): K3 with m_out/l_out
//      non-null also writes each query row's softmax max and sum [B, Hq, S]
//      float32, for the sequence-parallel merge of slabs
//      (parallel/sequence.py). There the positions are slab-local and may be
//      negative (the row attends nothing in this slab).
//
// What it computes, per query row i at position p (K2: p = i; K3:
// p = min(positions[b, i], T - 1), the clamp the TPU kernel applies to
// bucket-padded tail rows): softmax over keys j of scale * q.k (optionally
// c * tanh(s / c)), where key j takes part iff j <= p and, with a window,
// j > p - window; with `segments` (K2 only) also iff seg[i] == seg[j] > 0.
// A row with no key to attend writes zeros, and with stats m = -INFINITY
// (the TPU kernel writes -1e30) and l = 0. The stats are m, the running max
// of the scaled, softcapped logits in natural-log units, and l = sum
// exp(s - m), written by the thread that owns the row's first dim (c == 0).
//
// What bounds it on an H100: K2 at long S is bound by the attention FLOPs
// (4 * S^2/2 * D per head), which at scale belong on the tensor cores; K3 is
// bound by the KV bytes of the live context it reads per chunk.
//
// Storage types: bfloat16 goes to the tensor-core kernel of
// flash_attention_mma.cu; float32 stays on the CUDA-core kernel below, which
// computes in full float32 (TF32 tensor cores would keep about three
// digits). The split is by dtype alone: nothing retries one on the other.
//
// What the design of the float32 kernel does: one block per (q-tile of 32
// rows, q-head, b); the block loops over key tiles only inside the
// causal/window band of its rows (every tile when segments are given, since
// same-segment pairs can sit above the diagonal), so a K3 chunk at context L
// reads O(L + S) keys, never the whole allocated buffer. Each K/V tile is staged once in
// shared memory (float32) and reused by all 32 rows; TPR threads share a
// row, each owning the interleaved dims c, c+TPR, ... (conflict-free
// shared-memory reads), and combine partial dots with log2(TPR) shuffles.
// TPR and the tile size follow the head dim (common.cuh RowTile: 4 threads
// and 32 keys up to D = 128, 8 and 16 at D = 256). The softmax is online in
// float32.
#include "common.cuh"

namespace crane {

// flash_attention_mma.cu
cudaError_t flash_attention_mma_bf16(const void* q, const void* k, const void* v, void* out,
                                     float* m_out, float* l_out, const int* positions,
                                     const int* segments, int B, int S, int Tk, int Hq,
                                     int Hkv, int D, float scale, int window, float softcap,
                                     cudaStream_t stream, const int* kv_rows);

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(RowTile<D>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       const int* __restrict__ positions,
                       const int* __restrict__ segments,
                       const int* __restrict__ kv_rows, int S, int Tk,
                       int Hkv, int G, float scale, int window,
                       float softcap) {
  constexpr int kBlockQ = RowTile<D>::kBlockQ;
  constexpr int kTPR = RowTile<D>::kTPR;
  constexpr int kBlockK = RowTile<D>::kBlockK;
  constexpr int kThreads = RowTile<D>::kThreads;
  constexpr int NE = D / kTPR;  // dims owned by one thread
  __shared__ float Ks[kBlockK][D];
  __shared__ float Vs[kBlockK][D];
  __shared__ int seg_k[kBlockK];
  __shared__ int band_lo, band_hi;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // query row within the tile
  const int c = tid % kTPR;  // this thread's dim lane: dims c + kTPR * i
  const int qi = q0 + r;
  const bool live = qi < S;

  int p = qi;
  if (positions != nullptr) p = live ? min(positions[(size_t)b * S + qi], Tk - 1) : 0;
  const int sq = (segments != nullptr && live) ? segments[(size_t)b * S + qi] : 0;

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
  // inclusive key range of the tile loop; kv_lo >= 0 always (C's `/`
  // truncates where a floor is meant), and a band wholly before this buffer
  // (every p < 0, a later slab's view of an earlier chunk) runs no tile
  int kv_lo = 0, kv_hi = band_hi;
  if (segments != nullptr) {
    kv_hi = Tk - 1;
  } else if (window > 0) {
    kv_lo = max(0, band_lo - window + 1);
  }

  float qr[NE], acc[NE];
  const T* qp = q + (((size_t)b * S + (live ? qi : 0)) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    qr[i] = live ? to_float(qp[c + kTPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const size_t row_stride = (size_t)Hkv * D;
  const int bk = kv_rows != nullptr ? kv_rows[b] : b;  // the K/V row
  const T* kb = k + (size_t)bk * Tk * row_stride + (size_t)hk * D;
  const T* vb = v + (size_t)bk * Tk * row_stride + (size_t)hk * D;

  for (int kt = (kv_lo / kBlockK) * kBlockK; kt <= kv_hi; kt += kBlockK) {
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int t = kt + j;
      const bool in = t < Tk;
      Ks[j][d] = in ? to_float(kb[(size_t)t * row_stride + d]) : 0.f;
      Vs[j][d] = in ? to_float(vb[(size_t)t * row_stride + d]) : 0.f;
    }
    if (segments != nullptr && tid < kBlockK) {
      const int t = kt + tid;
      seg_k[tid] = t < Tk ? segments[(size_t)b * S + t] : 0;
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
      bool ok = t <= p && (window <= 0 || t > p - window);
      if (segments != nullptr) ok = ok || (sq > 0 && seg_k[j] == sq);
      ok = ok && t < Tk && live;
      s[j] = ok ? softcap_logit(part * scale, softcap) : -INFINITY;
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
#pragma unroll
        for (int i = 0; i < NE; ++i) acc[i] += pj * Vs[j][c + kTPR * i];
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

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out,
            float* m_out, float* l_out, const int* positions,
            const int* segments, const int* kv_rows, int B, int S, int Tk, int Hq, int Hkv,
            float scale, int window, float softcap, cudaStream_t stream) {
  using Tl = RowTile<D>;
  dim3 grid((S + Tl::kBlockQ - 1) / Tl::kBlockQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, Tl::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, positions,
      segments, kv_rows, S, Tk, Hkv, Hq / Hkv, scale, window, softcap);
}

template <typename T>
bool dispatch_dim(int D, const void* q, const void* k, const void* v,
                  void* out, float* m_out, float* l_out, const int* positions,
                  const int* segments, const int* kv_rows, int B, int S, int Tk, int Hq,
                  int Hkv, float scale, int window, float softcap,
                  cudaStream_t stream) {
  if (D == 64) {
    launch<T, 64>(q, k, v, out, m_out, l_out, positions, segments, kv_rows, B, S, Tk,
                  Hq, Hkv, scale, window, softcap, stream);
    return true;
  }
  if (D == 128) {
    launch<T, 128>(q, k, v, out, m_out, l_out, positions, segments, kv_rows, B, S, Tk,
                   Hq, Hkv, scale, window, softcap, stream);
    return true;
  }
  if (D == 256) {
    launch<T, 256>(q, k, v, out, m_out, l_out, positions, segments, kv_rows, B, S, Tk,
                   Hq, Hkv, scale, window, softcap, stream);
    return true;
  }
  return false;
}

}  // namespace
}  // namespace crane

// crane_flash_attention (below) with the K/V row of each query batch row
// named on the device: kv_rows [B] int32 (K3 only), so k/v may hold more rows than q
// (a batch-1 chunk over row kv_rows[0] of a multi-row cache, the row chosen
// at run time, as a CUDA graph replays it). The caller keeps each row inside
// the buffers. NULL is batch row b, crane_flash_attention's indexing.
extern "C" int crane_flash_attention_rows(int dtype, const void* q, const void* k,
                                          const void* v, void* out, void* m_out,
                                          void* l_out, const void* positions,
                                          const void* segments, const void* kv_rows,
                                          int B, int S, int Tk, int Hq, int Hkv, int D,
                                          float scale, int window, float softcap,
                                          void* stream) {
  using namespace crane;
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Tk <= 0) return cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  if (m_out != nullptr && positions == nullptr) return cudaErrorInvalidValue;
  if (kv_rows != nullptr && positions == nullptr) return cudaErrorInvalidValue;
  const int* pos = static_cast<const int*>(positions);
  const int* seg = static_cast<const int*>(segments);
  const int* rows = static_cast<const int*>(kv_rows);
  float* ms = static_cast<float*>(m_out);
  float* ls = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return flash_attention_mma_bf16(q, k, v, out, ms, ls, pos, seg, B, S, Tk, Hq,
                                    Hkv, D, scale, window, softcap, s, rows);
  if (dtype != kFloat32 ||
      !dispatch_dim<float>(D, q, k, v, out, ms, ls, pos, seg, rows, B, S, Tk, Hq,
                           Hkv, scale, window, softcap, s))
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// q [B,S,Hq,D], k/v [B,Tk,Hkv,D], out [B,S,Hq,D]; all contiguous.
// m_out/l_out [B,Hq,S] float32, both NULL or both set (K3-S; positions path
// only). positions [B,S] int32 or NULL: NULL is K2 (fresh prefill,
// positions 0..S-1, Tk == S); non-NULL is K3 (continuation over the cache
// buffer). segments [B,S] int32 or NULL (K2 only). window <= 0 and
// softcap <= 0 mean "off". Returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for a dtype/head dim the kernel does
// not take. bfloat16 runs flash_attention_mma.cu's kernel, float32 the one
// above.
extern "C" int crane_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, void* m_out,
                                     void* l_out, const void* positions,
                                     const void* segments, int B, int S,
                                     int Tk, int Hq, int Hkv, int D,
                                     float scale, int window, float softcap,
                                     void* stream) {
  return crane_flash_attention_rows(dtype, q, k, v, out, m_out, l_out, positions,
                                    segments, nullptr, B, S, Tk, Hq, Hkv, D, scale,
                                    window, softcap, stream);
}
