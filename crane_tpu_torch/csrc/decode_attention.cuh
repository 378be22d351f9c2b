// The split-KV decode kernel shared by K1 (decode_attention.cu, an fp cache)
// and K4 (quant_decode_attention.cu, an int8 / packed-int4 cache), with
// their with-stats forms K1-S and K4-S. K4's int4 instances compile in a
// source of their own (quant_decode_attention_int4.cu), so nvcc builds the
// three sets of 48 instances side by side.
//
// One query token per row: q [B, 1, Hq, D] against the cache of row b,
// slots [lo, valid) with valid = min(kv_valid[b], T) and lo = max(0, valid
// - window) (0 without a window). Logits are scale * q.k (times the key's
// scale over a quantized cache), optionally softcapped as c * tanh(s / c);
// the softmax is online and in float32.
//
// What bounds it on an H100: the KV bytes, 2 * (valid - lo) * Hkv * (bytes
// of a token-head) per row, against about 4 G FLOPs per element read.
//
// What the design does about it:
// - The grid is (n_split, Hkv, B). Block (s, hk, b) takes the s-th of
//   n_split even shares of [lo, valid), computed here from kv_valid, the
//   window and T, so a ragged batch gives every row the same number of
//   blocks. n_split comes from the host and depends on shapes only (B, Hkv,
//   T, the SM count and how many blocks of the instance an SM holds,
//   ops/cuda/decode_attention.py decode_splits): one stream at a long
//   context fills the card instead of Hkv of its SMs, and a CUDA graph can
//   capture the launch.
// - The G = Hq / Hkv query heads of a group share every K/V row the block
//   reads. A row is split over kLanes lanes, each loading 16 bytes where
//   its registers allow (a Policy's kE dims), so a warp's load covers
//   32 / kLanes rows; each sub-warp of kLanes lanes keeps its own online
//   softmax state over UNROLL rows in flight per iteration.
// - The sub-warps merge by shuffles and the warps in shared memory (the
//   log-sum-exp combine). With n_split = 1 the block writes out directly
//   (no scratch, no second pass). Otherwise it writes its float32 partial
//   (unnormalised acc [D], max m, sum l per head) to the wrapper's scratch,
//   and the last block of the (row, kv-head) to finish merges the partials
//   in float32 in split order (merge_split_states, common.cuh): it takes a
//   ticket from a per-(row, kv-head) counter with atomicAdd and resets the
//   counter for the next launch, so one launch does the whole call and a
//   CUDA graph replays it.
// A head that sees no key writes zeros, and in the with-stats form m = -inf
// and l = 0; a split that sees none weighs 0.
#pragma once

#include "common.cuh"

namespace crane {

struct DecodeArgs {
  const void* q;
  const void* k;  // fp rows [B, T, Hkv, D], or codes [B, T, Hkv * stored]
  const void* v;
  const float* k_scale;  // [B, Hkv, T] float32 (quantized caches only)
  const float* v_scale;
  const int* kv_valid;
  void* out;
  float* m_out;  // NULL, or [B, Hq] float32 (the with-stats form)
  float* l_out;
  float* part_acc;  // [B, Hq, n_split, D] float32 when n_split > 1
  float* part_ml;   // m [B, Hq, n_split] then l [B, Hq, n_split], float32
  int* counters;    // [B * Hkv] int32 zeros (the ticket merge) when n_split > 1
  int B, T_len, Hkv, n_split;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
};

// K4 at int4 (quant_decode_attention_int4.cu): decode_dispatch over its
// instances, called by the C entries of quant_decode_attention.cu.
bool quant_decode_int4(int dtype, int D, int G, const DecodeArgs* a, int* info);

namespace {

constexpr int kDecodeWarps = 8;

// Rows a sub-warp has in flight per iteration: 4, or 2 for groups of six
// heads or more, whose q and accumulator already take 96 registers or more.
template <int G>
__host__ __device__ constexpr int decode_unroll() {
  return G > 5 ? 2 : 4;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The fp cache: rows [B, T, Hkv, D] of T_ (float32 or bfloat16). A lane
// makes kLoads 16-byte loads of a row (2 for float32 at D = 256, else 1),
// the row spanning kLanes lanes.
template <typename T_, int D_>
struct FpRows {
  using T = T_;
  static constexpr int D = D_;
  static constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int kLanes = D / kVec < 32 ? D / kVec : 32;
  static constexpr int kLoads = D / (kVec * kLanes);
  static constexpr int kE = kVec * kLoads;  // dims a lane owns
  struct Raw {
    uint4 w[kLoads];
  };
  // the head dim of lane sl's e-th value
  static __device__ __forceinline__ int dim(int sl, int e) {
    return (e / kVec) * (kVec * kLanes) + sl * kVec + e % kVec;
  }

  const uint4* k;
  const uint4* v;
  size_t stride;  // 16-byte words from one token to the next

  __device__ FpRows(const DecodeArgs& a, int b, int hk, int sl) {
    stride = (size_t)a.Hkv * D / kVec;
    const size_t off = (size_t)b * a.T_len * stride + (size_t)hk * (D / kVec) + sl;
    k = static_cast<const uint4*>(a.k) + off;
    v = static_cast<const uint4*>(a.v) + off;
  }
  static __device__ __forceinline__ Raw load(const uint4* p, bool ok) {
    Raw r;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) r.w[j] = ok ? __ldg(p + j * kLanes) : make_uint4(0, 0, 0, 0);
    return r;
  }
  __device__ __forceinline__ Raw load_k(int t, bool ok) const { return load(k + t * stride, ok); }
  __device__ __forceinline__ Raw load_v(int t, bool ok) const { return load(v + t * stride, ok); }
  __device__ __forceinline__ float k_scale(int, bool) const { return 1.f; }
  __device__ __forceinline__ float v_scale(int, bool) const { return 1.f; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kE]) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w = word(r.w[j], i);
        if constexpr (sizeof(T) == 2) {  // two bfloat16: element 2i low
          f[j * kVec + 2 * i] = __uint_as_float(w << 16);
          f[j * kVec + 2 * i + 1] = __uint_as_float(w & 0xffff0000u);
        } else {
          f[j * kVec + i] = __uint_as_float(w);
        }
      }
    }
  }
};

// The quantized cache (ops/kv_cache.py QuantLayerKVCache): codes [B, T, Hkv
// * stored] int8, head h at bytes [h * stored, (h + 1) * stored); stored = D
// for int8, D / 2 for int4 (byte j holds dim j low and dim j + D / 2 high,
// as 16 * hi + lo); scales [B, Hkv, T] float32; q and out in T_. A lane
// owns kE dims: 32 / G, at least 8, so q and the accumulator (2 G kE
// floats) take 64 registers up to G = 4 (two blocks an SM): 16 bytes a
// load for int8 up to G = 2 and int4 at G = 1, 8 or 4 bytes past that.
template <typename T_, int D_, int BITS, int G>
struct QuantRows {
  using T = T_;
  static constexpr int D = D_;
  static constexpr int kStored = BITS == 4 ? D / 2 : D;
  static constexpr int kPerByte = BITS == 4 ? 2 : 1;  // dims a byte holds
  static constexpr int kWant = G == 1 ? 32 : G == 2 ? 16 : 8;
  static constexpr int kE = kWant < 16 * kPerByte ? kWant : 16 * kPerByte;
  static constexpr int kBytes = kE / kPerByte;  // 4, 8 or 16 a load
  static constexpr int kLanes = kStored / kBytes;
  static constexpr int kWords = kBytes / 4;
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0, "lanes per row");
  struct Raw {
    uint32_t w[kWords];
  };
  static __device__ __forceinline__ int dim(int sl, int e) {
    if constexpr (BITS == 4)
      return e < kBytes ? sl * kBytes + e : D / 2 + sl * kBytes + e - kBytes;
    else
      return sl * kBytes + e;
  }

  const int8_t* k;
  const int8_t* v;
  const float* ks;  // the (row, kv-head)'s scale rows
  const float* vs;
  size_t stride;  // bytes from one token to the next

  __device__ QuantRows(const DecodeArgs& a, int b, int hk, int sl) {
    stride = (size_t)a.Hkv * kStored;
    const size_t off = (size_t)b * a.T_len * stride + (size_t)hk * kStored + sl * kBytes;
    k = static_cast<const int8_t*>(a.k) + off;
    v = static_cast<const int8_t*>(a.v) + off;
    ks = a.k_scale + ((size_t)b * a.Hkv + hk) * a.T_len;
    vs = a.v_scale + ((size_t)b * a.Hkv + hk) * a.T_len;
  }
  static __device__ __forceinline__ Raw load(const int8_t* p, bool ok) {
    Raw r = {};
    if (!ok) return r;
    if constexpr (kWords == 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      r.w[0] = x.x, r.w[1] = x.y, r.w[2] = x.z, r.w[3] = x.w;
    } else if constexpr (kWords == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      r.w[0] = x.x, r.w[1] = x.y;
    } else {
      r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
    return r;
  }
  __device__ __forceinline__ Raw load_k(int t, bool ok) const { return load(k + t * stride, ok); }
  __device__ __forceinline__ Raw load_v(int t, bool ok) const { return load(v + t * stride, ok); }
  __device__ __forceinline__ float k_scale(int t, bool ok) const { return ok ? __ldg(ks + t) : 0.f; }
  __device__ __forceinline__ float v_scale(int t, bool ok) const { return ok ? __ldg(vs + t) : 0.f; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kE]) {
#pragma unroll
    for (int e = 0; e < kBytes; ++e) {
      const int byte = byte_of(r.w[e / 4], e % 4);
      if constexpr (BITS == 4) {
        f[e] = static_cast<float>(int4_lo(byte));
        f[kBytes + e] = static_cast<float>(int4_hi(byte));
      } else {
        f[e] = static_cast<float>(byte);
      }
    }
  }
};

// Bytes of dynamic shared memory of the cross-warp merge: m and l
// [kDecodeWarps][G] and acc [kDecodeWarps][G][D], float32 (above the 48 KB
// default at D = 256 and G >= 6, so the launch opts in).
template <int G, int D>
constexpr size_t decode_smem_bytes() {
  return sizeof(float) * kDecodeWarps * G * (D + 2);
}

template <class P, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_split_kernel(const DecodeArgs a) {
  using T = typename P::T;
  constexpr int D = P::D;
  constexpr int E = P::kE;
  constexpr int kLanes = P::kLanes;
  constexpr int kRows = 32 / kLanes;  // rows a warp's load covers
  constexpr int U = decode_unroll<G>();
  constexpr int kStep = kDecodeWarps * kRows * U;  // tokens a block iteration covers
  const int s = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sg = lane / kLanes;  // the lane's sub-warp
  const int sl = lane % kLanes;  // and its place in the row
  const int Hq = a.Hkv * G;
  const int n = a.n_split;

  // this block's share of the live range [lo, valid)
  const int valid = min(max(a.kv_valid[b], 0), a.T_len);
  const int lo = a.window > 0 ? max(0, valid - a.window) : 0;
  const int share = (valid - lo + n - 1) / n;
  const int t_lo = min(valid, lo + s * share);
  const int t_hi = min(valid, t_lo + share);

  const size_t head0 = (size_t)b * Hq + hk * G;  // the group's first q-head
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = static_cast<const T*>(a.q) + (head0 + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] = to_float(qp[P::dim(sl, e)]);
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const P rows(a, b, hk, sl);
  // t0 is the same across a warp, so every lane takes the shuffles below
  for (int t0 = t_lo + warp * kRows * U; t0 < t_hi; t0 += kStep) {
    typename P::Raw kr[U], vr[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kRows + sg;
      const bool ok = t < t_hi;
      kr[u] = rows.load_k(t, ok);
      vr[u] = rows.load_v(t, ok);
      ksc[u] = rows.k_scale(t, ok);
      vsc[u] = rows.v_scale(t, ok);
    }
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      P::unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[g][e] * kf[e];
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[u][g] = (t0 + u * kRows + sg < t_hi) ? softcap_logit(part * ksc[u] * a.scale, a.softcap)
                                                 : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
      const float m_new = fmaxf(m[g], mx);
      // a sub-warp past t_hi has seen no key yet: nothing to add
      const float alpha = m_new == -INFINITY ? 1.f : __expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][g] = m_new == -INFINITY ? 0.f : __expf(sc[u][g] - m_new);
        l[g] += sc[u][g];
        sc[u][g] *= vsc[u];
      }
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      P::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += sc[u][g] * vf[e];
      }
    }
  }

  // merge the sub-warps: lanes kLanes apart hold the same dims
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float cs = M == -INFINITY ? 0.f : __expf(m[g] - M);
      const float co = M == -INFINITY ? 0.f : __expf(mo - M);
      l[g] = l[g] * cs + lo_ * co;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * cs + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * co;
      m[g] = M;
    }
  }

  // merge the warps in shared memory
  extern __shared__ float smem[];
  float* sm_m = smem;                          // [kDecodeWarps][G]
  float* sm_l = smem + kDecodeWarps * G;       // [kDecodeWarps][G]
  float* sm_acc = smem + 2 * kDecodeWarps * G;  // [kDecodeWarps][G][D]
  if (sg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (sl == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[(warp * G + g) * D + P::dim(sl, e)] = acc[g][e];
    }
  }
  __syncthreads();
  const size_t heads = (size_t)a.B * Hq;
  for (int i = threadIdx.x; i < G * D; i += kDecodeWarps * 32) {
    const int g = i / D;
    const int d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecodeWarps; ++w) {
        const float c = __expf(sm_m[w * G + g] - M);  // 0 for an idle warp
        L += sm_l[w * G + g] * c;
        A += sm_acc[(w * G + g) * D + d] * c;
      }
    }
    const size_t h = head0 + g;
    if (n == 1) {
      static_cast<T*>(a.out)[h * D + d] = from_float<T>(M == -INFINITY ? 0.f : A / L);
      if (a.m_out != nullptr && d == 0) {
        a.m_out[h] = M;
        a.l_out[h] = L;
      }
    } else {
      a.part_acc[(h * n + s) * D + d] = A;
      if (d == 0) {
        a.part_ml[h * n + s] = M;
        a.part_ml[heads * n + h * n + s] = L;
      }
    }
  }
  if (n == 1) return;

  // the ticket merge: the last block of the (row, kv-head) to finish merges
  // (the barrier also ends the warp merge's reads of smem, which it reuses)
  __shared__ int last;
  __threadfence();  // this block's partials, visible to the last block
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = a.counters + (size_t)b * a.Hkv + hk;
    last = atomicAdd(counter, 1) == n - 1;
    if (last) *counter = 0;  // every ticket is taken: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_split_states<T>(a.part_acc + head0 * n * D, a.part_ml + head0 * n,
                        a.part_ml + (heads + head0) * n, n, G, D,
                        static_cast<T*>(a.out) + head0 * D,
                        a.m_out != nullptr ? a.m_out + head0 : nullptr,
                        a.l_out != nullptr ? a.l_out + head0 : nullptr, smem);
}

template <class P, int G>
void launch_decode(const DecodeArgs& a) {
  constexpr size_t smem = decode_smem_bytes<G, P::D>();
  if constexpr (smem + 1024 > 48 * 1024) {
    static std::atomic<uint64_t> devices{0};
    allow_dynamic_smem_once(decode_split_kernel<P, G>, smem, devices);
  }
  decode_split_kernel<P, G><<<dim3(a.n_split, a.Hkv, a.B), kDecodeWarps * 32, smem, a.stream>>>(a);
}

// The compiled form of one instance: info[0] registers a thread, info[1]
// local (spill) bytes a thread, info[2] shared memory bytes a block (static
// and dynamic), info[3] threads a block, info[4] blocks an SM holds at once.
template <class P, int G>
void decode_attributes(int* info) {
  constexpr size_t smem = decode_smem_bytes<G, P::D>();
  cudaFuncAttributes fa{};
  cudaFuncGetAttributes(&fa, decode_split_kernel<P, G>);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes + smem);
  info[3] = fa.maxThreadsPerBlock;
  allow_dynamic_smem(decode_split_kernel<P, G>, smem);  // for the occupancy query
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], decode_split_kernel<P, G>,
                                                kDecodeWarps * 32, smem);
}

// The most splits a launch takes: the ticket merge keeps the weights of a
// group's splits in the block's merge memory (decode_smem_bytes, at least
// kDecodeWarps * (64 + 2) floats a head).
constexpr int kMaxSplits = 512;

// The checks both C entries make; true when the arguments are usable.
inline bool decode_args_ok(const DecodeArgs& a, int Hq) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0 || a.n_split < 1 || a.n_split > kMaxSplits) return false;
  if ((a.m_out == nullptr) != (a.l_out == nullptr)) return false;
  return a.n_split == 1 ||
         (a.part_acc != nullptr && a.part_ml != nullptr && a.counters != nullptr);
}

// launch_decode (a non-null) or decode_attributes (into info) of the
// instance of the rows policy R<T, D, G> at group G.
template <template <typename, int, int> class R, typename T, int D, int G>
bool decode_instance(const DecodeArgs* a, int* info) {
  if (a != nullptr)
    launch_decode<R<T, D, G>, G>(*a);
  else
    decode_attributes<R<T, D, G>, G>(info);
  return true;
}

template <template <typename, int, int> class R, typename T, int D>
bool decode_by_group(int G, const DecodeArgs* a, int* info) {
  switch (G) {
    case 1: return decode_instance<R, T, D, 1>(a, info);
    case 2: return decode_instance<R, T, D, 2>(a, info);
    case 3: return decode_instance<R, T, D, 3>(a, info);
    case 4: return decode_instance<R, T, D, 4>(a, info);
    case 5: return decode_instance<R, T, D, 5>(a, info);
    case 6: return decode_instance<R, T, D, 6>(a, info);
    case 7: return decode_instance<R, T, D, 7>(a, info);
    case 8: return decode_instance<R, T, D, 8>(a, info);
    default: return false;
  }
}

template <template <typename, int, int> class R, typename T>
bool decode_by_dim(int D, int G, const DecodeArgs* a, int* info) {
  switch (D) {
    case 64: return decode_by_group<R, T, 64>(G, a, info);
    case 128: return decode_by_group<R, T, 128>(G, a, info);
    case 256: return decode_by_group<R, T, 256>(G, a, info);
    default: return false;
  }
}

// decode_instance for the dtype code, head dim and group of a call; false
// for one the kernels do not take. R is the rows policy of the source's
// instances: FpRows (K1) or QuantRows at one bit width (K4).
template <template <typename, int, int> class R>
bool decode_dispatch(int dtype, int D, int G, const DecodeArgs* a, int* info) {
  if (dtype == kBFloat16) return decode_by_dim<R, __nv_bfloat16>(D, G, a, info);
  if (dtype == kFloat32) return decode_by_dim<R, float>(D, G, a, info);
  return false;
}

}  // namespace
}  // namespace crane
