// K5 in bfloat16 on the tensor cores: GQA continuation-chunk attention over
// an int8 / packed-int4 KV cache (and its with-stats launch K5-S).
//
// Replaces, for bfloat16 queries, crane_tpu/ops/pallas/quant_attention.py
// _cached_attention (kernel _cached_kernel) at bits 8 and 4, and its
// return_stats form. crane_quant_cached_attention (quant_cached_attention.cu)
// routes bf16 here by dtype and keeps float32 on its CUDA-core kernel;
// nothing falls back from one to the other.
//
// What it computes is quant_cached_attention.cu's contract: per key,
// s = (q . code) * k_scale * scale and acc += (p * v_scale) * code, positions
// past the buffer clamped to T - 1, the causal and window band, softcap,
// zeros for a row with no key (with stats m = -INFINITY, l = 0). Only the
// arithmetic route differs: the int8 codes and the int4 codes are exact in
// bf16, and a bf16 q times a bf16 code is exact in the float32 sum, so the
// logits are those of the CUDA-core kernel up to the order of the sums.
//
// What bounds it on an H100: as K3, the attention FLOPs on the tensor cores,
// then the codes' bytes (half or a quarter of K3's).
//
// What the design does about it: K3's tile loop (flash_attention_mma.cuh:
// 64-row tiles stacking a kv-head's G query heads, 4 warps of
// mma.sync.m16n8k16, the band-limited key loop, the cluster split, the
// heaviest-first grid, the online softmax in log2 units, P' as hi + lo bf16
// operands) with the K/V policy QuantTiles below: a tile's code rows
// (`stored` = D or D/2 bytes a key and kv-head, contiguous in the flat
// [B, T, Hkv * stored] layout) and its keys' K and V scales are staged with
// cp.async into a 2-stage ring, then unpacked once into the swizzled bf16
// K/V tiles that ldmatrix reads, shared by every warp; the K scale
// multiplies S before the scale and the softcap, the V scale multiplies p
// after l has summed it (P' = p vs, not rounded to bf16 once as the TPU
// kernel does at :529). The build has six instances (D = 64, 128, 256 by
// bits 8, 4).
#include "flash_attention_mma.cuh"

namespace crane {
namespace mma {

template <int D, int BITS>
struct QuantTiles {
  static constexpr int BK = MmaTile<D>::kBlockK;
  static constexpr int kStored = BITS == 4 ? D / 2 : D;  // code bytes a key
  static constexpr int kCpr = kStored / 16;               // 16-byte chunks of a code row
  static constexpr bool kScaled = true;
  static constexpr bool kConvert = true;
  // unbounded, D = 64 takes 167-168 registers: three blocks fit an SM already
  static constexpr int kMinBlocks = 1;
  // bf16 K and V [BK][D], then the codes [2 stages][K, V][BK][kStored],
  // then the scales [2 stages][K, V][BK] float32
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * 2 * BK * D;
  static constexpr size_t kCodeBytes = (size_t)4 * BK * kStored;
  static constexpr size_t kSmemBytes = kTileBytes + kCodeBytes + sizeof(float) * 4 * BK;
  static_assert(BK * kCpr % kThreads == 0, "a tile's code chunks must split over the threads");
  static_assert(2 * BK <= kThreads, "one thread a scale");
  struct Args {
    const int8_t* kc;
    const int8_t* vc;
    const float* ks;
    const float* vs;
  };

  __nv_bfloat16* sK;  // [BK][D], then sV
  int8_t* codes;
  float* sc;
  const int8_t* kb;
  const int8_t* vb;
  const float* ksr;
  const float* vsr;
  size_t stride;  // bytes between key positions
  int Tk;

  __device__ QuantTiles(const Args& a, unsigned char* smem, int b, int hk, int Tk_, int Hkv)
      : sK(reinterpret_cast<__nv_bfloat16*>(smem)),
        codes(reinterpret_cast<int8_t*>(smem + kTileBytes)),
        sc(reinterpret_cast<float*>(smem + kTileBytes + kCodeBytes)),
        stride((size_t)Hkv * kStored),
        Tk(Tk_) {
    kb = a.kc + (size_t)b * Tk * stride + (size_t)hk * kStored;
    vb = a.vc + (size_t)b * Tk * stride + (size_t)hk * kStored;
    ksr = a.ks + ((size_t)b * Hkv + hk) * Tk;
    vsr = a.vs + ((size_t)b * Hkv + hk) * Tk;
  }

  __device__ __forceinline__ int8_t* code_row(int stage, int which, int j) const {
    return codes + ((size_t)(stage * 2 + which) * BK + j) * kStored;
  }

  __device__ __forceinline__ void load(int stage, int kt, int tid) {
#pragma unroll
    for (int i = 0; i < BK * kCpr / kThreads; ++i) {
      const int j = (tid + i * kThreads) / kCpr, c = (tid + i * kThreads) % kCpr;
      const int t = kt + j;
      const bool in = t < Tk;
      const size_t off = (size_t)(in ? t : 0) * stride + c * 16;
      cp_async16(smem_addr(code_row(stage, 0, j) + c * 16), kb + off, in);
      cp_async16(smem_addr(code_row(stage, 1, j) + c * 16), vb + off, in);
    }
    if (tid < 2 * BK) {
      const int which = tid / BK, j = tid % BK;
      const int t = kt + j;
      const bool in = t < Tk;
      cp_async4(smem_addr(sc + (stage * 2 + which) * BK + j), (which ? vsr : ksr) + (in ? t : 0),
                in);
    }
  }

  // the staged code rows as bf16 K and V rows: 16 bytes of row j, chunk c,
  // are dims 16 c .. 16 c + 15 (int8), or those dims low and dims
  // D / 2 + 16 c .. high (packed int4)
  __device__ __forceinline__ void convert(int stage, int tid) {
#pragma unroll
    for (int i = 0; i < BK * kCpr / kThreads; ++i) {
      const int j = (tid + i * kThreads) / kCpr, c = (tid + i * kThreads) % kCpr;
      __nv_bfloat16* sV = sK + BK * D;
      unpack16<D, BITS>(code_row(stage, 0, j) + c * 16, sK, 2 * c, sK, D / 16 + 2 * c, j);
      unpack16<D, BITS>(code_row(stage, 1, j) + c * 16, sV, 2 * c, sV, D / 16 + 2 * c, j);
    }
  }
  __device__ __forceinline__ const __nv_bfloat16* k_tile(int) const { return sK; }
  __device__ __forceinline__ const __nv_bfloat16* v_tile(int) const { return sK + BK * D; }
  __device__ __forceinline__ float k_scale(int stage, int j) const {
    return sc[stage * 2 * BK + j];
  }
  __device__ __forceinline__ float v_scale(int stage, int j) const {
    return sc[(stage * 2 + 1) * BK + j];
  }
};

}  // namespace mma

// The bf16 route of crane_quant_cached_attention (quant_cached_attention.cu),
// with its arguments checked there. Returns the CUDA error of the launch,
// or cudaErrorInvalidValue for a head dim or bit width it does not take.
cudaError_t quant_cached_attention_mma_bf16(int bits, int D, const void* q, const int8_t* kc,
                                            const int8_t* vc, const float* ks, const float* vs,
                                            void* out, float* m_out, float* l_out,
                                            const int* positions, int B, int S, int Tk, int Hq,
                                            int Hkv, float scale, int window, float softcap,
                                            cudaStream_t stream) {
#define CRANE_QUANT_MMA(d, bb)                                                              \
  if (D == d && bits == bb) {                                                               \
    const mma::QuantTiles<d, bb>::Args kv{kc, vc, ks, vs};                                  \
    return mma::launch<d, mma::QuantTiles<d, bb>>(q, kv, out, m_out, l_out, positions,      \
                                                  nullptr, B, S, Tk, Hq, Hkv, scale, window, \
                                                  softcap, stream);                         \
  }
  CRANE_QUANT_MMA(64, 8) CRANE_QUANT_MMA(64, 4) CRANE_QUANT_MMA(128, 8)
  CRANE_QUANT_MMA(128, 4) CRANE_QUANT_MMA(256, 8) CRANE_QUANT_MMA(256, 4)
#undef CRANE_QUANT_MMA
  return cudaErrorInvalidValue;
}

}  // namespace crane

// The compiled form of the bf16 K5 kernel at head dim D and `bits`, as
// crane_flash_attention_mma_info gives K2/K3's. Returns the CUDA error
// (cudaErrorInvalidValue for an instance the build does not have).
extern "C" int crane_quant_cached_attention_mma_info(int D, int bits, int* info) {
  using namespace crane::mma;
#define CRANE_QUANT_MMA_INFO(d, bb)                  \
  if (D == d && bits == bb) {                        \
    attributes<d, QuantTiles<d, bb>>(info);          \
    return cudaGetLastError();                       \
  }
  CRANE_QUANT_MMA_INFO(64, 8) CRANE_QUANT_MMA_INFO(64, 4) CRANE_QUANT_MMA_INFO(128, 8)
  CRANE_QUANT_MMA_INFO(128, 4) CRANE_QUANT_MMA_INFO(256, 8) CRANE_QUANT_MMA_INFO(256, 4)
#undef CRANE_QUANT_MMA_INFO
  return cudaErrorInvalidValue;
}
