// K2 and K3 in bfloat16 on the tensor cores: causal GQA flash attention for
// a fresh prefill (K2) and for a continuation chunk over the cache (K3, and
// its with-stats launch K3-S).
//
// Replaces, for bfloat16 storage, crane_tpu/ops/pallas/flash_attention.py
// _flash_causal_impl (K2) and _flash_cached_impl (K3), which also stands for
// quant_attention.py _cached_attention at bits=16 and its return_stats form
// (K3-S). crane_flash_attention (flash_attention.cu) routes bf16 here by
// dtype and keeps float32 on its CUDA-core kernel, which computes in full
// float32; nothing falls back from one to the other.
//
// The contract, what bounds the kernel and what its design does about it
// are in flash_attention_mma.cuh, whose tile loop K5 in bf16 shares; here
// the K/V policy is Bf16Tiles, the cache rows staged as stored. The build
// has three instances (D = 64, 128, 256); K2/K3, window, softcap, segments
// and stats are run-time arguments.
#include "flash_attention_mma.cuh"

namespace crane {

// The bf16 route of crane_flash_attention (flash_attention.cu), with its
// arguments checked there. Returns the CUDA error of the launch, or
// cudaErrorInvalidValue for a head dim it does not take.
cudaError_t flash_attention_mma_bf16(const void* q, const void* k, const void* v, void* out,
                                     float* m_out, float* l_out, const int* positions,
                                     const int* segments, int B, int S, int Tk, int Hq,
                                     int Hkv, int D, float scale, int window, float softcap,
                                     cudaStream_t stream, const int* kv_rows) {
#define CRANE_FLASH_MMA(d)                                                                  \
  case d: {                                                                                 \
    const mma::Bf16Tiles<d>::Args kv{static_cast<const __nv_bfloat16*>(k),                  \
                                     static_cast<const __nv_bfloat16*>(v)};                 \
    return mma::launch<d, mma::Bf16Tiles<d>>(q, kv, out, m_out, l_out, positions, segments, \
                                             B, S, Tk, Hq, Hkv, scale, window, softcap,     \
                                             stream, kv_rows);                              \
  }
  switch (D) {
    CRANE_FLASH_MMA(64)
    CRANE_FLASH_MMA(128)
    CRANE_FLASH_MMA(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef CRANE_FLASH_MMA
}

}  // namespace crane

// The compiled form of the bf16 kernel at head dim D: info[0] registers a
// thread, info[1] local (spill) bytes a thread, info[2] shared memory bytes
// a block (static and dynamic), info[3] threads a block. Returns the CUDA
// error (cudaErrorInvalidValue for a head dim it does not take).
extern "C" int crane_flash_attention_mma_info(int D, int* info) {
  using namespace crane::mma;
  switch (D) {
    case 64:
      attributes<64, Bf16Tiles<64>>(info);
      break;
    case 128:
      attributes<128, Bf16Tiles<128>>(info);
      break;
    case 256:
      attributes<256, Bf16Tiles<256>>(info);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
