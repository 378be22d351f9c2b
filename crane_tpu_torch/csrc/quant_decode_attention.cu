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
// What the design does about it: K1's split-KV kernel (decode_attention.cuh)
// over QuantRows: the grid splits each (row, kv-head)'s live range over
// n_split blocks and merges the float32 partials; a row's codes span 2-32
// lanes, each loading 16 bytes where q and the accumulator stay small
// (int8 up to G = 2, int4 at G = 1; 8 or 4 bytes for larger groups), so a
// warp's load covers up to 16 rows; the scale of a token is one broadcast
// load from the (row, kv-head)'s contiguous scale row. The TPU kernel's
// block-diagonal q operand and 0/1 scale-expansion matrix (:316-332,
// :106-113) were MXU layout work-arounds and are gone. A row with no key to
// attend writes zeros (the TPU kernel's empty denominator guard, :153-154).
//
// This source holds the C entries and the int8 instances; the int4
// instances are in quant_decode_attention_int4.cu, compiled beside it.
#include "decode_attention.cuh"

namespace crane {
namespace {

template <typename T, int D, int G>
using Int8Rows = QuantRows<T, D, 8, G>;

// decode_dispatch over K4's instances at the bit width
bool quant_decode(int dtype, int bits, int D, int G, const DecodeArgs* a, int* info) {
  if (bits == 8) return decode_dispatch<Int8Rows>(dtype, D, G, a, info);
  if (bits == 4) return quant_decode_int4(dtype, D, G, a, info);
  return false;
}

}  // namespace
}  // namespace crane

// q [B,1,Hq,D]; k/v codes [B,T,Hkv*stored] int8 (16-byte aligned); k/v
// scales [B,Hkv,T] float32; kv_valid [B] int32; out [B,1,Hq,D]; m_out/l_out
// [B,Hq] float32, both NULL (K4) or both set (K4-S); all contiguous, on the
// device of `stream`. window <= 0 and softcap <= 0 mean "off". n_split and
// the scratch as for crane_decode_attention. Returns the CUDA error of the
// launch (0 on success), or cudaErrorInvalidValue for arguments or a dtype,
// bit width, head dim or group the kernel does not take.
extern "C" int crane_quant_decode_attention(
    int dtype, int bits, const void* q, const void* kc, const void* vc,
    const void* ks, const void* vs, const void* kv_valid, void* out,
    void* m_out, void* l_out, void* part_acc, void* part_ml, void* counters,
    int B, int T_len, int Hq, int Hkv, int D, float scale, int window, float softcap,
    int n_split, void* stream) {
  using namespace crane;
  if (B == 0) return 0;
  const DecodeArgs a{q, kc, vc, static_cast<const float*>(ks), static_cast<const float*>(vs),
                     static_cast<const int*>(kv_valid), out, static_cast<float*>(m_out),
                     static_cast<float*>(l_out), static_cast<float*>(part_acc),
                     static_cast<float*>(part_ml), static_cast<int*>(counters), B, T_len, Hkv,
                     n_split, scale, window, softcap, static_cast<cudaStream_t>(stream)};
  if (!decode_args_ok(a, Hq)) return cudaErrorInvalidValue;
  if (!quant_decode(dtype, bits, D, Hq / Hkv, &a, nullptr)) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The compiled form of the instance at (dtype, bits, D, G), as
// crane_decode_attention_info gives K1's.
extern "C" int crane_quant_decode_attention_info(int dtype, int bits, int D, int G, int* info) {
  using namespace crane;
  if (!quant_decode(dtype, bits, D, G, nullptr, info)) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
