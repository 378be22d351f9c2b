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
// stored (float32 or bfloat16), the contract of decode_attention.cuh.
//
// What bounds it on an H100: the KV bytes. Each decoded token reads
// 2 * valid * Hkv * D * sizeof(T) bytes per layer and does about 4 * G
// FLOPs per element read, far too few per byte for compute to be the limit.
//
// What the design does about it (decode_attention.cuh): the grid splits
// each (row, kv-head)'s live range over n_split blocks, so one stream at a
// long context reads its KV through every SM, and the last block to finish
// merges the splits in float32. Each lane loads 16 bytes of a row (8 bf16
// or 4 float32 dims), so a warp covers 2-4 bf16 rows per load below D =
// 256; slots past kv_valid are never read, whatever the allocated T.
#include "decode_attention.cuh"

namespace crane {
namespace {

// K1's rows policy at group G (the fp rows do not depend on it)
template <typename T, int D, int G>
using FpGroupRows = FpRows<T, D>;

}  // namespace
}  // namespace crane

// q [B,1,Hq,D], k/v [B,T,Hkv,D] (16-byte aligned), kv_valid [B] int32,
// out [B,1,Hq,D]; all contiguous, on the device of `stream`. m_out/l_out
// [B,Hq] float32, both NULL (K1) or both set (K1-S). window <= 0 and
// softcap <= 0 mean "off". n_split >= 1 blocks per (row, kv-head); above 1,
// part_acc [B,Hq,n_split,D] and part_ml [2,B,Hq,n_split] float32 scratch,
// and counters [B*Hkv] int32 zeros for the ticket merge. Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for
// arguments or a dtype/head-dim/group the kernel does not take.
extern "C" int crane_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* kv_valid,
                                      void* out, void* m_out, void* l_out,
                                      void* part_acc, void* part_ml, void* counters,
                                      int B, int T_len, int Hq, int Hkv, int D,
                                      float scale, int window, float softcap,
                                      int n_split, void* stream) {
  using namespace crane;
  if (B == 0) return 0;
  const DecodeArgs a{q, k, v, nullptr, nullptr, static_cast<const int*>(kv_valid), out,
                     static_cast<float*>(m_out), static_cast<float*>(l_out),
                     static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                     static_cast<int*>(counters), B, T_len, Hkv, n_split, scale, window,
                     softcap, static_cast<cudaStream_t>(stream)};
  if (!decode_args_ok(a, Hq)) return cudaErrorInvalidValue;
  if (!decode_dispatch<FpGroupRows>(dtype, D, Hq / Hkv, &a, nullptr)) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The compiled form of the instance at (dtype, D, G): info[0] registers a
// thread, info[1] local (spill) bytes a thread, info[2] shared memory bytes
// a block (static and dynamic), info[3] threads a block, info[4] blocks an
// SM holds at once.
extern "C" int crane_decode_attention_info(int dtype, int D, int G, int* info) {
  using namespace crane;
  if (!decode_dispatch<FpGroupRows>(dtype, D, G, nullptr, info)) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
