// K4's int4 instances (a packed-int4 KV cache), compiled beside
// quant_decode_attention.cu, which holds K4's C entries, its int8 instances
// and the description of the kernel. The split-KV kernel itself is
// decode_attention.cuh over QuantRows at 4 bits: a lane loads 16 bytes of
// codes at G = 1 (32 dims), 8 or 4 bytes for larger groups, and unpacks
// each byte exactly (hi = (b + 8) >> 4, common.cuh).
#include "decode_attention.cuh"

namespace crane {
namespace {

template <typename T, int D, int G>
using Int4Rows = QuantRows<T, D, 4, G>;

}  // namespace

bool quant_decode_int4(int dtype, int D, int G, const DecodeArgs* a, int* info) {
  return decode_dispatch<Int4Rows>(dtype, D, G, a, info);
}

}  // namespace crane
