// Native GGUF block dequantization.
//
// Reference behavior: crane-core reads GGML-quantized tensors through
// Candle's CPU dequant kernels (the hot path of model load). Here the same
// public GGML block formats (q8_0, q4_0, q4_1, q5_0, q5_1, q4_k, q5_k, q6_k)
// are dequantized natively with OpenMP across blocks — bit-exact with the
// NumPy implementation in crane_tpu/loaders/gguf.py, which stays as the
// portable fallback.
//
// ABI: dequant(ggml_type, raw_bytes, n_elements, out_f32) -> 0 ok / -1 unsupported.

#include <cstdint>
#include <cstring>

namespace {

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      uint32_t e = 112;  // 127 - 15
      while (!(man & 0x400u)) {
        man <<= 1;
        e--;
      }
      man &= 0x3FFu;
      bits = sign | ((e + 1) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp + 112) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

void dq_q8_0(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 34;
    float d = f16_to_f32(rd16(blk));
    const int8_t* q = (const int8_t*)(blk + 2);
    float* o = out + b * 32;
    for (int i = 0; i < 32; i++) o[i] = d * (float)q[i];
  }
}

void dq_q4_0(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 18;
    float d = f16_to_f32(rd16(blk));
    const uint8_t* q = blk + 2;
    float* o = out + b * 32;
    for (int i = 0; i < 16; i++) {
      o[i] = d * ((float)(q[i] & 0x0F) - 8.0f);
      o[16 + i] = d * ((float)(q[i] >> 4) - 8.0f);
    }
  }
}

void dq_q4_1(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 20;
    float d = f16_to_f32(rd16(blk));
    float m = f16_to_f32(rd16(blk + 2));
    const uint8_t* q = blk + 4;
    float* o = out + b * 32;
    for (int i = 0; i < 16; i++) {
      o[i] = d * (float)(q[i] & 0x0F) + m;
      o[16 + i] = d * (float)(q[i] >> 4) + m;
    }
  }
}

void dq_q5_0(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 22;
    float d = f16_to_f32(rd16(blk));
    uint32_t qh = rd32(blk + 2);
    const uint8_t* q = blk + 6;
    float* o = out + b * 32;
    for (int i = 0; i < 16; i++) {
      float hb_lo = (float)((qh >> i) & 1u) * 16.0f;
      float hb_hi = (float)((qh >> (16 + i)) & 1u) * 16.0f;
      o[i] = d * ((float)(q[i] & 0x0F) + hb_lo - 16.0f);
      o[16 + i] = d * ((float)(q[i] >> 4) + hb_hi - 16.0f);
    }
  }
}

void dq_q5_1(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 24;
    float d = f16_to_f32(rd16(blk));
    float m = f16_to_f32(rd16(blk + 2));
    uint32_t qh = rd32(blk + 4);
    const uint8_t* q = blk + 8;
    float* o = out + b * 32;
    for (int i = 0; i < 16; i++) {
      float hb_lo = (float)((qh >> i) & 1u) * 16.0f;
      float hb_hi = (float)((qh >> (16 + i)) & 1u) * 16.0f;
      o[i] = d * ((float)(q[i] & 0x0F) + hb_lo) + m;
      o[16 + i] = d * ((float)(q[i] >> 4) + hb_hi) + m;
    }
  }
}

// q4_k / q5_k: 12-byte packed 6-bit scales+mins for 8 sub-blocks
inline void unpack_k_scales(const uint8_t* sc, float* scales, float* mins) {
  for (int j = 0; j < 8; j++) {
    if (j < 4) {
      scales[j] = (float)(sc[j] & 63);
      mins[j] = (float)(sc[j + 4] & 63);
    } else {
      scales[j] = (float)((sc[j + 4] & 0x0F) | ((sc[j - 4] >> 6) << 4));
      mins[j] = (float)((sc[j + 4] >> 4) | ((sc[j] >> 6) << 4));
    }
  }
}

void dq_q4_k(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 144;
    float d = f16_to_f32(rd16(blk));
    float dmin = f16_to_f32(rd16(blk + 2));
    float scales[8], mins[8];
    unpack_k_scales(blk + 4, scales, mins);
    const uint8_t* qs = blk + 16;
    float* o = out + b * 256;
    for (int c = 0; c < 4; c++) {
      const uint8_t* chunk = qs + c * 32;
      int sb0 = 2 * c, sb1 = 2 * c + 1;
      for (int i = 0; i < 32; i++) {
        o[sb0 * 32 + i] = d * scales[sb0] * (float)(chunk[i] & 0x0F) - dmin * mins[sb0];
        o[sb1 * 32 + i] = d * scales[sb1] * (float)(chunk[i] >> 4) - dmin * mins[sb1];
      }
    }
  }
}

void dq_q5_k(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 176;
    float d = f16_to_f32(rd16(blk));
    float dmin = f16_to_f32(rd16(blk + 2));
    float scales[8], mins[8];
    unpack_k_scales(blk + 4, scales, mins);
    const uint8_t* qh = blk + 16;
    const uint8_t* qs = blk + 48;
    float* o = out + b * 256;
    for (int c = 0; c < 4; c++) {
      const uint8_t* chunk = qs + c * 32;
      int sb0 = 2 * c, sb1 = 2 * c + 1;
      for (int i = 0; i < 32; i++) {
        float hb_lo = (float)((qh[i] >> (2 * c)) & 1) * 16.0f;
        float hb_hi = (float)((qh[i] >> (2 * c + 1)) & 1) * 16.0f;
        o[sb0 * 32 + i] = d * scales[sb0] * ((float)(chunk[i] & 0x0F) + hb_lo) - dmin * mins[sb0];
        o[sb1 * 32 + i] = d * scales[sb1] * ((float)(chunk[i] >> 4) + hb_hi) - dmin * mins[sb1];
      }
    }
  }
}

void dq_q6_k(const uint8_t* raw, int64_t nb, float* out) {
#pragma omp parallel for
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* blk = raw + b * 210;
    const uint8_t* ql = blk;
    const uint8_t* qh = blk + 128;
    const int8_t* sc = (const int8_t*)(blk + 192);
    float d = f16_to_f32(rd16(blk + 208));
    float* o = out + b * 256;
    for (int half = 0; half < 2; half++) {
      const uint8_t* qlh = ql + half * 64;
      const uint8_t* qhh = qh + half * 32;
      int base = half * 128;
      for (int i4 = 0; i4 < 4; i4++) {
        int seg = base + i4 * 32;
        int s_idx = half * 8 + i4 * 2;
        for (int i = 0; i < 32; i++) {
          int q;
          switch (i4) {
            case 0: q = (int)(qlh[i] & 0x0F) | (((qhh[i] >> 0) & 3) << 4); break;
            case 1: q = (int)(qlh[32 + i] & 0x0F) | (((qhh[i] >> 2) & 3) << 4); break;
            case 2: q = (int)(qlh[i] >> 4) | (((qhh[i] >> 4) & 3) << 4); break;
            default: q = (int)(qlh[32 + i] >> 4) | (((qhh[i] >> 6) & 3) << 4); break;
          }
          // match numpy: composed value stored as int8 before the -32
          int8_t q8 = (int8_t)q;
          float qf = (float)q8 - 32.0f;
          float s = (float)sc[s_idx + (i < 16 ? 0 : 1)];
          o[seg + i] = d * s * qf;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// ggml type ids must match crane_tpu/loaders/gguf.py
int gguf_dequant(int ggml_type, const uint8_t* raw, int64_t n_elements, float* out) {
  switch (ggml_type) {
    case 8:  dq_q8_0(raw, n_elements / 32, out); return 0;   // Q8_0
    case 2:  dq_q4_0(raw, n_elements / 32, out); return 0;   // Q4_0
    case 3:  dq_q4_1(raw, n_elements / 32, out); return 0;   // Q4_1
    case 6:  dq_q5_0(raw, n_elements / 32, out); return 0;   // Q5_0
    case 7:  dq_q5_1(raw, n_elements / 32, out); return 0;   // Q5_1
    case 12: dq_q4_k(raw, n_elements / 256, out); return 0;  // Q4_K
    case 13: dq_q5_k(raw, n_elements / 256, out); return 0;  // Q5_K
    case 14: dq_q6_k(raw, n_elements / 256, out); return 0;  // Q6_K
    default: return -1;
  }
}

}  // extern "C"
