// K6: quantized-weight matmul with per-column scales,
//   y[m, o] = (sum_i x[m, i] * code[i, o]) * scales[o].
//
// Replaces crane_tpu/ops/pallas/quant_matmul.py::quant_matmul (kernels
// _kernel_w8 and _kernel_w4), reached from ops/linear.py for every
// per-channel quantized weight at M <= 256 rows of activations: the
// decode steps of up to 256 slots, continuation chunks of up to 256
// tokens, and the int4 lm head.
//
// This file is the CUDA-core route: float32 x, and bfloat16 x at fewer than
// kMmaMinM rows (decode at batch 1 to 3), where the weight bytes bound the
// call. bfloat16 x at kMmaMinM rows or more goes to the tensor-core kernel
// (quant_matmul_mma.cu); crane_quant_matmul chooses by dtype and M.
//
// Layouts: x [M, I] (float32 or bfloat16); codes [I, O] int8 (bits 8) or
// [I/2, O] packed int4 (bits 4: byte (i, o) = 16 * code[i + I/2, o] +
// code[i, o], each code in [-7, 7]); scales [O] float32; y [M, O] in x's
// type. The sum is float32; the scale multiplies once at the end. x is not
// rounded to bf16 (the TPU kernel rounds it).
//
// What bounds it on an H100: the weight bytes. At decode (M <= 8) each
// code byte is used for at most 8 (int8) or 16 (int4) multiply-adds, far
// below the card's operations-per-byte balance, so the kernel is as fast
// as it streams codes; at M = 256 the CUDA-core multiply-adds take over.
//
// What the design does about it: every code byte crosses device memory
// once per M-tile of up to 8 rows (at decode, once), as stored -- int8 or
// packed int4 never widened in memory. A block owns 32 output columns and
// one M-tile and walks all of I; each thread owns 16 consecutive columns
// and loads them as one 16-byte vector (when O and the pointer allow it),
// so a pair of threads reads one 32-byte sector of a code row, and a warp
// has 16 rows, 4 x 16 bytes a thread, in flight. x is staged in shared
// memory, 512 code rows at a time (for int4 both halves, x[:, i] and
// x[:, i + I/2], pair with the low and high code of byte i), and read as
// broadcasts. int4 unpacks with integer shifts (common.cuh int4_hi). The
// per-thread partial sums over rows are reduced by warp shuffles and
// across warps in shared memory.
#include "common.cuh"

namespace crane {
namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;                                // columns a thread owns
constexpr int kLanesPerRow = 2;                          // threads on one code row
constexpr int kTileO = kCols * kLanesPerRow;             // 32 columns a block owns
constexpr int kRowsPerPass = kThreads / kLanesPerRow;    // 128 code rows a pass
constexpr int kChunk = 512;                              // code rows of x staged
constexpr int kUnroll = kChunk / kRowsPerPass;           // rows a thread loads
constexpr int kWarps = kThreads / 32;

// 16 codes of row `row`, columns [col, col + 16): one 16-byte load when
// kVec, else bytes with the O edge masked. Rows past Ip read as zeros.
template <bool kVec>
__device__ __forceinline__ void load_codes(const int8_t* __restrict__ codes,
                                           int row, int Ip, int col, int O,
                                           uint32_t (&w)[4]) {
  if constexpr (kVec) {
    if (row < Ip && col < O) {
      const int4 v =
          __ldg(reinterpret_cast<const int4*>(codes + (size_t)row * O + col));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      w[0] = w[1] = w[2] = w[3] = 0u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col + 4 * k + j;
        const uint32_t b = (row < Ip && c < O)
            ? static_cast<uint8_t>(codes[(size_t)row * O + c]) : 0u;
        word |= b << (8 * j);
      }
      w[k] = word;
    }
  }
}

template <typename T, int BM, bool kW4, bool kVec>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                    const float* __restrict__ scales, T* __restrict__ out,
                    int M, int I, int O) {
  __shared__ float xs[kW4 ? 2 : 1][BM][kChunk];  // x[:, i] (and x[:, i + I/2])
  __shared__ float red[kWarps][BM][kTileO];

  const int Ip = kW4 ? I / 2 : I;  // code rows
  const int o0 = blockIdx.x * kTileO;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = tid % kLanesPerRow;  // which 16 of the block's 32 columns
  const int rr = tid / kLanesPerRow;   // code row within a pass
  const int col = o0 + seg * kCols;

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int i0 = 0; i0 < Ip; i0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int idx = tid; idx < BM * kChunk; idx += kThreads) {
      const int m = idx / kChunk;
      const int c = idx % kChunk;
      const bool ok = m0 + m < M && i0 + c < Ip;
      const T* xr = x + (size_t)(m0 + m) * I + i0 + c;
      xs[0][m][c] = ok ? to_float(xr[0]) : 0.f;
      if constexpr (kW4) xs[1][m][c] = ok ? to_float(xr[Ip]) : 0.f;
    }
    __syncthreads();

    uint32_t w[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_codes<kVec>(codes, i0 + rr + u * kRowsPerPass, Ip, col, O, w[u]);

#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = rr + u * kRowsPerPass;
      float lo[kCols], hi[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int byte = byte_of(w[u][j / 4], j % 4);
        if constexpr (kW4) {
          hi[j] = static_cast<float>(int4_hi(byte));
          lo[j] = static_cast<float>(int4_lo(byte));
        } else {
          lo[j] = static_cast<float>(byte);
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xl = xs[0][m][c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] += xl * lo[j];
        if constexpr (kW4) {
          const float xh = xs[1][m][c];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[m][j] += xh * hi[j];
        }
      }
    }
  }

  // sum over the 16 code rows of a warp (lanes of equal seg), then over warps
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = kLanesPerRow; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < kLanesPerRow) red[warp][m][seg * kCols + j] = v;
    }
  __syncthreads();
  for (int idx = tid; idx < BM * kTileO; idx += kThreads) {
    const int m = idx / kTileO;
    const int c = idx % kTileO;
    const int o = o0 + c;
    if (m0 + m >= M || o >= O) continue;
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) v += red[w8][m][c];
    out[(size_t)(m0 + m) * O + o] = from_float<T>(v * scales[o]);
  }
}

template <typename T, int BM, bool kW4>
void launch(bool vec, const void* x, const int8_t* codes, const float* scales,
            void* out, int M, int I, int O, cudaStream_t stream) {
  dim3 grid((O + kTileO - 1) / kTileO, (M + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    quant_matmul_kernel<T, BM, kW4, true><<<grid, kThreads, 0, stream>>>(
        xt, codes, scales, ot, M, I, O);
  else
    quant_matmul_kernel<T, BM, kW4, false><<<grid, kThreads, 0, stream>>>(
        xt, codes, scales, ot, M, I, O);
}

template <typename T>
void dispatch(int bits, bool vec, const void* x, const int8_t* codes,
              const float* scales, void* out, int M, int I, int O,
              cudaStream_t stream) {
  // one row (decode at batch 1) keeps 16 accumulators a thread and many
  // blocks resident per SM; more rows take M-tiles of 8
  if (M == 1) {
    if (bits == 4) launch<T, 1, true>(vec, x, codes, scales, out, M, I, O, stream);
    else launch<T, 1, false>(vec, x, codes, scales, out, M, I, O, stream);
  } else {
    if (bits == 4) launch<T, 8, true>(vec, x, codes, scales, out, M, I, O, stream);
    else launch<T, 8, false>(vec, x, codes, scales, out, M, I, O, stream);
  }
}

}  // namespace

// bf16 x with at least this many rows takes the tensor-core kernel: in a
// same-call A/B on an H100 over the path's twelve (bits, I, O) shapes, this
// file's kernel won every one at 1 row and the tensor-core kernel every one
// at 4, 8, 12 and 16 (PERF.md section 5)
constexpr int kMmaMinM = 4;

// quant_matmul_mma.cu
cudaError_t quant_matmul_mma_bf16(int bits, const void* x, const int8_t* codes,
                                  const float* scales, void* out, int M, int I, int O,
                                  cudaStream_t stream);
}  // namespace crane

// x [M, I], codes [I, O] (bits 8) or [I/2, O] (bits 4) int8, scales [O]
// float32, out [M, O]; all contiguous, on the device of `stream`. Returns
// the CUDA error of the launch (0 on success), or cudaErrorInvalidValue for
// a dtype, bit width or shape the kernel does not take.
extern "C" int crane_quant_matmul(int dtype, int bits, const void* x,
                                  const void* codes, const void* scales,
                                  void* out, int M, int I, int O,
                                  void* stream) {
  using namespace crane;
  if (M == 0 || O == 0) return 0;
  if ((bits != 8 && bits != 4) || (bits == 4 && I % 2 != 0) || I <= 0)
    return cudaErrorInvalidValue;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte code loads need every row start 16-byte aligned
  const bool vec = O % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  // the tensor-core kernel's 16-byte copies need x's rows (and for int4 its
  // second half) and the code rows on 16-byte boundaries
  const int Ip = bits == 4 ? I / 2 : I;
  if (dtype == kBFloat16 && M >= kMmaMinM && vec && Ip % 8 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return quant_matmul_mma_bf16(bits, x, c, s, out, M, I, O, st);
  if (dtype == kBFloat16)
    dispatch<__nv_bfloat16>(bits, vec, x, c, s, out, M, I, O, st);
  else if (dtype == kFloat32)
    dispatch<float>(bits, vec, x, c, s, out, M, I, O, st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
