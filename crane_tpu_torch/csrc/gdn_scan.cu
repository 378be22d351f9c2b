// K7: the Gated-Delta-Net recurrence (gated delta rule), one sequential
// scan over a whole prompt or chunk in one launch.
//
// Replaces crane_tpu/ops/pallas/gdn_scan.py::gdn_recurrence_pallas (kernel
// _gdn_kernel), reached through crane_tpu/ops/gdn.py::gdn_recurrence with
// backend "pallas".
//
// What it computes, per (batch row b, head h) with state S [K, V] float32
// (the initial state, or zeros), for t = 0 .. S_len - 1:
//   S  *= exp(g[t]);  kv = k[t] . S;  delta = (v[t] - kv) * beta[t];
//   S  += k[t] (x) delta;  y[t] = q[t] . S
// q, k and v arrive in float32 or bf16, as the model gives them; q and k
// are l2-normalized here as the plain version does (x rsqrt(sum x^2 +
// 1e-6), q also scaled by K^-1/2; the JAX wrapper does that before its
// kernel) when a tile of timesteps is staged. y is written in v's dtype,
// the final state in float32. A pad step with g = 0 and
// beta = 0 leaves the state as it was, so callers mask bucket padding
// without any chunk padding here.
//
// What bounds it on an H100: the sequential dependency along time, not
// bytes or FLOPs. Each step reads 2K + 1 floats of q/k/v per (b, h) and
// does about 4 K V FLOPs against a K x V state (64 KB at K = V = 128) that
// must stay on chip for the whole sequence: the chip's state and the
// latency of one step are the cost.
//
// What the design does about it: the recurrence is independent across the
// V columns of the state, so a block owns kCols = 16 columns of one (b, h)
// and the grid is (B * H, V / 16): 128 blocks at B = 1, H = 16, V = 128.
// kTPC = 8 threads share a column, each holding K / 8 of its rows in
// registers as float4 chunks c, c + 8, ... (16 floats at K = 128); the two
// dot products of a step (k . S and q . S) meet through three xor-shuffles
// inside the 8 lanes, so the state never leaves registers and no step waits
// on shared memory for it. Each tile of timesteps stages q and k (32 KB),
// the block's v columns, exp(g) and beta in shared memory with coalesced
// loads; the chunks of 8 neighbouring lanes are 128 contiguous bytes, read
// conflict-free and broadcast to the other column groups of the warp. y
// leaves through shared memory at the end of a tile, coalesced. At batch 1
// the grid fills about one block a streaming multiprocessor, four warps
// each, so a step's latency (its two reductions) sets the time; splitting
// the state's rows over more blocks would need a cross-block reduction per
// step, and is not done.
#include "common.cuh"

namespace crane {
namespace {

constexpr int kTPC = 8;                  // threads per state column
constexpr int kCols = 16;                // state columns per block
constexpr int kThreads = kTPC * kCols;   // 128

// Float4 chunks of a column a thread owns, and timesteps staged per tile
// (q and k of a tile take 2 * 4096 floats = 32 KB at every K).
template <int K>
struct Shape {
  static_assert(K % (4 * kTPC) == 0, "K must be a multiple of 32");
  static constexpr int kChunks = K / 4 / kTPC;
  static constexpr int kSteps = 4096 / K;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float sum_lanes(float x) {
#pragma unroll
  for (int off = 1; off < kTPC; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Four consecutive elements of a float32 or bf16 row as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
gdn_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ beta,
                const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ s_out, int S, int H, int V) {
  constexpr int NC = Shape<K>::kChunks;
  constexpr int TS = Shape<K>::kSteps;
  constexpr int K4 = K / 4;
  __shared__ float4 qs[TS][K4];
  __shared__ float4 ks[TS][K4];
  __shared__ float vs[TS][kCols];
  __shared__ float ys[TS][kCols];
  __shared__ float decay[TS], bt[TS];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int j = tid / kTPC;  // this thread's column within the block
  const int c = tid % kTPC;  // its chunks: c, c + kTPC, ...
  const int col = col0 + j;
  const bool live = col < V;

  // rows 4 * (c + kTPC * i) + 0..3 of column `col`
  float4 st[NC];
  const size_t sbase = (size_t)bh * K * V + col;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const size_t r = 4 * (c + kTPC * i);
    const bool in = live && s0 != nullptr;
    st[i].x = in ? s0[sbase + (r + 0) * V] : 0.f;
    st[i].y = in ? s0[sbase + (r + 1) * V] : 0.f;
    st[i].z = in ? s0[sbase + (r + 2) * V] : 0.f;
    st[i].w = in ? s0[sbase + (r + 3) * V] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int n = min(TS, S - t0);
    __syncthreads();  // the previous tile's reads of qs/ks/vs/ys are done
    for (int idx = tid; idx < n * K4; idx += kThreads) {
      const int tt = idx / K4;
      const int e = idx % K4;
      const size_t row = ((size_t)b * S + t0 + tt) * H + h;
      qs[tt][e] = load4(q + row * K + 4 * e);
      ks[tt][e] = load4(k + row * K + 4 * e);
    }
    for (int idx = tid; idx < n * kCols; idx += kThreads) {
      const int tt = idx / kCols;
      const int jj = idx % kCols;
      const size_t row = ((size_t)b * S + t0 + tt) * H + h;
      vs[tt][jj] = col0 + jj < V ? to_float(v[row * V + col0 + jj]) : 0.f;
    }
    for (int tt = tid; tt < n; tt += kThreads) {
      const size_t row = ((size_t)b * S + t0 + tt) * H + h;
      decay[tt] = expf(g[row]);
      bt[tt] = beta[row];
    }
    __syncthreads();
    // l2-normalize the tile's rows of q and k (q also by K^-1/2), a warp a row
    for (int r = tid / 32; r < 2 * n; r += kThreads / 32) {
      float4* row = r < n ? ks[r] : qs[r - n];
      float ss = 0.f;
      for (int e = tid % 32; e < K4; e += 32) ss += dot4(row[e], row[e]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float scale = rsqrtf(ss + 1e-6f) * (r < n ? 1.f : rsqrtf(static_cast<float>(K)));
      for (int e = tid % 32; e < K4; e += 32) {
        row[e].x *= scale;
        row[e].y *= scale;
        row[e].z *= scale;
        row[e].w *= scale;
      }
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float a = decay[tt];
      float kv = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        st[i].x *= a;
        st[i].y *= a;
        st[i].z *= a;
        st[i].w *= a;
        kv += dot4(ks[tt][c + kTPC * i], st[i]);
      }
      const float delta = (vs[tt][j] - sum_lanes(kv)) * bt[tt];
      float yv = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 kk = ks[tt][c + kTPC * i];
        st[i].x += kk.x * delta;
        st[i].y += kk.y * delta;
        st[i].z += kk.z * delta;
        st[i].w += kk.w * delta;
        yv += dot4(qs[tt][c + kTPC * i], st[i]);
      }
      yv = sum_lanes(yv);
      if (c == 0) ys[tt][j] = yv;
    }
    __syncthreads();
    for (int idx = tid; idx < n * kCols; idx += kThreads) {
      const int tt = idx / kCols;
      const int jj = idx % kCols;
      const size_t row = ((size_t)b * S + t0 + tt) * H + h;
      if (col0 + jj < V) y[row * V + col0 + jj] = from_float<T>(ys[tt][jj]);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const size_t r = 4 * (c + kTPC * i);
      s_out[sbase + (r + 0) * V] = st[i].x;
      s_out[sbase + (r + 1) * V] = st[i].y;
      s_out[sbase + (r + 2) * V] = st[i].z;
      s_out[sbase + (r + 3) * V] = st[i].w;
    }
  }
}

template <typename T, int K>
void launch(const void* q, const void* k, const void* v, const float* g,
            const float* beta, const float* s0, void* y, float* s_out,
            int B, int S, int H, int V, cudaStream_t stream) {
  dim3 grid(B * H, (V + kCols - 1) / kCols);
  gdn_scan_kernel<T, K><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), g, beta,
      s0, static_cast<T*>(y), s_out, S, H, V);
}

template <typename T>
bool dispatch_k(int K, const void* q, const void* k, const void* v,
                const float* g, const float* beta, const float* s0, void* y,
                float* s_out, int B, int S, int H, int V,
                cudaStream_t stream) {
  switch (K) {
#define CRANE_CASE(kk)                                                    \
  case kk:                                                                \
    launch<T, kk>(q, k, v, g, beta, s0, y, s_out, B, S, H, V, stream);    \
    return true;
    CRANE_CASE(64) CRANE_CASE(128) CRANE_CASE(256)
#undef CRANE_CASE
    default:
      return false;
  }
}

}  // namespace
}  // namespace crane

// q, k [B,S,H,K] in `dtype`, as the model gives them (8-byte aligned rows;
// l2-normalized here, q also scaled by K^-1/2); v [B,S,H,V] in `dtype`;
// g, beta [B,S,H] float32 (g the log decay); s0 [B,H,K,V] float32 or NULL
// (zeros); y [B,S,H,V] in `dtype`; s_out [B,H,K,V] float32.
// All contiguous, on the device of `stream`; s_out may not alias s0.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a dtype or K the kernel does not take.
extern "C" int crane_gdn_scan(int dtype, const void* q, const void* k,
                              const void* v, const void* g, const void* beta,
                              const void* s0, void* y, void* s_out, int B,
                              int S, int H, int K, int V, void* stream) {
  using namespace crane;
  if (B == 0 || H == 0 || V == 0) return 0;
  if (S < 0 || V < 0) return cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(beta);
  const float* sf = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kBFloat16)
    ok = dispatch_k<__nv_bfloat16>(K, q, k, v, gf, bf, sf, y, so, B, S, H, V, st);
  else if (dtype == kFloat32)
    ok = dispatch_k<float>(K, q, k, v, gf, bf, sf, y, so, B, S, H, V, st);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
