// K7, the chunkwise route: the Gated-Delta-Net recurrence (gated delta
// rule) in chunks of kC = 64 timesteps on the tensor cores.
//
// Replaces crane_tpu/ops/pallas/gdn_scan.py:126 (gdn_recurrence_pallas,
// kernel _gdn_kernel) for S >= CHUNK_MIN_S (ops/cuda/gdn_scan.py, 128);
// shorter calls keep the sequential scan of gdn_scan.cu, which pays no
// chunk preparation and is faster there. It computes what the scan
// computes, per (batch row b, head h) with a float32 state S [K, V] (the
// initial state or zeros): S *= exp(g_t); delta = (v_t - k_t . S) beta_t;
// S += k_t (x) delta; y_t = q_t . S, with q and k l2-normalized and q scaled
// by K^-1/2 (here, in the preparation kernel, on rows as the model gives
// them). y is written in v's dtype, the final state in float32; a step with
// g = 0 and beta = 0 leaves the state alone.
//
// What bounds it on an H100: the scan pays one dependent step of two warp
// reductions per timestep (0.3-0.4 us at B = 1), 1000 dependent steps for
// a 1000-token prompt, with the tensor cores idle. The chunkwise ("WY") form
// folds the dependency inside a chunk into the inverse of a unit-lower-
// triangular kC x kC matrix and leaves ceil(S / kC) dependent steps (16 at
// S = 1000), each a few 64-row matrix products. Its least time is then the
// bytes (q, k, v, y: about 5 us at B = 1, S = 1000, H = 16, K = V = 128);
// what holds it above that is latency: one preparation block per chunk
// (about 28 us at one block an SM) and, per chunk, a state-pass step that
// re-reads the chunk's operands (about 116 KB a block) from L2 (about 5 us).
//
// What the design does, with gc the in-chunk prefix sum of g and
// Gamma_ij = exp(gc_i - gc_j) for i >= j:
//  1. gdn_chunk_prep_kernel, grid (B * H, chunks), parallel over chunks, 8
//     warps: normalizes q and k, A = strict_lower(-(beta k) k^T o Gamma),
//     T = (I - A)^-1 (16 x 16 diagonal blocks by forward substitution, the
//     off-diagonal blocks by block products, float32 on the CUDA cores),
//     W = T (beta exp(gc) k), U = T (beta v), P = lower(q k^T o Gamma),
//     QG = q exp(gc), KDT = (k exp(gc_last - gc))^T and exp(gc_last), into
//     float32 scratch the wrapper allocates (about 36 MB at S = 1000,
//     H = 16, K = V = 128), written in whole row pieces with st.global.cg
//     and read back from L2.
//  2. gdn_chunk_state_kernel, grid (B * H, V / VT), 8 warps: a block keeps
//     VT columns of one state in registers (the accumulators of its last
//     product) and walks the chunks in order: Vn = U - W S,
//     y = QG S + P Vn, S = exp(gc_last) S + KDT Vn. The next chunk's W, QG
//     and U are staged by cp.async while the current chunk's P and KDT
//     products run, and P and KDT while W S runs (when both sets fit in
//     shared memory; at K = 256 they share it and load in turn). VT is 16
//     while the grid is small (B = 1: more blocks share each chunk's
//     products) and 32 once B H V / 32 blocks fill the card (half the
//     operands re-read); the same-call A/B chose both.
// Every product is mma.sync m16n8k8 TF32 in 3xTF32 form: each float32
// operand is split into a TF32 hi part and a TF32 lo part and the sum
// hi.hi + hi.lo + lo.hi is taken in float32, about float32's accuracy (one
// TF32 pass misses the state tolerance when T's entries grow). Inside a
// 16-wide k tile a lane's physical columns 4t..4t+3 stand for the logical
// k's t and t + 4 of two k-steps, so every operand row is read as one
// 16-byte load. The branches that skip work above the diagonal sit outside
// the mma loops, or are not taken at all: T's and P's zero blocks above it
// are multiplied.
// The tail chunk is masked in the kernels (rows at or past S are g = 0,
// beta = 0, q = k = v = 0), so the wrapper pads nothing.
#include "common.cuh"

namespace crane {
namespace {

constexpr int kC = 64;          // timesteps a chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUPad = 64;       // U's rows hold V rounded up to this
// state columns a state-pass block owns: kNarrowCols while the grid is
// small (B = 1: more blocks, each chunk's products spread wider), kWideCols
// (K <= 128) once B H V / kWideCols blocks fill the card (half the chunk
// operands re-read from L2)
constexpr int kNarrowCols = 16;
constexpr int kWideCols = 32;
constexpr unsigned kFull = 0xffffffffu;

// Float32 pointers into the wrapper's scratch, chunk m = bh * chunks + c:
// W, QG [m][kC][K]; KDT [m][K][kC]; P [m][kC][kC]; U [m][kC][Vp]; decay [m].
struct ChunkScratch {
  float* W;
  float* QG;
  float* KDT;
  float* P;
  float* U;
  float* decay;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// float32 -> TF32 bits, round to nearest with ties away from zero (what
// cvt.rna.tf32.f32 does, in two integer operations; finite inputs)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A 16 x 8 operand (four elements a lane) and an 8 x 8 one (two), each as
// TF32 hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// The two k-steps of a 16-wide k tile from a lane's 16-byte loads of rows
// g (r0) and g + 8 (r1) at columns 4t..4t+3.
__device__ __forceinline__ void frag_a2(const float4& r0, const float4& r1, FragA (&f)[2]) {
  f[0] = frag_a(r0.x, r1.x, r0.y, r1.y);
  f[1] = frag_a(r0.z, r1.z, r0.w, r1.w);
}

// b0 (k t, col g), b1 (k t + 4, col g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// Eight consecutive elements of a float32 or bf16 row (16-byte aligned) as
// float32.
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = *reinterpret_cast<const float4*>(p);
  b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a, float4& b) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  const float2 f2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.z));
  const float2 f3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.w));
  a = make_float4(f0.x, f0.y, f1.x, f1.y);
  b = make_float4(f2.x, f2.y, f3.x, f3.y);
}

// An operand split once when it was stored: hi and lo arrays of TF32 bits.
__device__ __forceinline__ FragB frag_b_split(const float* hi, const float* lo, int i0, int i1) {
  FragB f;
  f.hi[0] = __float_as_uint(hi[i0]);
  f.hi[1] = __float_as_uint(hi[i1]);
  f.lo[0] = __float_as_uint(lo[i0]);
  f.lo[1] = __float_as_uint(lo[i1]);
  return f;
}

__device__ __forceinline__ void store_split(float* hi, float* lo, int i, float x) {
  uint32_t h, l;
  split(x, h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a b[n] in 3xTF32 over N tiles that share the operand a, pass by
// pass (lo.hi, hi.lo, then hi.hi), so that consecutive mma.sync are
// independent
template <int N>
__device__ __forceinline__ void mma3_row(float (&c)[N][4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.hi, b[n].hi[0], b[n].hi[1]);
}

// The same with the small products in accumulators of their own (big +
// small is the sum), for rows of few tiles: twice the independent chains
template <int N>
__device__ __forceinline__ void mma3_row(float (&big)[N][4], float (&small)[N][4], const FragA& a,
                                         const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(small[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(big[n], a.hi, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(small[n], a.hi, b[n].lo[0], b[n].lo[1]);
}

// Row and column (within its 16 x 8 tile) of accumulator element e of a lane.
__device__ __forceinline__ int acc_row(int gid, int e) { return gid + (e >= 2 ? 8 : 0); }
__device__ __forceinline__ int acc_col(int tig, int e) { return 2 * tig + (e & 1); }

// ---------------------------------------------------------------------------
// 1. Chunk preparation.

template <int K>
struct PrepSmem {
  static constexpr int kLd = K + 16;     // q and k rows (16-byte row loads)
  static constexpr int kLdX = K + 2;     // X rows, read by rows as a B operand
  static constexpr int kLdT = kC + 16;   // A, then T
  static constexpr int kLdV = kUPad + 2; // a tile of beta v
  static constexpr int kLdP = kC + 4;    // P, and KDT's rows, staged for row writes
  static constexpr int kK = 0;
  static constexpr int kQ = kK + kC * kLd;  // q, then KDT's rows, X, the v tiles
  static constexpr int kT = kQ + kC * kLd;
  static constexpr int kPs = kT + kC * kLdT;  // P
  static constexpr int kM = kPs + kC * kLdP;   // off-diagonal block sums, 3 x 16 x 16
  static constexpr int kG = kM + 3 * 256;    // gc
  static constexpr int kBeta = kG + kC;
  static constexpr int kEg = kBeta + kC;     // exp(gc)
  static constexpr int kXs = kEg + kC;       // beta exp(gc)
  static constexpr int kKd = kXs + kC;       // exp(gc_last - gc)
  static constexpr int kFloats = kKd + kC;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kC * kLdX <= kC * kLd && kC * kLdV <= kC * kLd && K * kLdP <= kC * kLd,
                "X, v tiles and KDT's rows fit where q was");
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
gdn_chunk_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ beta, ChunkScratch sc, int S, int H, int V,
                      int n_chunks) {
  using L = PrepSmem<K>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ks = sm + L::kK;
  float* qs = sm + L::kQ;
  float* xs = sm + L::kQ;  // X = beta exp(gc) k, after q is done
  float* vs = sm + L::kQ;  // tiles of beta v, after X is done
  float* kdt = sm + L::kQ; // KDT's rows, between q and X
  float* Ps = sm + L::kPs;
  float* Ts = sm + L::kT;
  float* Ms = sm + L::kM;
  float* gs = sm + L::kG;
  float* bs = sm + L::kBeta;
  float* eg = sm + L::kEg;
  float* xsc = sm + L::kXs;
  float* kd = sm + L::kKd;

  const int bh = blockIdx.x;
  const int c = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = c * kC;
  const int n = min(kC, S - t0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const size_t m = (size_t)bh * n_chunks + c;
  const int Vp = round_up(V, kUPad);

  // q and k rows of the chunk as they come (rows at or past S are zeros),
  // in float32, and g and beta
#pragma unroll 2
  for (int i = tid; i < kC * (K / 8); i += kThreads) {
    const int r = i / (K / 8);
    const int e = 8 * (i % (K / 8));
    float4 x[4] = {};
    if (r < n) {
      const size_t row = ((size_t)b * S + t0 + r) * H + h;
      load8(k + row * K + e, x[0], x[1]);
      load8(q + row * K + e, x[2], x[3]);
    }
    *reinterpret_cast<float4*>(ks + r * L::kLd + e) = x[0];
    *reinterpret_cast<float4*>(ks + r * L::kLd + e + 4) = x[1];
    *reinterpret_cast<float4*>(qs + r * L::kLd + e) = x[2];
    *reinterpret_cast<float4*>(qs + r * L::kLd + e + 4) = x[3];
  }
  if (tid < kC) {
    const bool in = tid < n;
    const size_t row = ((size_t)b * S + t0 + tid) * H + h;
    gs[tid] = in ? g[row] : 0.f;
    bs[tid] = in ? beta[row] : 0.f;
  }
  __syncthreads();
  if (warp == 0) {  // gc: the inclusive prefix sum of g, two entries a lane
    const float x0 = gs[2 * lane];
    const float x1 = gs[2 * lane + 1];
    float s = x0 + x1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += u;
    }
    float before = __shfl_up_sync(kFull, s, 1);
    if (lane == 0) before = 0.f;
    gs[2 * lane] = before + x0;
    gs[2 * lane + 1] = before + x0 + x1;
  }
  // l2-normalize every row of k and q as the plain version does (x
  // rsqrt(sum x^2 + 1e-6)), q also scaled by K^-1/2: a warp a row
  for (int r = warp; r < 2 * kC; r += kWarps) {
    float* row = r < kC ? ks + r * L::kLd : qs + (r - kC) * L::kLd;
    float ss = 0.f;
#pragma unroll
    for (int d = lane; d < K; d += 32) ss += row[d] * row[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
    const float scale = rsqrtf(ss + 1e-6f) * (r < kC ? 1.f : rsqrtf(static_cast<float>(K)));
#pragma unroll
    for (int d = lane; d < K; d += 32) row[d] *= scale;
  }
  __syncthreads();
  if (tid < kC) {
    const float e = expf(gs[tid]);
    eg[tid] = e;
    xsc[tid] = bs[tid] * e;
    kd[tid] = expf(gs[kC - 1] - gs[tid]);
  }

  // [k; q] k^T: warps 0-3 give A's rows, warps 4-7 P's, 16 rows a warp,
  // four column tiles at a time, skipping quads wholly above the diagonal
  // (the test sits outside the k loop)
  {
    const float* src = warp < 4 ? ks : qs;
    const int r0 = 16 * (warp % 4);
    const int live = r0 / 32 + 1;  // quads of column tiles that reach the diagonal
#pragma unroll 1
    for (int quad = 0; quad < 2; ++quad) {
      float acc[4][4] = {}, small[4][4] = {};
      if (quad < live) {
#pragma unroll 2
        for (int kt = 0; kt < K; kt += 16) {
          FragA fa[2];
          const float* p = src + (r0 + gid) * L::kLd + kt + 4 * tig;
          frag_a2(*reinterpret_cast<const float4*>(p),
                  *reinterpret_cast<const float4*>(p + 8 * L::kLd), fa);
          FragB fb[2][4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float4 rb = *reinterpret_cast<const float4*>(
                ks + (8 * (4 * quad + t) + gid) * L::kLd + kt + 4 * tig);
            fb[0][t] = frag_b(rb.x, rb.y);
            fb[1][t] = frag_b(rb.z, rb.w);
          }
          mma3_row(acc, small, fa[0], fb[0]);
          mma3_row(acc, small, fa[1], fb[1]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + acc_row(gid, e);
          const int j = 8 * (4 * quad + t) + acc_col(tig, e);
          // Gamma_ij, and 0 above the diagonal, without a branch (lanes
          // of a warp sit on both sides of it)
          const float gam = expf(fminf(gs[i] - gs[j], 0.f));
          const float x = (acc[t][e] + small[t][e]) * gam;
          if (warp < 4)
            Ts[i * L::kLdT + j] = j < i ? -bs[i] * x : 0.f;
          else
            Ps[i * L::kLdP + j] = j <= i ? x : 0.f;
        }
    }
  }
  __syncthreads();  // A, eg, xsc, kd in shared memory

  // QG = q exp(gc), P and KDT = (k exp(gc_last - gc))^T to the scratch, in
  // whole 16-byte row pieces, with st.global.cg: the state pass reads them
  // back through L2
  {
    float* QG = sc.QG + m * kC * K;
#pragma unroll 4
    for (int i = tid; i < kC * K / 4; i += kThreads) {
      const int r = i / (K / 4);
      const int d = 4 * (i % (K / 4));
      float4 x = *reinterpret_cast<const float4*>(qs + r * L::kLd + d);
      x.x *= eg[r];
      x.y *= eg[r];
      x.z *= eg[r];
      x.w *= eg[r];
      __stcg(reinterpret_cast<float4*>(QG + r * K + d), x);
    }
    float* P = sc.P + m * kC * kC;
#pragma unroll 4
    for (int i = tid; i < kC * kC / 4; i += kThreads) {
      const int r = i / (kC / 4);
      const int j = 4 * (i % (kC / 4));
      __stcg(reinterpret_cast<float4*>(P + r * kC + j),
             *reinterpret_cast<const float4*>(Ps + r * L::kLdP + j));
    }
    if (tid == 0) sc.decay[m] = expf(gs[kC - 1]);
  }
  __syncthreads();  // q is no longer read
  // KDT's rows where q was: a warp takes 4 rows j of k at 8 dims d
#pragma unroll 4
  for (int i = tid; i < K * kC; i += kThreads) {
    const int blk = i / 32;
    const int j = 4 * (blk % (kC / 4)) + (i & 3);
    const int d = 8 * (blk / (kC / 4)) + (i % 32) / 4;
    kdt[d * L::kLdP + j] = ks[j * L::kLd + d] * kd[j];
  }
  __syncthreads();
  {
    float* KDT = sc.KDT + m * K * kC;
#pragma unroll 4
    for (int i = tid; i < K * kC / 4; i += kThreads) {
      const int d = i / (kC / 4);
      const int j = 4 * (i % (kC / 4));
      __stcg(reinterpret_cast<float4*>(KDT + d * kC + j),
             *reinterpret_cast<const float4*>(kdt + d * L::kLdP + j));
    }
  }
  // the diagonal 16 x 16 blocks of T = (I - A)^-1 by forward substitution,
  // one thread a column: x_i = [i == col] + sum_{j < i} A_ij x_j
  float x[16];
  if (tid < kC) {
    const int base = 16 * (tid / 16);
    const int col = tid % 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float s = i == col ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < i; ++j) s += Ts[(base + i) * L::kLdT + base + j] * x[j];
      x[i] = s;
    }
  }
  __syncthreads();  // every read of A's diagonal blocks and of KDT's rows is done
  if (tid < kC) {
    const int base = 16 * (tid / 16);
    const int col = tid % 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) Ts[(base + i) * L::kLdT + base + col] = x[i];
  }
#pragma unroll 4
  for (int i = tid; i < kC * K; i += kThreads) {  // X = beta exp(gc) k, where q was
    const int r = i / K;
    const int d = i % K;
    xs[r * L::kLdX + d] = ks[r * L::kLd + d] * xsc[r];
  }
  __syncthreads();
  // the off-diagonal blocks, block row by block row:
  // T_ij = T_ii sum_{l = j}^{i-1} A_il T_lj
  for (int bi = 1; bi < 4; ++bi) {
    for (int e = tid; e < bi * 256; e += kThreads) {
      const int bj = e / 256;
      const int r = (e / 16) % 16;
      const int cc = e % 16;
      float s = 0.f;
      for (int bl = bj; bl < bi; ++bl)
#pragma unroll
        for (int l = 0; l < 16; ++l)
          s += Ts[(16 * bi + r) * L::kLdT + 16 * bl + l] *
               Ts[(16 * bl + l) * L::kLdT + 16 * bj + cc];
      Ms[e] = s;
    }
    __syncthreads();
    for (int e = tid; e < bi * 256; e += kThreads) {
      const int bj = e / 256;
      const int r = (e / 16) % 16;
      const int cc = e % 16;
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < 16; ++l)
        s += Ts[(16 * bi + r) * L::kLdT + 16 * bi + l] * Ms[bj * 256 + l * 16 + cc];
      Ts[(16 * bi + r) * L::kLdT + 16 * bj + cc] = s;
    }
    __syncthreads();
  }

  // W = T X and U = T (beta v): warp w owns rows 16 (w % 4) .. + 15 and
  // half the columns of a 64-wide tile. The next tile of v is loaded into registers
  // while the current products run.
  constexpr int kPer = kC * kUPad / kThreads;
  float xv[kPer];
  auto load_v = [&](int v0) {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kUPad;
      const int cc = i % kUPad;
      xv[it] = r < n && v0 + cc < V
                   ? to_float(v[(((size_t)b * S + t0 + r) * H + h) * V + v0 + cc]) : 0.f;
    }
  };
  load_v(0);
  const int mw = warp % 4;
  const int i0 = 16 * mw;
  const int c0 = 32 * (warp / 4);
  FragA ta[4][2];  // T's rows of this warp (its blocks above the diagonal
                   // are zeros, and taken all the same: no branch)
#pragma unroll
  for (int jt = 0; jt < 4; ++jt) {
    const float* p = Ts + (i0 + gid) * L::kLdT + 16 * jt + 4 * tig;
    frag_a2(*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 8 * L::kLdT),
            ta[jt]);
  }
  for (int d0 = 0; d0 < K; d0 += 64) {
    float acc[4][4] = {};
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      const int j = 16 * jt + 4 * tig;
      FragB fb[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = xs + j * L::kLdX + d0 + c0 + 8 * nt + gid;
        fb[0][nt] = frag_b(p[0], p[L::kLdX]);
        fb[1][nt] = frag_b(p[2 * L::kLdX], p[3 * L::kLdX]);
      }
      mma3_row(acc, ta[jt][0], fb[0]);
      mma3_row(acc, ta[jt][1], fb[1]);
    }
    float* W = sc.W + m * kC * K;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        __stcg(reinterpret_cast<float2*>(W + (i0 + acc_row(gid, e)) * K + d0 + c0 + 8 * nt +
                                         2 * tig),
               make_float2(acc[nt][e], acc[nt][e + 1]));
  }
  for (int v0 = 0; v0 < Vp; v0 += kUPad) {
    __syncthreads();  // X (or the last v tile) is no longer read
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = tid + it * kThreads;
      vs[(i / kUPad) * L::kLdV + i % kUPad] = xv[it] * bs[i / kUPad];
    }
    __syncthreads();
    if (v0 + kUPad < Vp) load_v(v0 + kUPad);
    float acc[4][4] = {};
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      const int j = 16 * jt + 4 * tig;
      FragB fb[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = vs + j * L::kLdV + c0 + 8 * nt + gid;
        fb[0][nt] = frag_b(p[0], p[L::kLdV]);
        fb[1][nt] = frag_b(p[2 * L::kLdV], p[3 * L::kLdV]);
      }
      mma3_row(acc, ta[jt][0], fb[0]);
      mma3_row(acc, ta[jt][1], fb[1]);
    }
    float* U = sc.U + m * kC * Vp;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        __stcg(reinterpret_cast<float2*>(U + (i0 + acc_row(gid, e)) * Vp + v0 + c0 + 8 * nt +
                                         2 * tig),
               make_float2(acc[nt][e], acc[nt][e + 1]));
  }
}

// ---------------------------------------------------------------------------
// 2. The state pass.

template <int K, int VT>
struct StateSmem {
  static constexpr int kLdA = K + 16;  // W and QG rows
  static constexpr int kLdB = kC + 16; // KDT and P rows
  static constexpr int kLdS = VT + 2;  // S and Vn, read by rows as B operands
  static constexpr int kLdU = VT + 4;  // U and Y
  static constexpr int kA = 2 * kC * kLdA;
  static constexpr int kB = (K + kC) * kLdB;
  static constexpr int kSmall = 2 * kC * kLdU + 2 * K * kLdS + 2 * kC * kLdS;
  // P and KDT get room of their own (so they load while W S runs) when
  // everything fits; else they share W and QG's room and load in turn
  static constexpr bool kPrefetch = sizeof(float) * (kA + kB + kSmall) <= 227 * 1024;
  static constexpr int kAOff = 0;
  static constexpr int kBOff = kPrefetch ? kA : 0;
  static constexpr int kUOff = kPrefetch ? kA + kB : kA;
  static constexpr int kYOff = kUOff + kC * kLdU;
  static constexpr int kShOff = kYOff + kC * kLdU;
  static constexpr int kSlOff = kShOff + K * kLdS;
  static constexpr int kVhOff = kSlOff + K * kLdS;
  static constexpr int kVlOff = kVhOff + kC * kLdS;
  static constexpr int kFloats = kVlOff + kC * kLdS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kB <= kA, "P and KDT fit where W and QG were");
  static_assert(kBytes <= 227 * 1024, "state-pass shared memory");
};

template <typename T, int K, int VT>
__global__ void __launch_bounds__(kThreads, 1)
gdn_chunk_state_kernel(ChunkScratch sc, const float* __restrict__ s0, T* __restrict__ y,
                       float* __restrict__ s_out, int S, int H, int V, int n_chunks) {
  using L = StateSmem<K, VT>;
  constexpr int NT = VT / 8;  // 8-column tiles
  // the state's tiles a warp owns: KM 16-row tiles of SN column tiles each
  // (at K = 64 two warps share a row tile, half the columns each)
  constexpr int kRowTiles = K / 16;
  constexpr int KM = kRowTiles >= kWarps ? kRowTiles / kWarps : 1;
  constexpr int SN = kRowTiles >= kWarps ? NT : NT * kRowTiles / kWarps;
  static_assert(KM * SN * kWarps == kRowTiles * NT, "state tiles over the warps");
  static_assert(NT % 2 == 0, "y's column tiles over two warps");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* As = sm + L::kAOff;  // W rows 0..63, QG rows 64..127
  float* Bs = sm + L::kBOff;  // KDT rows 0..K-1, P rows K..K+63
  float* Us = sm + L::kUOff;
  float* Ys = sm + L::kYOff;
  float* Sh = sm + L::kShOff;
  float* Sl = sm + L::kSlOff;
  float* Vh = sm + L::kVhOff;
  float* Vl = sm + L::kVlOff;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int v0 = blockIdx.y * VT;
  const int Vp = round_up(V, kUPad);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int s_row0 = kRowTiles >= kWarps ? warp * KM : warp % kRowTiles;  // row tiles
  const int s_col0 = kRowTiles >= kWarps ? 0 : (warp / kRowTiles) * SN;  // column tiles

  auto load_a = [&](int c) {
    const size_t m = (size_t)bh * n_chunks + c;
    const float* W = sc.W + m * kC * K;
    const float* QG = sc.QG + m * kC * K;
    for (int i = tid; i < 2 * kC * (K / 4); i += kThreads) {
      const int r = i / (K / 4);
      const int e = 4 * (i % (K / 4));
      cp16(As + r * L::kLdA + e, r < kC ? W + r * K + e : QG + (r - kC) * K + e);
    }
    const float* U = sc.U + m * kC * Vp + v0;
    for (int i = tid; i < kC * (VT / 4); i += kThreads) {
      const int r = i / (VT / 4);
      const int e = 4 * (i % (VT / 4));
      cp16(Us + r * L::kLdU + e, U + (size_t)r * Vp + e);
    }
    cp_commit();
  };
  auto load_b = [&](int c) {
    const size_t m = (size_t)bh * n_chunks + c;
    const float* KDT = sc.KDT + m * K * kC;
    const float* P = sc.P + m * kC * kC;
    for (int i = tid; i < (K + kC) * (kC / 4); i += kThreads) {
      const int r = i / (kC / 4);
      const int e = 4 * (i % (kC / 4));
      cp16(Bs + r * L::kLdB + e, r < K ? KDT + r * kC + e : P + (r - K) * kC + e);
    }
    cp_commit();
  };

  load_a(0);
  // this warp's tiles of the state in the accumulator layout, and the whole
  // state split into Sh / Sl for the B operand
  float st[KM][SN][4];
#pragma unroll
  for (int mt = 0; mt < KM; ++mt)
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * (s_row0 + mt) + acc_row(gid, e);
        const int col = 8 * (s_col0 + nt) + acc_col(tig, e);
        const float x = s0 != nullptr && v0 + col < V ? s0[((size_t)bh * K + row) * V + v0 + col]
                                                     : 0.f;
        st[mt][nt][e] = x;
        store_split(Sh, Sl, row * L::kLdS + col, x);
      }

  for (int c = 0; c < n_chunks; ++c) {
    const float decay = sc.decay[(size_t)bh * n_chunks + c];  // read now, used below
    cp_wait_all();
    __syncthreads();  // W, QG, U of chunk c and the state are in place
    if (L::kPrefetch) load_b(c);

    // W S (warps 0-3) and QG S (warps 4-7), 16 rows a warp
    {
      const int ra = 16 * warp;
      float acc[NT][4] = {}, small[NT][4] = {};
#pragma unroll 2
      for (int kt = 0; kt < K; kt += 16) {
        FragA fa[2];
        const float* p = As + (ra + gid) * L::kLdA + kt + 4 * tig;
        frag_a2(*reinterpret_cast<const float4*>(p),
                *reinterpret_cast<const float4*>(p + 8 * L::kLdA), fa);
        const int j = (kt + 4 * tig) * L::kLdS;
        FragB fb[2][NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = 8 * nt + gid;
          fb[0][nt] = frag_b_split(Sh, Sl, j + col, j + L::kLdS + col);
          fb[1][nt] = frag_b_split(Sh, Sl, j + 2 * L::kLdS + col, j + 3 * L::kLdS + col);
        }
        mma3_row(acc, small, fa[0], fb[0]);
        mma3_row(acc, small, fa[1], fb[1]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ra + acc_row(gid, e);
          const int col = 8 * nt + acc_col(tig, e);
          const float x = acc[nt][e] + small[nt][e];
          if (warp < 4)  // Vn = U - W S
            store_split(Vh, Vl, row * L::kLdS + col, Us[row * L::kLdU + col] - x);
          else
            Ys[(row - kC) * L::kLdU + col] = x;
        }
    }
    __syncthreads();  // Vn and QG S in place; W, QG and U are no longer read
    if (!L::kPrefetch) load_b(c);
    cp_wait_all();
    __syncthreads();  // P and KDT of chunk c in place
    if (L::kPrefetch && c + 1 < n_chunks) load_a(c + 1);

    // y = QG S + P Vn: warp w owns rows 16 (w % 4) .. + 15 and half the
    // column tiles
    {
      constexpr int NY = NT / 2;
      const int mw = warp % 4;
      const int n0 = (warp / 4) * NY;
      const float* Ps = Bs + K * L::kLdB;
      float acc[NY][4], small[NY][4] = {};
#pragma unroll
      for (int nt = 0; nt < NY; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] = Ys[(16 * mw + acc_row(gid, e)) * L::kLdU + 8 * (n0 + nt) + acc_col(tig, e)];
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {  // P's zero blocks too: no branch
        const float* p = Ps + (16 * mw + gid) * L::kLdB + 16 * jt + 4 * tig;
        FragA fa[2];
        frag_a2(*reinterpret_cast<const float4*>(p),
                *reinterpret_cast<const float4*>(p + 8 * L::kLdB), fa);
        const int j = (16 * jt + 4 * tig) * L::kLdS;
        FragB fb[2][NY];
#pragma unroll
        for (int nt = 0; nt < NY; ++nt) {
          const int col = 8 * (n0 + nt) + gid;
          fb[0][nt] = frag_b_split(Vh, Vl, j + col, j + L::kLdS + col);
          fb[1][nt] = frag_b_split(Vh, Vl, j + 2 * L::kLdS + col, j + 3 * L::kLdS + col);
        }
        mma3_row(acc, small, fa[0], fb[0]);
        mma3_row(acc, small, fa[1], fb[1]);
      }
#pragma unroll
      for (int nt = 0; nt < NY; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // this warp's own entries of Y, read above
          Ys[(16 * mw + acc_row(gid, e)) * L::kLdU + 8 * (n0 + nt) + acc_col(tig, e)] =
              acc[nt][e] + small[nt][e];
    }
    // S = exp(gc_last) S + KDT Vn
    {
      float small[KM][SN][4] = {};
#pragma unroll
      for (int mt = 0; mt < KM; ++mt)
#pragma unroll
        for (int nt = 0; nt < SN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][nt][e] *= decay;
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const int j = (16 * jt + 4 * tig) * L::kLdS;
        FragB fb[2][SN];
#pragma unroll
        for (int nt = 0; nt < SN; ++nt) {
          const int col = 8 * (s_col0 + nt) + gid;
          fb[0][nt] = frag_b_split(Vh, Vl, j + col, j + L::kLdS + col);
          fb[1][nt] = frag_b_split(Vh, Vl, j + 2 * L::kLdS + col, j + 3 * L::kLdS + col);
        }
#pragma unroll
        for (int mt = 0; mt < KM; ++mt) {
          const float* p = Bs + (16 * (s_row0 + mt) + gid) * L::kLdB + 16 * jt + 4 * tig;
          FragA fa[2];
          frag_a2(*reinterpret_cast<const float4*>(p),
                  *reinterpret_cast<const float4*>(p + 8 * L::kLdB), fa);
          mma3_row(st[mt], small[mt], fa[0], fb[0]);
          mma3_row(st[mt], small[mt], fa[1], fb[1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < KM; ++mt)
#pragma unroll
        for (int nt = 0; nt < SN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[mt][nt][e] += small[mt][nt][e];
            store_split(Sh, Sl,
                        (16 * (s_row0 + mt) + acc_row(gid, e)) * L::kLdS +
                            8 * (s_col0 + nt) + acc_col(tig, e),
                        st[mt][nt][e]);
          }
    }
    __syncthreads();  // P, KDT and Vn are no longer read, Y is whole
    if (!L::kPrefetch && c + 1 < n_chunks) load_a(c + 1);
    // y by rows of the block's columns (whole sectors)
    for (int i = tid; i < kC * VT; i += kThreads) {
      const int t = c * kC + i / VT;
      const int col = v0 + i % VT;
      if (t < S && col < V)
        y[(((size_t)b * S + t) * H + h) * V + col] = from_float<T>(Ys[(i / VT) * L::kLdU + i % VT]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < KM; ++mt)
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * (s_row0 + mt) + acc_row(gid, e);
        const int col = v0 + 8 * (s_col0 + nt) + acc_col(tig, e);
        if (col < V) s_out[((size_t)bh * K + row) * V + col] = st[mt][nt][e];
      }
}

// ---------------------------------------------------------------------------

struct ChunkArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* beta;
  const float* s0;
  void* y;
  float* s_out;
  ChunkScratch sc;
  int B, S, H, V, n_chunks;
  cudaStream_t stream;
};

template <typename T, int K, int VT>
int launch_state(const ChunkArgs& a) {
  using LS = StateSmem<K, VT>;
  static std::atomic<uint64_t> devices{0};
  allow_dynamic_smem_once(gdn_chunk_state_kernel<T, K, VT>, LS::kBytes, devices);
  gdn_chunk_state_kernel<T, K, VT>
      <<<dim3(a.B * a.H, (a.V + VT - 1) / VT), kThreads, LS::kBytes, a.stream>>>(
          a.sc, a.s0, static_cast<T*>(a.y), a.s_out, a.S, a.H, a.V, a.n_chunks);
  return cudaGetLastError();
}

// The SMs of the current device, asked once per device.
inline int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return 0;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, int K>
int launch_chunk(const ChunkArgs& a) {
  using LP = PrepSmem<K>;
  static std::atomic<uint64_t> prep_devices{0};
  allow_dynamic_smem_once(gdn_chunk_prep_kernel<T, K>, LP::kBytes, prep_devices);
  gdn_chunk_prep_kernel<T, K><<<dim3(a.B * a.H, a.n_chunks), kThreads, LP::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.g,
      a.beta, a.sc, a.S, a.H, a.V, a.n_chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (K <= 128) {
    if ((long long)a.B * a.H * ((a.V + kWideCols - 1) / kWideCols) >= sm_count())
      return launch_state<T, K, kWideCols>(a);
  }
  return launch_state<T, K, kNarrowCols>(a);
}

template <typename Kernel>
void attributes(Kernel kernel, size_t smem, int* info) {
  cudaFuncAttributes fa{};
  cudaFuncGetAttributes(&fa, kernel);
  info[0] = fa.numRegs;
  info[1] = static_cast<int>(fa.localSizeBytes);
  info[2] = static_cast<int>(fa.sharedSizeBytes + smem);
  info[3] = fa.maxThreadsPerBlock;
}

template <typename T, int K>
void chunk_info(int* info) {
  attributes(gdn_chunk_prep_kernel<T, K>, PrepSmem<K>::kBytes, info);
  attributes(gdn_chunk_state_kernel<T, K, kNarrowCols>, StateSmem<K, kNarrowCols>::kBytes,
             info + 4);
  if constexpr (K <= 128)
    attributes(gdn_chunk_state_kernel<T, K, kWideCols>, StateSmem<K, kWideCols>::kBytes,
               info + 8);
}

// Floats of scratch the chunkwise route needs (the wrapper allocates them,
// gdn_scan.py chunk_scratch_floats): per chunk of every (b, h), W and QG
// (kC K each), KDT (K kC), P (kC kC), U (kC Vp, Vp = V rounded up to 64)
// and one decay.
long long scratch_floats(int B, int S, int H, int K, int V) {
  const long long M = (long long)B * H * ((S + kC - 1) / kC);
  return M * (3LL * kC * K + (long long)kC * kC + (long long)kC * round_up(V, kUPad) + 1);
}

}  // namespace
}  // namespace crane

// The chunkwise route of K7: crane_gdn_scan's contract, except that q and
// k [B,S,H,K] come as the model gives them, in `dtype` (16-byte aligned),
// and are l2-normalized here (q also scaled by K^-1/2); v [B,S,H,V] in
// `dtype`; g, beta [B,S,H] float32; s0 [B,H,K,V] float32 or NULL (zeros);
// y [B,S,H,V] in `dtype`; s_out [B,H,K,V] float32, not aliasing s0;
// `scratch` float32 of at least scratch_floats(B,S,H,K,V) floats
// (`scratch_len` says how many it holds). Two launches on `stream`, the chunk
// preparation and the state pass. Returns the CUDA error (0 on success), or
// cudaErrorInvalidValue for a dtype, K, S or scratch it does not take.
extern "C" int crane_gdn_chunk(int dtype, const void* q, const void* k, const void* v,
                               const void* g, const void* beta, const void* s0, void* y,
                               void* s_out, void* scratch, long long scratch_len, int B,
                               int S, int H, int K, int V, void* stream) {
  using namespace crane;
  if (B == 0 || H == 0 || V == 0) return 0;
  if (S < 1 || V < 0 || scratch == nullptr ||
      scratch_len < scratch_floats(B, S, H, K, V))
    return cudaErrorInvalidValue;
  ChunkArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = static_cast<const float*>(g);
  a.beta = static_cast<const float*>(beta);
  a.s0 = static_cast<const float*>(s0);
  a.y = y;
  a.s_out = static_cast<float*>(s_out);
  a.B = B;
  a.S = S;
  a.H = H;
  a.V = V;
  a.n_chunks = (S + kC - 1) / kC;
  a.stream = static_cast<cudaStream_t>(stream);
  const size_t M = (size_t)B * H * a.n_chunks;
  float* p = static_cast<float*>(scratch);
  a.sc.W = p;
  a.sc.QG = a.sc.W + M * kC * K;
  a.sc.KDT = a.sc.QG + M * kC * K;
  a.sc.P = a.sc.KDT + M * K * kC;
  a.sc.U = a.sc.P + M * kC * kC;
  a.sc.decay = a.sc.U + M * kC * round_up(V, kUPad);
  const bool bf16 = dtype == kBFloat16;
  if (!bf16 && dtype != kFloat32) return cudaErrorInvalidValue;
  switch (K) {
    case 64: return bf16 ? launch_chunk<__nv_bfloat16, 64>(a) : launch_chunk<float, 64>(a);
    case 128: return bf16 ? launch_chunk<__nv_bfloat16, 128>(a) : launch_chunk<float, 128>(a);
    case 256: return bf16 ? launch_chunk<__nv_bfloat16, 256>(a) : launch_chunk<float, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The compiled form of the chunkwise route at `dtype` and K: info[0..3]
// the preparation kernel's registers a thread, local (spill) bytes a
// thread, shared memory a block and threads a block; info[4..7] the same of
// the state pass at 16 columns a block, info[8..11] at 32 (left as given
// at K = 256, which has only the first).
// Returns cudaErrorInvalidValue for a dtype or K it does not take.
extern "C" int crane_gdn_chunk_info(int dtype, int K, int* info) {
  using namespace crane;
  const bool bf16 = dtype == kBFloat16;
  if (!bf16 && dtype != kFloat32) return cudaErrorInvalidValue;
  switch (K) {
    case 64: bf16 ? chunk_info<__nv_bfloat16, 64>(info) : chunk_info<float, 64>(info); break;
    case 128: bf16 ? chunk_info<__nv_bfloat16, 128>(info) : chunk_info<float, 128>(info); break;
    case 256: bf16 ? chunk_info<__nv_bfloat16, 256>(info) : chunk_info<float, 256>(info); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
