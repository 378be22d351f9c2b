// The tensor-core flash-attention tile loop shared by K2/K3 in bfloat16
// (flash_attention_mma.cu) and K5 in bfloat16 (quant_cached_attention_mma.cu).
//
// What it computes is flash_attention.cu's contract: a query row at position
// p (K2: its index i; K3/K5: min(positions[b, i], T - 1)) attends keys j <= p
// and, with a window, j > p - window; with segments (K2 only) also any key
// of the same positive segment id. Logits are scale * q.k (K5: scale *
// k_scale[j] * q.code), optionally c * tanh(s / c); the softmax is online in
// float32. A row that sees no key writes zeros, and with stats m = -INFINITY
// and l = 0; m is the row max of the logits in natural-log units and
// l = sum exp(s - m), [B, Hq, S] float32. Batch row b reads the K/V of
// cache row b, or of row kv_rows[b] where the caller names one (K3 through
// crane_flash_attention_rows: a batch-1 chunk over a slot of a multi-row
// cache chosen on the device).
//
// What bounds it on an H100: the attention FLOPs (4 D per visible (row, key)
// pair and query head), which belong on the bf16 tensor cores; K/V bytes
// come next, read once per kv-head rather than once per query head.
//
// What the design does about it:
// - A block owns 64 query rows. The rows stack the G query heads of one
//   kv-head over 64 / G query positions (row r is position r / G, head
//   r % G; G > 64 splits the heads over blocks), so each staged K/V tile
//   feeds every head of its group. The mask depends only on a row's
//   position, so stacked heads share it.
// - A block is 4 warps, 16 rows a warp. Where the row tiles alone leave SMs
//   without a block (a 256-token continuation chunk has 32-64 row tiles; a
//   1024-token prefill at Qwen3.5's 8/2 heads has 128 of 132, the last of
//   them with 32 times the keys of the first), a thread-block cluster of 2
//   or 4 blocks shares a row tile: block r runs key tiles r, r + n, ... of
//   the band from its own ring, and at the end the cluster's first block
//   merges the others' (m, l, O) by log-sum-exp, reading them from their
//   shared memory (distributed shared memory), and writes the tile. No
//   scratch in device memory, no second pass.
// - S = Q K^T and O += P V are warp-level mma.sync.m16n8k16 bf16 products
//   with float32 accumulators. Operands come from shared memory through
//   ldmatrix (ldmatrix.trans for V, whose key axis is strided); Q's
//   fragments stay in registers up to D = 128 and are reloaded per k-step at
//   D = 256, where the 16 x 256 float32 O accumulator alone takes 128
//   registers a thread.
// - K/V tiles of 64 keys (32 at D = 256) are staged with 16-byte cp.async
//   copies into a 2-stage ring of dynamic shared memory: the next tile's
//   copy is in flight while the current one is used. How a tile is staged
//   is the template's K/V policy: Bf16Tiles copies bf16 rows straight into
//   swizzled tiles (one barrier a tile); QuantTiles (quant_cached_attention_
//   mma.cu) stages codes and scales and unpacks them once into the
//   swizzled bf16 tiles (a second barrier). Rows are XOR-swizzled by 16-byte
//   chunk (chunk ^ (row & 7)), so ldmatrix and the copies are free of bank
//   conflicts. Keys past the buffer are zero-filled.
// - Masking, softcap and the online max and sum run on the float32 S
//   fragments, in log2 units (one ex2 per logit); l sums the float32 P. A
//   tile that lies inside every live row's band skips the mask. A scaled
//   policy multiplies S by each key's k_scale before the scale and softcap,
//   and P by each key's v_scale after l has summed it (P' = p vs).
// - P (or P') enters P V as two bf16 A operands, hi = bf16(P) and lo =
//   bf16(P - hi) (three products per key tile instead of two). One bf16
//   rounding of P (2^-9 relative) moves the output of a row that sees few
//   keys by up to 2^-9 sum p|v| / l, more than the kernel is held to against
//   its plain version (1e-3 + 2^-6 |ref|), which keeps P in float32;
//   tests/test_torch_flash_tiles.py and tests/test_torch_quant_tiles.py
//   measure both forms.
// - The block runs only the key tiles inside its rows' causal or window band
//   (every tile with segments), so a chunk at context L reads O(L + S) keys;
//   a band wholly before the buffer (every position negative, K3-S/K5-S)
//   runs no tile. The grid is one axis of row tiles, the latest (heaviest)
//   query positions of every head first; when a second wave of blocks
//   shares the SMs with the first, it runs in reverse, pairing heavy with
//   light.
// - The output goes back through this warp's rows of the Q tile in shared
//   memory, so every row is written with 16-byte stores.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace crane {
namespace mma {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows of a block (the mma M tile)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 4;         // blocks of a cluster sharing one row tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct MmaTile {
  static constexpr int kBlockK = D > 128 ? 32 : 64;  // keys per staged tile
  static constexpr int kChunks = D / 8;              // 16-byte chunks of a row
  static constexpr bool kQInRegs = D <= 128;
  static constexpr size_t kQBytes = sizeof(__nv_bfloat16) * (size_t)kRows * D;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk c of row `row` in a swizzled bf16 tile
// with W elements a row (W / 8 >= 8 chunks).
template <int W>
__device__ __forceinline__ int swz(int row, int c) {
  return row * W + ((c ^ (row & 7)) << 3);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, col-major), bf16 in, float32 sum;
// a pure function of its registers, so the compiler may schedule it freely
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi), so that
// hi + lo is x to about 2^-17 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 2^x; 2^-inf = +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 code bytes at `src` as exact bf16 values in row j of swizzled bf16
// tiles W elements wide: int8 codes go to chunks lo_c and lo_c + 1 of
// `lo`; packed int4 bytes (common.cuh int4_lo / int4_hi) put their low
// codes there and their high codes in chunks hi_c and hi_c + 1 of `hi`.
template <int W, int BITS>
__device__ __forceinline__ void unpack16(const int8_t* src, __nv_bfloat16* lo, int lo_c,
                                         __nv_bfloat16* hi, int hi_c, int j) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
  uint32_t l[8], h[8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int b0 = byte_of(word[k], 2 * p), b1 = byte_of(word[k], 2 * p + 1);
      if constexpr (BITS == 4) {
        l[2 * k + p] = pack_bf16((float)int4_lo(b0), (float)int4_lo(b1));
        h[2 * k + p] = pack_bf16((float)int4_hi(b0), (float)int4_hi(b1));
      } else {
        l[2 * k + p] = pack_bf16((float)b0, (float)b1);
      }
    }
  *reinterpret_cast<uint4*>(lo + swz<W>(j, lo_c)) = make_uint4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<uint4*>(lo + swz<W>(j, lo_c + 1)) = make_uint4(l[4], l[5], l[6], l[7]);
  if constexpr (BITS == 4) {
    *reinterpret_cast<uint4*>(hi + swz<W>(j, hi_c)) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + swz<W>(j, hi_c + 1)) = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// Where block row r (0..kRows-1) lives: query index qi, query head h, and
// whether the row exists (r / GH < 64 / GH, its head < G, qi < S).
struct Row {
  int qi, h;
  bool live;
};
__device__ __forceinline__ Row block_row(int r, int q0, int QP, int GH, int g0, int G,
                                         int hk, int S) {
  const int pi = r / GH;
  const int gg = r % GH;
  Row row;
  row.qi = q0 + pi;
  row.h = hk * G + g0 + gg;
  row.live = pi < QP && g0 + gg < G && row.qi < S;
  return row;
}

// K/V policy of K2/K3: bf16 rows [B, Tk, Hkv, D], staged by cp.async
// straight into a 2-stage ring of swizzled [kBlockK][D] tiles.
template <int D>
struct Bf16Tiles {
  static constexpr int BK = MmaTile<D>::kBlockK;
  static constexpr bool kScaled = false;   // no per-key scales
  static constexpr bool kConvert = false;  // the staged tile is the operand
  // At D = 64 three blocks share an SM only while a thread keeps to 170
  // registers; at the 186 the compiler takes unbounded, two do, and K3
  // runs 1.28 times slower on an H100 (PERF.md section 6).
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
  // K and V [2 stages][BK][D] bf16
  static constexpr size_t kSmemBytes = sizeof(__nv_bfloat16) * 4 * BK * D;
  struct Args {
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
  };

  __nv_bfloat16* sK;  // [2][BK][D], then sV
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  size_t stride;  // elements between key positions
  int Tk;

  __device__ Bf16Tiles(const Args& a, unsigned char* smem, int b, int hk, int Tk_, int Hkv)
      : sK(reinterpret_cast<__nv_bfloat16*>(smem)),
        stride((size_t)Hkv * D),
        Tk(Tk_) {
    kb = a.k + (size_t)b * Tk * stride + (size_t)hk * D;
    vb = a.v + (size_t)b * Tk * stride + (size_t)hk * D;
  }

  __device__ __forceinline__ void load(int stage, int kt, int tid) {
    constexpr int NC = D / 8;
#pragma unroll
    for (int i = 0; i < BK * NC / kThreads; ++i) {
      const int j = (tid + i * kThreads) / NC, c = (tid + i * kThreads) % NC;
      const int t = kt + j;
      const bool in = t < Tk;
      const size_t off = (size_t)(in ? t : 0) * stride + c * 8;
      const int e = stage * BK * D + swz<D>(j, c);
      cp_async16(smem_addr(sK + e), kb + off, in);
      cp_async16(smem_addr(sK + 2 * BK * D + e), vb + off, in);
    }
  }
  __device__ __forceinline__ void convert(int, int) {}
  __device__ __forceinline__ const __nv_bfloat16* k_tile(int stage) const {
    return sK + stage * BK * D;
  }
  __device__ __forceinline__ const __nv_bfloat16* v_tile(int stage) const {
    return sK + 2 * BK * D + stage * BK * D;
  }
  __device__ __forceinline__ float k_scale(int, int) const { return 1.f; }
  __device__ __forceinline__ float v_scale(int, int) const { return 1.f; }
};

template <int D, class KV>
__global__ void __launch_bounds__(kThreads, KV::kMinBlocks)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const typename KV::Args kv_args,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, const int* __restrict__ positions,
                 const int* __restrict__ segments, int S, int Tk, int Hkv, int G, int GH,
                 int wave, float scale, int window, float softcap,
                 const int* __restrict__ kv_rows) {
  using Tl = MmaTile<D>;
  constexpr int BK = Tl::kBlockK;
  constexpr int NC = Tl::kChunks;
  constexpr int NT = BK / 8;  // n-tiles of S (8 keys each)
  constexpr int ND = D / 8;   // n-tiles of O (8 dims each)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ int seg_k[2][BK];
  __shared__ int band_lo, band_hi;

  // the cluster's blocks share one row tile and split its key tiles
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int QP = kRows / GH;  // query positions of a block
  const int n_chunks = (G + GH - 1) / GH;
  // which row tile: the grid is one axis of row tiles (clusters), ordered
  // from the latest query positions, the heaviest in a causal prefill, to
  // the earliest, across every head and batch row. The first `wave` start
  // one to an SM; a second wave of at most as many is taken in reverse, so
  // the SM that got the heaviest tile also gets the lightest
  const int q_tiles = (S + QP - 1) / QP;
  const int heads = Hkv * n_chunks;
  const int n_rows = gridDim.x / n_split;
  const int c = blockIdx.x / n_split;
  const int order = c < wave || n_rows > 2 * wave ? c : n_rows - 1 - (c - wave);
  const int per_q_tile = n_rows / q_tiles;  // head groups x batch rows
  const int q0 = (q_tiles - 1 - order / per_q_tile) * QP;
  const int rest = order % per_q_tile;
  const int b = rest / heads;
  const int hk = (rest % heads) / n_chunks;
  const int g0 = (rest % heads) % n_chunks * GH;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int wr = tid / 32;  // this warp's rows: 16 wr .. 16 wr + 15
  const int lane = tid % 32;
  const size_t q_stride = (size_t)Hq * D;  // elements between query positions
  // the K/V row: kv_rows[b] where the caller names one (a slot of a
  // multi-row cache read by a batch-1 chunk), else batch row b
  KV kv(kv_args, smem_raw + Tl::kQBytes, kv_rows != nullptr ? kv_rows[b] : b, hk, Tk, Hkv);

  // Q tile -> shared (zero rows where no row lives)
#pragma unroll
  for (int i = 0; i < kRows * NC / kThreads; ++i) {
    const int r = (tid + i * kThreads) / NC, c = (tid + i * kThreads) % NC;
    const Row row = block_row(r, q0, QP, GH, g0, G, hk, S);
    const __nv_bfloat16* src =
        row.live ? q + ((size_t)b * S + row.qi) * q_stride + (size_t)row.h * D + c * 8 : q;
    cp_async16(smem_addr(sQ + swz<D>(r, c)), src, row.live);
  }

  // this thread's two rows (mma rows lane/4 and lane/4 + 8 of its warp):
  // position p (-1 for a row that does not live: it sees nothing), segment
  // id, and the band of the live rows
  int p[2], sq[2];
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const Row row = block_row(wr * 16 + lane / 4 + 8 * rh, q0, QP, GH, g0, G, hk, S);
    p[rh] = -1;
    sq[rh] = 0;
    if (row.live) {
      p[rh] = positions != nullptr ? min(positions[(size_t)b * S + row.qi], Tk - 1) : row.qi;
      if (segments != nullptr) sq[rh] = segments[(size_t)b * S + row.qi];
      lo = min(lo, p[rh]);
      hi = max(hi, p[rh]);
    }
  }
  if (tid == 0) {
    band_lo = 0x7fffffff;
    band_hi = -0x7fffffff - 1;
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    atomicMin(&band_lo, lo);
    atomicMax(&band_hi, hi);
  }
  __syncthreads();
  const int blo = band_lo, bhi = band_hi;
  // inclusive key range of the tile loop: no live row gives an empty range;
  // a band wholly before the buffer (every p < 0) runs no tile
  int kv_lo = 0, kv_hi = bhi;
  if (segments != nullptr) {
    kv_hi = blo <= bhi ? Tk - 1 : -1;
  } else if (window > 0) {
    kv_lo = max(0, blo - window + 1);
  }
  kv_hi = min(kv_hi, Tk - 1);
  const int kt0 = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi < kt0 ? 0 : (kv_hi - kt0) / BK + 1;
  // this block's tiles: rank, rank + n_split, ...
  const int n_mine = n_tiles > rank ? (n_tiles - rank + n_split - 1) / n_split : 0;

  auto load_tile = [&](int stage, int kt) {
    kv.load(stage, kt, tid);
    if (segments != nullptr && tid < BK) {
      const int t = kt + tid;
      seg_k[stage][tid] = t < Tk ? segments[(size_t)b * S + t] : 0;
    }
  };

  auto tile_start = [&](int i) { return kt0 + (rank + n_split * i) * BK; };
  if (n_mine > 0) load_tile(0, tile_start(0));  // with Q
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q's A fragments (rows 16 wr .. +15): ldmatrix row lane % 16, chunk
  // 2 kd + lane / 16
  const int q_row = wr * 16 + (lane & 15);
  uint32_t qf[Tl::kQInRegs ? D / 16 : 1][4];
  if constexpr (Tl::kQInRegs) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldsm_x4(qf[kd], smem_addr(sQ + swz<D>(q_row, 2 * kd + (lane >> 4))));
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  // ldmatrix lanes: K (non-trans) key lane % 8 + 8 (lane / 16), chunk
  // (lane / 8) % 2; V (trans) key lane % 8 + 8 ((lane / 8) % 2), chunk
  // lane / 16
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_chunk = lane >> 4;

  for (int it = 0; it < n_mine; ++it) {
    const int kt = tile_start(it);
    const int st = it & 1;
    // tile `it` has landed for every thread, and every warp is done with
    // tile it - 1, whose stage is refilled with tile it + 1 while this one
    // is used: one barrier a tile (two where the policy converts the tile)
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_mine) {
      load_tile(st ^ 1, tile_start(it + 1));
      cp_async_commit();
    }
    if constexpr (KV::kConvert) {
      kv.convert(st, tid);
      __syncthreads();
    }
    const __nv_bfloat16* sKs = kv.k_tile(st);
    const __nv_bfloat16* sVs = kv.v_tile(st);

    // S = Q K^T, float32
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      if constexpr (Tl::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
      } else {
        ldsm_x4(a, smem_addr(sQ + swz<D>(q_row, 2 * kd + (lane >> 4))));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(sKs + swz<D>(16 * np + k_row, 2 * kd + k_chunk)));
        mma_bf16(s[2 * np], a, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }
    // a scaled policy: each key's k_scale (column n * 8 + 2 (lane % 4) + e % 2)
    if constexpr (KV::kScaled) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ks = kv.k_scale(st, n * 8 + 2 * (lane & 3) + e);
          s[n][e] *= ks;
          s[n][e + 2] *= ks;
        }
    }

    // logits in log2 units (the softcap's branch taken once a tile, not per
    // logit); the mask unless every live row sees the whole tile
    if (softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = softcap * kLog2e * tanhf(s[n][e] * cap_in);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    }
    const bool full = kt + BK - 1 <= blo && kt + BK <= Tk && (window <= 0 || kt > bhi - window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rh = e >> 1;
          const int j = n * 8 + 2 * (lane & 3) + (e & 1);
          const int t = kt + j;
          bool ok = t <= p[rh] && (window <= 0 || t > p[rh] - window);
          if (segments != nullptr) ok = ok || (sq[rh] > 0 && seg_k[st][j] == sq[rh]);
          if (!(ok && t < Tk)) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax per row; a row that has seen no key keeps m = -inf
    // and scales by 2^(x - 0) = 0 (never -inf - -inf)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rh], s[n][2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rh], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_approx(m[rh] - m_use);
      m[rh] = m_new;
      l[rh] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * rh] *= alpha;
        o[n][2 * rh + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * rh] = exp2_approx(s[n][2 * rh] - m_use);
        s[n][2 * rh + 1] = exp2_approx(s[n][2 * rh + 1] - m_use);
        l[rh] += s[n][2 * rh] + s[n][2 * rh + 1];
      }
    }
    // a scaled policy: P' = p * v_scale of each key, after l summed p
    if constexpr (KV::kScaled) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vs = kv.v_scale(st, n * 8 + 2 * (lane & 3) + e);
          s[n][e] *= vs;
          s[n][e + 2] *= vs;
        }
    }

    // O += P V with P as two bf16 A operands, hi + lo (one V fragment feeds
    // both)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_addr(sVs + swz<D>(16 * kk + v_row, 2 * dp + v_chunk)));
        mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }

  // a split row tile: each other block of the cluster leaves its (O, m, l)
  // in its own shared memory (thread for thread: the same fragment layout)
  // and the cluster's first block merges them by log-sum-exp, reading
  // them through distributed shared memory, and finishes the tile
  if (n_split > 1) {
    float* xch = reinterpret_cast<float*>(smem_raw);  // over Q and the ring
    __syncthreads();  // every warp is done with them
    if (rank > 0) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * n + e) * kThreads + tid] = o[n][e];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        xch[(4 * ND + rh) * kThreads + tid] = m[rh];
        xch[(4 * ND + 2 + rh) * kThreads + tid] = l[rh];
      }
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < n_split; ++r) {
        const float* rx = cluster.map_shared_rank(xch, r);
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float m1 = rx[(4 * ND + rh) * kThreads + tid];
          const float m_new = fmaxf(m[rh], m1);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float a0 = exp2_approx(m[rh] - m_use), a1 = exp2_approx(m1 - m_use);
          m[rh] = m_new;
          l[rh] = l[rh] * a0 + rx[(4 * ND + 2 + rh) * kThreads + tid] * a1;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[n][2 * rh] = o[n][2 * rh] * a0 + rx[(4 * n + 2 * rh) * kThreads + tid] * a1;
            o[n][2 * rh + 1] =
                o[n][2 * rh + 1] * a0 + rx[(4 * n + 2 * rh + 1) * kThreads + tid] * a1;
          }
        }
      }
    }
    cluster.sync();  // no block leaves while the first still reads its memory
    if (rank > 0) return;
  }

  // row sums across the 4 lanes of a row; normalise; stage the bf16 rows in
  // this warp's rows of the Q tile (read by no other warp), then write them
  // out 16 bytes at a time
  __syncwarp();
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
    const float inv = l[rh] > 0.f ? 1.f / l[rh] : 0.f;
    const int r = wr * 16 + lane / 4 + 8 * rh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(sQ + swz<D>(r, n) + 2 * (lane & 3)) =
          pack_bf16(o[n][2 * rh] * inv, o[n][2 * rh + 1] * inv);
    const Row row = block_row(r, q0, QP, GH, g0, G, hk, S);
    if (m_out != nullptr && row.live && (lane & 3) == 0) {
      const size_t si = ((size_t)b * Hq + row.h) * S + row.qi;  // [B, Hq, S]
      m_out[si] = m[rh] * kLn2;  // -inf stays -inf
      l_out[si] = l[rh];
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * NC; idx += 32) {
    const int r = wr * 16 + idx / NC, c = idx % NC;
    const Row row = block_row(r, q0, QP, GH, g0, G, hk, S);
    if (row.live)
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + row.qi) * q_stride + (size_t)row.h * D +
                                c * 8) = *reinterpret_cast<const uint4*>(sQ + swz<D>(r, c));
  }
}

// Dynamic shared memory of the kernel at head dim D with K/V policy KV: Q,
// then the policy's tiles; a split block's (O, m, l) [D / 2 + 4][kThreads]
// float32 reuses it after the loop.
template <int D, class KV>
constexpr size_t smem_bytes() {
  return MmaTile<D>::kQBytes + KV::kSmemBytes;
}

template <int D, class KV>
cudaError_t launch(const void* q, const typename KV::Args& kv, void* out, float* m_out,
                   float* l_out, const int* positions, const int* segments, int B, int S,
                   int Tk, int Hq, int Hkv, float scale, int window, float softcap,
                   cudaStream_t stream, const int* kv_rows = nullptr) {
  static_assert((D / 2 + 4) * kThreads * sizeof(float) <= smem_bytes<D, KV>(),
                "the merge does not fit in shared memory");
  const int G = Hq / Hkv;
  const int GH = G < kRows ? G : kRows;  // heads of one kv-head in a block
  const int QP = kRows / GH;
  const size_t smem = smem_bytes<D, KV>();
  auto kernel = flash_mma_kernel<D, KV>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // split each row tile's key tiles over a cluster of n_split blocks while
  // the row tiles alone leave SMs without a block (a continuation chunk, the
  // few tiles of a short or GQA-heavy prefill)
  const long blocks = (long)((S + QP - 1) / QP) * Hkv * ((G + GH - 1) / GH) * B;  // row tiles
  const int key_tiles = (Tk + MmaTile<D>::kBlockK - 1) / MmaTile<D>::kBlockK;
  int n_split = 1;
  while (n_split < kMaxSplit && blocks * n_split < sms && n_split < key_tiles) n_split *= 2;
  const int wave = sms / n_split;  // clusters that start one to an SM

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(blocks * n_split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q), kv,
                           static_cast<__nv_bfloat16*>(out), m_out, l_out, positions, segments,
                           S, Tk, Hkv, G, GH, wave, scale, window, softcap, kv_rows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The compiled form of an instance: info[0] registers a thread, info[1]
// local (spill) bytes a thread, info[2] shared memory bytes a block (static
// and dynamic), info[3] threads a block.
template <int D, class KV>
void attributes(int* info) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, flash_mma_kernel<D, KV>);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)(a.sharedSizeBytes + smem_bytes<D, KV>());
  info[3] = kThreads;
}

}  // namespace mma
}  // namespace crane
