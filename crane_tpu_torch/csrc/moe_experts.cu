// K8: the routed experts of a sparse-MoE layer (models/modules/transformer.py
// moe_block), over the experts the router chose and no other. For each
// token t and each of its k picks (e, w):
//   y[t] += w * down_e(act(gate_e(x_t)) * up_e(x_t)),
// with float32 sums, h = act(g) * u rounded once to the input's dtype, and
// the k weighted rows of a token summed in pick order in float32 and
// rounded once (or kept in float32 for a tensor-parallel shard's partial).
//
// Replaces no TPU kernel: crane_tpu leaves the dispatch to XLA (a dense
// one-hot product, or lax.ragged_dot), and the port ran the dense form on
// the card, every expert on every token, the combine weighing the experts
// the router did not pick by 0. K8 is added because that dense form reads
// every expert's weights on every decode step and does n / k times the
// routed operations at prefill (512 / 10 on Qwen3-Next, 64 / 4 on LFM2).
//
// What bounds it on an H100: the bytes of the distinct routed experts (3 E I
// bf16 values each), read once, at 3.35 TB/s; only from some hundreds of
// rows an expert do the 6 T k E I operations at 989 TFLOP/s take over.
// A 32-row decode step of Qwen3-Next routes to about 240 of 512 experts a
// layer: 1.51 GB, 0.45 ms; a 512-token chunk touches all of them: 3.22 GB.
//
// What the design does about it:
// - Device-side grouping, no host read (moe_group_kernel, one block): the
//   T k (token, pick) pairs are counted per expert (each warp its own run
//   of pairs), the counts scanned into each expert's range of pair slots,
//   and the pairs scattered stably into them (each warp in order, 32 at a
//   time, ranked by __match_any_sync). It also lists the work items, one
//   an (expert, row tile of BM pair slots). The other kernels' grids are
//   sized from T, k and n alone (max_items), so a CUDA graph captures the
//   layer; a block past the listed items exits at once. A shard's pairs
//   outside [offset, offset + n) get no slot and add 0.
// - Gate|up with the activation fused (kGateUp): a block takes one work
//   item and a 64-column tile of I, gathers its pairs' x rows by token and
//   streams the expert's gate and up columns through a 4-stage cp.async
//   ring in shared memory, 64 rows of the reduction a stage; mma.sync
//   m16n8k16 bf16 products with float32 sums (K6's tile loop,
//   quant_matmul_mma.cu, with bf16 weights staged as they are stored);
//   it writes act(g) u as bf16 h[slot, I]. Each routed expert's weights are
//   read once for each row tile, and the row tile (16, 32 or 64 rows) grows
//   with the rows an expert gets (the wrapper's row_tile: 16 at decode, so
//   every expert's pairs fit one tile).
// - Down with the weight (kGateUp false): the same items over h, 128
//   columns of E a block; the epilogue scales each row by its pair's
//   weight and writes it in float32 to the pair's own row (t k + j). The
//   combine (moe_combine_kernel) sums a token's k rows in pick order. No
//   float atomics: a graph replay and its eager step give the same bits.
// - Where the grid leaves SMs without a block (a decode step of one row),
//   a thread-block cluster of 2-4 blocks shares an item's tile and splits
//   the reduction as K6 does (distributed shared memory, no scratch).
// - float32 inputs (the checks against the CPU) take a CUDA-core form of
//   the same two kernels (moe_expert_f32_kernel), 16-row items.
// The wrapper (ops/cuda/moe.py) requires E and I to be multiples of 8, so
// every 16-byte copy is whole and aligned.
#include "flash_attention_mma.cuh"

namespace crane {
namespace {

using namespace mma;

constexpr int kBK = 64;         // reduction rows of a stage
constexpr int kStages = 4;      // the cp.async ring
constexpr int kMaxSplitK = 4;   // blocks of a cluster sharing one tile
constexpr int kGateUpCols = 64;  // columns of I a gate|up block owns (of gate and of up)
constexpr int kDownCols = 128;   // columns of E a down block owns
constexpr int kGroupWarps = 8;
constexpr int kGroupThreads = 32 * kGroupWarps;

// the activations of ops/cuda/moe.py ACTS
enum Act : int { kSilu = 0, kGeluTanh = 1 };

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + __expf(-g));
}

// Shared memory of the grouping: per-warp counts (then cursors) [W][n], the
// experts' pair and tile counts [n] each, the scan's partial sums [2][threads].
inline size_t group_smem_bytes(int n) {
  return sizeof(int) * ((size_t)kGroupWarps * n + 2 * (size_t)n + 2 * kGroupThreads);
}

// sel [P] the router's picks (row-major [T, k], int64). Writes order[slot]
// = the pair (t k + j) in that slot, pairs grouped by expert and in pair
// order within an expert; start[e] the first slot of local expert e and
// start[n] the pairs routed to this shard; items[2 i], items[2 i + 1] the
// expert and first slot of work item i, in expert order, BM slots an item;
// n_items[0] their number.
__global__ void __launch_bounds__(kGroupThreads)
moe_group_kernel(const int64_t* __restrict__ sel, int P, int n, int offset, int bm,
                 int* __restrict__ order, int* __restrict__ start, int* __restrict__ items,
                 int* __restrict__ n_items) {
  extern __shared__ int gsm[];
  int* cnt = gsm;                      // [kGroupWarps][n]
  int* tot = cnt + kGroupWarps * n;    // [n]
  int* tiles = tot + n;                // [n]
  int* part = tiles + n;               // [2][kGroupThreads]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kGroupWarps * n; i += kGroupThreads) cnt[i] = 0;
  __syncthreads();
  const int chunk = (P + kGroupWarps - 1) / kGroupWarps;
  const int p0 = min(P, warp * chunk), p1 = min(P, warp * chunk + chunk);
  for (int p = p0 + lane; p < p1; p += 32) {
    const long long e = sel[p] - offset;
    if (e >= 0 && e < n) atomicAdd(&cnt[warp * n + (int)e], 1);
  }
  __syncthreads();
  // each expert's pairs, and each warp's first place among them
  for (int e = tid; e < n; e += kGroupThreads) {
    int s = 0;
    for (int w = 0; w < kGroupWarps; ++w) {
      const int c = cnt[w * n + e];
      cnt[w * n + e] = s;
      s += c;
    }
    tot[e] = s;
    tiles[e] = (s + bm - 1) / bm;
  }
  __syncthreads();
  // exclusive scans of the pair and tile counts: thread t owns a run of
  // `per` experts, the runs' sums scanned over the threads
  const int per = (n + kGroupThreads - 1) / kGroupThreads;
  const int e0 = min(n, tid * per), e1 = min(n, tid * per + per);
  int sp = 0, st = 0;
  for (int e = e0; e < e1; ++e) {
    sp += tot[e];
    st += tiles[e];
  }
  part[tid] = sp;
  part[kGroupThreads + tid] = st;
  __syncthreads();
  for (int d = 1; d < kGroupThreads; d <<= 1) {
    const int a = tid >= d ? part[tid - d] : 0;
    const int b = tid >= d ? part[kGroupThreads + tid - d] : 0;
    __syncthreads();
    part[tid] += a;
    part[kGroupThreads + tid] += b;
    __syncthreads();
  }
  int run_p = part[tid] - sp, run_t = part[kGroupThreads + tid] - st;
  for (int e = e0; e < e1; ++e) {
    start[e] = run_p;
    for (int w = 0; w < kGroupWarps; ++w) cnt[w * n + e] += run_p;
    for (int i = 0; i < tiles[e]; ++i) {
      items[2 * (run_t + i)] = e;
      items[2 * (run_t + i) + 1] = run_p + i * bm;
    }
    run_p += tot[e];
    run_t += tiles[e];
  }
  if (tid == kGroupThreads - 1) {
    start[n] = part[tid];
    n_items[0] = part[kGroupThreads + tid];
  }
  __syncthreads();
  // the stable scatter: a warp places its run of pairs in order, 32 at a
  // time; lanes of one expert take consecutive slots by lane
  for (int b = p0; b < p1; b += 32) {
    const int p = b + lane;
    const long long e = p < p1 ? sel[p] - offset : -1;
    const int key = e >= 0 && e < n ? (int)e : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key >= 0) order[cnt[warp * n + key] + __popc(same & ((1u << lane) - 1u))] = p;
    __syncwarp();
    if (key >= 0 && lane == __ffs(same) - 1) cnt[warp * n + key] += __popc(same);
    __syncwarp();
  }
}

template <int BM, int BN, bool kGateUp>
struct ExpertTile {
  static constexpr int kMats = kGateUp ? 2 : 1;  // weight matrices a block streams
  static constexpr int kWarpsM = BM >= 32 ? 2 : 1, kWarpsN = kWarps / kWarpsM;
  static constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;  // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr size_t kABytes = sizeof(__nv_bfloat16) * BM * kBK;
  static constexpr size_t kBBytes = sizeof(__nv_bfloat16) * kMats * kBK * BN;
  static constexpr size_t kStageBytes = kABytes + kBBytes;
  static constexpr size_t kRingBytes = kStages * kStageBytes;
  static constexpr size_t kAccBytes = sizeof(float) * kMats * MT * NT * 4 * kThreads;
  static constexpr size_t kSmemBytes = 4 * sizeof(int) * BM + (kRingBytes > kAccBytes ? kRingBytes : kAccBytes);
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  static_assert(BM * (kBK / 8) % kThreads == 0 && kBK * (BN / 8) % kThreads == 0,
                "a stage's chunks must split over the threads");
};

// One work item's tile (kGateUp: h = act(x W_gate) * (x W_up) for a column
// tile of I; else the pair rows w * (h W_down) for a column tile of E).
// a: gate|up x [T, K]; down h [slots, K]. b0, b1: gate, up [n, K, N] (down:
// b0 [n, K, N]). out: gate|up h [slots, N] bf16; down rows [T k, N] float32.
template <int BM, int BN, bool kGateUp>
__global__ void __launch_bounds__(kThreads)
moe_expert_mma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b0,
                      const __nv_bfloat16* __restrict__ b1, const int* __restrict__ order,
                      const int* __restrict__ start, const int* __restrict__ items,
                      const int* __restrict__ n_items, const float* __restrict__ w,
                      void* __restrict__ out, int K, int N, int k, int act) {
  using Tl = ExpertTile<BM, BN, kGateUp>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / n_split;
  if (item >= n_items[0]) return;  // the whole cluster: one item
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* rows_src = reinterpret_cast<int*>(smem_raw);  // [BM] a's row, -1 past the item
  int* rows_pair = rows_src + BM;                    // [BM] the pair (t k + j)
  unsigned char* ring = smem_raw + 4 * sizeof(int) * BM;
  const int e = items[2 * item], r0 = items[2 * item + 1];
  const int r1 = min(start[e + 1], r0 + BM);
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / Tl::kWarpsN, wn = warp % Tl::kWarpsN;
  if (tid < BM) {
    const int s = r0 + tid;
    const int p = s < r1 ? order[s] : -1;
    rows_pair[tid] = p;
    rows_src[tid] = p < 0 ? -1 : kGateUp ? p / k : s;
  }
  __syncthreads();
  const __nv_bfloat16* w0 = b0 + (size_t)e * K * N;
  const __nv_bfloat16* w1 = (kGateUp ? b1 : b0) + (size_t)e * K * N;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int n_k = k_tiles > rank ? (k_tiles - rank + n_split - 1) / n_split : 0;

  auto load = [&](int stage, int it) {
    const int k0 = (rank + it * n_split) * kBK;
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(ring + (size_t)stage * Tl::kStageBytes);
    __nv_bfloat16* bs = as + BM * kBK;
#pragma unroll
    for (int i = 0; i < BM * (kBK / 8) / kThreads; ++i) {
      const int r = (tid + i * kThreads) / (kBK / 8), c = (tid + i * kThreads) % (kBK / 8);
      const int src = rows_src[r];
      const bool in = src >= 0 && k0 + c * 8 < K;
      cp_async16(smem_addr(as + swz<kBK>(r, c)), in ? a + (size_t)src * K + k0 + c * 8 : a, in);
    }
#pragma unroll
    for (int m = 0; m < Tl::kMats; ++m) {
      const __nv_bfloat16* wm_ = m == 0 ? w0 : w1;
#pragma unroll
      for (int i = 0; i < kBK * (BN / 8) / kThreads; ++i) {
        const int j = (tid + i * kThreads) / (BN / 8), c = (tid + i * kThreads) % (BN / 8);
        const bool in = k0 + j < K && n0 + c * 8 < N;
        cp_async16(smem_addr(bs + m * kBK * BN + swz<BN>(j, c)),
                   in ? wm_ + (size_t)(k0 + j) * N + n0 + c * 8 : wm_, in);
      }
    }
  };

  float acc[Tl::kMats][Tl::MT][Tl::NT][4];
#pragma unroll
  for (int m = 0; m < Tl::kMats; ++m)
#pragma unroll
    for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt)
        acc[m][mt][nt][0] = acc[m][mt][nt][1] = acc[m][mt][nt][2] = acc[m][mt][nt][3] = 0.f;
  // ldmatrix lanes as K6's: A row lane % 16, chunk 2 kd + lane / 16; B
  // (trans) k row lane % 8 + 8 ((lane / 8) % 2), chunk lane / 16
  const int a_row = wm * Tl::WM + (lane & 15);
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_chunk = wn * (Tl::WN / 8) + (lane >> 4);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();  // one group a stage, empty or not
  }
  for (int kt = 0; kt < n_k; ++kt) {
    // stage kt has landed, and every warp is done with stage kt - 1, whose
    // slot is refilled now
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < n_k) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* as =
        reinterpret_cast<const __nv_bfloat16*>(ring + (size_t)(kt % kStages) * Tl::kStageBytes);
    const __nv_bfloat16* bs = as + BM * kBK;
#pragma unroll
    for (int kd = 0; kd < kBK / 16; ++kd) {
      uint32_t af[Tl::MT][4];
#pragma unroll
      for (int mt = 0; mt < Tl::MT; ++mt)
        ldsm_x4(af[mt], smem_addr(as + swz<kBK>(a_row + mt * 16, 2 * kd + (lane >> 4))));
#pragma unroll
      for (int m = 0; m < Tl::kMats; ++m)
#pragma unroll
        for (int np = 0; np < Tl::NT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(bs + m * kBK * BN + swz<BN>(16 * kd + b_row, b_chunk + 2 * np)));
#pragma unroll
          for (int mt = 0; mt < Tl::MT; ++mt) {
            mma_bf16(acc[m][mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16(acc[m][mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // a split tile: the cluster's other blocks leave their accumulators in
  // their own shared memory, and its first block adds them in rank order
  if (n_split > 1) {
    float* xch = reinterpret_cast<float*>(ring);
    __syncthreads();  // every warp is done with the ring
    if (rank > 0) {
#pragma unroll
      for (int m = 0; m < Tl::kMats; ++m)
#pragma unroll
        for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              xch[(((m * Tl::MT + mt) * Tl::NT + nt) * 4 + q) * kThreads + tid] = acc[m][mt][nt][q];
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < n_split; ++r) {
        const float* rx = cluster.map_shared_rank(xch, r);
#pragma unroll
        for (int m = 0; m < Tl::kMats; ++m)
#pragma unroll
          for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[m][mt][nt][q] += rx[(((m * Tl::MT + mt) * Tl::NT + nt) * 4 + q) * kThreads + tid];
      }
    }
    cluster.sync();  // no block leaves while the first still reads its memory
    if (rank > 0) return;
  }

  // rows lane / 4 and lane / 4 + 8 of each m-tile, columns 2 (lane % 4)
  // and + 1 of each n-tile (N % 8 == 0: col + 1 < N with col)
#pragma unroll
  for (int nt = 0; nt < Tl::NT; ++nt) {
    const int col = n0 + wn * Tl::WN + nt * 8 + 2 * (lane & 3);
    if (col >= N) continue;
#pragma unroll
    for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = wm * Tl::WM + mt * 16 + lane / 4 + 8 * rh;
        const int p = rows_pair[r];
        if (p < 0) continue;
        if constexpr (kGateUp) {
          const float h0 = activate(acc[0][mt][nt][2 * rh], act) * acc[1][mt][nt][2 * rh];
          const float h1 = activate(acc[0][mt][nt][2 * rh + 1], act) * acc[1][mt][nt][2 * rh + 1];
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + (size_t)(r0 + r) * N + col) =
              pack_bf16(h0, h1);
        } else {
          const float wp = w[p];
          *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)p * N + col) =
              make_float2(acc[0][mt][nt][2 * rh] * wp, acc[0][mt][nt][2 * rh + 1] * wp);
        }
      }
  }
}

// The float32 form (CUDA cores): 16-row items, 64 columns a block, the
// reduction in 32-row steps; each thread one row and four columns.
constexpr int kF32Rows = 16, kF32Cols = 64, kF32K = 32, kF32Threads = 256;

template <bool kGateUp>
__global__ void __launch_bounds__(kF32Threads)
moe_expert_f32_kernel(const float* __restrict__ a, const float* __restrict__ b0,
                      const float* __restrict__ b1, const int* __restrict__ order,
                      const int* __restrict__ start, const int* __restrict__ items,
                      const int* __restrict__ n_items, const float* __restrict__ w,
                      float* __restrict__ out, int K, int N, int k, int act) {
  constexpr int kMats = kGateUp ? 2 : 1;
  __shared__ float sA[kF32Rows][kF32K + 1];
  __shared__ float sB[kMats][kF32K][kF32Cols];
  __shared__ int rows_src[kF32Rows], rows_pair[kF32Rows];
  const int item = blockIdx.x;
  if (item >= n_items[0]) return;
  const int e = items[2 * item], r0 = items[2 * item + 1];
  const int r1 = min(start[e + 1], r0 + kF32Rows);
  const int n0 = blockIdx.y * kF32Cols;
  const int tid = threadIdx.x;
  if (tid < kF32Rows) {
    const int s = r0 + tid;
    const int p = s < r1 ? order[s] : -1;
    rows_pair[tid] = p;
    rows_src[tid] = p < 0 ? -1 : kGateUp ? p / k : s;
  }
  __syncthreads();
  const float* w0 = b0 + (size_t)e * K * N;
  const float* w1 = (kGateUp ? b1 : b0) + (size_t)e * K * N;
  const int r = tid / (kF32Cols / 4), c = (tid % (kF32Cols / 4)) * 4;
  float acc[kMats][4] = {};
  for (int k0 = 0; k0 < K; k0 += kF32K) {
    for (int i = tid; i < kF32Rows * kF32K; i += kF32Threads) {
      const int rr = i / kF32K, kk = i % kF32K;
      const int src = rows_src[rr];
      sA[rr][kk] = src >= 0 && k0 + kk < K ? a[(size_t)src * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      const float* wm_ = m == 0 ? w0 : w1;
      for (int i = tid; i < kF32K * kF32Cols; i += kF32Threads) {
        const int kk = i / kF32Cols, cc = i % kF32Cols;
        sB[m][kk][cc] = k0 + kk < K && n0 + cc < N ? wm_[(size_t)(k0 + kk) * N + n0 + cc] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32K; ++kk) {
      const float av = sA[r][kk];
#pragma unroll
      for (int m = 0; m < kMats; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(av, sB[m][kk][c + q], acc[m][q]);
    }
    __syncthreads();
  }
  const int p = rows_pair[r];
  if (p < 0) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = n0 + c + q;
    if (col >= N) continue;
    if constexpr (kGateUp)
      out[(size_t)(r0 + r) * N + col] = activate(acc[0][q], act) * acc[1][q];
    else
      out[(size_t)p * N + col] = acc[0][q] * w[p];
  }
}

// y[t, c] = sum over j in pick order of rows[t k + j, c], the picks of
// this shard only, in float32, rounded once to T. Four columns a thread.
template <typename T>
__global__ void moe_combine_kernel(const float* __restrict__ rows, const int64_t* __restrict__ sel,
                                   int k, int n, int offset, int N, T* __restrict__ y) {
  const int t = blockIdx.y;
  const int c = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= N) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < k; ++j) {
    const long long p = (long long)t * k + j;
    const long long e = sel[p] - offset;
    if (e < 0 || e >= n) continue;
    const float4 v = *reinterpret_cast<const float4*>(rows + p * N + c);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  T* o = y + (size_t)t * N + c;
  o[0] = from_float<T>(s.x);
  o[1] = from_float<T>(s.y);
  o[2] = from_float<T>(s.z);
  o[3] = from_float<T>(s.w);
}

// blocks of a cluster sharing one tile: doubled while the grid leaves SMs
// without a block and each block keeps two reduction tiles (as K6)
inline int split_count(long blocks, int K, int sms) {
  const int k_tiles = (K + kBK - 1) / kBK;
  int n_split = 1;
  while (n_split < kMaxSplitK && blocks * n_split < sms && 2 * (2 * n_split) <= k_tiles)
    n_split *= 2;
  return n_split;
}

template <int BM, int BN, bool kGateUp>
cudaError_t launch_mma(int max_items, const void* a, const void* b0, const void* b1,
                       const int* order, const int* start, const int* items, const int* n_items,
                       const float* w, void* out, int K, int N, int k, int act,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  auto kernel = moe_expert_mma_kernel<BM, BN, kGateUp>;
  const size_t smem = ExpertTile<BM, BN, kGateUp>::kSmemBytes;
  allow_dynamic_smem_once(kernel, smem, smem_set);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int col_tiles = (N + BN - 1) / BN;
  const int n_split = split_count((long)max_items * col_tiles, K, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(max_items * n_split), (unsigned)col_tiles);
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(a),
                           static_cast<const __nv_bfloat16*>(b0),
                           static_cast<const __nv_bfloat16*>(b1), order, start, items, n_items, w,
                           out, K, N, k, act);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kGateUp>
cudaError_t dispatch_mma(int bm, int max_items, const void* a, const void* b0, const void* b1,
                         const int* order, const int* start, const int* items,
                         const int* n_items, const float* w, void* out, int K, int N, int k,
                         int act, cudaStream_t stream) {
  constexpr int BN = kGateUp ? kGateUpCols : kDownCols;
  switch (bm) {
    case 16:
      return launch_mma<16, BN, kGateUp>(max_items, a, b0, b1, order, start, items, n_items, w,
                                         out, K, N, k, act, stream);
    case 32:
      return launch_mma<32, BN, kGateUp>(max_items, a, b0, b1, order, start, items, n_items, w,
                                         out, K, N, k, act, stream);
    case 64:
      return launch_mma<64, BN, kGateUp>(max_items, a, b0, b1, order, start, items, n_items, w,
                                         out, K, N, k, act, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kGateUp>
cudaError_t launch_f32(int bm, int max_items, const void* a, const void* b0, const void* b1,
                       const int* order, const int* start, const int* items, const int* n_items,
                       const float* w, void* out, int K, int N, int k, int act,
                       cudaStream_t stream) {
  if (bm != kF32Rows) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)max_items, (unsigned)((N + kF32Cols - 1) / kF32Cols));
  moe_expert_f32_kernel<kGateUp><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b0),
      static_cast<const float*>(b1), order, start, items, n_items, w, static_cast<float*>(out),
      K, N, k, act);
  return cudaGetLastError();
}

template <int BM, int BN, bool kGateUp>
void mma_attributes(int* info) {
  cudaFuncAttributes at{};
  cudaFuncGetAttributes(&at, moe_expert_mma_kernel<BM, BN, kGateUp>);
  info[0] = at.numRegs;
  info[1] = (int)at.localSizeBytes;
  info[2] = (int)(at.sharedSizeBytes + ExpertTile<BM, BN, kGateUp>::kSmemBytes);
  info[3] = kThreads;
  info[4] = BM;
  info[5] = BN;
}

}  // namespace
}  // namespace crane

// The grouping (moe_group_kernel): sel [P] int64 picks, n local experts from
// `offset`, work items of `bm` slots; order [P], start [n + 1], items
// [2 max_items], n_items [1] int32. Returns the CUDA error of the launch.
extern "C" int crane_moe_group(const void* sel, int P, int n, int offset, int bm, void* order,
                               void* start, void* items, void* n_items, void* stream) {
  using namespace crane;
  static std::atomic<uint64_t> smem_set{0};
  if (P <= 0 || n <= 0 || bm <= 0) return cudaErrorInvalidValue;
  const size_t smem = group_smem_bytes(n);
  allow_dynamic_smem_once(moe_group_kernel, smem, smem_set);
  moe_group_kernel<<<1, kGroupThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sel), P, n, offset, bm, static_cast<int*>(order),
      static_cast<int*>(start), static_cast<int*>(items), static_cast<int*>(n_items));
  return cudaGetLastError();
}

// Gate|up with the activation: x [T, E], gate and up [n, E, I] in `dtype`
// (0 float32, 1 bfloat16); h [slots, I] in the same dtype. `bm` is the row
// tile the grouping used (bf16 16, 32 or 64; float32 16), `max_items` the
// grid's items, `act` an Act.
extern "C" int crane_moe_gate_up(int dtype, int bm, int max_items, const void* x,
                                 const void* gate, const void* up, const void* order,
                                 const void* start, const void* items, const void* n_items,
                                 void* h, int E, int I, int k, int act, void* stream) {
  using namespace crane;
  if (max_items <= 0 || E % 8 || I % 8) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto st = static_cast<const int*>(start);
  auto it = static_cast<const int*>(items);
  auto ni = static_cast<const int*>(n_items);
  if (dtype == kBFloat16)
    return dispatch_mma<true>(bm, max_items, x, gate, up, o, st, it, ni, nullptr, h, E, I, k,
                              act, s);
  if (dtype == kFloat32)
    return launch_f32<true>(bm, max_items, x, gate, up, o, st, it, ni, nullptr, h, E, I, k, act,
                            s);
  return cudaErrorInvalidValue;
}

// Down, weighted, then the combine: h [slots, I] and down [n, I, E] in
// `dtype`; w [T k] float32 and sel [T k] int64 the picks; rows [T k, E]
// float32 scratch; y [T, E] in `out_dtype`.
extern "C" int crane_moe_down(int dtype, int out_dtype, int bm, int max_items, const void* h,
                              const void* down, const void* order, const void* start,
                              const void* items, const void* n_items, const void* w,
                              const void* sel, void* rows, void* y, int T, int I, int E, int k,
                              int n, int offset, void* stream) {
  using namespace crane;
  if (max_items <= 0 || E % 8 || I % 8) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto st = static_cast<const int*>(start);
  auto it = static_cast<const int*>(items);
  auto ni = static_cast<const int*>(n_items);
  auto wf = static_cast<const float*>(w);
  cudaError_t err;
  if (dtype == kBFloat16)
    err = dispatch_mma<false>(bm, max_items, h, down, down, o, st, it, ni, wf, rows, I, E, k,
                              kSilu, s);
  else if (dtype == kFloat32)
    err = launch_f32<false>(bm, max_items, h, down, down, o, st, it, ni, wf, rows, I, E, k,
                            kSilu, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((E / 4 + 127) / 128), (unsigned)T);
  auto r = static_cast<const float*>(rows);
  auto sl = static_cast<const int64_t*>(sel);
  if (out_dtype == kBFloat16)
    moe_combine_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(r, sl, k, n, offset, E,
                                                           static_cast<__nv_bfloat16*>(y));
  else if (out_dtype == kFloat32)
    moe_combine_kernel<float><<<grid, 128, 0, s>>>(r, sl, k, n, offset, E, static_cast<float*>(y));
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The compiled bf16 form of the gate|up (`gate_up` 1) or down (0) kernel at
// row tile `bm` (16, 32, 64): info[0] registers a thread, info[1] local
// (spill) bytes a thread, info[2] shared memory bytes a block, info[3]
// threads a block, info[4] and info[5] the tile's rows and columns.
extern "C" int crane_moe_experts_info(int gate_up, int bm, int* info) {
  using namespace crane;
  switch (bm) {
    case 16:
      gate_up ? mma_attributes<16, kGateUpCols, true>(info)
              : mma_attributes<16, kDownCols, false>(info);
      break;
    case 32:
      gate_up ? mma_attributes<32, kGateUpCols, true>(info)
              : mma_attributes<32, kDownCols, false>(info);
      break;
    case 64:
      gate_up ? mma_attributes<64, kGateUpCols, true>(info)
              : mma_attributes<64, kDownCols, false>(info);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
