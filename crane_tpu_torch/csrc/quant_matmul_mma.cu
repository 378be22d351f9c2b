// K6 in bfloat16 on the tensor cores, for M >= kMmaMinM rows
// (quant_matmul.cu): y[m, o] = (sum_i x[m, i] * code[i, o]) * scales[o].
//
// Replaces, for bfloat16 activations from 4 rows on, crane_tpu/ops/pallas/
// quant_matmul.py::quant_matmul (kernels _kernel_w8 and _kernel_w4).
// crane_quant_matmul (quant_matmul.cu) routes here by dtype and M; float32
// and M < kMmaMinM (decode at batch 1 to 3) keep the CUDA-core kernel.
//
// What it computes is quant_matmul.cu's contract: the sum in float32 and
// one scale at the end. The int8 codes and the int4 codes are exact in
// bf16, and a bf16 x times a bf16 code is exact in float32, so feeding the
// tensor cores changes only the order of the float32 sums.
//
// What bounds it on an H100: at M = 256 the 2 M I O operations (1.6 GFLOP
// for a 256-token chunk's q/k/v/o/gate/up/down), which belong on the bf16
// tensor cores; then the code bytes, read once from device memory.
//
// What the design does about it:
// - A block owns a BM x BN output tile (64 x 128, 64 x 64 or 32 x 64, the
//   largest that still gives every SM a block: a 256-row chunk has 32
//   64 x 128 tiles at O = 1024). 4 warps, 2 x 2, each a (BM / 2) x (BN / 2)
//   tile of mma.sync.m16n8k16 bf16 products with float32 accumulators.
// - Where the output tiles alone leave SMs without a block (16 32 x 64
//   tiles at M = 16, O = 1024), a thread-block cluster of 2-8 blocks shares
//   a tile and splits I: block r runs k-tiles r, r + n, ..., and the
//   cluster's first block adds the others' accumulators, reading them from
//   their shared memory (distributed shared memory), and writes the tile.
//   No scratch in device memory, no second pass (as K2/K3 split keys).
// - A stage is 64 code rows as stored (int8, or packed int4 never widened
//   in device memory) and x's matching 64 columns (for int4 both halves:
//   byte row i pairs its low code with x[:, i] and its high code with
//   x[:, i + I/2], so one staged byte tile feeds two 64-deep k-steps), copied
//   with 16-byte cp.async into a 3-stage ring of dynamic shared memory.
//   Each stage's codes are converted once into a swizzled bf16 B tile
//   (flash_attention_mma.cuh unpack16) that every warp reads.
// - A comes from x's tile through ldmatrix, B from the code tile through
//   ldmatrix.trans; rows are XOR-swizzled by 16-byte chunk so both are free
//   of bank conflicts. Rows of x past M and code rows past I/2 (or I) are
//   zero-filled.
// - The epilogue multiplies by the column's scale and writes bf16 pairs.
// Routed here only where the 16-byte copies are aligned: I/2 (int4) or I
// (int8) a multiple of 8, O a multiple of 16, x and the codes on 16-byte
// boundaries; other shapes take the CUDA-core kernel.
#include "flash_attention_mma.cuh"

namespace crane {
namespace {

using namespace mma;

constexpr int kBK = 64;       // code rows (and x columns) of a stage
constexpr int kStages = 3;    // the cp.async ring
constexpr int kMaxSplitK = 8;  // blocks of a cluster sharing one output tile

template <int BM, int BN, bool kW4>
struct MatmulTile {
  static constexpr int H = kW4 ? 2 : 1;  // k-halves a code row feeds
  static constexpr int WM = BM / 2, WN = BN / 2;  // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr size_t kXBytes = sizeof(__nv_bfloat16) * H * BM * kBK;  // a stage of x
  static constexpr size_t kCodeBytes = (size_t)kBK * BN;                  // a stage of codes
  static constexpr size_t kBBytes = sizeof(__nv_bfloat16) * H * kBK * BN;
  static constexpr size_t kSmemBytes = kStages * (kXBytes + kCodeBytes) + kBBytes;
  static_assert(BM * (kBK / 8) % kThreads == 0 && kBK * (BN / 16) % kThreads == 0,
                "a stage's chunks must split over the threads");
  static_assert(sizeof(float) * MT * NT * 4 * kThreads <= kSmemBytes,
                "a split block's accumulators do not fit in shared memory");
};

template <int BM, int BN, bool kW4>
__global__ void __launch_bounds__(kThreads)
quant_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                        const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
                        int M, int I, int O) {
  using Tl = MatmulTile<BM, BN, kW4>;
  constexpr int H = Tl::H;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][H][BM][kBK]
  int8_t* sC = reinterpret_cast<int8_t*>(smem_raw + kStages * Tl::kXBytes);  // [stage][kBK][BN]
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + kStages * (Tl::kXBytes + Tl::kCodeBytes));  // [H][kBK][BN]

  // the cluster's blocks share one output tile and split its k-tiles
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Ip = kW4 ? I / 2 : I;  // code rows
  const int o0 = (blockIdx.x / n_split) * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int k_tiles = (Ip + kBK - 1) / kBK;
  // this block's k-tiles: rank, rank + n_split, ...
  const int n_k = k_tiles > rank ? (k_tiles - rank + n_split - 1) / n_split : 0;

  auto load = [&](int stage, int it) {
    const int i0 = (rank + it * n_split) * kBK;
    __nv_bfloat16* xs = sX + (size_t)stage * H * BM * kBK;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < BM * (kBK / 8) / kThreads; ++i) {
        const int r = (tid + i * kThreads) / (kBK / 8), c = (tid + i * kThreads) % (kBK / 8);
        const bool in = m0 + r < M && i0 + c * 8 < Ip;
        const __nv_bfloat16* src = in ? x + (size_t)(m0 + r) * I + h * Ip + i0 + c * 8 : x;
        cp_async16(smem_addr(xs + h * BM * kBK + swz<kBK>(r, c)), src, in);
      }
    int8_t* cs = sC + (size_t)stage * kBK * BN;
#pragma unroll
    for (int i = 0; i < kBK * (BN / 16) / kThreads; ++i) {
      const int j = (tid + i * kThreads) / (BN / 16), c = (tid + i * kThreads) % (BN / 16);
      const bool in = i0 + j < Ip && o0 + c * 16 < O;
      const int8_t* src = in ? codes + (size_t)(i0 + j) * O + o0 + c * 16 : codes;
      cp_async16(smem_addr(cs + j * BN + c * 16), src, in);
    }
  };

  float acc[Tl::MT][Tl::NT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tl::NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;
  // ldmatrix lanes: A row lane % 16, chunk 2 kd + lane / 16; B (trans) k row
  // lane % 8 + 8 ((lane / 8) % 2), chunk lane / 16 (as K3's V)
  const int a_row = wm * Tl::WM + (lane & 15);
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_chunk = wn * (Tl::WN / 8) + (lane >> 4);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();  // one group a stage, empty or not
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % kStages;
    // stage kt has landed, and every warp is done with stage kt - 1 (its
    // slot is refilled now) and with the B tile (converted anew below)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < n_k) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const int8_t* cs = sC + (size_t)st * kBK * BN;
#pragma unroll
    for (int i = 0; i < kBK * (BN / 16) / kThreads; ++i) {
      const int j = (tid + i * kThreads) / (BN / 16), c = (tid + i * kThreads) % (BN / 16);
      unpack16<BN, kW4 ? 4 : 8>(cs + j * BN + c * 16, sB, 2 * c, sB + kBK * BN, 2 * c, j);
    }
    __syncthreads();

    const __nv_bfloat16* xs = sX + (size_t)st * H * BM * kBK;
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int kd = 0; kd < kBK / 16; ++kd) {
        uint32_t a[Tl::MT][4];
#pragma unroll
        for (int mt = 0; mt < Tl::MT; ++mt)
          ldsm_x4(a[mt], smem_addr(xs + h * BM * kBK +
                                   swz<kBK>(a_row + mt * 16, 2 * kd + (lane >> 4))));
#pragma unroll
        for (int np = 0; np < Tl::NT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_addr(sB + h * kBK * BN +
                                      swz<BN>(16 * kd + b_row, b_chunk + 2 * np)));
#pragma unroll
          for (int mt = 0; mt < Tl::MT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // a split tile: each other block of the cluster leaves its accumulators
  // in its own shared memory (thread for thread: the same fragment layout)
  // and the cluster's first block adds them, reading them through
  // distributed shared memory, and finishes the tile
  if (n_split > 1) {
    float* xch = reinterpret_cast<float*>(smem_raw);
    __syncthreads();  // every warp is done with the ring
    if (rank > 0) {
#pragma unroll
      for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) xch[((mt * Tl::NT + nt) * 4 + e) * kThreads + tid] =
              acc[mt][nt][e];
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < n_split; ++r) {
        const float* rx = cluster.map_shared_rank(xch, r);
#pragma unroll
        for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] += rx[((mt * Tl::NT + nt) * 4 + e) * kThreads + tid];
      }
    }
    cluster.sync();  // no block leaves while the first still reads its memory
    if (rank > 0) return;
  }

  // y = acc * scale, rows lane / 4 and lane / 4 + 8 of each m-tile, columns
  // 2 (lane % 4) and + 1 of each n-tile
#pragma unroll
  for (int nt = 0; nt < Tl::NT; ++nt) {
    const int col = o0 + wn * Tl::WN + nt * 8 + 2 * (lane & 3);
    if (col >= O) continue;  // O % 16 == 0: col + 1 < O with col
    const float s0 = scales[col], s1 = scales[col + 1];
#pragma unroll
    for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = m0 + wm * Tl::WM + mt * 16 + lane / 4 + 8 * rh;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * O + col) =
              pack_bf16(acc[mt][nt][2 * rh] * s0, acc[mt][nt][2 * rh + 1] * s1);
      }
  }
}

template <int BM, int BN, bool kW4>
cudaError_t launch_mma(int sms, const void* x, const int8_t* codes, const float* scales,
                       void* out, int M, int I, int O, cudaStream_t stream) {
  auto kernel = quant_matmul_mma_kernel<BM, BN, kW4>;
  const size_t smem = MatmulTile<BM, BN, kW4>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // split each output tile's k-tiles over a cluster of n_split blocks while
  // the tiles alone leave SMs without a block, keeping two k-tiles a block
  const long tiles = (long)((O + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int k_tiles = ((kW4 ? I / 2 : I) + kBK - 1) / kBK;
  int n_split = 1;
  while (n_split < kMaxSplitK && tiles * n_split < sms && 2 * (2 * n_split) <= k_tiles)
    n_split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((O + BN - 1) / BN * n_split), (unsigned)((M + BM - 1) / BM));
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x), codes, scales,
                           static_cast<__nv_bfloat16*>(out), M, I, O);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the output tiles, largest first
constexpr int kTiles[3][2] = {{64, 128}, {64, 64}, {32, 64}};

template <bool kW4>
cudaError_t dispatch_mma(int tile, int sms, const void* x, const int8_t* codes,
                         const float* scales, void* out, int M, int I, int O,
                         cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch_mma<64, 128, kW4>(sms, x, codes, scales, out, M, I, O, stream);
    case 1:
      return launch_mma<64, 64, kW4>(sms, x, codes, scales, out, M, I, O, stream);
    default:
      return launch_mma<32, 64, kW4>(sms, x, codes, scales, out, M, I, O, stream);
  }
}

template <int BM, int BN, bool kW4>
void mma_attributes(int* info) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, quant_matmul_mma_kernel<BM, BN, kW4>);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)(a.sharedSizeBytes + MatmulTile<BM, BN, kW4>::kSmemBytes);
  info[3] = kThreads;
  info[4] = BM;
  info[5] = BN;
}

}  // namespace

// The bf16 route of crane_quant_matmul (quant_matmul.cu), with its
// arguments and alignment checked there: the largest output tile whose grid
// still gives every SM a block (else the smallest, split over a cluster).
cudaError_t quant_matmul_mma_bf16(int bits, const void* x, const int8_t* codes,
                                  const float* scales, void* out, int M, int I, int O,
                                  cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int tile = 0;
  while (tile < 2 && (long)((O + kTiles[tile][1] - 1) / kTiles[tile][1]) *
                             ((M + kTiles[tile][0] - 1) / kTiles[tile][0]) < sms)
    ++tile;
  return bits == 4 ? dispatch_mma<true>(tile, sms, x, codes, scales, out, M, I, O, stream)
                   : dispatch_mma<false>(tile, sms, x, codes, scales, out, M, I, O, stream);
}

}  // namespace crane

// The compiled form of the bf16 tensor-core K6 at output tile `tile` (0, 1,
// 2: 64 x 128, 64 x 64, 32 x 64) and `bits`: info[0] registers a thread,
// info[1] local (spill) bytes a thread, info[2] shared memory bytes a
// block, info[3] threads a block, info[4] and info[5] the tile's rows and
// columns. Returns the CUDA error (cudaErrorInvalidValue for an instance
// the build does not have).
extern "C" int crane_quant_matmul_mma_info(int tile, int bits, int* info) {
  using namespace crane;
  if (bits != 8 && bits != 4) return cudaErrorInvalidValue;
  const bool w4 = bits == 4;
  switch (tile) {
    case 0:
      w4 ? mma_attributes<64, 128, true>(info) : mma_attributes<64, 128, false>(info);
      break;
    case 1:
      w4 ? mma_attributes<64, 64, true>(info) : mma_attributes<64, 64, false>(info);
      break;
    case 2:
      w4 ? mma_attributes<32, 64, true>(info) : mma_attributes<32, 64, false>(info);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
