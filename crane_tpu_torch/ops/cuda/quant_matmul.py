"""K6: int8 / packed-int4 weight matmul with per-column scales
(``csrc/quant_matmul.cu``).

Port of ``crane_tpu/ops/pallas/quant_matmul.py::quant_matmul``:
``y = (x @ codes) * scales`` for activations ``x [M, I]``, codes ``[I, O]``
int8 (``bits=8``) or ``[I/2, O]`` packed int4 (``bits=4``: byte ``(i, o)``
holds code ``i`` low and code ``i + I/2`` high) and ``scales [1, O]``
float32. On a CUDA tensor :func:`quant_matmul` launches the hand-written
kernel or raises; on a CPU tensor it runs :func:`quant_matmul_plain`. Unlike
the TPU kernel, neither rounds a float32 ``x`` to bf16. The one C entry
chooses the kernel by dtype and M: bfloat16 ``x`` with at least
``MMA_MIN_M`` rows (and 16-byte-aligned rows) runs the tensor-core kernel
(``csrc/quant_matmul_mma.cu``), everything else the CUDA-core kernel
(``csrc/quant_matmul.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.kv_cache import unpack_int4

BITS = (8, 4)
# bf16 rows from which the C entry takes the tensor-core kernel (quant_matmul.cu
# kMmaMinM)
MMA_MIN_M = 4
# the tensor-core kernel's output tiles, by the index its info entry takes
MMA_TILES = ((64, 128), (64, 64), (32, 64))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, as XLA's ``preferred_element_type``
    gives it: cuBLAS writes float32 itself for a bf16 pair on the card
    (``out_dtype``); the CPU has no such product and upcasts after, which in
    float32 is the same."""
    if a.is_cuda and a.dtype != torch.float32:
        flat = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return flat.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a, b).float()


def quant_matmul_plain(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                       *, bits: int) -> torch.Tensor:
    """x ``[M, I]``; codes ``[I, O]`` int8 or ``[I/2, O]`` packed int4;
    scales ``[1, O]`` (or ``[O]``) float32. The codes, exact in any float
    type, are cast to x's dtype; the product accumulates in float32 and is
    scaled once. Returns ``[M, O]`` in x's dtype."""
    w = unpack_int4(codes.T).T if bits == 4 else codes
    y = matmul_f32(x, w.to(x.dtype)) * scales.reshape(1, -1)
    return y.to(x.dtype)


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                 *, bits: int) -> torch.Tensor:
    """Quantized-weight matmul (contract in :func:`quant_matmul_plain`).
    Launches are counted per ``bits``: ``launches["w8"]``, ``["w4"]``."""
    build.refuse_grad("quant_matmul", x, codes, scales)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, codes, scales, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    if bits not in BITS:
        raise ValueError(f"quant_matmul takes bits in {BITS}, got {bits}")
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"quant_matmul takes x [M, I] and codes [I', O], got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    M, I = x.shape
    Ip, O = codes.shape
    if Ip * (2 if bits == 4 else 1) != I:
        raise ValueError(f"quant_matmul: codes {tuple(codes.shape)} do not fit x "
                         f"{tuple(x.shape)} at {bits} bits")
    if codes.dtype != torch.int8:
        raise TypeError(f"quant_matmul: codes must be int8, got {codes.dtype}")
    if scales.dtype != torch.float32 or scales.numel() != O:
        raise TypeError("quant_matmul: scales must be float32 [1, O]")
    build.require_cuda("quant_matmul", x, codes, scales)
    out = torch.empty((M, O), dtype=x.dtype, device=x.device)
    err = build.lib().crane_quant_matmul(
        build.dtype_code(x), bits, x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        out.data_ptr(), M, I, O, build.stream_ptr(x.device),
    )
    build.check_launch("crane_quant_matmul", err)
    quant_matmul.launches[f"w{bits}"] += 1
    return out


# the tensor-core kernel's code rows a stage and its most blocks a cluster
# (quant_matmul_mma.cu kBK, kMaxSplitK)
MMA_BK, MMA_MAX_SPLIT = 64, 8


def mma_plan(M: int, I: int, O: int, bits: int, sms: int) -> tuple[int, int]:
    """(tile, n_split): the output tile (an index of ``MMA_TILES``) and the
    blocks of a cluster that split I, as the C entry chooses them for the
    tensor-core kernel on a card of ``sms`` SMs (quant_matmul_mma.cu
    ``quant_matmul_mma_bf16`` and ``launch_mma``): the largest tile whose
    grid gives every SM a block, else the smallest, whose k-tiles double
    over a cluster while the grid leaves SMs without a block and each block
    keeps two k-tiles. An output column's float32 sum runs over the same
    k-steps in the same order at every tile; only ``n_split`` changes the
    order (each block sums its share, the first block adds the others')."""
    def tiles(t):
        bm, bn = MMA_TILES[t]
        return -(-O // bn) * -(-M // bm)

    tile = 0
    while tile < len(MMA_TILES) - 1 and tiles(tile) < sms:
        tile += 1
    k_tiles = -(-(I // 2 if bits == 4 else I) // MMA_BK)
    n_split = 1
    while n_split < MMA_MAX_SPLIT and tiles(tile) * n_split < sms and 4 * n_split <= k_tiles:
        n_split *= 2
    return tile, n_split


def mma_kernel_info(tile: int, bits: int) -> dict[str, int]:
    """The compiled form of the bf16 tensor-core K6 at output tile ``tile``
    (an index of ``MMA_TILES``) and ``bits``: registers and local (spill)
    bytes a thread, shared memory bytes and threads a block, the tile's rows
    and columns. Builds the kernels on first use; needs the card."""
    info = (ctypes.c_int * 6)()
    build.check_launch("crane_quant_matmul_mma_info",
                       build.lib().crane_quant_matmul_mma_info(tile, bits, info))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads", "rows", "cols"), info))


quant_matmul.launches = {f"w{b}": 0 for b in BITS}
