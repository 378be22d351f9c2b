"""K1 and K1-S: GQA decode attention over an fp KV cache
(``csrc/decode_attention.cu``).

Port of ``crane_tpu/ops/pallas/quant_attention.py::quant_decode_attention``
with ``bits=16`` (``_fp_decode_attention`` / ``_fp_kernel``), and of its
with-stats form ``decode_attention_with_stats(bits=16)``, which also returns
each head's softmax max and sum for the sequence-parallel merge. On a CUDA
tensor :func:`fp_decode_attention` and :func:`fp_decode_attention_with_stats`
launch the hand-written kernel (one launch, the stats pointers null or set)
or raise; on a CPU tensor they run their ``*_plain`` versions, the same
functions in plain PyTorch.

The kernel splits each (row, kv-head)'s live range over
:func:`decode_splits` blocks, a count taken from shapes alone, and merges
the float32 partials in scratch this module allocates
(:func:`split_operands`); K4 (``quant_attention.py``) shares both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from crane_tpu_torch.ops.attention import masked_attention, masked_attention_with_stats
from crane_tpu_torch.ops.cuda import build

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
# the split-KV grid (csrc/decode_attention.cuh): the fewest slots of the
# allocated T a split may be given (eight warps, 16 slots each), and the
# most splits a launch takes (kMaxSplits)
MIN_SPLIT_SLOTS = 128
MAX_SPLITS = 512
INFO_KEYS = ("registers", "local_bytes", "smem_bytes", "threads", "blocks_per_sm")


def decode_splits(B: int, Hkv: int, T: int, n_sms: int, blocks_per_sm: int = 2) -> int:
    """Blocks per (row, kv-head) of the decode kernels K1/K4 and their -S
    forms: the most n whose grid of ``n * B * Hkv`` blocks the card holds at
    once (``blocks_per_sm`` on each of ``n_sms`` SMs), at most ``T //
    MIN_SPLIT_SLOTS`` and MAX_SPLITS, and 1 when ``B * Hkv`` blocks already
    give every SM one. One block more than the card holds waits for a
    second wave that takes as long as the first. From shapes alone: the
    live lengths would need a read from the device, and a CUDA graph
    replays the launch with new ones."""
    blocks = B * Hkv
    if blocks >= n_sms:
        return 1
    return max(1, min(blocks_per_sm * n_sms // blocks, T // MIN_SPLIT_SLOTS, MAX_SPLITS))


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _blocks_per_sm(index: int, dtype: torch.dtype, bits: int, D: int, G: int) -> int:
    with torch.cuda.device(index):
        if bits == 16:
            info = kernel_info(dtype, D, G)
        else:
            from crane_tpu_torch.ops.cuda.quant_attention import decode_kernel_info

            info = decode_kernel_info(dtype, bits, D, G)
    return max(1, info["blocks_per_sm"])


def decode_split_count(q: torch.Tensor, Hkv: int, T: int, bits: int = 16) -> int:
    """The n_split the wrappers launch q ``[B, 1, Hq, D]`` with over a T-slot
    cache (``bits`` 16: K1; 8 or 4: K4): :func:`decode_splits` at the
    device's SM count and the blocks an SM holds of the instance that runs
    (its registers and shared memory, asked of the runtime once)."""
    B, _, Hq, D = q.shape
    index = q.device.index
    return decode_splits(B, Hkv, T, sm_count(index),
                         _blocks_per_sm(index, q.dtype, bits, D, Hq // Hkv))


# per device: int32 zeros, one ticket counter per (row, kv-head) of a split
# launch, which has fewer (row, kv-head)s than the device has SMs
# (decode_splits); the block that merges a (row, kv-head) resets its
# counter, so they stay zero between launches (the port launches on one
# stream per device). Allocated once, so a captured CUDA graph's pointer
# stays valid.
_counters: dict[torch.device, torch.Tensor] = {}


def _ticket_counters(device: torch.device) -> torch.Tensor:
    buf = _counters.get(device)
    if buf is None:
        buf = _counters[device] = torch.zeros(sm_count(device.index), dtype=torch.int32,
                                              device=device)
    return buf


def split_operands(q: torch.Tensor, Hkv: int, T: int, bits: int = 16):
    """``(n_split, part_acc, part_ml, counters, scratch)`` for a decode
    launch of q ``[B, 1, Hq, D]`` over a T-slot cache with Hkv kv-heads:
    the split count (:func:`decode_split_count`) and, above 1, the pointers
    of the float32 partials (``[B, Hq, n, D]`` acc, ``[2, B, Hq, n]`` m and
    l) in ``scratch`` and of the ticket counters, so the last block of each
    (row, kv-head) merges in the one launch; at n = 1 the pointers are None
    (NULL)."""
    B, _, Hq, D = q.shape
    n = decode_split_count(q, Hkv, T, bits)
    if n == 1:
        return 1, None, None, None, None
    scratch = torch.empty(B * Hq * n * (D + 2), dtype=torch.float32, device=q.device)
    acc = scratch.data_ptr()
    counters = _ticket_counters(q.device).data_ptr()
    return n, acc, acc + B * Hq * n * D * 4, counters, scratch


def _decode_mask(kv_valid, T, window, device):
    """``[B, 1, T]``: slot t is visible iff ``valid - window <= t < valid``
    (no lower bound without a window), ``valid = min(kv_valid[b], T)``."""
    valid = kv_valid.to(torch.int64).clamp(0, T)[:, None]
    t = torch.arange(T, device=device)[None, :]
    mask = t < valid
    if window is not None:
        mask = mask & (t >= valid - window)
    return mask[:, None, :]


def fp_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """q ``[B, 1, Hq, D]``; k/v ``[B, T, Hkv, D]``; ``kv_valid [B]`` int32.
    Row b attends slots ``[max(0, valid - window), valid)`` with
    ``valid = min(kv_valid[b], T)``; a row with ``valid == 0`` returns 0.
    Returns ``[B, 1, Hq, D]`` in q's dtype."""
    mask = _decode_mask(kv_valid, k.shape[1], window, k.device)
    return masked_attention(q, k, v, mask, scale=scale, logit_softcap=logit_softcap)


def fp_decode_attention_with_stats_plain(
    q, k, v, kv_valid, *, scale: float, window: int | None = None,
    logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fp_decode_attention_plain` with each head's softmax max ``m``
    and sum ``l``, ``[B, Hq]`` float32 (``m = -inf``, ``l = 0`` for an empty
    row): ``(out, m, l)``."""
    mask = _decode_mask(kv_valid, k.shape[1], window, k.device)
    out, m, l = masked_attention_with_stats(q, k, v, mask, scale=scale,
                                            logit_softcap=logit_softcap)
    return out, m[:, :, 0], l[:, :, 0]


def _launch(q, k, v, kv_valid, scale, window, logit_softcap, stats: bool):
    """Check the operands and launch K1 (``stats``: K1-S, which also writes
    ``m``, ``l``). Returns ``out`` or ``(out, m, l)``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if S != 1:
        raise ValueError(f"decode kernel takes one query per row, got S={S}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode kernel head_dim must be in {HEAD_DIMS}, got {D}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode kernel needs Hq/Hkv in 1..{MAX_GROUP}: {Hq}/{Hkv}")
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch: {q.dtype} {k.dtype} {v.dtype}")
    if kv_valid.dtype != torch.int32 or kv_valid.shape != (B,):
        raise TypeError("kv_valid must be int32 [B]")
    build.require_cuda("fp_decode_attention", q, k, v, kv_valid)
    dtype = build.dtype_code(q)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("fp_decode_attention: k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    n, acc, ml, counters, _scratch = split_operands(q, Hkv, T)
    err = build.lib().crane_decode_attention(
        dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(),
        m.data_ptr() if stats else None, l.data_ptr() if stats else None, acc, ml, counters,
        B, T, Hq, Hkv, D, float(scale), int(window or 0), float(logit_softcap or 0.0), n,
        build.stream_ptr(q.device),
    )
    build.check_launch("crane_decode_attention", err)
    return (out, m, l) if stats else out


def kernel_info(dtype: torch.dtype, head_dim: int, group: int) -> dict[str, int]:
    """The compiled form of K1's instance at ``dtype``, ``head_dim`` and
    ``group`` query heads per kv-head (``cudaFuncGetAttributes``):
    registers and local (spill) bytes a thread, shared-memory bytes and
    threads a block, and the blocks an SM holds at once (the runtime's
    occupancy calculator). Builds the kernels on first use; needs the
    card."""
    info = (ctypes.c_int * len(INFO_KEYS))()
    build.check_launch("crane_decode_attention_info", build.lib().crane_decode_attention_info(
        build.DTYPE_CODES[dtype], head_dim, group, info))
    return dict(zip(INFO_KEYS, info))


def fp_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Decode attention (contract in :func:`fp_decode_attention_plain`)."""
    build.refuse_grad("fp_decode_attention", q, k, v)
    if q.device.type == "cpu":
        return fp_decode_attention_plain(
            q, k, v, kv_valid, scale=scale, window=window,
            logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"fp_decode_attention: no kernel for {q.device}")
    out = _launch(q, k, v, kv_valid, scale, window, logit_softcap, stats=False)
    fp_decode_attention.launches += 1
    return out


def fp_decode_attention_with_stats(
    q, k, v, kv_valid, *, scale: float, window: int | None = None,
    logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention with its softmax statistics, K1-S (contract in
    :func:`fp_decode_attention_with_stats_plain`)."""
    build.refuse_grad("fp_decode_attention_with_stats", q, k, v)
    if q.device.type == "cpu":
        return fp_decode_attention_with_stats_plain(
            q, k, v, kv_valid, scale=scale, window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"fp_decode_attention_with_stats: no kernel for {q.device}")
    res = _launch(q, k, v, kv_valid, scale, window, logit_softcap, stats=True)
    fp_decode_attention_with_stats.launches += 1
    return res


fp_decode_attention.launches = 0
fp_decode_attention_with_stats.launches = 0
