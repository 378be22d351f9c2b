"""K4, K5 and their with-stats forms K4-S and K5-S: GQA attention over an int8
/ packed-int4 KV cache (``csrc/quant_decode_attention.cu`` and its int4
instances in ``csrc/quant_decode_attention_int4.cu``,
``csrc/quant_cached_attention.cu``).

Port of ``crane_tpu/ops/pallas/quant_attention.py`` with ``bits`` 8 and 4:

- :func:`quant_decode_attention` (K4, ``_quant_decode_attention``): one
  query per row over the cache's live length;
- :func:`quant_cached_attention` (K5, ``_cached_attention``): a
  continuation chunk at absolute ``positions`` over the whole buffer;
- :func:`quant_decode_attention_with_stats` (K4-S) and
  :func:`quant_cached_attention_with_stats` (K5-S): the same launches with
  stats pointers (Pallas's ``return_stats=True``), which also return each
  query row's softmax max ``m`` and sum ``l`` for the sequence-parallel merge.

:func:`decode_attention_with_stats` and :func:`cached_attention_with_stats`
are the JAX package's dispatchers by name: ``bits=16`` goes to K1-S / K3-S
over an fp cache, ``bits`` 8 / 4 to K4-S / K5-S.

All read the cache as :class:`~crane_tpu_torch.ops.kv_cache.QuantLayerKVCache`
stores it: flat codes ``[B, T, Hkv * stored]`` int8 and scales
``[B, Hkv, T]`` float32. On a CUDA tensor each wrapper launches the
hand-written kernel or raises; on a CPU tensor it runs its ``*_plain``
counterpart, which dequantizes the buffer (in q's dtype) and runs K1's or
K3's plain version. Launches are counted per ``bits`` (``launches["kv8"]``,
``["kv4"]``), each wrapper on its own counter. K5 and K5-S are chosen by
dtype inside the one C entry: bfloat16 runs the tensor-core kernel
(``csrc/quant_cached_attention_mma.cu``, K3's tile loop over unpacked
codes), float32 the CUDA-core kernel.
"""

from __future__ import annotations

import ctypes

import torch

from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.cuda.decode_attention import (
    MAX_GROUP,
    fp_decode_attention_plain,
    fp_decode_attention_with_stats,
    INFO_KEYS,
    fp_decode_attention_with_stats_plain,
    split_operands,
)
from crane_tpu_torch.ops.cuda.flash_attention import (
    HEAD_DIMS,
    flash_attention_cached_plain,
    flash_attention_cached_with_stats,
    flash_attention_cached_with_stats_plain,
)
from crane_tpu_torch.ops.kv_cache import dequant_codes

BITS = (8, 4)


def _dequant(q, k_codes, v_codes, k_scale, v_scale, bits):
    Hkv = k_scale.shape[1]
    return (dequant_codes(k_codes, k_scale, bits, Hkv, q.dtype),
            dequant_codes(v_codes, v_scale, bits, Hkv, q.dtype))


def quant_decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale, kv_valid, *,
                                 bits: int, scale: float, window: int | None = None,
                                 logit_softcap: float | None = None) -> torch.Tensor:
    """q ``[B, 1, Hq, D]``; codes ``[B, T, Hkv * stored]`` int8; scales
    ``[B, Hkv, T]`` float32; ``kv_valid [B]`` int32. Row b attends slots
    ``[max(0, valid - window), valid)``, ``valid = min(kv_valid[b], T)``; a
    row with ``valid == 0`` returns 0. Returns ``[B, 1, Hq, D]`` in q's
    dtype."""
    k, v = _dequant(q, k_codes, v_codes, k_scale, v_scale, bits)
    return fp_decode_attention_plain(q, k, v, kv_valid, scale=scale, window=window,
                                     logit_softcap=logit_softcap)


def quant_decode_attention_with_stats_plain(
    q, k_codes, v_codes, k_scale, v_scale, kv_valid, *, bits: int, scale: float,
    window: int | None = None, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quant_decode_attention_plain` with each head's softmax max and
    sum ``[B, Hq]`` float32: ``(out, m, l)``."""
    k, v = _dequant(q, k_codes, v_codes, k_scale, v_scale, bits)
    return fp_decode_attention_with_stats_plain(q, k, v, kv_valid, scale=scale, window=window,
                                                logit_softcap=logit_softcap)


def quant_cached_attention_plain(q, k_codes, v_codes, k_scale, v_scale, positions, *,
                                 bits: int, scale: float, window: int | None = None,
                                 logit_softcap: float | None = None) -> torch.Tensor:
    """q ``[B, S, Hq, D]`` at absolute ``positions [B, S]`` int32 over the
    whole quantized buffer (the chunk already written); positions past the
    buffer are clamped to ``T - 1``. Returns ``[B, S, Hq, D]`` in q's dtype."""
    k, v = _dequant(q, k_codes, v_codes, k_scale, v_scale, bits)
    return flash_attention_cached_plain(q, k, v, positions, scale=scale, window=window,
                                        softcap=logit_softcap)


def quant_cached_attention_with_stats_plain(
    q, k_codes, v_codes, k_scale, v_scale, positions, *, bits: int, scale: float,
    window: int | None = None, logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quant_cached_attention_plain` with each query row's softmax max
    and sum ``[B, Hq, S]`` float32: ``(out, m, l)``; a row with no visible
    slot (a negative position) gives 0, ``-inf`` and 0."""
    k, v = _dequant(q, k_codes, v_codes, k_scale, v_scale, bits)
    return flash_attention_cached_with_stats_plain(q, k, v, positions, scale=scale,
                                                   window=window, softcap=logit_softcap)


def _check(name, q, k_codes, v_codes, k_scale, v_scale, bits):
    """Shape and type checks shared by K4 and K5; returns (B, T, Hq, Hkv, D)."""
    if bits not in BITS:
        raise ValueError(f"{name} takes bits in {BITS}, got {bits}")
    B, _, Hq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be in {HEAD_DIMS}, got {D}")
    if k_scale.ndim != 3:
        raise ValueError(f"{name}: scales must be [B, Hkv, T], got {tuple(k_scale.shape)}")
    Hkv, T = k_scale.shape[1], k_scale.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    stored = D // 2 if bits == 4 else D
    if k_codes.shape != (B, T, Hkv * stored) or v_codes.shape != k_codes.shape:
        raise ValueError(f"{name}: codes {tuple(k_codes.shape)}/{tuple(v_codes.shape)} "
                         f"do not fit q {tuple(q.shape)} at {bits} bits")
    if k_scale.shape != (B, Hkv, T) or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError(f"{name}: codes must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32")
    return B, T, Hq, Hkv, D


def _stats(q, stats: bool, shape):
    """Float32 ``m``, ``l`` of ``shape``, or ``(None, None)`` without stats."""
    if not stats:
        return None, None
    m = torch.empty(shape, dtype=torch.float32, device=q.device)
    return m, torch.empty_like(m)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_decode(name, q, k_codes, v_codes, k_scale, v_scale, kv_valid, bits, scale,
                   window, logit_softcap, stats: bool):
    if q.shape[1] != 1:
        raise ValueError(f"decode kernel takes one query per row, got S={q.shape[1]}")
    B, T, Hq, Hkv, D = _check(name, q, k_codes, v_codes, k_scale, v_scale, bits)
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode kernel needs Hq/Hkv in 1..{MAX_GROUP}: {Hq}/{Hkv}")
    if kv_valid.dtype != torch.int32 or kv_valid.shape != (B,):
        raise TypeError("kv_valid must be int32 [B]")
    build.require_cuda(name, q, k_codes, v_codes, k_scale, v_scale, kv_valid)
    dtype = build.dtype_code(q)
    if k_codes.data_ptr() % 16 or v_codes.data_ptr() % 16:
        # a lane loads up to 16 bytes of a code row (every row is a
        # multiple of 16 bytes at the head dims the kernel takes)
        raise ValueError(f"{name}: the codes must start on a 16-byte boundary")
    out = torch.empty_like(q)
    m, l = _stats(q, stats, (B, Hq))
    n, acc, ml, counters, _scratch = split_operands(q, Hkv, T, bits)
    err = build.lib().crane_quant_decode_attention(
        dtype, bits, q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
        _ptr(m), _ptr(l), acc, ml, counters, B, T, Hq, Hkv, D, float(scale), int(window or 0),
        float(logit_softcap or 0.0), n, build.stream_ptr(q.device),
    )
    build.check_launch("crane_quant_decode_attention", err)
    return (out, m, l) if stats else out


def _launch_cached(name, q, k_codes, v_codes, k_scale, v_scale, positions, bits, scale,
                   window, logit_softcap, stats: bool):
    B, T, Hq, Hkv, D = _check(name, q, k_codes, v_codes, k_scale, v_scale, bits)
    S = q.shape[1]
    if positions.dtype != torch.int32 or positions.shape != (B, S):
        raise TypeError("positions must be int32 [B, S]")
    build.require_cuda(name, q, k_codes, v_codes, k_scale, v_scale, positions)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k_codes, v_codes)):
        # the tensor-core kernel stages q rows and code rows with 16-byte
        # copies (a row is a multiple of 16 bytes at every head dim it takes)
        raise ValueError(f"{name}: bf16 q and the codes must start on a 16-byte boundary")
    out = torch.empty_like(q)
    m, l = _stats(q, stats, (B, Hq, S))
    err = build.lib().crane_quant_cached_attention(
        build.dtype_code(q), bits, q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
        positions.data_ptr(), B, S, T, Hq, Hkv, D, float(scale), int(window or 0),
        float(logit_softcap or 0.0), build.stream_ptr(q.device),
    )
    build.check_launch("crane_quant_cached_attention", err)
    return (out, m, l) if stats else out


def mma_kernel_info(head_dim: int, bits: int) -> dict[str, int]:
    """The compiled form of the bf16 tensor-core K5 at ``head_dim`` and
    ``bits`` (``cudaFuncGetAttributes``), as
    :func:`~crane_tpu_torch.ops.cuda.flash_attention.mma_kernel_info` gives
    K2/K3's. Builds the kernels on first use; needs the card."""
    info = (ctypes.c_int * 4)()
    build.check_launch("crane_quant_cached_attention_mma_info",
                       build.lib().crane_quant_cached_attention_mma_info(head_dim, bits, info))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads"), info))


def decode_kernel_info(dtype: torch.dtype, bits: int, head_dim: int,
                       group: int) -> dict[str, int]:
    """The compiled form of K4's instance at ``dtype``, ``bits``,
    ``head_dim`` and ``group``, as
    :func:`~crane_tpu_torch.ops.cuda.decode_attention.kernel_info` gives
    K1's. Builds the kernels on first use; needs the card."""
    info = (ctypes.c_int * len(INFO_KEYS))()
    build.check_launch("crane_quant_decode_attention_info",
                       build.lib().crane_quant_decode_attention_info(
                           build.DTYPE_CODES[dtype], bits, head_dim, group, info))
    return dict(zip(INFO_KEYS, info))


def quant_decode_attention(q, k_codes, v_codes, k_scale, v_scale, kv_valid, *,
                           bits: int, scale: float, window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """Decode attention over a quantized cache (contract in
    :func:`quant_decode_attention_plain`)."""
    build.refuse_grad("quant_decode_attention", q, k_codes, v_codes, k_scale, v_scale)
    if q.device.type == "cpu":
        return quant_decode_attention_plain(
            q, k_codes, v_codes, k_scale, v_scale, kv_valid, bits=bits, scale=scale,
            window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"quant_decode_attention: no kernel for {q.device}")
    out = _launch_decode("quant_decode_attention", q, k_codes, v_codes, k_scale, v_scale,
                         kv_valid, bits, scale, window, logit_softcap, stats=False)
    quant_decode_attention.launches[f"kv{bits}"] += 1
    return out


def quant_decode_attention_with_stats(q, k_codes, v_codes, k_scale, v_scale, kv_valid, *,
                                      bits: int, scale: float, window: int | None = None,
                                      logit_softcap: float | None = None):
    """Decode attention over a quantized cache with its softmax statistics,
    K4-S (contract in :func:`quant_decode_attention_with_stats_plain`)."""
    build.refuse_grad("quant_decode_attention_with_stats", q, k_codes, v_codes, k_scale, v_scale)
    if q.device.type == "cpu":
        return quant_decode_attention_with_stats_plain(
            q, k_codes, v_codes, k_scale, v_scale, kv_valid, bits=bits, scale=scale,
            window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"quant_decode_attention_with_stats: no kernel for {q.device}")
    res = _launch_decode("quant_decode_attention_with_stats", q, k_codes, v_codes, k_scale,
                         v_scale, kv_valid, bits, scale, window, logit_softcap, stats=True)
    quant_decode_attention_with_stats.launches[f"kv{bits}"] += 1
    return res


def quant_cached_attention(q, k_codes, v_codes, k_scale, v_scale, positions, *,
                           bits: int, scale: float, window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """Continuation-chunk attention over a quantized cache (contract in
    :func:`quant_cached_attention_plain`)."""
    build.refuse_grad("quant_cached_attention", q, k_codes, v_codes, k_scale, v_scale)
    if q.device.type == "cpu":
        return quant_cached_attention_plain(
            q, k_codes, v_codes, k_scale, v_scale, positions, bits=bits, scale=scale,
            window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"quant_cached_attention: no kernel for {q.device}")
    out = _launch_cached("quant_cached_attention", q, k_codes, v_codes, k_scale, v_scale,
                         positions, bits, scale, window, logit_softcap, stats=False)
    quant_cached_attention.launches[f"kv{bits}"] += 1
    return out


def quant_cached_attention_with_stats(q, k_codes, v_codes, k_scale, v_scale, positions, *,
                                      bits: int, scale: float, window: int | None = None,
                                      logit_softcap: float | None = None):
    """Continuation-chunk attention over a quantized cache with its softmax
    statistics, K5-S (contract in :func:`quant_cached_attention_with_stats_plain`)."""
    build.refuse_grad("quant_cached_attention_with_stats", q, k_codes, v_codes, k_scale, v_scale)
    if q.device.type == "cpu":
        return quant_cached_attention_with_stats_plain(
            q, k_codes, v_codes, k_scale, v_scale, positions, bits=bits, scale=scale,
            window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"quant_cached_attention_with_stats: no kernel for {q.device}")
    res = _launch_cached("quant_cached_attention_with_stats", q, k_codes, v_codes, k_scale,
                         v_scale, positions, bits, scale, window, logit_softcap, stats=True)
    quant_cached_attention_with_stats.launches[f"kv{bits}"] += 1
    return res


def decode_attention_with_stats(q, k_codes, v_codes, k_scale, v_scale, kv_valid, *,
                                bits: int, scale: float, window: int | None = None,
                                logit_softcap: float | None = None):
    """``crane_tpu``'s ``decode_attention_with_stats``: decode attention
    returning ``(out [B, 1, Hq, D], m [B, Hq], l [B, Hq])``. ``bits=16``
    reads an fp cache ``[B, T, Hkv, D]`` (scales ignored; K1-S); 8 or 4 a
    quantized one (K4-S)."""
    if bits == 16:
        return fp_decode_attention_with_stats(q, k_codes, v_codes, kv_valid, scale=scale,
                                              window=window, logit_softcap=logit_softcap)
    return quant_decode_attention_with_stats(q, k_codes, v_codes, k_scale, v_scale, kv_valid,
                                             bits=bits, scale=scale, window=window,
                                             logit_softcap=logit_softcap)


def cached_attention_with_stats(q, k, v, k_scale, v_scale, positions, *, bits: int,
                                scale: float, window: int | None = None,
                                logit_softcap: float | None = None):
    """``crane_tpu``'s ``cached_attention_with_stats``: continuation-chunk
    attention returning ``(out [B, S, Hq, D], m [B, Hq, S], l [B, Hq, S])``.
    ``bits=16`` reads an fp cache (K3-S); 8 or 4 a quantized one (K5-S)."""
    if bits == 16:
        return flash_attention_cached_with_stats(q, k, v, positions, scale=scale,
                                                 window=window, softcap=logit_softcap)
    return quant_cached_attention_with_stats(q, k, v, k_scale, v_scale, positions, bits=bits,
                                             scale=scale, window=window,
                                             logit_softcap=logit_softcap)


def decode_attention_with_stats_plain(q, k_codes, v_codes, k_scale, v_scale, kv_valid, *,
                                      bits: int, scale: float, window: int | None = None,
                                      logit_softcap: float | None = None):
    """The plain version of :func:`decode_attention_with_stats`, for heads
    the kernels do not take."""
    if bits == 16:
        return fp_decode_attention_with_stats_plain(q, k_codes, v_codes, kv_valid, scale=scale,
                                                    window=window, logit_softcap=logit_softcap)
    return quant_decode_attention_with_stats_plain(q, k_codes, v_codes, k_scale, v_scale,
                                                   kv_valid, bits=bits, scale=scale,
                                                   window=window, logit_softcap=logit_softcap)


def cached_attention_with_stats_plain(q, k, v, k_scale, v_scale, positions, *, bits: int,
                                      scale: float, window: int | None = None,
                                      logit_softcap: float | None = None):
    """The plain version of :func:`cached_attention_with_stats`, for heads
    the kernels do not take."""
    if bits == 16:
        return flash_attention_cached_with_stats_plain(q, k, v, positions, scale=scale,
                                                       window=window, softcap=logit_softcap)
    return quant_cached_attention_with_stats_plain(q, k, v, k_scale, v_scale, positions,
                                                   bits=bits, scale=scale, window=window,
                                                   logit_softcap=logit_softcap)


quant_decode_attention.launches = {f"kv{b}": 0 for b in BITS}
quant_cached_attention.launches = {f"kv{b}": 0 for b in BITS}
quant_decode_attention_with_stats.launches = {f"kv{b}": 0 for b in BITS}
quant_cached_attention_with_stats.launches = {f"kv{b}": 0 for b in BITS}
