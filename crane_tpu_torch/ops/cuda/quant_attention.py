"""K4 and K5: GQA attention over an int8 / packed-int4 KV cache
(``csrc/quant_decode_attention.cu``, ``csrc/quant_cached_attention.cu``).

Port of ``crane_tpu/ops/pallas/quant_attention.py`` with ``bits`` 8 and 4:

- :func:`quant_decode_attention` (K4, ``_quant_decode_attention``): one
  query per row over the cache's live length;
- :func:`quant_cached_attention` (K5, ``_cached_attention``): a
  continuation chunk at absolute ``positions`` over the whole buffer.

Both read the cache as :class:`~crane_tpu_torch.ops.kv_cache.QuantLayerKVCache`
stores it: flat codes ``[B, T, Hkv * stored]`` int8 and scales
``[B, Hkv, T]`` float32. On a CUDA tensor each wrapper launches the
hand-written kernel or raises; on a CPU tensor it runs its ``*_plain``
counterpart, which dequantizes the buffer (in q's dtype) and runs K1's or
K3's plain version. Launches are counted per ``bits`` (``launches["kv8"]``,
``["kv4"]``).
"""

from __future__ import annotations

import torch

from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.cuda.decode_attention import MAX_GROUP, fp_decode_attention_plain
from crane_tpu_torch.ops.cuda.flash_attention import HEAD_DIMS, flash_attention_cached_plain
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


def quant_cached_attention_plain(q, k_codes, v_codes, k_scale, v_scale, positions, *,
                                 bits: int, scale: float, window: int | None = None,
                                 logit_softcap: float | None = None) -> torch.Tensor:
    """q ``[B, S, Hq, D]`` at absolute ``positions [B, S]`` int32 over the
    whole quantized buffer (the chunk already written); positions past the
    buffer are clamped to ``T - 1``. Returns ``[B, S, Hq, D]`` in q's dtype."""
    k, v = _dequant(q, k_codes, v_codes, k_scale, v_scale, bits)
    return flash_attention_cached_plain(q, k, v, positions, scale=scale, window=window,
                                        softcap=logit_softcap)


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


def quant_decode_attention(q, k_codes, v_codes, k_scale, v_scale, kv_valid, *,
                           bits: int, scale: float, window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """Decode attention over a quantized cache (contract in
    :func:`quant_decode_attention_plain`)."""
    if q.device.type == "cpu":
        return quant_decode_attention_plain(
            q, k_codes, v_codes, k_scale, v_scale, kv_valid, bits=bits, scale=scale,
            window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"quant_decode_attention: no kernel for {q.device}")
    if q.shape[1] != 1:
        raise ValueError(f"decode kernel takes one query per row, got S={q.shape[1]}")
    B, T, Hq, Hkv, D = _check("quant_decode_attention", q, k_codes, v_codes,
                              k_scale, v_scale, bits)
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode kernel needs Hq/Hkv in 1..{MAX_GROUP}: {Hq}/{Hkv}")
    if kv_valid.dtype != torch.int32 or kv_valid.shape != (B,):
        raise TypeError("kv_valid must be int32 [B]")
    build.require_cuda("quant_decode_attention", q, k_codes, v_codes, k_scale, v_scale,
                       kv_valid)
    out = torch.empty_like(q)
    err = build.lib().crane_quant_decode_attention(
        build.dtype_code(q), bits, q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
        B, T, Hq, Hkv, D, float(scale), int(window or 0), float(logit_softcap or 0.0),
        build.stream_ptr(q.device),
    )
    build.check_launch("crane_quant_decode_attention", err)
    quant_decode_attention.launches[f"kv{bits}"] += 1
    return out


def quant_cached_attention(q, k_codes, v_codes, k_scale, v_scale, positions, *,
                           bits: int, scale: float, window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """Continuation-chunk attention over a quantized cache (contract in
    :func:`quant_cached_attention_plain`)."""
    if q.device.type == "cpu":
        return quant_cached_attention_plain(
            q, k_codes, v_codes, k_scale, v_scale, positions, bits=bits, scale=scale,
            window=window, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"quant_cached_attention: no kernel for {q.device}")
    B, T, Hq, Hkv, D = _check("quant_cached_attention", q, k_codes, v_codes,
                              k_scale, v_scale, bits)
    S = q.shape[1]
    if positions.dtype != torch.int32 or positions.shape != (B, S):
        raise TypeError("positions must be int32 [B, S]")
    build.require_cuda("quant_cached_attention", q, k_codes, v_codes, k_scale, v_scale,
                       positions)
    out = torch.empty_like(q)
    err = build.lib().crane_quant_cached_attention(
        build.dtype_code(q), bits, q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), positions.data_ptr(),
        B, S, T, Hq, Hkv, D, float(scale), int(window or 0), float(logit_softcap or 0.0),
        build.stream_ptr(q.device),
    )
    build.check_launch("crane_quant_cached_attention", err)
    quant_cached_attention.launches[f"kv{bits}"] += 1
    return out


quant_decode_attention.launches = {f"kv{b}": 0 for b in BITS}
quant_cached_attention.launches = {f"kv{b}": 0 for b in BITS}
