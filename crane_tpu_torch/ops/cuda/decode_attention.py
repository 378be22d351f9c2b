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
"""

from __future__ import annotations

import torch

from crane_tpu_torch.ops.attention import masked_attention, masked_attention_with_stats
from crane_tpu_torch.ops.cuda import build

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8


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
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    err = build.lib().crane_decode_attention(
        build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(),
        m.data_ptr() if stats else None, l.data_ptr() if stats else None,
        B, T, Hq, Hkv, D, float(scale), int(window or 0), float(logit_softcap or 0.0),
        build.stream_ptr(q.device),
    )
    build.check_launch("crane_decode_attention", err)
    return (out, m, l) if stats else out


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
