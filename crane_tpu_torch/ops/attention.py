"""Grouped-query attention: the eager reference every attention kernel of
the port is checked against.

Port of ``crane_tpu/ops/attention.py``. Q is viewed as ``[B, S, Hkv, G, D]``
so K/V are contracted per kv-head without repeating them; logits and softmax
are float32, the PV product takes the probabilities in V's dtype and
accumulates in float32. Masking is positional: KV slot ``t`` takes part iff
``t <= q_position`` (and ``t > q_position - window`` with a window).
"""

from __future__ import annotations

import torch

_NEG_INF = torch.finfo(torch.float32).min


def attention_mask(
    q_positions: torch.Tensor, kv_len: int, *, window: int | None = None
) -> torch.Tensor:
    """Boolean mask ``[B, S, T]``: True where KV slot t attends to query s."""
    t = torch.arange(kv_len, dtype=torch.int32, device=q_positions.device)
    t = t[None, None, :]
    p = q_positions[:, :, None]
    mask = t <= p
    if window is not None:
        mask = mask & (t > p - window)
    return mask


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
    logit_softcap: float | None = None,
    extra_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """q ``[B, S, Hq, D]``; k, v ``[B, T, Hkv, D]`` (whole cache buffers —
    slots past each query's position are masked). ``extra_mask [B, S, T']``
    is OR'd with the causal mask over its first T' slots. Returns
    ``[B, S, Hq, D]`` in q's dtype. Like the reference, a query with no
    visible slot gets a uniform softmax (masked logits are the float32
    minimum, not -inf)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    mask = attention_mask(q_positions, k.shape[1], window=window)
    if extra_mask is not None:
        if extra_mask.shape[-1] != k.shape[1]:
            pad = k.shape[1] - extra_mask.shape[-1]
            extra_mask = torch.nn.functional.pad(extra_mask, (0, pad))
        mask = mask | extra_mask
    logits = torch.where(mask[:, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: float,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """GQA attention under an explicit mask ``[B, S, T]``, all in float32:
    the arithmetic the CUDA attention kernels implement, written plainly.
    A query with no visible slot gives zeros (as the kernels write)."""
    return _masked_attention(q, k, v, mask, scale, logit_softcap, stats=False)


def masked_attention_with_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    *,
    scale: float,
    logit_softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`masked_attention` with each query row's softmax statistics:
    ``(out [B, S, Hq, D], m [B, Hq, S], l [B, Hq, S])``, ``m`` the max of the
    scaled, softcapped logits over the visible slots and ``l = sum exp(s -
    m)``, both float32. Softmax partials over disjoint slot sets merge
    exactly by these (``crane_tpu_torch.parallel.sequence``). A query with
    no visible slot gives ``out = 0``, ``m = -inf`` and ``l = 0``."""
    return _masked_attention(q, k, v, mask, scale, logit_softcap, stats=True)


def _masked_attention(q, k, v, mask, scale, logit_softcap, *, stats: bool):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    m = mask[:, None, None]
    logits = logits.masked_fill(~m, float("-inf"))
    seen = m.any(dim=-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(seen, probs, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    out = out.reshape(B, S, Hq, D).to(q.dtype)
    if not stats:
        return out
    mx = logits.amax(dim=-1)  # [B, Hkv, G, S]; -inf for an empty row
    # an empty row's exp(-inf - -inf) is nan: replaced, never summed into l
    total = torch.exp(logits - mx[..., None]).sum(dim=-1)
    total = torch.where(seen[..., 0], total, 0.0)
    return out, mx.reshape(B, Hq, S), total.reshape(B, Hq, S)
