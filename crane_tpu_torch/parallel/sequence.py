"""Sequence parallelism: a KV cache split along its sequence axis into slabs.

Port of ``crane_tpu/parallel/sequence.py``. When a context no longer fits one
device's memory, every full-attention layer's KV buffers split their
SEQUENCE axis into ``n`` contiguous slabs, one per slab device
(:class:`~crane_tpu_torch.ops.kv_cache.SequenceShardedKVCache`), so ``n``
devices hold an ``n`` times longer context. Sliding-window layers (bounded
KV) and GDN states stay whole on the lead device.

One process drives every slab, as one JAX process drives an ``sp`` mesh
through ``shard_map``: work outside attention over the cache (projections,
norms, the MLP, K2 over a fresh prompt's own K/V) runs once, on the lead
device, which holds the weights; the cache write routes each token to its
slab. Reading the cache, each slab runs the with-stats kernel over its own
positions (decode: K1-S / K4-S at the slab-local live length
``clip(len - i T/n, 0, T/n)``; a continuation chunk: K3-S / K5-S at the
slab-local positions ``pos - i T/n``, negative where the row attends nothing
there), and the partials come to the lead device, where the log-sum-exp
merge combines them exactly (:func:`merge_partials`):

    out = sum_i out_i * w_i / sum_i w_i,   w_i = l_i * exp(m_i - max_j m_j)

A slab device may repeat (``make_sp_mesh(4, ["cuda:0"] * 4)``): four slabs
on one card, the counterpart of XLA's forced host device count.
"""

from __future__ import annotations

import dataclasses

import torch

from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.modules.transformer import attention_route, make_layer_cache
from crane_tpu_torch.ops.cuda.quant_attention import (
    cached_attention_with_stats,
    cached_attention_with_stats_plain,
    decode_attention_with_stats,
    decode_attention_with_stats_plain,
)
from crane_tpu_torch.ops.kv_cache import KVCache, SequenceShardedKVCache
from crane_tpu_torch.utils.device import default_device


def make_sp_mesh(n: int, devices=None) -> tuple[torch.device, ...]:
    """The ``n`` slab devices of a sequence-parallel model: the first ``n``
    of ``devices``, by default the cards ``cuda:0 .. cuda:n-1`` (raising
    without a card). A device may repeat: ``["cpu"] * 4`` runs four slabs
    on the CPU, ``["cuda:0"] * 4`` four on one card. The first is the lead
    device, which holds the weights."""
    if devices is None:
        default_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n < 1 or len(devices) < n:
        raise ValueError(f"an {n}-way sp mesh needs {n} devices, got {len(devices)}")
    return tuple(devices[:n])


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, as a tensor's own device reads."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def merge_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """The exact log-sum-exp merge of per-slab softmax partials (the JAX
    ``_merge`` and its per-row form). ``parts``: one ``(out [B, S, Hq, D],
    m [B, Hq, S], l [B, Hq, S])`` per slab, ``out`` already rounded to the
    query's dtype as the kernels write it. A slab weighs
    ``l > 0 ? l * exp(m - max m) : 0``, so an empty slab (``l == 0``, ``m``
    ``-inf``) adds nothing and a row empty everywhere gives 0, never NaN.
    Float32 throughout; the result is cast to ``dtype``."""
    out = torch.stack([p[0] for p in parts]).float()  # [n, B, S, Hq, D]
    m = torch.stack([p[1] for p in parts])  # [n, B, Hq, S]
    l = torch.stack([p[2] for p in parts])
    m_max = m.amax(dim=0)
    w = torch.where(l > 0, l * torch.exp(m - m_max), 0.0)
    denom = w.sum(dim=0).clamp_min(1e-30).transpose(1, 2)[..., None]  # [B, S, Hq, 1]
    num = (out * w.transpose(2, 3)[..., None]).sum(dim=0)
    return (num / denom).to(dtype)


def _operands(slab, bits):
    if bits == 16:
        return slab.k, slab.v, None, None
    return slab.k, slab.v, slab.k_scale, slab.v_scale


def _slab_route(kind, kernel, plain, q, cache: SequenceShardedKVCache):
    """The with-stats kernel for the slabs of ``cache``, or, for heads the
    kernels do not take, its plain version (counted once per attention call
    in ``attention_block.plain_routes``)."""
    slab = cache.slabs[0]
    n_kv = slab.k.shape[2] if cache.bits == 16 else slab.n_kv_heads
    return attention_route(kind, kernel, plain, q.shape[3], q.shape[2], n_kv)


def sp_decode_attention(q, cache: SequenceShardedKVCache, lengths, *, scale: float,
                        logit_softcap: float | None = None) -> torch.Tensor:
    """Decode (q ``[B, 1, Hq, D]``) over a sequence-sharded cache whose rows
    hold ``lengths [B]`` live tokens (GLOBAL counts): the with-stats decode
    kernel per slab at its local lengths (a slab past a row's end has local
    length 0 and reads nothing), merged on q's device."""
    T = cache.slab_len
    attend = _slab_route("decode", decode_attention_with_stats,
                         decode_attention_with_stats_plain, q, cache)
    parts = []
    for i, (slab, dev) in enumerate(zip(cache.slabs, cache.devices)):
        local = (lengths - i * T).clamp(0, T).to(device=dev, dtype=torch.int32)
        out, m, l = attend(
            q.to(dev), *_operands(slab, cache.bits), local, bits=cache.bits, scale=scale,
            logit_softcap=logit_softcap)
        parts.append((out.to(q.device), m.to(q.device)[..., None], l.to(q.device)[..., None]))
    return merge_partials(parts, q.dtype)


def sp_chunk_attention(q, cache: SequenceShardedKVCache, positions, *, scale: float,
                       logit_softcap: float | None = None) -> torch.Tensor:
    """A continuation chunk (q ``[B, S, Hq, D]`` at absolute ``positions
    [B, S]``, already written) over a sequence-sharded cache: the with-stats
    chunk kernel per slab at slab-local positions (negative before the slab:
    the row attends nothing there; past its end: clamped to its last slot,
    as the kernels clamp), merged per query row on q's device. Each slab's
    cost is one chunk against one slab, as ring attention's, with no
    rotation of KV slabs: the chunk is small, so it goes to every slab."""
    T = cache.slab_len
    attend = _slab_route("chunk", cached_attention_with_stats,
                         cached_attention_with_stats_plain, q, cache)
    parts = []
    for i, (slab, dev) in enumerate(zip(cache.slabs, cache.devices)):
        local = (positions - i * T).to(device=dev, dtype=torch.int32)
        out, m, l = attend(
            q.to(dev), *_operands(slab, cache.bits), local, bits=cache.bits, scale=scale,
            logit_softcap=logit_softcap)
        parts.append((out.to(q.device), m.to(q.device), l.to(q.device)))
    return merge_partials(parts, q.dtype)


class SequenceShardedCausalLM(CausalLM):
    """A :class:`CausalLM` whose full-attention KV caches split their
    sequence axis over the slab devices ``mesh`` (:func:`make_sp_mesh`).
    The weights stay on the lead device ``mesh[0]``, where the model must
    already be, in the base's layout (a fused tree stays fused, as in
    crane_tpu); each other device holds only its slabs."""

    def __init__(self, base: CausalLM, mesh):
        mesh = tuple(_indexed(torch.device(d)) for d in mesh)
        if not mesh or base.device != mesh[0]:
            raise ValueError(f"the model lies on {base.device}; the sp mesh leads with "
                             f"{mesh[0] if mesh else None}")
        super().__init__(
            dataclasses.replace(base.config, sequence_axis="sp"), base.params,
            tokenizer=base.tokenizer, eos_token_ids=base.eos_token_ids, dtype=base.dtype)
        self.mesh = mesh

    def init_cache(self, batch: int, max_seq: int, *, quant_bits: int | None = None,
                   device=None) -> KVCache:
        """``max_seq`` rounded up to a multiple of the slab count; every
        full-attention layer split into slabs of ``max_seq / n`` positions,
        one per slab device; sliding-window and GDN layers whole on the lead
        device. ``device="meta"`` sizes without allocating (the slabs still
        name their devices)."""
        cfg, n = self.config, len(self.mesh)
        max_seq = -(-max_seq // n) * n
        layers = []
        for i in range(cfg.num_layers):
            if cfg.layer_type(i) == "full":
                slabs = tuple(make_layer_cache(cfg, i, batch, max_seq // n, self.dtype,
                                               quant_bits=quant_bits, device=device or d)
                              for d in self.mesh)
                layers.append(SequenceShardedKVCache(slabs, self.mesh))
            else:
                layers.append(make_layer_cache(cfg, i, batch, max_seq, self.dtype,
                                               quant_bits=quant_bits,
                                               device=device or self.device))
        return KVCache(layers=tuple(layers),
                       lengths=torch.zeros((batch,), dtype=torch.int32,
                                           device=device or self.device))


def sp_shard_lm(lm: CausalLM, mesh) -> SequenceShardedCausalLM:
    """Split a loaded model's KV sequence axis over ``mesh`` (``sp``)."""
    return SequenceShardedCausalLM(lm, mesh)
