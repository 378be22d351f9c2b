"""Shared prefill-from-embeddings + greedy decode step.

Port of ``crane_tpu/models/modules/embeds_decode.py``: the common shape
behind every embed-splicing model (PaddleOCR-VL's image splice here; the
audio models when they are ported). A prefill of pre-built input embeddings
from position 0 over the cache (a continuation over the cache buffers, so
its attention takes K3, as crane_tpu's cached route does), then greedy
one-token decode steps over the cache (K1). crane_tpu jits both; here the
decode step, the part a generation repeats, is one replay of a CUDA graph
on the card (``graphs.dispatch``, as ``CausalLM``'s decode blocks are), and
the prefill runs eagerly once a prompt.
"""

from __future__ import annotations

import functools

import torch

from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
from crane_tpu_torch.ops.kv_cache import KVCache


@torch.no_grad()
def embeds_prefill(cfg, params, rope, cache, embeds: torch.Tensor, true_length: int):
    """embeds ``[B, S_bucket, E]`` (padded); returns last-token logits
    ``[B, V]`` + cache with lengths set to ``true_length``."""
    B, S, _ = embeds.shape
    tokens = torch.zeros((B, S), dtype=torch.int32, device=embeds.device)
    lengths = torch.full((B,), true_length, dtype=torch.int32, device=embeds.device)
    hidden, new_cache = forward_hidden(cfg, params, tokens, cache, 0, rope,
                                       inputs_embeds=embeds, true_lengths=lengths)
    new_cache.lengths = lengths
    return lm_logits(cfg, params, hidden[:, true_length - 1:true_length])[:, 0], new_cache


def _greedy_body(cfg, params, rope, *, layers, tokens, lengths, active, out):
    """One greedy step of ``tokens [B]`` over the cache ``layers``: the
    next tokens into ``out [B]``, the active rows' ``lengths`` rolled in
    place (an inactive row writes no KV and keeps its length)."""
    cache = KVCache(layers=layers, lengths=lengths)
    hidden, cache = forward_hidden(cfg, params, tokens[:, None], cache, lengths, rope,
                                   active=active)
    out.copy_(torch.argmax(lm_logits(cfg, params, hidden)[:, 0], -1))
    lengths.copy_(cache.lengths)


@torch.no_grad()
def greedy_decode_step(programs: dict, cfg, params, rope, cache, token: torch.Tensor):
    """token ``[B]`` int32 -> (the greedy next token ``[B]`` int32, cache
    with its lengths rolled in place). On the card the step is one replay
    of a program kept in the model's ``programs`` dict (captured on the
    first call over these cache buffers); on the CPU and under
    ``graphs.eager()`` it runs eagerly."""
    B = token.shape[0]
    inputs = dict(tokens=token, lengths=cache.lengths,
                  active=torch.ones((B,), dtype=torch.bool, device=token.device))
    body = functools.partial(_greedy_body, cfg, params, rope)
    out = graphs.dispatch(programs, token.device, "greedy_decode", body, cache, inputs,
                          {"out": ((B,), torch.int32)})["out"]
    return out, cache
