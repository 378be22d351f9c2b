"""Shared prefill-from-embeddings + greedy decode step and block.

Port of ``crane_tpu/models/modules/embeds_decode.py``: the common shape
behind every embed-splicing model (PaddleOCR-VL's image splice, Qwen2-Audio's
and Qwen3-ASR's audio splice). A prefill of pre-built input embeddings
from position 0 over the cache (a continuation over the cache buffers, so
its attention takes K3, as crane_tpu's cached route does), then greedy
one-token decode steps over the cache (K1). crane_tpu jits both; here the
decode step, the part a generation repeats, is one replay of a CUDA graph
on the card (``graphs.dispatch``, as ``CausalLM``'s decode blocks are), and
the prefill runs eagerly once a prompt. :func:`greedy_decode_block` is
Qwen3-ASR's ``_asr_decode_block`` (``n_steps`` greedy steps in one
``lax.scan``, crane_tpu/models/qwen3_asr.py:351-367): one replay of one
graph for the whole block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
from crane_tpu_torch.ops.kv_cache import KVCache
from crane_tpu_torch.utils.buckets import bucket_length


def splice_prompt(embed: torch.Tensor, input_ids, token_id: int, feats, dtype):
    """The prompt's embeddings ``[1, S_bucket, E]`` in ``dtype``, gathered
    from the table ``embed``, with ``feats [n, E]`` (if given) over the n
    positions that hold ``token_id``, padded to the 64-floor bucket; and S.
    A count of placeholders other than n raises ``ValueError``."""
    ids = np.asarray(list(input_ids), np.int64)
    S = len(ids)
    embeds = embed[torch.as_tensor(ids, device=embed.device)][None].to(dtype)
    if feats is not None:
        (pos,) = np.where(ids == token_id)
        if len(pos) != feats.shape[0]:
            raise ValueError(f"{len(pos)} placeholder tokens for {feats.shape[0]} features")
        embeds[0, torch.as_tensor(pos, device=embed.device)] = feats.to(dtype)
    return F.pad(embeds, (0, 0, 0, bucket_length(S, floor=64) - S)), S


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


@torch.no_grad()
def greedy_decode_step(programs: dict, cfg, params, rope, cache, token: torch.Tensor):
    """token ``[B]`` int32 -> (the greedy next token ``[B]`` int32, cache
    with its lengths rolled in place): a block of one step
    (:func:`greedy_decode_block`), one replay of a program kept in the
    model's ``programs`` dict on the card (captured on the first call over
    these cache buffers); on the CPU and under ``graphs.eager()`` it runs
    eagerly."""
    out, cache = greedy_decode_block(programs, cfg, params, rope, cache, token, 1)
    return out[:, 0], cache


def _greedy_block_body(cfg, params, rope, *, layers, n_steps, tokens, lengths, active, out):
    """``n_steps`` greedy steps from ``tokens [B]``: step i's tokens into
    ``out[:, i]``, the active rows' ``lengths`` rolled in place."""
    cache = KVCache(layers=layers, lengths=lengths)
    toks = tokens
    for i in range(n_steps):
        hidden, cache = forward_hidden(cfg, params, toks[:, None], cache, cache.lengths, rope,
                                       active=active)
        toks = torch.argmax(lm_logits(cfg, params, hidden)[:, 0], -1).to(torch.int32)
        out[:, i] = toks
    lengths.copy_(cache.lengths)


@torch.no_grad()
def greedy_decode_block(programs: dict, cfg, params, rope, cache, token: torch.Tensor,
                        n_steps: int):
    """token ``[B]`` int32 -> (the next ``n_steps`` greedy tokens ``[B,
    n_steps]`` int32, cache with its lengths rolled by ``n_steps`` in
    place). On the card the block is one replay of a program (kind
    ``greedy_block``) kept in ``programs``; on the CPU and under
    ``graphs.eager()`` it runs eagerly. The caller checks for EOS once a
    block, so the cache must hold ``n_steps`` slots past the last one kept."""
    B = token.shape[0]
    inputs = dict(tokens=token, lengths=cache.lengths,
                  active=torch.ones((B,), dtype=torch.bool, device=token.device))
    body = functools.partial(_greedy_block_body, cfg, params, rope)
    out = graphs.dispatch(programs, token.device, "greedy_block", body, cache, inputs,
                          {"out": ((B, n_steps), torch.int32)}, n_steps=n_steps)["out"]
    return out, cache
