"""Generic causal-LM driver: prefill, decode steps and generate.

Port of ``crane_tpu/models/causal_lm.py``. JAX ran each step as one jitted
program over donated buffers; PyTorch runs eagerly, and the cache buffers are
written in place by the layers (the returned cache shares them and carries
the new lengths). Forward, logits, repetition penalty and sampling stay on
the device; only sampled token ids cross to the host, for streaming and EOS
checks.

Shape discipline is kept as in the reference: prompts are padded to
power-of-two buckets (``utils/buckets.py``, a copy of crane_tpu's) and caches are
allocated once at a bucketed max length. Pad tokens sit past each row's true
length and are causally masked until decode overwrites them; every prefill
hands the true lengths to ``forward_hidden``, so GDN layers keep the pad
steps out of their recurrent state and conv window.

Speculative decoding (``GenerationConfig.speculative``) is not ported yet
(ROADMAP Queue 1 item 6) and raises.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    lm_logits,
    make_cache,
    make_rope_tables,
)
from crane_tpu_torch.ops.kv_cache import KVCache
from crane_tpu_torch.ops.sampling import SamplingParams, sample, update_recent


class CausalLM:
    """A loaded model: static config + parameter tree + step functions."""

    def __init__(
        self,
        config: TransformerConfig,
        params: dict,
        *,
        tokenizer=None,
        eos_token_ids: Sequence[int] = (),
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.eos_token_ids = tuple(eos_token_ids)
        self.dtype = dtype
        self.device = params["embed"].device
        self.rope = make_rope_tables(config, device=self.device)

    def _ids(self, token_ids) -> torch.Tensor:
        if isinstance(token_ids, torch.Tensor):
            return token_ids.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(token_ids, np.int32), device=self.device)

    # -- cache management ----------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, *, quant_bits: int | None = None,
                   device=None) -> KVCache:
        """``device="meta"`` sizes a cache without allocating it."""
        return make_cache(self.config, batch, max_seq, self.dtype,
                          quant_bits=quant_bits, device=device or self.device)

    # -- low-level steps -----------------------------------------------------
    @torch.no_grad()
    def prefill(self, cache: KVCache, token_ids, true_lengths, start: int = 0):
        """token_ids ``[B, S_bucket]`` (padded) written at ``start..``.
        Returns (last-token logits ``[B, V]`` f32, cache). ``start == 0`` is
        a fresh prefill that attends the in-context K/V (K2); a later start
        attends the cache buffers (K3) and continues the GDN states."""
        tokens = self._ids(token_ids)
        true_lengths = self._ids(true_lengths)
        hidden, new_cache = forward_hidden(
            self.config, self.params, tokens, cache, start, self.rope,
            read_cache=start != 0, true_lengths=true_lengths,
        )
        new_cache.lengths = cache.lengths + true_lengths
        b = torch.arange(tokens.shape[0], device=self.device)
        last = hidden[b, (true_lengths - 1).long()]  # the chunk's last real token
        return lm_logits(self.config, self.params, last[:, None])[:, 0], new_cache

    @torch.no_grad()
    def prefill_slot(self, cache: KVCache, token_ids, slot: int, true_length: int):
        """Prefill ``token_ids [1, S_bucket]`` into row ``slot`` of a
        multi-slot serving cache. Attention reads the in-context K/V, so no
        other row is touched. Returns (last-token logits ``[1, V]``, cache)."""
        hidden, new_cache = forward_hidden(
            self.config, self.params, self._ids(token_ids), cache, 0, self.rope,
            read_cache=False, cache_row=slot, true_lengths=self._ids([true_length]),
        )
        new_cache.lengths = cache.lengths.clone()
        new_cache.lengths[slot] = true_length
        last = hidden[0, true_length - 1]
        return lm_logits(self.config, self.params, last[None, None])[:, 0], new_cache

    @torch.no_grad()
    def prefill_slot_continue(self, cache: KVCache, token_ids, slot: int,
                              start: int, true_length: int):
        """Write a continuation chunk ``token_ids [1, S_bucket]`` at
        positions ``start..`` of row ``slot`` (chunked admission and prefix
        reuse); it attends the row's live context and continues the row's
        GDN states. JAX sliced the row out and merged it back; here the
        layers write through a batch-1 view of the row, in place. Returns
        logits at the chunk's last real token."""
        hidden, _ = forward_hidden(
            self.config, self.params, self._ids(token_ids), cache.row(slot),
            start, self.rope, true_lengths=self._ids([true_length]),
        )
        lengths = cache.lengths.clone()
        lengths[slot] = start + true_length
        last = hidden[0, true_length - 1]
        logits = lm_logits(self.config, self.params, last[None, None])[:, 0]
        return logits, KVCache(layers=cache.layers, lengths=lengths)

    def _decode_one(self, cache, toks, recent, sp, generator, active=None):
        hidden, cache = forward_hidden(
            self.config, self.params, toks[:, None], cache, cache.lengths,
            self.rope, active=active,
        )
        logits = lm_logits(self.config, self.params, hidden)[:, 0]
        nxt = sample(logits, sp, recent, generator)
        if active is None:
            return nxt, cache, update_recent(recent, nxt)
        nxt = torch.where(active, nxt, toks)
        recent = torch.where(active[:, None], update_recent(recent, nxt), recent)
        return nxt, cache, recent

    @torch.no_grad()
    def decode_step(self, cache, tokens, recent, sp: SamplingParams, generator):
        """One batched decode step: ``tokens [B]`` -> sampled next ``[B]``."""
        return self._decode_one(cache, self._ids(tokens), recent, sp, generator)

    @torch.no_grad()
    def decode_steps(self, cache, tokens, recent, sp: SamplingParams, generator,
                     n_steps: int):
        """``n_steps`` decode rounds; returns (tokens ``[B, n_steps]``,
        cache, recent). EOS is checked on the host after the block."""
        return self.decode_active(cache, tokens, recent, sp, generator, None, n_steps)

    @torch.no_grad()
    def decode_active(self, cache, tokens, recent, sp, generator, active,
                      n_steps: int):
        """``n_steps`` batched decode rounds over all slots with an activity
        mask ``active [B]`` (or ``None``: every row). Inactive rows compute
        garbage that is masked out: their KV writes are dropped, their
        lengths, recent rings and current tokens stay put."""
        toks = self._ids(tokens)
        if active is not None:
            active = torch.as_tensor(np.asarray(active), dtype=torch.bool, device=self.device)
        out = []
        for _ in range(n_steps):
            toks, cache, recent = self._decode_one(cache, toks, recent, sp, generator, active)
            out.append(toks)
        return torch.stack(out, dim=1), cache, recent

    # -- high-level generate (single sequence, streaming) --------------------
    def generate(
        self,
        input_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        streamer=None,
    ) -> list[int]:
        gen = gen or GenerationConfig()
        if gen.speculative is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP Queue 1 item 6)")
        eos = set(gen.eos_token_ids) | set(self.eos_token_ids)
        prompt_len = len(input_ids)
        max_seq = bucket_length(prompt_len + gen.max_new_tokens, floor=256)
        cache = self.init_cache(1, max_seq, quant_bits=gen.kv_quant_bits)

        sp = SamplingParams.make(
            1, temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
            repetition_penalty=gen.repetition_penalty, do_sample=gen.do_sample,
            device=self.device,
        )
        window = max(gen.repeat_last_n, 1)
        recent = torch.full((1, window), -1, dtype=torch.int32, device=self.device)
        if gen.repetition_penalty != 1.0:
            tail = self._ids(input_ids[-window:])
            recent[0, window - tail.shape[0]:] = tail

        s_bucket = bucket_length(prompt_len, floor=64, ceiling=max_seq)
        padded = np.zeros((1, s_bucket), np.int32)
        padded[0, :prompt_len] = input_ids

        generator = torch.Generator(device=self.device).manual_seed(gen.seed)
        t0 = time.perf_counter()
        logits, cache = self.prefill(cache, padded, [prompt_len])
        first = sample(logits, sp, recent, generator)
        recent = update_recent(recent, first)
        tok = int(first[0])
        t_prefill = time.perf_counter() - t0

        # decode in blocks of `decode_block` tokens: one host round trip per
        # block, EOS checked after it
        block = max(1, gen.decode_block)
        out: list[int] = [tok]
        stopped = tok in eos or (streamer is not None and streamer.append(tok) is False)
        t1 = time.perf_counter()
        cur = first
        while not stopped and len(out) < gen.max_new_tokens:
            toks, cache, recent = self.decode_steps(cache, cur, recent, sp, generator, block)
            cur = toks[:, -1]
            for t in toks[0].tolist():
                out.append(t)
                if streamer is not None and streamer.append(t) is False:
                    stopped = True
                    break
                if t in eos or len(out) >= gen.max_new_tokens:
                    stopped = True
                    break
        out = out[: gen.max_new_tokens]
        t_decode = time.perf_counter() - t1

        if streamer is not None:
            streamer.finalize()
        if gen.report_speed and out:
            dec_tps = (len(out) - 1) / t_decode if t_decode > 0 else float("inf")
            print(
                f"[crane_tpu_torch] prefill {prompt_len} tok in {t_prefill * 1e3:.1f} ms "
                f"({prompt_len / max(t_prefill, 1e-9):.1f} tok/s) | "
                f"decode {len(out)} tok in {t_decode * 1e3:.1f} ms ({dec_tps:.1f} tok/s)"
            )
        return out
