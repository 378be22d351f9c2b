"""Generic causal-LM driver: prefill, decode steps and generate.

Port of ``crane_tpu/models/causal_lm.py``. JAX ran each step as one jitted
program over donated buffers; the port runs decode blocks as CUDA graphs
(below), the serving engine's slot prefills too where the model lets it
(:meth:`CausalLM.prefill_graphs`), other prefills eagerly, and the cache
buffers are written in place by the
layers (the returned cache shares them and carries
the new lengths). Forward, logits, repetition penalty and sampling stay on
the device; only sampled token ids cross to the host, for streaming and EOS
checks.

Shape discipline is kept as in the reference: prompts are padded to
power-of-two buckets (``utils/buckets.py``, a copy of crane_tpu's) and caches are
allocated once at a bucketed max length. Pad tokens sit past each row's true
length and are causally masked until decode overwrites them; every prefill
hands the true lengths to ``forward_hidden``, so GDN layers keep the pad
steps out of their recurrent state and conv window.

Decode blocks (``decode_steps``, ``decode_active``, ``decode_active_hist``)
and speculative decoding (``ngram_propose`` / ``device_ngram_propose``,
``verify_step`` / ``verify_active`` / ``verify_slot``, ``spec_rounds``)
port crane_tpu's functions of the same names. On the card each block is one
CUDA-graph replay, the counterpart of one jitted ``lax.scan``
(:mod:`crane_tpu_torch.models.graphs`); on the CPU the same block functions
run eagerly. A block updates the cache's ``lengths``, the ``recent`` rings
and the ``history`` rows in place. ``generate(speculative="ngram")`` runs
only for greedy, penalty-free configs on models without recurrent layers,
as crane_tpu's gate says; any other config takes plain decoding.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.fuse import fuse_params
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    lm_logits,
    make_cache,
    make_rope_tables,
)
from crane_tpu_torch.ops.kv_cache import KVCache, LayerKVCache
from crane_tpu_torch.ops.sampling import SamplingParams, sample, update_recent
from crane_tpu_torch.parallel.sharding import ShardedParams
from crane_tpu_torch.utils import tracing


def _greedy_accept(logits: torch.Tensor, tokens: torch.Tensor):
    """(model_tok ``[B, K+1]``, n_accept ``[B]``) int32: the argmax at each
    position, and the longest prefix where it equals the next draft."""
    model_tok = logits.argmax(-1).to(torch.int32)
    match = (model_tok[:, :-1] == tokens[:, 1:]).to(torch.int32)
    return model_tok, match.cumprod(dim=1).sum(dim=1).to(torch.int32)


def ngram_propose(history: list, n: int, k: int, pad: int = 0) -> list:
    """Prompt-lookup draft: continuation of the most recent earlier
    occurrence of the trailing ``n``-gram of ``history`` whose full k-token
    continuation exists, else the most recent occurrence of any kind;
    ``pad``-filled to exactly ``k`` tokens (the verify forward is
    fixed-shape; unmatched pads are simply rejected). The full-window
    preference mirrors :func:`device_ngram_propose`: on a period-p cycle the
    most recent occurrence only carries p real continuation tokens."""
    if len(history) > n:
        tail = history[-n:]
        best = None
        for i in range(len(history) - n - 1, -1, -1):
            if history[i: i + n] == tail:
                if best is None:
                    best = i  # most recent match of any kind (fallback)
                if i + n + k <= len(history):
                    best = i  # most recent full-window match wins
                    break
        if best is not None:
            cont = history[best + n: best + n + k]
            return cont + [pad] * (k - len(cont))
    return [pad] * k


def device_ngram_propose(history: torch.Tensor, hist_len: torch.Tensor, n: int,
                         k: int) -> torch.Tensor:
    """Vectorized prompt lookup over a device history buffer, the
    counterpart of :func:`ngram_propose` (the same draft for the same
    history). ``history [B, H]`` int32 token rows, ``hist_len [B]`` valid
    counts. Returns drafts ``[B, k]`` int32: the continuation of the most
    recent strictly earlier occurrence of each row's trailing ``n``-gram
    whose full k-token continuation lies inside the valid region, else the
    most recent occurrence of any kind (0-padded past the valid end), else
    zeros. ``n`` shifted compares over ``[B, H]``, with no host read."""
    B, H = history.shape
    dev = history.device
    hist_len = hist_len.long()[:, None]
    pos = hist_len - n + torch.arange(n, device=dev)[None, :]
    tail = history.gather(1, pos.clamp(0, H - 1))
    W = H - n + 1
    match = torch.ones((B, W), dtype=torch.bool, device=dev)
    for i in range(n):
        match &= history[:, i:W + i] == tail[:, i:i + 1]
    p_idx = torch.arange(W, device=dev)[None, :]
    # strictly earlier: the window ending at the tail itself (p = L - n) and
    # anything past the valid region never match
    match &= p_idx <= hist_len - n - 1
    full = match & (p_idx <= hist_len - n - k)  # continuation fully valid
    cand = torch.where(full.any(dim=1, keepdim=True), full, match)
    has = match.any(dim=1, keepdim=True)
    p = torch.where(cand, p_idx, -1).argmax(dim=1, keepdim=True)  # most recent
    didx = p + n + torch.arange(k, device=dev)[None, :]
    drafts = history.gather(1, didx.clamp(0, H - 1))
    ok = has & (didx < hist_len) & (hist_len > n)
    return torch.where(ok, drafts, 0).to(torch.int32)


def prompt_ids_error(ids, vocab_size: int) -> str | None:
    """Why ``ids`` cannot be a prompt, or None: a prompt is a flat sequence
    of integers in ``[0, vocab_size)``. Checked on the host, before the
    embedding gather: on the card an index past the table is a device-side
    assert, which leaves the process's CUDA context unusable. (``crane_tpu``
    clamps such an id into the table instead; the port refuses it.)"""
    arr = np.asarray(ids)
    if arr.ndim != 1 or (arr.size and arr.dtype.kind not in "iu"):
        return "prompt ids must be a flat list of integers"
    bad = (arr < 0) | (arr >= vocab_size)
    if bad.any():
        i = int(np.argmax(bad))
        return f"prompt id {int(arr[i])} at position {i} lies outside the vocabulary [0, {vocab_size})"
    return None


class CausalLM:
    """A loaded model: static config + parameter tree + step functions."""

    # the devices of a sequence-parallel model's slabs (parallel/sequence.py)
    # or of a tensor/data-parallel model's shards (parallel/inference.py);
    # none for one device
    mesh: tuple = ()

    def __init__(
        self,
        config: TransformerConfig,
        params: dict,
        *,
        tokenizer=None,
        eos_token_ids: Sequence[int] = (),
        dtype: torch.dtype = torch.bfloat16,
        fuse: bool | None = None,
    ):
        """``fuse`` joins each layer's wq|wk|wv and gate|up into one product
        each (:mod:`crane_tpu_torch.models.fuse`); ``None`` reads
        ``CRANE_FUSE_PROJ`` (``"1"`` fuses; off by default, as in
        crane_tpu). A tensor-parallel model passes ``False`` after
        unfusing: its shards split q, k and v by heads."""
        if fuse is None:
            fuse = os.environ.get("CRANE_FUSE_PROJ", "0") == "1"
        if fuse:
            params = fuse_params(params)
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.eos_token_ids = tuple(eos_token_ids)
        self.dtype = dtype
        self.device = params.device if isinstance(params, ShardedParams) else params["embed"].device
        self.rope = make_rope_tables(config, device=self.device)
        self._programs: dict = {}  # captured decode blocks and prefills (models/graphs.py)
        self._prefill_pool = None  # the memory pool the prefill programs share
        self._generate_caches: dict = {}

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
        with tracing.span("model.prefill", tokens=int(np.sum(true_lengths)),
                          bucket=tokens.numel()):
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
        other row is touched. Returns (last-token logits ``[1, V]``, cache).
        Where :meth:`prefill_graphs` holds, one CUDA-graph replay."""
        graph = self.prefill_graphs(cache)
        with tracing.span("model.prefill", tokens=true_length, bucket=np.shape(token_ids)[-1],
                          graph=int(graph)):
            if graph:
                logits = self._prefill_replay(cache, token_ids, slot, 0, true_length, True)
                new_cache = KVCache(layers=cache.layers, lengths=cache.lengths)
            else:
                hidden, new_cache = forward_hidden(
                    self.config, self.params, self._ids(token_ids), cache, 0, self.rope,
                    read_cache=False, cache_row=slot, true_lengths=self._ids([true_length]),
                )
                last = hidden[0, true_length - 1]
                logits = lm_logits(self.config, self.params, last[None, None])[:, 0]
            new_cache.lengths = cache.lengths.clone()
            # fill_ on a slice: a Python number set at an index would copy
            # from the host and wait for the card
            new_cache.lengths[slot:slot + 1].fill_(true_length)
            return logits, new_cache

    @torch.no_grad()
    def prefill_slot_continue(self, cache: KVCache, token_ids, slot: int,
                              start: int, true_length: int):
        """Write a continuation chunk ``token_ids [1, S_bucket]`` at
        positions ``start..`` of row ``slot`` (chunked admission and prefix
        reuse); it attends the row's live context and continues the row's
        GDN states. JAX sliced the row out and merged it back; here the
        layers write through a batch-1 view of the row, in place (or, where
        :meth:`prefill_graphs` holds, one CUDA-graph replay writes and reads
        the row it is given on the device). Returns logits at the chunk's
        last real token."""
        graph = self.prefill_graphs(cache)
        with tracing.span("model.prefill", tokens=true_length, bucket=np.shape(token_ids)[-1],
                          graph=int(graph)):
            if graph:
                logits = self._prefill_replay(cache, token_ids, slot, start, true_length, False)
            else:
                hidden, _ = forward_hidden(
                    self.config, self.params, self._ids(token_ids), cache.row(slot),
                    start, self.rope, true_lengths=self._ids([true_length]),
                )
                last = hidden[0, true_length - 1]
                logits = lm_logits(self.config, self.params, last[None, None])[:, 0]
            lengths = cache.lengths.clone()
            lengths[slot:slot + 1].fill_(start + true_length)
            return logits, KVCache(layers=cache.layers, lengths=lengths)

    # -- slot prefills as CUDA graphs -----------------------------------------
    # The engine's admissions (prefill_slot, prefill_slot_continue) replay
    # one program per (kind, bucket): the slot, the start and the true
    # length are device inputs, so warmup's captures serve every slot.

    def prefill_graphs(self, cache: KVCache) -> bool:
        """True when slot prefills over ``cache`` run as CUDA-graph
        replays: the model takes graphs on its device (``graphs.takes_graphs``:
        the card, one device, outside ``graphs.eager()``), every layer is
        full attention over an fp cache (:class:`LayerKVCache`), and no
        layer has experts. A GDN or short-conv layer, a sliding window, an
        int8/int4 cache, a mesh or the CPU keep the eager prefill."""
        cfg = self.config
        return (graphs.takes_graphs(self.device, self.mesh) and not self.mesh
                and cfg.num_experts == 0
                and all(cfg.layer_type(i) == "full" for i in range(cfg.num_layers))
                and all(type(layer) is LayerKVCache for layer in cache.layers))

    def _prefill_body(self, *, layers, fresh, tokens, meta, active, logits):
        """A slot prefill of ``tokens [1, S]`` into row ``meta[0]`` from
        position ``meta[1]`` (``fresh``: 0, K2 over the in-context K/V;
        else K3 over the row's live context), ``meta[2]`` of its tokens
        real; the head's logits at the last real token go to ``logits
        [1, V]``. With ``active`` false (the capture) no slot is written."""
        slot, start, n = meta[0:1], meta[1:2], meta[2:3]
        hidden, _ = forward_hidden(self.config, self.params, tokens,
                                   KVCache(layers=layers, lengths=start), start, self.rope,
                                   read_cache=not fresh, cache_row=slot, active=active)
        last = hidden[0].index_select(0, (n - 1).long())
        logits.copy_(lm_logits(self.config, self.params, last[None])[:, 0])

    def _prefill_replay(self, cache, token_ids, slot, start, true_length, fresh):
        """Logits ``[1, V]`` of one replay of the (``fresh``, bucket)
        prefill program, captured at its first call. The tokens, slot,
        start and length reach the card in one copy from pinned memory,
        queued behind the stream's work: nothing here waits for the card."""
        if isinstance(token_ids, torch.Tensor):
            token_ids = token_ids.cpu()
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        S, T = ids.shape[0], cache.max_seq
        if not (0 <= slot < cache.lengths.shape[0] and 0 < true_length <= S
                and 0 <= start and start + S <= T):
            raise ValueError(f"prefill of {true_length} in a bucket of {S} at [{start}, "
                             f"{start + S}) of slot {slot}: outside the cache")
        if self._prefill_pool is None:
            self._prefill_pool = graphs.new_pool(self.device)
        host = torch.from_numpy(np.concatenate([ids, np.array([slot, start, true_length],
                                                              np.int32)]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        inputs = dict(tokens=dev[:S].view(1, S), meta=dev[S:],
                      active=torch.ones((1,), dtype=torch.bool, device=self.device))
        kind = "prefill" if fresh else "prefill_continue"
        return graphs.dispatch(self._programs, self.device, kind, self._prefill_body, cache,
                               inputs, {"logits": ((1, self.config.vocab_size), torch.float32)},
                               mesh=self.mesh, pool=self._prefill_pool, fresh=fresh)["logits"]

    # -- decode blocks -------------------------------------------------------
    # Each block is one function of tensors (the ``_*_body`` methods below):
    # it reads its inputs, writes its outputs and the in/out state in place,
    # and closes over the cache layers. On the card ``graphs.dispatch`` runs
    # it as a CUDA graph program, elsewhere eagerly.

    def _mask(self, active, batch: int) -> torch.Tensor:
        """``active`` as a device bool ``[B]`` (``None``: every row)."""
        if active is None:
            return torch.ones((batch,), dtype=torch.bool, device=self.device)
        if isinstance(active, torch.Tensor):
            return active.to(device=self.device, dtype=torch.bool)
        return torch.as_tensor(np.asarray(active, bool), device=self.device)

    def release_graphs(self) -> None:
        """Drop the captured programs, their graphs' memory pools and the
        caches and generators they hold, ``generate``'s own included. Every
        new cache or generator a caller hands a decode block captures new
        programs, kept until this call."""
        self._programs.clear()
        self._prefill_pool = None
        self._generate_caches.clear()

    def _decode_body(self, *, layers, generator, n_steps, tokens, lengths, recent, active,
                     out, temperature, top_k, top_p, repetition_penalty, do_sample,
                     history=None):
        """``n_steps`` masked decode rounds (``_decode_active``; with
        ``history``, ``_decode_active_hist``): inactive rows compute garbage
        that is masked out, their KV writes are dropped and their lengths,
        recent rings, current tokens and history stay put. Each sampled
        token goes to ``out[:, i]`` and, at the row's post-step length, to
        its history row."""
        sp = SamplingParams(temperature, top_k, top_p, repetition_penalty, do_sample)
        cache = KVCache(layers=layers, lengths=lengths)
        toks, rec, hist = tokens, recent, history
        for i in range(n_steps):
            hidden, cache = forward_hidden(self.config, self.params, toks[:, None], cache,
                                           cache.lengths, self.rope, active=active)
            logits = lm_logits(self.config, self.params, hidden)[:, 0]
            nxt = torch.where(active, sample(logits, sp, rec, generator), toks)
            rec = torch.where(active[:, None], update_recent(rec, nxt), rec)
            if hist is not None:
                col = cache.lengths.clamp(0, hist.shape[1] - 1).long()[:, None]
                hist = torch.where(active[:, None], hist.scatter(1, col, nxt[:, None]), hist)
            out[:, i] = nxt
            toks = nxt
        lengths.copy_(cache.lengths)
        recent.copy_(rec)
        if history is not None:
            history.copy_(hist)

    def _verify_body(self, *, layers, tokens, lengths, active, model_tok, n_accept):
        """Speculative verify (``_verify_body`` / ``_verify_active``):
        ``tokens [B, K+1]`` = [cur, d1..dK] written and attended at positions
        ``lengths..lengths+K``. One forward scores every draft; greedy
        acceptance is the longest prefix where the model's argmax equals the
        next draft. Emitted tokens are ``model_tok[:n_accept+1]``, what K+1
        sequential greedy steps give; active rows' lengths roll to
        ``lengths + n_accept + 1`` (rejected drafts' KV lies past it, masked
        and later overwritten), inactive rows' stay and write nothing."""
        hidden, _ = forward_hidden(self.config, self.params, tokens,
                                   KVCache(layers=layers, lengths=lengths), lengths,
                                   self.rope, active=active)
        tok, acc = _greedy_accept(lm_logits(self.config, self.params, hidden), tokens)
        lengths.copy_(torch.where(active, lengths + acc + 1, lengths))
        model_tok.copy_(tok)
        n_accept.copy_(acc)

    def _spec_body(self, *, layers, n_rounds, k, ngram_n, lengths, history, active, out_tok,
                   out_acc):
        """``n_rounds`` chained speculative rounds (``_spec_rounds``): each
        drafts on the device from the history rows
        (:func:`device_ngram_propose`), verifies with one forward, accepts
        the longest matching prefix and appends all ``k + 1`` scored tokens
        to the history at ``lengths + 1`` (the columns past the acceptance
        point lie beyond the new valid count). Row b of ``history`` holds
        ``lengths[b] + 1`` valid tokens; the caller guarantees
        ``lengths + n_rounds * (k + 1) + 1`` fits the cache and the history
        for every active row."""
        H = history.shape[1]
        cols = torch.arange(k + 1, device=history.device)[None, :]
        cur_len, hist = lengths, history
        for r in range(n_rounds):
            hist_len = cur_len + 1
            drafts = device_ngram_propose(hist, hist_len, ngram_n, k)
            cur = hist.gather(1, cur_len.clamp(0, H - 1).long()[:, None])
            toks = torch.cat([cur, drafts], dim=1)
            hidden, _ = forward_hidden(self.config, self.params, toks,
                                       KVCache(layers=layers, lengths=cur_len), cur_len,
                                       self.rope, active=active)
            tok, acc = _greedy_accept(lm_logits(self.config, self.params, hidden), toks)
            cur_len = torch.where(active, cur_len + acc + 1, cur_len)
            # dynamic_update_slice's start: clamped so the k + 1 columns fit
            at = hist_len.clamp(0, H - (k + 1)).long()[:, None] + cols
            hist = torch.where(active[:, None], hist.scatter(1, at, tok), hist)
            out_tok[r] = tok
            out_acc[r] = acc
        lengths.copy_(cur_len)
        history.copy_(hist)

    @torch.no_grad()
    def decode_step(self, cache, tokens, recent, sp: SamplingParams, generator):
        """One batched decode step: ``tokens [B]`` -> sampled next ``[B]``."""
        out, cache, recent = self.decode_steps(cache, tokens, recent, sp, generator, 1)
        return out[:, 0], cache, recent

    @torch.no_grad()
    def decode_steps(self, cache, tokens, recent, sp: SamplingParams, generator,
                     n_steps: int):
        """``n_steps`` decode rounds over every row; returns (tokens
        ``[B, n_steps]``, cache, recent). EOS is checked on the host after
        the block. The cache's lengths and ``recent`` are updated in place."""
        return self.decode_active(cache, tokens, recent, sp, generator, None, n_steps)

    @torch.no_grad()
    def decode_active(self, cache, tokens, recent, sp, generator, active,
                      n_steps: int):
        """``n_steps`` batched decode rounds over all slots with an activity
        mask ``active [B]`` (a device bool tensor, or ``None``: every row).
        Inactive rows compute garbage that is masked out: their KV writes are
        dropped, their lengths, recent rings and current tokens stay put.
        Returns (tokens ``[B, n_steps]``, cache, recent); the cache's lengths
        and ``recent`` are updated in place."""
        out, cache, recent, _ = self._decode(cache, tokens, recent, sp, generator, active,
                                             n_steps, None)
        return out, cache, recent

    @torch.no_grad()
    def decode_active_hist(self, cache, tokens, recent, sp, generator, active,
                           n_steps: int, history):
        """:meth:`decode_active` that also writes each sampled token into the
        speculative history rows ``history [B, H]`` at the row's post-step
        length (row b keeps ``lengths[b] + 1`` valid tokens), so speculative
        rounds after plain blocks draft from current history. Returns
        (tokens, cache, recent, history), ``history`` updated in place."""
        return self._decode(cache, tokens, recent, sp, generator, active, n_steps, history)

    def _decode(self, cache, tokens, recent, sp, generator, active, n_steps, history,
                copy_out=True):
        toks = self._ids(tokens)
        B = toks.shape[0]
        inputs = dict(tokens=toks, lengths=cache.lengths, recent=recent,
                      active=self._mask(active, B), **vars(sp))
        if history is not None:
            inputs["history"] = history
        out = graphs.dispatch(self._programs, self.device, "decode", self._decode_body, cache,
                              inputs, {"out": ((B, n_steps), torch.int32)},
                              generator=generator, copy_out=copy_out, mesh=self.mesh,
                              n_steps=n_steps)["out"]
        return out, cache, recent, history

    @torch.no_grad()
    def verify_step(self, cache, tokens):
        """Speculative verify of ``tokens [B, K+1]`` over every row; returns
        (model_tok ``[B, K+1]``, n_accept ``[B]``, cache)."""
        return self.verify_active(cache, tokens, None)

    @torch.no_grad()
    def verify_active(self, cache, tokens, active):
        """Batched speculative verify over all slots with an activity mask:
        ``tokens [B, K+1]`` = per-row [cur, d1..dK]. Returns (model_tok
        ``[B, K+1]``, n_accept ``[B]``, cache); the cache's lengths roll in
        place."""
        toks = self._ids(tokens)
        B, S = toks.shape
        inputs = dict(tokens=toks, lengths=cache.lengths, active=self._mask(active, B))
        res = graphs.dispatch(self._programs, self.device, "verify", self._verify_body, cache,
                              inputs, {"model_tok": ((B, S), torch.int32),
                                       "n_accept": ((B,), torch.int32)}, mesh=self.mesh)
        return res["model_tok"], res["n_accept"], cache

    @torch.no_grad()
    def verify_slot(self, cache, tokens, slot: int):
        """Speculative verify of ``tokens [1, K+1]`` for row ``slot`` of a
        multi-slot cache: the batched verify with only that row active.
        Returns (model_tok ``[1, K+1]``, n_accept ``[1]``, cache)."""
        toks = self._ids(tokens)
        B = cache.lengths.shape[0]
        rows = torch.zeros((B, toks.shape[1]), dtype=torch.int32, device=self.device)
        rows[slot] = toks[0]
        active = torch.arange(B, device=self.device) == slot
        model_tok, n_acc, cache = self.verify_active(cache, rows, active)
        return model_tok[slot:slot + 1], n_acc[slot:slot + 1], cache

    @torch.no_grad()
    def spec_rounds(self, cache, history, active, n_rounds: int, k: int, ngram_n: int):
        """``n_rounds`` chained propose/verify rounds in one block (see
        :meth:`_spec_body`). Returns (model_tok ``[n_rounds, B, k+1]``,
        n_accept ``[n_rounds, B]``, cache, history); the host emits
        ``model_tok[r, b, :n_accept[r, b] + 1]`` per round, byte-identical to
        sequential greedy decoding. Lengths and ``history`` roll in place."""
        B = history.shape[0]
        inputs = dict(lengths=cache.lengths, history=history, active=self._mask(active, B))
        res = graphs.dispatch(self._programs, self.device, "spec", self._spec_body, cache,
                              inputs, {"out_tok": ((n_rounds, B, k + 1), torch.int32),
                                       "out_acc": ((n_rounds, B), torch.int32)},
                              mesh=self.mesh, n_rounds=n_rounds, k=k, ngram_n=ngram_n)
        return res["out_tok"], res["out_acc"], cache, history

    def _generate_cache(self, max_seq: int, quant_bits: int | None):
        """``generate``'s batch-1 cache and generator for this shape, kept
        across calls (so a second call of the same shape replays the
        programs the first captured, as a jitted function compiles once)."""
        key = (max_seq, quant_bits)
        if key not in self._generate_caches:
            self._generate_caches[key] = (
                self.init_cache(1, max_seq, quant_bits=quant_bits),
                torch.Generator(device=self.device))
        return self._generate_caches[key]

    # -- high-level generate (single sequence, streaming) --------------------
    def generate(
        self,
        input_ids: Sequence[int],
        gen: GenerationConfig | None = None,
        streamer=None,
    ) -> list[int]:
        """Greedy or sampled generation of one sequence, streamed in decode
        blocks of ``gen.decode_block`` tokens. A prompt id outside the
        vocabulary raises ``ValueError`` (:func:`prompt_ids_error`). The batch-1 cache (and on the
        card the captured blocks) is kept per (max_seq, kv bits) across
        calls, so calls on one model must not overlap; these caches stay on
        the device until :meth:`release_graphs`, outside any engine's
        memory budget."""
        gen = gen or GenerationConfig()
        err = prompt_ids_error(input_ids, self.config.vocab_size)
        if err:
            raise ValueError(err)
        eos = set(gen.eos_token_ids) | set(self.eos_token_ids)
        # speculative decoding is exact only for greedy, penalty-free configs
        # on purely positional caches (a recurrent state cannot roll back
        # past rejected drafts); any other config takes plain decoding
        use_spec = (
            gen.speculative == "ngram"
            and not gen.do_sample
            and gen.repetition_penalty == 1.0
            and not self.config.has_recurrent_layers
        )
        prompt_len = len(input_ids)
        total = prompt_len + gen.max_new_tokens + (gen.spec_k + 1 if use_spec else 0)
        max_seq = bucket_length(total, floor=256)
        cache, generator = self._generate_cache(max_seq, gen.kv_quant_bits)
        cache.lengths.zero_()  # a fresh prefill from position 0 overwrites the rest
        generator.manual_seed(gen.seed)

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

        t0 = time.perf_counter()
        logits, cache = self.prefill(cache, padded, [prompt_len])
        first = sample(logits, sp, recent, generator)
        recent = update_recent(recent, first)
        tok = int(first[0])
        t_prefill = time.perf_counter() - t0

        # decode in blocks of `decode_block` tokens: one dispatch and one host
        # round trip per block, EOS checked after it
        block = max(1, gen.decode_block)
        out: list[int] = [tok]
        stopped = tok in eos or (streamer is not None and streamer.append(tok) is False)
        t1 = time.perf_counter()
        cur = first
        history = list(input_ids) + out
        while not stopped and len(out) < gen.max_new_tokens:
            if use_spec:
                # prompt-lookup speculative step: K drafts verified in one
                # forward; emits 1..K+1 tokens for one weight pass
                drafts = ngram_propose(history, gen.spec_ngram, gen.spec_k)
                model_tok, n_acc, cache = self.verify_step(cache, [[history[-1]] + drafts])
                emitted = model_tok[0, : int(n_acc[0]) + 1].tolist()
            else:
                toks, cache, recent = self.decode_steps(cache, cur, recent, sp, generator, block)
                emitted = toks[0].tolist()
                cur = toks[:, -1]
            for t in emitted:
                out.append(t)
                history.append(t)
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
