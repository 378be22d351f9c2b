"""Continuous-batching inference engine on static KV slots.

Port of ``crane_tpu/serve/engine.py``. ONE static ``[max_slots, max_seq]``
cache holds every sequence: admission prefills directly into a free slot
row, batched decode runs over all slots with an activity mask, eviction
clears a host-side bit. The scheduler, the per-request sequence state and
the statistics are copies of ``crane_tpu``'s modules (``serve/scheduler.py``,
``serve/sequence.py``, ``serve/stats.py``).

What the engine keeps from the reference:

- chunked admission: prompts longer than ``prefill_chunk`` admit one chunk
  per engine step (the first a fresh slot prefill, K2, which restarts a
  hybrid row's GDN states; the rest continuation chunks, K3, which continue
  them through the row's view), with a decode block for the running
  sequences between chunks;
- cross-request prefix reuse: a freed slot's rows still hold its context,
  and a new prompt that extends it prefills only the unseen suffix (K3);
  off for hybrid models, whose GDN states cannot be re-entered mid-way;
- longest-first preempt-and-requeue under slot starvation;
- the depth-1 decode pipeline: block N's tokens are read back and streamed
  while the device runs block N+1;
- speculative decoding (``speculative="ngram"``): when every running
  sequence decodes greedy and penalty-free, one block runs ``spec_rounds``
  chained propose/verify rounds on the device
  (:meth:`~crane_tpu_torch.models.causal_lm.CausalLM.spec_rounds`) over a
  per-slot token ``history``, gated by the acceptance EMA
  (``spec_min_gain``, ``spec_cooldown``) as crane_tpu gates it.

On the card every decode block, plain or speculative, is one CUDA-graph
replay (:mod:`crane_tpu_torch.models.graphs`), and ``warmup`` captures each
one serving reaches: the block sizes 1 and ``decode_tokens_per_seq``, with
the history rows when speculation can engage, and the speculative rounds.

``kv_quant_bits`` 8 or 4 keeps the slots in an int8 or int4 cache
(decode through K4, continuation chunks through K5). A sequence-parallel
model (:func:`~crane_tpu_torch.parallel.sequence.sp_shard_lm`) is served the
same way: its slots' rows are split into slabs, and every admission, chunk,
preemption, prefix reuse and speculative verify works on the sharded rows.
A tensor/data-parallel model (:func:`~crane_tpu_torch.parallel.inference.shard_lm`)
too: its slots split over the dp groups (``max_slots`` must divide by dp), a
slot prefill goes to the group that holds the row, and every step runs on
each group's tp shards.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from crane_tpu_torch.serve.scheduler import Scheduler
from crane_tpu_torch.serve.sequence import (  # noqa: F401  (EngineRequest, SamplingOptions: re-exported API)
    EngineRequest,
    EngineResponse,
    FinishReason,
    SamplingOptions,
    Sequence,
)
from crane_tpu_torch.serve.stats import EngineStats
from crane_tpu_torch.tokenizer.token_stream import TokenOutputStream
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.models.causal_lm import CausalLM, prompt_ids_error
from crane_tpu_torch.ops.kv_cache import MeshLayerCache, SequenceShardedKVCache
from crane_tpu_torch.ops.linear import QuantizedWeight
from crane_tpu_torch.ops.sampling import SamplingParams, sample, update_recent
from crane_tpu_torch.parallel.sharding import ShardedParams
from crane_tpu_torch.utils import tracing

log = logging.getLogger("crane_tpu_torch.engine")

RECENT_WINDOW = 64  # repetition-penalty window (reference repeat_last_n default)

# Every admission offset (prefix reuse, chunk boundaries) stays a multiple of
# this, and every prefill/continuation bucket is a power of two >= it, so a
# chunk's cache write always fits the buffer. Matches bucket_length's floor.
BUCKET_ALIGN = 64


def _pow2_floor(cap: int, floor: int) -> int:
    """Largest power-of-two-multiple-of-floor bucket <= cap (callers
    guarantee cap >= floor)."""
    b = floor
    while b * 2 <= cap:
        b *= 2
    return b


def _tree_bytes(tree) -> int:
    """Bytes of a parameter tree; a ``QuantizedWeight`` counts its codes
    and scales, a sharded tree every shard's copy."""
    if isinstance(tree, ShardedParams):
        return sum(tree.device_bytes().values())
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, QuantizedWeight):
        return _tree_bytes(tree.tensors())
    return tree.numel() * tree.element_size()


def _weight_bytes(lm) -> dict:
    """Bytes of weights each device holds: a sharded model's shards on their
    devices (copies on a repeated device add up), else all on its device."""
    if isinstance(lm.params, ShardedParams):
        return lm.params.device_bytes()
    return {lm.device: _tree_bytes(lm.params)}


def _device_bytes(lm, cache) -> dict:
    """Bytes each device holds: the weights (:func:`_weight_bytes`), the
    lengths and every whole layer cache on the model's (lead) device, each
    slab of a sequence-sharded layer and each part of a mesh-sharded one on
    its own device."""
    held = _weight_bytes(lm)
    held[lm.device] = held.get(lm.device, 0) + _tree_bytes(cache.lengths)
    for layer in cache.layers:
        if isinstance(layer, SequenceShardedKVCache):
            for slab, dev in zip(layer.slabs, layer.devices):
                held[dev] = held.get(dev, 0) + _tree_bytes(slab.tensors())
        elif isinstance(layer, MeshLayerCache):
            for parts, devs in zip(layer.parts, layer.devices):
                for part, dev in zip(parts, devs):
                    held[dev] = held.get(dev, 0) + _tree_bytes(part.tensors())
        else:
            held[lm.device] += _tree_bytes(layer.tensors())
    return held


def _check_hbm_budget(lm, max_slots: int, max_seq_len: int,
                      kv_quant_bits: int | None, history_cols: int = 0) -> None:
    """Fail fast at startup if weights + the fully committed KV slots can't
    fit device memory (the reference's memory governor, reduced to one
    inequality per device because static slots commit the whole budget up
    front).

    The cache size is exact by construction: the same ``init_cache`` call
    the engine makes next runs on the ``meta`` device, which allocates
    nothing. A sequence-parallel model counts its lead device as the weights
    plus what it holds of the cache, and every other device as its slabs
    (slabs on a repeated device add up); a tensor/data-parallel model counts
    each device's weight shards and cache parts, so weights divide by the tp
    extent only and the KV by dp x tp, as crane_tpu's rule has it (parts on
    a repeated device add up); the speculative ``history`` rows
    (``history_cols`` int32 tokens a slot) count on the lead device. 15%
    headroom covers activations and allocator slack. The limit is the
    device's total memory (``torch.cuda.mem_get_info``) on a CUDA model; ``CRANE_HBM_BYTES``
    overrides it for every device, and on the CPU the check runs only when
    that variable is set."""
    env = os.environ.get("CRANE_HBM_BYTES")
    if not env and lm.device.type != "cuda":
        return
    cache = lm.init_cache(max_slots, max_seq_len, quant_bits=kv_quant_bits, device="meta")
    weights_by = _weight_bytes(lm)
    gib = 1024 ** 3
    held_by = _device_bytes(lm, cache)
    held_by[lm.device] += max_slots * history_cols * 4
    for dev, held in held_by.items():
        limit = int(env) if env else torch.cuda.mem_get_info(dev)[1]
        need = int(held * 1.15)
        w = weights_by.get(dev, 0)
        if need > limit:
            raise RuntimeError(
                f"HBM budget exceeded on {dev}: weights {w / gib:.2f} GiB + cache "
                f"{(held - w) / gib:.2f} GiB ({max_slots} slots x {max_seq_len} tokens, "
                f"{kv_quant_bits or 8 * torch.empty((), dtype=lm.dtype).element_size()}-bit KV) "
                f"x 1.15 headroom = {need / gib:.2f} GiB > device limit {limit / gib:.2f} GiB. "
                f"Reduce max_slots/max_seq_len or use kv_quant_bits=8/4."
            )
        log.info("memory budget on %s: weights %.2f GiB + cache %.2f GiB (x1.15) fits %.2f GiB",
                 dev, w / gib, (held - w) / gib, limit / gib)


class InferenceEngine:
    def __init__(
        self,
        lm: CausalLM,
        *,
        max_slots: int = 8,
        max_seq_len: int = 2048,
        decode_tokens_per_seq: int = 8,
        kv_quant_bits: int | None = None,
        preempt_after_s: float | None = 30.0,
        prefill_chunk: int | None = None,
        speculative: str | None = None,
        spec_k: int = 8,
        spec_ngram: int = 3,
        spec_rounds: int | None = None,
        spec_min_gain: float = 1.1,
        spec_cooldown: int = 32,
        prefix_cache: bool = True,
        prefix_reuse_min: int = 64,
        bucket_align: int = BUCKET_ALIGN,
    ):
        self.lm = lm
        self.max_slots = max_slots
        # round the buffer up to an align multiple: admission offsets are
        # align multiples, so every continuation cap (max_seq - offset) stays
        # an align multiple >= align and every chunk bucket fits the buffer
        self.max_seq_len = -(-max_seq_len // bucket_align) * bucket_align
        self.decode_tokens_per_seq = decode_tokens_per_seq
        # when the oldest waiting request has starved this long with every
        # slot busy, preempt the longest-running sequence and requeue it.
        # None disables preemption.
        self.preempt_after_s = preempt_after_s
        # chunked prefill: prompts longer than this admit in chunks, one per
        # engine step, with a decode block for the running sequences between
        # chunks. None = whole-prompt prefill. Rounded up to the alignment so
        # chunk offsets stay aligned.
        self.align = bucket_align
        if prefill_chunk is not None:
            prefill_chunk = -(-prefill_chunk // self.align) * self.align
        self.prefill_chunk = prefill_chunk
        # speculative decoding ("ngram" = prompt-lookup drafts): when every
        # running sequence decodes greedy and penalty-free, one block runs
        # ``spec_rounds`` chained propose/verify rounds on the device, each
        # emitting 1..spec_k+1 tokens a stream for one weight pass. After a
        # block whose tokens-per-pass EMA falls below spec_min_gain, plain
        # blocks run for spec_cooldown blocks before the next probe. The gate
        # counts tokens per pass and not time, as crane_tpu's does.
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_rounds_n = spec_rounds or decode_tokens_per_seq
        self.spec_min_gain = spec_min_gain
        self.spec_cooldown = spec_cooldown
        self._spec_ema: Optional[float] = None
        self._spec_wait = 0  # plain blocks remaining until the next probe
        # depth-1 decode pipeline: the dispatched-but-unprocessed block
        # (device tokens + n_steps + the slot->seq snapshot at dispatch)
        self._inflight: Optional[tuple] = None
        self._pending: Optional[dict] = None
        # cross-request prefix reuse, gated to purely positional caches:
        # GDN recurrent states and sliding-window layers summarize the past
        # at the END of the sequence, so their rows cannot be re-entered at
        # an arbitrary earlier position
        cfg = lm.config
        self.prefix_cache = bool(prefix_cache) and cfg.gdn is None and (
            cfg.layer_types is None or all(t == "full" for t in cfg.layer_types)
        )
        self.prefix_reuse_min = prefix_reuse_min
        # per-slot token ids whose KV is resident in that slot's rows
        # (recorded at finish/preemption; None once a new occupant writes)
        self._resident: list[Optional[np.ndarray]] = [None] * max_slots

        # per-slot token history for the on-device draft proposal (row b holds
        # lengths[b] + 1 valid tokens; spec_k + 2 columns of margin absorb the
        # last round's k + 1 appended tokens), only when speculation can
        # engage: recurrent-state models never speculate
        spec_on = speculative == "ngram" and not cfg.has_recurrent_layers
        history_cols = self.max_seq_len + spec_k + 2 if spec_on else 0
        _check_hbm_budget(lm, max_slots, self.max_seq_len, kv_quant_bits, history_cols)
        device = lm.device
        self.cache = lm.init_cache(max_slots, self.max_seq_len, quant_bits=kv_quant_bits)
        self.history = (torch.zeros((max_slots, history_cols), dtype=torch.int32, device=device)
                        if spec_on else None)
        self.recent = torch.full((max_slots, RECENT_WINDOW), -1, dtype=torch.int32, device=device)
        self.sp = SamplingParams.make(max_slots, device=device)
        self.cur_tokens = torch.zeros((max_slots,), dtype=torch.int32, device=device)
        # the activity mask on the host (scheduling) and its device mirror
        # (the decode blocks' input), changed together by _set_active
        self.active = np.zeros((max_slots,), bool)
        self.active_mask = torch.zeros((max_slots,), dtype=torch.bool, device=device)
        self.slots: list[Optional[Sequence]] = [None] * max_slots

        self.scheduler = Scheduler(max_running=max_slots)
        self.stats = EngineStats()
        self.request_q: "queue.Queue" = queue.Queue()
        self._abort_ids: set[str] = set()
        self.generator = torch.Generator(device=device).manual_seed(0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- public API (thread-safe) -------------------------------------------
    def submit(self, request: EngineRequest) -> "queue.Queue[EngineResponse]":
        q: "queue.Queue[EngineResponse]" = queue.Queue()
        self.request_q.put(Sequence(request, q))
        return q

    def abort(self, request_id: str):
        with self._lock:
            self._abort_ids.add(request_id)

    def start(self):
        self._thread = threading.Thread(target=self.run, name="engine", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)
        self._flush_inflight()  # deliver any tokens the loop left in flight

    def prefill_buckets(self) -> tuple[list[int], list[int]]:
        """(fresh, continuation) buckets admission can reach: powers of two
        from ``align`` up to the chunk's bucket, or up to ``max_seq_len``
        when there is no chunk (and ``max_seq_len`` itself, where a whole
        prompt's bucket is cut to the buffer); a continuation starts at
        ``align`` or later, so its bucket fits below that."""
        top = self.max_seq_len
        if self.prefill_chunk is not None:
            top = min(top, bucket_length(self.prefill_chunk, floor=self.align))
        pow2, b = [], self.align
        while b <= top:
            pow2.append(b)
            b *= 2
        fresh = pow2 + ([top] if top not in pow2 else [])
        return fresh, [b for b in pow2 if b + self.align <= self.max_seq_len]

    def warmup(self):
        """Run each program serving reaches once (slot prefill, continuation
        chunk, admission sampling, the decode blocks of 1 and
        ``decode_tokens_per_seq`` steps, with the history rows when
        speculation can engage, and the speculative rounds), so the first
        request pays no one-time cost: on a CUDA model that includes
        building the kernels and capturing every decode block's graph and,
        where the model runs slot prefills as graphs
        (``CausalLM.prefill_graphs``), the prefill graph of each bucket
        :meth:`prefill_buckets` gives, the largest first (their shared pool
        then holds one forward of it), so none is captured while serving.
        Every slot is inactive here, so the blocks write nothing; state
        touched by the prefills is reset after."""
        t0 = time.perf_counter()
        fresh, cont = [self.align], [self.align]
        if self.lm.prefill_graphs(self.cache):
            fresh, cont = self.prefill_buckets()
        for b in sorted(set(fresh) | set(cont), reverse=True):
            tok = np.zeros((1, b), np.int32)
            if b in fresh:
                logits, self.cache = self.lm.prefill_slot(self.cache, tok, 0, 1)
            if b in cont and self.align + b <= self.max_seq_len:
                _, self.cache = self.lm.prefill_slot_continue(self.cache, tok, 0, self.align, 1)
        for n in sorted({1, self.decode_tokens_per_seq}):
            out = self._run_decode(n)
        if self.history is not None:
            self.lm.spec_rounds(self.cache, self.history, self.active_mask,
                                self.spec_rounds_n, self.spec_k, self.spec_ngram)
        sample(logits, self.sp.row(0), self.recent[:1], self.generator)
        self.cache.lengths.zero_()
        for layer in self.cache.layers:
            for t in layer.tensors():
                t.zero_()
        if self.history is not None:
            self.history.zero_()
        self.recent.fill_(-1)
        self.cur_tokens.zero_()
        out.cpu()  # a real sync: no warmup work lands on the first request
        log.info("warmup done in %.1fs", time.perf_counter() - t0)

    # -- engine loop ---------------------------------------------------------
    def run(self):
        while not self._stop.is_set():
            if not self.step():
                try:
                    seq = self.request_q.get(timeout=0.05)
                    self.scheduler.add(seq)
                    self.stats.requests_received += 1
                except queue.Empty:
                    pass

    def step(self) -> bool:
        self.stats.engine_steps += 1
        if self.stats.engine_steps % 200 == 0:
            snap = self.stats.snapshot(
                running=len(self.scheduler.running),
                waiting=len(self.scheduler.waiting),
            )
            log.info(
                "engine: uptime=%.0fs reqs=%d/%d gen_tokens=%d prefill=%.0f tok/s decode=%.0f tok/s running=%d waiting=%d",
                snap["uptime_s"], snap["requests_completed"],
                snap["requests_received"], snap["generated_tokens"],
                snap["prefill_tok_s"], snap["decode_tok_s"],
                snap["running"], snap["waiting"],
            )
        self._drain_requests()
        self._check_aborted()

        if self._pending is not None:
            self._admit_chunk()
            if self._pending is not None and any(self.active):
                # keep running streams alive between chunks of a long
                # admission (the point of chunked prefill)
                self._decode_block(1)
            return True

        if self.scheduler.waiting:
            # admission / preemption decisions need current slot occupancy,
            # and a finish hiding in the inflight block may free a slot
            self._flush_inflight()

        seq = self.scheduler.next_prefill()
        if seq is not None:
            self._admit(seq)
            return True

        if self._maybe_preempt():
            return True

        if any(self.active) or self._inflight is not None:
            if not any(self.active):
                # only the trailing block is left: drain it and go idle
                self._flush_inflight()
                return True
            if self._spec_candidate() is not None:
                # the speculative budget check reads host-visible positions,
                # which lag by the inflight block: flush and re-validate
                self._flush_inflight()
                spec_seqs = self._spec_candidate()
                if spec_seqs is not None:
                    self._spec_block(spec_seqs)
                    return True
                if not any(self.active):
                    return True
            n = self.decode_tokens_per_seq
            if self.scheduler.waiting and (
                any(s is None for s in self.slots) or self._preempt_imminent()
            ):
                # shorten the block only when the waiting head could be
                # admitted soon (a free slot, or preemption about to fire)
                n = 1
            self._decode_block(n)
            return True
        return False

    def _preempt_imminent(self) -> bool:
        """True when a fresh waiting request is within one short block of
        tripping the starvation preemption."""
        if self.preempt_after_s is None:
            return False
        now = time.monotonic()
        return any(
            not s.preempted and now - s.submitted_at >= self.preempt_after_s - 1.0
            for s in self.scheduler.waiting
        )

    # -- internals -----------------------------------------------------------
    def _drain_requests(self):
        while True:
            try:
                seq = self.request_q.get_nowait()
            except queue.Empty:
                return
            self.scheduler.add(seq)
            self.stats.requests_received += 1

    def _check_aborted(self):
        with self._lock:
            ids, self._abort_ids = self._abort_ids, set()
        for rid in ids:
            if self.scheduler.drop_waiting(rid):
                self.stats.requests_aborted += 1
                continue
            for seq in self.scheduler.running:
                if seq.request_id == rid:
                    seq.cancelled = True
        for seq in self.slots:
            if seq is not None and seq.cancelled:
                self._finish(seq, FinishReason.ABORT)

    def _maybe_preempt(self) -> bool:
        """Preempt-and-requeue under slot starvation: when a fresh waiting
        request has aged past ``preempt_after_s`` and every slot is busy,
        evict the running sequence with the most generated tokens and requeue
        it; re-admission re-prefills prompt + generated (or reuses its still
        resident rows). No token is lost or sent twice."""
        if self.preempt_after_s is None or not self.scheduler.waiting:
            return False
        if any(s is None for s in self.slots):
            return False  # a slot is free; normal admission handles it
        # only a FRESH starved request triggers preemption, which breaks the
        # preempt/re-preempt ping-pong two long requests would enter
        now = time.monotonic()
        head = next(
            (s for s in self.scheduler.waiting
             if not s.preempted and now - s.submitted_at >= self.preempt_after_s),
            None,
        )
        if head is None:
            return False
        victim = max(
            (s for s in self.slots if s is not None and s.generated),
            key=lambda s: len(s.generated),
            default=None,
        )
        if victim is None:
            return False
        if self.prefix_cache and victim.generated:
            self._resident[victim.slot] = np.asarray(
                list(victim.request.prompt_ids) + victim.generated[:-1], np.int32
            )
        self._set_active(victim.slot, False)
        self.slots[victim.slot] = None
        victim.slot = -1
        victim.preempted = True
        victim.queued_ns = time.time_ns()
        self.scheduler.requeue(victim)
        # the freed slot goes to the starved request this preemption was for
        if self.scheduler.waiting[0] is not head:
            self.scheduler.waiting.remove(head)
            self.scheduler.waiting.appendleft(head)
        self.stats.requests_preempted += 1
        log.info(
            "preempted %s (%d generated) for starved head %s (waited %.1fs)",
            victim.request_id, len(victim.generated), head.request_id,
            time.monotonic() - head.submitted_at,
        )
        return True

    def _choose_slot(self, ctx) -> tuple[int, int]:
        """Pick a free slot for ``ctx``; returns (slot, reuse_len). With
        prefix caching, the free slot whose resident tokens share the longest
        common prefix with ``ctx`` wins when that prefix clears
        ``prefix_reuse_min``; otherwise fresh admissions prefer slots with no
        resident prefix, so reusable contexts survive as long as possible."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        best, best_lcp = None, 0
        if self.prefix_cache:
            arr = np.asarray(ctx, np.int32)
            for i in free:
                r = self._resident[i]
                if r is None:
                    continue
                n = min(len(r), len(arr))
                neq = np.nonzero(r[:n] != arr[:n])[0]
                lcp = int(neq[0]) if neq.size else n
                if lcp > best_lcp:
                    best, best_lcp = i, lcp
        # at least one suffix token must run to produce admission logits;
        # the reused offset aligns down so chunk writes stay bucket-aligned
        best_lcp = min(best_lcp, len(ctx) - 1, self.max_seq_len - self.align)
        best_lcp -= best_lcp % self.align
        if best is not None and best_lcp >= self.prefix_reuse_min:
            return best, best_lcp
        for i in free:
            if self._resident[i] is None:
                return i, 0
        return free[0], 0

    def clear_prefix_cache(self):
        """Forget all resident prefixes."""
        self._resident = [None] * self.max_slots

    def _admit(self, seq: Sequence):
        tracing.record("request.queued", seq.queued_ns, rid=seq.request_id)
        with tracing.span("engine.admit", rid=seq.request_id):
            req = seq.request
            # context = prompt for a fresh sequence; prompt + generated-so-far
            # for one resumed after preemption (KV reconstruction by re-prefill)
            ctx = seq.context_ids()
            ctx_len = len(ctx)
            if ctx_len == 0:
                seq.send_error("empty prompt")
                self.stats.requests_failed += 1
                return
            # refused on the host: an id past the embedding would be a device-
            # side assert inside the gather, and the thread and the card with it
            err = prompt_ids_error(ctx, self.lm.config.vocab_size)
            if err:
                seq.send_error(err)
                self.stats.requests_failed += 1
                return
            if ctx_len + 1 >= self.max_seq_len:
                seq.send_error(
                    f"prompt length {ctx_len} exceeds max_seq_len {self.max_seq_len}"
                )
                self.stats.requests_failed += 1
                return
            # clamp generation budget to the slot capacity
            budget = self.max_seq_len - ctx_len - 1
            req.max_new_tokens = min(req.max_new_tokens, len(seq.generated) + budget)

            slot, reuse = self._choose_slot(ctx)
            seq.slot = slot
            self._resident[slot] = None  # the new occupant overwrites the row
            if reuse:
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_reused += reuse
                # the row's live length becomes the reused prefix
                self.cache.lengths[slot] = reuse

            n_new = ctx_len - reuse
            s_bucket = bucket_length(n_new, floor=self.align, ceiling=self.max_seq_len)
            if (self.prefill_chunk is not None and n_new > self.prefill_chunk) or (
                s_bucket > self.max_seq_len - reuse
            ):
                # chunked admission: reserve the slot (inactive), promote so the
                # scheduler's capacity accounting sees it, then feed chunks one
                # step at a time from the engine loop. Also taken when the
                # whole-suffix bucket would overrun the buffer past a reused
                # prefix: chunks shrink to buckets that fit.
                self.slots[slot] = seq
                self.scheduler.promote(seq)
                self._pending = {
                    "seq": seq, "ctx": np.asarray(ctx, np.int32), "offset": reuse,
                    "spent": 0.0,
                    "chunk": self.prefill_chunk
                    or _pow2_floor(self.max_seq_len - reuse, self.align),
                }
                self._admit_chunk()
                return

            t0 = time.perf_counter()
            padded = np.zeros((1, s_bucket), np.int32)
            padded[0, :n_new] = ctx[reuse:]
            if reuse:
                logits, self.cache = self.lm.prefill_slot_continue(
                    self.cache, padded, slot, reuse, n_new)
            else:
                logits, self.cache = self.lm.prefill_slot(self.cache, padded, slot, n_new)
            self.slots[slot] = seq
            self.scheduler.promote(seq)
            self.stats.prefill_time_s += time.perf_counter() - t0
            self._finish_admission(seq, logits, ctx)

    def _admit_chunk(self):
        """One chunk of a pending chunked admission: the first chunk is a
        fresh slot prefill, later chunks run the cached continuation at the
        row's live offset. The final chunk's logits complete admission."""
        p = self._pending
        with tracing.span("engine.admit_chunk", rid=p["seq"].request_id):
            seq = p["seq"]
            if seq.cancelled or seq.slot < 0 or self.slots[seq.slot] is not seq:
                # aborted or preempted mid-admission; the slot is already freed
                self._pending = None
                return
            ctx, offset = p["ctx"], p["offset"]
            n = min(p["chunk"], len(ctx) - offset)
            # the [1, bucket] cache write must fit the buffer: shrink the bucket
            # to the largest aligned power of two below the remaining capacity
            # (offsets are align multiples, so the cap is >= align and the
            # shrunk n keeps the next offset aligned)
            s_bucket = bucket_length(n, floor=self.align)
            cap = self.max_seq_len - offset
            if s_bucket > cap:
                s_bucket = _pow2_floor(cap, self.align)
                n = min(n, s_bucket)
            padded = np.zeros((1, s_bucket), np.int32)
            padded[0, :n] = ctx[offset:offset + n]
            t0 = time.perf_counter()
            if offset == 0:
                logits, self.cache = self.lm.prefill_slot(self.cache, padded, seq.slot, n)
            else:
                logits, self.cache = self.lm.prefill_slot_continue(
                    self.cache, padded, seq.slot, offset, n)
            p["spent"] += time.perf_counter() - t0
            p["offset"] = offset + n
            if p["offset"] < len(ctx):
                return
            self._pending = None
            self.stats.prefill_time_s += p["spent"]
            self._finish_admission(seq, logits, ctx)

    def _finish_admission(self, seq: Sequence, logits, ctx):
        """Sampling state + first token + activation, shared by whole-prompt
        and chunked admission."""
        slot = seq.slot
        s = seq.request.sampling
        self.sp.set_row(slot, temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
                        repetition_penalty=s.repetition_penalty, do_sample=s.do_sample)
        self.recent[slot] = -1
        if s.repetition_penalty != 1.0:
            t = torch.as_tensor(np.asarray(ctx[-RECENT_WINDOW:], np.int32),
                                device=self.recent.device)
            self.recent[slot, RECENT_WINDOW - t.shape[0]:] = t
        rrow = self.recent[slot:slot + 1]
        first = sample(logits, self.sp.row(slot), rrow, self.generator)
        self.recent[slot] = update_recent(rrow, first)[0]
        self.cur_tokens[slot] = first[0]
        if self.history is not None:
            self._hist_admit(slot, ctx, first)

        self._set_active(slot, True)
        self.stats.prompt_tokens += len(ctx)
        if seq.detok is None and self.lm.tokenizer is not None:
            seq.detok = TokenOutputStream(self.lm.tokenizer)  # survives preemption
        first_token = not seq.generated  # else re-admitted after a preemption
        self._emit(seq, int(first[0]))
        if first_token:
            tracing.record("request.ttft", seq.submitted_ns, rid=seq.request_id)

    def _emit(self, seq: Sequence, token: int) -> bool:
        """Record + stream one token; returns False when the seq finished."""
        seq.generated.append(token)
        reason = seq.should_stop(token)
        is_eos = reason == FinishReason.STOP
        text = None
        if seq.detok is not None and not is_eos:
            text = seq.detok.next_token(token)
        if not is_eos:
            if seq.request.stop_strings:
                out, stopped = seq.filter_stop(text or "")
                seq.send_token(token, out or None)
                if stopped:
                    seq.stopped_by_string = True
                    self._finish(seq, FinishReason.STOP)
                    return False
            else:
                seq.send_token(token, text)
        if reason is not None:
            self._finish(seq, reason)
            return False
        return True

    def _finish(self, seq: Sequence, reason: FinishReason):
        if seq.slot >= 0 and self.slots[seq.slot] is seq:
            if self.prefix_cache and self.active[seq.slot] and seq.generated:
                # every token except the last sampled one was fed back, so
                # its KV is resident; junk a decode block wrote past EOS lies
                # beyond this prefix and is cut off by the length reset at
                # reuse time
                self._resident[seq.slot] = np.asarray(
                    list(seq.request.prompt_ids) + seq.generated[:-1], np.int32
                )
            self._set_active(seq.slot, False)
            self.slots[seq.slot] = None
        self.scheduler.finish(seq)
        if seq.detok is not None:
            rest = seq.detok.decode_rest() or ""
            if seq.stopped_by_string:
                rest = ""  # everything from the stop match on is dropped
            elif seq.request.stop_strings:
                out, stopped = seq.filter_stop(rest)
                rest = out if stopped else out + seq.flush_stop_buf()
                if stopped and reason != FinishReason.ABORT:
                    seq.stopped_by_string = True
                    reason = FinishReason.STOP
            if rest:
                seq.response_q.put(
                    EngineResponse(seq.request_id, token=None, text=rest,
                                   n_generated=len(seq.generated))
                )
        if reason == FinishReason.ABORT:
            self.stats.requests_aborted += 1
        else:
            self.stats.requests_completed += 1
        self.stats.generated_tokens += len(seq.generated)
        seq.send_finished(reason)

    def _set_active(self, slot: int, flag: bool) -> None:
        self.active[slot] = flag
        self.active_mask[slot] = flag

    def _hist_admit(self, slot: int, ctx, first: torch.Tensor) -> None:
        """Install an admitted sequence's token history in row ``slot``: the
        context at columns 0.., the first sampled token (``first [1]``, on
        the device) at ``len(ctx)``, zeros beyond."""
        row = np.zeros((self.history.shape[1],), np.int32)
        row[:len(ctx)] = ctx
        self.history[slot] = torch.from_numpy(row).to(self.history.device)
        self.history[slot, len(ctx)] = first[0]

    def _spec_candidate(self):
        """The running sequences eligible for a chained speculative block,
        or None. Exact only when every active slot decodes greedy and
        penalty-free with ``spec_rounds * (spec_k + 1)`` slots of cache
        headroom (a mixed batch takes the plain block: verifying a subset
        would cost a second full weight stream for the rest). Models with
        recurrent layers never speculate (``history`` is None). After a block
        whose tokens-per-pass EMA fell below ``spec_min_gain``, plain blocks
        run for ``spec_cooldown`` calls before the next probe."""
        if self.history is None:
            return None
        if self.scheduler.waiting and (
            any(s is None for s in self.slots) or self._preempt_imminent()
        ):
            # let the plain path's block shortening admit the waiting head
            return None
        if self._spec_wait > 0:
            self._spec_wait -= 1
            return None
        running = [s for s in self.slots if s is not None and self.active[s.slot]]
        if not running:
            return None
        budget = self.spec_rounds_n * (self.spec_k + 1)
        for seq in running:
            samp = seq.request.sampling
            if samp.do_sample or samp.repetition_penalty != 1.0:
                return None
            pos = len(seq.request.prompt_ids) + len(seq.generated)
            if pos + budget > self.max_seq_len:
                return None
        return running

    def _spec_block(self, running):
        """One chained speculative block over every running stream:
        ``spec_rounds`` propose/verify rounds back to back on the device,
        drafts from each slot's history, one device-to-host copy for
        1..spec_rounds*(spec_k+1) tokens a stream, byte-identical to
        sequential greedy decoding."""
        with tracing.span("engine.spec_block", rows=len(running), slots=self.max_slots,
                          steps=self.spec_rounds_n):
            t0 = time.perf_counter()
            R, K = self.spec_rounds_n, self.spec_k
            out_tok, out_acc, self.cache, self.history = self.lm.spec_rounds(
                self.cache, self.history, self.active_mask, R, K, self.spec_ngram)
            tok_np = out_tok.cpu().numpy()  # [R, B, K+1]
            acc_np = out_acc.cpu().numpy()  # [R, B]
            self.stats.spec_steps += R
            for seq in running:
                slot = seq.slot
                done = False
                for r in range(R):
                    for t in tok_np[r, slot, : int(acc_np[r, slot]) + 1].tolist():
                        # count only tokens delivered: an early finish must not
                        # inflate the acceptance reported
                        self.stats.spec_tokens += 1
                        if not self._emit(seq, int(t)):
                            done = True
                            break
                    if done:
                        break
                if self.slots[slot] is seq:  # still running: the next block continues
                    self.cur_tokens[slot] = seq.generated[-1]
            # the device's acceptance (tokens the host dropped past EOS or
            # max_tokens included: they cost weight passes either way)
            m = float((acc_np[:, [s.slot for s in running]] + 1).mean())
            self._spec_ema = m if self._spec_ema is None else 0.5 * self._spec_ema + 0.5 * m
            if self._spec_ema < self.spec_min_gain:
                self._spec_wait = self.spec_cooldown
            self.stats.decode_time_s += time.perf_counter() - t0

    def _run_decode(self, n_steps: int) -> torch.Tensor:
        """One masked decode block over every slot (with the history rows
        when speculation can engage); returns its tokens ``[B, n_steps]``.
        On the card these are the block program's static output, which the
        next replay overwrites: :meth:`_decode_block` copies them out on the
        stream before it."""
        out, self.cache, self.recent, self.history = self.lm._decode(
            self.cache, self.cur_tokens, self.recent, self.sp, self.generator,
            self.active_mask, n_steps, self.history, copy_out=False)
        return out

    def _decode_block(self, n_steps: int):
        """Dispatch one masked decode block, then process the PREVIOUS
        block's tokens while the device computes this one (depth-1
        pipeline). The block's tokens start for the host at once, on the
        stream, so reading them waits for this block only and not for the
        next. A finish can surface one block late; the junk block after it
        writes past the finished prefix, which the length reset at reuse
        time masks, and ``max_new_tokens``'s slot-capacity clamp keeps it
        inside the buffer."""
        with tracing.span("engine.decode_block", rows=int(np.count_nonzero(self.active)),
                          slots=self.max_slots, steps=n_steps):
            t0 = time.perf_counter()
            out = self._run_decode(n_steps)
            self.cur_tokens = out[:, -1].clone()
            seqs = [s if self.active[i] else None for i, s in enumerate(self.slots)]
            prev, self._inflight = self._inflight, (_start_host_copy(out), n_steps, seqs)
            if prev is not None:
                self._process_block(*prev)
            self.stats.decode_time_s += time.perf_counter() - t0

    def _process_block(self, out, n_steps: int, seqs):
        """Emit a decode block's tokens (``out`` from :func:`_start_host_copy`):
        wait for its device-to-host copy, then per-stream detok and queue
        puts. ``seqs`` is the slot snapshot at dispatch; a slot whose
        occupant changed since is skipped."""
        with tracing.span("engine.emit_tokens"):
            tokens = _host_tokens(out)
            for slot, seq in enumerate(seqs):
                if seq is None or self.slots[slot] is not seq:
                    continue
                for j in range(n_steps):
                    if not self._emit(seq, int(tokens[slot, j])):
                        break

    def _flush_inflight(self):
        if self._inflight is not None:
            with tracing.span("engine.flush_inflight"):
                t0 = time.perf_counter()
                prev, self._inflight = self._inflight, None
                self._process_block(*prev)
                self.stats.decode_time_s += time.perf_counter() - t0


def _start_host_copy(out: torch.Tensor):
    """Start ``out``'s copy to the host (on the card into pinned memory,
    behind the block on the stream, with an event that marks its end). The
    copy outlives the next replay of the block's program."""
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
    host.copy_(out, non_blocking=out.is_cuda)
    if not out.is_cuda:
        return host, None
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_tokens(copy) -> np.ndarray:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()
