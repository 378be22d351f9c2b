"""The system under test: ``crane_tpu_torch``'s ``InferenceEngine`` over a
``CausalLM``, built the way ``serve/api.py`` ``main()`` builds it for the
server flags a traffic mix names, on weights drawn from the run's seed.

The weights reach the port through its loader (``map_hf_weights``, what
``from_pretrained`` calls on a checkpoint's tensors) from
:class:`~crane_bench.weights.Weights` in place of a file; ``--quant``
quantizes them in situ as ``from_pretrained`` does.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from crane_bench.weights import Weights

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def engine_args(flags: list[str]) -> argparse.Namespace:
    """The flags of ``python -m crane_tpu_torch.serve`` that shape the model
    and the engine, with the server's defaults."""
    ap = argparse.ArgumentParser("engine flags")
    ap.add_argument("--max-concurrent", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--decode-tokens-per-seq", type=int, default=8)
    ap.add_argument("--preempt-after", type=float, default=30.0)
    ap.add_argument("--speculative", default=None, choices=[None, "ngram"])
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    ap.add_argument("--quant", default=None, choices=[None, "q8", "q4"])
    ap.add_argument("--kv-quant", default=None, choices=[None, "int8", "int4"])
    return ap.parse_args(flags)


def build(hf: dict, model, seed: int, device, flags: list[str]):
    """(the ``CausalLM``, the ``InferenceEngine``) for the configuration
    ``hf`` under the server flags ``flags``, on weights from ``seed``."""
    from crane_tpu_torch.models.auto import (
        map_hf_weights,
        quantize_params,
        transformer_config_from_hf,
    )
    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.serve.engine import InferenceEngine

    args = engine_args(flags)
    dtype = DTYPES[args.dtype]
    cfg = transformer_config_from_hf(hf)
    # drawn in the type the checkpoint holds; the loader casts to ``--dtype``
    source = Weights(model, hf, seed, device)
    params = map_hf_weights(cfg, source, dtype, torch.device(device))
    source.release()
    if args.quant is not None:
        params = quantize_params(params, bits={"q8": 8, "q4": 4}[args.quant])
    lm = CausalLM(cfg, params, tokenizer=None, eos_token_ids=(), dtype=dtype)
    engine = InferenceEngine(
        lm,
        max_slots=args.max_concurrent,
        max_seq_len=args.max_seq_len,
        decode_tokens_per_seq=args.decode_tokens_per_seq,
        kv_quant_bits={"int8": 8, "int4": 4}.get(args.kv_quant),
        preempt_after_s=args.preempt_after if args.preempt_after > 0 else None,
        prefill_chunk=args.prefill_chunk if args.prefill_chunk > 0 else None,
        speculative=args.speculative,
        prefix_cache=not args.no_prefix_cache,
    )
    return lm, engine


def prefill_buckets(mix: dict, engine) -> tuple[list[int], list[int]]:
    """(fresh, continuation) prefill buckets the mix's traffic can reach
    under the engine's chunking (``serve/engine.py`` ``_admit``): a prompt
    longer than the chunk admits in chunks of it, the first fresh and the
    rest continuations; a later turn, or a prompt that shares a cached
    prefix, continues past it."""
    from crane_bench import traffic
    from crane_tpu_torch.utils.buckets import bucket_length

    chunk = engine.prefill_chunk or engine.max_seq_len
    firsts = {mix["system_prompt"] + t.turns[0].message for t in traffic.session_pool(mix)
              if t.turns}
    fresh = sorted({bucket_length(min(n, chunk), floor=engine.align) for n in firsts})
    later = max(firsts) > chunk or mix["turns"] > 1 or mix["system_prompt"] >= engine.align
    cont, b = [], engine.align
    while later and b <= chunk:
        cont.append(b)
        b *= 2
    return fresh, cont


def warm_prefills(engine, mix: dict) -> None:
    """Run each prefill bucket the mix reaches once, fresh and continuing,
    into slot 0, then clear the cache as ``engine.warmup`` does."""
    lm, cache = engine.lm, engine.cache
    fresh, cont = prefill_buckets(mix, engine)
    for b in fresh:
        lm.prefill_slot(cache, np.zeros((1, b), np.int32), 0, b)
    for b in cont:
        if engine.align + b <= engine.max_seq_len:
            lm.prefill_slot_continue(cache, np.zeros((1, b), np.int32), 0, engine.align, b)
    for layer in cache.layers:
        for t in layer.tensors():
            t.zero_()
    if cache.lengths.is_cuda:
        torch.cuda.synchronize()


class HostSpans:
    """Host spans around the engine's calls into the model, recorded in a
    traced run by wrapping the engine's own methods on the instance:
    ``(name, start_ns, end_ns)`` on ``time.time_ns``, the clock of the
    profiler's events."""

    CALLS = {"_admit": "engine.admit", "_admit_chunk": "engine.admit_chunk",
             "_decode_block": "engine.decode_block", "_process_block": "engine.emit_tokens",
             "_flush_inflight": "engine.flush_inflight"}

    def __init__(self, engine):
        self.spans: list[tuple[str, int, int]] = []
        for attr, name in self.CALLS.items():
            setattr(engine, attr, self._wrap(getattr(engine, attr), name))
        # held by each engine step; the profiler starts and stops under it,
        # so no launch runs while CUPTI is switched on or off
        self.gate = threading.Lock()
        step = engine.step

        def gated_step():
            with self.gate:
                return step()
        engine.step = gated_step

    def _wrap(self, fn, name):
        spans = self.spans

        def call(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((name, t0, time.time_ns()))
        return call
