"""crane_tpu_torch's serving engine against crane_tpu's on the same weights.

Both engines are driven through the same scenario step by step: concurrent
requests, chunked admission, cross-request prefix reuse and preemption.
Greedy outputs and the engine statistics must be identical. The rest checks
the port's engine on its own (sampling, aborts, the memory budget, the
thread loop).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.models.auto import quantize_params
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.init import QWEN3_TINY, init_params
from crane_tpu.serve import sequence as jseq
from crane_tpu.serve.engine import InferenceEngine as JEngine
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.serve.engine import (
    EngineRequest,
    FinishReason,
    InferenceEngine,
    SamplingOptions,
)
from crane_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(2)

GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)
STAT_KEYS = ("requests_received", "requests_completed", "requests_preempted",
             "prompt_tokens", "generated_tokens", "prefix_hits", "prefix_tokens_reused")


@pytest.fixture(scope="module")
def lms():
    jp = init_params(QWEN3_TINY, seed=0, dtype=jnp.float32)
    return (JLM(QWEN3_TINY, jp, dtype=jnp.float32),
            TLM(QWEN3_TINY, params_from_jax(jp), dtype=torch.float32))


@pytest.fixture(scope="module")
def quant_lms(lms):
    """ISQ-quantized models per bit width, on crane_tpu's codes."""
    jp = lms[0].params
    out = {}
    for bits in (8, 4):
        jq = quantize_params(jp, bits=bits)
        out[bits] = (JLM(QWEN3_TINY, jq, dtype=jnp.float32),
                     TLM(QWEN3_TINY, params_from_jax(jq), dtype=torch.float32))
    return out


def req(engine, rid, prompt, n, sampling=GREEDY):
    """A request of the engine's own package (greedy unless ``sampling``)."""
    if isinstance(engine, JEngine):
        return jseq.EngineRequest(request_id=rid, prompt_ids=list(prompt), max_new_tokens=n,
                                  sampling=jseq.SamplingOptions(**vars(sampling)))
    return EngineRequest(request_id=rid, prompt_ids=list(prompt), max_new_tokens=n,
                         sampling=sampling)


def drain(q):
    toks = []
    while True:
        r = q.get(timeout=30)
        assert r.error is None, r.error
        if r.finished:
            return toks, r.finish_reason
        if r.token is not None:
            toks.append(r.token)


def run_until_idle(engine, max_steps=500):
    for _ in range(max_steps):
        if not engine.step() and engine.request_q.empty():
            return
    raise AssertionError("engine did not drain")


def mixed_scenario(engine):
    """Four concurrent requests (two admitted in chunks), then a later turn
    of one conversation that reuses its resident prefix and continues in
    chunks."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, n) for n in (3, 17, 40, 70)]
    qs = [engine.submit(req(engine, f"r{i}", p, 10)) for i, p in enumerate(prompts)]
    run_until_idle(engine)
    outs = [drain(q)[0] for q in qs]
    follow = list(prompts[2]) + outs[2] + list(rng.integers(1, 500, 35))
    q = engine.submit(req(engine, "follow", follow, 8))
    run_until_idle(engine)
    return outs + [drain(q)[0]]


def preempt_scenario(engine):
    """One slot, immediate starvation preemption: the victim's stream pauses
    and resumes from re-admission with no token lost or repeated."""
    qa = engine.submit(req(engine, "a", [3, 14, 15, 92, 6], 12))
    for _ in range(3):
        engine.step()
    qb = engine.submit(req(engine, "b", [7, 8, 9], 4))
    run_until_idle(engine)
    assert engine.stats.requests_preempted == 1
    return [drain(qa)[0], drain(qb)[0]]


@pytest.mark.parametrize("kv_quant_bits", [None, 8, 4], ids=["dense", "w8kv8", "w4kv4"])
@pytest.mark.parametrize("scenario,kw", [
    (mixed_scenario, dict(max_slots=3, max_seq_len=256, prefill_chunk=16, bucket_align=16,
                          decode_tokens_per_seq=4, prefix_reuse_min=16)),
    (preempt_scenario, dict(max_slots=1, max_seq_len=128, decode_tokens_per_seq=2,
                            preempt_after_s=0.0)),
])
def test_engine_matches_crane_tpu(lms, quant_lms, scenario, kw, kv_quant_bits):
    """Dense weights on an fp cache, or ISQ weights on a KV cache of the
    same bit width."""
    jl, tl = lms if kv_quant_bits is None else quant_lms[kv_quant_bits]
    kw = dict(kw, kv_quant_bits=kv_quant_bits)
    jeng, teng = JEngine(jl, **kw), InferenceEngine(tl, **kw)
    assert scenario(teng) == scenario(jeng)
    js, ts = jeng.stats.snapshot(), teng.stats.snapshot()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ts["requests_completed"] == ts["requests_received"]


def test_warmup_leaves_no_trace_and_sampling_finishes(lms):
    """After warmup the engine serves as a fresh one would; a sampled
    request (exact top-p, penalty) finishes with the tokens asked."""
    _, tl = lms
    engine = InferenceEngine(tl, max_slots=2, max_seq_len=128)
    engine.warmup()
    sampled = SamplingOptions(temperature=0.8, top_p=0.9, top_k=0, repetition_penalty=1.1)
    qa = engine.submit(req(engine, "greedy", [3, 14, 15], 6))
    qb = engine.submit(req(engine, "sampled", [5, 6, 7, 8], 9, sampled))
    run_until_idle(engine)
    assert drain(qa) == (tl.generate([3, 14, 15], GenerationConfig.greedy(6)), FinishReason.LENGTH)
    toks, reason = drain(qb)
    assert reason == FinishReason.LENGTH and len(toks) == 9
    assert all(0 <= t < QWEN3_TINY.vocab_size for t in toks)


def test_abort_mid_admission_frees_the_slot(lms):
    _, tl = lms
    engine = InferenceEngine(tl, max_slots=1, max_seq_len=256, prefill_chunk=16, bucket_align=16)
    q1 = engine.submit(req(engine, "r1", np.random.default_rng(9).integers(1, 500, 64), 4))
    engine.step()  # first chunk done, admission pending
    assert engine._pending is not None
    engine.abort("r1")
    q2 = engine.submit(req(engine, "r2", [5, 6], 3))
    run_until_idle(engine)
    assert drain(q1) == ([], FinishReason.ABORT)
    assert drain(q2)[0] == tl.generate([5, 6], GenerationConfig.greedy(3))
    assert engine.stats.requests_aborted == 1


def test_memory_budget_and_unported_options(lms, quant_lms, monkeypatch):
    """The budget counts the fp or quantized cache (codes and scale planes),
    QuantizedWeight leaves (codes and scales) and, with speculation, the
    history rows, and names the KV bits."""
    _, tl = lms
    monkeypatch.setenv("CRANE_HBM_BYTES", str(1024 * 1024))
    with pytest.raises(RuntimeError, match="HBM budget exceeded"):
        InferenceEngine(tl, max_slots=4, max_seq_len=512)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(64 * 1024 ** 3))
    InferenceEngine(tl, max_slots=4, max_seq_len=512)

    _, tq = quant_lms[4]
    cfg = QWEN3_TINY
    E, V, I, H, Hkv, D = (cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size,
                          cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    linear_in_out = [(E, H * D), (E, Hkv * D), (E, Hkv * D), (H * D, E), (E, I), (E, I), (I, E)]
    # int4 codes pack two input rows per byte; one float32 scale per column;
    # the dense embedding and norms stay float32; the tied head is quantized
    weights = (cfg.num_layers * (sum(i // 2 * o + 4 * o for i, o in linear_in_out)
                                 + 4 * (2 * E + 2 * D))
               + 4 * (V * E + E) + (E // 2 * V + 4 * V))
    slots, seq = 4, 512
    kv = cfg.num_layers * (2 * slots * seq * Hkv * D // 2 + 2 * slots * Hkv * seq * 4) + 4 * slots
    need = int((weights + kv) * 1.15)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need))
    InferenceEngine(tq, max_slots=slots, max_seq_len=seq, kv_quant_bits=4)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need - 1))
    with pytest.raises(RuntimeError, match="4-bit KV"):
        InferenceEngine(tq, max_slots=slots, max_seq_len=seq, kv_quant_bits=4)
    # speculation adds the int32 history rows, spec_k + 2 columns past the slot
    need = int((weights + kv + slots * (seq + 8 + 2) * 4) * 1.15)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need))
    InferenceEngine(tq, max_slots=slots, max_seq_len=seq, kv_quant_bits=4, speculative="ngram")
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need - 1))
    with pytest.raises(RuntimeError, match="4-bit KV"):
        InferenceEngine(tq, max_slots=slots, max_seq_len=seq, kv_quant_bits=4,
                        speculative="ngram")


def test_threaded_run(lms):
    _, tl = lms
    engine = InferenceEngine(tl, max_slots=2, max_seq_len=64)
    engine.start()
    try:
        toks, reason = drain(engine.submit(req(engine, "r1", [3, 14, 15], 5)))
    finally:
        engine.stop()
    assert not engine._thread.is_alive()
    assert len(toks) == 5 and reason == FinishReason.LENGTH


def one_stream(engine, prompt, n, sampling=GREEDY):
    q = engine.submit(req(engine, "a", prompt, n, sampling))
    run_until_idle(engine)
    return [drain(q)[0]]


def spec_single(engine):
    """One greedy stream on a repetitive prompt: drafts are accepted."""
    return one_stream(engine, [5, 6, 7, 8] * 6, 12)


def spec_eight(engine):
    """Eight greedy streams with repetitive tails: one batched verify a
    round serves all of them."""
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(1, 40, 4).tolist() * 5)[: 4 + 4 * i] + [5, 6, 7, 8] * 3
               for i in range(8)]
    qs = [engine.submit(req(engine, f"s{i}", p, 10)) for i, p in enumerate(prompts)]
    run_until_idle(engine)
    return [drain(q)[0] for q in qs]


def spec_mixed(engine):
    """A sampled request beside a greedy one: no block is speculative."""
    sampled = SamplingOptions(do_sample=True, temperature=0.9, repetition_penalty=1.0)
    qs = [engine.submit(req(engine, "g", [5, 6, 7, 8] * 6, 8)),
          engine.submit(req(engine, "s", [9, 8, 7], 6, sampled))]
    run_until_idle(engine)
    return [drain(q)[0] for q in qs]


def spec_sampled(engine):
    """One sampled request alone on a repetitive prompt: never speculated,
    the tokens of the plain engine from the same seed."""
    sampled = SamplingOptions(do_sample=True, temperature=0.8, repetition_penalty=1.0)
    return one_stream(engine, [5, 6, 7, 8] * 2, 8, sampled)


def spec_headroom(engine):
    """52 tokens in a 64-slot cache: no room for a block of rounds, so the
    engine declines speculation near the end and decodes plainly."""
    return one_stream(engine, [5, 6, 7, 8] * 13, 10)


def spec_low_acceptance(engine):
    """Random prompts: after the first probe the acceptance EMA falls below
    spec_min_gain and plain blocks take over for the cooldown."""
    rng = np.random.default_rng(9)
    qs = [engine.submit(req(engine, f"s{i}", rng.integers(1, 500, 24).tolist(), 24))
          for i in range(4)]
    run_until_idle(engine)
    return [drain(q)[0] for q in qs]


def spec_alternating(engine):
    """An unattainable spec_min_gain with a cooldown of one: probes and
    plain blocks alternate, and the plain blocks keep the history rows
    current."""
    return one_stream(engine, [5, 6, 7, 8] * 6, 24)


@pytest.mark.parametrize("scenario,kw,kv_quant_bits", [
    (spec_single, dict(max_slots=2, max_seq_len=128), None),
    (spec_eight, dict(max_slots=8, max_seq_len=128), None),
    (spec_eight, dict(max_slots=8, max_seq_len=128), 8),
    (spec_eight, dict(max_slots=8, max_seq_len=128), 4),
    (spec_mixed, dict(max_slots=2, max_seq_len=128), None),
    (spec_sampled, dict(max_slots=1, max_seq_len=128), None),
    (spec_headroom, dict(max_slots=1, max_seq_len=64), None),
    (spec_low_acceptance, dict(max_slots=4, max_seq_len=256, spec_rounds=4), None),
    (spec_alternating, dict(max_slots=2, max_seq_len=256, spec_rounds=2, spec_min_gain=100.0,
                            spec_cooldown=1), None),
], ids=["single", "eight", "eight-w8kv8", "eight-w4kv4", "mixed", "sampled", "headroom",
        "cooldown", "alternating"])
def test_speculative_engine_matches_crane_tpu(lms, quant_lms, scenario, kw, kv_quant_bits):
    """speculative="ngram" against crane_tpu's speculative engine (the
    greedy tokens, spec_steps and spec_tokens, the gate's wait) and against
    the port's plain engine (the tokens, a sampled request's included)."""
    jl, tl = lms if kv_quant_bits is None else quant_lms[kv_quant_bits]
    kw = dict(kw, kv_quant_bits=kv_quant_bits)
    jeng = JEngine(jl, speculative="ngram", **kw)
    teng = InferenceEngine(tl, speculative="ngram", **kw)
    plain = InferenceEngine(tl, **{k: v for k, v in kw.items() if not k.startswith("spec_")})
    got = scenario(teng)
    assert got == scenario(plain)
    # a sampled stream draws another package's random numbers: crane_tpu's
    # tokens are compared for the greedy streams, which come first
    greedy = {spec_mixed: 1, spec_sampled: 0}.get(scenario, len(got))
    assert got[:greedy] == scenario(jeng)[:greedy]
    for key in ("spec_steps", "spec_tokens"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    assert teng._spec_wait == jeng._spec_wait
    speculated = scenario not in (spec_mixed, spec_sampled, spec_headroom)
    assert (teng.stats.spec_steps > 0) == speculated
    if scenario is spec_low_acceptance:
        assert teng.stats.spec_steps == 4 and teng._spec_wait > 0


def test_speculative_engine_budget_edge(lms):
    """_spec_candidate's headroom at its edge: a stream whose position plus
    spec_rounds * (spec_k + 1) equals max_seq_len is speculated, one past it
    is not; the tokens equal plain decoding's either way."""
    _, tl = lms
    k, rounds, seq = 4, 2, 64
    for prompt_len, expect in ((seq - rounds * (k + 1) - 1, True), (seq - rounds * (k + 1), False)):
        prompt = ([5, 6, 7, 8] * 16)[:prompt_len]
        spec = InferenceEngine(tl, max_slots=1, max_seq_len=seq, speculative="ngram",
                               spec_k=k, spec_rounds=rounds)
        q = spec.submit(req(spec, "e", prompt, 2))
        spec.step()  # admission: one token generated, position prompt_len + 1
        assert (spec._spec_candidate() is not None) == expect, prompt_len
        run_until_idle(spec)
        plain = InferenceEngine(tl, max_slots=1, max_seq_len=seq)
        assert drain(q)[0] == one_stream(plain, prompt, 2)[0]


def test_out_of_vocabulary_prompt_ends_in_an_error(lms):
    """A prompt id of ``vocab`` or -1 is refused on the host before the
    embedding gather (crane_tpu clamps it instead; on the card the gather
    would be a device-side assert): the threaded engine answers each with an
    error response, stays alive, and serves the next request with the
    tokens a fresh engine gives it; ``generate`` raises for such a prompt."""
    _, tl = lms
    vocab = QWEN3_TINY.vocab_size
    engine = InferenceEngine(tl, max_slots=2, max_seq_len=128, decode_tokens_per_seq=2)
    engine.start()
    try:
        for rid, ids in (("high", [3, vocab, 4]), ("negative", [-1, 3]), ("float", [3.5, 4])):
            r = engine.submit(req(engine, rid, ids, 4)).get(timeout=30)
            assert r.finished and r.finish_reason == FinishReason.ERROR and "prompt" in r.error
        toks, reason = drain(engine.submit(req(engine, "good", [3, 4, 5], 6)))
        assert engine._thread.is_alive() and reason == FinishReason.LENGTH
    finally:
        engine.stop()
    assert engine.stats.requests_failed == 3 and engine.stats.requests_completed == 1
    fresh = InferenceEngine(tl, max_slots=2, max_seq_len=128, decode_tokens_per_seq=2)
    q = fresh.submit(req(fresh, "good", [3, 4, 5], 6))
    run_until_idle(fresh)
    assert drain(q)[0] == toks
    with pytest.raises(ValueError, match="outside the vocabulary"):
        tl.generate([3, vocab], GenerationConfig.greedy(2))
