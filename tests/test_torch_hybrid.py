"""The hybrid Gated-DeltaNet model (Qwen3-Next / Qwen3.5 architecture) in
crane_tpu_torch against crane_tpu, on one tiny checkpoint (CPU, f32).

The checkpoint is tests/test_qwen3_next_parity.py's: 4 layers, 3 of them GDN,
saved by transformers and loaded by both ``from_pretrained``s. Logits agree
within rtol/atol 2e-4 (the other port tests' bar); greedy tokens, through
``generate`` and through the engine (whole and chunked admission, and
preemption), are identical; the engine's statistics are the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models import auto as jauto
from crane_tpu.models.modules import transformer as jtf
from crane_tpu.serve import sequence as jseq
from crane_tpu.serve.engine import InferenceEngine as JEngine
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import auto as tauto
from crane_tpu_torch.models import init as tinit
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.kv_cache import GdnLayerCache, LayerKVCache, QuantLayerKVCache
from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions
from crane_tpu_torch.utils.bridge import cache_from_jax
from tests.test_qwen3_next_parity import _save_tiny_next

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)
STAT_KEYS = ("requests_received", "requests_completed", "requests_preempted",
             "prompt_tokens", "generated_tokens", "prefix_hits", "prefix_tokens_reused")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    _, d = _save_tiny_next(tmp_path_factory.mktemp("next"))
    return (jauto.from_pretrained(d, dtype=jnp.float32),
            tauto.from_pretrained(d, dtype=torch.float32, device="cpu"))


def ids(n, seed):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 150, n)]


def close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def close_caches(tc, jc):
    for tl, jl in zip(tc.layers, jc.layers):
        for got, ref in zip(tl.tensors(), (jl.conv_state, jl.recurrent_state)
                            if isinstance(tl, GdnLayerCache) else (jl.k, jl.v)):
            close(got, ref)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_config_weights_and_cache_layout_match(pair):
    jl, tl = pair
    assert dataclasses.asdict(tl.config) == dataclasses.asdict(jl.config)
    assert tl.config.layer_types == ("gdn", "gdn", "gdn", "full") and tl.config.attn_output_gate
    jflat = jax.tree_util.tree_leaves_with_path(jl.params)
    tflat = jax.tree_util.tree_leaves_with_path(tl.params)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    cache = tl.init_cache(2, 64)
    assert [type(c) for c in cache.layers] == [GdnLayerCache] * 3 + [LayerKVCache]
    assert cache.max_seq == 64
    jcache = jl.init_cache(2, 64)
    for tc, jc in zip(cache.layers, jcache.layers):
        assert [tuple(x.shape) for x in tc.tensors()] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]


def test_forward_hidden_prefill_continuation_decode(pair):
    """A fresh prefill of two rows, a continuation chunk over the cache
    (K7 continues the GDN state, K3 attends the KV), and a masked decode
    step (K1): hidden states, logits and every layer's state against
    crane_tpu's forward_hidden."""
    jl, tl = pair
    jcfg, tcfg = jl.config, tl.config
    toks = np.asarray([ids(20, 1), ids(20, 2)], np.int32)
    jc, tc = jl.init_cache(2, 32), tl.init_cache(2, 32)

    def both(tokens, jpos, tpos, **kw):
        nonlocal jc, tc
        jh, jc = jtf.forward_hidden(jcfg, jl.params, jnp.asarray(tokens), jc, jpos, jl.rope,
                                    **{k: jnp.asarray(v) if k == "active" else v
                                       for k, v in kw.items()})
        th, tc = ttf.forward_hidden(tcfg, tl.params, torch.tensor(tokens), tc, tpos, tl.rope,
                                    **{k: torch.tensor(v) if k == "active" else v
                                       for k, v in kw.items()})
        close(th, jh)
        close(ttf.lm_logits(tcfg, tl.params, th), jtf.lm_logits(jcfg, jl.params, jh))
        close_caches(tc, jc)

    both(toks[:, :12], jnp.asarray(0, jnp.int32), 0, read_cache=False)
    both(toks[:, 12:], jnp.asarray(12, jnp.int32), 12)
    pos = np.asarray(jc.lengths)
    both(toks[:, :1], jnp.asarray(pos), torch.tensor(pos), active=np.array([True, False]))


def test_padded_prefill_keeps_pad_steps_out_of_the_state(pair):
    """A bucket-padded batched prefill (true lengths 9 and 16 in a 16-token
    bucket): last-token logits and the GDN states against crane_tpu, and
    the short row's state equal to that of its unpadded prompt. Without
    ``true_lengths`` the pad tokens would enter the recurrent state."""
    jl, tl = pair
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1] = ids(9, 3), ids(16, 4)
    jlog, jc = jl.prefill(jl.init_cache(2, 64), toks, [9, 16])
    tlog, tc = tl.prefill(tl.init_cache(2, 64), toks, [9, 16])
    close(tlog, jlog)
    close_caches(tc, jc)
    short_log, short = tl.prefill(tl.init_cache(1, 64), toks[:1, :9], [9])
    np.testing.assert_allclose(tlog[0].numpy(), short_log[0].numpy(), **TOL)
    for row, alone in zip(tc.layers[:3], short.layers[:3]):
        np.testing.assert_allclose(row.recurrent_state[0].numpy(),
                                   alone.recurrent_state[0].numpy(), **TOL)
        np.testing.assert_allclose(row.conv_state[0].numpy(), alone.conv_state[0].numpy(), **TOL)
    # a row's state from an unmasked padded prefill differs: the pad steps
    # would enter it, which is what true_lengths prevents
    _, unmasked = ttf.forward_hidden(tl.config, tl.params, torch.tensor(toks[:1]),
                                     tl.init_cache(1, 64), 0, tl.rope, read_cache=False)
    assert not torch.allclose(unmasked.layers[0].recurrent_state, short.layers[0].recurrent_state)


def test_decode_after_prefill_equals_prefill_logits(pair):
    """Incremental decode (conv roll, one-step recurrence, K1) reproduces
    the logits of one prefill over the whole sequence; the decode starts
    from crane_tpu's own prefilled cache, handed over by cache_from_jax."""
    jl, tl = pair
    seq = np.asarray([ids(11, 5)], np.int32)
    h, _ = ttf.forward_hidden(tl.config, tl.params, torch.tensor(seq), tl.init_cache(1, 32), 0,
                              tl.rope, read_cache=False)
    full = ttf.lm_logits(tl.config, tl.params, h)[0]
    pad = np.zeros((1, 8), np.int32)
    pad[0, :6] = seq[0, :6]
    jlog, jc = jl.prefill(jl.init_cache(1, 32), pad, [6])
    np.testing.assert_allclose(np.asarray(jlog)[0], full[5].numpy(), **TOL)
    cache = cache_from_jax(jc)
    assert [type(c) for c in cache.layers] == [GdnLayerCache] * 3 + [LayerKVCache]
    for s in range(6, 11):
        h, cache = ttf.forward_hidden(tl.config, tl.params, torch.tensor(seq[:, s:s + 1]), cache,
                                      cache.lengths, tl.rope)
        close(ttf.lm_logits(tl.config, tl.params, h)[0, 0], full[s].numpy())


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_generate_greedy_tokens_identical(pair, penalty):
    jl, tl = pair
    prompt = ids(70, 6)  # crosses the 64-token bucket
    assert tl.generate(prompt, GenerationConfig.greedy(16, repetition_penalty=penalty)) == \
        jl.generate(prompt, JGenerationConfig.greedy(16, repetition_penalty=penalty))


def test_slot_prefill_and_continuation_match_whole(pair):
    """A slot prefill plus a continuation chunk into row 1 of a 2-slot
    cache gives the logits of one whole slot prefill (crane_tpu's
    test_hybrid_model_chunked_prefill_logits_match), and the row's states
    equal crane_tpu's; row 0 stays zero."""
    jl, tl = pair
    toks = ids(24, 7)
    whole = np.zeros((1, 64), np.int32)
    whole[0, :24] = toks
    log_whole, _ = tl.prefill_slot(tl.init_cache(2, 64), whole, 1, 24)
    first, cont = np.zeros((1, 64), np.int32), np.zeros((1, 16), np.int32)
    first[0, :16], cont[0, :8] = toks[:16], toks[16:]
    _, tc = tl.prefill_slot(tl.init_cache(2, 64), first, 1, 16)
    tlog, tc = tl.prefill_slot_continue(tc, cont, 1, 16, 8)
    _, jc = jl.prefill_slot(jl.init_cache(2, 64), first, 1, 16)
    jlog, jc = jl.prefill_slot_continue(jc, cont, 1, 16, 8)
    close(tlog, jlog)
    np.testing.assert_allclose(tlog.numpy(), log_whole.numpy(), **TOL)
    close_caches(tc, jc)
    assert tc.layers[0].recurrent_state[0].abs().sum() == 0


def request(engine, rid, prompt, n):
    """A greedy request of the engine's own package."""
    if isinstance(engine, JEngine):
        return jseq.EngineRequest(rid, prompt, n, jseq.SamplingOptions(**vars(GREEDY)))
    return EngineRequest(rid, prompt, n, GREEDY)


def mixed(engine):
    """Three concurrent requests (two admitted in chunks), then a later turn
    of one conversation, which a positional cache would reuse."""
    prompts = [ids(5, 10), ids(40, 11), ids(70, 12)]
    qs = [engine.submit(request(engine, f"r{i}", p, 8)) for i, p in enumerate(prompts)]
    outs = [_drain(q) for q in _after(engine, qs)]
    follow = prompts[1] + outs[1] + ids(20, 13)
    return outs + [_drain(q) for q in _after(engine, [engine.submit(
        request(engine, "follow", follow, 6))])]


def preempt(engine):
    """One slot, immediate starvation preemption: the victim's stream
    resumes from a fresh re-prefill of prompt + generated."""
    qa = engine.submit(request(engine, "a", ids(7, 14), 10))
    for _ in range(3):
        engine.step()
    qb = engine.submit(request(engine, "b", ids(3, 15), 4))
    out = [_drain(q) for q in _after(engine, [qa, qb])]
    assert engine.stats.requests_preempted == 1
    return out


def _after(engine, qs):
    for _ in range(1000):
        if not engine.step() and engine.request_q.empty():
            return qs
    raise AssertionError("engine did not drain")


def _drain(q):
    toks = []
    while True:
        r = q.get(timeout=30)
        assert r.error is None, r.error
        if r.finished:
            return toks
        if r.token is not None:
            toks.append(r.token)


@pytest.mark.parametrize("scenario,kw", [
    (mixed, dict(max_slots=3, max_seq_len=256, prefill_chunk=16, bucket_align=16,
                 decode_tokens_per_seq=4, prefix_reuse_min=16)),
    (mixed, dict(max_slots=3, max_seq_len=256, decode_tokens_per_seq=4)),
    (preempt, dict(max_slots=1, max_seq_len=128, decode_tokens_per_seq=2, preempt_after_s=0.0)),
], ids=["chunked", "whole", "preempt"])
def test_engine_matches_crane_tpu(pair, scenario, kw):
    """Chunked admission (the first chunk a fresh slot prefill, the rest
    continuations through the row's view), whole-prompt admission, and
    preemption with re-prefill: tokens and statistics equal crane_tpu's,
    prefix reuse stays off, and chunked tokens equal whole-prompt tokens."""
    jl, tl = pair
    jeng, teng = JEngine(jl, **kw), InferenceEngine(tl, **kw)
    assert teng.prefix_cache is False and jeng.prefix_cache is False
    got = scenario(teng)
    assert got == scenario(jeng)
    js, ts = jeng.stats.snapshot(), teng.stats.snapshot()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ts["prefix_hits"] == 0 and ts["requests_completed"] == ts["requests_received"]
    if scenario is mixed:
        assert got[:3] == [tl.generate(p, GenerationConfig.greedy(8))
                           for p in (ids(5, 10), ids(40, 11), ids(70, 12))]


def test_recurrent_models_never_speculate(pair):
    """crane_tpu's gate: a model with GDN layers takes plain decoding under
    speculative="ngram", in generate (quietly) and in the engine (no
    history rows, no speculative block), with crane_tpu's greedy tokens."""
    jl, tl = pair
    prompt = [5, 6, 7, 8] * 6
    expected = jl.generate(prompt, JGenerationConfig.greedy(8))
    assert tl.generate(prompt, GenerationConfig.greedy(8, speculative="ngram")) == expected
    engine = InferenceEngine(tl, max_slots=2, max_seq_len=128, speculative="ngram")
    assert engine.history is None
    [got] = [_drain(q) for q in _after(engine, [engine.submit(request(engine, "h", prompt, 8))])]
    assert got == expected and engine.stats.spec_steps == 0


def test_memory_budget_counts_gdn_states(pair, monkeypatch):
    """The budget sizes the cache on the meta device: one KV layer plus
    three GDN layers' conv windows and float32 states."""
    _, tl = pair
    from crane_tpu_torch.serve.engine import _tree_bytes

    cfg, g = tl.config, tl.config.gdn
    slots, seq = 2, 512
    kv = 2 * slots * seq * cfg.num_kv_heads * cfg.head_dim * 4
    gdn = 3 * (slots * g.conv_kernel * g.conv_dim * 4
               + slots * g.num_v_heads * g.head_k_dim * g.head_v_dim * 4)
    assert tl.init_cache(slots, seq, device="meta").nbytes() == kv + gdn + 4 * slots
    need = int((_tree_bytes(tl.params) + kv + gdn + 4 * slots) * 1.15)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need))
    InferenceEngine(tl, max_slots=slots, max_seq_len=seq)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need - 1))
    with pytest.raises(RuntimeError, match="HBM budget exceeded"):
        InferenceEngine(tl, max_slots=slots, max_seq_len=seq)


def test_int8_kv_on_the_attention_layers(pair):
    """An int8 cache quantizes the full-attention layer only (GDN layers
    keep their states); prefill and a decode step against crane_tpu."""
    jl, tl = pair
    pad = np.zeros((1, 8), np.int32)
    pad[0, :5] = ids(5, 16)
    jlog, jc = jl.prefill(jl.init_cache(1, 64, quant_bits=8), pad, [5])
    tlog, tc = tl.prefill(tl.init_cache(1, 64, quant_bits=8), pad, [5])
    assert [type(c) for c in tc.layers] == [GdnLayerCache] * 3 + [QuantLayerKVCache]
    close(tlog, jlog)
    tok = np.asarray([[int(np.argmax(np.asarray(jlog)[0]))]], np.int32)
    jh, _ = jtf.forward_hidden(jl.config, jl.params, jnp.asarray(tok), jc, jc.lengths, jl.rope)
    th, _ = ttf.forward_hidden(tl.config, tl.params, torch.tensor(tok), tc, tc.lengths, tl.rope)
    close(ttf.lm_logits(tl.config, tl.params, th), jtf.lm_logits(jl.config, jl.params, jh))


# a tiny Qwen3.5-shaped text config: 3-in-4 GDN, gated attention, tied head
TINY_QWEN3_5 = {
    "model_type": "qwen3_5", "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 4,
    "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 16,
    "intermediate_size": 48, "rms_norm_eps": 1e-6, "rope_theta": 1e7,
    "tie_word_embeddings": True, "partial_rotary_factor": 0.25,
    "layer_types": ["linear_attention"] * 3 + ["full_attention"],
    "linear_num_value_heads": 4, "linear_num_key_heads": 2, "linear_key_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_dim": 4,
}


def test_random_hf_checkpoint_maps_like_crane_tpu():
    """The smoke run's weights: a seeded HF-layout state dict for a tiny
    Qwen3.5-shaped config, mapped by both packages' map_hf_weights, then one
    prefill through both."""
    cfg, jcfg = (m.transformer_config_from_hf(TINY_QWEN3_5) for m in (tauto, jauto))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = tinit.hf_state_dict(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    tp = tauto.map_hf_weights(cfg, sd, torch.float32)
    jp = jauto.map_hf_weights(jcfg, {k: v.numpy() for k, v in sd.items()}, jnp.float32)
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    tflat = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (tp["layers"][0]["gdn"]["A_log"].exp() <= 16).all()
    toks = np.asarray([ids(9, 17)], np.int32) % 64
    jh, _ = jtf.forward_hidden(jcfg, jp, jnp.asarray(toks), jtf.make_cache(jcfg, 1, 16, jnp.float32),
                               jnp.asarray(0, jnp.int32), jtf.make_rope_tables(jcfg))
    th, _ = ttf.forward_hidden(cfg, tp, torch.tensor(toks), ttf.make_cache(cfg, 1, 16, torch.float32),
                               0, ttf.make_rope_tables(cfg))
    close(th, jh)
