"""The LFM2 short-conv hybrid in crane_tpu_torch against crane_tpu, on one
tiny checkpoint (CPU, f32).

The checkpoint is tests/test_lfm2_parity.py's: 4 layers, conv at 0, 1 and 3
and full attention at 2, saved by transformers (LFM2's own weight names) and
loaded by both ``from_pretrained``s. Logits agree within rtol/atol 2e-4 (the
other port tests' bar), the conv windows (``ConvLayerCache``) equal
crane_tpu's; greedy tokens, through ``generate`` and through the engine
(whole and chunked admission, and preemption), are identical.
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
from crane_tpu.serve.engine import InferenceEngine as JEngine
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import auto as tauto
from crane_tpu_torch.models import init as tinit
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.kv_cache import ConvLayerCache, LayerKVCache, QuantLayerKVCache
from crane_tpu_torch.serve.engine import InferenceEngine
from crane_tpu_torch.utils.bridge import cache_from_jax, params_from_jax
from tests.test_lfm2_parity import tiny  # noqa: F401  (the checkpoint fixture)
from tests.test_torch_hybrid import (
    STAT_KEYS,
    TOL,
    _after,
    _drain,
    close,
    ids,
    mixed,
    preempt,
    request,
)
from tests.test_torch_moe import close_caches, same_leaves

torch.set_num_threads(2)

LAYOUT = [ConvLayerCache, ConvLayerCache, LayerKVCache, ConvLayerCache]


@pytest.fixture(scope="module")
def pair(tiny):  # noqa: F811
    _, d = tiny
    return (jauto.from_pretrained(d, dtype=jnp.float32),
            tauto.from_pretrained(d, dtype=torch.float32, device="cpu"))


def test_config_weights_and_cache_layout_match(pair):
    """The lfm2 config, the mapped tree (conv projections, ``conv_w`` from
    the ``[C, 1, L]`` conv weight, feed_forward w1/w3/w2, operator_norm /
    ffn_norm, q/k_layernorm, embedding_norm) leaf for leaf, and the cache
    layout (a ``[B, L, C]`` window for each conv layer) against crane_tpu's."""
    jl, tl = pair
    assert dataclasses.asdict(tl.config) == dataclasses.asdict(jl.config)
    assert tl.config.layer_types == ("conv", "conv", "full", "conv")
    assert tl.config.has_recurrent_layers and tl.config.conv_l_cache == 3
    same_leaves(tl.params, jl.params)
    assert tl.params["layers"][0]["conv"]["conv_w"].dtype == torch.float32
    cache, jcache = tl.init_cache(2, 64), jl.init_cache(2, 64)
    assert [type(c) for c in cache.layers] == LAYOUT
    assert cache.layers[0].conv_state.shape == (2, 3, tl.config.hidden_size)
    for tc, jc in zip(cache.layers, jcache.layers):
        assert [tuple(x.shape) for x in tc.tensors()] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]


def test_forward_hidden_prefill_continuation_decode(pair):
    """A fresh prefill of two rows, a continuation chunk that re-enters the
    saved conv window, and a masked decode step (the window rolls for the
    active row only): hidden states, logits and every layer's state against
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
    before = tc.layers[0].conv_state[1].clone()
    pos = np.asarray(jc.lengths)
    both(toks[:, :1], jnp.asarray(pos), torch.tensor(pos), active=np.array([True, False]))
    assert torch.equal(tc.layers[0].conv_state[1], before)


def test_padded_prefill_keeps_pad_steps_out_of_the_window(pair):
    """A bucket-padded batched prefill (true lengths 9 and 16 in a 16-token
    bucket): last-token logits and windows against crane_tpu, and the short
    row's windows equal to those of its unpadded prompt."""
    jl, tl = pair
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1] = ids(9, 3), ids(16, 4)
    jlog, jc = jl.prefill(jl.init_cache(2, 64), toks, [9, 16])
    tlog, tc = tl.prefill(tl.init_cache(2, 64), toks, [9, 16])
    close(tlog, jlog)
    close_caches(tc, jc)
    short_log, short = tl.prefill(tl.init_cache(1, 64), toks[:1, :9], [9])
    np.testing.assert_allclose(tlog[0].numpy(), short_log[0].numpy(), **TOL)
    for i in (0, 1, 3):
        np.testing.assert_allclose(tc.layers[i].conv_state[0].numpy(),
                                   short.layers[i].conv_state[0].numpy(), **TOL)
    # an unmasked padded prefill's window holds pad steps: true_lengths keeps them out
    _, unmasked = ttf.forward_hidden(tl.config, tl.params, torch.tensor(toks[:1]),
                                     tl.init_cache(1, 64), 0, tl.rope, read_cache=False)
    assert not torch.allclose(unmasked.layers[0].conv_state, short.layers[0].conv_state)


def test_round_trips_and_decode_from_crane_tpu_cache(pair):
    """params_from_jax gives the port's own tree; cache_from_jax turns
    crane_tpu's conv windows into ConvLayerCaches; a decode started from
    that cache reproduces the logits of one prefill over the whole
    sequence."""
    jl, tl = pair
    same_leaves(params_from_jax(jl.params), jl.params)
    seq = np.asarray([ids(11, 5)], np.int32)
    h, _ = ttf.forward_hidden(tl.config, tl.params, torch.tensor(seq), tl.init_cache(1, 32), 0,
                              tl.rope, read_cache=False)
    full = ttf.lm_logits(tl.config, tl.params, h)[0]
    pad = np.zeros((1, 8), np.int32)
    pad[0, :6] = seq[0, :6]
    jlog, jc = jl.prefill(jl.init_cache(1, 32), pad, [6])
    cache = cache_from_jax(jc)
    assert [type(c) for c in cache.layers] == LAYOUT
    close_caches(cache, jc)
    np.testing.assert_allclose(np.asarray(jlog)[0], full[5].numpy(), **TOL)
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


def test_chunked_prefill_equals_whole(pair):
    """A slot prefill plus a continuation chunk into row 1 of a 2-slot cache
    (the chunk re-enters the window through the row's view) gives the
    logits of one whole slot prefill, and the row's windows equal
    crane_tpu's; row 0 stays zero."""
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
    assert tc.layers[0].conv_state[0].abs().sum() == 0


@pytest.mark.parametrize("scenario,kw", [
    (mixed, dict(max_slots=3, max_seq_len=256, prefill_chunk=16, bucket_align=16,
                 decode_tokens_per_seq=4, prefix_reuse_min=16)),
    (mixed, dict(max_slots=3, max_seq_len=256, decode_tokens_per_seq=4)),
    (preempt, dict(max_slots=1, max_seq_len=128, decode_tokens_per_seq=2, preempt_after_s=0.0)),
], ids=["chunked", "whole", "preempt"])
def test_engine_matches_crane_tpu(pair, scenario, kw):
    """Chunked admission, whole-prompt admission, and preemption with
    re-prefill: tokens and statistics equal crane_tpu's, prefix reuse stays
    off (the conv windows summarize the end of a row), and chunked tokens
    equal whole-prompt tokens."""
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


def test_short_conv_models_never_speculate(pair):
    """crane_tpu's gate: a model with short-conv layers takes plain decoding
    under speculative="ngram", in generate and in the engine (no history
    rows, no speculative block), with crane_tpu's greedy tokens."""
    jl, tl = pair
    prompt = [5, 6, 7, 8] * 6
    expected = jl.generate(prompt, JGenerationConfig.greedy(8))
    assert tl.generate(prompt, GenerationConfig.greedy(8, speculative="ngram")) == expected
    engine = InferenceEngine(tl, max_slots=2, max_seq_len=128, speculative="ngram")
    assert engine.history is None and engine.prefix_cache is False
    [got] = [_drain(q) for q in _after(engine, [engine.submit(request(engine, "h", prompt, 8))])]
    assert got == expected and engine.stats.spec_steps == 0


def test_memory_budget_counts_conv_windows(pair, monkeypatch):
    """The budget sizes the cache on the meta device: one KV layer plus
    three conv windows of ``[slots, L, hidden]``."""
    _, tl = pair
    from crane_tpu_torch.serve.engine import _tree_bytes

    cfg = tl.config
    slots, seq = 2, 512
    kv = 2 * slots * seq * cfg.num_kv_heads * cfg.head_dim * 4
    conv = 3 * slots * cfg.conv_l_cache * cfg.hidden_size * 4
    cache = tl.init_cache(slots, seq, device="meta")
    assert cache.nbytes() == kv + conv + 4 * slots
    assert cache.layers[0].nbytes() == conv // 3 and cache.row(1).layers[0].nbytes() == conv // 6
    need = int((_tree_bytes(tl.params) + kv + conv + 4 * slots) * 1.15)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need))
    InferenceEngine(tl, max_slots=slots, max_seq_len=seq)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need - 1))
    with pytest.raises(RuntimeError, match="HBM budget exceeded"):
        InferenceEngine(tl, max_slots=slots, max_seq_len=seq)


def test_int8_kv_on_the_attention_layer(pair):
    """An int8 cache quantizes the attention layer only (conv layers keep
    their windows); prefill and a decode step against crane_tpu."""
    jl, tl = pair
    pad = np.zeros((1, 8), np.int32)
    pad[0, :5] = ids(5, 16)
    jlog, jc = jl.prefill(jl.init_cache(1, 64, quant_bits=8), pad, [5])
    tlog, tc = tl.prefill(tl.init_cache(1, 64, quant_bits=8), pad, [5])
    assert [type(c) for c in tc.layers] == [ConvLayerCache] * 2 + [QuantLayerKVCache,
                                                                   ConvLayerCache]
    close(tlog, jlog)
    tok = np.asarray([[int(np.argmax(np.asarray(jlog)[0]))]], np.int32)
    jh, _ = jtf.forward_hidden(jl.config, jl.params, jnp.asarray(tok), jc, jc.lengths, jl.rope)
    th, _ = ttf.forward_hidden(tl.config, tl.params, torch.tensor(tok), tc, tc.lengths, tl.rope)
    close(ttf.lm_logits(tl.config, tl.params, th), jtf.lm_logits(jl.config, jl.params, jh))


# LFM2-1.2B's config fields in miniature: hybrid layers, tied head,
# block_auto_adjust_ff_dim (which both packages ignore)
TINY_LFM2 = {
    "model_type": "lfm2", "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 96,
    "block_auto_adjust_ff_dim": True, "norm_eps": 1e-5, "rope_theta": 1e6,
    "conv_L_cache": 3, "conv_bias": True, "tie_word_embeddings": True,
    "layer_types": ["conv", "full_attention", "conv"],
}


def test_random_hf_checkpoint_maps_like_crane_tpu():
    """The smoke run's weights: a seeded state dict in LFM2's HF layout
    (with a conv bias), its MLP drawn 64 wide where the config reads 96 (a
    checkpoint's adjusted width, which the config as both packages read it
    does not give), mapped by both packages' map_hf_weights leaf for leaf;
    init_params draws the same tree; one prefill through both."""
    cfg, jcfg = (m.transformer_config_from_hf(TINY_LFM2) for m in (tauto, jauto))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.intermediate_size == 96 and cfg.rms_norm_eps == 1e-5 and cfg.conv_bias
    drawn_cfg = dataclasses.replace(cfg, intermediate_size=64)
    sd = tinit.hf_state_dict(drawn_cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    assert "model.embedding_norm.weight" in sd and "model.layers.1.self_attn.out_proj.weight" in sd
    tp = tauto.map_hf_weights(cfg, sd, torch.float32)
    jp = jauto.map_hf_weights(jcfg, {k: v.numpy() for k, v in sd.items()}, jnp.float32)
    same_leaves(tp, jp)
    assert tp["layers"][0]["mlp"]["gate"].shape == (32, 64) and "conv_b" in tp["layers"][0]["conv"]
    drawn = tinit.init_params(drawn_cfg, torch.Generator().manual_seed(0), device="cpu",
                              dtype=torch.float32)
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), drawn)
    assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)
    toks = np.asarray([ids(9, 17)], np.int32) % 64
    jh, _ = jtf.forward_hidden(jcfg, jp, jnp.asarray(toks), jtf.make_cache(jcfg, 1, 16, jnp.float32),
                               jnp.asarray(0, jnp.int32), jtf.make_rope_tables(jcfg))
    th, _ = ttf.forward_hidden(cfg, tp, torch.tensor(toks), ttf.make_cache(cfg, 1, 16, torch.float32),
                               0, ttf.make_rope_tables(cfg))
    close(th, jh)
