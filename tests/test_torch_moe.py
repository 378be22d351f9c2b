"""The sparse-MoE Qwen3-Next hybrid in crane_tpu_torch against crane_tpu, on
one tiny checkpoint (CPU, f32).

The checkpoint is tests/test_moe_parity.py's: 4 layers (3 GDN, 1 gated
attention), 8 experts with top-2 routing renormalised and a shared expert,
layer 1 a dense MLP (``mlp_only_layers``), saved by transformers and loaded
by both ``from_pretrained``s. ``moe_block`` is held against crane_tpu's with
both dispatches (dense, and ``CRANE_MOE_DISPATCH=ragged``, the reference's
own switch) on seeded numpy weights; logits agree within rtol/atol 2e-4 (the
other port tests' bar); greedy tokens, through ``generate`` and through the
engine (whole and chunked admission, and preemption), are identical.
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
from crane_tpu_torch.ops.kv_cache import GdnLayerCache, LayerKVCache
from crane_tpu_torch.serve.engine import InferenceEngine
from crane_tpu_torch.utils.bridge import cache_from_jax, params_from_jax
from tests.test_moe_parity import tiny  # noqa: F401  (the checkpoint fixture)
from tests.test_torch_hybrid import STAT_KEYS, TOL, _after, close, ids, mixed, preempt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair(tiny):  # noqa: F811
    _, d = tiny
    return (jauto.from_pretrained(d, dtype=jnp.float32),
            tauto.from_pretrained(d, dtype=torch.float32, device="cpu"))


def close_caches(tc, jc):
    """Every layer's tensors (GDN, short-conv, KV) and the lengths against
    crane_tpu's cache, leaf for leaf."""
    for tl, jl in zip(tc.layers, jc.layers):
        refs = jax.tree_util.tree_leaves(jl)
        assert len(tl.tensors()) == len(refs)
        for got, ref in zip(tl.tensors(), refs):
            close(got, ref)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def same_leaves(tp, jp):
    """Two parameter trees with the same paths and byte-identical leaves."""
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    tflat = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_config_weights_and_cache_layout_match(pair):
    """The MoE config fields, the mapped tree (``_map_moe``'s stacked
    experts, router and shared expert; the dense MLP of layer 1) leaf for
    leaf, and the cache layout against crane_tpu's."""
    jl, tl = pair
    assert dataclasses.asdict(tl.config) == dataclasses.asdict(jl.config)
    cfg = tl.config
    assert cfg.num_experts == 8 and cfg.num_experts_per_tok == 2 and cfg.mlp_only_layers == (1,)
    assert [cfg.is_moe_layer(i) for i in range(4)] == [jl.config.is_moe_layer(i) for i in range(4)] \
        == [True, False, True, True]
    same_leaves(tl.params, jl.params)
    mlp = tl.params["layers"][0]["mlp"]
    assert mlp["experts_gate"].shape == (8, 64, 32) and mlp["experts_down"].shape == (8, 32, 64)
    assert mlp["shared_gate"].shape == (64, 1) and "router" not in tl.params["layers"][1]["mlp"]
    cache, jcache = tl.init_cache(2, 64), jl.init_cache(2, 64)
    assert [type(c) for c in cache.layers] == [GdnLayerCache] * 3 + [LayerKVCache]
    for tc, jc in zip(cache.layers, jcache.layers):
        assert [tuple(x.shape) for x in tc.tensors()] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]


def moe_weights(n_exp, E, I, shared, seed):
    """Seeded numpy weights of one sparse-MoE MLP (router, stacked experts,
    and a shared expert with its gate when ``shared``)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)

    p = {"router": w(E, n_exp), "experts_gate": w(n_exp, E, I), "experts_up": w(n_exp, E, I),
         "experts_down": w(n_exp, I, E)}
    if shared:
        p.update(shared_gate_proj=w(E, shared), shared_up=w(E, shared),
                 shared_down=w(shared, E), shared_gate=w(E, 1))
    return p


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
@pytest.mark.parametrize("norm_topk,shared", [(True, 40), (False, 0)],
                         ids=["renorm-shared", "raw-noshared"])
def test_moe_block_matches_crane_tpu(dispatch, norm_topk, shared, monkeypatch):
    """moe_block (through mlp_block, which routes on the router) against
    crane_tpu's on the same numpy weights and input, with each dispatch
    (both packages read ``CRANE_MOE_DISPATCH``), with and without the
    renormalised top-k and the shared expert."""
    cfg = ttf.TransformerConfig(
        vocab_size=16, hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=2, head_dim=16,
        intermediate_size=64, num_experts=8, num_experts_per_tok=3, moe_intermediate_size=24,
        shared_expert_intermediate_size=shared, norm_topk_prob=norm_topk)
    jcfg = jtf.TransformerConfig(**dataclasses.asdict(cfg))
    p = moe_weights(8, 32, 24, shared, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 7, 32)).astype(np.float32)
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    got = ttf.mlp_block(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    ref = jtf.mlp_block(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    close(got, ref)


def test_dispatches_agree(monkeypatch):
    """The token-sorted grouped dispatch reproduces the dense one (13 tokens,
    top-3 of 8: uneven groups, some experts empty), and the dense dispatch
    cut into token blocks (MOE_BLOCK_ELEMENTS) equals it in one block."""
    cfg = ttf.TransformerConfig(
        vocab_size=16, hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=2, head_dim=16,
        intermediate_size=64, num_experts=8, num_experts_per_tok=3, moe_intermediate_size=24)
    p = {k: torch.from_numpy(v) for k, v in moe_weights(8, 32, 24, 0, seed=3).items()}
    rng = np.random.default_rng(4)
    xt = torch.from_numpy(rng.standard_normal((13, 32)).astype(np.float32))
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((13, 8)).astype(np.float32)), -1)
    w, sel = torch.topk(probs, 3)
    w = w / w.sum(-1, keepdim=True)
    assert len(set(sel.reshape(-1).tolist())) <= 8
    dense = ttf._moe_dispatch_dense(cfg, p, xt, w, sel)
    ragged = ttf._moe_dispatch_ragged(cfg, p, xt, w, sel)
    np.testing.assert_allclose(ragged.numpy(), dense.numpy(), rtol=1e-4, atol=1e-5)
    monkeypatch.setattr(ttf, "MOE_BLOCK_ELEMENTS", 8 * 24 * 4)  # blocks of 4 tokens
    blocked = ttf._moe_dispatch_dense(cfg, p, xt, w, sel)
    np.testing.assert_allclose(blocked.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)


def test_forward_hidden_prefill_continuation_decode(pair):
    """A fresh prefill of two rows, a continuation chunk over the cache and
    a masked decode step: hidden states, logits and every layer's state
    against crane_tpu's forward_hidden."""
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


def test_padded_batch_prefill(pair):
    """A bucket-padded batched prefill (true lengths 9 and 16 in a 16-token
    bucket): last-token logits and states against crane_tpu, and the short
    row's logits equal to those of its unpadded prompt."""
    jl, tl = pair
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1] = ids(9, 3), ids(16, 4)
    jlog, jc = jl.prefill(jl.init_cache(2, 64), toks, [9, 16])
    tlog, tc = tl.prefill(tl.init_cache(2, 64), toks, [9, 16])
    close(tlog, jlog)
    close_caches(tc, jc)
    short_log, _ = tl.prefill(tl.init_cache(1, 64), toks[:1, :9], [9])
    np.testing.assert_allclose(tlog[0].numpy(), short_log[0].numpy(), **TOL)


def test_round_trips_and_decode_from_crane_tpu_cache(pair):
    """params_from_jax gives the port's own tree; a decode started from
    crane_tpu's prefilled cache (cache_from_jax) reproduces the logits of
    one prefill over the whole sequence."""
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
    close_caches(cache, jc)
    np.testing.assert_allclose(np.asarray(jlog)[0], full[5].numpy(), **TOL)
    for s in range(6, 11):
        h, cache = ttf.forward_hidden(tl.config, tl.params, torch.tensor(seq[:, s:s + 1]), cache,
                                      cache.lengths, tl.rope)
        close(ttf.lm_logits(tl.config, tl.params, h)[0, 0], full[s].numpy())


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_generate_greedy_tokens_identical(pair, dispatch, monkeypatch):
    jl, tl = pair
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    prompt = ids(70, 6)  # crosses the 64-token bucket
    assert tl.generate(prompt, GenerationConfig.greedy(16)) == \
        jl.generate(prompt, JGenerationConfig.greedy(16))


def test_slot_prefill_and_continuation_match_whole(pair):
    """A slot prefill plus a continuation chunk into row 1 of a 2-slot cache
    gives the logits of one whole slot prefill, and the row's states equal
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
    assert tc.layers[0].recurrent_state[0].abs().sum() == 0


@pytest.mark.parametrize("scenario,kw", [
    (mixed, dict(max_slots=3, max_seq_len=256, prefill_chunk=16, bucket_align=16,
                 decode_tokens_per_seq=4, prefix_reuse_min=16)),
    (mixed, dict(max_slots=3, max_seq_len=256, decode_tokens_per_seq=4)),
    (preempt, dict(max_slots=1, max_seq_len=128, decode_tokens_per_seq=2, preempt_after_s=0.0)),
], ids=["chunked", "whole", "preempt"])
def test_engine_matches_crane_tpu(pair, scenario, kw):
    """Chunked admission, whole-prompt admission, and preemption with
    re-prefill: tokens and statistics equal crane_tpu's, prefix reuse stays
    off (GDN layers), and chunked tokens equal whole-prompt tokens."""
    jl, tl = pair
    jeng, teng = JEngine(jl, **kw), InferenceEngine(tl, **kw)
    assert teng.prefix_cache is False and jeng.prefix_cache is False and teng.history is None
    got = scenario(teng)
    assert got == scenario(jeng)
    js, ts = jeng.stats.snapshot(), teng.stats.snapshot()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    if scenario is mixed:
        assert got[:3] == [tl.generate(p, GenerationConfig.greedy(8))
                           for p in (ids(5, 10), ids(40, 11), ids(70, 12))]


# a tiny Qwen3-Next MoE config in the HF layout: every layer sparse but
# layer 2, 4 experts top-2, a shared expert
TINY_NEXT_MOE = {
    "model_type": "qwen3_next", "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 4,
    "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 16,
    "intermediate_size": 48, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "partial_rotary_factor": 0.25,
    "layer_types": ["linear_attention"] * 3 + ["full_attention"],
    "linear_num_value_heads": 4, "linear_num_key_heads": 2, "linear_key_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_dim": 4,
    "num_experts": 4, "num_experts_per_tok": 2, "moe_intermediate_size": 16,
    "shared_expert_intermediate_size": 24, "norm_topk_prob": True, "mlp_only_layers": [2],
}


def test_random_hf_checkpoint_maps_like_crane_tpu():
    """The smoke run's weights: a seeded HF-layout state dict (one tensor
    per expert) mapped by both packages' map_hf_weights, leaf for leaf;
    init_params draws the same tree (paths, shapes, dtypes); one prefill
    through both."""
    cfg, jcfg = (m.transformer_config_from_hf(TINY_NEXT_MOE) for m in (tauto, jauto))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = tinit.hf_state_dict(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    assert "model.layers.0.mlp.experts.3.down_proj.weight" in sd
    assert "model.layers.2.mlp.gate_proj.weight" in sd
    tp = tauto.map_hf_weights(cfg, sd, torch.float32)
    jp = jauto.map_hf_weights(jcfg, {k: v.numpy() for k, v in sd.items()}, jnp.float32)
    same_leaves(tp, jp)
    drawn = tinit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                              dtype=torch.float32)
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), drawn)
    assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)
    toks = np.asarray([ids(9, 17)], np.int32) % 64
    jh, _ = jtf.forward_hidden(jcfg, jp, jnp.asarray(toks), jtf.make_cache(jcfg, 1, 16, jnp.float32),
                               jnp.asarray(0, jnp.int32), jtf.make_rope_tables(jcfg))
    th, _ = ttf.forward_hidden(cfg, tp, torch.tensor(toks), ttf.make_cache(cfg, 1, 16, torch.float32),
                               0, ttf.make_rope_tables(cfg))
    close(th, jh)


def test_quantize_params_leaves_the_experts_dense(pair):
    """ISQ quantizes the attention and the dense MLP's 2-D linears, as the
    reference does; routers, stacked and shared experts and the GDN
    projections stay dense."""
    from crane_tpu_torch.ops.linear import QuantizedWeight

    _, tl = pair
    q = tauto.quantize_params(tl.params, bits=8)
    moe, dense = q["layers"][0]["mlp"], q["layers"][1]["mlp"]
    assert not any(isinstance(v, QuantizedWeight) for v in moe.values())
    assert all(isinstance(dense[k], QuantizedWeight) for k in ("gate", "up", "down"))
    assert isinstance(q["layers"][3]["attn"]["wq"], QuantizedWeight)
    assert not isinstance(q["layers"][0]["gdn"]["in_proj_qkvz"], QuantizedWeight)
