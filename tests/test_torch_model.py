"""crane_tpu_torch models against crane_tpu on the same weights (CPU, fp32).

Weights are crane_tpu's, handed to the port through
``crane_tpu_torch.utils.bridge.params_from_jax``. Hidden states and logits
agree within rtol/atol 2e-4 (tests/test_model_parity.py's bar); greedy
tokens are identical.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models import auto as jauto
from crane_tpu.models import init as jinit
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.modules import transformer as jtf
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import auto as tauto
from crane_tpu_torch.models import init as tinit
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = jinit.QWEN3_TINY


def _with_random_leaves(params, names, seed, scale=0.1):
    """Replace the named leaves (biases, extra norms) by random values so
    the tests see them act."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        layer = {k: dict(v) if isinstance(v, dict) else v for k, v in layer.items()}
        for name in names:
            sub, key = name.split(".") if "." in name else (None, name)
            tgt = layer[sub] if sub else layer
            shape = tgt[key].shape if key in tgt else (TINY.hidden_size,)
            tgt[key] = jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32)
        layers.append(layer)
    out["layers"] = tuple(layers)
    return out


def _config(kind):
    """(jax cfg, port cfg, jax params) for one dense family variant."""
    fields = {}
    extra = []
    if kind == "qwen2":  # attn biases, no QK-norm, untied head
        fields = dict(qk_norm=False, attn_bias=True, tie_word_embeddings=False)
        extra = ["attn.bq", "attn.bk", "attn.bv"]
    elif kind == "hunyuan":  # QK-norm after RoPE
        fields = dict(qk_norm_after_rope=True)
    elif kind == "llama3_interleaved":
        fields = dict(qk_norm=False, rope_mode="interleaved",
                      rope_llama3=(8.0, 1.0, 4.0, 64))
    elif kind == "gemma3":  # sandwich norms, sliding layers, softcaps, gelu
        fields = dict(norm_weight_offset=1.0, sandwich_norms=True,
                      layer_types=("sliding", "full"), sliding_window=6,
                      rope_local_theta=10000.0, rope_theta=1e6, query_scale=0.2,
                      embed_scale=TINY.hidden_size ** 0.5, act="gelu_tanh",
                      attn_logit_softcap=20.0, logit_softcap=15.0,
                      rope_scaling_factor=2.0)
        extra = ["post_attn_ln", "pre_ffn_ln", "post_ffn_ln", "input_ln", "attn.q_norm"]
    jcfg = dataclasses.replace(TINY, max_position_embeddings=512, **fields)
    params = jinit.init_params(jcfg, seed=3, dtype=jnp.float32)
    if extra:
        params = _with_random_leaves(params, extra, seed=4)
    tcfg = ttf.TransformerConfig(**{f.name: getattr(jcfg, f.name)
                                    for f in dataclasses.fields(jcfg)})
    return jcfg, tcfg, params


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jtf.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttf.TransformerConfig)}
    assert list(jf) == list(tf)
    assert jf == tf
    assert tinit.QWEN3_0_6B == ttf.TransformerConfig(**dataclasses.asdict(jinit.QWEN3_0_6B))
    assert tinit.QWEN3_TINY == ttf.TransformerConfig(**dataclasses.asdict(jinit.QWEN3_TINY))


def test_rope_tables_match():
    for kind in ("gemma3", "llama3_interleaved"):
        jcfg, tcfg, _ = _config(kind)
        j, t = jtf.make_rope_tables(jcfg), ttf.make_rope_tables(tcfg)
        assert set(j) == set(t)
        for name in j:
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["qwen3", "qwen2", "hunyuan", "llama3_interleaved", "gemma3"])
def test_forward_hidden_prefill_continue_decode(kind):
    """A fresh prefill (K2's path), a continuation chunk over the cache
    (K3's) and a batched decode step with an inactive row (K1's), each
    against crane_tpu's forward_hidden on the same weights."""
    jcfg, tcfg, jp = _config(kind)
    tp = params_from_jax(jp)
    B, T = 2, 32
    rng = np.random.default_rng(5)
    toks = rng.integers(1, TINY.vocab_size, (B, 20)).astype(np.int32)
    jrope, trope = jtf.make_rope_tables(jcfg), ttf.make_rope_tables(tcfg)
    jc = jtf.make_cache(jcfg, B, T, jnp.float32)
    tc = ttf.make_cache(tcfg, B, T, torch.float32)

    def both(tokens, jpos, tpos, **kw):
        nonlocal jc, tc
        jh, jc = jtf.forward_hidden(jcfg, jp, jnp.asarray(tokens), jc, jpos, jrope, **kw)
        jkw = {k: (torch.tensor(np.asarray(v)) if k == "active" else v) for k, v in kw.items()}
        th, tc = ttf.forward_hidden(tcfg, tp, torch.tensor(tokens), tc, tpos, trope, **jkw)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(ttf.lm_logits(tcfg, tp, th).numpy(),
                                   np.asarray(jtf.lm_logits(jcfg, jp, jh)), **TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    both(toks[:, :12], jnp.asarray(0, jnp.int32), 0, read_cache=False)
    both(toks[:, 12:], jnp.asarray(12, jnp.int32), 12)
    active = np.array([True, False])
    pos = np.asarray(jc.lengths)
    both(toks[:, :1], jnp.asarray(pos), torch.tensor(pos), active=active)
    for jl, tl in zip(jc.layers, tc.layers):
        np.testing.assert_allclose(tl.k.numpy(), np.asarray(jl.k), **TOL)
        np.testing.assert_allclose(tl.v.numpy(), np.asarray(jl.v), **TOL)


@pytest.fixture(scope="module")
def tiny_pair():
    jp = jinit.init_params(TINY, seed=0, dtype=jnp.float32)
    return (JLM(TINY, jp, dtype=jnp.float32),
            TLM(tinit.QWEN3_TINY, params_from_jax(jp), dtype=torch.float32))


def test_causal_lm_prefill_logits(tiny_pair):
    """Batched prefill with ragged true lengths: fresh from 0 (in-context
    attention), then a second chunk at start 16 over the cache.

    For a chunk at start > 0, crane_tpu's ``_prefill`` reads the last token
    at ``start + true - 1`` of the chunk's hidden states, an absolute index
    that JAX clamps into the chunk (ROADMAP Queue 3); the port reads
    ``true - 1``, checked against crane_tpu's forward_hidden."""
    jl, tl = tiny_pair
    toks = np.random.default_rng(8).integers(1, 500, (2, 32)).astype(np.int32)
    jc, tc = jl.init_cache(2, 64), tl.init_cache(2, 64)
    jlog, jc = jl.prefill(jc, toks[:, :16], [11, 16])
    tlog, tc = tl.prefill(tc, toks[:, :16], [11, 16])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    chunk = toks[:, 16:]
    jh, _ = jtf.forward_hidden(TINY, jl.params, jnp.asarray(chunk), jc,
                               jnp.asarray(16, jnp.int32), jl.rope)
    ref = jtf.lm_logits(TINY, jl.params, jh[jnp.arange(2), jnp.array([15, 8])][:, None])[:, 0]
    tlog, tc = tl.prefill(tc, chunk, [16, 9], start=16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), [27, 25])


def test_causal_lm_slot_prefill_continue_and_decode(tiny_pair):
    """CausalLM's serving steps on a 3-slot cache: a slot prefill, a
    continuation chunk into that row, then a decode step; logits and tokens
    against crane_tpu's jitted steps."""
    jl, tl = tiny_pair
    rng = np.random.default_rng(6)
    first = np.zeros((1, 16), np.int32)
    first[0, :11] = rng.integers(1, 500, 11)
    cont = np.zeros((1, 16), np.int32)
    cont[0, :9] = rng.integers(1, 500, 9)
    jc, tc = jl.init_cache(3, 64), tl.init_cache(3, 64)
    jlog, jc = jl.prefill_slot(jc, first, 1, 11)
    tlog, tc = tl.prefill_slot(tc, first, 1, 11)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jlog, jc = jl.prefill_slot_continue(jc, cont, 1, 11, 9)
    tlog, tc = tl.prefill_slot_continue(tc, cont, 1, 11, 9)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), [0, 20, 0])
    np.testing.assert_array_equal(tc.layers[0].k[[0, 2]].numpy(), 0.0)  # other rows untouched
    np.testing.assert_allclose(tc.layers[1].k.numpy(), np.asarray(jc.layers[1].k), **TOL)

    from crane_tpu.ops.sampling import SamplingParams as JSP
    from crane_tpu_torch.ops.sampling import SamplingParams as TSP

    cur = np.array([0, int(np.argmax(jlog)), 0], np.int32)
    active = np.array([False, True, False])
    jt, jc, _ = jl.decode_active(jc, cur, jnp.full((3, 4), -1, jnp.int32),
                                 JSP.make(3, do_sample=False), jax.random.PRNGKey(0), active, 3)
    tt, tc, _ = tl.decode_active(tc, cur, torch.full((3, 4), -1, dtype=torch.int32),
                                 TSP.make(3, do_sample=False), torch.Generator(), active, 3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_generate_greedy_tokens_identical(tiny_pair, penalty):
    jl, tl = tiny_pair
    prompt = list(np.random.default_rng(7).integers(1, 500, 70))  # crosses a bucket
    assert tl.generate(prompt, GenerationConfig.greedy(24, repetition_penalty=penalty)) == \
        jl.generate(prompt, JGenerationConfig.greedy(24, repetition_penalty=penalty))


def test_generate_streams_and_stops_on_eos(tiny_pair):
    _, tl = tiny_pair
    full = tl.generate([3, 14, 15], GenerationConfig.greedy(12))
    eos = full[4]
    seen = []

    class Streamer:
        def append(self, t):
            seen.append(t)

        def finalize(self):
            seen.append("end")

    out = tl.generate([3, 14, 15], GenerationConfig.greedy(12, eos_token_ids=(eos,)), Streamer())
    assert out == full[:full.index(eos) + 1] and seen == out + ["end"]


def test_from_pretrained_matches_crane_tpu(tmp_path):
    from tests.fixtures import make_tiny_qwen3_checkpoint

    d = make_tiny_qwen3_checkpoint(str(tmp_path / "ckpt"))
    jl = jauto.from_pretrained(d, dtype=jnp.float32)
    tl = tauto.from_pretrained(d, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(tl.config) == dataclasses.asdict(jl.config)
    assert tl.eos_token_ids == jl.eos_token_ids
    assert tl.tokenizer is not None
    jflat = jax.tree_util.tree_leaves_with_path(jl.params)
    tflat = jax.tree_util.tree_leaves_with_path(tl.params)
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    prompt = [3, 14, 15, 42, 6]  # the checkpoint's vocabulary has 67 ids
    assert tl.generate(prompt, GenerationConfig.greedy(10)) == \
        jl.generate(prompt, JGenerationConfig.greedy(10))


def test_entry_points_default_to_the_card():
    """from_pretrained and init_params place weights on the card unless
    told otherwise; with no card they raise rather than fall back to the
    CPU."""
    if torch.cuda.is_available():
        assert tinit.init_params(tinit.QWEN3_TINY, torch.Generator().manual_seed(0))["embed"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinit.init_params(tinit.QWEN3_TINY, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tauto.from_pretrained("any-checkpoint")
    p = tinit.init_params(tinit.QWEN3_TINY, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].device.type == "cpu"


def test_once_refused_branches_build(tiny_pair, tmp_path):
    """What the port refused in its earlier slices and builds now, and what
    it still refuses: int8/int4 caches are allocated; an MoE config and a
    short-conv config build their caches (a GDN/KV cache beside the MoE
    MLPs, a ``[B, L, hidden]`` window per conv layer) and their configs from
    HF dicts; a gemma3n config, which ``main()`` refused until the model
    was ported, now gives crane_tpu's ``Gemma3nConfig`` and goes to its
    loader (a directory with no weights then fails to load)."""
    from crane_tpu_torch.ops.kv_cache import ConvLayerCache, LayerKVCache
    from crane_tpu_torch.serve.api import main

    _, tl = tiny_pair
    for bits in (8, 4):
        cache = tl.init_cache(1, 64, quant_bits=bits)
        assert all(layer.bits == bits for layer in cache.layers)
    moe = dataclasses.replace(tinit.QWEN3_TINY, num_experts=4, moe_intermediate_size=16)
    short_conv = dataclasses.replace(tinit.QWEN3_TINY, layer_types=("conv", "full"))
    assert [type(c) for c in ttf.make_cache(moe, 1, 16).layers] == [LayerKVCache] * 2
    conv_cache = ttf.make_cache(short_conv, 1, 16)
    assert [type(c) for c in conv_cache.layers] == [ConvLayerCache, LayerKVCache]
    assert conv_cache.layers[0].conv_state.shape == (1, 3, short_conv.hidden_size)
    next_moe = {"model_type": "qwen3_next", "vocab_size": 64, "hidden_size": 32,
                "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
                "head_dim": 16, "intermediate_size": 48,
                "layer_types": ["linear_attention", "full_attention"],
                "linear_num_value_heads": 2, "linear_num_key_heads": 2,
                "linear_key_head_dim": 8, "linear_value_head_dim": 8, "num_experts": 8,
                "num_experts_per_tok": 2, "moe_intermediate_size": 16}
    lfm2 = {"model_type": "lfm2", "vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 2, "num_key_value_heads": 1, "intermediate_size": 48,
            "layer_types": ["conv", "full_attention"]}
    for hf in (next_moe, lfm2):
        cfg = tauto.transformer_config_from_hf(hf)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jauto.transformer_config_from_hf(hf))
    assert tauto.transformer_config_from_hf(next_moe).is_moe_layer(1)
    assert tauto.transformer_config_from_hf(lfm2).layer_types == ("conv", "full")
    from crane_tpu.models.gemma3n import config_from_hf as jg3n_config
    from crane_tpu_torch.models.gemma3n import config_from_hf as tg3n_config

    gemma3n = {"model_type": "gemma3n_text", "vocab_size": 64, "hidden_size": 32,
               "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
               "head_dim": 16, "intermediate_size": 48, "num_kv_shared_layers": 1}
    assert dataclasses.asdict(tg3n_config(gemma3n)) == dataclasses.asdict(jg3n_config(gemma3n))
    (tmp_path / "config.json").write_text(json.dumps(gemma3n))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        main(["--model-path", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("gate,bias", [(False, False), (True, False), (True, True)])
def test_init_params_shapes_match_crane_tpu(gate, bias):
    """init_params draws crane_tpu's tree: with ``attn_output_gate`` the q
    projection (and its bias) is ``H * D * 2`` wide, ``[query | gate]``."""
    jcfg = dataclasses.replace(TINY, attn_output_gate=gate, attn_bias=bias)
    tcfg = ttf.TransformerConfig(**dataclasses.asdict(jcfg))
    jp = jinit.init_params(jcfg, seed=0, dtype=jnp.float32)
    tp = tinit.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    tflat = jax.tree_util.tree_leaves_with_path(tp)
    assert [(p, tuple(j.shape)) for p, j in jflat] == [(p, tuple(t.shape)) for p, t in tflat]
    wq = tp["layers"][0]["attn"]["wq"]
    assert wq.shape == (TINY.hidden_size, TINY.num_heads * TINY.head_dim * (2 if gate else 1))
