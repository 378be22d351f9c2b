"""Projection fusion in crane_tpu_torch against crane_tpu, on the CPU.

The counterparts of tests/test_fuse.py, on the same numpy-seeded weights in
both packages (crane_tpu's ``init_params`` through the bridge): ``wq|wk|wv``
-> ``wqkv`` and ``gate|up`` -> ``gate_up`` give the unfused greedy tokens
and crane_tpu's fused ones; float32 logits agree with crane_tpu's fused
model within 1e-5 (tests/test_fuse.py's bar between fused and unfused);
fuse/unfuse round trips and the fused trees themselves are byte-identical
to crane_tpu's, dense, int8 and packed int4; MoE layers and layers missing
a projection pass through; tensor parallelism unfuses first and sequence
parallelism keeps the fused tree; a q8_0 GGUF model and a tiny Qwen3.5
(its q projection twice as wide, ``[query | gate]``) fuse under
``CRANE_FUSE_PROJ=1``. The fused product's slices reach the attention calls
and the cache write as contiguous tensors, as the kernels require.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models import auto as jauto
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.fuse import fuse_params as jfuse_params
from crane_tpu.models.init import init_params as jinit_params
from crane_tpu.models.modules.transformer import TransformerConfig as JConfig
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import auto as tauto
from crane_tpu_torch.models import init as tinit
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.fuse import fuse_params, qkv_sizes, unfuse_params
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.linear import QuantizedWeight
from crane_tpu_torch.parallel.inference import shard_lm
from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm
from crane_tpu_torch.parallel.sharding import make_mesh
from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions
from crane_tpu_torch.utils.bridge import params_from_jax
from tests.fixtures import make_tiny_qwen3_checkpoint
from tests.test_gguf import write_gguf
from tests.test_gguf_model import _gguf_metadata
from tests.test_torch_gguf import gguf_tensors

torch.set_num_threads(2)

LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_fuse.py's
# tests/test_fuse.py's configs
CFG = JConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=16, intermediate_size=96, qk_norm=True, tie_word_embeddings=True)
CFG_BIAS = JConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                   head_dim=16, intermediate_size=96, attn_bias=True, tie_word_embeddings=True)
PROMPT = [3, 17, 99, 42, 7]
IDS = np.arange(1, 9, dtype=np.int32)[None]
GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)


def jparams_of(cfg, quant=None):
    """crane_tpu's float32 weights for ``cfg`` (biases drawn with numpy, as
    tests/test_fuse.py draws them), quantized in situ at ``quant`` bits."""
    p = jinit_params(cfg, seed=0, dtype=jnp.float32)
    if cfg.attn_bias:
        rng = np.random.default_rng(5)
        for layer in p["layers"]:
            for b, n in (("bq", 64), ("bk", 32), ("bv", 32)):
                layer["attn"][b] = jnp.asarray(rng.normal(size=n) * 0.02, jnp.float32)
    if quant is not None:
        p = jauto.quantize_params(p, bits=quant, quant_tied_head=False)
    return p


def port_cfg(jcfg):
    return ttf.TransformerConfig(**dataclasses.asdict(jcfg))


def pair(cfg, quant=None, fuse=True):
    """(crane_tpu's model, the port's) on the same weights, both float32."""
    jp = jparams_of(cfg, quant)
    jl = JLM(cfg, jp, dtype=jnp.float32, fuse=fuse)
    return jl, TLM(port_cfg(cfg), params_from_jax(jp), dtype=torch.float32, fuse=fuse)


def prefill_logits(lm, as_numpy):
    logits, _ = lm.prefill(lm.init_cache(1, 64), IDS, [8])
    return as_numpy(logits)


def same_leaf(t, j):
    if isinstance(t, QuantizedWeight):
        assert (t.bits, t.block, t.packed) == (j.bits, j.block, j.packed)
        for a, b in ((t.codes, j.codes), (t.scales, j.scales)):
            assert a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        assert t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def same_tree(t, j):
    """Equal keys and byte-identical leaves; QuantizedWeight metadata equal."""
    if isinstance(j, dict):
        assert sorted(t) == sorted(j)
        for k in j:
            same_tree(t[k], j[k])
    elif isinstance(j, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            same_tree(a, b)
    else:
        same_leaf(t, j)


@pytest.mark.parametrize("cfg", [CFG, CFG_BIAS], ids=["nobias", "bias"])
def test_fused_generate_matches_unfused_and_crane_tpu(cfg):
    jl, tl = pair(cfg)
    unfused = TLM(port_cfg(cfg), params_from_jax(jparams_of(cfg)), dtype=torch.float32,
                  fuse=False)
    attn = tl.params["layers"][0]["attn"]
    assert "wqkv" in attn and "wq" not in attn and "gate_up" in tl.params["layers"][0]["mlp"]
    assert ("bqkv" in attn) == cfg.attn_bias
    assert "wq" in unfused.params["layers"][0]["attn"]
    got = tl.generate(PROMPT, GenerationConfig.greedy(24))
    assert got == unfused.generate(PROMPT, GenerationConfig.greedy(24))
    assert got == jl.generate(PROMPT, JGenerationConfig(max_new_tokens=24, do_sample=False))


@pytest.mark.parametrize("cfg", [CFG, CFG_BIAS], ids=["nobias", "bias"])
def test_fused_logits_match_crane_tpu_fused(cfg):
    jl, tl = pair(cfg)
    np.testing.assert_allclose(prefill_logits(tl, lambda x: x.numpy()),
                               prefill_logits(jl, np.asarray), **LOGITS_TOL)


@pytest.mark.parametrize("quant", [None, 8, 4], ids=["dense", "w8", "w4"])
def test_fused_tree_and_round_trip_are_byte_identical(quant):
    """The port's fuse_params equals crane_tpu's leaf for leaf, and unfuse
    gives back the bridged unfused tree, bytes and layout (packed int4
    stays packed through both)."""
    cfg = CFG_BIAS if quant is None else CFG
    jp = jparams_of(cfg, quant)
    tp = params_from_jax(jp)
    fused = fuse_params(tp)
    same_tree(fused, jfuse_params(jp))
    if quant == 4:
        w = fused["layers"][0]["attn"]["wqkv"]
        assert w.packed and w.shape == (64, 64 + 32 + 32)
    same_tree(unfuse_params(port_cfg(cfg), fused), jp)
    assert "wq" in tp["layers"][0]["attn"]  # the input tree is not mutated


def test_bridge_carries_a_fused_tree():
    """crane_tpu's fused tree through params_from_jax equals the port's
    fuse_params of the bridged unfused tree, byte for byte."""
    for cfg, quant in ((CFG_BIAS, None), (CFG, 8), (CFG, 4)):
        jp = jparams_of(cfg, quant)
        same_tree(params_from_jax(jfuse_params(jp)), jfuse_params(jp))
        bridged = params_from_jax(jfuse_params(jp))
        ported = fuse_params(params_from_jax(jp))
        for a, b in zip(jax_free_leaves(bridged), jax_free_leaves(ported)):
            assert torch.equal(a, b)


def jax_free_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_free_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in jax_free_leaves(v)]
    if isinstance(tree, QuantizedWeight):
        return [tree.codes, tree.scales]
    return [tree]


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_quantized_weights_match(bits):
    """ISQ int8 and packed int4: the fused model's logits and tokens equal
    the unfused port's and crane_tpu's fused model's."""
    jl, tl = pair(CFG, quant=bits)
    _, tu = pair(CFG, quant=bits, fuse=False)
    w = tl.params["layers"][0]["attn"]["wqkv"]
    assert isinstance(w, QuantizedWeight) and w.bits == bits and w.shape == (64, 128)
    assert w.packed == (bits == 4)
    logits = prefill_logits(tl, lambda x: x.numpy())
    np.testing.assert_allclose(logits, prefill_logits(jl, np.asarray), **LOGITS_TOL)
    np.testing.assert_allclose(logits, prefill_logits(tu, lambda x: x.numpy()), **LOGITS_TOL)
    got = tl.generate(PROMPT, GenerationConfig.greedy(16))
    assert got == tu.generate(PROMPT, GenerationConfig.greedy(16))
    assert got == jl.generate(PROMPT, JGenerationConfig(max_new_tokens=16, do_sample=False))


def test_moe_and_missing_weights_pass_through():
    moe_layer = {
        "attn": {"wq": torch.ones(8, 8), "wk": torch.ones(8, 4)},
        "mlp": {"router": torch.ones(8, 4), "gate": torch.ones(8, 16), "up": torch.ones(8, 16)},
    }
    mixed = {"attn": {"wq": torch.ones(8, 8), "wk": torch.ones(8, 4),
                      "wv": torch.ones(8, 4, dtype=torch.bfloat16)},
             "mlp": {"gate": torch.ones(8, 16), "up": torch.ones(8, 12)}}
    partial_bias = {"attn": {"wq": torch.ones(8, 8), "wk": torch.ones(8, 4),
                             "wv": torch.ones(8, 4), "bq": torch.zeros(8)}}
    f = fuse_params({"layers": (moe_layer, mixed, partial_bias)})
    assert "gate_up" not in f["layers"][0]["mlp"] and "wqkv" not in f["layers"][0]["attn"]
    assert f["layers"][1] == mixed and f["layers"][2] == partial_bias
    assert fuse_params({"embed": torch.ones(2)})["embed"].shape == (2,)


def test_tp_unfuses_and_gives_the_unfused_tokens():
    """A fused base split by shard_lm carries wq/wk/wv (and gate/up) and
    gives the unfused model's greedy tokens."""
    _, tl = pair(CFG)
    _, tu = pair(CFG, fuse=False)
    slm = shard_lm(tl, make_mesh(1, 2, ["cpu"] * 2))
    for shard in slm.params.trees[0]:
        attn, mlp = shard["layers"][0]["attn"], shard["layers"][0]["mlp"]
        assert {"wq", "wk", "wv"} <= set(attn) and "wqkv" not in attn
        assert {"gate", "up"} <= set(mlp) and "gate_up" not in mlp
    assert "wqkv" in tl.params["layers"][0]["attn"]  # the base stays fused
    gen = GenerationConfig.greedy(12)
    assert slm.generate([3, 17, 99], gen) == tu.generate([3, 17, 99], gen)


def test_sp_keeps_the_fused_tree():
    _, tl = pair(CFG)
    _, tu = pair(CFG, fuse=False)
    slm = sp_shard_lm(tl, make_sp_mesh(4, ["cpu"] * 4))
    assert "wqkv" in slm.params["layers"][0]["attn"]
    assert "gate_up" in slm.params["layers"][0]["mlp"]
    gen = GenerationConfig.greedy(16)
    assert slm.generate(PROMPT, gen) == tu.generate(PROMPT, gen)


def test_constructor_reads_crane_fuse_proj(monkeypatch):
    jp = jparams_of(CFG)
    monkeypatch.delenv("CRANE_FUSE_PROJ", raising=False)
    assert "wq" in TLM(port_cfg(CFG), params_from_jax(jp), dtype=torch.float32) \
        .params["layers"][0]["attn"]
    monkeypatch.setenv("CRANE_FUSE_PROJ", "1")
    for lm in (TLM(port_cfg(CFG), params_from_jax(jp), dtype=torch.float32),
               JLM(CFG, jp, dtype=jnp.float32)):
        assert "wqkv" in lm.params["layers"][0]["attn"]
    assert "wq" in TLM(port_cfg(CFG), params_from_jax(jp), dtype=torch.float32,
                       fuse=False).params["layers"][0]["attn"]


def test_gguf_q8_0_model_fuses_under_crane_fuse_proj(monkeypatch, tmp_path):
    """A q8_0 GGUF file through both packages' from_gguf under
    CRANE_FUSE_PROJ=1: the blockwise weights fuse (block 32), and the
    greedy tokens equal crane_tpu's fused model's and the unfused port's."""
    from tokenizers import Tokenizer

    from crane_tpu.loaders import gguf_model as ref_model
    from crane_tpu_torch.loaders import gguf_model

    ckpt = make_tiny_qwen3_checkpoint(str(tmp_path / "m"))
    md = _gguf_metadata(ckpt, Tokenizer.from_file(f"{ckpt}/tokenizer.json"))
    path = write_gguf(str(tmp_path / "q8_0.gguf"), md, gguf_tensors(ckpt, "q8_0"))
    prompt, gen = [3, 14, 15, 52, 6], GenerationConfig.greedy(10)
    monkeypatch.setenv("CRANE_FUSE_PROJ", "0")
    unfused = gguf_model.from_gguf(path, dtype=torch.float32, device="cpu")
    monkeypatch.setenv("CRANE_FUSE_PROJ", "1")
    lm = gguf_model.from_gguf(path, dtype=torch.float32, device="cpu")
    ref = ref_model.from_gguf(path, dtype=jnp.float32)
    w = lm.params["layers"][0]["attn"]["wqkv"]
    assert isinstance(w, QuantizedWeight) and (w.bits, w.block) == (8, 32)
    assert "gate_up" in lm.params["layers"][0]["mlp"]
    same_tree(lm.params, ref.params)
    got = lm.generate(prompt, gen)
    assert got == unfused.generate(prompt, gen)
    assert got == ref.generate(prompt, JGenerationConfig(max_new_tokens=10, do_sample=False))


def run_engine(lm, prompts, n, kv_bits):
    engine = InferenceEngine(lm, max_slots=2, max_seq_len=128, prefill_chunk=16,
                             kv_quant_bits=kv_bits)
    qs = [engine.submit(EngineRequest(request_id=f"r{i}", prompt_ids=p, max_new_tokens=n,
                                      sampling=GREEDY)) for i, p in enumerate(prompts)]
    for _ in range(400):
        if not engine.step() and engine.request_q.empty():
            break
    out = []
    for q in qs:
        toks = []
        while True:
            r = q.get(timeout=60)
            if r.finished:
                assert r.error is None, r.error
                break
            if r.token is not None:
                toks.append(r.token)
        out.append(toks)
    return out


def test_fused_engine_w4_kv4_matches_unfused():
    """The engine (a 40-token prompt in chunks of 16, K5's and K6's plain
    versions here) on int4 weights and an int4 cache, fused against
    unfused."""
    prompts = [[(7 * i + 3) % 256 for i in range(40)], PROMPT]
    _, tl = pair(CFG, quant=4)
    _, tu = pair(CFG, quant=4, fuse=False)
    assert run_engine(tl, prompts, 12, 4) == run_engine(tu, prompts, 12, 4)


@pytest.mark.parametrize("read_cache", [False, True], ids=["fresh", "chunk"])
def test_fused_slices_reach_the_kernels_contiguous(monkeypatch, read_cache):
    """q, k and v of a fused product are views; the attention calls (K2 for
    a fresh prefill, K3 for a chunk) and the cache write get contiguous
    tensors."""
    _, tl = pair(CFG)
    seen = []

    def spy(fn):
        def wrapped(q, k, v, *args, **kwargs):
            seen.append(all(t.is_contiguous() for t in (q, k, v)))
            return fn(q, k, v, *args, **kwargs)
        return wrapped

    # head_dim 16 routes to the plain versions here; either way they are spied
    for name in ("flash_attention_causal", "flash_attention_cached"):
        for fn in (name, name + "_plain"):
            monkeypatch.setattr(ttf, fn, spy(getattr(ttf, fn)))
    update = ttf.LayerKVCache.update
    monkeypatch.setattr(ttf.LayerKVCache, "update", lambda self, k, v, *a, **kw: (
        seen.append(k.is_contiguous() and v.is_contiguous()), update(self, k, v, *a, **kw))[1])
    cache = tl.init_cache(1, 64)
    start = 8 if read_cache else 0
    ttf.forward_hidden(tl.config, tl.params, torch.as_tensor(IDS), cache, start, tl.rope,
                       read_cache=read_cache)
    assert len(seen) == 2 * CFG.num_layers and all(seen)


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


def test_qwen3_5_output_gate_fuses_like_crane_tpu():
    """The attention layer's q is [query | gate], 2 H D wide, so wqkv splits
    at 2 H D, Hkv D, Hkv D; the GDN layers keep their own projections and
    fuse their MLPs only."""
    cfg, jcfg = (m.transformer_config_from_hf(TINY_QWEN3_5) for m in (tauto, jauto))
    sd = tinit.hf_state_dict(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    jp = jauto.map_hf_weights(jcfg, {k: v.numpy() for k, v in sd.items()}, jnp.float32)
    jl = JLM(jcfg, jp, dtype=jnp.float32, fuse=True)
    tl = TLM(cfg, params_from_jax(jp), dtype=torch.float32, fuse=True)
    tu = TLM(cfg, params_from_jax(jp), dtype=torch.float32, fuse=False)
    assert qkv_sizes(cfg) == [2 * 2 * 16, 16, 16]
    layers = tl.params["layers"]
    assert layers[3]["attn"]["wqkv"].shape == (32, 64 + 16 + 16)
    assert "gdn" in layers[0] and "attn" not in layers[0] and "gate_up" in layers[0]["mlp"]
    same_tree(tl.params, jl.params)
    ids = np.asarray([[5, 9, 13, 2, 44, 31, 7, 8, 60]], np.int32)
    tlog, _ = tl.prefill(tl.init_cache(1, 32), ids, [9])
    jlog, _ = jl.prefill(jl.init_cache(1, 32), ids, [9])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS_TOL)
    ulog, _ = tu.prefill(tu.init_cache(1, 32), ids, [9])
    np.testing.assert_allclose(tlog.numpy(), ulog.numpy(), **LOGITS_TOL)
    gen = GenerationConfig.greedy(16)
    got = tl.generate(ids[0].tolist(), gen)
    assert got == tu.generate(ids[0].tolist(), gen)
    assert got == jl.generate(ids[0].tolist(), JGenerationConfig(max_new_tokens=16,
                                                                 do_sample=False))
