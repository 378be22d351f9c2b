"""Gemma3n in crane_tpu_torch against crane_tpu, on one tiny checkpoint
(CPU, f32).

The checkpoint is tests/test_gemma3n.py's (6 layers, sliding window 4, the
last 2 layers sharing the KV of layers 3 and 2, activation sparsity on
layers 0-1), saved by transformers and loaded by both ``from_pretrained``s.
Each sub-function (AltUp predict and correct, Laurel, the sparse and the
dense MLP, attention on an owning and on a shared layer) takes the same
seeded numpy inputs in both packages; logits agree within rtol/atol 2e-4
and greedy tokens are identical. A second checkpoint has a per-layer
vocabulary smaller than the vocabulary, where both packages clamp an id
past the per-layer table into it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.models import gemma3n as jg
from crane_tpu.ops.kv_cache import LayerKVCache as JLayerKVCache
from crane_tpu_torch.models import gemma3n as tg
from crane_tpu_torch.models.modules.transformer import attention_block
from crane_tpu_torch.ops.kv_cache import KVCache, LayerKVCache
from crane_tpu_torch.utils.bridge import params_from_jax
from tests.test_gemma3n import LAYER_TYPES, tiny  # noqa: F401  (the checkpoint fixture)
from tests.test_torch_moe import same_leaves

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT = [3, 14, 15, 92, 6, 44, 12, 7, 9, 10]


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def pair(tiny):  # noqa: F811
    _, d = tiny
    return (jg.from_pretrained(d, dtype=jnp.float32, max_seq=32),
            tg.from_pretrained(d, dtype=torch.float32, max_seq=32, device="cpu"))


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_and_weights_match(pair):
    jm, tm = pair
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.first_shared_layer == 4
    same_leaves(tm.params, jm.params)
    assert "wk" not in tm.params["layers"][4]["attn"]


def test_hf_shapes_name_every_checkpoint_tensor(tiny):  # noqa: F811
    """``hf_shapes`` lists the tensors an HF ``Gemma3nForCausalLM`` holds
    (under the ``model.`` prefix), with their shapes."""
    model, _ = tiny
    cfg = tg.config_from_hf(model.config.to_dict())
    want = {k.replace("model.language_model.", "model."): tuple(v.shape)
            for k, v in model.state_dict().items() if k != "lm_head.weight"}
    assert tg.hf_shapes(cfg, laurel_rank=4) == want


@pytest.mark.parametrize("layer", [0, 2])
def test_altup_laurel_and_mlp_match(pair, layer):
    """AltUp predict and correct (the transposed 4x4 einsum), Laurel and the
    MLP (gaussian top-k on layer 0, dense on layer 2) on seeded inputs."""
    jm, tm = pair
    cfg = jm.cfg
    jp, tp = jm.params["layers"][layer], tm.params["layers"][layer]
    E = cfg.hidden_size
    hs, act, x = rnd(1, 4, 2, 5, E), rnd(2, 2, 5, E), rnd(3, 2, 5, E)
    close(tg.altup_predict(cfg, tp["altup"], torch.from_numpy(hs)),
          jg.altup_predict(cfg, jp["altup"], jnp.asarray(hs)))
    close(tg.altup_correct(cfg, tp["altup"], torch.from_numpy(hs), torch.from_numpy(act)),
          jg.altup_correct(cfg, jp["altup"], jnp.asarray(hs), jnp.asarray(act)))
    close(tg._laurel(cfg, tp["laurel"], torch.from_numpy(x)),
          jg._laurel(cfg, jp["laurel"], jnp.asarray(x)))
    close(tg._mlp(cfg, tp["mlp"], torch.from_numpy(x), layer),
          jg._mlp(cfg, jp["mlp"], jnp.asarray(x), layer))


def test_sparsity_threshold_uses_population_std(pair):
    """The sparse MLP's threshold is mean + std * Phi^-1(0.95) with the
    population std: the sample std (correction 1) moves it."""
    jm, tm = pair
    cfg, tp = tm.cfg, tm.params["layers"][0]["mlp"]
    x = torch.from_numpy(rnd(4, 1, 3, cfg.hidden_size))
    gate = x @ tp["gate"]
    thr = gate.mean(-1, keepdim=True) + gate.std(-1, keepdim=True, correction=0) * 1.6448536269514722
    want = (torch.nn.functional.gelu(torch.relu(gate - thr), approximate="tanh")
            * (x @ tp["up"])) @ tp["down"]
    close(tg._mlp(cfg, tp, x, 0), want.numpy())
    assert abs(tg._std_multiplier(0.95) - 1.6448536269514722) < 1e-12


@pytest.mark.parametrize("layer", [3, 4])
def test_attention_owning_and_shared_layer(pair, layer):
    """Layer 3 owns its cache and writes the chunk into it; layer 4 (full)
    shares layer 2's and writes nothing. A 3-token chunk at position 5 over
    seeded cache buffers, then a decode step at position 8."""
    jm, tm = pair
    cfg = jm.cfg
    T, Hkv, D = 32, cfg.num_kv_heads, cfg.head_dim
    kv = [(rnd(10 + i, 1, T, Hkv, D), rnd(20 + i, 1, T, Hkv, D))
          for i in range(cfg.first_shared_layer)]
    jcache = tuple(JLayerKVCache(k=jnp.asarray(k), v=jnp.asarray(v)) for k, v in kv)
    tcache = KVCache(layers=tuple(LayerKVCache(k=torch.from_numpy(k.copy()),
                                               v=torch.from_numpy(v.copy())) for k, v in kv),
                     lengths=torch.zeros(1, dtype=torch.int32))
    jp, tp = jm.params["layers"][layer]["attn"], tm.params["layers"][layer]["attn"]
    for S, start in ((3, 5), (1, 8)):
        x = rnd(30 + S, 1, S, cfg.hidden_size)
        if S == 1:
            jpos, jw = jnp.asarray([[start]], jnp.int32), jnp.asarray([start], jnp.int32)
            tpos, tw = torch.tensor([[start]], dtype=torch.int32), torch.tensor([start], dtype=torch.int32)
        else:
            jpos = jnp.arange(start, start + S, dtype=jnp.int32)[None]
            jw = jnp.asarray(start, jnp.int32)
            tpos, tw = torch.arange(start, start + S, dtype=torch.int32)[None], start
        before = [t.clone() for layer_c in tcache.layers for t in layer_c.tensors()]
        jout, jcache = jg._attention(cfg, jp, jnp.asarray(x), jcache, jpos, jw, jm.rope, layer)
        tout = tg._attention(cfg, tp, torch.from_numpy(x), tcache, tpos, tw, tm.rope, layer)
        close(tout, jout)
        after = [t for layer_c in tcache.layers for t in layer_c.tensors()]
        changed = [i // 2 for i, (a, b) in enumerate(zip(before, after)) if not torch.equal(a, b)]
        assert changed == ([layer, layer] if layer < cfg.first_shared_layer else [])
        for tl, jl in zip(tcache.layers, jcache):
            close(tl.k, jl.k)
            close(tl.v, jl.v)


def test_prefill_logits_match(pair):
    jm, tm = pair
    ids = np.array([[1, 5, 9, 17, 33, 2, 7, 11, 4, 3, 22, 8]], dtype=np.int32)
    close(tm.prefill_logits(ids), jm.prefill_logits(ids))


def test_decode_equals_prefill_and_crane_tpu(pair):
    """Stepping one token at a time reproduces the one-shot prefill logits
    (and crane_tpu's decode steps), through the eager step and the
    dispatched (graph on the card) step."""
    jm, tm = pair
    ids = np.array([[1, 5, 9, 17, 33, 2, 7, 11]], dtype=np.int32)
    full = tm.prefill_logits(ids)
    jcache = jm.new_cache()
    _, jcache = jm._prefill(jm.params, jnp.asarray(ids[:, :3]), jcache)
    for step in (tm.decode_step, tm.decode_graph):
        logits, cache = tm.prefill(ids[:, :3], tm.new_cache())
        close(logits, full[:, :3])
        for t in range(3, ids.shape[1]):
            out = step(ids[:, t:t + 1], cache, [t])
            logits = out[0] if isinstance(out, tuple) else out
            close(logits, full[:, t])
    for t in range(3, ids.shape[1]):
        jstep, jcache = jm._decode_step(jm.params, jnp.asarray(ids[:, t:t + 1]), jcache,
                                        jnp.asarray([t], jnp.int32))
        close(full[:, t], jstep)


def test_greedy_tokens_identical(pair):
    jm, tm = pair
    assert tm.generate_greedy(np.asarray([PROMPT]), 8) == jm.generate_greedy(
        np.asarray([PROMPT]), 8)
    # a second call reuses the kept cache
    assert tm.generate_greedy(np.asarray([PROMPT[:6]]), 5) == jm.generate_greedy(
        np.asarray([PROMPT[:6]]), 5)


def test_shared_layers_write_nothing(pair, monkeypatch):
    """One prefill and one decode step write exactly the owning layers'
    buffers, once each; the cache holds no buffer for a shared layer."""
    _, tm = pair
    writes = []
    orig = LayerKVCache.update

    def update(self, *a, **kw):
        writes.append(id(self))
        return orig(self, *a, **kw)

    monkeypatch.setattr(LayerKVCache, "update", update)
    cache = tm.new_cache()
    assert len(cache.layers) == tm.cfg.first_shared_layer
    _, cache = tm.prefill(np.asarray([PROMPT]), cache)
    tm.decode_step([[5]], cache, [len(PROMPT)])
    owners = [id(layer) for layer in cache.layers]
    assert writes == owners + owners


def test_decode_attention_routes_by_shape(pair):
    """Every decode step's attention goes through the K1 router: head_dim 8
    is a shape the kernel does not take, so each of the 6 layers of each of
    the 3 decode steps counts one plain route, and nothing else does (the
    prefill is plain attention, as in crane_tpu, and no route)."""
    _, tm = pair
    before = dict(attention_block.plain_routes)
    tm.generate_greedy(np.asarray([PROMPT]), 4)
    after = attention_block.plain_routes
    assert after["decode"] - before["decode"] == 3 * tm.cfg.num_layers
    assert (after["prefill"], after["chunk"]) == (before["prefill"], before["chunk"])


def test_out_of_vocabulary_prompt_raises(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="outside the vocabulary"):
        tm.generate_greedy(np.asarray([[1, 2, tm.cfg.vocab_size]]), 2)


@pytest.fixture(scope="module")
def small_ple(tmp_path_factory):
    """tests/test_gemma3n.py's config with a per-layer vocabulary of 96 of
    the 128 ids."""
    torch.manual_seed(1)
    cfg = transformers.Gemma3nTextConfig(
        vocab_size=128, vocab_size_per_layer_input=96,
        hidden_size=32, hidden_size_per_layer_input=16,
        intermediate_size=[64] * 6, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        layer_types=LAYER_TYPES, sliding_window=4,
        num_kv_shared_layers=2, laurel_rank=4,
        activation_sparsity_pattern=[0.95, 0.95, 0.0, 0.0, 0.0, 0.0],
        max_position_embeddings=64, tie_word_embeddings=True,
    )
    model = transformers.Gemma3nForCausalLM(cfg).eval().to(torch.float32)
    d = str(tmp_path_factory.mktemp("g3n_ple") / "m")
    model.save_pretrained(d, safe_serialization=True)
    return d


def test_ids_past_the_per_layer_table_are_clamped(small_ple):
    """Ids in [96, 128) lie inside the vocabulary but past the per-layer
    table: the port clamps them into it, as crane_tpu's gather does, and
    gives crane_tpu's logits and tokens."""
    jm = jg.from_pretrained(small_ple, dtype=jnp.float32, max_seq=32)
    tm = tg.from_pretrained(small_ple, dtype=torch.float32, max_seq=32, device="cpu")
    assert tm.cfg.vocab_size_per_layer_input == 96 < tm.cfg.vocab_size
    ids = np.array([[1, 100, 5, 127, 96, 40, 95, 120]], dtype=np.int32)
    close(tm.prefill_logits(ids), jm.prefill_logits(ids))
    assert tm.generate_greedy(ids, 6) == jm.generate_greedy(ids, 6)
    # the clamp is what makes them equal: the last row stands in for them
    clamped = np.minimum(ids, 95)
    close(tm.prefill_logits(ids)[:, 0], tm.prefill_logits(clamped)[:, 0])


def test_map_hf_weights_takes_the_mangled_key(tiny):  # noqa: F811
    """transformers' save-time renaming spells ``per_layer_model_projection``
    as ``per_layer_model.language_model_projection``; the mapping reads
    either, under any of the three prefixes."""
    model, _ = tiny
    cfg = tg.config_from_hf(model.config.to_dict())
    sd = {k.replace("model.language_model.", "model."): v
          for k, v in model.state_dict().items()}
    plain = tg.map_hf_weights(cfg, sd, torch.float32, "cpu")
    mangled = {k.replace("model.", "model.language_model.", 1)
               .replace("per_layer_model_", "per_layer_model.language_model_"): v
               for k, v in sd.items()}
    assert "model.language_model.per_layer_model.language_model_projection.weight" in mangled
    same_leaves(tg.map_hf_weights(cfg, mangled, torch.float32, "cpu"), plain)
    jparams = jg.map_hf_weights(cfg, {k: v.numpy() for k, v in mangled.items()}, jnp.float32)
    same_leaves(plain, jparams)


def test_params_from_jax_carries_the_tree(pair):
    """crane_tpu's Gemma3n tree (tuples of streams and layers) crosses the
    bridge leaf for leaf, and runs the port's forward to the same logits."""
    jm, tm = pair
    params = params_from_jax(jm.params)
    same_leaves(params, jm.params)
    lm = tg.Gemma3nLM(tm.cfg, params, max_seq=32)
    ids = np.array([[4, 8, 15, 16, 23, 42]], dtype=np.int32)
    close(lm.prefill_logits(ids), jm.prefill_logits(ids))
