"""Sequence parallelism in crane_tpu_torch against crane_tpu, on the CPU.

The port's sp model splits every full-attention layer's KV sequence axis
into four slabs on ``["cpu"] * 4`` (the counterpart of the virtual devices
``tests/test_sequence_parallel.py`` runs on), runs the with-stats kernels'
plain versions per slab and merges the partials. Test for test it mirrors
that file: its greedy tokens must equal crane_tpu's single-device tokens,
and its continuation-chunk outputs must lie within 2e-4 of them. With
speculation the verify chunks (k + 1 tokens a row at per-row positions) are
written across slab boundaries and attend through the with-stats chunk
path.

The op-level cases hold ``decode_attention_with_stats`` and
``cached_attention_with_stats`` (plain versions on a CPU tensor) against the
Pallas kernels of the same names in interpret mode, for bits 16, 8 and 4,
including an empty slab and a chunk wholly before the slab; and the merge of
slab partials against the unsharded plain output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.init import QWEN3_TINY, init_params
from crane_tpu.ops import kv_cache as jkv
from crane_tpu.ops import sampling as jsamp
from crane_tpu.ops.pallas import quant_attention as jqa
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops import cuda as kernels
from crane_tpu_torch.ops import sampling as tsamp
from crane_tpu_torch.ops.cuda import decode_attention as k1
from crane_tpu_torch.ops.cuda import flash_attention as k23
from crane_tpu_torch.ops.cuda import quant_attention as k45
from crane_tpu_torch.ops.kv_cache import LayerKVCache, SequenceShardedKVCache
from crane_tpu_torch.parallel.sequence import (
    SequenceShardedCausalLM,
    make_sp_mesh,
    merge_partials,
    sp_shard_lm,
)
from crane_tpu_torch.serve.engine import (
    EngineRequest,
    InferenceEngine,
    SamplingOptions,
    _check_hbm_budget,
    _device_bytes,
)
from crane_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(2)

CPU4 = ["cpu"] * 4
GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)
# out to 1e-5; m and l to 1e-5 relative where l > 0 (float32 sums in another
# order on both sides)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def port_lm(jl):
    """The port's model on crane_tpu's weights, float32 on the CPU."""
    cfg = ttf.TransformerConfig(**dataclasses.asdict(jl.config))
    return TLM(cfg, params_from_jax(jl.params), dtype=torch.float32)


@pytest.fixture(scope="module")
def lms():
    jl = JLM(QWEN3_TINY, init_params(QWEN3_TINY, seed=0, dtype=jnp.float32), dtype=jnp.float32)
    return jl, port_lm(jl)


def run(engine, rid, prompt, n, max_steps=300):
    q = engine.submit(EngineRequest(request_id=rid, prompt_ids=list(prompt), max_new_tokens=n,
                                    sampling=GREEDY))
    for _ in range(max_steps):
        if not engine.step() and engine.request_q.empty():
            break
    toks = []
    while True:
        r = q.get(timeout=60)
        if r.finished:
            assert r.error is None, r.error
            return toks
        if r.token is not None:
            toks.append(r.token)


def test_sp_generate_matches_single_device(lms):
    jl, tl = lms
    prompt = [3, 14, 15, 92, 6]
    expected = jl.generate(prompt, JGenerationConfig.greedy(10))
    slm = sp_shard_lm(tl, make_sp_mesh(4, CPU4))
    cache = slm.init_cache(1, 32)
    layer = cache.layers[0]
    assert isinstance(layer, SequenceShardedKVCache)  # the cache is actually split
    assert len(layer.slabs) == 4 and layer.slab_len == 8 and layer.max_seq == 32
    assert layer.devices == (torch.device("cpu"),) * 4
    assert slm.generate(prompt, GenerationConfig.greedy(10)) == expected


def test_sp_prompt_spanning_slabs_matches(lms):
    """A prompt longer than a slab: the prefill write crosses slab
    boundaries and every decode step attends tokens on several slabs."""
    jl, tl = lms
    slm = sp_shard_lm(tl, make_sp_mesh(4, CPU4))
    prompt = list(range(2, 152))  # generate's 256-token buffer: 64-token slabs, 3 of them live
    assert slm.generate(prompt, GenerationConfig.greedy(8)) == \
        jl.generate(prompt, JGenerationConfig.greedy(8))

    # 23 tokens over 8-token slabs, then decode steps past the third slab
    prompt = list(range(2, 25))
    jc = jl.init_cache(1, 32)
    jlog, jc = jl.prefill(jc, jnp.asarray([prompt], jnp.int32), [len(prompt)])
    tc = slm.init_cache(1, 32)
    tlog, tc = slm.prefill(tc, [prompt], [len(prompt)])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)
    first = int(np.argmax(np.asarray(jlog)[0]))
    assert int(tlog[0].argmax()) == first
    jt, _, _ = jl.decode_steps(jc, jnp.asarray([first], jnp.int32), jnp.full((1, 8), -1, jnp.int32),
                               jsamp.SamplingParams.make(1, do_sample=False),
                               jax.random.PRNGKey(0), 6)
    tt, tc, _ = slm.decode_steps(tc, torch.tensor([first], dtype=torch.int32),
                                 torch.full((1, 8), -1, dtype=torch.int32),
                                 tsamp.SamplingParams.make(1, do_sample=False),
                                 torch.Generator(), 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tc.lengths[0]) == len(prompt) + 6


@pytest.mark.parametrize("bits", [8, 4])
def test_sp_quant_cache_matches_single_device(lms, bits):
    """int8/int4 KV and sp compose: each slab holds codes and [B, Hkv, T/n]
    scales; decode runs K4-S's plain version per slab."""
    jl, tl = lms
    prompt = [3, 14, 15, 92, 6, 7, 21, 9, 44, 2]
    jc = jl.init_cache(1, 32, quant_bits=bits)
    jlog, jc = jl.prefill(jc, jnp.asarray([prompt], jnp.int32), [len(prompt)])
    ref_toks = [int(jnp.argmax(jlog, -1)[0])]

    slm = sp_shard_lm(tl, make_sp_mesh(4, CPU4))
    tc = slm.init_cache(1, 32, quant_bits=bits)
    assert tc.layers[0].bits == bits and tc.layers[0].slabs[0].k_scale.shape == (1, 2, 8)
    tlog, tc = slm.prefill(tc, [prompt], [len(prompt)])
    assert [int(tlog[0].argmax())] == ref_toks

    jt, _, _ = jl.decode_steps(jc, jnp.asarray(ref_toks, jnp.int32), jnp.full((1, 64), -1, jnp.int32),
                               jsamp.SamplingParams.make(1, do_sample=False),
                               jax.random.PRNGKey(0), 6)
    tt, _, _ = slm.decode_steps(tc, torch.tensor(ref_toks, dtype=torch.int32),
                                torch.full((1, 64), -1, dtype=torch.int32),
                                tsamp.SamplingParams.make(1, do_sample=False),
                                torch.Generator(), 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sp_engine_serving_matches_single_device(lms):
    """The continuous-batching engine over the sp model: slot caches split
    their sequence axis; admission and batched decode stream the
    single-device tokens."""
    jl, tl = lms
    prompts = [[3, 14, 15], [92, 6, 44, 12]]
    expected = [jl.generate(p, JGenerationConfig.greedy(6)) for p in prompts]
    engine = InferenceEngine(sp_shard_lm(tl, make_sp_mesh(4, CPU4)), max_slots=2, max_seq_len=64,
                             decode_tokens_per_seq=2)
    qs = [engine.submit(EngineRequest(f"r{i}", p, 6, GREEDY)) for i, p in enumerate(prompts)]
    for _ in range(200):
        if not engine.step() and engine.request_q.empty():
            break
    for q, exp in zip(qs, expected):
        toks = []
        while True:
            r = q.get(timeout=60)
            if r.finished:
                assert r.error is None, r.error
                break
            toks.append(r.token)
        assert toks == exp


def test_sp_sliding_window_hybrid_matches():
    """A sliding/full hybrid under sp: window layers keep whole caches on
    the lead device (their KV is bounded) while full layers split into
    slabs; tokens match crane_tpu's single device."""
    from crane_tpu.models.modules.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=16, intermediate_size=96, qk_norm=True,
        layer_types=("sliding", "full", "sliding", "full"),
        sliding_window=8, rope_local_theta=10000.0,
    )
    jl = JLM(cfg, init_params(cfg, seed=3, dtype=jnp.float32), dtype=jnp.float32)
    prompt = list(range(2, 20))
    expected = jl.generate(prompt, JGenerationConfig.greedy(8))
    slm = sp_shard_lm(port_lm(jl), make_sp_mesh(4, CPU4))
    cache = slm.init_cache(1, 32)
    assert isinstance(cache.layers[0], LayerKVCache) and cache.layers[0].max_seq == 32
    assert isinstance(cache.layers[1], SequenceShardedKVCache)
    assert slm.generate(prompt, GenerationConfig.greedy(8)) == expected


def test_sp_chunked_prefill_matches_single_device(lms):
    """Continuation chunks run the chunk kernel per slab at slab-shifted
    positions and merge per query row; the engine's chunked admission."""
    jl, tl = lms
    rng = np.random.default_rng(5)
    first = rng.integers(1, 500, 20)[None].astype(np.int32)
    chunk = rng.integers(1, 500, 8)[None].astype(np.int32)

    ref_cache = jl.init_cache(1, 64)
    _, ref_cache = jl.prefill_slot(ref_cache, first, 0, 20)
    ref_out, _ = jl.prefill_slot_continue(ref_cache, chunk, 0, 20, 8)

    slm = sp_shard_lm(tl, make_sp_mesh(4, CPU4))
    sp_cache = slm.init_cache(1, 64)
    _, sp_cache = slm.prefill_slot(sp_cache, first, 0, 20)
    sp_out, _ = slm.prefill_slot_continue(sp_cache, chunk, 0, 20, 8)
    np.testing.assert_allclose(sp_out.numpy(), np.asarray(ref_out, np.float32),
                               atol=2e-4, rtol=2e-4)

    prompt = list(rng.integers(1, 500, 40))
    expected = jl.generate(prompt, JGenerationConfig.greedy(5))
    engine = InferenceEngine(slm, max_slots=1, max_seq_len=64, prefill_chunk=16)
    assert run(engine, "r", prompt, 5) == expected


def test_sp_with_engine_speculative_matches(lms):
    """tests/test_sequence_parallel.py's case: the sp engine with
    speculative="ngram" (k=4, 4 rounds) on a repetitive prompt gives
    crane_tpu's single-device greedy tokens, and speculated."""
    jl, tl = lms
    prompt = [5, 6, 7, 8] * 6
    engine = InferenceEngine(sp_shard_lm(tl, make_sp_mesh(4, CPU4)), max_slots=1,
                             max_seq_len=64, speculative="ngram", spec_k=4, spec_rounds=4)
    assert run(engine, "r", prompt, 10) == jl.generate(prompt, JGenerationConfig.greedy(10))
    assert engine.stats.spec_steps > 0


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_sp_generate_speculative_across_slabs(lms, bits):
    """Speculative generate over four 64-slot slabs, a 60-token repetitive
    prompt: the verify chunks straddle the first slab boundary, and the
    tokens equal crane_tpu's single-device greedy tokens on the same cache
    width (the port's slabs write each token of a chunk into its own slab)."""
    jl, tl = lms
    prompt = ([5, 6, 7, 8, 9] * 12)[:60]
    gen = dict(kv_quant_bits=bits)
    expected = jl.generate(prompt, JGenerationConfig.greedy(12, **gen))
    slm = sp_shard_lm(tl, make_sp_mesh(4, CPU4))
    assert slm.generate(prompt, GenerationConfig.greedy(12, speculative="ngram", **gen)) == expected
    cache = slm._generate_caches[(256, bits)][0]
    assert isinstance(cache.layers[0], SequenceShardedKVCache) and cache.layers[0].slab_len == 64


def test_sp_prefix_reuse_matches_single_device(lms):
    """Cross-request prefix reuse over sharded rows: the suffix admits
    through the sp continuation path, token-identical to single-device."""
    jl, tl = lms
    engine = InferenceEngine(sp_shard_lm(tl, make_sp_mesh(4, CPU4)), max_slots=2,
                             max_seq_len=64, decode_tokens_per_seq=2, prefix_reuse_min=4,
                             bucket_align=4)
    assert engine.prefix_cache
    prompt = [3, 14, 15, 92, 6, 5, 35, 89]
    t1 = run(engine, "turn1", prompt, 6)
    prompt2 = prompt + t1 + [7, 9, 2]
    t2 = run(engine, "turn2", prompt2, 6)
    assert engine.stats.prefix_hits == 1
    assert t2 == jl.generate(prompt2, JGenerationConfig.greedy(6))


def test_sp_gdn_hybrid_and_quantized_weights_match_unsharded(lms):
    """Beyond crane_tpu's sp tests: a Qwen3.5-shaped GDN hybrid (GDN
    states whole on the lead device, its attention layer in slabs) and ISQ
    int4 weights on an int4 cache give the unsharded port's tokens through
    generate, and the unsharded engine's through chunked admission (which
    reads the int4 cache where a whole prefill attends its own float K/V)."""
    from crane_tpu_torch.models.auto import (
        map_hf_weights,
        quantize_params,
        transformer_config_from_hf,
    )
    from crane_tpu_torch.models.init import hf_state_dict
    from crane_tpu_torch.ops.kv_cache import GdnLayerCache

    cfg = transformer_config_from_hf({
        "model_type": "qwen3_5", "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 4,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
        "intermediate_size": 96, "rms_norm_eps": 1e-6, "rope_theta": 1e7,
        "tie_word_embeddings": True, "partial_rotary_factor": 0.25,
        "layer_types": ["linear_attention"] * 3 + ["full_attention"],
        "linear_num_value_heads": 4, "linear_num_key_heads": 2, "linear_key_head_dim": 32,
        "linear_value_head_dim": 16, "linear_conv_kernel_dim": 4})
    sd = hf_state_dict(cfg, torch.Generator().manual_seed(1), dtype=torch.float32)
    hybrid = TLM(cfg, map_hf_weights(cfg, sd, torch.float32, "cpu"), dtype=torch.float32)
    _, tl = lms
    w4 = TLM(tl.config, quantize_params(tl.params, bits=4), dtype=torch.float32)
    prompt = list(range(3, 90))
    for lm, bits in ((hybrid, None), (w4, 4)):
        slm = sp_shard_lm(lm, make_sp_mesh(4, CPU4))
        cache = slm.init_cache(1, 64, quant_bits=bits)
        if lm is hybrid:
            assert isinstance(cache.layers[0], GdnLayerCache)
            assert isinstance(cache.layers[3], SequenceShardedKVCache)
        gen = GenerationConfig.greedy(8, kv_quant_bits=bits)
        assert slm.generate(prompt, gen) == lm.generate(prompt, gen)
        tokens = [run(InferenceEngine(m, max_slots=1, max_seq_len=256, prefill_chunk=32,
                                      bucket_align=32, kv_quant_bits=bits), "r", prompt, 6)
                  for m in (slm, lm)]
        assert tokens[0] == tokens[1]


def test_sp_mesh_placement_and_odd_degree(lms):
    """A 3-way mesh rounds the buffer up to a slab multiple and still gives
    single-device tokens; the mesh defaults to the cards (none here) and
    must lead with the model's device."""
    jl, tl = lms
    mesh = make_sp_mesh(3, CPU4)
    assert mesh == (torch.device("cpu"),) * 3
    slm = sp_shard_lm(tl, mesh)
    assert slm.init_cache(2, 32).layers[1].slab_len == 11  # 32 -> 33 = 3 x 11
    prompt = [3, 14, 15, 92, 6]
    assert slm.generate(prompt, GenerationConfig.greedy(8)) == \
        jl.generate(prompt, JGenerationConfig.greedy(8))
    with pytest.raises(ValueError, match="3 devices"):
        make_sp_mesh(3, ["cpu"] * 2)
    with pytest.raises(ValueError, match="lies on cpu"):
        SequenceShardedCausalLM(tl, (torch.device("meta"),))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_sp_mesh(2)


def test_sp_memory_budget_per_device(lms, monkeypatch):
    """The lead device holds the weights, the lengths and any whole layer;
    every other device its slabs; slabs on a repeated device add up, so four
    slabs on one device need what the unsharded cache needs."""
    _, tl = lms
    slm = sp_shard_lm(tl, make_sp_mesh(4, CPU4))
    unsharded = tl.init_cache(2, 64, device="meta").nbytes()
    held = _device_bytes(slm, slm.init_cache(2, 64, device="meta"))
    weights = sum(t.numel() * t.element_size() for t in jax.tree.leaves(tl.params))
    assert held == {torch.device("cpu"): weights + unsharded}

    meta = slm.init_cache(2, 64, device="meta")
    cards = tuple(torch.device("cuda", i) for i in range(4))
    spread = dataclasses.replace(meta, layers=tuple(
        dataclasses.replace(layer, devices=cards) for layer in meta.layers))
    held = _device_bytes(slm, spread)
    slab = sum(t.numel() * t.element_size() for layer in meta.layers
               for t in layer.slabs[0].tensors())
    assert held[torch.device("cpu")] == weights + 4 * 2
    assert all(held[c] == slab for c in cards)

    need = int((weights + unsharded) * 1.15)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need))
    _check_hbm_budget(slm, 2, 64, None)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need - 1))
    with pytest.raises(RuntimeError, match="HBM budget exceeded on cpu"):
        _check_hbm_budget(slm, 2, 64, None)


# ── op level: the with-stats kernels' plain versions against Pallas ─────────


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


B, T, HQ, HKV, D = 3, 64, 4, 2, 32
# decode: an empty slab (local length 0), a ragged row and a full one
LOCAL_LEN = np.array([0, 17, T], np.int32)
# a 16-query chunk at slab-local positions: row 0 wholly before the slab
# (every position negative), row 1 from below into the slab, row 2 from
# inside the slab past its end (clamped to T - 1)
CHUNK_START = np.array([-40, -6, 56], np.int32)


def cache_operands(bits):
    """(crane_tpu operands, port operands) of a full slab of T tokens."""
    k, v = rnd(B, T, HKV, D, seed=11), rnd(B, T, HKV, D, seed=12)
    if bits == 16:
        ops = (k, v, None, None)
    else:
        c = jkv.QuantLayerKVCache.empty(B, T, HKV, D, bits=bits).update(
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(0))
        ops = tuple(np.asarray(a) for a in (c.k, c.v, c.k_scale, c.v_scale))
    return (tuple(None if a is None else jnp.asarray(a) for a in ops),
            tuple(None if a is None else torch.tensor(a) for a in ops))


def check_stats(got, ref):
    """The port's (out, m, l) against Pallas's: where the port's row saw a
    slot (l > 0), all three to STATS_TOL. Where it saw none, the port writes
    out 0, m -inf, l 0; Pallas writes -1e30 for m, and out 0, l 0 unless the
    row shares a query tile with a row that saw slots, in which case its l
    counts the masked slots of that tile. Either way the row's merge weight
    l * exp(m - max m) is 0, which is what the merge reads."""
    out, m, l = (x.numpy() for x in got)
    r_out, r_m, r_l = (np.asarray(x) for x in ref)
    seen = l > 0
    np.testing.assert_allclose(m[seen], r_m[seen], **STATS_TOL)
    np.testing.assert_allclose(l[seen], r_l[seen], **STATS_TOL)
    assert np.all(m[~seen] == -np.inf) and np.all(l[~seen] == 0)
    assert np.all(r_m[~seen] <= -1e29)
    heads_seen = seen if out.shape[1] == 1 else seen.transpose(0, 2, 1)  # [B, S, Hq]
    heads_seen = heads_seen.reshape(out.shape[0], out.shape[1], -1)
    np.testing.assert_allclose(out[heads_seen], r_out[heads_seen], **STATS_TOL)
    assert np.all(out[~heads_seen] == 0)
    return seen


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_decode_with_stats_plain_matches_pallas(bits):
    jops, tops = cache_operands(bits)
    q = rnd(B, 1, HQ, D, seed=13)
    ref = jqa.decode_attention_with_stats(
        jnp.asarray(q), *jops, jnp.asarray(LOCAL_LEN), bits=bits, scale=D ** -0.5,
        block_t=16, interpret=True)
    kernels.reset_launch_counts()
    got = k45.decode_attention_with_stats(torch.tensor(q), *tops, torch.tensor(LOCAL_LEN),
                                          bits=bits, scale=D ** -0.5)
    assert sum(kernels.launch_counts().values()) == 0  # the CPU runs the plain version
    assert got[1].shape == (B, HQ) and got[1].dtype == torch.float32
    seen = check_stats(got, ref)
    assert not seen[0].any() and seen[1:].all()  # the empty slab, and the live rows
    np.testing.assert_array_equal(np.asarray(ref[2])[0], 0.0)  # Pallas: l == 0 there too
    np.testing.assert_array_equal(np.asarray(ref[0])[0], 0.0)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_chunk_with_stats_plain_matches_pallas(bits):
    jops, tops = cache_operands(bits)
    S = 16
    q = rnd(B, S, HQ, D, seed=14)
    pos = (CHUNK_START[:, None] + np.arange(S)[None]).astype(np.int32)
    ref = jqa.cached_attention_with_stats(
        jnp.asarray(q), *jops, jnp.asarray(pos), bits=bits, scale=D ** -0.5, block_q=8,
        block_k=16, interpret=True)
    got = k45.cached_attention_with_stats(torch.tensor(q), *tops, torch.tensor(pos), bits=bits,
                                          scale=D ** -0.5)
    assert got[1].shape == (B, HQ, S)
    seen = check_stats(got, ref)
    assert np.array_equal(seen[:, 0, :], pos >= 0)
    # a chunk wholly before the slab: l == 0 and out == 0 in both, as
    # tests/test_tpu_kernels.py checks the Mosaic form
    np.testing.assert_array_equal(np.asarray(ref[2])[0], 0.0)
    np.testing.assert_array_equal(np.asarray(ref[0])[0], 0.0)


@pytest.mark.parametrize("phase", ["decode", "chunk"])
def test_merged_slabs_reproduce_unsharded(phase):
    """Four slabs' with-stats partials, merged, give the plain output over
    the whole buffer; a row no slab saw merges to 0, not NaN."""
    n, Tl = 4, T // 4
    k, v = torch.tensor(rnd(B, T, HKV, D, seed=21)), torch.tensor(rnd(B, T, HKV, D, seed=22))
    if phase == "decode":
        q = torch.tensor(rnd(B, 1, HQ, D, seed=23))
        lengths = torch.tensor([0, 21, T], dtype=torch.int32)
        whole = k1.fp_decode_attention_plain(q, k, v, lengths, scale=D ** -0.5)
        parts = []
        for i in range(n):
            local = (lengths - i * Tl).clamp(0, Tl).to(torch.int32)
            out, m, l = k1.fp_decode_attention_with_stats_plain(
                q, k[:, i * Tl:(i + 1) * Tl], v[:, i * Tl:(i + 1) * Tl], local, scale=D ** -0.5)
            parts.append((out, m[..., None], l[..., None]))
    else:
        S = 12
        q = torch.tensor(rnd(B, S, HQ, D, seed=24))
        pos = torch.tensor([[-1] * S, list(range(10, 22)), list(range(55, 67))],
                           dtype=torch.int32)  # row 0 sees nothing
        whole = k23.flash_attention_cached_plain(q, k, v, pos, scale=D ** -0.5)
        parts = [k23.flash_attention_cached_with_stats_plain(
            q, k[:, i * Tl:(i + 1) * Tl], v[:, i * Tl:(i + 1) * Tl], pos - i * Tl,
            scale=D ** -0.5) for i in range(n)]
    merged = merge_partials(parts, q.dtype)
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, whole, rtol=1e-5, atol=1e-5)
    assert torch.equal(merged[0], torch.zeros_like(merged[0]))
