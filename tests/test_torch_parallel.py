"""Tensor and data parallelism in crane_tpu_torch against crane_tpu, on the CPU.

The port splits a model over a dp x tp mesh of ``["cpu"] * n`` (the
counterpart of the virtual devices tests/test_parallel.py runs on): each tp
shard holds its slice of the Megatron split, the partials add up on each dp
group's first device. This file mirrors tests/test_parallel.py case for
case (tp forward, MoE expert parallelism, the dp x tp train step, tp
generate greedy and sampled, the tp and dp x tp engines, remat gradients),
tests/test_engine.py's memory budget under dp/tp and
tests/test_kernel_partitioning.py (each shard's attention call sees
``B/dp`` rows and ``Hkv/tp`` heads; an indivisible kv-head count keeps the
layer whole); tests/test_torch_parallel_hybrid.py holds the hybrid models'
cases (tests/test_qwen3_next_parity.py's, tests/test_gguf_hybrid.py's). Tolerances are those files' own: logits at rtol 1e-4 / atol
1e-5, the train step's loss at 1e-5 relative and its gradients against
``jax.grad`` at rtol 1e-4 / atol 1e-6, remat at rtol 1e-5 / atol 1e-6;
greedy tokens equal.

It also records the two limits of crane_tpu that decide what the port does:
crane_tpu cannot shard weights quantized in situ (the port refuses them the
same way), and cannot differentiate through its Pallas attention (the port's
train step goes to the plain attention by argument, and every kernel wrapper
refuses an input that requires grad).
"""

import dataclasses
import importlib
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.init import QWEN3_TINY, init_params
from crane_tpu.parallel import sharding as jsharding
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.kv_cache import MeshLayerCache
from crane_tpu_torch.parallel import train as ttrain
from crane_tpu_torch.parallel.inference import (
    gather_cache,
    make_sharded_cache,
    shard_cache,
    shard_lm,
)
from crane_tpu_torch.parallel.sharding import (
    ISQ_UNDER_MESH,
    Mesh,
    gather_params,
    leaves,
    make_mesh,
    param_partition_specs,
    shard_params,
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

GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_parallel.py's
CACHE_TOL = dict(rtol=2e-4, atol=2e-4)  # the port's tests' bar against crane_tpu


def cpu_mesh(dp, tp):
    return make_mesh(dp, tp, ["cpu"] * (dp * tp))


def port_cfg(jcfg):
    return ttf.TransformerConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def lms():
    """(crane_tpu's QWEN3_TINY model, the port's on the same weights)."""
    jl = JLM(QWEN3_TINY, init_params(QWEN3_TINY, seed=0, dtype=jnp.float32), dtype=jnp.float32)
    return jl, TLM(port_cfg(jl.config), params_from_jax(jl.params), dtype=torch.float32)


def run(engine, prompts, n, max_steps=400):
    """Each prompt through ``engine`` (greedy), stepped inline; its tokens."""
    qs = [engine.submit(EngineRequest(request_id=f"r{i}", prompt_ids=list(p), max_new_tokens=n,
                                      sampling=GREEDY)) for i, p in enumerate(prompts)]
    for _ in range(max_steps):
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


def jax_logits(jl, ids):
    from crane_tpu.models.modules.transformer import forward_hidden, lm_logits

    cache = jl.init_cache(ids.shape[0], 16)
    h, _ = forward_hidden(jl.config, jl.params, jnp.asarray(ids), cache,
                          jnp.asarray(0, jnp.int32), jl.rope)
    return np.asarray(lm_logits(jl.config, jl.params, h))


def port_logits(lm, ids):
    cache = lm.init_cache(ids.shape[0], 16)
    h, _ = ttf.forward_hidden(lm.config, lm.params, torch.as_tensor(ids), cache, 0, lm.rope)
    return ttf.lm_logits(lm.config, lm.params, h).numpy()


# ── the mesh and the split ────────────────────────────────────────────────


def test_make_mesh_repeats_devices_and_needs_a_card_by_default():
    mesh = cpu_mesh(2, 2)
    assert (mesh.dp, mesh.tp, mesh.lead) == (2, 2, torch.device("cpu"))
    assert mesh.flat == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(2, 2, ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(1, 2)


def _moe_params(jcfg, params, seed=0):
    """tests/test_parallel.py's MoE conversion: each dense MLP replaced by
    random experts."""
    import jax.random as jr

    key = jr.PRNGKey(seed)
    layers = []
    for layer in params["layers"]:
        k1, k2, k3, k4, key = jr.split(key, 5)
        E, I = jcfg.hidden_size, jcfg.moe_intermediate_size
        layer = dict(layer)
        layer["mlp"] = {
            "router": jr.normal(k4, (E, jcfg.num_experts)) * 0.1,
            "experts_gate": jr.normal(k1, (jcfg.num_experts, E, I)) * E ** -0.5,
            "experts_up": jr.normal(k2, (jcfg.num_experts, E, I)) * E ** -0.5,
            "experts_down": jr.normal(k3, (jcfg.num_experts, I, E)) * I ** -0.5,
        }
        layers.append(layer)
    return {**params, "layers": tuple(layers)}


MOE_CFG = dataclasses.replace(QWEN3_TINY, num_experts=4, num_experts_per_tok=2,
                              moe_intermediate_size=64, decoder_sparse_step=1)


def _key(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _trees(kind):
    """(crane_tpu params, the port's config and params) of a dense and a MoE
    model (the hybrid's are tests/test_torch_parallel_hybrid.py's)."""
    if kind == "dense":
        jcfg, jparams = QWEN3_TINY, init_params(QWEN3_TINY, seed=0, dtype=jnp.float32)
    else:
        jcfg = MOE_CFG
        jparams = _moe_params(MOE_CFG, init_params(MOE_CFG, seed=1, dtype=jnp.float32))
    return jparams, port_cfg(jcfg), params_from_jax(jparams)


def assert_specs_equal(jparams, params):
    """The port's partition specs are crane_tpu's tree, leaf by leaf."""
    ref = jax.tree_util.tree_leaves_with_path(
        jsharding.param_partition_specs(jparams),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = dict(leaves(param_partition_specs(params)))
    assert {_key(path): tuple(spec) for path, spec in ref} == got


def assert_split_and_gathered(cfg, params, dp, tp):
    """Every position holds its own copy of its part (no memory shared with
    the source or another position); gathering group 0 gives the tree back
    bit for bit. Returns the sharded params."""
    sp = shard_params(cfg, params, cpu_mesh(dp, tp))
    assert len(sp.trees) == dp and all(len(row) == tp for row in sp.trees)
    for (path, x), (_, y) in zip(leaves(gather_params(cfg, sp)), leaves(params)):
        assert torch.equal(x, y), path
    ptrs = [t.data_ptr() for row in sp.trees for tree in row for _, t in leaves(tree)]
    assert len(set(ptrs)) == len(ptrs)
    assert not set(ptrs) & {t.data_ptr() for _, t in leaves(params)}
    return sp


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_param_partition_specs_equal_crane_tpus(kind):
    jparams, _, params = _trees(kind)
    assert_specs_equal(jparams, params)


@pytest.mark.parametrize("kind,dp,tp", [("dense", 2, 2), ("moe", 1, 4)])
def test_shard_params_splits_and_gathers_back(kind, dp, tp):
    _, cfg, params = _trees(kind)
    sp = assert_split_and_gathered(cfg, params, dp, tp)
    if kind == "dense":
        wq = sp.trees[1][1]["layers"][0]["attn"]["wq"]
        assert wq.shape == (cfg.hidden_size, cfg.num_heads * cfg.head_dim // tp)
    else:
        assert sp.trees[0][3]["layers"][0]["mlp"]["experts_gate"].shape[0] == 1


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_shard_cache_splits_rows_and_heads_and_gathers_back(lms, bits):
    _, tl = lms
    cfg = tl.config
    cache = tl.init_cache(4, 32, quant_bits=bits)
    gen = torch.Generator().manual_seed(0)
    for layer in cache.layers:
        for t in layer.tensors():
            t.copy_(torch.randint(-7, 8, t.shape, generator=gen).to(t.dtype))
    sc = shard_cache(cfg, cache, cpu_mesh(2, 2))
    part = sc.layers[0].parts[1][1]
    assert isinstance(sc.layers[0], MeshLayerCache)
    assert part.tensors()[0].shape[0] == 2
    if bits is None:
        assert part.k.shape[2] == cfg.num_kv_heads // 2
    else:
        assert part.n_kv_heads == cfg.num_kv_heads // 2
        assert part.k_scale.shape[1] == cfg.num_kv_heads // 2
    back = gather_cache(cfg, sc)
    for a, b in zip(back.layers, cache.layers):
        for x, y in zip(a.tensors(), b.tensors()):
            assert torch.equal(x, y)


# ── tests/test_parallel.py, case for case ────────────────────────────────


def test_tp_forward_matches_single_device(lms):
    jl, tl = lms
    ids = np.array([[1, 5, 9, 17, 33, 2, 7, 11]], dtype=np.int32)
    slm = shard_lm(tl, cpu_mesh(1, 2))
    wq = [tree["layers"][0]["attn"]["wq"] for tree in slm.params.trees[0]]
    assert [w.shape[1] for w in wq] == [tl.params["layers"][0]["attn"]["wq"].shape[1] // 2] * 2
    np.testing.assert_allclose(port_logits(slm, ids), jax_logits(jl, ids), **LOGITS_TOL)


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_moe_expert_parallel_forward(monkeypatch, dispatch):
    """Expert parallelism (experts over tp=4, one each) reproduces
    crane_tpu's single-device logits, under both dispatches."""
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    jparams = _moe_params(MOE_CFG, init_params(MOE_CFG, seed=1, dtype=jnp.float32))
    jl = JLM(MOE_CFG, jparams, dtype=jnp.float32)
    ids = np.array([[1, 5, 9, 17]], dtype=np.int32)
    monkeypatch.delenv("CRANE_MOE_DISPATCH")
    ref = jax_logits(jl, ids)
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    slm = shard_lm(TLM(port_cfg(MOE_CFG), params_from_jax(jparams), dtype=torch.float32),
                   cpu_mesh(1, 4))
    eg = [tree["layers"][0]["mlp"]["experts_gate"] for tree in slm.params.trees[0]]
    assert [e.shape[0] for e in eg] == [1] * 4  # experts distributed
    np.testing.assert_allclose(port_logits(slm, ids), ref, **LOGITS_TOL)


def test_dp_tp_train_step(lms):
    """One AdamW step at dp=2 x tp=2: the loss equals crane_tpu's, the
    gradients (summed over the copies) equal ``jax.grad`` of crane_tpu's
    loss, and the params stay sharded, every dp copy equal to group 0's."""
    from crane_tpu.parallel.train import next_token_loss as jloss

    jl, _ = lms
    tokens = np.arange(32, dtype=np.int32).reshape(2, 16) % QWEN3_TINY.vocab_size
    jparams = init_params(QWEN3_TINY, seed=0, dtype=jnp.float32)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(QWEN3_TINY, p, jl.rope, jnp.asarray(tokens))))(jparams)

    cfg = port_cfg(QWEN3_TINY)
    sp = shard_params(cfg, params_from_jax(jparams), cpu_mesh(2, 2))
    optimizer = torch.optim.AdamW(ttrain.train_parameters(sp), lr=1e-4, weight_decay=1e-4)
    grads = {}
    optimizer.register_step_pre_hook(  # the gradients the optimizer steps with
        lambda opt, args, kwargs: grads.update(leaves(gather_params(cfg, sp, grads=True))))
    train_step = ttrain.make_train_step(cfg, optimizer)
    routes = dict(ttf.attention_block.plain_routes)
    loss = train_step(sp, ttf.make_rope_tables(cfg), torch.as_tensor(tokens))
    assert ttf.attention_block.plain_routes["chunk"] > routes["chunk"]  # the plain route
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        key = _key(path)
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6,
                                   err_msg=str(key))
    wq = [tree["layers"][0]["attn"]["wq"] for row in sp.trees for tree in row]
    assert all(w.shape[1] == QWEN3_TINY.num_heads * QWEN3_TINY.head_dim // 2 for w in wq)
    for t in range(2):
        for (_, a), (_, b) in zip(leaves(sp.trees[0][t]), leaves(sp.trees[1][t])):
            assert torch.equal(a, b)


def test_tp_generate_matches_single_device(lms):
    jl, tl = lms
    prompt = [3, 14, 15, 92, 6, 53]
    slm = shard_lm(tl, cpu_mesh(1, 2))
    assert slm.generate(prompt, GenerationConfig.greedy(10)) \
        == jl.generate(prompt, JGenerationConfig.greedy(10))
    # sampling (same seed, same tokens through the sharded forward)
    g = GenerationConfig(max_new_tokens=8, do_sample=True, temperature=0.8, seed=11)
    assert slm.generate(prompt, g) == tl.generate(prompt, g)


def test_tp_engine_serving_matches_single_device(lms):
    jl, tl = lms
    prompts = [[3, 14, 15], [92, 6, 44, 12]]
    expected = [jl.generate(p, JGenerationConfig.greedy(6)) for p in prompts]
    engine = InferenceEngine(shard_lm(tl, cpu_mesh(1, 2)), max_slots=2, max_seq_len=64,
                             decode_tokens_per_seq=2)
    assert run(engine, prompts, 6) == expected


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "dp2-tp2"])
def test_remat_gradients_match(sharded):
    """Per-layer checkpointing changes memory, not math: the loss and the
    gradients are the same with and without it (the recompute writes the
    throwaway cache again, with the same values)."""
    cfg = port_cfg(QWEN3_TINY)
    tokens = torch.as_tensor(np.arange(16, dtype=np.int32).reshape(1, 16) % cfg.vocab_size)
    if sharded:
        tokens = tokens.repeat(2, 1)
    rope = ttf.make_rope_tables(cfg)
    out = []
    for remat in (False, True):
        params = params_from_jax(init_params(QWEN3_TINY, seed=2, dtype=jnp.float32))
        if sharded:
            params = shard_params(cfg, params, cpu_mesh(2, 2))
        ttrain.train_parameters(params)
        loss = ttrain.next_token_loss(cfg, params, rope, tokens, remat=remat)
        loss.backward()
        if sharded:
            ttrain.reduce_grads(params)
            grads = dict(leaves(gather_params(cfg, params, grads=True)))
        else:
            grads = {k: x.grad for k, x in leaves(params)}
        out.append((float(loss.detach()), grads))
    (l1, g1), (l2, g2) = out
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5, atol=1e-6)


def test_remat_leaves_no_reference_cycle():
    """The first checkpointed forward of a process (a fresh interpreter:
    torch imports ``torch._dynamo`` on checkpoint's first call) leaves none
    of its tensors in a reference cycle, so a train step's activations and
    gradients go when it returns, with no garbage collection."""
    import subprocess
    import sys

    code = """
import gc, sys, torch
from crane_tpu_torch.models.init import QWEN3_TINY, init_params
from crane_tpu_torch.models.modules.transformer import make_rope_tables
from crane_tpu_torch.parallel import train
assert "torch._dynamo" not in sys.modules
cfg = QWEN3_TINY
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
train.train_parameters(params)
tokens = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32)
gc.collect()
gc.disable()
train.next_token_loss(cfg, params, make_rope_tables(cfg), tokens, remat=True).backward()
gc.set_debug(gc.DEBUG_SAVEALL)
gc.collect()
print(sum(isinstance(o, torch.Tensor) for o in gc.garbage))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "0"


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "kv8", "kv4"])
def test_dp_tp_engine_serving_matches_single_device(lms, bits):
    """dp=2 x tp=2 serving: the slots split over the two groups, heads over
    tp; greedy tokens equal crane_tpu's (fp) or the unsharded port
    engine's on the same quantized cache."""
    jl, tl = lms
    prompts = [[3, 14, 15], [92, 6, 44, 12], [5, 6], [9, 9, 9]]
    if bits is None:
        expected = [jl.generate(p, JGenerationConfig.greedy(5)) for p in prompts]
    else:
        expected = run(InferenceEngine(tl, max_slots=4, max_seq_len=64, decode_tokens_per_seq=2,
                                       kv_quant_bits=bits), prompts, 5)
    engine = InferenceEngine(shard_lm(tl, cpu_mesh(2, 2)), max_slots=4, max_seq_len=64,
                             decode_tokens_per_seq=2, kv_quant_bits=bits)
    assert [len(g) for g in engine.cache.layers[0].parts] == [2, 2]
    assert run(engine, prompts, 5) == expected


# ── tests/test_engine.py: the memory budget under dp and tp ───────────────


@pytest.mark.parametrize("dp,tp", [(1, 2), (4, 1), (2, 2)])
def test_hbm_budget_weights_divide_by_tp_only(lms, monkeypatch, dp, tp):
    """Each card holds its tp shard of the weights (so weights divide by
    the tp extent only; every dp group holds them again) and 1 / (dp tp) of
    the KV. The mesh relabelled onto distinct cards shows the split per
    device; on one repeated device the parts add up."""
    _, tl = lms
    slm = shard_lm(tl, cpu_mesh(dp, tp))
    weights = sum(t.numel() * t.element_size() for _, t in leaves(tl.params))
    repl = sum(t.numel() * t.element_size() for path, t in leaves(tl.params)
               if not slm.params.split[path])
    kv = tl.init_cache(4, 512, device="meta").nbytes() - 4 * 4  # without the lengths

    cards = tuple(tuple(torch.device("cuda", g * tp + t) for t in range(tp)) for g in range(dp))
    spread = dataclasses.replace(slm.params, mesh=Mesh(cards))
    per_card = spread.device_bytes()
    assert set(per_card) == set(Mesh(cards).flat)
    for row in cards:
        assert sum(per_card[c] for c in row) == weights + (tp - 1) * repl
    meta = make_sharded_cache(tl.config, Mesh(cards), 4, 512, tl.dtype, device="meta")
    held = _device_bytes(types.SimpleNamespace(params=spread, device=cards[0][0]), meta)
    for c in Mesh(cards).flat:
        lengths = 4 * 4 if c == cards[0][0] else 0
        assert held[c] == per_card[c] + kv // (dp * tp) + lengths

    # on the repeated device the positions add up: dp copies of the weights
    need = int((dp * (weights + (tp - 1) * repl) + kv + 4 * 4) * 1.15)
    wrong = int((weights + kv) * 1.15)  # everything once, the old accounting's total
    if dp > 1:
        assert wrong < need
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need - 1024))
    with pytest.raises(RuntimeError, match="HBM budget exceeded"):
        InferenceEngine(slm, max_slots=4, max_seq_len=512)
    monkeypatch.setenv("CRANE_HBM_BYTES", str(need + 1024))
    _check_hbm_budget(slm, 4, 512, None)


# ── tests/test_kernel_partitioning.py: each shard's call at local shapes ──

D64 = dataclasses.replace(QWEN3_TINY, head_dim=64)  # a head dim the kernels take


@pytest.fixture(scope="module")
def d64():
    jl = JLM(D64, init_params(D64, seed=3, dtype=jnp.float32), dtype=jnp.float32)
    return jl, TLM(port_cfg(D64), params_from_jax(jl.params), dtype=torch.float32)


def _recorded(monkeypatch, names):
    """The (name, q shape, k shape) of every call of the named attention
    wrappers as transformer.py calls them."""
    calls = []
    for name in names:
        fn = getattr(ttf, name)

        def wrapped(q, k, *a, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(q.shape), tuple(k.shape)))
            return _fn(q, k, *a, **kw)

        monkeypatch.setattr(ttf, name, wrapped)
    return calls


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "kv8", "kv4"])
def test_each_shard_attends_its_rows_and_heads(d64, monkeypatch, bits):
    """dp=2 x tp=2 over B=2 rows of Hq=4 / Hkv=2 heads: each attention call
    (prefill K2, a continuation chunk K3/K5, decode K1/K4) gets 1 row and
    Hq/2, Hkv/2 heads, fp and int8/int4 caches alike, and the logits equal
    the unsharded port's (crane_tpu's for the fp cache)."""
    jl, tl = d64
    cfg = tl.config
    names = ("flash_attention_causal", "flash_attention_cached", "fp_decode_attention",
             "quant_cached_attention", "quant_decode_attention")
    ids = np.array([[1, 5, 9, 17, 33, 2, 7, 11]] * 2, dtype=np.int32)
    ids[1] = ids[1][::-1]

    def run_steps(lm):
        cache = lm.init_cache(2, 32, quant_bits=bits)
        out = []
        h, cache = ttf.forward_hidden(cfg, lm.params, torch.as_tensor(ids[:, :4]), cache, 0,
                                      lm.rope, read_cache=False)
        out.append(ttf.lm_logits(cfg, lm.params, h))
        h, cache = ttf.forward_hidden(cfg, lm.params, torch.as_tensor(ids[:, 4:]), cache, 4,
                                      lm.rope)
        out.append(ttf.lm_logits(cfg, lm.params, h))
        h, cache = ttf.forward_hidden(cfg, lm.params, torch.tensor([[3], [4]], dtype=torch.int32),
                                      cache, cache.lengths, lm.rope)
        out.append(ttf.lm_logits(cfg, lm.params, h))
        return out

    ref = run_steps(tl)
    calls = _recorded(monkeypatch, names)
    got = run_steps(shard_lm(tl, cpu_mesh(2, 2)))
    chunk = "flash_attention_cached" if bits is None else "quant_cached_attention"
    decode = "fp_decode_attention" if bits is None else "quant_decode_attention"
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads // 2, cfg.num_kv_heads // 2
    stored = D if bits in (None, 8) else D // 2
    kv = (1, 32, Hkv, D) if bits is None else (1, 32, Hkv * stored)
    per_kind = {"flash_attention_causal": ((1, 4, Hq, D), (1, 4, Hkv, D)),
                chunk: ((1, 4, Hq, D), kv), decode: ((1, 1, Hq, D), kv)}
    n = cfg.num_layers * 4  # every layer, each of the 2 groups x 2 shards
    assert sorted({c[0] for c in calls}) == sorted(per_kind)
    for name, shapes in per_kind.items():
        assert [c[1:] for c in calls if c[0] == name] == [shapes] * n, name
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **LOGITS_TOL)
    if bits is None:
        np.testing.assert_allclose(ref[0].numpy(), jax_logits(jl, ids[:, :4]), **LOGITS_TOL)


def test_indivisible_kv_heads_keep_the_layer_whole(d64, monkeypatch):
    """tp=4 does not divide Hkv=2: as crane_tpu replicates its attention
    there, the port keeps each attention layer whole on the group's first
    device (one call a group, all heads) and still splits the MLP and the
    vocab; the logits are crane_tpu's."""
    jl, tl = d64
    ids = np.array([[1, 5, 9, 17, 33, 2, 7, 11]], dtype=np.int32)
    calls = _recorded(monkeypatch, ("flash_attention_causal",))
    slm = shard_lm(tl, cpu_mesh(1, 4))
    assert all(slm.params.whole)
    assert "attn" in slm.params.trees[0][0]["layers"][0]
    assert "attn" not in slm.params.trees[0][1]["layers"][0]
    assert slm.params.trees[0][1]["layers"][0]["mlp"]["gate"].shape[1] \
        == D64.intermediate_size // 4
    cache = slm.init_cache(1, 16)
    assert len(cache.layers[0].parts[0]) == 1
    h, _ = ttf.forward_hidden(slm.config, slm.params, torch.as_tensor(ids), cache, 0, slm.rope,
                              read_cache=False)
    got = ttf.lm_logits(slm.config, slm.params, h).numpy()
    assert [c[1:] for c in calls] == [((1, 8, D64.num_heads, 64), (1, 8, D64.num_kv_heads, 64))] \
        * D64.num_layers
    np.testing.assert_allclose(got, jax_logits(jl, ids), **LOGITS_TOL)


# ── the reference's limits ────────────────────────────────────────────────


def test_quantized_weights_under_a_mesh_raise_in_both_packages():
    """crane_tpu's shard_params cannot map its spec leaves onto a
    QuantizedWeight node (a reference fault); the port refuses the same
    weights with the reason (tests/test_torch_parallel_checkpoints.py:
    ``--quant q8 --tp 2`` in both servers)."""
    from crane_tpu.models.auto import quantize_params as jquant
    from crane_tpu_torch.models.auto import quantize_params

    jparams = init_params(QWEN3_TINY, seed=0, dtype=jnp.float32)
    with pytest.raises(ValueError, match="Custom dataclass node type mismatch"):
        jsharding.shard_params(jquant(jparams, bits=8), jsharding.make_mesh(1, 2))
    lm = TLM(port_cfg(QWEN3_TINY), quantize_params(params_from_jax(jparams), bits=8),
             dtype=torch.float32)
    with pytest.raises(ValueError, match="cannot be sharded") as err:
        shard_lm(lm, cpu_mesh(1, 2))
    assert str(err.value) == ISQ_UNDER_MESH


def test_attention_gradients_take_the_plain_route():
    """crane_tpu's Pallas attention has no differentiation rule (a reference
    fault: ``jax.grad`` through ``flash_attention_causal`` raises at S=256,
    D=128). The port's next_token_loss at those shapes asks for the plain
    route by argument and counts it; its gradients are finite; the kernel
    wrapper itself refuses the inputs."""
    from crane_tpu.ops.pallas.flash_attention import flash_attention_causal as jflash
    from crane_tpu_torch.ops.cuda.flash_attention import flash_attention_causal

    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 256, h, 128)), jnp.float32) for h in (2, 1, 1))
    with pytest.raises(NotImplementedError, match="custom_partitioning"):
        jax.grad(lambda q: jflash(q, k, v, scale=128 ** -0.5, interpret=True).sum())(q)

    cfg = dataclasses.replace(port_cfg(QWEN3_TINY), num_layers=1, head_dim=128)
    from crane_tpu_torch.models.init import init_params as tinit_params

    params = tinit_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                          dtype=torch.float32)
    ttrain.train_parameters(params)
    tokens = torch.as_tensor(np.arange(256, dtype=np.int32)[None] % cfg.vocab_size)
    before = dict(ttf.attention_block.plain_routes)
    loss = ttrain.next_token_loss(cfg, params, ttf.make_rope_tables(cfg), tokens, remat=False)
    loss.backward()
    assert ttf.attention_block.plain_routes["chunk"] == before["chunk"] + 1
    wq = params["layers"][0]["attn"]["wq"]
    assert wq.grad is not None and torch.isfinite(wq.grad).all() and wq.grad.abs().sum() > 0

    tq, tk, tv = (torch.tensor(np.asarray(x), requires_grad=True) for x in (q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_causal(tq, tk, tv, scale=128 ** -0.5)


def _wrapper_calls():
    """(name, call) of every kernel wrapper on small CPU inputs."""
    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23
    from crane_tpu_torch.ops.cuda import quant_attention as k45

    # the package re-exports these wrappers under their modules' names
    k6 = importlib.import_module("crane_tpu_torch.ops.cuda.quant_matmul")
    k7 = importlib.import_module("crane_tpu_torch.ops.cuda.gdn_scan")

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v = r(1, 4, 2, 64), r(1, 8, 1, 64), r(1, 8, 1, 64)
    qd = r(1, 1, 2, 64)
    codes = torch.randint(-7, 8, (1, 8, 64), dtype=torch.int8, generator=g)
    sc = r(1, 1, 8).abs()
    valid = torch.tensor([5], dtype=torch.int32)
    pos = torch.arange(4, 8, dtype=torch.int32)[None]
    quant = dict(bits=8, scale=0.125)
    return {
        "K1": lambda req: k1.fp_decode_attention(req(qd), k, v, valid, scale=0.125),
        "K1-S": lambda req: k1.fp_decode_attention_with_stats(req(qd), k, v, valid, scale=0.125),
        "K2": lambda req: k23.flash_attention_causal(req(q), req(k[:, :4]), v[:, :4],
                                                      scale=0.125),
        "K3": lambda req: k23.flash_attention_cached(req(q), k, v, pos, scale=0.125),
        "K3-S": lambda req: k23.flash_attention_cached_with_stats(req(q), k, v, pos, scale=0.125),
        "K4": lambda req: k45.quant_decode_attention(req(qd), codes, codes, sc, sc, valid,
                                                     **quant),
        "K4-S": lambda req: k45.quant_decode_attention_with_stats(req(qd), codes, codes, sc, sc,
                                                                  valid, **quant),
        "K5": lambda req: k45.quant_cached_attention(req(q), codes, codes, sc, sc, pos, **quant),
        "K5-S": lambda req: k45.quant_cached_attention_with_stats(req(q), codes, codes, sc, sc,
                                                                  pos, **quant),
        "K6": lambda req: k6.quant_matmul(req(r(3, 64)), codes[0].T.contiguous(),
                                          r(1, 8).abs(), bits=8),
        "K7": lambda req: k7.gdn_scan(req(r(1, 5, 2, 64)), r(1, 5, 2, 64), r(1, 5, 2, 16),
                                      -r(1, 5, 2).abs(), r(1, 5, 2).sigmoid()),
    }


@pytest.mark.parametrize("kernel", ["K1", "K1-S", "K2", "K3", "K3-S", "K4", "K4-S", "K5", "K5-S",
                                    "K6", "K7"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """A kernel's output has no ``grad_fn``: each wrapper raises, on the
    CPU as on the card, when grad mode is on and an input requires grad,
    instead of cutting the gradient; under ``no_grad`` it runs."""
    call = _wrapper_calls()[kernel]
    with pytest.raises(RuntimeError, match="no backward"):
        call(lambda t: t.clone().requires_grad_(True))
    with torch.no_grad():
        call(lambda t: t.clone().requires_grad_(True))
    call(lambda t: t)  # no input requires grad
