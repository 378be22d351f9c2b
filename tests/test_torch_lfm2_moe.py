"""LFM2-MoE (``lfm2_moe``) in crane_tpu_torch against the benchmark's plain
float32 reference (``crane_bench/models/lfm2_moe.py``), on the CPU in
float32, with seeded random weights drawn by ``crane_bench.weights.Weights``
at tiny widths (crane_tpu has no such model, so the reference is the plain
one): the configuration's mapping, the sigmoid router with its
selection-only bias, prefill and decode through the cache (whole and
chunked) under both dispatches, tensor-parallel shards of the experts, the
idle of a traced prefill, and a tiny run of the benchmark cell.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crane_bench import devtrace, program_spans, run, weights
from crane_bench.models import plain
from crane_bench.spec import HERE, load_module, read_json
from crane_bench.tests import tiny
from crane_tpu_torch.models.auto import map_hf_weights, transformer_config_from_hf
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
from crane_tpu_torch.ops.kv_cache import ConvLayerCache, LayerKVCache
from crane_tpu_torch.parallel.sharding import param_partition_specs
from crane_tpu_torch.utils import tracing

torch.set_num_threads(2)

CELL = "lfm2-24b-a2b.decode-heavy"
CONFIG = HERE / "configs" / "lfm2-24b-a2b.json"
# the tiny widths of this file's runs: 4 layers (conv, conv, attention, conv;
# layers 0-1 dense, 2-3 MoE), 8 experts top-2
TINY = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, moe_intermediate_size=32, num_experts=8,
            num_experts_per_tok=2, vocab_size=512, max_position_embeddings=4096)
# port against reference, both float32: the same products in other orders
# (batched experts, fused rows), so rounding apart, relative to the largest
# logit; the bar of crane_bench/tests/test_bench_reference.py
REL_TOL = 1e-4


@pytest.fixture
def tiny_preset(monkeypatch):
    """``crane_bench.tests.tiny.TINY`` with this file's lfm2_moe preset."""
    monkeypatch.setitem(tiny.TINY, "lfm2_moe", TINY)


def _grouped_mm_runs() -> bool:
    try:
        torch._grouped_mm(torch.ones(2, 4), torch.ones(1, 4, 4),
                          offs=torch.tensor([2], dtype=torch.int32))
        return True
    except (RuntimeError, NotImplementedError, AttributeError):
        return False


DISPATCHES = ["dense", pytest.param("ragged", marks=pytest.mark.skipif(
    not _grouped_mm_runs(), reason="torch._grouped_mm does not run on this CPU build"))]


def test_config_maps_the_published_file():
    hf = read_json(CONFIG)
    cfg = transformer_config_from_hf(hf)
    assert isinstance(cfg, ttf.MoeRouterConfig)
    assert (cfg.moe_router, cfg.routed_scaling_factor) == ("sigmoid", 1.0)
    assert cfg.rope_theta == 1e6  # only under rope_parameters in the file
    assert cfg.mlp_only_layers == (0, 1)
    assert [cfg.is_moe_layer(i) for i in range(40)] == [False] * 2 + [True] * 38
    assert cfg.layer_types.count("conv") == 30 and cfg.layer_types.count("full") == 10
    assert [i for i, t in enumerate(cfg.layer_types) if t == "full"] == list(range(2, 40, 4))
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 8, 64)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size) == (64, 4, 1536)
    assert (cfg.intermediate_size, cfg.shared_expert_intermediate_size) == (11776, 0)
    assert cfg.norm_topk_prob and cfg.tie_word_embeddings and cfg.qk_norm
    assert (cfg.rms_norm_eps, cfg.conv_l_cache, cfg.conv_bias) == (1e-5, 3, False)
    assert (cfg.hidden_size, cfg.vocab_size, cfg.num_layers) == (2048, 65536, 40)


@pytest.mark.parametrize("model_type", ["lfm2", "lfm2_moe"])
def test_rope_theta_read_from_rope_parameters(model_type):
    """Newer LFM2 configs keep theta only in ``rope_parameters``; a
    top-level ``rope_theta`` still wins where there is one."""
    hf = {k: v for k, v in read_json(CONFIG).items() if k != "rope_theta"}
    hf["model_type"] = model_type
    assert transformer_config_from_hf(hf).rope_theta == 1e6
    assert transformer_config_from_hf(dict(hf, rope_theta=5e5)).rope_theta == 5e5
    del hf["rope_parameters"]
    assert transformer_config_from_hf(hf).rope_theta == 10000.0


def test_softmax_stays_the_default_router():
    cfg = ttf.TransformerConfig(vocab_size=8, hidden_size=8, num_layers=1, num_heads=1,
                                num_kv_heads=1, head_dim=8, intermediate_size=8)
    assert (cfg.moe_router, cfg.routed_scaling_factor) == ("softmax", 1.0)
    assert "moe_router" not in {f.name for f in dataclasses.fields(cfg)}


def _moe_params(n, E, I, seed, bias_scale):
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * shape[-2] ** -0.5

    return {"router": w(E, n), "experts_gate": w(n, E, I), "experts_up": w(n, E, I),
            "experts_down": w(n, I, E),
            "expert_bias": torch.randn(n, generator=g) * bias_scale}


def _router_cfg(n=8, k=3, norm=True, scale=1.0):
    return ttf.MoeRouterConfig(
        vocab_size=16, hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=2, head_dim=16,
        intermediate_size=64, num_experts=n, num_experts_per_tok=k, moe_intermediate_size=24,
        norm_topk_prob=norm, moe_router="sigmoid", routed_scaling_factor=scale)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("norm,scale", [(True, 1.0), (False, 2.5)])
def test_sigmoid_router_against_a_hand_computation(dispatch, norm, scale, monkeypatch):
    """The experts chosen on sigmoid + bias, weighted by the unbiased
    sigmoids: a bias that changes the choice of most tokens, while the
    weights stay the chosen experts' own scores."""
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    cfg = _router_cfg(norm=norm, scale=scale)
    p = _moe_params(8, 32, 24, seed=1, bias_scale=0.5)
    x = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(2))
    xt = x.reshape(14, 32).double()
    scores = torch.sigmoid(xt @ p["router"].double()).numpy()
    choice = scores + p["expert_bias"].double().numpy()
    want = np.zeros((14, 32))
    changed = 0
    for t in range(14):
        sel = np.argsort(-choice[t])[:3]
        changed += set(sel) != set(np.argsort(-scores[t])[:3])
        wts = scores[t, sel] / (scores[t, sel].sum() + 1e-6) if norm else scores[t, sel]
        for e, wt in zip(sel, wts * scale):
            h = xt[t] @ p["experts_gate"][e].double()
            h = torch.nn.functional.silu(h) * (xt[t] @ p["experts_up"][e].double())
            want[t] += wt * (h @ p["experts_down"][e].double()).numpy()
    assert changed >= 7  # the bias moves the choice of half the tokens or more
    w, sel = ttf._route_sigmoid(cfg, p, x.reshape(14, 32))
    assert [set(r) for r in sel.tolist()] == [set(np.argsort(-c)[:3]) for c in choice]
    chosen = np.take_along_axis(scores, sel.numpy(), 1)
    if norm:
        chosen = chosen / (chosen.sum(1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(w.numpy(), chosen * scale, rtol=1e-5)
    got = ttf.mlp_block(cfg, p, x).reshape(14, 32).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_sigmoid_router_over_tensor_parallel_shards(dispatch, monkeypatch):
    """Each shard's experts at its offset, the router whole: the shards'
    float32 partials add up to the whole layer."""
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    cfg = _router_cfg()
    p = _moe_params(8, 32, 24, seed=3, bias_scale=0.5)
    x = torch.randn(1, 9, 32, generator=torch.Generator().manual_seed(4))
    whole = ttf.moe_block(cfg, p, x)
    parts = []
    for t in range(4):
        shard = {k: (v[2 * t:2 * t + 2] if k.startswith("experts_") else v) for k, v in p.items()}
        parts.append(ttf.moe_block(cfg, shard, x, expert_offset=2 * t, partial=True))
    torch.testing.assert_close(sum(parts), whole.float(), rtol=1e-5, atol=1e-6)
    spec = param_partition_specs({"layers": ({"mlp": p, "input_ln": None},)})
    assert spec["layers"][0]["mlp"]["expert_bias"] == ()


def _tiny_model(seed=3):
    hf = tiny.tiny_hf(read_json(CONFIG))
    model = load_module(HERE / "models" / "lfm2_moe.py", "m_lfm2_moe")
    cfg = transformer_config_from_hf(hf)
    params = map_hf_weights(cfg, weights.Weights(model, hf, seed, "cpu"), torch.float32,
                            torch.device("cpu"))
    return hf, model, cfg, params


def test_weights_map_from_the_lfm2_moe_names(tiny_preset):
    hf, _, cfg, params = _tiny_model()
    assert [cfg.layer_type(i) for i in range(4)] == ["conv", "conv", "full", "conv"]
    dense, moe = params["layers"][1]["mlp"], params["layers"][2]["mlp"]
    assert set(dense) == {"gate", "up", "down"} and dense["gate"].shape == (64, 96)
    assert set(moe) == {"router", "experts_gate", "experts_up", "experts_down", "expert_bias"}
    assert moe["experts_gate"].shape == (8, 64, 32) and moe["experts_down"].shape == (8, 32, 64)
    assert moe["router"].shape == (64, 8) and moe["expert_bias"].dtype == torch.float32
    assert set(params["layers"][2]["attn"]) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    assert "lm_head" not in params  # tied
    lm = CausalLM(cfg, params, dtype=torch.float32)
    cache = lm.init_cache(2, 64)
    assert [type(c) for c in cache.layers] == [ConvLayerCache] * 2 + [LayerKVCache, ConvLayerCache]


def _reference_logits(hf, model, ids, seed=3):
    plain.exact_float32()
    src = weights.Weights(model, hf, seed, "cpu")
    g = src.globals()
    hs = [plain.f32(g["model.embed_tokens.weight"][ids.long()])]
    for i in range(hf["num_hidden_layers"]):
        hs = model.layers(hf, i, src.layer(i), hs, [torch.arange(ids.shape[0])])
    return model.final_norm(hf, g, hs[0]) @ plain.f32(model.head(hf, g)).T


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_port_equals_the_reference(tiny_preset, dispatch, monkeypatch):
    """Full-prefill logits; then a whole slot prefill of 26 tokens and a
    prefill in chunks of 16 and 10, each followed by decode steps through
    the cache to 40 tokens: every logit the port gives equals the
    reference's full forward at that position."""
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    hf, model, cfg, params = _tiny_model()
    L = 40
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, hf["vocab_size"], L),
                          dtype=torch.int32)
    ref = _reference_logits(hf, model, ids)
    scale = ref.abs().max().item()
    lm = CausalLM(cfg, params, dtype=torch.float32)

    h, _ = forward_hidden(cfg, params, ids[None], lm.init_cache(1, 64), 0, lm.rope,
                          read_cache=False, true_lengths=torch.tensor([L], dtype=torch.int32))
    assert (lm_logits(cfg, params, h)[0] - ref).abs().max().item() <= REL_TOL * scale

    def bucket(part):
        x = np.zeros((1, 64), np.int32)
        x[0, :len(part)] = part.numpy()
        return x

    for chunks in ([26], [16, 10]):
        cache = lm.init_cache(2, 128)  # row 1 of the slots
        firsts, start = [], 0
        for n in chunks:
            x = bucket(ids[start:start + n])
            if start == 0:
                logits, cache = lm.prefill_slot(cache, x, 1, n)
            else:
                logits, cache = lm.prefill_slot_continue(cache, x, 1, start, n)
            firsts.append(logits[0])
            start += n
        steps = []
        active = torch.tensor([False, True])
        for p in range(start, L):
            tok = torch.stack([torch.tensor(0, dtype=torch.int32), ids[p]])[:, None]
            hd, cache = forward_hidden(cfg, params, tok, cache, cache.lengths, lm.rope,
                                       active=active)
            steps.append(lm_logits(cfg, params, hd)[1, 0])
        got = torch.stack([*firsts, *steps])
        at = [sum(chunks[:j + 1]) - 1 for j in range(len(chunks))] + list(range(start, L))
        assert (got - ref[at]).abs().max().item() <= REL_TOL * scale, chunks
        assert int(cache.lengths[1]) == L and int(cache.lengths[0]) == 0


# a float32 program reads 0 to 1e-6 against the float32 reference; the float8
# reference about 0.02 on this tiny model
LIMIT = 1e-3


def test_engine_run_is_correct_where_its_control_fails(tiny_preset, monkeypatch):
    """A whole run of the cell at a tiny size, the program serving in
    float32: its greedy tokens pass, the float8 reference's fail. (This
    suite's conftest loads jax, so the harness's guard against a process
    that loaded it is stubbed here; the benchmark's own runs keep it.)"""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    cell = tiny.tiny_cell(CELL, limit=LIMIT, f32=True)
    cell.mix["check"] = {"served_tokens": 10 ** 6, "max_requests": 64}
    assert cell.limits["control"]["kind"] == "reference_fp8"
    program = run.run_cell(cell, 2 ** 31 + 5, 3.0, False, "cpu")
    ctl = run.run_cell(cell, 2 ** 31 + 5, 3.0, False, "cpu", control=True)
    assert program["result"]["correct"], program["result"]["check"]
    assert program["result"]["failed"] == 0 and program["result"]["attempted"] > 0
    assert not ctl["result"]["correct"], ctl["result"]["check"]


@pytest.fixture
def recording():
    tracing.reset()
    tracing.enable()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("chunks", [[26], [16, 10]])
def test_prefill_idle_stays_the_prefills(tiny_preset, recording, dispatch, chunks, monkeypatch):
    """A traced slot prefill of the MoE stack opens no span inside
    ``model.prefill``: every idle gap of the device during it goes to
    ``model.prefill`` (``model.prefill_idle_share``), the MoE layers'
    included. The device here is busy for a microsecond at 64 points
    spread over each prefill, so idle gaps fall all through it."""
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    hf, _, cfg, params = _tiny_model()
    lm = CausalLM(cfg, params, dtype=torch.float32)
    ids = np.random.default_rng(4).integers(0, hf["vocab_size"], sum(chunks))
    cache, start = lm.init_cache(2, 128), 0
    for n in chunks:
        x = np.zeros((1, 64), np.int32)
        x[0, :n] = ids[start:start + n]
        with tracing.span("engine.admit"):
            if start == 0:
                _, cache = lm.prefill_slot(cache, x, 1, n)
            else:
                _, cache = lm.prefill_slot_continue(cache, x, 1, start, n)
        start += n
    recs = tracing.timeline()
    prefills = [r for r in recs if r.name == "model.prefill"]
    assert len(prefills) == len(chunks)
    assert [r.name for r in recs if r.parent == "model.prefill"] == []
    sl = devtrace.Slice([], None)
    sl.t0_ns, sl.t1_ns = min(r.start_ns for r in recs), max(r.end_ns for r in recs)
    sl.events = [("k", t, t + 1000) for r in prefills
                 for t in (r.start_ns + (r.end_ns - 1000 - r.start_ns) * i // 63 for i in range(64))]
    idle = program_spans.idle_by_span(sl, program_spans.records(sl))
    inside = sum(r.end_ns - r.start_ns - 64 * 1000 for r in prefills) / 1e9
    assert idle.get("model.prefill", 0.0) == pytest.approx(inside, rel=1e-6)
