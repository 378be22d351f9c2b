"""Tensor and data parallelism on checkpoints saved by transformers, on the CPU.

tests/test_torch_parallel.py's companion (each file stays short under
``--dist loadfile``) for the cases that load a checkpoint: the hybrids with
Gated-DeltaNet layers, against crane_tpu on the same files (the tiny
Qwen3-Next of tests/test_qwen3_next_parity.py: its partition specs, its
split, tp generate and its cache split both ways; tests/test_moe_parity.py's
tiny Qwen3-Next MoE, expert parallel under both dispatches;
tests/test_gguf_hybrid.py's GGUF hybrid), and ``serve/api.py``'s ``main``
with ``--tp``/``--dp`` (a 2 x 2 mesh serving on the CPU, the meshes it
refuses, and ``--quant q8 --tp 2`` refused by both packages' servers).
Greedy tokens equal crane_tpu's; logits and caches within the port's bar
against crane_tpu.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import auto as tauto
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.kv_cache import GdnLayerCache
from crane_tpu_torch.parallel.inference import gather_cache, shard_cache, shard_lm
from crane_tpu_torch.utils.bridge import cache_from_jax
from tests.test_torch_parallel import (
    CACHE_TOL,
    assert_specs_equal,
    assert_split_and_gathered,
    cpu_mesh,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    from crane_tpu.models import auto as jauto
    from tests.test_qwen3_next_parity import _save_tiny_next

    _, d = _save_tiny_next(tmp_path_factory.mktemp("next"))
    return (jauto.from_pretrained(d, dtype=jnp.float32),
            tauto.from_pretrained(d, dtype=torch.float32, device="cpu"))


def test_param_partition_specs_equal_crane_tpus(hybrid):
    jl, tl = hybrid
    assert_specs_equal(jl.params, tl.params)


def test_shard_params_splits_and_gathers_back(hybrid):
    """As tests/test_torch_parallel.py's dense and MoE cases, at dp=2 x
    tp=2: each shard holds its q/k/v conv channels and its v-heads."""
    _, tl = hybrid
    cfg, tp = tl.config, 2
    sp = assert_split_and_gathered(cfg, tl.params, 2, tp)
    gdn = sp.trees[0][1]["layers"][0]["gdn"]
    assert gdn["conv_w"].shape[0] == cfg.gdn.conv_dim // tp
    assert gdn["A_log"].shape == (cfg.gdn.num_v_heads // tp,)


def test_tp_hybrid_generate_matches_single_device(hybrid):
    """The GDN layers split their k-head-major projections and v-head
    states over tp (each shard convolving its own q/k/v channels) and still
    give crane_tpu's single-device tokens; a prefilled cache gathers back to
    crane_tpu's, and crane_tpu's cache split over the mesh decodes on."""
    jl, tl = hybrid
    prompt = [3, 14, 15, 92, 6]
    slm = shard_lm(tl, cpu_mesh(1, 2))
    gdn = [tree["layers"][0]["gdn"]["in_proj_qkvz"] for tree in slm.params.trees[0]]
    assert [w.shape[1] for w in gdn] == [tl.params["layers"][0]["gdn"]["in_proj_qkvz"].shape[1]
                                         // 2] * 2
    cache = slm.init_cache(1, 32)
    part = cache.layers[0].parts[0][1]
    assert isinstance(part, GdnLayerCache)
    assert part.recurrent_state.shape[1] == tl.config.gdn.num_v_heads // 2
    assert slm.generate(prompt, GenerationConfig.greedy(10)) \
        == jl.generate(prompt, JGenerationConfig.greedy(10))

    jc = jl.init_cache(1, 32)
    jlog, jc = jl.prefill(jc, jnp.asarray([prompt + [0] * 3], jnp.int32), [len(prompt)])
    tlog, tc = slm.prefill(slm.init_cache(1, 32), [prompt + [0] * 3], [len(prompt)])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **CACHE_TOL)
    ref = cache_from_jax(jc)
    for got, want in zip(gather_cache(tl.config, tc).layers, ref.layers):
        for x, y in zip(got.tensors(), want.tensors()):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **CACHE_TOL)

    # crane_tpu's cache, split, decodes one step as crane_tpu does
    from crane_tpu.models.modules.transformer import forward_hidden as jfh, lm_logits as jll

    tok = int(np.argmax(np.asarray(jlog)[0]))
    want = np.asarray(jax.jit(lambda t, c: jll(jl.config, jl.params, jfh(
        jl.config, jl.params, t, c, c.lengths, jl.rope)[0]))(jnp.asarray([[tok]], jnp.int32), jc))
    sc = shard_cache(tl.config, ref, cpu_mesh(1, 2))
    h, _ = ttf.forward_hidden(tl.config, slm.params, torch.tensor([[tok]], dtype=torch.int32),
                              sc, sc.lengths, slm.rope)
    np.testing.assert_allclose(ttf.lm_logits(tl.config, slm.params, h).numpy(), want,
                               **CACHE_TOL)


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_tp_hybrid_moe_generate_matches_single_device(tmp_path_factory, monkeypatch, dispatch):
    """tests/test_moe_parity.py's tiny Qwen3-Next MoE (GDN layers, 8
    experts, a shared expert, one dense MLP layer) at tp=2: each shard
    routes over all experts and computes its own four, under both
    dispatches; the tokens are crane_tpu's."""
    transformers = pytest.importorskip("transformers")
    from crane_tpu.models import auto as jauto

    torch.manual_seed(0)
    cfg = transformers.Qwen3NextConfig(
        vocab_size=160, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, linear_num_value_heads=4, linear_num_key_heads=2,
        linear_key_head_dim=16, linear_value_head_dim=8,
        linear_conv_kernel_dim=4, partial_rotary_factor=0.25,
        max_position_embeddings=256, tie_word_embeddings=False,
        num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1,
        moe_intermediate_size=32, shared_expert_intermediate_size=48,
        norm_topk_prob=True, mlp_only_layers=[1],
        layer_types=["linear_attention", "linear_attention", "linear_attention", "full_attention"],
    )
    d = str(tmp_path_factory.mktemp("moe") / "m")
    transformers.Qwen3NextForCausalLM(cfg).eval().to(torch.float32).save_pretrained(
        d, safe_serialization=True)
    prompt = [3, 14, 15, 92, 6]
    expected = jauto.from_pretrained(d, dtype=jnp.float32).generate(
        prompt, JGenerationConfig.greedy(8))
    monkeypatch.setenv("CRANE_MOE_DISPATCH", dispatch)
    slm = shard_lm(tauto.from_pretrained(d, dtype=torch.float32, device="cpu"), cpu_mesh(1, 2))
    assert slm.params.trees[0][1]["layers"][0]["mlp"]["experts_gate"].shape[0] == 4
    assert slm.generate(prompt, GenerationConfig.greedy(8)) == expected


def test_gguf_hybrid_tp_generate_matches(tmp_path_factory):
    """The GGUF loader fuses the split GDN projections into the k-head-major
    layout, so a GGUF hybrid shards under tp like a safetensors one
    (tests/test_gguf_hybrid.py's conversion)."""
    transformers = pytest.importorskip("transformers")
    from crane_tpu.loaders.gguf_model import from_gguf as jfrom_gguf
    from crane_tpu_torch.loaders.gguf_model import from_gguf
    from tests.test_gguf_hybrid import HK, K, V, VG, _convert_to_gguf

    torch.manual_seed(0)
    cfg = transformers.Qwen3NextConfig(
        vocab_size=160, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, linear_num_value_heads=HK * VG, linear_num_key_heads=HK,
        linear_key_head_dim=K, linear_value_head_dim=V,
        linear_conv_kernel_dim=4, partial_rotary_factor=0.25,
        max_position_embeddings=256, num_experts=0, decoder_sparse_step=0,
        tie_word_embeddings=False,
        layer_types=["linear_attention"] * 3 + ["full_attention"],
    )
    d = tmp_path_factory.mktemp("gh")
    transformers.Qwen3NextForCausalLM(cfg).eval().to(torch.float32) \
        .save_pretrained(str(d / "m"), safe_serialization=True)
    path = _convert_to_gguf(str(d / "m"), str(d / "m.gguf"))
    lm = from_gguf(path, dtype=torch.float32, device="cpu")
    assert "in_proj_qkvz" in lm.params["layers"][0]["gdn"]
    prompt = [3, 14, 15, 92, 6]
    slm = shard_lm(lm, cpu_mesh(1, 2))
    assert slm.params.trees[0][1]["layers"][0]["gdn"]["in_proj_qkvz"].shape[1] \
        == lm.params["layers"][0]["gdn"]["in_proj_qkvz"].shape[1] // 2
    assert slm.generate(prompt, GenerationConfig.greedy(8)) \
        == jfrom_gguf(path, dtype=jnp.float32).generate(prompt, JGenerationConfig.greedy(8))


# ── serve/api.py main ────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.fixtures import make_tiny_qwen3_checkpoint

    # a vocabulary tp=2 divides (crane_tpu's split requires it too)
    return make_tiny_qwen3_checkpoint(str(tmp_path_factory.mktemp("tp") / "m"), vocab_size=128)


def test_main_serves_tp2_dp2_on_the_cpu(ckpt, monkeypatch):
    """``--tp 2 --dp 2 --device cpu``: the model split over a 2 x 2 mesh of
    the CPU, the engine's slots over the two groups, one chat completion
    served."""
    from crane_tpu_torch.serve import api, transport
    from tests.test_torch_api import CHAT, PortClient

    seen = {}

    def serve_once(app, *, host, port):
        seen["server"] = app.router.routes[0][2].__self__
        with transport.BackgroundServer(app) as srv:
            seen["answer"] = PortClient(srv.port).request("POST", "/v1/chat/completions", CHAT)

    monkeypatch.setattr(transport, "run_app", serve_once)
    api.main(["--model-path", ckpt, "--device", "cpu", "--dtype", "f32", "--max-concurrent", "2",
              "--max-seq-len", "256", "--tp", "2", "--dp", "2"])
    engine = seen["server"].engine
    assert (engine.lm.grid.dp, engine.lm.grid.tp) == (2, 2)
    assert [len(g) for g in engine.cache.layers[0].parts] == [2, 2]
    status, _, body = seen["answer"]
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == CHAT["max_tokens"]


@pytest.mark.parametrize("flags", [["--tp", "2", "--sp", "2"],
                                   ["--dp", "2", "--max-concurrent", "3"]])
def test_main_refuses_meshes_that_do_not_split(ckpt, flags):
    from crane_tpu_torch.serve.api import main

    with pytest.raises(ValueError, match="mutually exclusive|must divide"):
        main(["--model-path", ckpt, "--device", "cpu", *flags])


def test_main_refuses_quantized_weights_under_a_mesh_in_both_packages(ckpt):
    """``--quant q8 --tp 2``: crane_tpu's server fails at start-up on its
    own fault (its shard_params cannot map a spec onto a QuantizedWeight),
    the port's refuses with the reason."""
    from crane_tpu.serve.api import main as jmain
    from crane_tpu_torch.serve.api import main

    with pytest.raises(ValueError, match="Custom dataclass node type mismatch"):
        jmain(["--model-path", ckpt, "--quant", "q8", "--tp", "2", "--dtype", "f32"])
    with pytest.raises(ValueError, match="cannot be sharded"):
        main(["--model-path", ckpt, "--device", "cpu", "--quant", "q8", "--tp", "2",
              "--dtype", "f32"])
