"""Each architecture's plain float32 reference against the port's CPU path
in float32 at a tiny size, on the same drawn weights: a whole prefill, and
a prefill in two chunks followed by decode steps."""

import numpy as np
import pytest
import torch

from crane_bench import weights
from crane_bench.models import plain
from crane_bench.spec import HERE, load_module, read_json
from crane_bench.tests.tiny import tiny_hf


def port_and_reference(config: str, seed: int = 3, L: int = 40):
    from crane_tpu_torch.models.auto import map_hf_weights, transformer_config_from_hf
    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits

    hf = tiny_hf(read_json(HERE / "configs" / f"{config}.json"))
    model = load_module(HERE / "models" / f"{hf['model_type']}.py", f"m_{hf['model_type']}")
    cfg = transformer_config_from_hf(hf)
    params = map_hf_weights(cfg, weights.Weights(model, hf, seed, "cpu"), torch.float32,
                            torch.device("cpu"))
    lm = CausalLM(cfg, params, dtype=torch.float32)
    ids = torch.as_tensor(np.random.default_rng(seed).integers(0, hf["vocab_size"], L),
                          dtype=torch.int32)[None]

    plain.exact_float32()
    src = weights.Weights(model, hf, seed, "cpu")
    g = src.globals()
    hs = [plain.f32(g["model.embed_tokens.weight"][ids[0].long()])]
    for i in range(hf["num_hidden_layers"]):
        hs = model.layers(hf, i, src.layer(i), hs, [torch.arange(L)])
    ref = model.final_norm(hf, g, hs[0]) @ plain.f32(model.head(hf, g)).T

    h, _ = forward_hidden(cfg, params, ids, lm.init_cache(1, 64), 0, lm.rope, read_cache=False,
                          true_lengths=torch.tensor([L], dtype=torch.int32))
    whole = lm_logits(cfg, params, h)[0]

    cache = lm.init_cache(1, 128)
    x = np.zeros((1, 64), np.int32)
    x[0, :16] = ids[0, :16].numpy()
    first, cache = lm.prefill_slot(cache, x, 0, 16)
    x[0, :] = 0
    x[0, :10] = ids[0, 16:26].numpy()
    second, cache = lm.prefill_slot_continue(cache, x, 0, 16, 10)
    steps = []
    for p in range(26, L):
        hd, cache = forward_hidden(cfg, params, ids[:, p:p + 1], cache, cache.lengths, lm.rope,
                                   active=torch.tensor([True]))
        steps.append(lm_logits(cfg, params, hd)[0, 0])
    served = torch.stack([first[0], second[0], *steps])
    return ref, whole, served, ref[[15, 25, *range(26, L)]]


@pytest.mark.parametrize("config", ["qwen3-0.6b", "qwen3-next-80b-a3b"])
def test_reference_equals_port_float32(config):
    ref, whole, served, ref_served = port_and_reference(config)
    scale = ref.abs().max().item()
    assert (whole - ref).abs().max().item() <= 1e-4 * scale
    assert (served - ref_served).abs().max().item() <= 1e-4 * scale
