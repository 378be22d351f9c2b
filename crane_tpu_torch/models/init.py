"""Random parameter initialization for a TransformerConfig (port of
``crane_tpu/models/init.py``): benchmarks, dry runs and tests, where decode
speed does not depend on the weights' values.

The tree has the reference's structure and scales; the values come from the
given ``torch.Generator`` (``jax.random`` draws other numbers from the same
seed, so tests that compare the packages hand one set of weights to both).
"""

from __future__ import annotations

import torch

from crane_tpu_torch.models.modules.transformer import TransformerConfig
from crane_tpu_torch.utils.device import default_device


def init_params(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """Normal weights (scale ``fan_in ** -0.5``, embedding 0.02), unit norms,
    zero biases, for the attention layers of ``cfg`` (as the reference's,
    every layer is one; a hybrid model's GDN weights come from
    :func:`hf_state_dict`). With ``attn_output_gate`` the q projection
    carries ``[query | gate]`` per head and is twice as wide. Drawn in
    float32 on the generator's device, then cast and moved to ``device``:
    by default the card, and with no card an error unless ``device="cpu"``
    is given."""
    device = default_device(device)
    gen_device = generator.device

    def nrm(shape, scale):
        w = torch.randn(shape, generator=generator, device=gen_device, dtype=torch.float32)
        return (w * scale).to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones((n,), device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    E, D = cfg.hidden_size, cfg.head_dim
    H, Hkv, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    s = E ** -0.5
    q_out = H * D * (2 if cfg.attn_output_gate else 1)
    layers = []
    for _ in range(cfg.num_layers):
        attn = {
            "wq": nrm((E, q_out), s),
            "wk": nrm((E, Hkv * D), s),
            "wv": nrm((E, Hkv * D), s),
            "wo": nrm((H * D, E), (H * D) ** -0.5),
        }
        if cfg.qk_norm:
            attn["q_norm"] = ones(D)
            attn["k_norm"] = ones(D)
        if cfg.attn_bias:
            attn["bq"], attn["bk"], attn["bv"] = zeros(q_out), zeros(Hkv * D), zeros(Hkv * D)
        layers.append({
            "attn": attn,
            "mlp": {
                "gate": nrm((E, I), s),
                "up": nrm((E, I), s),
                "down": nrm((I, E), I ** -0.5),
            },
            "input_ln": ones(E),
            "post_ln": ones(E),
        })
    params = {
        "embed": nrm((cfg.vocab_size, E), 0.02),
        "layers": tuple(layers),
        "final_norm": ones(E),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm((E, cfg.vocab_size), s)
    return params


def hf_state_dict(cfg: TransformerConfig, generator: torch.Generator,
                  dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """A random checkpoint in the HF layout (``[out, in]`` linears, the
    Qwen3-Next names for GDN layers), for ``map_hf_weights``: normal
    weights with :func:`init_params`' scales, unit norm weights (zero where
    ``norm_weight_offset`` makes them ``1 + w``), and each GDN layer's
    ``A_log`` and ``dt_bias`` drawn as HF initializes them
    (``A = U(0, 16)``, ``A_log = log A``; ``dt_bias = 1``), so the
    recurrent state stays bounded. Tensors stay on the generator's
    device."""
    dev = generator.device
    E, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    H, Hkv = cfg.num_heads, cfg.num_kv_heads

    def lin(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=generator, device=dev)
        return (w * in_f ** -0.5).to(dtype)

    def norm(n):
        return torch.full((n,), 1.0 - cfg.norm_weight_offset, dtype=dtype, device=dev)

    sd = {"model.embed_tokens.weight":
          (torch.randn((cfg.vocab_size, E), generator=generator, device=dev) * 0.02).to(dtype),
          "model.norm.weight": norm(E)}
    for i in range(cfg.num_layers):
        lp = f"model.layers.{i}."
        sd.update({lp + "input_layernorm.weight": norm(E),
                   lp + "post_attention_layernorm.weight": norm(E),
                   lp + "mlp.gate_proj.weight": lin(I, E),
                   lp + "mlp.up_proj.weight": lin(I, E),
                   lp + "mlp.down_proj.weight": lin(E, I)})
        if cfg.layer_type(i) == "gdn":
            g, gp = cfg.gdn, lp + "linear_attn."
            n_v = g.num_v_heads
            a = torch.rand((n_v,), generator=generator, device=dev) * 16
            conv = torch.randn((g.conv_dim, 1, g.conv_kernel), generator=generator, device=dev)
            sd.update({
                gp + "in_proj_qkvz.weight": lin(2 * g.key_dim + 2 * g.value_dim, E),
                gp + "in_proj_ba.weight": lin(2 * n_v, E),
                gp + "conv1d.weight": (conv * g.conv_kernel ** -0.5).to(dtype),
                gp + "A_log": torch.log(a.clamp(min=1e-4)),
                gp + "dt_bias": torch.ones((n_v,), device=dev),
                gp + "norm.weight": torch.ones((g.head_v_dim,), dtype=dtype, device=dev),
                gp + "out_proj.weight": lin(E, g.value_dim),
            })
            continue
        q_out = H * D * (2 if cfg.attn_output_gate else 1)
        sd.update({lp + "self_attn.q_proj.weight": lin(q_out, E),
                   lp + "self_attn.k_proj.weight": lin(Hkv * D, E),
                   lp + "self_attn.v_proj.weight": lin(Hkv * D, E),
                   lp + "self_attn.o_proj.weight": lin(E, H * D)})
        if cfg.qk_norm:
            sd[lp + "self_attn.q_norm.weight"] = norm(D)
            sd[lp + "self_attn.k_norm.weight"] = norm(D)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = lin(cfg.vocab_size, E)
    return sd


QWEN3_0_6B = TransformerConfig(
    vocab_size=151936, hidden_size=1024, num_layers=28, num_heads=16,
    num_kv_heads=8, head_dim=128, intermediate_size=3072, rms_norm_eps=1e-6,
    rope_theta=1000000.0, max_position_embeddings=40960, qk_norm=True,
    tie_word_embeddings=True,
)

QWEN3_TINY = TransformerConfig(
    vocab_size=512, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=32, intermediate_size=256, qk_norm=True, tie_word_embeddings=True,
)
