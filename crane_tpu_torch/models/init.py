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
    zero biases, in the tree :func:`~crane_tpu_torch.models.auto.map_hf_weights`
    builds. An attention layer is the reference's; a GDN layer (``A_log``
    and ``dt_bias`` drawn as :func:`hf_state_dict` draws them, conv weight
    float32), a short-conv layer and a sparse-MoE MLP (router, experts
    stacked ``[n_experts, in, out]``, the shared expert and its gate) are
    drawn in place, so a full-width MoE model never exists in the HF layout.
    With ``attn_output_gate`` the q projection carries ``[query | gate]``
    per head and is twice as wide. A norm weight is stored as 0 where
    ``norm_weight_offset`` makes it ``1 + w``. Drawn in float32 on the
    generator's device, then cast and moved to ``device``: by default the
    card, and with no card an error unless ``device="cpu"`` is given."""
    device = default_device(device)
    gen_device = generator.device

    def nrm(shape, scale, dt=dtype):
        w = torch.randn(shape, generator=generator, device=gen_device, dtype=torch.float32)
        return (w * scale).to(device=device, dtype=dt)

    def ones(n, dt=dtype, value=1.0):
        return torch.full((n,), value, device=device, dtype=dt)

    def norm(n):
        return ones(n, value=1.0 - cfg.norm_weight_offset)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    E, D = cfg.hidden_size, cfg.head_dim
    H, Hkv, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    s = E ** -0.5
    q_out = H * D * (2 if cfg.attn_output_gate else 1)

    def attention():
        attn = {
            "wq": nrm((E, q_out), s),
            "wk": nrm((E, Hkv * D), s),
            "wv": nrm((E, Hkv * D), s),
            "wo": nrm((H * D, E), (H * D) ** -0.5),
        }
        if cfg.qk_norm:
            attn["q_norm"] = norm(D)
            attn["k_norm"] = norm(D)
        if cfg.attn_bias:
            attn["bq"], attn["bk"], attn["bv"] = zeros(q_out), zeros(Hkv * D), zeros(Hkv * D)
        return attn

    def gdn():
        g = cfg.gdn
        a = torch.rand((g.num_v_heads,), generator=generator, device=gen_device) * 16
        return {
            "in_proj_qkvz": nrm((E, 2 * g.key_dim + 2 * g.value_dim), s),
            "in_proj_ba": nrm((E, 2 * g.num_v_heads), s),
            "conv_w": nrm((g.conv_dim, g.conv_kernel), g.conv_kernel ** -0.5, torch.float32),
            "dt_bias": ones(g.num_v_heads, torch.float32),
            "A_log": torch.log(a.clamp(min=1e-4)).to(device),
            "norm": ones(g.head_v_dim),
            "out_proj": nrm((g.value_dim, E), g.value_dim ** -0.5),
        }

    def short_conv():
        conv = {
            "in_proj": nrm((E, 3 * E), s),
            "out_proj": nrm((E, E), s),
            "conv_w": nrm((E, cfg.conv_l_cache), cfg.conv_l_cache ** -0.5, torch.float32),
        }
        if cfg.conv_bias:
            conv["conv_b"] = zeros(E)
        return conv

    def moe():
        n, Im, Is = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
        mlp = {
            "router": nrm((E, n), s),
            "experts_gate": nrm((n, E, Im), s),
            "experts_up": nrm((n, E, Im), s),
            "experts_down": nrm((n, Im, E), Im ** -0.5),
        }
        if Is:
            mlp.update(shared_gate_proj=nrm((E, Is), s), shared_up=nrm((E, Is), s),
                       shared_down=nrm((Is, E), Is ** -0.5), shared_gate=nrm((E, 1), s))
        return mlp

    layers = []
    for i in range(cfg.num_layers):
        ltype = cfg.layer_type(i)
        if ltype == "gdn":
            layer = {"gdn": gdn()}
        elif ltype == "conv":
            layer = {"conv": short_conv()}
        else:
            layer = {"attn": attention()}
        layer["mlp"] = moe() if cfg.is_moe_layer(i) else {
            "gate": nrm((E, I), s),
            "up": nrm((E, I), s),
            "down": nrm((I, E), I ** -0.5),
        }
        layer["input_ln"] = norm(E)
        layer["post_ln"] = norm(E)
        layers.append(layer)
    params = {
        "embed": nrm((cfg.vocab_size, E), 0.02),
        "layers": tuple(layers),
        "final_norm": norm(E),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm((E, cfg.vocab_size), s)
    return params


def hf_state_dict(cfg: TransformerConfig, generator: torch.Generator,
                  dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """A random checkpoint in the HF layout (``[out, in]`` linears; the
    Qwen3-Next names for GDN layers and MoE MLPs, one tensor per expert;
    LFM2's names, ``operator_norm``, ``ffn_norm``, ``feed_forward.w1/w2/w3``,
    ``conv.*``, ``self_attn.out_proj``, ``q/k_layernorm`` and
    ``embedding_norm``, for a model with short-conv layers), for
    ``map_hf_weights``: normal weights with :func:`init_params`' scales,
    unit norm weights (zero where ``norm_weight_offset`` makes them
    ``1 + w``), and each GDN layer's ``A_log`` and ``dt_bias`` drawn as HF
    initializes them (``A = U(0, 16)``, ``A_log = log A``; ``dt_bias = 1``),
    so the recurrent state stays bounded. Tensors stay on the generator's
    device."""
    dev = generator.device
    E, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    lfm2 = cfg.layer_types is not None and "conv" in cfg.layer_types

    def lin(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=generator, device=dev)
        return (w * in_f ** -0.5).to(dtype)

    def norm(n):
        return torch.full((n,), 1.0 - cfg.norm_weight_offset, dtype=dtype, device=dev)

    def conv1d(channels, k):
        w = torch.randn((channels, 1, k), generator=generator, device=dev)
        return (w * k ** -0.5).to(dtype)

    sd = {"model.embed_tokens.weight":
          (torch.randn((cfg.vocab_size, E), generator=generator, device=dev) * 0.02).to(dtype),
          "model.embedding_norm.weight" if lfm2 else "model.norm.weight": norm(E)}
    for i in range(cfg.num_layers):
        lp = f"model.layers.{i}."
        if lfm2:
            sd.update({lp + "operator_norm.weight": norm(E), lp + "ffn_norm.weight": norm(E),
                       lp + "feed_forward.w1.weight": lin(I, E),
                       lp + "feed_forward.w3.weight": lin(I, E),
                       lp + "feed_forward.w2.weight": lin(E, I)})
        else:
            sd.update({lp + "input_layernorm.weight": norm(E),
                       lp + "post_attention_layernorm.weight": norm(E)})
        if cfg.is_moe_layer(i):
            Im, Is = cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
            sd[lp + "mlp.gate.weight"] = lin(cfg.num_experts, E)
            for e in range(cfg.num_experts):
                ep = f"{lp}mlp.experts.{e}."
                sd.update({ep + "gate_proj.weight": lin(Im, E), ep + "up_proj.weight": lin(Im, E),
                           ep + "down_proj.weight": lin(E, Im)})
            if Is:
                sp = lp + "mlp.shared_expert."
                sd.update({sp + "gate_proj.weight": lin(Is, E), sp + "up_proj.weight": lin(Is, E),
                           sp + "down_proj.weight": lin(E, Is),
                           lp + "mlp.shared_expert_gate.weight": lin(1, E)})
        elif not lfm2:
            sd.update({lp + "mlp.gate_proj.weight": lin(I, E),
                       lp + "mlp.up_proj.weight": lin(I, E),
                       lp + "mlp.down_proj.weight": lin(E, I)})
        if cfg.layer_type(i) == "conv":
            sd.update({lp + "conv.in_proj.weight": lin(3 * E, E),
                       lp + "conv.conv.weight": conv1d(E, cfg.conv_l_cache),
                       lp + "conv.out_proj.weight": lin(E, E)})
            if cfg.conv_bias:
                sd[lp + "conv.conv.bias"] = torch.zeros((E,), dtype=dtype, device=dev)
            continue
        if cfg.layer_type(i) == "gdn":
            g, gp = cfg.gdn, lp + "linear_attn."
            n_v = g.num_v_heads
            a = torch.rand((n_v,), generator=generator, device=dev) * 16
            conv = conv1d(g.conv_dim, g.conv_kernel)
            sd.update({
                gp + "in_proj_qkvz.weight": lin(2 * g.key_dim + 2 * g.value_dim, E),
                gp + "in_proj_ba.weight": lin(2 * n_v, E),
                gp + "conv1d.weight": conv,
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
                   lp + ("self_attn.out_proj.weight" if lfm2 else "self_attn.o_proj.weight"):
                       lin(E, H * D)})
        if cfg.qk_norm:
            names = ("q_layernorm", "k_layernorm") if lfm2 else ("q_norm", "k_norm")
            for name in names:
                sd[f"{lp}self_attn.{name}.weight"] = norm(D)
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
