"""HF checkpoint loading for the dense decoder families, the hybrid
Gated-DeltaNet family with dense or sparse-MoE MLPs, and LFM2's short-conv
hybrids (port of ``crane_tpu/models/auto.py``).

``config.json`` is authoritative for the family. HF stores linear weights
``[out, in]``; the port stores ``[in, out]`` as the reference does, so the
forward is ``x @ w``. Checkpoints load through
:mod:`crane_tpu_torch.loaders.safetensors_loader`, which imports
``safetensors`` inside its functions: the machine with the card has none,
and it runs on random weights.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch
import torch.nn.functional as F

from crane_tpu_torch.loaders.safetensors_loader import load_state_dict
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.modules.gdn_layer import GdnConfig
from crane_tpu_torch.models.modules.transformer import MoeRouterConfig, TransformerConfig
from crane_tpu_torch.ops.linear import quantize_weight
from crane_tpu_torch.utils.device import default_device


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_hf_config(model_dir: str) -> dict:
    return read_json(os.path.join(model_dir, "config.json"))


def transformer_config_from_hf(hf: dict) -> TransformerConfig:
    """Map an HF config.json dict to a TransformerConfig: qwen2, qwen3,
    llama/mistral, ernie4_5, hunyuan_v1_dense, gemma3(_text), the short-conv
    hybrids lfm2 and lfm2_moe (a :class:`MoeRouterConfig`: sigmoid-routed
    experts) and the GDN hybrids qwen3_next / qwen3_5 (dense or MoE).

    As in the reference, lfm2 reads ``intermediate_size`` as it stands and
    ignores ``block_auto_adjust_ff_dim``: a checkpoint's MLP weights keep
    their own (adjusted) width through :func:`map_hf_weights`."""
    mt = hf.get("model_type", "llama")
    if mt == "gemma3" and "text_config" in hf:
        return transformer_config_from_hf({**hf["text_config"], "model_type": "gemma3_text"})
    hidden = hf["hidden_size"]
    heads = hf["num_attention_heads"]
    common: dict[str, Any] = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hidden // heads,
        intermediate_size=hf["intermediate_size"],
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    if mt == "qwen2":
        return TransformerConfig(attn_bias=True, qk_norm=False, **common)
    if mt == "qwen3":
        return TransformerConfig(attn_bias=False, qk_norm=True, **common)
    if mt in ("llama", "mistral"):
        rs = hf.get("rope_scaling") or {}
        llama3 = None
        if rs.get("rope_type", rs.get("type")) == "llama3":
            llama3 = (
                float(rs["factor"]),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)),
                int(rs.get("original_max_position_embeddings", 8192)),
            )
        return TransformerConfig(
            attn_bias=hf.get("attention_bias", False), qk_norm=False,
            rope_llama3=llama3, **common,
        )
    if mt == "ernie4_5":
        common["rms_norm_eps"] = hf.get("rms_norm_eps", 1e-5)
        common["rope_theta"] = hf.get("rope_theta", 500_000.0)
        return TransformerConfig(
            attn_bias=hf.get("use_bias", False), qk_norm=False,
            rope_mode="interleaved", **common,
        )
    if mt == "hunyuan_v1_dense":
        return TransformerConfig(
            attn_bias=hf.get("attention_bias", False),
            qk_norm=True, qk_norm_after_rope=True, **common,
        )
    if mt == "gemma3_text":
        rope_scaling = hf.get("rope_scaling") or {}
        common["rope_theta"] = hf.get("rope_theta", 1_000_000.0)
        return TransformerConfig(
            qk_norm=True,
            attn_bias=hf.get("attention_bias", False),
            norm_weight_offset=1.0,
            sandwich_norms=True,
            layer_types=tuple(
                "sliding" if t == "sliding_attention" else "full"
                for t in hf["layer_types"]
            ),
            sliding_window=hf.get("sliding_window", 4096),
            rope_local_theta=hf.get("rope_local_base_freq", 10000.0),
            rope_scaling_factor=float(rope_scaling.get("factor", 1.0)),
            query_scale=float(hf.get("query_pre_attn_scalar", hf.get("head_dim", 256))) ** -0.5,
            embed_scale=float(hf["hidden_size"]) ** 0.5,
            act="gelu_tanh",
            attn_logit_softcap=hf.get("attn_logit_softcapping"),
            logit_softcap=hf.get("final_logit_softcapping"),
            **common,
        )
    if mt in ("lfm2", "lfm2_moe"):
        # hybrid attention + short-conv layers; newer configs keep theta only
        # under rope_parameters
        common["rms_norm_eps"] = hf.get("norm_eps", 1e-5)
        common["rope_theta"] = hf.get(
            "rope_theta", (hf.get("rope_parameters") or {}).get("rope_theta", 10000.0))
        lfm2 = dict(
            qk_norm=True,
            layer_types=tuple(
                "conv" if t != "full_attention" else "full" for t in hf["layer_types"]
            ),
            conv_l_cache=hf.get("conv_L_cache", 3),
            conv_bias=hf.get("conv_bias", False),
            **common,
        )
        if mt == "lfm2":
            return TransformerConfig(**lfm2)
        # LFM2-MoE: the first num_dense_layers keep a dense MLP, the rest
        # route over num_experts (no shared expert) by sigmoid scores
        return MoeRouterConfig(
            num_experts=hf["num_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            norm_topk_prob=hf.get("norm_topk_prob", True),
            mlp_only_layers=tuple(range(hf.get("num_dense_layers", 0))),
            moe_router="sigmoid",
            routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
            **lfm2,
        )
    if mt in ("qwen3_next", "qwen3_5"):
        # hybrid GDN: unit-offset norms, 2x-wide gated q_proj, partial
        # rotary, 3-in-4 linear-attention layers, sparse-MoE MLPs where the
        # config has experts
        if hf.get("num_experts", 0):
            common.update(
                num_experts=hf["num_experts"],
                num_experts_per_tok=hf.get("num_experts_per_tok", 8),
                moe_intermediate_size=hf.get("moe_intermediate_size", 0),
                shared_expert_intermediate_size=hf.get("shared_expert_intermediate_size", 0),
                norm_topk_prob=hf.get("norm_topk_prob", True),
                decoder_sparse_step=hf.get("decoder_sparse_step", 1),
                mlp_only_layers=tuple(hf.get("mlp_only_layers", ())),
            )
        return TransformerConfig(
            attn_bias=hf.get("attention_bias", False),
            qk_norm=True,
            norm_weight_offset=1.0,
            attn_output_gate=True,
            partial_rotary_factor=hf.get("partial_rotary_factor", 0.25),
            layer_types=tuple(
                "gdn" if t == "linear_attention" else "full" for t in hf["layer_types"]
            ),
            gdn=GdnConfig(
                num_v_heads=hf["linear_num_value_heads"],
                num_k_heads=hf["linear_num_key_heads"],
                head_k_dim=hf["linear_key_head_dim"],
                head_v_dim=hf["linear_value_head_dim"],
                conv_kernel=hf.get("linear_conv_kernel_dim", 4),
            ),
            **common,
        )
    raise ValueError(f"unsupported model_type for dense causal LM: {mt!r}")


def _pick(sd: dict, *names: str):
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(names[0])


def _map_moe(cfg: TransformerConfig, sd: dict, lp: str, t, a) -> dict:
    """Layer ``lp``'s sparse-MoE MLP (qwen3_next's ``mlp.`` names, or
    lfm2_moe's ``feed_forward.`` ones with experts ``w1``/``w3``/``w2``):
    the router, the experts' gate/up/down stacked into
    ``[n_experts, in, out]``, the shared expert with its sigmoid gate where
    the checkpoint has one, and LFM2-MoE's ``expert_bias`` in float32. ``t``
    transposes one HF ``[out, in]`` weight onto the target device and
    dtype, ``a`` casts one; each stack is built there, one expert at a
    time."""
    if lp + "mlp.gate.weight" in sd:
        mp, names = lp + "mlp.", ("gate_proj", "up_proj", "down_proj")
    else:
        mp, names = lp + "feed_forward.", ("w1", "w3", "w2")

    def stack(name):
        first = t(sd[f"{mp}experts.0.{name}.weight"])
        out = first.new_empty((cfg.num_experts, *first.shape))
        out[0] = first
        for e in range(1, cfg.num_experts):
            out[e] = t(sd[f"{mp}experts.{e}.{name}.weight"])
        return out

    moe = {
        "router": t(sd[mp + "gate.weight"]),
        "experts_gate": stack(names[0]),
        "experts_up": stack(names[1]),
        "experts_down": stack(names[2]),
    }
    if mp + "expert_bias" in sd:
        moe["expert_bias"] = a(sd[mp + "expert_bias"], torch.float32)
    if lp + "mlp.shared_expert.gate_proj.weight" in sd:
        moe["shared_gate_proj"] = t(sd[lp + "mlp.shared_expert.gate_proj.weight"])
        moe["shared_up"] = t(sd[lp + "mlp.shared_expert.up_proj.weight"])
        moe["shared_down"] = t(sd[lp + "mlp.shared_expert.down_proj.weight"])
        moe["shared_gate"] = t(sd[lp + "mlp.shared_expert_gate.weight"])
    return moe


def map_hf_weights(cfg: TransformerConfig, sd: dict, dtype=torch.bfloat16,
                   device=None) -> dict:
    """Map an HF llama/qwen/lfm2-style state dict (name -> tensor) to the
    port's param tree: linear weights transposed to ``[in, out]``, MoE
    experts stacked (:func:`_map_moe`). A GDN or short-conv layer's conv
    weight ``[C, 1, k]`` becomes ``[C, k]`` float32, and a GDN layer's
    ``A_log`` and ``dt_bias`` and an LFM2-MoE layer's ``expert_bias`` stay
    float32."""

    def a(w, dt=dtype):
        return w.to(device=device, dtype=dt)

    def t(w):
        return w.T.contiguous().to(device=device, dtype=dtype)

    p = "model."
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}layers.{i}."
        if cfg.is_moe_layer(i):
            mlp = _map_moe(cfg, sd, lp, t, a)
        else:
            mlp = {
                "gate": t(_pick(sd, lp + "mlp.gate_proj.weight", lp + "feed_forward.w1.weight")),
                "up": t(_pick(sd, lp + "mlp.up_proj.weight", lp + "feed_forward.w3.weight")),
                "down": t(_pick(sd, lp + "mlp.down_proj.weight", lp + "feed_forward.w2.weight")),
            }
        if cfg.layer_type(i) == "conv":
            conv = {
                "in_proj": t(sd[lp + "conv.in_proj.weight"]),
                "out_proj": t(sd[lp + "conv.out_proj.weight"]),
                "conv_w": a(sd[lp + "conv.conv.weight"][:, 0, :], torch.float32),
            }
            if lp + "conv.conv.bias" in sd:
                conv["conv_b"] = a(sd[lp + "conv.conv.bias"])
            layers.append({
                "conv": conv,
                "mlp": mlp,
                "input_ln": a(_pick(sd, lp + "input_layernorm.weight",
                                    lp + "operator_norm.weight")),
                "post_ln": a(_pick(sd, lp + "post_attention_layernorm.weight",
                                   lp + "ffn_norm.weight")),
            })
            continue
        if cfg.layer_type(i) == "gdn":
            gp = lp + "linear_attn."
            layers.append({
                "gdn": {
                    "in_proj_qkvz": t(sd[gp + "in_proj_qkvz.weight"]),
                    "in_proj_ba": t(sd[gp + "in_proj_ba.weight"]),
                    "conv_w": a(sd[gp + "conv1d.weight"][:, 0, :], torch.float32),
                    "dt_bias": a(sd[gp + "dt_bias"], torch.float32),
                    "A_log": a(sd[gp + "A_log"], torch.float32),
                    "norm": a(sd[gp + "norm.weight"]),
                    "out_proj": t(sd[gp + "out_proj.weight"]),
                },
                "mlp": mlp,
                "input_ln": a(sd[lp + "input_layernorm.weight"]),
                "post_ln": a(sd[lp + "post_attention_layernorm.weight"]),
            })
            continue
        attn = {
            "wq": t(sd[lp + "self_attn.q_proj.weight"]),
            "wk": t(sd[lp + "self_attn.k_proj.weight"]),
            "wv": t(sd[lp + "self_attn.v_proj.weight"]),
            "wo": t(_pick(sd, lp + "self_attn.o_proj.weight", lp + "self_attn.out_proj.weight")),
        }
        if cfg.attn_bias:
            for nm, key in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                bias = sd.get(lp + f"self_attn.{key}.bias")
                if bias is not None:
                    attn[nm] = a(bias)
        if cfg.qk_norm:
            attn["q_norm"] = a(_pick(
                sd, lp + "self_attn.q_norm.weight",
                lp + "self_attn.query_layernorm.weight",  # hunyuan
                lp + "self_attn.q_layernorm.weight",  # lfm2
            ))
            attn["k_norm"] = a(_pick(
                sd, lp + "self_attn.k_norm.weight",
                lp + "self_attn.key_layernorm.weight",
                lp + "self_attn.k_layernorm.weight",
            ))
        layer = {
            "attn": attn,
            "mlp": mlp,
            "input_ln": a(_pick(sd, lp + "input_layernorm.weight", lp + "operator_norm.weight")),
        }
        if cfg.sandwich_norms:
            layer["post_attn_ln"] = a(sd[lp + "post_attention_layernorm.weight"])
            layer["pre_ffn_ln"] = a(sd[lp + "pre_feedforward_layernorm.weight"])
            layer["post_ffn_ln"] = a(sd[lp + "post_feedforward_layernorm.weight"])
        else:
            layer["post_ln"] = a(_pick(
                sd, lp + "post_attention_layernorm.weight", lp + "ffn_norm.weight"))
        layers.append(layer)
    params = {
        "embed": a(sd[p + "embed_tokens.weight"]),
        "layers": tuple(layers),
        "final_norm": a(_pick(sd, p + "norm.weight", p + "embedding_norm.weight")),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = t(sd["lm_head.weight"])
    return params


def read_eos_ids(model_dir: str) -> tuple[int, ...]:
    """Multi-id EOS from generation_config.json, falling back to config.json."""
    for fname in ("generation_config.json", "config.json"):
        path = os.path.join(model_dir, fname)
        if os.path.exists(path):
            eos = read_json(path).get("eos_token_id")
            if eos is None:
                continue
            return tuple(eos) if isinstance(eos, list) else (eos,)
    return ()


def from_pretrained(
    model_dir: str,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    tokenizer=None,
    quant_bits: int | None = None,
) -> CausalLM:
    """Load a causal LM (dense, GDN or short-conv hybrid) from an HF checkpoint
    directory or hub id onto ``device``: by default the card, and with no
    card an error unless ``device="cpu"`` is given. ``quant_bits`` 8 or 4
    quantizes its linear weights in situ (:func:`quantize_params`)."""
    from crane_tpu_torch.utils.hub import resolve_checkpoint

    device = default_device(device)
    model_dir = resolve_checkpoint(model_dir)
    cfg = transformer_config_from_hf(load_hf_config(model_dir))
    params = map_hf_weights(cfg, load_state_dict(model_dir), dtype, device)
    if quant_bits is not None:
        params = quantize_params(params, bits=quant_bits)
    if tokenizer is None:
        try:
            from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_dir)
        except (ImportError, OSError, ValueError):
            tokenizer = None  # token ids only: the engine streams no text
    return CausalLM(cfg, params, tokenizer=tokenizer,
                    eos_token_ids=read_eos_ids(model_dir), dtype=dtype)


# vocab columns of a quantized head are padded to a multiple of this, with
# zero columns, so its storage matches the reference's byte for byte
HEAD_PAD = 512
LINEAR_NAMES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def quantize_params(params: dict, *, bits: int = 8, block: int = 32,
                    quant_tied_head: bool | None = None) -> dict:
    """In-situ quantization (ISQ) of every linear weight of the layers, the
    reference's ``quantize_params``: per-channel int8 or packed int4 codes
    with float32 scales. Embeddings, norms and biases stay dense, and so do
    the ones the reference leaves dense: MoE routers, stacked experts and
    shared experts, and the GDN and short-conv projections (only the 2-D
    ``LINEAR_NAMES`` are quantized).

    A separate ``lm_head`` is quantized too. A tied head gets a quantized
    copy beside the dense embedding (which stays for the gathers) when
    ``quant_tied_head``: by default for int4 and not for int8, as in the
    reference, and ``CRANE_QUANT_TIED_HEAD=0/1`` overrides the default."""

    def q_layer(layer):
        out = {}
        for k, v in layer.items():
            if isinstance(v, dict):
                out[k] = q_layer(v)
            elif k in LINEAR_NAMES and v.ndim == 2:
                out[k] = quantize_weight(v, bits=bits, block=block)
            else:
                out[k] = v
        return out

    def q_head(w):
        return quantize_weight(F.pad(w, (0, (-w.shape[1]) % HEAD_PAD)), bits=bits, block=block)

    new = dict(params)
    new["layers"] = tuple(q_layer(layer) for layer in params["layers"])
    if quant_tied_head is None:
        env = os.environ.get("CRANE_QUANT_TIED_HEAD")
        quant_tied_head = (bits == 4) if env is None else env == "1"
    if "lm_head" in params:
        new["lm_head"] = q_head(params["lm_head"])
    elif quant_tied_head and "embed" in params:
        new["lm_head"] = q_head(params["embed"].T)
    return new
