"""Qwen3 (``model_type`` ``qwen3``): the weights' names, shapes and draws, the
plain float32 reference, and the work a token needs.

The reference follows HF ``Qwen3ForCausalLM``: pre-norm decoder layers of
GQA attention (per-head RMSNorm on q and k before full-width RoPE) and a
SwiGLU MLP, a final RMSNorm and the head (the embedding where it is tied).
It imports nothing of the program.
"""

from __future__ import annotations

import torch

from crane_bench.models import plain


def _dims(hf: dict):
    E, H, Hkv = hf["hidden_size"], hf["num_attention_heads"], hf["num_key_value_heads"]
    D = hf.get("head_dim") or E // H
    return E, H, Hkv, D, hf["intermediate_size"]


def global_spec(hf: dict) -> list:
    E, V = hf["hidden_size"], hf["vocab_size"]
    spec = [("model.embed_tokens.weight", (V, E), ("normal", 0.02)),
            ("model.norm.weight", (E,), ("norm", 1.0))]
    if not hf.get("tie_word_embeddings", False):
        spec.append(("lm_head.weight", (V, E), ("normal", E ** -0.5)))
    return spec


def layer_spec(hf: dict, i: int) -> list:
    E, H, Hkv, D, I = _dims(hf)
    p = f"model.layers.{i}."
    return [
        (p + "input_layernorm.weight", (E,), ("norm", 1.0)),
        (p + "self_attn.q_proj.weight", (H * D, E), ("normal", E ** -0.5)),
        (p + "self_attn.k_proj.weight", (Hkv * D, E), ("normal", E ** -0.5)),
        (p + "self_attn.v_proj.weight", (Hkv * D, E), ("normal", E ** -0.5)),
        (p + "self_attn.o_proj.weight", (E, H * D), ("normal", (H * D) ** -0.5)),
        (p + "self_attn.q_norm.weight", (D,), ("norm", 1.0)),
        (p + "self_attn.k_norm.weight", (D,), ("norm", 1.0)),
        (p + "post_attention_layernorm.weight", (E,), ("norm", 1.0)),
        (p + "mlp.gate_proj.weight", (I, E), ("normal", E ** -0.5)),
        (p + "mlp.up_proj.weight", (I, E), ("normal", E ** -0.5)),
        (p + "mlp.down_proj.weight", (E, I), ("normal", I ** -0.5)),
    ]


def attention(hf: dict, p: str, w: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Self-attention of ``x [L, E]`` (already normed) at ``positions``."""
    E, H, Hkv, D, _ = _dims(hf)
    eps, L = hf["rms_norm_eps"], x.shape[0]
    q = plain.linear(x, w[p + "self_attn.q_proj.weight"]).reshape(L, H, D)
    k = plain.linear(x, w[p + "self_attn.k_proj.weight"]).reshape(L, Hkv, D)
    v = plain.linear(x, w[p + "self_attn.v_proj.weight"]).reshape(L, Hkv, D)
    q = plain.rms_norm(q, w[p + "self_attn.q_norm.weight"], eps)
    k = plain.rms_norm(k, w[p + "self_attn.k_norm.weight"], eps)
    q = plain.rope(q, positions, hf["rope_theta"], D)
    k = plain.rope(k, positions, hf["rope_theta"], D)
    a = plain.causal_attention(q, k, v, D ** -0.5).reshape(L, H * D)
    return plain.linear(a, w[p + "self_attn.o_proj.weight"])


def layer(hf: dict, i: int, w: dict, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Decoder layer ``i`` on one sequence's hidden states ``h [L, E]``."""
    p, eps = f"model.layers.{i}.", hf["rms_norm_eps"]
    h = h + attention(hf, p, w, plain.rms_norm(h, w[p + "input_layernorm.weight"], eps), positions)
    x = plain.rms_norm(h, w[p + "post_attention_layernorm.weight"], eps)
    return h + plain.swiglu(x, w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"],
                            w[p + "mlp.down_proj.weight"])


def layers(hf: dict, i: int, w: dict, hs: list, positions: list) -> list:
    """Layer ``i`` over every sequence of ``hs``."""
    return [layer(hf, i, w, h, pos) for h, pos in zip(hs, positions)]


def final_norm(hf: dict, w: dict, h: torch.Tensor) -> torch.Tensor:
    return plain.rms_norm(h, w["model.norm.weight"], hf["rms_norm_eps"])


def head(hf: dict, w: dict) -> torch.Tensor:
    """The output projection ``[V, E]``."""
    return w["model.embed_tokens.weight" if hf.get("tie_word_embeddings") else "lm_head.weight"]


# -- the work a token needs, counted from the configuration -----------------

def attention_layers(hf: dict) -> list[tuple[int, int, int]]:
    """(query heads, key heads, head size) of each softmax-attention layer."""
    _, H, Hkv, D, _ = _dims(hf)
    return [(H, Hkv, D)] * hf["num_hidden_layers"]


def gdn_layers(hf: dict) -> list:
    return []


def body_flops(hf: dict) -> float:
    """FLOPs of one token through every layer's products, attention over
    the context excepted: twice the weights a token multiplies."""
    E, H, Hkv, D, I = _dims(hf)
    per_layer = E * (H * D + 2 * Hkv * D) + H * D * E + 3 * E * I
    return 2.0 * per_layer * hf["num_hidden_layers"]


def head_flops(hf: dict) -> float:
    return 2.0 * hf["vocab_size"] * hf["hidden_size"]
