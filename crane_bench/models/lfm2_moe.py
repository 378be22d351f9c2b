"""LFM2-MoE (``model_type`` ``lfm2_moe``): the weights' names, shapes and
draws, the plain float32 reference, and the work a token needs.

The reference follows HF ``Lfm2MoeForCausalLM``
(``transformers/models/lfm2_moe/modeling_lfm2_moe.py``). Norms are RMSNorm
``x * rsqrt(mean x^2 + norm_eps) * w``, with no unit offset. Each layer is
``operator_norm`` -> mixer -> +res -> ``ffn_norm`` -> feed-forward -> +res.
The mixer of a ``full_attention`` layer is GQA attention: per-head
``q_layernorm`` / ``k_layernorm``, then RoPE over the whole head, then
``out_proj``. The mixer of a ``conv`` layer is the gated short conv:
``in_proj`` gives ``(B, C, x)``, then ``C * conv(B * x)``, a depthwise causal
conv of ``conv_L_cache`` taps with no bias and no activation, then
``out_proj``. The first ``num_dense_layers`` feed-forwards are SwiGLU
``w2(silu(w1 x) * w3 x)``. The rest are sparse MoE: ``sigmoid(gate x)``
scores, the top ``num_experts_per_tok`` chosen on ``scores + expert_bias``,
weighted by their unbiased scores, renormalised (``/ (sum + 1e-6)``) when
``norm_topk_prob``, times ``routed_scaling_factor``; no shared expert. The
final norm is ``embedding_norm``; the head is the embedding where tied.
It imports nothing of the program.

Departures and names the catalog does not confirm:

- the weights' names are HF's for this family (``feed_forward.experts.{e}.
  w1/w3/w2``, ``feed_forward.gate``, ``feed_forward.expert_bias``,
  ``operator_norm``, ``ffn_norm``, ``self_attn.out_proj``,
  ``self_attn.q_layernorm``, ``conv.in_proj``, ``conv.conv``,
  ``conv.out_proj``, ``model.embedding_norm``), from the LFM2 modeling
  code, not from a checkpoint's index;
- ``expert_bias`` is a trained buffer: here a normal draw of scale 0.1,
  made in the type the other weights are drawn in (bf16) and read in
  float32, so that the bias changes the choice on many tokens;
- the head is tied (``tie_word_embeddings`` is not in the published
  config; tied is the LFM2 family's default) and the head size is
  ``hidden_size / num_attention_heads``;
- RoPE's theta is read from ``rope_parameters`` where the config has no
  top-level ``rope_theta``;
- HF computes the router's sigmoid and top-k weights in the model's dtype;
  here they are float32, as everything else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crane_bench.models import plain

EXPERT_BIAS_SCALE = 0.1


def _attn_dims(hf: dict):
    H, Hkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    return H, Hkv, hf.get("head_dim") or hf["hidden_size"] // H


def _theta(hf: dict) -> float:
    return hf.get("rope_theta", (hf.get("rope_parameters") or {}).get("rope_theta", 10000.0))


def _is_attention(hf: dict, i: int) -> bool:
    return hf["layer_types"][i] == "full_attention"


def _is_dense(hf: dict, i: int) -> bool:
    return i < hf.get("num_dense_layers", 0)


def global_spec(hf: dict) -> list:
    E, V = hf["hidden_size"], hf["vocab_size"]
    spec = [("model.embed_tokens.weight", (V, E), ("normal", 0.02)),
            ("model.embedding_norm.weight", (E,), ("norm", 1.0))]
    if not hf.get("tie_word_embeddings", False):
        spec.append(("lm_head.weight", (V, E), ("normal", E ** -0.5)))
    return spec


def layer_spec(hf: dict, i: int) -> list:
    E = hf["hidden_size"]
    p = f"model.layers.{i}."
    spec = [(p + "operator_norm.weight", (E,), ("norm", 1.0))]
    if _is_attention(hf, i):
        H, Hkv, D = _attn_dims(hf)
        spec += [
            (p + "self_attn.q_proj.weight", (H * D, E), ("normal", E ** -0.5)),
            (p + "self_attn.k_proj.weight", (Hkv * D, E), ("normal", E ** -0.5)),
            (p + "self_attn.v_proj.weight", (Hkv * D, E), ("normal", E ** -0.5)),
            (p + "self_attn.out_proj.weight", (E, H * D), ("normal", (H * D) ** -0.5)),
            (p + "self_attn.q_layernorm.weight", (D,), ("norm", 1.0)),
            (p + "self_attn.k_layernorm.weight", (D,), ("norm", 1.0)),
        ]
    else:
        L = hf["conv_L_cache"]
        spec += [
            (p + "conv.in_proj.weight", (3 * E, E), ("normal", E ** -0.5)),
            (p + "conv.conv.weight", (E, 1, L), ("normal", L ** -0.5)),
            (p + "conv.out_proj.weight", (E, E), ("normal", E ** -0.5)),
        ]
    spec.append((p + "ffn_norm.weight", (E,), ("norm", 1.0)))
    f = p + "feed_forward."
    if _is_dense(hf, i):
        I = hf["intermediate_size"]
        return spec + [(f + "w1.weight", (I, E), ("normal", E ** -0.5)),
                       (f + "w3.weight", (I, E), ("normal", E ** -0.5)),
                       (f + "w2.weight", (E, I), ("normal", I ** -0.5))]
    n, I = hf["num_experts"], hf["moe_intermediate_size"]
    spec += [
        (f + "gate.weight", (n, E), ("normal", E ** -0.5)),
        (f + "experts.{e}.w1.weight", (n, I, E), ("normal", E ** -0.5)),
        (f + "experts.{e}.w3.weight", (n, I, E), ("normal", E ** -0.5)),
        (f + "experts.{e}.w2.weight", (n, E, I), ("normal", I ** -0.5)),
    ]
    if hf.get("use_expert_bias", False):
        spec.append((f + "expert_bias", (n,), ("normal", EXPERT_BIAS_SCALE)))
    return spec


def attention(hf: dict, p: str, w: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Self-attention of ``x [L, E]`` (already normed) at ``positions``."""
    H, Hkv, D = _attn_dims(hf)
    eps, L = hf["norm_eps"], x.shape[0]
    a = p + "self_attn."
    q = plain.linear(x, w[a + "q_proj.weight"]).reshape(L, H, D)
    k = plain.linear(x, w[a + "k_proj.weight"]).reshape(L, Hkv, D)
    v = plain.linear(x, w[a + "v_proj.weight"]).reshape(L, Hkv, D)
    q = plain.rope(plain.rms_norm(q, w[a + "q_layernorm.weight"], eps), positions, _theta(hf), D)
    k = plain.rope(plain.rms_norm(k, w[a + "k_layernorm.weight"], eps), positions, _theta(hf), D)
    out = plain.causal_attention(q, k, v, D ** -0.5).reshape(L, H * D)
    return plain.linear(out, w[a + "out_proj.weight"])


def short_conv(hf: dict, p: str, w: dict, x: torch.Tensor) -> torch.Tensor:
    """The gated short conv of ``x [L, E]`` (already normed), from zero
    state: ``out_proj(C * conv(B * x))``."""
    L, E = x.shape
    taps = hf["conv_L_cache"]
    b, c, xx = plain.linear(x, w[p + "conv.in_proj.weight"]).chunk(3, dim=-1)
    conv = F.conv1d((b * xx).T[None], plain.f32(w[p + "conv.conv.weight"]), padding=taps - 1,
                    groups=E)[0, :, :L].T
    return plain.linear(c * conv, w[p + "conv.out_proj.weight"])


def route(hf: dict, f: str, w: dict, x: torch.Tensor):
    """(weights, experts) ``[T, k]`` of ``x [T, E]`` (normed): the top k of
    ``sigmoid(gate x) + expert_bias``, weighted by the unbiased sigmoids."""
    scores = torch.sigmoid(plain.linear(x, w[f + "gate.weight"]))
    choice = scores + plain.f32(w[f + "expert_bias"]) if f + "expert_bias" in w else scores
    sel = torch.topk(choice, hf["num_experts_per_tok"], dim=-1).indices
    top = scores.gather(1, sel)
    if hf.get("norm_topk_prob", True):
        top = top / (top.sum(-1, keepdim=True) + 1e-6)
    return top * hf.get("routed_scaling_factor", 1.0), sel


def sparse_moe(hf: dict, f: str, w: dict, x: torch.Tensor, experts: dict) -> torch.Tensor:
    """The sparse-MoE feed-forward of ``x [T, E]`` (normed); ``experts``
    holds the layer's stacked expert weights in float32."""
    top, sel = route(hf, f, w, x)
    out = torch.zeros_like(x)
    for e in torch.unique(sel).tolist():
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        y = plain.swiglu(x[rows], experts["w1"][e], experts["w3"][e], experts["w2"][e])
        out.index_add_(0, rows, y * top[rows, slot, None])
    return out


def layers(hf: dict, i: int, w: dict, hs: list, positions: list) -> list:
    """Layer ``i`` over every sequence of ``hs``."""
    p, eps = f"model.layers.{i}.", hf["norm_eps"]
    xs = [plain.rms_norm(h, w[p + "operator_norm.weight"], eps) for h in hs]
    if _is_attention(hf, i):
        mixed = [attention(hf, p, w, x, pos) for x, pos in zip(xs, positions)]
    else:
        mixed = [short_conv(hf, p, w, x) for x in xs]
    # the feed-forward works token by token: every sequence's tokens go through at once
    h = torch.cat([h + m for h, m in zip(hs, mixed)])
    x = plain.rms_norm(h, w[p + "ffn_norm.weight"], eps)
    f = p + "feed_forward."
    if _is_dense(hf, i):
        h = h + plain.swiglu(x, w[f + "w1.weight"], w[f + "w3.weight"], w[f + "w2.weight"])
    else:
        experts = {name: plain.f32(w[f"{f}experts.{{e}}.{name}.weight"])
                   for name in ("w1", "w3", "w2")}
        h = h + sparse_moe(hf, f, w, x, experts)
        del experts
    return list(h.split([x.shape[0] for x in hs]))


def final_norm(hf: dict, w: dict, h: torch.Tensor) -> torch.Tensor:
    return plain.rms_norm(h, w["model.embedding_norm.weight"], hf["norm_eps"])


def head(hf: dict, w: dict) -> torch.Tensor:
    """The output projection ``[V, E]``."""
    return w["model.embed_tokens.weight" if hf.get("tie_word_embeddings") else "lm_head.weight"]


# -- the work a token needs, counted from the configuration -----------------

def attention_layers(hf: dict) -> list[tuple[int, int, int]]:
    """(query heads, key heads, head size) of each softmax-attention layer."""
    return [_attn_dims(hf)] * hf["layer_types"].count("full_attention")


def gdn_layers(hf: dict) -> list:
    return []


def body_flops(hf: dict) -> float:
    """FLOPs of one token through every layer, attention over the context
    excepted: twice the weights it multiplies (the attention and conv
    projections, a dense layer's MLP; in a MoE layer the router and its
    ``num_experts_per_tok`` experts, not the rest), plus a conv layer's taps
    (twice ``E * conv_L_cache``) and its two gating products (``E`` each)."""
    E, n, k = hf["hidden_size"], hf["num_experts"], hf["num_experts_per_tok"]
    H, Hkv, D = _attn_dims(hf)
    attn = 2.0 * (E * (H * D + 2 * Hkv * D) + H * D * E)
    conv = 2.0 * (3 * E * E + E * E + E * hf["conv_L_cache"]) + 2.0 * E
    dense = 2.0 * 3 * E * hf["intermediate_size"]
    moe = 2.0 * (E * n + 3 * E * hf["moe_intermediate_size"] * k)
    total = 0.0
    for i in range(hf["num_hidden_layers"]):
        total += attn if _is_attention(hf, i) else conv
        total += dense if _is_dense(hf, i) else moe
    return total


def head_flops(hf: dict) -> float:
    return 2.0 * hf["vocab_size"] * hf["hidden_size"]
