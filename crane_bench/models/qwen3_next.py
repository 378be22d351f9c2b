"""Qwen3-Next (``model_type`` ``qwen3_next``): the weights' names, shapes and
draws, the plain float32 reference, and the work a token needs.

The reference follows HF ``Qwen3NextForCausalLM``. Norms are RMSNorm times
``1 + w``. A ``full_attention`` layer is gated attention: q_proj gives each
head ``[query | gate]``, q and k get a per-head norm, RoPE turns the first
``partial_rotary_factor`` of each head, and the output is multiplied by
``sigmoid(gate)`` before o_proj. A ``linear_attention`` layer is a Gated
DeltaNet: in_proj_qkvz and in_proj_ba in k-head-grouped order, a causal
depthwise conv (SiLU) over ``[q | k | v]``, L2-normed q and k (q scaled by
``K ** -0.5``), ``beta = sigmoid(b)``, ``g = -exp(A_log) softplus(a +
dt_bias)``, the delta rule step by step, then RMSNorm(y) * w * silu(z) and
out_proj. Every MLP is the sparse MoE: a softmax router over all experts,
the top ``num_experts_per_tok`` renormalised, each chosen expert's SwiGLU
weighted, plus the shared expert gated by ``sigmoid(shared_expert_gate)``.
It imports nothing of the program. The model's multi-token-prediction head
is not run (the port has none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crane_bench.models import plain


def layer_types(hf: dict) -> list[str]:
    if "layer_types" in hf:
        return list(hf["layer_types"])
    n = hf["full_attention_interval"]
    return ["full_attention" if (i + 1) % n == 0 else "linear_attention"
            for i in range(hf["num_hidden_layers"])]


def _attn_dims(hf: dict):
    return hf["num_attention_heads"], hf["num_key_value_heads"], hf["head_dim"]


def _gdn_dims(hf: dict):
    return (hf["linear_num_key_heads"], hf["linear_num_value_heads"],
            hf["linear_key_head_dim"], hf["linear_value_head_dim"], hf["linear_conv_kernel_dim"])


def global_spec(hf: dict) -> list:
    E, V = hf["hidden_size"], hf["vocab_size"]
    spec = [("model.embed_tokens.weight", (V, E), ("normal", 0.02)),
            ("model.norm.weight", (E,), ("norm", 0.0))]
    if not hf.get("tie_word_embeddings", False):
        spec.append(("lm_head.weight", (V, E), ("normal", E ** -0.5)))
    return spec


def layer_spec(hf: dict, i: int) -> list:
    E = hf["hidden_size"]
    p = f"model.layers.{i}."
    spec = [(p + "input_layernorm.weight", (E,), ("norm", 0.0))]
    if layer_types(hf)[i] == "full_attention":
        H, Hkv, D = _attn_dims(hf)
        spec += [
            (p + "self_attn.q_proj.weight", (2 * H * D, E), ("normal", E ** -0.5)),
            (p + "self_attn.k_proj.weight", (Hkv * D, E), ("normal", E ** -0.5)),
            (p + "self_attn.v_proj.weight", (Hkv * D, E), ("normal", E ** -0.5)),
            (p + "self_attn.o_proj.weight", (E, H * D), ("normal", (H * D) ** -0.5)),
            (p + "self_attn.q_norm.weight", (D,), ("norm", 0.0)),
            (p + "self_attn.k_norm.weight", (D,), ("norm", 0.0)),
        ]
    else:
        Hk, Hv, K, V, ck = _gdn_dims(hf)
        g = p + "linear_attn."
        conv = 2 * Hk * K + Hv * V
        spec += [
            (g + "in_proj_qkvz.weight", (2 * Hk * K + 2 * Hv * V, E), ("normal", E ** -0.5)),
            (g + "in_proj_ba.weight", (2 * Hv, E), ("normal", E ** -0.5)),
            (g + "conv1d.weight", (conv, 1, ck), ("normal", ck ** -0.5)),
            (g + "dt_bias", (Hv,), ("norm", 1.0)),
            (g + "A_log", (Hv,), ("alog",)),
            (g + "norm.weight", (V,), ("norm", 1.0)),
            (g + "out_proj.weight", (E, Hv * V), ("normal", (Hv * V) ** -0.5)),
        ]
    n, I, Is = hf["num_experts"], hf["moe_intermediate_size"], hf["shared_expert_intermediate_size"]
    m = p + "mlp."
    spec += [
        (p + "post_attention_layernorm.weight", (E,), ("norm", 0.0)),
        (m + "gate.weight", (n, E), ("normal", E ** -0.5)),
        (m + "experts.{e}.gate_proj.weight", (n, I, E), ("normal", E ** -0.5)),
        (m + "experts.{e}.up_proj.weight", (n, I, E), ("normal", E ** -0.5)),
        (m + "experts.{e}.down_proj.weight", (n, E, I), ("normal", I ** -0.5)),
        (m + "shared_expert.gate_proj.weight", (Is, E), ("normal", E ** -0.5)),
        (m + "shared_expert.up_proj.weight", (Is, E), ("normal", E ** -0.5)),
        (m + "shared_expert.down_proj.weight", (E, Is), ("normal", Is ** -0.5)),
        (m + "shared_expert_gate.weight", (1, E), ("normal", E ** -0.5)),
    ]
    return spec


def gated_attention(hf: dict, p: str, w: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    H, Hkv, D = _attn_dims(hf)
    eps, L = hf["rms_norm_eps"], x.shape[0]
    qg = plain.linear(x, w[p + "self_attn.q_proj.weight"]).reshape(L, H, 2 * D)
    q, gate = qg[..., :D], qg[..., D:]
    k = plain.linear(x, w[p + "self_attn.k_proj.weight"]).reshape(L, Hkv, D)
    v = plain.linear(x, w[p + "self_attn.v_proj.weight"]).reshape(L, Hkv, D)
    q = plain.rms_norm(q, w[p + "self_attn.q_norm.weight"], eps, 1.0)
    k = plain.rms_norm(k, w[p + "self_attn.k_norm.weight"], eps, 1.0)
    rot = int(D * hf["partial_rotary_factor"])
    q = plain.rope(q, positions, hf["rope_theta"], rot)
    k = plain.rope(k, positions, hf["rope_theta"], rot)
    a = plain.causal_attention(q, k, v, D ** -0.5) * torch.sigmoid(gate)
    return plain.linear(a.reshape(L, H * D), w[p + "self_attn.o_proj.weight"])


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def gated_deltanet(hf: dict, p: str, w: dict, xs: list) -> list:
    """The GDN mixer over every sequence of ``xs`` (each ``[L, E]``, normed);
    the recurrence runs step by step over all of them at once, a sequence's
    steps past its end holding its state (decay 1, beta 0)."""
    Hk, Hv, K, V, ck = _gdn_dims(hf)
    g = p + "linear_attn."
    vg = Hv // Hk
    conv_w = plain.f32(w[g + "conv1d.weight"])
    qs, ks, vs, zs, betas, gs = [], [], [], [], [], []
    for x in xs:
        L = x.shape[0]
        qkvz = plain.linear(x, w[g + "in_proj_qkvz.weight"]).reshape(L, Hk, 2 * K + 2 * vg * V)
        ba = plain.linear(x, w[g + "in_proj_ba.weight"]).reshape(L, Hk, 2 * vg)
        q, k = qkvz[..., :K], qkvz[..., K:2 * K]
        v = qkvz[..., 2 * K:2 * K + vg * V].reshape(L, Hv, V)
        z = qkvz[..., 2 * K + vg * V:].reshape(L, Hv, V)
        b, a = ba[..., :vg].reshape(L, Hv), ba[..., vg:].reshape(L, Hv)
        mixed = torch.cat([q.reshape(L, -1), k.reshape(L, -1), v.reshape(L, -1)], -1)
        mixed = F.silu(F.conv1d(mixed.T[None], conv_w, padding=ck - 1,
                                groups=mixed.shape[1])[0, :, :L].T)
        q = mixed[:, :Hk * K].reshape(L, Hk, K).repeat_interleave(vg, dim=1)
        k = mixed[:, Hk * K:2 * Hk * K].reshape(L, Hk, K).repeat_interleave(vg, dim=1)
        v = mixed[:, 2 * Hk * K:].reshape(L, Hv, V)
        qs.append(_l2norm(q) * K ** -0.5)
        ks.append(_l2norm(k))
        vs.append(v)
        zs.append(z)
        betas.append(torch.sigmoid(b))
        gs.append(-torch.exp(plain.f32(w[g + "A_log"])) * F.softplus(a + plain.f32(w[g + "dt_bias"])))
    n, T = len(xs), max(x.shape[0] for x in xs)

    def pad(ts):
        out = ts[0].new_zeros((n, T, *ts[0].shape[1:]))
        for j, t in enumerate(ts):
            out[j, :t.shape[0]] = t
        return out

    q, k, v, beta, gdecay = pad(qs), pad(ks), pad(vs), pad(betas), pad(gs)
    state = q.new_zeros((n, Hv, K, V))
    ys = q.new_empty((n, T, Hv, V))
    for t in range(T):
        state = state * torch.exp(gdecay[:, t])[..., None, None]
        kv = torch.einsum("bhk,bhkv->bhv", k[:, t], state)
        delta = (v[:, t] - kv) * beta[:, t, :, None]
        state = state + k[:, t, :, :, None] * delta[:, :, None, :]
        ys[:, t] = torch.einsum("bhk,bhkv->bhv", q[:, t], state)
    out = []
    for j, x in enumerate(xs):
        L = x.shape[0]
        y = plain.rms_norm(ys[j, :L], w[g + "norm.weight"], hf["rms_norm_eps"]) * F.silu(zs[j])
        out.append(plain.linear(y.reshape(L, Hv * V), w[g + "out_proj.weight"]))
    return out


def sparse_moe(hf: dict, p: str, w: dict, x: torch.Tensor, experts: dict) -> torch.Tensor:
    """The sparse-MoE MLP of ``x [L, E]`` (normed); ``experts`` holds the
    layer's stacked expert weights in float32."""
    m = p + "mlp."
    probs = torch.softmax(plain.linear(x, w[m + "gate.weight"]), -1)
    top, sel = torch.topk(probs, hf["num_experts_per_tok"], -1)
    if hf["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in torch.unique(sel).tolist():
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        y = plain.swiglu(x[rows], experts["gate"][e], experts["up"][e], experts["down"][e])
        out.index_add_(0, rows, y * top[rows, slot, None])
    shared = plain.swiglu(x, w[m + "shared_expert.gate_proj.weight"],
                          w[m + "shared_expert.up_proj.weight"],
                          w[m + "shared_expert.down_proj.weight"])
    return out + torch.sigmoid(plain.linear(x, w[m + "shared_expert_gate.weight"])) * shared


def layers(hf: dict, i: int, w: dict, hs: list, positions: list) -> list:
    """Layer ``i`` over every sequence of ``hs``."""
    p, eps = f"model.layers.{i}.", hf["rms_norm_eps"]
    xs = [plain.rms_norm(h, w[p + "input_layernorm.weight"], eps, 1.0) for h in hs]
    if layer_types(hf)[i] == "full_attention":
        mixed = [gated_attention(hf, p, w, x, pos) for x, pos in zip(xs, positions)]
    else:
        mixed = gated_deltanet(hf, p, w, xs)
    hs = [h + a for h, a in zip(hs, mixed)]
    experts = {name: plain.f32(w[f"{p}mlp.experts.{{e}}.{name}_proj.weight"])
               for name in ("gate", "up", "down")}
    # the MLP works token by token: every sequence's tokens go through at once
    h = torch.cat(hs)
    h = h + sparse_moe(hf, p, w, plain.rms_norm(h, w[p + "post_attention_layernorm.weight"],
                                                 eps, 1.0), experts)
    del experts
    return list(h.split([x.shape[0] for x in hs]))


def final_norm(hf: dict, w: dict, h: torch.Tensor) -> torch.Tensor:
    return plain.rms_norm(h, w["model.norm.weight"], hf["rms_norm_eps"], 1.0)


def head(hf: dict, w: dict) -> torch.Tensor:
    return w["model.embed_tokens.weight" if hf.get("tie_word_embeddings") else "lm_head.weight"]


# -- the work a token needs, counted from the configuration -----------------

def attention_layers(hf: dict) -> list[tuple[int, int, int]]:
    """(query heads, key heads, head size) of each softmax-attention layer."""
    return [_attn_dims(hf)] * layer_types(hf).count("full_attention")


def gdn_layers(hf: dict) -> list[tuple[int, int, int, int]]:
    """(key heads, value heads, key size, value size) of each GDN layer."""
    Hk, Hv, K, V, _ = _gdn_dims(hf)
    return [(Hk, Hv, K, V)] * layer_types(hf).count("linear_attention")


def body_flops(hf: dict) -> float:
    """FLOPs of one token through every layer, attention over the context
    excepted: twice the weights it multiplies (the router, its
    ``num_experts_per_tok`` experts and the shared expert, not the rest),
    plus the conv and the delta rule's three state products in a GDN
    layer."""
    E = hf["hidden_size"]
    H, Hkv, D = _attn_dims(hf)
    Hk, Hv, K, V, ck = _gdn_dims(hf)
    n, top = hf["num_experts"], hf["num_experts_per_tok"]
    I, Is = hf["moe_intermediate_size"], hf["shared_expert_intermediate_size"]
    mlp = 2.0 * (E * n + 3 * E * I * top + 3 * E * Is + E)
    attn = 2.0 * (E * (2 * H * D + 2 * Hkv * D) + H * D * E)
    conv = 2 * Hk * K + Hv * V
    gdn = 2.0 * (E * (2 * Hk * K + 2 * Hv * V + 2 * Hv) + Hv * V * E + conv * ck) + 6.0 * Hv * K * V
    types = layer_types(hf)
    return (mlp * len(types) + attn * types.count("full_attention")
            + gdn * types.count("linear_attention"))


def head_flops(hf: dict) -> float:
    return 2.0 * hf["vocab_size"] * hf["hidden_size"]
