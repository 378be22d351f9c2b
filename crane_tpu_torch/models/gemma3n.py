"""Gemma3n text model (the reference's "Gemma4" family).

Port of ``crane_tpu/models/gemma3n.py``. Reference behavior (crane-core
``src/models/gemma4/modeling.rs``): the Gemma3n decoder wraps each
transformer layer in AltUp (four stacked hidden streams with a learned
predict/correct router), adds a Laurel low-rank residual branch, gates
Per-Layer-Embedding (PLE) inputs into the non-active streams, shares the KV
cache of the last non-shared layer of each attention type across the final
``num_kv_shared_layers`` layers, applies RMS value-norm (no scale) and unit
attention scaling, uses per-layer MLP widths with gaussian-top-k activation
sparsity, and softcaps final logits.

The whole stack is one function over the reference's parameter tree, with
torch tensors as leaves; the four AltUp streams live in one ``[4, B, S, E]``
tensor. KV sharing: shared layers read the source layer's cache buffer
and never write; the cache holds the owning layers only.

Attention: a prefill attends the cache buffers through the plain
:func:`~crane_tpu_torch.ops.attention.gqa_attention`, as crane_tpu's is
plain XLA there. A decode step (S == 1) goes to K1,
:func:`~crane_tpu_torch.ops.cuda.decode_attention.fp_decode_attention`, with
scale 1.0, the layer's window and, on a shared layer, the source layer's
buffer at its live length, as crane_tpu's Pallas route does; heads the
kernel does not take go to its plain version by shape
(:func:`~crane_tpu_torch.models.modules.transformer.attention_route`).
:class:`Gemma3nLM` runs the decode step as one CUDA-graph replay a token on
the card (:mod:`crane_tpu_torch.models.graphs`), the counterpart of the
jitted ``decode_step``.

The per-layer embedding table has ``vocab_size_per_layer_input`` rows,
fewer than the vocabulary (262144 of 262400 in Gemma 3n). crane_tpu's
gather clamps an id past the table to its last row (JAX clamps an
out-of-range gather); the port clamps it explicitly, on the device, so the
id never reaches an out-of-range index (a device-side assert on the card).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.causal_lm import prompt_ids_error
from crane_tpu_torch.models.modules.transformer import attention_route
from crane_tpu_torch.ops.attention import gqa_attention
from crane_tpu_torch.ops.cuda.decode_attention import (
    fp_decode_attention,
    fp_decode_attention_plain,
)
from crane_tpu_torch.ops.cuda.quant_matmul import matmul_f32
from crane_tpu_torch.ops.kv_cache import KVCache, LayerKVCache
from crane_tpu_torch.ops.norm import rms_norm
from crane_tpu_torch.ops.rope import apply_rope, rope_table
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class Gemma3nConfig:
    vocab_size: int
    vocab_size_per_layer_input: int
    hidden_size: int
    hidden_size_per_layer_input: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: tuple  # per-layer widths
    activation_sparsity: tuple  # per-layer target sparsity (0.0 = dense)
    layer_types: tuple  # "sliding_attention" | "full_attention"
    sliding_window: int = 512
    num_kv_shared_layers: int = 0
    rope_theta: float = 1_000_000.0
    rope_local_theta: float = 10_000.0
    rms_eps: float = 1e-6
    altup_num_inputs: int = 4
    altup_active_idx: int = 0
    altup_correct_scale: bool = True
    final_logit_softcapping: float | None = 30.0
    max_position_embeddings: int = 32768

    @property
    def first_shared_layer(self) -> int:
        """Layers >= this index reuse another layer's KV (own no cache)."""
        if self.num_kv_shared_layers <= 0:
            return self.num_layers
        return self.num_layers - self.num_kv_shared_layers

    def kv_source(self, layer_idx: int) -> int:
        """Cache index this layer attends over: itself if it owns a cache,
        else the last non-shared layer of the same attention type."""
        fs = self.first_shared_layer
        if layer_idx < fs:
            return layer_idx
        t = self.layer_types[layer_idx]
        return max(i for i in range(fs) if self.layer_types[i] == t)


def make_gemma3n_cache(cfg: Gemma3nConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16, device=None) -> KVCache:
    """KV buffers for cache-owning layers only (shared layers read, not
    write); ``lengths`` is kept for the graph key and never read here."""
    layers = tuple(LayerKVCache.empty(batch, max_seq, cfg.num_kv_heads, cfg.head_dim, dtype,
                                      device) for _ in range(cfg.first_shared_layer))
    return KVCache(layers=layers, lengths=torch.zeros((batch,), dtype=torch.int32,
                                                      device=device))


def make_gemma3n_rope(cfg: Gemma3nConfig, device=None) -> dict:
    cg, sg = rope_table(cfg.head_dim, cfg.max_position_embeddings, theta=cfg.rope_theta,
                        device=device)
    cl, sl = rope_table(cfg.head_dim, cfg.max_position_embeddings,
                        theta=cfg.rope_local_theta, device=device)
    return {"cos": cg, "sin": sg, "local_cos": cl, "local_sin": sl}


def _rms_only(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Scale-free RMS norm (Gemma3n v_norm: with_scale=False)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype first, as ``jnp.asarray(value,
    dtype)`` rounds it in the reference (a fill kernel, no host copy, so a
    CUDA graph captures it)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _router_modalities(cfg: Gemma3nConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """AltUp modality router: tanh(route(rms(x) / E)), the tanh in float32."""
    r = rms_norm(x, p["router_norm"], eps=cfg.rms_eps) * (1.0 / cfg.hidden_size)
    return torch.tanh((r @ p["modality_router"]).float()).to(x.dtype)


def altup_predict(cfg: Gemma3nConfig, p: dict, hs: torch.Tensor) -> torch.Tensor:
    """hs ``[A, B, S, E]`` -> mixed predictions ``[A, B, S, E]``: per token,
    a 4x4 mixing matrix from the active stream's modalities is applied
    across the stacked streams (plus identity). HF permutes the matrix's last
    two dims before its product, hence the transposed einsum."""
    A = cfg.altup_num_inputs
    mod = _router_modalities(cfg, p, hs[cfg.altup_active_idx])  # [B, S, A]
    coefs = (mod @ p["prediction_coefs"]).reshape(*mod.shape[:-1], A, A)
    return torch.einsum("ubse,bsvu->vbse", hs, coefs) + hs


def altup_correct(cfg: Gemma3nConfig, p: dict, preds: torch.Tensor,
                  activated: torch.Tensor) -> torch.Tensor:
    """Propagate the layer output (activated) back into all streams."""
    mod = _router_modalities(cfg, p, activated)  # [B, S, A]
    coefs = mod @ p["correction_coefs"] + 1.0
    innovation = activated - preds[cfg.altup_active_idx]
    return innovation[None] * coefs.permute(2, 0, 1)[..., None] + preds


def _laurel(cfg: Gemma3nConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["left"] @ p["right"]
    return x + rms_norm(h, p["post_norm"], eps=cfg.rms_eps)


@functools.lru_cache(maxsize=None)
def _std_multiplier(sparsity: float) -> float:
    """Phi^-1(sparsity), the standard normal's quantile."""
    return statistics.NormalDist().inv_cdf(sparsity)


def _mlp(cfg: Gemma3nConfig, p: dict, x: torch.Tensor, layer_idx: int) -> torch.Tensor:
    gate = x @ p["gate"]
    sparsity = cfg.activation_sparsity[layer_idx]
    if sparsity > 0.0:
        # gaussian top-k: keep activations above mean + std * Phi^-1(sparsity);
        # jnp.std is the population std (correction 0), both in float32 as
        # jnp's reductions upcast a bf16 input
        gf = gate.float()
        mean = gf.mean(dim=-1, keepdim=True).to(gate.dtype)
        std = gf.std(dim=-1, keepdim=True, correction=0).to(gate.dtype)
        gate = F.relu(gate - (mean + std * _std_multiplier(sparsity)))
    return (F.gelu(gate, approximate="tanh") * (x @ p["up"])) @ p["down"]


def _attention(
    cfg: Gemma3nConfig,
    p: dict,
    x: torch.Tensor,
    cache: KVCache,
    positions: torch.Tensor,
    write_pos,
    rope: dict,
    layer_idx: int,
) -> torch.Tensor:
    """One attention layer; an owning layer writes its K/V into its cache
    buffer in place, a shared layer reads its source's."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    is_sliding = cfg.layer_types[layer_idx] == "sliding_attention"
    cos, sin = (rope["local_cos"], rope["local_sin"]) if is_sliding else (rope["cos"], rope["sin"])

    q = (x @ p["wq"]).reshape(B, S, H, D)
    q = apply_rope(rms_norm(q, p["q_norm"], eps=cfg.rms_eps), cos, sin, positions)
    layer_cache = cache.layers[cfg.kv_source(layer_idx)]
    if layer_idx < cfg.first_shared_layer:
        k = (x @ p["wk"]).reshape(B, S, Hkv, D)
        k = apply_rope(rms_norm(k, p["k_norm"], eps=cfg.rms_eps), cos, sin, positions)
        v = _rms_only((x @ p["wv"]).reshape(B, S, Hkv, D), cfg.rms_eps)
        layer_cache.update(k, v, write_pos)

    window = cfg.sliding_window if is_sliding else None
    if S == 1:
        decode = attention_route("decode", fp_decode_attention, fp_decode_attention_plain,
                                 D, H, Hkv)
        out = decode(q.contiguous(), layer_cache.k, layer_cache.v, positions[:, 0] + 1,
                     scale=1.0, window=window)
    else:
        # unit attention scaling: v is RMS-normed
        out = gqa_attention(q, layer_cache.k, layer_cache.v, positions, scale=1.0,
                            window=window)
    return out.reshape(B, S, H * D) @ p["wo"]


def _decoder_layer(cfg, p, hs, per_layer_input, cache, positions, write_pos, rope,
                   layer_idx) -> torch.Tensor:
    """hs ``[A, B, S, E]``; per_layer_input ``[B, S, P]``."""
    preds = altup_predict(cfg, p["altup"], hs)
    active = preds[cfg.altup_active_idx]
    a_norm = rms_norm(active, p["input_ln"], eps=cfg.rms_eps)
    laurel_out = _laurel(cfg, p["laurel"], a_norm)

    attn = _attention(cfg, p["attn"], a_norm, cache, positions, write_pos, rope, layer_idx)
    attn = rms_norm(attn, p["post_attn_ln"], eps=cfg.rms_eps)
    attn_laurel = (active + attn + laurel_out) * (1.0 / math.sqrt(2.0))

    h = rms_norm(attn_laurel, p["pre_ffw_ln"], eps=cfg.rms_eps)
    h = rms_norm(_mlp(cfg, p["mlp"], h, layer_idx), p["post_ffw_ln"], eps=cfg.rms_eps)
    corrected = altup_correct(cfg, p["altup"], preds, attn_laurel + h)

    first = corrected[cfg.altup_active_idx]
    if cfg.altup_correct_scale:
        first = first * p["altup"]["correct_output_scale"]
    gate = F.gelu(first @ p["ple"]["gate"], approximate="tanh") * per_layer_input
    proj = rms_norm(gate @ p["ple"]["proj"], p["ple"]["post_norm"], eps=cfg.rms_eps)
    # PLE feedback goes into the non-active streams only
    return torch.cat([corrected[:1], corrected[1:] + proj[None]])


def _magnitude(h: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(h.float() ** 2, dim=-1, keepdim=True))


def gemma3n_forward(
    cfg: Gemma3nConfig,
    params: dict,
    ids: torch.Tensor,
    cache: KVCache,
    cache_positions,
    rope: dict,
    *,
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """The decoder stack: ids ``[B, S]`` -> final hidden ``[B, S, E]`` + the
    cache, written in place. ``cache_positions`` is an ``int`` start
    (prefill) or ``[B]`` per-row positions (decode, S == 1); ``active [B]``
    drops the KV writes of inactive rows (a captured step)."""
    B, S = ids.shape
    E, P, L = cfg.hidden_size, cfg.hidden_size_per_layer_input, cfg.num_layers
    if isinstance(cache_positions, torch.Tensor):
        if S != 1:
            raise ValueError("per-row positions take one token a row")
        positions = cache_positions.to(torch.int32)[:, None]
        write_pos = cache_positions if active is None else torch.where(
            active, cache_positions, cache.layers[0].max_seq)
    else:
        write_pos = int(cache_positions)
        positions = (torch.arange(S, dtype=torch.int32, device=ids.device)
                     + write_pos)[None].expand(B, S)
    ids = ids.long()
    embed, embed_pl = params["embed"], params["embed_per_layer"]
    x0 = embed[ids] * _scalar(math.sqrt(E), embed)

    # Per-Layer Embeddings: gathered PLE (ids clamped into the per-layer
    # table, as the reference's gather clamps) + projection of x0, / sqrt(2)
    ple_ids = ids.clamp(max=cfg.vocab_size_per_layer_input - 1)
    ple = embed_pl[ple_ids].reshape(B, S, L, P) * _scalar(math.sqrt(P), embed_pl)
    proj = (x0 @ params["per_layer_model_projection"]) * (E ** -0.5)
    proj = rms_norm(proj.reshape(B, S, L, P), params["per_layer_projection_norm"],
                    eps=cfg.rms_eps)
    per_layer_inputs = (proj + ple) * (1.0 / math.sqrt(2.0))

    # AltUp stream init: project streams 1.. and match the RMS magnitude of x0
    target = _magnitude(x0)
    streams = [x0]
    for w in params["altup_proj"]:
        h = x0 @ w
        streams.append(h * (target / _magnitude(h).clamp(min=1e-5 ** 0.5)).to(h.dtype))
    hs = torch.stack(streams)

    for i, p in enumerate(params["layers"]):
        hs = _decoder_layer(cfg, p, hs, per_layer_inputs[:, :, i], cache, positions,
                            write_pos, rope, i)

    # collapse streams: unembed-project 1.., magnitude-match to stream 0, mean
    target = _magnitude(hs[0])
    outs = [hs[0]]
    for i, w in enumerate(params["altup_unembed"]):
        h = hs[i + 1] @ w
        outs.append(h * (target / _magnitude(h).clamp(min=1e-5 ** 0.5)).to(h.dtype))
    hidden = torch.mean(torch.stack(outs), dim=0)
    return rms_norm(hidden, params["final_norm"], eps=cfg.rms_eps), cache


def gemma3n_logits(cfg: Gemma3nConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-head float32 logits, softcapped. The product writes float32
    (as :func:`~crane_tpu_torch.models.modules.transformer.lm_logits`
    does): bf16 logits would round ties into the greedy argmax."""
    logits = matmul_f32(hidden, params["embed"].T)
    c = cfg.final_logit_softcapping
    if c is not None:
        logits = torch.tanh(logits / c) * c
    return logits


# ---------------------------------------------------------------------------
# HF checkpoint loading


def config_from_hf(cfg_dict: dict) -> Gemma3nConfig:
    """Build from an HF ``Gemma3nTextConfig`` dict (model_type gemma3n_text,
    or the text_config of a full gemma3n)."""
    if "text_config" in cfg_dict:
        cfg_dict = cfg_dict["text_config"]
    L = cfg_dict["num_hidden_layers"]
    inter = cfg_dict["intermediate_size"]
    if isinstance(inter, int):
        inter = [inter] * L
    sparsity = cfg_dict.get("activation_sparsity_pattern") or [0.0] * L
    layer_types = cfg_dict.get("layer_types")
    if layer_types is None:
        pattern = cfg_dict.get("sliding_window_pattern", 5)
        layer_types = [
            "full_attention" if (i + 1) % pattern == 0 else "sliding_attention"
            for i in range(L)
        ]
    return Gemma3nConfig(
        vocab_size=cfg_dict["vocab_size"],
        vocab_size_per_layer_input=cfg_dict.get("vocab_size_per_layer_input",
                                                cfg_dict["vocab_size"]),
        hidden_size=cfg_dict["hidden_size"],
        hidden_size_per_layer_input=cfg_dict.get("hidden_size_per_layer_input", 256),
        num_layers=L,
        num_heads=cfg_dict["num_attention_heads"],
        num_kv_heads=cfg_dict["num_key_value_heads"],
        head_dim=cfg_dict.get("head_dim", 256),
        intermediate_size=tuple(int(i) for i in inter),
        activation_sparsity=tuple(float(s) for s in sparsity),
        layer_types=tuple(layer_types),
        sliding_window=cfg_dict.get("sliding_window", 512),
        num_kv_shared_layers=cfg_dict.get("num_kv_shared_layers", 0),
        rope_theta=cfg_dict.get("rope_theta", 1_000_000.0),
        rope_local_theta=cfg_dict.get("rope_local_base_freq", 10_000.0),
        rms_eps=cfg_dict.get("rms_norm_eps", 1e-6),
        altup_num_inputs=cfg_dict.get("altup_num_inputs", 4),
        altup_active_idx=cfg_dict.get("altup_active_idx", 0),
        altup_correct_scale=cfg_dict.get("altup_correct_scale", True),
        final_logit_softcapping=cfg_dict.get("final_logit_softcapping", 30.0),
        max_position_embeddings=min(cfg_dict.get("max_position_embeddings", 32768), 32768),
    )


def hf_shapes(cfg: Gemma3nConfig, laurel_rank: int) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every tensor of an HF ``Gemma3nForCausalLM``
    checkpoint of this config (``model.`` names, ``[out, in]`` linears):
    what :func:`map_hf_weights` reads, for drawing a random checkpoint."""
    E, P, L, A = (cfg.hidden_size, cfg.hidden_size_per_layer_input, cfg.num_layers,
                  cfg.altup_num_inputs)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "model.embed_tokens.weight": (cfg.vocab_size, E),
        "model.embed_tokens_per_layer.weight": (cfg.vocab_size_per_layer_input, L * P),
        "model.per_layer_model_projection.weight": (L * P, E),
        "model.per_layer_projection_norm.weight": (P,),
        "model.norm.weight": (E,),
    }
    for i in range(A - 1):
        shapes[f"model.altup_projections.{i}.weight"] = (E, E)
        shapes[f"model.altup_unembed_projections.{i}.weight"] = (E, E)
    for i in range(L):
        lp, inter = f"model.layers.{i}.", cfg.intermediate_size[i]
        shapes.update({
            lp + "self_attn.q_proj.weight": (H * D, E),
            lp + "self_attn.k_proj.weight": (Hkv * D, E),
            lp + "self_attn.v_proj.weight": (Hkv * D, E),
            lp + "self_attn.o_proj.weight": (E, H * D),
            lp + "self_attn.q_norm.weight": (D,),
            lp + "self_attn.k_norm.weight": (D,),
            lp + "mlp.gate_proj.weight": (inter, E),
            lp + "mlp.up_proj.weight": (inter, E),
            lp + "mlp.down_proj.weight": (E, inter),
            lp + "input_layernorm.weight": (E,),
            lp + "post_attention_layernorm.weight": (E,),
            lp + "pre_feedforward_layernorm.weight": (E,),
            lp + "post_feedforward_layernorm.weight": (E,),
            lp + "altup.router_norm.weight": (E,),
            lp + "altup.modality_router.weight": (A, E),
            lp + "altup.prediction_coefs.weight": (A * A, A),
            lp + "altup.correction_coefs.weight": (A, A),
            lp + "altup.correct_output_scale": (E,),
            lp + "laurel.linear_left.weight": (laurel_rank, E),
            lp + "laurel.linear_right.weight": (E, laurel_rank),
            lp + "laurel.post_laurel_norm.weight": (E,),
            lp + "per_layer_input_gate.weight": (P, E),
            lp + "per_layer_projection.weight": (E, P),
            lp + "post_per_layer_input_norm.weight": (E,),
        })
    return shapes


def map_hf_weights(cfg: Gemma3nConfig, tensors: dict, dtype=torch.bfloat16,
                   device=None) -> dict:
    """Map HF ``Gemma3nForCausalLM`` tensors to the port's tree (``[in,
    out]`` linears) on ``device``. A shared layer's k/v projections are
    not read: it owns no cache."""

    def g(name, transpose=True):
        t = tensors.get(name)
        if t is None:
            # transformers' save-time key renaming ("model." ->
            # "model.language_model.") also rewrites the *middle* of
            # "per_layer_model_projection"; accept the mangled spelling
            t = tensors[name.replace("per_layer_model_", "per_layer_model.language_model_")]
        t = torch.as_tensor(t)
        if transpose and t.ndim == 2:
            t = t.T
        return t.to(device=device, dtype=dtype).contiguous()

    pre = ""
    for cand in ("model.language_model.", "language_model.", "model."):
        if any(k.startswith(cand + "embed_tokens.") for k in tensors):
            pre = cand
            break
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        attn = {
            "wq": g(lp + "self_attn.q_proj.weight"),
            "wo": g(lp + "self_attn.o_proj.weight"),
            "q_norm": g(lp + "self_attn.q_norm.weight"),
            "k_norm": g(lp + "self_attn.k_norm.weight"),
        }
        if i < cfg.first_shared_layer:
            attn["wk"] = g(lp + "self_attn.k_proj.weight")
            attn["wv"] = g(lp + "self_attn.v_proj.weight")
        layers.append({
            "attn": attn,
            "mlp": {
                "gate": g(lp + "mlp.gate_proj.weight"),
                "up": g(lp + "mlp.up_proj.weight"),
                "down": g(lp + "mlp.down_proj.weight"),
            },
            "input_ln": g(lp + "input_layernorm.weight"),
            "post_attn_ln": g(lp + "post_attention_layernorm.weight"),
            "pre_ffw_ln": g(lp + "pre_feedforward_layernorm.weight"),
            "post_ffw_ln": g(lp + "post_feedforward_layernorm.weight"),
            "altup": {
                "router_norm": g(lp + "altup.router_norm.weight"),
                "modality_router": g(lp + "altup.modality_router.weight"),
                "prediction_coefs": g(lp + "altup.prediction_coefs.weight"),
                "correction_coefs": g(lp + "altup.correction_coefs.weight"),
                "correct_output_scale": g(lp + "altup.correct_output_scale"),
            },
            "laurel": {
                "left": g(lp + "laurel.linear_left.weight"),
                "right": g(lp + "laurel.linear_right.weight"),
                "post_norm": g(lp + "laurel.post_laurel_norm.weight"),
            },
            "ple": {
                "gate": g(lp + "per_layer_input_gate.weight"),
                "proj": g(lp + "per_layer_projection.weight"),
                "post_norm": g(lp + "post_per_layer_input_norm.weight"),
            },
        })
    return {
        "embed": g(pre + "embed_tokens.weight", transpose=False),
        "embed_per_layer": g(pre + "embed_tokens_per_layer.weight", transpose=False),
        "per_layer_model_projection": g(pre + "per_layer_model_projection.weight"),
        "per_layer_projection_norm": g(pre + "per_layer_projection_norm.weight"),
        "altup_proj": tuple(g(pre + f"altup_projections.{i}.weight")
                            for i in range(cfg.altup_num_inputs - 1)),
        "altup_unembed": tuple(g(pre + f"altup_unembed_projections.{i}.weight")
                               for i in range(cfg.altup_num_inputs - 1)),
        "final_norm": g(pre + "norm.weight"),
        "layers": tuple(layers),
    }


class Gemma3nLM:
    """Prefill + greedy decode over one cache, as crane_tpu's ``Gemma3nLM``.

    ``generate_greedy`` reuses one cache per ``max_seq`` (a fresh prefill
    from position 0 overwrites what it reads), so on the card its decode
    step is captured once as a CUDA graph and replayed a token
    (``graphs.dispatch``, keyed by the cache buffers); on the CPU and under
    ``graphs.eager()`` the same step runs eagerly.
    :meth:`release_graphs` drops the programs and the kept caches."""

    def __init__(self, cfg: Gemma3nConfig, params: dict, max_seq: int = 512, batch: int = 1):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.device = params["embed"].device
        self.cache_dtype = params["embed"].dtype
        self.rope = make_gemma3n_rope(cfg, self.device)
        self._programs: dict = {}
        self._generate_caches: dict = {}

    def release_graphs(self) -> None:
        """Drop the captured programs and the caches they hold."""
        self._programs.clear()
        self._generate_caches.clear()

    def new_cache(self) -> KVCache:
        return make_gemma3n_cache(self.cfg, self.batch, self.max_seq, self.cache_dtype,
                                  self.device)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32), device=self.device)

    @torch.no_grad()
    def prefill(self, ids, cache: KVCache, *, last_only: bool = False):
        """A fresh prefill of ids ``[B, S]`` from position 0: (logits ``[B,
        S, V]`` float32, or ``[B, V]`` at the last position, cache)."""
        hidden, cache = gemma3n_forward(self.cfg, self.params, self._ids(ids), cache, 0,
                                        self.rope)
        if last_only:
            hidden = hidden[:, -1:]
        logits = gemma3n_logits(self.cfg, self.params, hidden)
        return (logits[:, 0] if last_only else logits), cache

    @torch.no_grad()
    def decode_step(self, tok, cache: KVCache, pos):
        """One decode step, eagerly: tok ``[B, 1]`` at positions ``pos
        [B]`` -> (logits ``[B, V]``, cache)."""
        hidden, cache = gemma3n_forward(self.cfg, self.params, self._ids(tok), cache,
                                        self._ids(pos), self.rope)
        return gemma3n_logits(self.cfg, self.params, hidden)[:, -1], cache

    def _step_body(self, *, layers, tokens, positions, active, logits):
        cache = KVCache(layers=layers, lengths=positions)
        hidden, _ = gemma3n_forward(self.cfg, self.params, tokens, cache, positions,
                                    self.rope, active=active)
        logits.copy_(gemma3n_logits(self.cfg, self.params, hidden)[:, -1])

    @torch.no_grad()
    def decode_graph(self, tok, cache: KVCache, pos) -> torch.Tensor:
        """:meth:`decode_step` as one replay of a captured program on the
        card (eager elsewhere): logits ``[B, V]``."""
        toks = self._ids(tok)
        B = toks.shape[0]
        inputs = dict(tokens=toks, positions=self._ids(pos),
                      active=torch.ones((B,), dtype=torch.bool, device=self.device))
        return graphs.dispatch(self._programs, self.device, "gemma3n_decode", self._step_body,
                               cache, inputs,
                               {"logits": ((B, self.cfg.vocab_size), torch.float32)})["logits"]

    def prefill_logits(self, ids: np.ndarray) -> np.ndarray:
        logits, _ = self.prefill(ids, self.new_cache())
        return logits.cpu().numpy()

    def generate_greedy(
        self,
        ids: np.ndarray,
        max_new_tokens: int,
        *,
        eos: tuple = (),
        streamer=None,
    ) -> list[int]:
        """Greedy tokens of one prompt ``[1, S]`` (crane_tpu's loop: stop at
        EOS, ``max_new_tokens`` or the cache's end). A prompt id outside the
        vocabulary raises ``ValueError``; an id past the per-layer table is
        clamped into it, as in the reference."""
        ids = np.asarray(ids, np.int32)
        if ids.ndim != 2 or ids.shape[0] != 1:
            raise ValueError(f"generate_greedy takes one prompt [1, S], got {ids.shape}")
        err = prompt_ids_error(ids[0], self.cfg.vocab_size)
        if err:
            raise ValueError(err)
        if self.max_seq not in self._generate_caches:
            self._generate_caches[self.max_seq] = self.new_cache()
        logits, cache = self.prefill(ids, self._generate_caches[self.max_seq], last_only=True)
        pos = ids.shape[1]
        eos = set(eos)

        def emit(t) -> bool:  # stream non-eos tokens; False stops generation
            if streamer is None or t in eos:
                return True
            return streamer.append(t) is not False

        tok = int(torch.argmax(logits[0]))
        out = [tok]
        keep_going = emit(tok)
        while (keep_going and len(out) < max_new_tokens and tok not in eos
               and pos < self.max_seq - 1):
            logits = self.decode_graph([[tok]], cache, [pos])
            pos += 1
            tok = int(torch.argmax(logits[0]))
            out.append(tok)
            if not emit(tok):
                break
        if streamer is not None:
            streamer.finalize()
        return out


def from_pretrained(path: str, dtype=torch.bfloat16, max_seq: int = 512,
                    device=None) -> Gemma3nLM:
    """Load an HF Gemma3n checkpoint onto ``device``: by default the card,
    and with no card an error unless ``device="cpu"`` is given."""
    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict

    device = default_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    params = map_hf_weights(cfg, load_state_dict(path), dtype, device)
    return Gemma3nLM(cfg, params, max_seq=max_seq)
