"""Shared decoder-only transformer: config and forward functions.

Port of ``crane_tpu/models/modules/transformer.py``: the dense branches,
quantized weights and int8/int4 KV caches, the hybrid Gated-DeltaNet layers
of Qwen3-Next / Qwen3.5, their sparse-MoE MLPs, and LFM2's short-conv
layers (with LFM2-MoE's sigmoid-routed experts). The pre-norm block is
input_ln -> token mixer -> +res -> post_ln -> MLP -> +res, one
parameterised implementation for Qwen3, Qwen2.5, Llama-likes,
Hunyuan-dense, Gemma3 text, LFM2 and the GDN hybrids. The
mixer is GQA attention (QK-norm, RoPE, KV-cache write, the optional sigmoid
output gate), in a ``gdn`` layer
:func:`~crane_tpu_torch.models.modules.gdn_layer.gdn_block` (K7 for fresh
prefills and continuation chunks), in a ``conv`` layer
:func:`short_conv_block`. The MLP is SwiGLU, or :func:`moe_block` where the
layer's params carry a router. Params are the reference's nested dict, with
torch tensors as leaves.

Attention has one route per phase and cache form, whatever S and T are:

- fresh prefill (``read_cache=False``): in-context K/V through K2,
  :func:`~crane_tpu_torch.ops.cuda.flash_attention.flash_attention_causal`,
  whatever the cache stores;
- a continuation chunk (``read_cache``, S > 1): the fp cache buffers through
  K3, :func:`~crane_tpu_torch.ops.cuda.flash_attention.flash_attention_cached`;
  an int8/int4 cache's codes and scales through K5,
  :func:`~crane_tpu_torch.ops.cuda.quant_attention.quant_cached_attention`;
- decode (``read_cache``, S == 1): the fp cache through K1,
  :func:`~crane_tpu_torch.ops.cuda.decode_attention.fp_decode_attention`; an
  int8/int4 cache through K4,
  :func:`~crane_tpu_torch.ops.cuda.quant_attention.quant_decode_attention`.

A layer whose cache is a
:class:`~crane_tpu_torch.ops.kv_cache.SequenceShardedKVCache` (sequence
parallelism, :mod:`crane_tpu_torch.parallel.sequence`) writes each token to
its slab and, reading the cache, runs the with-stats kernel per slab and
merges the partials exactly: decode through K1-S / K4-S, continuation chunks
through K3-S / K5-S. A fresh prefill still attends its own K/V through K2.

Each route takes its kernel only where the kernel takes the heads
(:func:`~crane_tpu_torch.ops.cuda.attention_kernel_takes`: a head dim in
{64, 128, 256}, and for decode at most 8 query heads per kv-head); other
shapes go to the kernel's plain version, as crane_tpu sends them to
``gqa_attention``, and each such call counts in
``attention_block.plain_routes[kind]`` (:func:`attention_route`).

Quantized linear weights go through :func:`~crane_tpu_torch.ops.linear.linear`
(K6 at M <= 256). Each wrapper launches its CUDA kernel on a CUDA tensor and
runs its plain PyTorch version on a CPU tensor. The MoE dispatch and the
short conv have no Pallas kernel in the reference (XLA computes them): the
short conv is plain PyTorch here, and the MoE's routed experts run K8 on
the card (:func:`moe_block`) and the reference's dispatches on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import math
import os
import sys
import threading
from typing import Any, ClassVar

import torch
import torch.nn.functional as F

from crane_tpu_torch.models.fuse import qkv_sizes
from crane_tpu_torch.models.modules.gdn_layer import gdn_block
from crane_tpu_torch.ops.attention import gqa_attention
from crane_tpu_torch.ops.cuda import ATTENTION_KINDS, attention_kernel_takes
from crane_tpu_torch.ops.cuda.decode_attention import (
    fp_decode_attention,
    fp_decode_attention_plain,
)
from crane_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_cached,
    flash_attention_cached_plain,
    flash_attention_causal,
    flash_attention_causal_plain,
)
from crane_tpu_torch.ops.cuda.moe import moe_experts
from crane_tpu_torch.ops.cuda.quant_attention import (
    quant_cached_attention,
    quant_cached_attention_plain,
    quant_decode_attention,
    quant_decode_attention_plain,
)
from crane_tpu_torch.ops.cuda.quant_matmul import matmul_f32
from crane_tpu_torch.ops.gdn import causal_conv1d, causal_conv1d_update
from crane_tpu_torch.ops.kv_cache import (
    ConvLayerCache,
    GdnLayerCache,
    KVCache,
    LayerKVCache,
    QuantLayerKVCache,
    SequenceShardedKVCache,
)
from crane_tpu_torch.ops.linear import QuantizedWeight, linear
from crane_tpu_torch.ops.norm import rms_norm
from crane_tpu_torch.ops.rope import apply_rope_embeds, inv_frequencies, rope_table
from crane_tpu_torch.parallel.sharding import ShardedParams


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static architecture description: the same fields and defaults as
    ``crane_tpu``'s, so a config moves between the packages unchanged."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 32768
    qk_norm: bool = False
    qk_norm_after_rope: bool = False
    attn_bias: bool = False
    tie_word_embeddings: bool = False
    rope_mode: str = "half"
    partial_rotary_factor: float = 1.0
    layer_types: tuple[str, ...] | None = None
    sliding_window: int | None = None
    logit_softcap: float | None = None
    attn_logit_softcap: float | None = None
    norm_weight_offset: float = 0.0
    embed_scale: float | None = None
    act: str = "silu"
    sandwich_norms: bool = False
    rope_local_theta: float | None = None
    query_scale: float | None = None
    rope_scaling_factor: float = 1.0
    rope_llama3: tuple[float, float, float, int] | None = None
    attn_output_gate: bool = False
    gdn: Any = None
    conv_l_cache: int = 3
    conv_bias: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = True
    decoder_sparse_step: int = 1
    mlp_only_layers: tuple[int, ...] = ()
    sequence_axis: str | None = None
    # the MoE router (:func:`moe_block`): class attributes and not fields,
    # so the fields stay crane_tpu's; :class:`MoeRouterConfig` sets them
    moe_router: ClassVar[str] = "softmax"
    routed_scaling_factor: ClassVar[float] = 1.0

    def is_moe_layer(self, i: int) -> bool:
        return (
            self.num_experts > 0
            and i not in self.mlp_only_layers
            and self.decoder_sparse_step > 0
            and (i + 1) % self.decoder_sparse_step == 0
        )

    @property
    def rot_dim(self) -> int:
        r = int(self.head_dim * self.partial_rotary_factor)
        return r - (r % 2)

    def layer_type(self, i: int) -> str:
        if self.layer_types is None:
            return "full"
        return self.layer_types[i]

    @property
    def has_recurrent_layers(self) -> bool:
        return self.layer_types is not None and any(
            t in ("gdn", "conv") for t in self.layer_types
        )


@dataclasses.dataclass(frozen=True)
class MoeRouterConfig(TransformerConfig):
    """A :class:`TransformerConfig` whose sparse-MoE layers route otherwise
    than Qwen3-Next's softmax (crane_tpu has no other router, so its config
    has no such fields). ``moe_router`` ``"sigmoid"`` is LFM2-MoE's (HF
    ``Lfm2MoeSparseMoeBlock``): experts chosen on ``sigmoid(logits) +
    expert_bias``, weighted by their unbiased sigmoids, renormalised when
    ``norm_topk_prob``, then times ``routed_scaling_factor``."""

    moe_router: str = "softmax"
    routed_scaling_factor: float = 1.0


def make_cache(
    cfg: TransformerConfig,
    batch: int,
    max_seq: int,
    dtype=torch.bfloat16,
    *,
    quant_bits: int | None = None,
    device=None,
) -> KVCache:
    """Allocate the per-layer cache: KV buffers ``[batch, max_seq, Hkv, D]``
    in ``dtype`` (or int8/int4 codes and scales with ``quant_bits`` 8 or 4)
    for attention layers, the conv window and float32 recurrent state for
    GDN layers, the ``[batch, conv_l_cache, hidden]`` window for short-conv
    layers. ``device="meta"`` sizes without allocating."""
    layers = tuple(make_layer_cache(cfg, i, batch, max_seq, dtype, quant_bits=quant_bits,
                                    device=device) for i in range(cfg.num_layers))
    return KVCache(layers=layers,
                   lengths=torch.zeros((batch,), dtype=torch.int32, device=device))


def make_layer_cache(cfg: TransformerConfig, i: int, batch: int, max_seq: int, dtype, *,
                     quant_bits: int | None = None, device=None):
    """Layer ``i``'s cache as :func:`make_cache` allocates it."""
    if cfg.layer_type(i) == "gdn":
        g = cfg.gdn
        return GdnLayerCache.empty(batch, g.conv_kernel, g.conv_dim, g.num_v_heads,
                                   g.head_k_dim, g.head_v_dim, dtype, device)
    if cfg.layer_type(i) == "conv":
        return ConvLayerCache.empty(batch, cfg.conv_l_cache, cfg.hidden_size, dtype, device)
    if quant_bits is not None:
        return QuantLayerKVCache.empty(batch, max_seq, cfg.num_kv_heads, cfg.head_dim,
                                       bits=quant_bits, device=device)
    return LayerKVCache.empty(batch, max_seq, cfg.num_kv_heads, cfg.head_dim, dtype, device)


def make_rope_tables(cfg: TransformerConfig, device=None) -> dict[str, torch.Tensor]:
    """Precompute cos/sin tables ``[max_pos, rot_dim / 2]`` float32; Gemma
    style models carry a second pair for sliding layers."""
    cos, sin = rope_table(cfg.rot_dim, cfg.max_position_embeddings,
                          theta=cfg.rope_theta, device=device)
    t = torch.arange(cfg.max_position_embeddings, dtype=torch.float32, device=device)
    if cfg.rope_llama3 is not None:
        factor, low_f, high_f, orig_max = cfg.rope_llama3
        inv = inv_frequencies(cfg.rot_dim, cfg.rope_theta, device)
        wavelen = 2 * math.pi / inv
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        inv_scaled = torch.where(
            wavelen > orig_max / low_f,
            inv / factor,
            torch.where(wavelen < orig_max / high_f, inv,
                        (1 - smooth) * inv / factor + smooth * inv),
        )
        freqs = torch.outer(t, inv_scaled)
        cos, sin = torch.cos(freqs), torch.sin(freqs)
    if cfg.rope_scaling_factor != 1.0:
        # linear position scaling: equivalent to dividing positions
        freqs = torch.outer(t / cfg.rope_scaling_factor,
                            inv_frequencies(cfg.rot_dim, cfg.rope_theta, device))
        cos, sin = torch.cos(freqs), torch.sin(freqs)
    tables = {"cos": cos, "sin": sin}
    if cfg.rope_local_theta is not None:
        tables["local_cos"], tables["local_sin"] = rope_table(
            cfg.rot_dim, cfg.max_position_embeddings, theta=cfg.rope_local_theta,
            device=device)
    return tables


def _activation(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {cfg.act!r}")


def mlp_block(cfg: TransformerConfig, p: dict, x: torch.Tensor, expert_offset: int = 0,
              partial: bool = False) -> torch.Tensor:
    """SwiGLU: down(act(gate(x)) * up(x)); the sparse-MoE MLP where the
    layer's params carry a router (``expert_offset``: see :func:`moe_block`).
    ``partial``: a tensor-parallel shard's product over its rows of
    ``down``, returned in float32 (the shards' partials are summed before
    one rounding)."""
    if "router" in p:
        return moe_block(cfg, p, x, expert_offset, partial)
    if "gate_up" in p:
        # fused gate|up (models/fuse.py): one product, sliced after
        g, u = linear(x, p["gate_up"]).chunk(2, dim=-1)
        h = _activation(cfg, g) * u
    else:
        h = _activation(cfg, linear(x, p["gate"])) * linear(x, p["up"])
    return matmul_f32(h, p["down"].to(h.dtype)) if partial else linear(h, p["down"])


# the dense dispatch's [n_experts, tokens, I] intermediates hold at most this
# many elements: longer token runs go through in blocks of tokens
MOE_BLOCK_ELEMENTS = 1 << 27


def _moe_dispatch_dense(cfg: TransformerConfig, p: dict, xt: torch.Tensor,
                        w: torch.Tensor, sel: torch.Tensor, offset: int = 0,
                        partial: bool = False) -> torch.Tensor:
    """Dense one-hot dispatch, the reference's default: every expert computes
    every token, weighted by the sparse combine matrix. xt ``[T, E]``; w,
    sel ``[T, k]``. The gate and up projections are one batched product over
    the experts (``[n, t, I]``); the combine weights scale ``h`` first, so the
    down projection is one contraction over (expert, I) and never builds a
    ``[t, n, E]`` product. ``p`` may hold the experts ``offset ..
    offset + n`` only (a tensor-parallel shard): their columns of the
    combine matrix weight them, and an expert the router did not pick
    weighs 0; with ``partial`` the down projection writes float32."""
    T, E = xt.shape
    n, I = p["experts_down"].shape[0], p["experts_down"].shape[1]
    cw = torch.zeros((T, cfg.num_experts), dtype=torch.float32, device=xt.device)
    cw = cw.scatter_add_(1, sel, w.float())[:, offset:offset + n].to(xt.dtype)
    down = p["experts_down"].reshape(n * I, E)
    block = max(1, MOE_BLOCK_ELEMENTS // (n * I))
    out = []
    for s in range(0, T, block):
        x = xt[s:s + block]
        h = _activation(cfg, torch.matmul(x, p["experts_gate"])) * torch.matmul(x, p["experts_up"])
        h = h * cw[s:s + block].T[:, :, None]
        h = h.transpose(0, 1).reshape(x.shape[0], n * I)
        out.append(matmul_f32(h, down) if partial else h @ down)
    return out[0] if len(out) == 1 else torch.cat(out)


def _moe_dispatch_ragged(cfg: TransformerConfig, p: dict, xt: torch.Tensor,
                         w: torch.Tensor, sel: torch.Tensor, offset: int = 0,
                         partial: bool = False) -> torch.Tensor:
    """Token-sorted grouped-product dispatch (``CRANE_MOE_DISPATCH=ragged``):
    the T k (token, expert) slots are sorted by expert (stably), each expert
    multiplies its contiguous group (``torch._grouped_mm``, the counterpart
    of ``lax.ragged_dot``), and the weighted results add back per token.
    Group ends are counted on the device, with no host read, so a CUDA graph
    captures it. ``p`` may hold the experts ``offset .. offset + n`` only
    (a tensor-parallel shard): the slots routed to them sort first and the
    grouped products stop at their count; the other slots sort last and add
    0, so the shapes stay those of all T k slots. With ``partial`` the
    weighted rows add up in float32 (the grouped product itself writes the
    input's dtype)."""
    T, E = xt.shape
    n = p["experts_down"].shape[0]
    flat = sel.reshape(-1)
    local = (flat >= offset) & (flat < offset + n)
    key = torch.where(local, flat - offset, n)
    order = torch.argsort(key, stable=True)
    token_idx = torch.div(order, cfg.num_experts_per_tok, rounding_mode="floor")
    xs = xt[token_idx]
    sizes = torch.zeros(n + 1, dtype=torch.int32, device=xt.device)
    sizes.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    offs = torch.cumsum(sizes[:n], 0, dtype=torch.int32)
    h = _activation(cfg, torch._grouped_mm(xs, p["experts_gate"], offs=offs)) \
        * torch._grouped_mm(xs, p["experts_up"], offs=offs)
    out = torch._grouped_mm(h, p["experts_down"], offs=offs)
    if partial:
        out = out.float()
    # rows past the last group end are not computed: where() drops them
    out = torch.where(local[order][:, None], out * w.reshape(-1)[order][:, None].to(out.dtype), 0)
    return torch.zeros((T, E), dtype=out.dtype, device=xt.device).index_add_(0, token_idx, out)


def _route_sigmoid(cfg: TransformerConfig, p: dict, xt: torch.Tensor):
    """LFM2-MoE's router (HF ``Lfm2MoeSparseMoeBlock``), in float32: the
    top k of ``sigmoid(logits) + expert_bias`` (the bias, where the layer
    has one, chooses and never weighs), weighted by their unbiased
    sigmoids, renormalised when ``norm_topk_prob`` (``/ (sum + 1e-6)``),
    times ``routed_scaling_factor``. Returns (w, sel) ``[T, k]``."""
    scores = torch.sigmoid((xt @ p["router"].to(xt.dtype)).float())
    bias = p.get("expert_bias")
    choice = scores if bias is None else scores + bias.float()
    sel = torch.topk(choice, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, sel)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    return w * cfg.routed_scaling_factor, sel


def moe_route(cfg: TransformerConfig, p: dict, xt: torch.Tensor):
    """The router's picks for tokens xt ``[T, E]``: (w float32, sel int64),
    ``[T, k]`` each. Qwen3-Next's (HF ``Qwen3NextSparseMoeBlock``): a
    softmax over the experts in float32, top-k, renormalised when
    ``norm_topk_prob``; or, where ``cfg.moe_router`` is ``"sigmoid"``,
    LFM2-MoE's (:func:`_route_sigmoid`)."""
    if cfg.moe_router == "sigmoid":
        return _route_sigmoid(cfg, p, xt)
    probs = torch.softmax((xt @ p["router"].to(xt.dtype)).float(), dim=-1)
    w, sel = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, sel


def moe_dispatch(device: torch.device) -> str:
    """Which dispatch runs the routed experts on ``device``: ``"kernel"``
    (K8) on the card; on the CPU the reference's, ``"dense"`` unless
    ``CRANE_MOE_DISPATCH=ragged``."""
    if device.type == "cuda":
        return "kernel"
    return "ragged" if os.environ.get("CRANE_MOE_DISPATCH", "dense") == "ragged" else "dense"


def moe_block(cfg: TransformerConfig, p: dict, x: torch.Tensor,
              expert_offset: int = 0, partial: bool = False) -> torch.Tensor:
    """Sparse-MoE SwiGLU, with a sigmoid-gated shared expert where the
    layer has one (Qwen3-Next).

    Routing as the reference does it (:func:`moe_route`). On the card the
    routed experts go through K8
    (:func:`~crane_tpu_torch.ops.cuda.moe.moe_experts`), which runs only the
    (token, expert) pairs the router chose; on the CPU the dispatch is the
    reference's, dense unless ``CRANE_MOE_DISPATCH=ragged``, its own switch
    (:func:`moe_dispatch`). A
    tensor-parallel shard (:mod:`crane_tpu_torch.parallel.inference`)
    passes its experts ``expert_offset ..`` and its columns of the shared
    expert; the router runs whole, and the result is the shard's partial
    sum (in float32 with ``partial``)."""
    B, S, E = x.shape
    xt = x.reshape(B * S, E)
    w, sel = moe_route(cfg, p, xt)
    dispatch = moe_dispatch(xt.device)
    if dispatch == "kernel":
        y = moe_experts(xt.contiguous(), w, sel, p["experts_gate"], p["experts_up"],
                        p["experts_down"], act=cfg.act, offset=expert_offset, partial=partial)
    elif dispatch == "ragged":
        y = _moe_dispatch_ragged(cfg, p, xt, w, sel, expert_offset, partial)
    else:
        y = _moe_dispatch_dense(cfg, p, xt, w, sel, expert_offset, partial)
    if "shared_gate" in p:
        hs = _activation(cfg, linear(xt, p["shared_gate_proj"])) * linear(xt, p["shared_up"])
        sh = matmul_f32(hs, p["shared_down"].to(hs.dtype)) if partial else \
            linear(hs, p["shared_down"])
        gate = torch.sigmoid((xt @ p["shared_gate"].to(xt.dtype)).float()).to(x.dtype)
        y = y + gate.to(sh.dtype) * sh
    return y.reshape(B, S, E)


def attention_block(
    cfg: TransformerConfig,
    p: dict,
    x: torch.Tensor,
    layer_cache,
    positions: torch.Tensor,
    cache_positions,
    rope: dict,
    *,
    window: int | None = None,
    read_cache: bool = True,
    cache_row: int | torch.Tensor | None = None,
    use_local_rope: bool = False,
    extra_mask: torch.Tensor | None = None,
    segments: torch.Tensor | None = None,
    plain: bool = False,
    partial: bool = False,
):
    """GQA attention with QK-norm, RoPE, the KV-cache append and the
    optional sigmoid output gate.

    x ``[B, S, E]``; positions ``[B, S]`` int32; ``cache_positions`` an int
    start or ``[B]`` per-row write positions (see ``LayerKVCache.update``).
    ``read_cache=False`` attends over the freshly computed in-context K/V
    (fresh prefill from position 0) so a slot prefill touches no other row.
    ``cache_row`` is the slot row of an ``int``-start write, or, with
    ``[B]`` per-row starts, a ``[B]`` int32 device tensor of the rows the
    batch writes and, reading the cache, attends (a batch-1 chunk into a
    slot chosen on the device, as a CUDA graph replays it: K3 over an fp
    cache only).
    With ``cfg.attn_output_gate`` the q projection is twice as wide and
    carries ``[query | gate]`` per head; the attention output is multiplied
    by ``sigmoid(gate)`` before the output projection. The cache is written
    in place. Returns (out ``[B, S, E]``, layer cache).

    ``extra_mask [B, S, T']`` is OR'd with the causal mask (Gemma3-VL's
    bidirectional image blocks). ``segments [B, S]`` int32 is the same mask
    in compact form (a key and a query in one positive segment see each
    other), and a caller that passes it passes the ``extra_mask`` it
    stands for: a fresh prefill then takes K2 with the segments, as
    crane_tpu's flash route does. An ``extra_mask`` without ``segments``
    (or over the cache) goes to the plain :func:`gqa_attention`, as in
    crane_tpu, and counts in ``plain_routes``. The route follows the
    arguments, never a failed launch.

    ``plain=True`` sends every call to the plain version (counted in
    ``plain_routes`` too): the kernels have no backward, so a forward that
    is differentiated (:mod:`crane_tpu_torch.parallel.train`) asks for the
    plain route, as crane_tpu trains through ``gqa_attention``.
    ``partial``: a tensor-parallel shard's product over its rows of ``wo``,
    returned in float32 (the shards' partials are summed before one
    rounding).
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    if "wqkv" in p:
        # fused q|k|v (models/fuse.py): one product, sliced after
        q, k, v = linear(x, p["wqkv"], p.get("bqkv")).split(qkv_sizes(cfg), dim=-1)
    else:
        q = linear(x, p["wq"], p.get("bq"))
        k = linear(x, p["wk"], p.get("bk"))
        v = linear(x, p["wv"], p.get("bv"))
    gate = None
    if cfg.attn_output_gate:
        q = q.reshape(B, S, H, 2 * D)
        q, gate = q[..., :D], q[..., D:]
    else:
        q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)

    def qk_normalize(q, k):
        q = rms_norm(q, p["q_norm"], eps=cfg.rms_norm_eps, weight_offset=cfg.norm_weight_offset)
        k = rms_norm(k, p["k_norm"], eps=cfg.rms_norm_eps, weight_offset=cfg.norm_weight_offset)
        return q, k

    if cfg.qk_norm and not cfg.qk_norm_after_rope:
        q, k = qk_normalize(q, k)
    cos = rope["local_cos"] if use_local_rope else rope["cos"]
    sin = rope["local_sin"] if use_local_rope else rope["sin"]
    q = apply_rope_embeds(q, cos, sin, mode=cfg.rope_mode)
    k = apply_rope_embeds(k, cos, sin, mode=cfg.rope_mode)
    if cfg.qk_norm and cfg.qk_norm_after_rope:
        q, k = qk_normalize(q, k)
    # the kernels take contiguous rows: a fused product's slices are views
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

    new_cache = layer_cache.update(k, v, cache_positions, row=cache_row)
    scale = cfg.query_scale if cfg.query_scale is not None else D ** -0.5
    softcap = cfg.attn_logit_softcap
    kind = "prefill" if not read_cache else ("decode" if S == 1 else "chunk")
    kv_rows = cache_row if isinstance(cache_row, torch.Tensor) else None
    if kv_rows is not None and read_cache and (
            kind != "chunk" or extra_mask is not None or type(new_cache) is not LayerKVCache):
        raise ValueError("a device cache row is read only by a chunk over an fp cache (K3)")

    def route(kernel, plain_fn):
        return attention_route(kind, kernel, plain_fn, D, H, Hkv, force_plain=plain)

    if extra_mask is not None and (read_cache or segments is None):
        attention_block.plain_routes[kind] += 1
        kc, vc = (k, v) if not read_cache else (
            new_cache.dequant(x.dtype) if isinstance(new_cache, QuantLayerKVCache)
            else (new_cache.k, new_cache.v))
        out = gqa_attention(q, kc, vc, positions, scale=scale, window=window,
                            logit_softcap=softcap, extra_mask=extra_mask)
    elif not read_cache:
        out = route(flash_attention_causal, flash_attention_causal_plain)(
            q, k, v, segments, scale=scale, window=window, softcap=softcap)
    elif isinstance(new_cache, SequenceShardedKVCache):
        # only full-attention layers shard (a sliding window's KV is bounded)
        if window is not None:
            raise ValueError("a sliding-window layer's cache is never sequence-sharded")
        from crane_tpu_torch.parallel.sequence import sp_chunk_attention, sp_decode_attention

        if S == 1:
            out = sp_decode_attention(q, new_cache, positions[:, 0] + 1, scale=scale,
                                      logit_softcap=softcap)
        else:
            out = sp_chunk_attention(q, new_cache, positions, scale=scale,
                                     logit_softcap=softcap)
    elif isinstance(new_cache, QuantLayerKVCache):
        args = (q, new_cache.k, new_cache.v, new_cache.k_scale, new_cache.v_scale)
        kw = dict(bits=new_cache.bits, scale=scale, window=window, logit_softcap=softcap)
        if S == 1:
            out = route(quant_decode_attention, quant_decode_attention_plain)(
                *args, positions[:, 0] + 1, **kw)
        else:
            out = route(quant_cached_attention, quant_cached_attention_plain)(
                *args, positions, **kw)
    elif S == 1:
        out = route(fp_decode_attention, fp_decode_attention_plain)(
            q, new_cache.k, new_cache.v, positions[:, 0] + 1, scale=scale,
            window=window, logit_softcap=softcap)
    else:
        out = route(flash_attention_cached, flash_attention_cached_plain)(
            q, new_cache.k, new_cache.v, positions, scale=scale, window=window,
            softcap=softcap, kv_rows=kv_rows)

    if gate is not None:
        out = out * torch.sigmoid(gate.float()).to(out.dtype)
    out = out.reshape(B, S, H * D)
    if partial:
        return matmul_f32(out, p["wo"].to(out.dtype)), new_cache
    return linear(out, p["wo"], p.get("bo")), new_cache


def attention_route(kind: str, kernel, plain, head_dim: int, n_heads: int, n_kv_heads: int,
                    *, force_plain: bool = False):
    """``kernel`` (a wrapper) where the ``kind`` kernels take these heads,
    else ``plain``, its plain version, counted once in
    ``attention_block.plain_routes[kind]``. The route is chosen by shape
    (or by the caller's ``force_plain``), never by a failed launch."""
    if not force_plain and attention_kernel_takes(kind, head_dim, n_heads, n_kv_heads):
        return kernel
    attention_block.plain_routes[kind] += 1
    return plain


# attention calls routed to a plain version by shape, per kind
attention_block.plain_routes = dict.fromkeys(ATTENTION_KINDS, 0)


def short_conv_block(
    cfg: TransformerConfig,
    p: dict,
    x: torch.Tensor,
    layer_cache: ConvLayerCache,
    *,
    decode: bool,
    cache_row: int | None = None,
    active: torch.Tensor | None = None,
    true_lengths: torch.Tensor | None = None,
    continuation: bool = False,
):
    """LFM2 short-conv mixer (HF ``Lfm2ShortConv``): in_proj -> (B, C, x) ->
    depthwise causal conv of B * x, no activation -> C * conv_out ->
    out_proj, with the rolling L-window in the layer cache for decode.
    ``continuation`` re-enters the saved window (chunked prefill == whole
    prefill). The window is written in place (:meth:`ConvLayerCache.replace_rows`).
    Returns (out ``[B, S, E]``, layer cache)."""
    b, c, xx = linear(x, p["in_proj"], p.get("in_bias")).chunk(3, dim=-1)
    bx = b * xx
    if decode:
        y, new_state = causal_conv1d_update(bx[:, 0], layer_cache.conv_state, p["conv_w"],
                                            activation=False)
        conv_out = y[:, None]
    else:
        conv_out, new_state = causal_conv1d(
            bx, p["conv_w"], activation=False, true_lengths=true_lengths,
            init_window=layer_cache.conv_state if continuation else None)
    if "conv_b" in p:
        conv_out = conv_out + p["conv_b"]
    out = linear(c * conv_out, p["out_proj"], p.get("out_bias"))
    return out, layer_cache.replace_rows(new_state, row=cache_row, active=active)


@dataclasses.dataclass(frozen=True)
class LayerBlocks:
    """The calls a decoder layer makes for its mixer and its MLP, each with
    the signature of its default. A tensor-parallel model
    (:mod:`crane_tpu_torch.parallel.inference`) passes calls that run the
    block on every shard and sum the partials."""

    attention: Any = attention_block
    gdn: Any = gdn_block
    conv: Any = short_conv_block
    mlp: Any = mlp_block


def decoder_layer(
    cfg: TransformerConfig,
    p: dict,
    x: torch.Tensor,
    layer_cache,
    positions: torch.Tensor,
    cache_positions,
    rope: dict,
    *,
    layer_idx: int,
    read_cache: bool = True,
    cache_row: int | torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    true_lengths: torch.Tensor | None = None,
    extra_mask: torch.Tensor | None = None,
    segments: torch.Tensor | None = None,
    plain_attention: bool = False,
    blocks: LayerBlocks = LayerBlocks(),
):
    ltype = cfg.layer_type(layer_idx)

    def nrm(t, w):
        return rms_norm(t, w, eps=cfg.rms_norm_eps, weight_offset=cfg.norm_weight_offset)

    if ltype in ("gdn", "conv"):
        # as attention: S == 1 while reading the cache is decode; S > 1
        # while reading it is a continuation chunk (re-enters the saved conv
        # window and recurrent state, so chunked prefill == whole prefill);
        # read_cache=False is a fresh prefill restarting from zero state
        decode = read_cache and x.shape[1] == 1
        kw = dict(decode=decode, cache_row=cache_row, active=active if decode else None,
                  true_lengths=None if decode else true_lengths,
                  continuation=read_cache and x.shape[1] > 1 and cache_row is None)
        if ltype == "gdn":
            attn_out, new_cache = blocks.gdn(cfg.gdn, p["gdn"], nrm(x, p["input_ln"]),
                                             layer_cache, eps=cfg.rms_norm_eps, **kw)
        else:
            attn_out, new_cache = blocks.conv(cfg, p["conv"], nrm(x, p["input_ln"]),
                                              layer_cache, **kw)
    else:
        attn_out, new_cache = blocks.attention(
            cfg, p["attn"], nrm(x, p["input_ln"]), layer_cache, positions,
            cache_positions, rope,
            window=cfg.sliding_window if ltype == "sliding" else None,
            read_cache=read_cache, cache_row=cache_row,
            use_local_rope=(ltype == "sliding" and cfg.rope_local_theta is not None),
            extra_mask=extra_mask, segments=segments, plain=plain_attention,
        )
    if cfg.sandwich_norms:
        x = x + nrm(attn_out, p["post_attn_ln"])
        x = x + nrm(blocks.mlp(cfg, p["mlp"], nrm(x, p["pre_ffn_ln"])), p["post_ffn_ln"])
    else:
        x = x + attn_out
        x = x + blocks.mlp(cfg, p["mlp"], nrm(x, p["post_ln"]))
    return x, new_cache


def forward_hidden(
    cfg: TransformerConfig,
    params: dict,
    tokens: torch.Tensor,
    cache: KVCache,
    cache_positions,
    rope: dict,
    *,
    read_cache: bool = True,
    cache_row: int | torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    true_lengths: torch.Tensor | None = None,
    inputs_embeds: torch.Tensor | None = None,
    rope_embeds: dict | None = None,
    deepstack: tuple | None = None,
    extra_mask: torch.Tensor | None = None,
    segments: torch.Tensor | None = None,
    remat: bool = False,
    plain_attention: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Token ids ``[B, S]`` -> final hidden states ``[B, S, E]`` + cache.

    ``cache_positions``: an ``int`` start (prefill; all rows aligned) or a
    ``[B]`` tensor of per-row write positions (batched decode, S == 1; a
    slot prefill replayed as a CUDA graph, whose ``cache_row`` is then a
    ``[B]`` device tensor too, :func:`attention_block`).
    ``active [B]`` bool masks rows out of a batched decode: their KV writes
    are dropped, their GDN states stay and their lengths don't advance
    (static-slot serving). ``true_lengths [B]``: the unpadded length of each
    row of a bucket-padded prefill; GDN layers keep the pad steps out of
    their state (attention masks them by position). Buffers are written in
    place; the returned cache shares them and carries the advanced lengths.

    The multimodal hooks, as in crane_tpu: ``inputs_embeds [B, S, E]``
    replaces the embedding lookup (VLM and audio splices); ``rope_embeds``
    (``{"cos", "sin"}`` per token, ``[B, S, R / 2]``) replaces the table
    lookup (MRoPE); ``deepstack`` = (mask ``[B, S]`` bool, embeds
    ``[n, n_visual, E]``) adds visual features at the masked positions
    after each of the first n layers (Qwen3-VL DeepStack; the mask is read
    on the host, so it belongs to a prefill, never to a captured block);
    ``extra_mask`` and ``segments`` go to every attention layer
    (:func:`attention_block`).

    Training, as crane_tpu's: ``remat`` runs each layer under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward
    pass; the cache is written again then, with the same values), and
    ``plain_attention`` sends every attention call to its plain version,
    the kernels having no backward.

    Params sharded over a dp x tp mesh
    (:class:`~crane_tpu_torch.parallel.sharding.ShardedParams`) run
    :func:`~crane_tpu_torch.parallel.inference.sharded_forward_hidden`
    over the matching cache.
    """
    if isinstance(params, ShardedParams):
        if any(a is not None for a in (inputs_embeds, rope_embeds, deepstack, extra_mask,
                                       segments)):
            raise ValueError("a tensor-parallel model takes token ids only")
        from crane_tpu_torch.parallel.inference import sharded_forward_hidden

        return sharded_forward_hidden(
            cfg, params, tokens, cache, cache_positions, rope, read_cache=read_cache,
            cache_row=cache_row, active=active, true_lengths=true_lengths, remat=remat,
            plain_attention=plain_attention)
    B, S = tokens.shape
    positions, write_pos, new_lengths = step_positions(cache, cache_positions, B, S, active,
                                                       tokens.device)
    if rope_embeds is None:
        rope_embeds = rope_rows(rope, positions)
    x = scale_embeds(cfg, params["embed"][tokens.long()] if inputs_embeds is None
                     else inputs_embeds)
    if deepstack is not None:
        visual = deepstack[0].nonzero(as_tuple=True)

    new_layers = list(cache.layers)
    for i in range(cfg.num_layers):
        layer = functools.partial(
            decoder_layer, cfg, params["layers"][i], layer_idx=i, read_cache=read_cache,
            cache_row=cache_row, active=active, true_lengths=true_lengths,
            extra_mask=extra_mask, segments=segments, plain_attention=plain_attention)
        x, new_layers[i] = run_layer(layer, remat, x, cache.layers[i], positions, write_pos,
                                     rope_embeds)
        if deepstack is not None and i < deepstack[1].shape[0]:
            x = x.index_put(visual, deepstack[1][i].to(x.dtype), accumulate=True)
    x = rms_norm(x, params["final_norm"], eps=cfg.rms_norm_eps,
                 weight_offset=cfg.norm_weight_offset)
    return x, KVCache(layers=tuple(new_layers), lengths=new_lengths)


def step_positions(cache: KVCache, cache_positions, B: int, S: int, active, device):
    """(positions ``[B, S]`` int32, the cache write positions, the new
    lengths) of a forward over ``B`` rows of ``S`` tokens: an ``int`` start
    writes every row there; ``[B]`` per-row starts write each row at its
    own, and an inactive row (``active`` False) writes past the buffer,
    which drops the write, and keeps its length."""
    steps = torch.arange(S, dtype=torch.int32, device=device)
    if isinstance(cache_positions, torch.Tensor):
        positions = cache_positions.to(torch.int32)[:, None] + steps[None, :]
        if active is not None:
            return (positions, torch.where(active, cache_positions, cache.max_seq),
                    cache.lengths + active.to(torch.int32))
        return positions, cache_positions, cache.lengths + S
    write_pos = int(cache_positions)
    return (steps + write_pos)[None, :].expand(B, S).contiguous(), write_pos, cache.lengths + S


def rope_rows(rope: dict, positions: torch.Tensor) -> dict:
    """The rope tables' rows at ``positions``. A position past the tables
    reads their last row, as jax's gather clamps it (an index past them
    asserts on the card and ends the process)."""
    idx = positions.long().clamp(max=next(iter(rope.values())).shape[0] - 1)
    return {name: table[idx] for name, table in rope.items()}


def scale_embeds(cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """Embeddings times ``cfg.embed_scale`` (in float32, cast back), where
    the model has one."""
    if cfg.embed_scale is None:
        return x
    return (x.float() * cfg.embed_scale).to(x.dtype)


def run_layer(layer, remat: bool, x, *args):
    """``layer(x, *args)``, under ``torch.utils.checkpoint`` with ``remat``
    (crane_tpu's per-layer ``jax.checkpoint``: activation memory of one
    layer, the layer recomputed in the backward pass)."""
    if remat:
        _import_dynamo_apart()
        return torch.utils.checkpoint.checkpoint(layer, x, *args, use_reentrant=False)
    return layer(x, *args)


def _import_dynamo_apart() -> None:
    """Import ``torch._dynamo``, which checkpoint's first call imports, on a
    thread of its own. That import leaves a reference cycle through the
    stack it runs on (``torch.fx``'s ``wrap`` keeps its own frame), and on
    the forward's stack the cycle would hold the last locals of the forward
    and of its callers (a train step's activations, logits and gradients)
    until the garbage collector next ran."""
    if "torch._dynamo" not in sys.modules:
        thread = threading.Thread(target=importlib.import_module, args=("torch._dynamo",))
        thread.start()
        thread.join()


def lm_logits(cfg: TransformerConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden states to float32 vocab logits (tied or separate head).

    A dense head is read in the hidden states' dtype and the product writes
    float32, as XLA's ``preferred_element_type`` does: bf16 logits would
    round ties into the greedy argmax at 151936 entries. A quantized head
    (``QuantizedWeight``) goes through :func:`linear` (K6 on the card), as
    the reference's does: its output is in the hidden dtype, then float32,
    and the zero columns padding the vocab are sliced off. Params sharded
    over a mesh compute their vocab columns per shard
    (:func:`~crane_tpu_torch.parallel.inference.sharded_lm_logits`)."""
    if isinstance(params, ShardedParams):
        from crane_tpu_torch.parallel.inference import sharded_lm_logits

        return sharded_lm_logits(cfg, params, hidden)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if isinstance(head, QuantizedWeight):
        logits = linear(hidden, head).float()[..., :cfg.vocab_size]
    else:
        logits = matmul_f32(hidden, head.to(hidden.dtype))
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
