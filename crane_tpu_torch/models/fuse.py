"""Projection fusion: wq|wk|wv -> wqkv, gate|up -> gate_up (port of
``crane_tpu/models/fuse.py``).

A pure transform of the parameter tree: :func:`attention_block` and
:func:`mlp_block` (``models/modules/transformer.py``) read the fused weight
where it is present and slice the product. Each output column is the same
contraction over the same input as the unfused product, so the result is
the unfused one wherever the product's reduction over the input does not
depend on its width (K6's CUDA-core route; the tensor-core route where the
split of the reduction over a cluster is the same at both widths); cuBLAS
may choose another algorithm for a wider bf16 product.

Off by default, as in crane_tpu: ``CausalLM(fuse=None)`` reads
``CRANE_FUSE_PROJ`` (``"1"`` fuses). On the card, fusion turns three K6
launches a layer into one for q|k|v and two into one for gate|up.

Dense weights fuse where they share a dtype and are 2-D; a
:class:`~crane_tpu_torch.ops.linear.QuantizedWeight` fuses only with
others of equal ``bits``, ``block``, ``packed`` and code rows, so per-channel
int8, packed int4 and GGUF blockwise weights concatenate exactly along the
output axis (codes and scales alike). Biases fuse only when all three are
present. A MoE layer (a ``router``) and a layer with a projection missing
pass through unchanged. No input tree is mutated.

Tensor parallelism splits q, k and v by heads under their own names, so
:class:`~crane_tpu_torch.parallel.inference.ShardedCausalLM` calls
:func:`unfuse_params` first; sequence parallelism keeps the weights whole
on the lead device and keeps the fused layout.
"""

from __future__ import annotations

import torch

from crane_tpu_torch.ops.linear import QuantizedWeight

_QKV = ("wq", "wk", "wv")
_BIASES = ("bq", "bk", "bv")


def _fusable_quant(ws: list) -> bool:
    w0 = ws[0]
    return all(
        isinstance(w, QuantizedWeight)
        and w.bits == w0.bits
        and w.block == w0.block
        and w.packed == w0.packed
        and w.codes.shape[0] == w0.codes.shape[0]
        for w in ws
    )


def _concat_out(ws: list):
    """The weights concatenated along the output axis; None if they do not
    fuse."""
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.dtype for w in ws}) != 1 or any(w.ndim != 2 for w in ws):
            return None
        return torch.cat(ws, dim=1)
    if _fusable_quant(ws):
        w0 = ws[0]
        return QuantizedWeight(codes=torch.cat([w.codes for w in ws], dim=1),
                               scales=torch.cat([w.scales for w in ws], dim=1),
                               block=w0.block, bits=w0.bits)
    return None


def _split_out(w, sizes: list[int]) -> list:
    """The inverse of :func:`_concat_out`: contiguous copies of each part."""
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    if isinstance(w, QuantizedWeight):
        return [QuantizedWeight(codes=w.codes[:, lo:hi].contiguous(),
                                scales=w.scales[:, lo:hi].contiguous(),
                                block=w.block, bits=w.bits)
                for lo, hi in zip(offs, offs[1:])]
    return [w[:, lo:hi].contiguous() for lo, hi in zip(offs, offs[1:])]


def qkv_sizes(cfg) -> list[int]:
    """The output widths of q, k and v in a fused ``wqkv``: q is twice as
    wide under ``attn_output_gate`` (``[query | gate]`` per head)."""
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return [H * D * (2 if cfg.attn_output_gate else 1), Hkv * D, Hkv * D]


def fuse_layer(layer: dict) -> dict:
    """One decoder layer's projections fused, as a new dict. Layers whose
    weights do not fuse (mixed dtypes, some biases only, a MoE MLP) pass
    through; the split sizes come from the config at forward time."""
    out = dict(layer)
    attn = layer.get("attn")
    if attn is not None and all(k in attn for k in _QKV):
        biases = [attn.get(b) for b in _BIASES]
        n_bias = sum(b is not None for b in biases)
        fused = _concat_out([attn[k] for k in _QKV])
        if fused is not None and n_bias in (0, 3):
            a = {k: v for k, v in attn.items() if k not in _QKV + _BIASES}
            a["wqkv"] = fused
            if n_bias == 3:
                a["bqkv"] = torch.cat(biases)
            out["attn"] = a
    mlp = layer.get("mlp")
    if (mlp is not None and "gate" in mlp and "up" in mlp and "router" not in mlp
            and mlp["gate"].shape[1] == mlp["up"].shape[1]):
        fused = _concat_out([mlp["gate"], mlp["up"]])
        if fused is not None:
            m = {k: v for k, v in mlp.items() if k not in ("gate", "up")}
            m["gate_up"] = fused
            out["mlp"] = m
    return out


def unfuse_layer(cfg, layer: dict) -> dict:
    """The inverse of :func:`fuse_layer` (a new dict): ``wqkv`` split at
    :func:`qkv_sizes`, ``gate_up`` in halves."""
    out = dict(layer)
    attn = layer.get("attn")
    if attn is not None and "wqkv" in attn:
        a = {k: v for k, v in attn.items() if k not in ("wqkv", "bqkv")}
        sizes = qkv_sizes(cfg)
        a["wq"], a["wk"], a["wv"] = _split_out(attn["wqkv"], sizes)
        if "bqkv" in attn:
            a["bq"], a["bk"], a["bv"] = (b.contiguous() for b in attn["bqkv"].split(sizes))
        out["attn"] = a
    mlp = layer.get("mlp")
    if mlp is not None and "gate_up" in mlp:
        m = {k: v for k, v in mlp.items() if k != "gate_up"}
        half = mlp["gate_up"].shape[1] // 2
        m["gate"], m["up"] = _split_out(mlp["gate_up"], [half, half])
        out["mlp"] = m
    return out


def fuse_params(params: dict) -> dict:
    """Every decoder layer's projections fused; other entries untouched."""
    if "layers" not in params:
        return params
    return {**params, "layers": tuple(fuse_layer(l) for l in params["layers"])}


def unfuse_params(cfg, params: dict) -> dict:
    """Every decoder layer's fused projections split again."""
    if "layers" not in params:
        return params
    return {**params, "layers": tuple(unfuse_layer(cfg, l) for l in params["layers"])}
