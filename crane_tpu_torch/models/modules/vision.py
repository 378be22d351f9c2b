"""Qwen3-VL vision tower: ViT with 2-D RoPE, interpolated position embeds,
2x2 patch merger, DeepStack feature taps.

Port of ``crane_tpu/models/modules/vision.py`` (reference crane-core
``src/models/qwen3_5/vision.rs`` and ``modules/siglip2.rs``). The Conv3d
patch embed (kernel == stride) is one product over flattened patches;
attention is bidirectional over one image, written as plain products and a
softmax, as crane_tpu's is plain XLA (no Pallas kernel, so none is written
here). Host code precomputes only shape-dependent index and weight arrays
(2-D rope positions, bilinear position-embed taps) in numpy, as the
reference does; the forward runs on the parameters' device.

Numerics match HF transformers ``Qwen3VLVisionModel``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int
    hidden_size: int
    intermediate_size: int
    num_heads: int
    patch_size: int
    temporal_patch_size: int
    spatial_merge_size: int
    out_hidden_size: int
    in_channels: int = 3
    num_position_embeddings: int = 2304
    deepstack_indexes: tuple[int, ...] = ()
    eps: float = 1e-6
    act: str = "gelu_tanh"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _act(cfg: VisionConfig, x):
    if cfg.act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if cfg.act == "gelu":
        return F.gelu(x)
    return F.silu(x)


def affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in x's dtype (``[in, out]`` weights)."""
    return x @ w.to(x.dtype) + b.to(x.dtype)


# -- host-side shape-dependent precomputation --------------------------------


def vision_rope_positions(grid_thw: tuple[int, int, int], merge_size: int) -> np.ndarray:
    """(row, col) per patch in merge-block-major order -> ``[S, 2]`` int32."""
    t, h, w = grid_thw
    mh, mw = h // merge_size, w // merge_size
    rows = (
        np.arange(mh)[:, None, None, None] * merge_size
        + np.arange(merge_size)[None, None, :, None]
    )
    cols = (
        np.arange(mw)[None, :, None, None] * merge_size
        + np.arange(merge_size)[None, None, None, :]
    )
    rows = np.broadcast_to(rows, (mh, mw, merge_size, merge_size)).reshape(-1)
    cols = np.broadcast_to(cols, (mh, mw, merge_size, merge_size)).reshape(-1)
    coords = np.stack([rows, cols], axis=-1)
    if t > 1:
        coords = np.tile(coords, (t, 1))
    return coords.astype(np.int32)


def vision_rope_tables(cfg: VisionConfig, grid_thw) -> tuple[np.ndarray, np.ndarray]:
    """Full-width cos/sin ``[S, head_dim]`` from 2-D patch positions (HF
    rot_pos_emb: half from rows, half from cols, duplicated)."""
    dim = cfg.head_dim // 2  # rotary dim per spatial axis (quarter pairs)
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    pos = vision_rope_positions(grid_thw, cfg.spatial_merge_size)  # [S,2]
    freqs = pos[:, :, None].astype(np.float64) * inv[None, None, :]  # [S,2,dim/2]
    half = freqs.reshape(pos.shape[0], -1)  # [S, dim] == [S, head_dim/2]
    emb = np.concatenate([half, half], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def pos_embed_bilinear_taps(
    cfg: VisionConfig, grid_thw
) -> tuple[np.ndarray, np.ndarray]:
    """4-tap bilinear interpolation over the learned grid pos embeds (HF
    fast_pos_embed_interpolate): returns (idx ``[4, S]``, weight ``[4, S]``)
    already permuted to merge-block-major patch order."""
    t, h, w = grid_thw
    side = int(round(cfg.num_position_embeddings ** 0.5))
    h_idx = np.linspace(0, side - 1, h)
    w_idx = np.linspace(0, side - 1, w)
    hf, wf = h_idx.astype(np.int64), w_idx.astype(np.int64)
    hc = np.clip(hf + 1, None, side - 1)
    wc = np.clip(wf + 1, None, side - 1)
    dh, dw = h_idx - hf, w_idx - wf
    idx = np.stack(
        [
            (hf[:, None] * side + wf[None, :]).ravel(),
            (hf[:, None] * side + wc[None, :]).ravel(),
            (hc[:, None] * side + wf[None, :]).ravel(),
            (hc[:, None] * side + wc[None, :]).ravel(),
        ]
    )
    wgt = np.stack(
        [
            ((1 - dh)[:, None] * (1 - dw)[None, :]).ravel(),
            ((1 - dh)[:, None] * dw[None, :]).ravel(),
            (dh[:, None] * (1 - dw)[None, :]).ravel(),
            (dh[:, None] * dw[None, :]).ravel(),
        ]
    )
    # permute from (h, w) raster order to merge-block-major + tile over t
    m = cfg.spatial_merge_size
    order = (
        np.arange(h * w)
        .reshape(h // m, m, w // m, m)
        .transpose(0, 2, 1, 3)
        .reshape(-1)
    )
    idx = np.tile(idx[:, order], (1, t))
    wgt = np.tile(wgt[:, order], (1, t))
    return idx.astype(np.int32), wgt.astype(np.float32)


# -- vision forward ------------------------------------------------------------


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v ``[..., S, H, D]``: every query sees every key. Logits and
    softmax in float32, the PV product in v's dtype, as the reference's
    einsums do it."""
    D = q.shape[-1]
    logits = torch.einsum("...shd,...thd->...hst", q.float(), k.float())
    probs = torch.softmax(logits * (D ** -0.5), dim=-1)
    return torch.einsum("...hst,...thd->...shd", probs.to(v.dtype), v)


def vision_block(cfg: VisionConfig, p: dict, x: torch.Tensor, cos, sin) -> torch.Tensor:
    """One ViT block over ``[S, E]`` (bidirectional, single image); cos/sin
    ``[S, head_dim]`` full-width rotary tables."""
    S = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    h = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.eps)
    q, k, v = affine(h, p["qkv_w"], p["qkv_b"]).reshape(S, 3, H, D).unbind(1)

    def rot(u):
        uf = u.float()
        u1, u2 = uf.chunk(2, dim=-1)
        rotated = torch.cat([-u2, u1], dim=-1)
        return (uf * cos[:, None, :] + rotated * sin[:, None, :]).to(u.dtype)

    o = bidirectional_attention(rot(q), rot(k), v)
    x = x + affine(o.reshape(S, H * D), p["proj_w"], p["proj_b"])
    h = layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.eps)
    h = affine(_act(cfg, affine(h, p["fc1_w"], p["fc1_b"])), p["fc2_w"], p["fc2_b"])
    return x + h


def patch_merger(cfg: VisionConfig, p: dict, x: torch.Tensor, *, postshuffle: bool) -> torch.Tensor:
    """[S, E] -> [S / merge_unit, out_hidden]."""
    width = cfg.merge_unit * cfg.hidden_size
    if postshuffle:
        h = layer_norm(x.reshape(-1, width), p["ln_w"], p["ln_b"], cfg.eps)
    else:
        h = layer_norm(x, p["ln_w"], p["ln_b"], cfg.eps).reshape(-1, width)
    h = F.gelu(affine(h, p["fc1_w"], p["fc1_b"]))
    return affine(h, p["fc2_w"], p["fc2_b"])


def vision_forward(
    cfg: VisionConfig,
    params: dict,
    patches: torch.Tensor,  # [S, patch_dim]
    pos_idx: torch.Tensor,  # [4, S]
    pos_weight: torch.Tensor,  # [4, S]
    rope_cos: torch.Tensor,  # [S, head_dim]
    rope_sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (merged features ``[S / unit, out_hidden]``, deepstack
    features ``[n_taps, S / unit, out_hidden]``)."""
    x = patches.to(params["patch_w"].dtype) @ params["patch_w"] + params["patch_b"]
    pos = torch.einsum("kse,ks->se", params["pos_embed"][pos_idx.long()].float(), pos_weight)
    x = x + pos.to(x.dtype)

    taps = []
    for i in range(cfg.depth):
        x = vision_block(cfg, params["blocks"][i], x, rope_cos, rope_sin)
        if i in cfg.deepstack_indexes:
            j = cfg.deepstack_indexes.index(i)
            taps.append(patch_merger(cfg, params["deepstack"][j], x, postshuffle=True))
    out = patch_merger(cfg, params["merger"], x, postshuffle=False)
    if taps:
        return out, torch.stack(taps)
    return out, out.new_zeros((0,) + tuple(out.shape))
