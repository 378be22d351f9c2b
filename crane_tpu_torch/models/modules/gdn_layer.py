"""Gated-Delta-Net layer: projections, conv, recurrence, gated norm (port of
``crane_tpu/models/modules/gdn_layer.py``).

in_proj -> depthwise causal conv1d (k=4) per part -> split heads -> L2-norm
q, k -> beta/g -> recurrence -> RMSNorm(y) * silu(z) -> out_proj. The
projection columns follow HF's interleaved, k-head-major order: each k-head
block carries ``[q | k | v_group | z_group]``. The recurrence of a fresh
prefill or a continuation chunk goes through
:func:`~crane_tpu_torch.ops.gdn.gdn_recurrence` (K7 on the card); decode
runs the one-step recurrence in plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from crane_tpu_torch.ops.gdn import (
    causal_conv1d,
    causal_conv1d_update,
    compute_beta_g,
    gdn_decode_step,
    gdn_recurrence,
)
from crane_tpu_torch.ops.cuda.quant_matmul import matmul_f32
from crane_tpu_torch.ops.kv_cache import GdnLayerCache
from crane_tpu_torch.ops.linear import linear
from crane_tpu_torch.ops.norm import gated_rms_norm


@dataclasses.dataclass(frozen=True)
class GdnConfig:
    num_v_heads: int
    num_k_heads: int
    head_k_dim: int
    head_v_dim: int
    conv_kernel: int = 4

    @property
    def key_dim(self) -> int:
        return self.num_k_heads * self.head_k_dim

    @property
    def value_dim(self) -> int:
        return self.num_v_heads * self.head_v_dim

    @property
    def conv_dim(self) -> int:
        return 2 * self.key_dim + self.value_dim

    @property
    def v_per_group(self) -> int:
        return self.num_v_heads // self.num_k_heads


def split_qkvz_ba(g: GdnConfig, qkvz: torch.Tensor, ba: torch.Tensor):
    """HF ``fix_query_key_value_ordering``: the k-head-grouped projection
    outputs -> (q ``[B,S,Hk,K]``, k ``[B,S,Hk,K]``, v ``[B,S,Hv,V]``,
    z ``[B,S,Hv,V]``, b/a ``[B,S,Hv]``)."""
    B, S, _ = qkvz.shape
    Hk, K, V, vg = g.num_k_heads, g.head_k_dim, g.head_v_dim, g.v_per_group
    blk = qkvz.reshape(B, S, Hk, 2 * K + 2 * vg * V)
    q = blk[..., :K]
    k = blk[..., K:2 * K]
    v = blk[..., 2 * K:2 * K + vg * V].reshape(B, S, g.num_v_heads, V)
    z = blk[..., 2 * K + vg * V:].reshape(B, S, g.num_v_heads, V)
    bab = ba.reshape(B, S, Hk, 2 * vg)
    b = bab[..., :vg].reshape(B, S, g.num_v_heads)
    a = bab[..., vg:].reshape(B, S, g.num_v_heads)
    return q, k, v, z, b, a


def gdn_block(
    gcfg: GdnConfig,
    p: dict,
    x: torch.Tensor,
    layer_cache: GdnLayerCache,
    *,
    eps: float = 1e-6,
    decode: bool = False,
    cache_row: int | None = None,
    active: torch.Tensor | None = None,
    backend: str | None = None,
    true_lengths: torch.Tensor | None = None,
    continuation: bool = False,
    partial: bool = False,
):
    """x ``[B, S, E]`` -> (out ``[B, S, E]``, the layer cache, written in
    place).

    ``decode=True``: S must be 1; the rolling conv state and the one-step
    recurrence. Otherwise a fresh prefill from position 0 (zero initial
    state: a slot prefill always restarts its row), unless
    ``continuation=True``, which re-enters the cached recurrent state and
    conv window (chunk N continues where chunk N-1 stopped, so chunked
    prefill equals whole prefill; the cache rows must line up with the
    batch, so ``cache_row`` must be None). ``true_lengths [B]`` masks
    bucket-padded tail steps out of the state: they get beta=0, g=0 (the
    identity update) and the conv window ends at the true length.
    ``partial``: a tensor-parallel shard's product over its rows of
    ``out_proj``, returned in float32."""
    if continuation and (decode or cache_row is not None):
        raise ValueError("continuation excludes decode/cache_row (documented contract)")
    B, S, _ = x.shape
    qkvz = linear(x, p["in_proj_qkvz"])
    ba = linear(x, p["in_proj_ba"])
    q, k, v, z, b, a = split_qkvz_ba(gcfg, qkvz, ba)

    # the depthwise conv runs per part (q, k, v) on static channel slices
    # of the conv weight; only the rolling state keeps the concatenated
    # [Q|K|V] channel layout
    kd, vd = gcfg.key_dim, gcfg.value_dim
    wq, wk, wv = p["conv_w"][:kd], p["conv_w"][kd:2 * kd], p["conv_w"][2 * kd:]
    qf, kf, vf = q.reshape(B, S, kd), k.reshape(B, S, kd), v.reshape(B, S, vd)

    cs = layer_cache.conv_state
    if decode:
        if cache_row is not None:
            raise ValueError("decode with cache_row unsupported")
        yq, sq = causal_conv1d_update(qf[:, 0], cs[..., :kd], wq)
        yk, sk = causal_conv1d_update(kf[:, 0], cs[..., kd:2 * kd], wk)
        yv, sv = causal_conv1d_update(vf[:, 0], cs[..., 2 * kd:], wv)
        qc, kc, vc = yq[:, None], yk[:, None], yv[:, None]
    else:
        # a continuation re-enters the saved window per part; a fresh
        # prefill left-pads with zeros
        iwq, iwk, iwv = ((cs[..., :kd], cs[..., kd:2 * kd], cs[..., 2 * kd:])
                         if continuation else (None, None, None))
        qc, sq = causal_conv1d(qf, wq, true_lengths=true_lengths, init_window=iwq)
        kc, sk = causal_conv1d(kf, wk, true_lengths=true_lengths, init_window=iwk)
        vc, sv = causal_conv1d(vf, wv, true_lengths=true_lengths, init_window=iwv)
    new_conv = torch.cat([sq, sk, sv], dim=-1)

    qc = qc.reshape(B, S, gcfg.num_k_heads, gcfg.head_k_dim)
    kc = kc.reshape(B, S, gcfg.num_k_heads, gcfg.head_k_dim)
    vc = vc.reshape(B, S, gcfg.num_v_heads, gcfg.head_v_dim)

    beta, gdecay = compute_beta_g(b, a, p["A_log"], p["dt_bias"])
    if not decode and true_lengths is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < true_lengths.to(x.device)[:, None])[..., None]
        beta = beta * valid
        gdecay = gdecay * valid
    if gcfg.v_per_group > 1:
        qc = qc.repeat_interleave(gcfg.v_per_group, dim=2)
        kc = kc.repeat_interleave(gcfg.v_per_group, dim=2)

    if decode:
        y, new_state = gdn_decode_step(qc[:, 0], kc[:, 0], vc[:, 0], gdecay[:, 0], beta[:, 0],
                                       layer_cache.recurrent_state)
        y = y[:, None]
    else:
        init = layer_cache.recurrent_state if continuation else None
        y, new_state = gdn_recurrence(qc, kc, vc, gdecay, beta, init, backend=backend)

    new_cache = layer_cache.replace_rows(new_conv, new_state, row=cache_row, active=active)

    y = gated_rms_norm(y, z, p["norm"], eps=eps).reshape(B, S, gcfg.value_dim)
    if partial:
        return matmul_f32(y, p["out_proj"].to(y.dtype)), new_cache
    return linear(y, p["out_proj"]), new_cache
