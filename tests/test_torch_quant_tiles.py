"""A CPU rehearsal of the numerics of the bf16 tensor-core K5 and K6
(``crane_tpu_torch/csrc/quant_cached_attention_mma.cu``,
``crane_tpu_torch/csrc/quant_matmul_mma.cu``).

The kernels cannot run here, so their arithmetic is emulated in a few lines
of PyTorch and held against the plain versions (what the kernels are
compared with on the card) within ``chip_smoke.py``'s kernel bound.

- K5: the int8 / int4 codes as exact bf16 values; ``S = q code^T`` in
  float32 over key tiles of 64 (32 at head_dim 256), times each key's K
  scale, then the scale, softcap and mask; the online max and sum per tile;
  ``P' = p * v_scale`` entering ``P' code_v`` as two bf16 operands (hi +
  lo) while ``l`` sums the unscaled ``p``; a row that sees no key left at
  zeros with ``m = -inf`` and ``l = 0``. Ragged S, G = 1..16, windows,
  softcap, tails past ``T - 1`` and negative positions (K5-S).
- K6: bf16 x times bf16 codes summed in float32 one 16-deep k-step at a
  time, int4's two k-steps per staged byte tile (the low codes with
  ``x[:, i]``, the high ones with ``x[:, i + I/2]``), the column scale at
  the end, the output rounded to bf16.

It also records how one bf16 rounding of ``p * v_scale`` (the TPU kernel's
form) fares against the same bound.
"""

import math

import pytest
import torch

from crane_tpu_torch.ops.cuda import quant_attention as k45
from crane_tpu_torch.ops.cuda.build import KERNEL_ATOL, KERNEL_RTOL
from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul_plain
from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache, dequant_codes
from crane_tpu_torch.ops.linear import quantize_weight, unpack_int4_rows

torch.set_num_threads(2)

# the with-stats m and l against the plain float32 statistics (as on the card)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def k5_tile_loop(q, cache: QuantLayerKVCache, pos, *, scale, window=None, softcap=None,
                 pv="split"):
    """The kernel's tile loop on the CPU. q ``[B, S, Hq, D]`` bf16 at
    positions ``pos [B, S]`` (clamped to ``T - 1`` as the kernel clamps);
    the cache's codes and scales. ``pv`` how ``P' = p * v_scale`` enters
    ``P' V``: ``"split"`` as the kernel takes it (hi + lo bf16 operands), or
    ``"bf16"`` rounded once. Returns ``(out in q's dtype, m, l)`` with m, l
    ``[B, Hq, S]`` float32."""
    B, S, Hq, D = q.shape
    Hkv, T = cache.k_scale.shape[1], cache.k_scale.shape[2]
    G = Hq // Hkv
    block_k = 32 if D > 128 else 64
    ones = torch.ones_like(cache.k_scale)
    kc = dequant_codes(cache.k, ones, cache.bits, Hkv).permute(0, 2, 1, 3)  # [B, Hkv, T, D]
    vc = dequant_codes(cache.v, ones, cache.bits, Hkv).permute(0, 2, 1, 3)
    p = pos.to(torch.int64).clamp(max=T - 1)
    # rows stacked as the block stacks them: [B, Hkv, S * G] (position-major)
    qr = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * G, D)
    prow = p.repeat_interleave(G, dim=1)[:, None, :, None]
    m = torch.full((B, Hkv, S * G, 1), -math.inf)
    l = torch.zeros(B, Hkv, S * G, 1)
    o = torch.zeros(B, Hkv, S * G, D)
    for kt in range(0, T, block_k):
        kk, vv = kc[:, :, kt:kt + block_k], vc[:, :, kt:kt + block_k]
        ks = cache.k_scale[:, :, None, kt:kt + block_k]
        vs = cache.v_scale[:, :, None, kt:kt + block_k]
        t = torch.arange(kt, kt + kk.shape[2])[None, None, None, :]
        s = (qr @ kk.transpose(-1, -2)) * ks  # float32 sums of exact bf16 products
        s = softcap * torch.tanh(s * (scale / softcap)) if softcap else s * scale
        ok = t <= prow
        if window is not None:
            ok = ok & (t > prow - window)
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)  # never -inf - -inf
        alpha = torch.exp(m - m_use)
        pr = torch.exp(s - m_use)
        l = l * alpha + pr.sum(dim=-1, keepdim=True)
        pv_ = pr * vs
        if pv == "split":
            hi = pv_.to(torch.bfloat16).float()
            o = o * alpha + hi @ vv + (pv_ - hi).to(torch.bfloat16).float() @ vv
        else:
            o = o * alpha + pv_.to(torch.bfloat16).float() @ vv
        m = m_new
    out = torch.where(l > 0, o / l.clamp(min=1e-30), 0.0)
    out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)

    def heads(x):  # [B, Hkv, S*G, 1] -> [B, Hq, S]
        return x.reshape(B, Hkv, S, G).permute(0, 1, 3, 2).reshape(B, Hq, S)

    return out.to(q.dtype), heads(m), heads(l)


def k6_tile_loop(x, w):
    """K6's arithmetic on the CPU: bf16 x ``[M, I]`` times the codes as
    bf16, summed in float32 one 16-deep k-step at a time in the kernel's
    order (int4: per 64-row byte tile, the low codes' k-steps then the high
    codes'), times the column scale, rounded to bf16."""
    codes = (unpack_int4_rows(w.codes) if w.bits == 4 else w.codes).float()
    I = codes.shape[0]
    xf = x.float()
    halves = 2 if w.bits == 4 else 1
    rows = I // halves
    acc = torch.zeros(x.shape[0], codes.shape[1])
    for i0 in range(0, rows, 64):
        for h in range(halves):
            for k in range(i0, min(i0 + 64, rows), 16):
                lo, hi = h * rows + k, h * rows + min(k + 16, i0 + 64, rows)
                acc = acc + xf[:, lo:hi] @ codes[lo:hi]
    return (acc * w.scales.reshape(1, -1)).to(x.dtype)


def rnd(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def assert_kernel_bound(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def make_cache(gen, B, T, Hkv, D, bits):
    cache = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits)
    cache.update(rnd(gen, B, T, Hkv, D), rnd(gen, B, T, Hkv, D), 0)
    return cache


OPTIONS = [{}, {"window": 1}, {"window": 7}, {"window": 100}, {"softcap": 5.0}]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 8), (128, 16, 8), (256, 8, 2), (64, 16, 1),
                                     (128, 8, 2)])
@pytest.mark.parametrize("S", [1, 17, 77])
def test_k5_tile_loop_matches_plain(bits, D, Hq, Hkv, S):
    """K5 rows at different offsets per batch row, one running past T - 1
    (clamped), T not a multiple of the key tile, every option."""
    gen = torch.Generator().manual_seed(S + D * Hq + bits)
    T = 301
    cache = make_cache(gen, 2, T, Hkv, D, bits)
    q = rnd(gen, 2, S, Hq, D)
    pos = torch.stack([torch.arange(S) + 40, torch.arange(S) + T - 10]).to(torch.int32)
    ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    for kw in OPTIONS:
        got = k5_tile_loop(q, cache, pos, scale=D ** -0.5, window=kw.get("window"),
                           softcap=kw.get("softcap"))[0]
        ref = k45.quant_cached_attention_plain(q.float(), *ops, pos, bits=bits, scale=D ** -0.5,
                                               window=kw.get("window"),
                                               logit_softcap=kw.get("softcap"))
        assert_kernel_bound(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 4), (256, 8, 2)])
@pytest.mark.parametrize("start", [-500, -30, 0, 290])
def test_k5s_tile_loop_stats_match_plain(bits, D, Hq, Hkv, start):
    """K5-S at slab-local starts wholly before, into, inside and past a
    300-slot slab: out to the kernel bound, m and l to the stats bound where
    a row saw a key, and (0, -inf, 0) where none did."""
    gen = torch.Generator().manual_seed(D + start + bits)
    S, T = 77, 300
    cache = make_cache(gen, 1, T, Hkv, D, bits)
    q = rnd(gen, 1, S, Hq, D)
    pos = (torch.arange(S) + start).to(torch.int32)[None]
    out, m, l = k5_tile_loop(q, cache, pos, scale=D ** -0.5)
    r_out, r_m, r_l = k45.quant_cached_attention_with_stats_plain(
        q.float(), cache.k, cache.v, cache.k_scale, cache.v_scale, pos, bits=bits,
        scale=D ** -0.5)
    assert_kernel_bound(out, r_out)
    seen = r_l > 0
    torch.testing.assert_close(m[seen], r_m[seen], **STATS_TOL)
    torch.testing.assert_close(l[seen], r_l[seen], **STATS_TOL)
    assert (l[~seen] == 0).all() and (m[~seen] == -math.inf).all()
    assert (out.float().transpose(1, 2)[~seen] == 0).all()


def test_one_bf16_rounding_of_scaled_p():
    """The kernel enters P' = p * v_scale as hi + lo bf16 operands. Rounded
    once to bf16 instead (as the TPU kernel rounds it), P' moves the output
    of rows that see few keys by up to 2^-9 sum p |v| / l, as K3's P does:
    past the kernel bound on a window of 7, where the split form stays well
    inside it on the same inputs."""
    gen = torch.Generator().manual_seed(7)
    S, T, D, Hq, Hkv = 300, 300, 64, 8, 4
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    ratios = {}
    for bits in (8, 4):
        cache = make_cache(gen, 2, T, Hkv, D, bits)
        q = rnd(gen, 2, S, Hq, D)
        ref = k45.quant_cached_attention_plain(q.float(), cache.k, cache.v, cache.k_scale,
                                               cache.v_scale, pos, bits=bits, scale=D ** -0.5,
                                               window=7).float()
        bound = KERNEL_ATOL + KERNEL_RTOL * ref.abs()
        for form in ("bf16", "split"):
            got = k5_tile_loop(q, cache, pos, scale=D ** -0.5, window=7, pv=form)[0]
            ratios[(bits, form)] = ((got.float() - ref).abs() / bound).max().item()
    assert all(ratios[(b, "bf16")] > 1.0 and ratios[(b, "split")] < 0.6 for b in (8, 4)), ratios


@pytest.mark.parametrize("kw", [{}, {"window": 5}, {"softcap": 5.0}], ids=["plain", "window",
                                                                        "softcap"])
def test_k5_tile_loop_without_rounding_is_the_plain_softmax(kw):
    """The emulation's own check: with q in float32 and P' kept in float32
    (hi + lo carries it to 2^-17), the tile loop with its scales folded in
    is the plain softmax to float32 rounding."""
    gen = torch.Generator().manual_seed(5)
    S, T, D = 130, 200, 64
    cache = make_cache(gen, 2, T, 2, D, 8)
    q = torch.randn(2, S, 4, D, generator=gen)
    pos = torch.stack([torch.arange(S) - 20, torch.arange(S) + 100]).to(torch.int32)
    got, m, l = k5_tile_loop(q, cache, pos, scale=D ** -0.5, window=kw.get("window"),
                             softcap=kw.get("softcap"))
    ref, r_m, r_l = k45.quant_cached_attention_with_stats_plain(
        q, cache.k, cache.v, cache.k_scale, cache.v_scale, pos, bits=8, scale=D ** -0.5,
        window=kw.get("window"), logit_softcap=kw.get("softcap"))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(m, r_m, **STATS_TOL)
    torch.testing.assert_close(l, r_l, **STATS_TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,I,O", [(16, 1024, 3072), (17, 3072, 1024), (100, 1008, 1040),
                                   (256, 1024, 2048), (64, 96, 48)])
def test_k6_tile_loop_matches_plain(bits, M, I, O):
    """K6 at chunk-sized M on the path's shapes, an I that is not a
    multiple of 32 and an O that is not a multiple of the output tile."""
    gen = torch.Generator().manual_seed(M + I + O + bits)
    w = quantize_weight(torch.randn(I, O, generator=gen) * I ** -0.5, bits=bits)
    x = rnd(gen, M, I)
    assert_kernel_bound(k6_tile_loop(x, w), quant_matmul_plain(x.float(), w.codes, w.scales,
                                                               bits=bits))
