"""A CPU rehearsal of the numerics of the bf16 tensor-core K2/K3 kernel
(``crane_tpu_torch/csrc/flash_attention_mma.cu``).

The kernel cannot run here, so its arithmetic is emulated in a few lines of
PyTorch: bf16 inputs, float32 logits ``S = q k^T`` over key tiles of 64 (32
at head_dim 256), masking, softcap and the online max and sum per tile in
float32, ``P`` entering ``P V`` as two bf16 operands (hi = bf16(P), lo =
bf16(P - hi)) while ``l`` sums the float32 ``P``, a row that sees no key
left at zeros with ``m = -inf`` and ``l = 0``. The emulation is held against the plain versions (what the
kernel is compared with on the card) within ``chip_smoke.py``'s kernel
bound, for every option: ragged S, G = 1..8, windows down to 1, softcap,
segments above the diagonal, K3 rows at different offsets, a tail past
``T - 1`` and negative positions (K3-S).
"""

import math

import pytest
import torch

from crane_tpu_torch.ops.cuda import flash_attention as k23
from crane_tpu_torch.ops.cuda.build import KERNEL_ATOL, KERNEL_RTOL

torch.set_num_threads(2)

# the with-stats m and l against the plain float32 statistics (as on the card)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def tile_loop(q, k, v, pos, seg=None, *, scale, window=None, softcap=None,
              p_dtype="split"):
    """The kernel's tile loop on the CPU. q ``[B, S, Hq, D]``, k/v ``[B, T,
    Hkv, D]`` (bf16 on the kernel's route); ``pos [B, S]`` each row's
    position (K2: 0..S-1 with T == S; K3: clamped to T - 1 here, as the
    kernel clamps); ``seg [B, S]`` K2's segment ids; ``p_dtype`` how P enters
    ``P V``: ``"split"`` as the kernel takes it (hi = bf16(P) and lo =
    bf16(P - hi), two products), or rounded once to a dtype. Returns ``(out in q's dtype, m, l)`` with
    m, l ``[B, Hq, S]`` float32."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    block_k = 32 if D > 128 else 64
    p = pos.to(torch.int64).clamp(max=T - 1)
    # rows stacked as the block stacks them: [B, Hkv, S * G] (position-major)
    qr = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, S * G, D)
    prow = p.repeat_interleave(G, dim=1)[:, None, :, None]  # [B, 1, S*G, 1]
    m = torch.full((B, Hkv, S * G, 1), -math.inf)
    l = torch.zeros(B, Hkv, S * G, 1)
    o = torch.zeros(B, Hkv, S * G, D)
    for kt in range(0, T, block_k):
        kk = k[:, kt:kt + block_k].float().permute(0, 2, 1, 3)  # [B, Hkv, BK, D]
        vv = v[:, kt:kt + block_k].float().permute(0, 2, 1, 3)
        t = torch.arange(kt, kt + kk.shape[2])[None, None, None, :]
        s = qr @ kk.transpose(-1, -2)  # float32 sums of exact bf16 products
        s = softcap * torch.tanh(s * (scale / softcap)) if softcap else s * scale
        ok = t <= prow
        if window is not None:
            ok = ok & (t > prow - window)
        if seg is not None:
            sq = seg.to(torch.int64).repeat_interleave(G, dim=1)[:, None, :, None]
            sk = seg.to(torch.int64)[:, None, None, kt:kt + block_k]
            ok = ok | ((sq > 0) & (sk == sq))
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)  # never -inf - -inf
        alpha = torch.exp(m - m_use)
        pr = torch.exp(s - m_use)
        l = l * alpha + pr.sum(dim=-1, keepdim=True)
        if p_dtype == "split":  # P = hi + lo, two bf16 operands
            hi = pr.to(torch.bfloat16).float()
            o = o * alpha + hi @ vv + (pr - hi).to(torch.bfloat16).float() @ vv
        else:
            o = o * alpha + pr.to(p_dtype).float() @ vv
        m = m_new
    out = torch.where(l > 0, o / l.clamp(min=1e-30), 0.0)
    out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)

    def heads(x):  # [B, Hkv, S*G, 1] -> [B, Hq, S]
        return x.reshape(B, Hkv, S, G).permute(0, 1, 3, 2).reshape(B, Hq, S)

    return out.to(q.dtype), heads(m), heads(l)


def rnd(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def assert_kernel_bound(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


OPTIONS = [
    ({}, "plain"),
    ({"window": 1}, "window 1"),
    ({"window": 7}, "window 7"),
    ({"window": 100}, "window 100"),
    ({"softcap": 5.0}, "softcap"),
]


@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 300])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 4, 4), (64, 8, 4), (128, 8, 2), (64, 8, 1),
                                     (256, 4, 1)])
def test_k2_tile_loop_matches_plain(S, D, Hq, Hkv):
    """K2 at each ragged S and G in {1, 2, 4, 8} with every option, and
    segments with a run above the diagonal."""
    gen = torch.Generator().manual_seed(S * D + Hq)
    q, k, v = rnd(gen, 2, S, Hq, D), rnd(gen, 2, S, Hkv, D), rnd(gen, 2, S, Hkv, D)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    for kw, _ in OPTIONS:
        got = tile_loop(q, k, v, pos, scale=D ** -0.5, **kw)[0]
        assert_kernel_bound(got, k23.flash_attention_causal_plain(q, k, v, scale=D ** -0.5, **kw))
    seg = torch.zeros(2, S, dtype=torch.int32)
    seg[1, S // 4:] = 3  # row 1's run attends keys far above its queries' diagonal
    seg[0, : S // 2] = 1
    got = tile_loop(q, k, v, pos, seg, scale=D ** -0.5, window=7)[0]
    assert_kernel_bound(got, k23.flash_attention_causal_plain(q, k, v, seg, scale=D ** -0.5,
                                                              window=7))


@pytest.mark.parametrize("S", [1, 17, 65, 300])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 8), (128, 8, 2), (64, 8, 1), (256, 8, 2)])
def test_k3_tile_loop_matches_plain(S, D, Hq, Hkv):
    """K3 rows at different offsets per batch row, one running past T - 1
    (clamped), with every option."""
    gen = torch.Generator().manual_seed(S + D * Hq)
    T = 400
    q, kc, vc = rnd(gen, 2, S, Hq, D), rnd(gen, 2, T, Hkv, D), rnd(gen, 2, T, Hkv, D)
    pos = torch.stack([torch.arange(S) + 40, torch.arange(S) + 350]).to(torch.int32)
    for kw, _ in OPTIONS:
        got = tile_loop(q, kc, vc, pos, scale=D ** -0.5, **kw)[0]
        assert_kernel_bound(got, k23.flash_attention_cached_plain(q, kc, vc, pos,
                                                                  scale=D ** -0.5, **kw))


@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 4), (256, 8, 2)])
@pytest.mark.parametrize("start", [-500, -30, 0, 290])
def test_k3s_tile_loop_stats_match_plain(D, Hq, Hkv, start):
    """K3-S at slab-local starts wholly before, into, inside and past a
    300-slot slab: out to the kernel bound, m and l to the stats bound where
    a row saw a key, and (0, -inf, 0) where none did."""
    gen = torch.Generator().manual_seed(D + start)
    S, T = 77, 300
    q, kc, vc = rnd(gen, 1, S, Hq, D), rnd(gen, 1, T, Hkv, D), rnd(gen, 1, T, Hkv, D)
    pos = (torch.arange(S) + start).to(torch.int32)[None]
    out, m, l = tile_loop(q, kc, vc, pos, scale=D ** -0.5)
    r_out, r_m, r_l = k23.flash_attention_cached_with_stats_plain(q, kc, vc, pos,
                                                                  scale=D ** -0.5)
    assert_kernel_bound(out, r_out)
    seen = r_l > 0
    torch.testing.assert_close(m[seen], r_m[seen], **STATS_TOL)
    torch.testing.assert_close(l[seen], r_l[seen], **STATS_TOL)
    assert (l[~seen] == 0).all() and (m[~seen] == -math.inf).all()
    assert (out.float().transpose(1, 2)[~seen] == 0).all()


def test_one_bf16_rounding_of_p_exceeds_the_kernel_bound():
    """Why the kernel splits P into hi + lo: rounded once to bf16 (2^-9
    relative), P moves the output of rows that see few keys past the bound
    the kernel is held to; the split form stays inside it on the same
    inputs."""
    S, D, Hq, Hkv = 300, 64, 8, 4
    gen = torch.Generator().manual_seed(S * D + Hq)
    q, k, v = rnd(gen, 2, S, Hq, D), rnd(gen, 2, S, Hkv, D), rnd(gen, 2, S, Hkv, D)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    ref = k23.flash_attention_causal_plain(q, k, v, scale=D ** -0.5, window=7).float()
    bound = KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    ratios = {}
    for form in ("bf16", "split"):
        p_dtype = torch.bfloat16 if form == "bf16" else "split"
        got = tile_loop(q, k, v, pos, scale=D ** -0.5, window=7, p_dtype=p_dtype)[0]
        ratios[form] = ((got.float() - ref).abs() / bound).max().item()
    assert ratios["bf16"] > 1.5 and ratios["split"] < 0.6, ratios


@pytest.mark.parametrize("kw", [{}, {"window": 5}, {"softcap": 5.0}], ids=["plain", "window",
                                                                        "softcap"])
def test_tile_loop_without_rounding_is_the_plain_softmax(kw):
    """The emulation's own check: in float32 with P kept in float32, the
    tile loop (online rescale across tiles, masks, empty rows) is the plain
    softmax to float32 rounding, so the bound above measures the bf16
    rounding of P and of the output alone."""
    gen = torch.Generator().manual_seed(5)
    S, T, D = 130, 200, 64
    q, k, v = (torch.randn(2, n, h, D, generator=gen) for n, h in ((S, 4), (T, 2), (T, 2)))
    pos = torch.stack([torch.arange(S) - 20, torch.arange(S) + 100]).to(torch.int32)
    got, m, l = tile_loop(q, k, v, pos, scale=D ** -0.5, p_dtype=torch.float32, **kw)
    ref, r_m, r_l = k23.flash_attention_cached_with_stats_plain(q, k, v, pos, scale=D ** -0.5,
                                                                **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m, r_m, **STATS_TOL)
    torch.testing.assert_close(l, r_l, **STATS_TOL)
