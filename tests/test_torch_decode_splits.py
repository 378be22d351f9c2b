"""A CPU rehearsal of the split-KV decode kernels K1 and K4 and their
with-stats forms (``crane_tpu_torch/csrc/decode_attention.cuh``).

The kernel cannot run here, so what the split adds is emulated in a few
lines of PyTorch: block s of a (row, kv-head) takes the s-th of n even
shares of the row's live range ``[lo, valid)``, computed from ``kv_valid``,
the window and T exactly as the kernel computes it; each share gives a
float32 partial (max m, sum l, unnormalised output acc), ``m = -inf``,
``l = 0``, ``acc = 0`` where it saw no key; the partials merge by the
log-sum-exp combine (``merge_split_states`` in ``common.cuh``), a row no
share saw writing zeros with ``m = -inf`` and ``l = 0``. The emulation is
held against the plain versions (what the kernels are compared with on the
card) and against crane_tpu's Pallas kernels in interpret mode, within
the kernel bound (``build.KERNEL_ATOL``/``KERNEL_RTOL``): empty rows, one live token, fewer live
tokens than splits, windows across split boundaries and of 1, softcap, G
1..8, head dims 64/128/256 and fp, int8 and int4 caches. The split count
itself, :func:`decode_splits`, is held over the served shapes.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_tpu.ops.kv_cache import QuantLayerKVCache as JQCache
from crane_tpu.ops.pallas import quant_attention as jqa
from crane_tpu_torch.ops.cuda import decode_attention as k1
from crane_tpu_torch.ops.cuda import quant_attention as k45
from crane_tpu_torch.ops.cuda.build import KERNEL_ATOL, KERNEL_RTOL
from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache, dequant_codes

torch.set_num_threads(2)

# an H100 SXM's SMs
N_SMS = 132
# the with-stats m and l against the plain float32 statistics (as on the card)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
# the kv-heads of the served models: Qwen3.5-0.8B 2, Qwen3-0.6B 8, and the
# other configurations of the zoo (1, 4, 16)
ZOO_HKV = (1, 2, 4, 8, 16)


def split_bounds(valid: int, window: int | None, T: int, n: int) -> list[tuple[int, int]]:
    """The ``[t_lo, t_hi)`` of each of a row's n blocks, as the kernel
    computes them."""
    valid = min(max(valid, 0), T)
    lo = max(0, valid - window) if window else 0
    share = -(-(valid - lo) // n)
    bounds = []
    for s in range(n):
        t_lo = min(valid, lo + s * share)
        bounds.append((t_lo, min(valid, t_lo + share)))
    return bounds


def split_decode(q, k, v, kv_valid, n, *, scale, window=None, softcap=None):
    """The kernel's split and merge on the CPU. q ``[B, 1, Hq, D]``; k/v
    ``[B, T, Hkv, D]`` (dequantized in float32 for K4). Returns ``(out in
    q's dtype, m, l)``, m and l ``[B, Hq]`` float32."""
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float()[:, 0].reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    M = torch.full((B, Hkv, G), -math.inf)
    L = torch.zeros(B, Hkv, G)
    for b in range(B):
        accs, ms, ls = [], [], []
        for t_lo, t_hi in split_bounds(int(kv_valid[b]), window, T, n):
            if t_hi == t_lo:  # a share that sees no key weighs 0
                accs.append(torch.zeros(Hkv, G, D))
                ms.append(torch.full((Hkv, G), -math.inf))
                ls.append(torch.zeros(Hkv, G))
                continue
            kk = k[b, t_lo:t_hi].float().transpose(0, 1)  # [Hkv, n_t, D]
            vv = v[b, t_lo:t_hi].float().transpose(0, 1)
            s = (qf[b] @ kk.transpose(1, 2)) * scale  # [Hkv, G, n_t]
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            accs.append(p @ vv)
            ms.append(m)
            ls.append(p.sum(dim=-1))
        acc, m, l = torch.stack(accs), torch.stack(ms), torch.stack(ls)  # [n, Hkv, G, (D)]
        Mb = m.amax(dim=0)
        c = torch.where(m == -math.inf, 0.0, torch.exp(m - torch.where(Mb == -math.inf, 0.0, Mb)))
        Lb = (l * c).sum(dim=0)
        Ab = (acc * c[..., None]).sum(dim=0)
        out[b] = torch.where(Lb[..., None] > 0, Ab / Lb.clamp(min=1e-30)[..., None], 0.0)
        M[b], L[b] = Mb, Lb
    return out.reshape(B, 1, Hq, D).to(q.dtype), M.reshape(B, Hq), L.reshape(B, Hq)


def assert_kernel_bound(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def assert_stats(m, l, r_m, r_l):
    """m and l to the stats bound where the plain row saw a slot, and
    (-inf, 0) where it saw none."""
    seen = r_l > 0
    torch.testing.assert_close(m[seen], r_m[seen], **STATS_TOL)
    torch.testing.assert_close(l[seen], r_l[seen], **STATS_TOL)
    assert (l[~seen] == 0).all() and (m[~seen] == -math.inf).all()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("Hkv", ZOO_HKV)
@pytest.mark.parametrize("per_sm", [1, 2])
def test_decode_splits_fill_the_card(B, Hkv, per_sm):
    """At one stream and at 8 slots, for an instance an SM holds one or two
    blocks of: n >= 1; the grid is the most splits' blocks the card holds
    at once (one more split would start a second wave), unless a split of
    the allocated T would fall under MIN_SPLIT_SLOTS; never a split shorter
    than that."""
    for T in (128, 300, 512, 2048, 4096, 16384, 40960):
        n = k1.decode_splits(B, Hkv, T, N_SMS, per_sm)
        blocks = B * Hkv
        assert 1 <= n <= k1.MAX_SPLITS
        if n > 1:
            assert T // n >= k1.MIN_SPLIT_SLOTS
            assert n * blocks <= per_sm * N_SMS, (T, n)  # one wave
        target = per_sm * N_SMS // blocks
        if T // k1.MIN_SPLIT_SLOTS >= target:
            assert n == max(1, target), (T, n)
        else:  # the length caps it
            assert n == max(1, T // k1.MIN_SPLIT_SLOTS), (T, n)


def test_decode_splits_at_the_served_shapes():
    """One stream at 16K: Qwen3-0.6B's 8 kv-heads and Qwen3.5-0.8B's 2, at
    two blocks an SM (K1 in bf16) and at one (K4 kv8 at G = 2: 16 splits,
    128 blocks, where 17 would leave 4 blocks to a second wave); eight
    slots of 2048; a small model's one kv-head over a 128K cache."""
    assert k1.decode_splits(1, 8, 16384, N_SMS) == 33
    assert k1.decode_splits(1, 2, 16384, N_SMS) == 128  # capped by T // 128
    assert k1.decode_splits(1, 8, 16384, N_SMS, 1) == 16
    assert k1.decode_splits(8, 8, 2048, N_SMS) == 4
    assert k1.decode_splits(8, 2, 2048, N_SMS) == 16
    assert k1.decode_splits(1, 1, 131072, N_SMS, 8) == k1.MAX_SPLITS


@pytest.mark.parametrize("B,Hkv", [(17, 8), (33, 4), (66, 2), (132, 1), (64, 16)])
def test_decode_splits_stay_one_when_the_batch_fills_the_card(B, Hkv):
    for T in (256, 2048, 40960):
        for per_sm in (1, 2, 4):
            assert k1.decode_splits(B, Hkv, T, N_SMS, per_sm) == 1
    assert k1.decode_splits(B, Hkv, 40960, 2 * B * Hkv) > 1  # a larger card splits again


def test_split_bounds_cover_the_live_range_once():
    """Every slot of [lo, valid) lies in exactly one share, in order; a row
    with fewer live slots than splits leaves the last shares empty."""
    for valid, window, n in ((0, None, 8), (1, None, 8), (5, None, 8), (16000, None, 33),
                             (700, 300, 7), (700, 1, 4), (2048, 2048, 3), (2049, None, 64)):
        T = 16384
        bounds = split_bounds(valid, window, T, n)
        lo = max(0, valid - window) if window else 0
        slots = [t for a, b in bounds for t in range(a, b)]
        assert slots == list(range(lo, valid))
        assert all(a <= b for a, b in bounds) and len(bounds) == n
        if valid - lo < n:
            assert bounds[-1][0] == bounds[-1][1]


def rnd(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


# (kernel options, label): windows across the split boundaries and of one
# slot, and a softcap
OPTIONS = [({}, "plain"), ({"window": 45}, "window 45"), ({"window": 1}, "window 1"),
           ({"logit_softcap": 5.0}, "softcap")]


def operands(bits, k, v):
    """(kernel operands, float32 K/V the emulation reads) of a cache of k, v
    at ``bits`` (16: the fp cache as it is)."""
    if bits == 16:
        return (k, v, None, None), (k, v)
    B, T, Hkv, D = k.shape
    c = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device="cpu")
    c.update(k, v, 0)
    ops = (c.k, c.v, c.k_scale, c.v_scale)
    return ops, (dequant_codes(c.k, c.k_scale, bits, Hkv, torch.float32).reshape(B, T, Hkv, D),
                 dequant_codes(c.v, c.v_scale, bits, Hkv, torch.float32).reshape(B, T, Hkv, D))


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_split_merge_matches_plain(bits, D, G):
    """The emulation at n = 1, 3, 8 and at decode_splits' count for one
    stream, against the plain version (the bf16 out to the kernel bound;
    with stats, m and l to the stats bound): an empty row, one live slot,
    fewer live slots than splits and a full row, with every option."""
    Hkv = 2
    B, T = 4, 300
    gen = torch.Generator().manual_seed(bits * 1000 + D + G)
    q, k, v = rnd(gen, B, 1, G * Hkv, D), rnd(gen, B, T, Hkv, D), rnd(gen, B, T, Hkv, D)
    valid = torch.tensor([0, 1, 5, T], dtype=torch.int32)
    ops, (kf, vf) = operands(bits, k, v)
    q_plain = q if bits == 16 else q.float()  # as chip_smoke holds K4: codes in float32
    for kw, _ in OPTIONS:
        window = kw.get("window")
        softcap = kw.get("logit_softcap")
        ref, r_m, r_l = k45.decode_attention_with_stats_plain(q_plain, *ops, valid, bits=bits,
                                                              scale=D ** -0.5, **kw)
        for n in (1, 3, 8, k1.decode_splits(1, Hkv, T, N_SMS)):
            out, m, l = split_decode(q, kf, vf, valid, n, scale=D ** -0.5, window=window,
                                     softcap=softcap)
            assert_kernel_bound(out, ref)
            assert_stats(m, l, r_m, r_l)
            assert (out[0] == 0).all()  # the empty row


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("kw", [{}, {"window": 100}, {"window": 1}, {"logit_softcap": 20.0}],
                         ids=["plain", "window-100", "window-1", "softcap"])
def test_split_merge_matches_pallas(bits, kw):
    """The emulation against crane_tpu's quant_decode_attention and
    decode_attention_with_stats in interpret mode, float32, at 5 splits of a
    256-slot cache: the out to the kernel bound; m and l to the stats bound
    where the row saw a slot (Pallas writes -1e30 for an empty row's m)."""
    B, T, Hq, Hkv, D = 4, 256, 8, 2, 64
    rng = np.random.default_rng(bits)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32) for _ in range(2))
    valid = np.array([0, 1, 3, T], np.int32)
    if bits == 16:
        jops, (kf, vf) = (jnp.asarray(k), jnp.asarray(v), None, None), (torch.tensor(k),
                                                                          torch.tensor(v))
    else:
        c = JQCache.empty(B, T, Hkv, D, bits=bits).update(jnp.asarray(k), jnp.asarray(v),
                                                           jnp.asarray(0))
        jops = (c.k, c.v, c.k_scale, c.v_scale)
        tops = [torch.tensor(np.asarray(a)) for a in jops]
        kf = dequant_codes(tops[0], tops[2], bits, Hkv, torch.float32).reshape(B, T, Hkv, D)
        vf = dequant_codes(tops[1], tops[3], bits, Hkv, torch.float32).reshape(B, T, Hkv, D)
    common = dict(bits=bits, scale=D ** -0.5, window=kw.get("window"),
                  logit_softcap=kw.get("logit_softcap"), block_t=128, interpret=True)
    ref = jqa.quant_decode_attention(jnp.asarray(q), *jops, jnp.asarray(valid),
                                     n_kv_heads=Hkv, **common)
    _, r_m, r_l = jqa.decode_attention_with_stats(jnp.asarray(q), *jops, jnp.asarray(valid),
                                                  **common)
    out, m, l = split_decode(torch.tensor(q), kf, vf, torch.tensor(valid), 5, scale=D ** -0.5,
                             window=kw.get("window"), softcap=kw.get("logit_softcap"))
    assert_kernel_bound(out, torch.tensor(np.asarray(ref)))
    r_m, r_l = torch.tensor(np.asarray(r_m)), torch.tensor(np.asarray(r_l))
    seen = l > 0
    assert not seen[0].any() and seen[1:].all()
    torch.testing.assert_close(m[seen], r_m[seen], **STATS_TOL)
    torch.testing.assert_close(l[seen], r_l[seen], **STATS_TOL)
    assert (m[~seen] == -math.inf).all() and (r_m[~seen] <= -1e29).all()


def test_merge_of_empty_shares_is_zero_not_nan():
    """A row whose every share is empty merges to out 0, m -inf, l 0 (the
    kernel guards M == -inf before exp(m - M)); one live slot among eight
    shares gives that slot's value exactly."""
    q = torch.randn(2, 1, 4, 64)
    k, v = torch.randn(2, 16, 2, 64), torch.randn(2, 16, 2, 64)
    out, m, l = split_decode(q, k, v, torch.tensor([0, 1]), 8, scale=0.125)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert (m[0] == -math.inf).all() and (l[0] == 0).all()
    torch.testing.assert_close(out[1, 0], v[1, 0].repeat_interleave(2, dim=0))
    torch.testing.assert_close(l[1], torch.ones(4))
