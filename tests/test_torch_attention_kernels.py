"""The plain PyTorch versions of the port's attention kernels (K1-K3) against
crane_tpu's Pallas kernels run in interpret mode, on the same inputs.

K1 ``fp_decode_attention`` <-> ``quant_decode_attention(bits=16)``;
K2 ``flash_attention_causal`` <-> ``flash_attention_causal``;
K3 ``flash_attention_cached`` <-> ``flash_attention_cached`` and
``quant_cached_attention(bits=16)``. Tolerances are the ones
tests/test_flash_attention.py and tests/test_quant_attention.py use. On a
CPU tensor each wrapper runs its plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.ops.pallas import flash_attention as jflash
from crane_tpu.ops.pallas.quant_attention import quant_cached_attention, quant_decode_attention
from crane_tpu_torch.ops import cuda as kernels
from crane_tpu_torch.ops.cuda import decode_attention as k1
from crane_tpu_torch.ops.cuda import flash_attention as k23

torch.set_num_threads(2)

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
CACHED_TOL = dict(rtol=2e-5, atol=2e-5)
DECODE_TOL = dict(rtol=1e-4, atol=2e-5)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def segments(B, S):
    seg = np.zeros((B, S), np.int32)
    seg[0, 10:42] = 1  # one run spanning block boundaries
    seg[0, 60:75] = 2
    seg[-1, 5:S - 3] = 3  # a run far above the causal diagonal of its queries
    return seg


@pytest.mark.parametrize(
    "B,S,Hq,Hkv,D,window,softcap,seg",
    [
        (1, 64, 4, 2, 32, None, None, False),   # GQA, several blocks
        (2, 48, 2, 2, 16, None, None, False),   # ragged blocks
        (1, 16, 8, 1, 8, None, None, False),    # MQA
        (1, 96, 4, 2, 32, 24, None, False),     # sliding window
        (1, 64, 4, 2, 32, None, 20.0, False),   # softcap
        (2, 48, 2, 2, 16, 12, 30.0, False),     # both
        (1, 96, 4, 2, 32, None, None, True),    # segments
        (2, 96, 4, 2, 32, 24, 25.0, True),      # segments with window and softcap
        (1, 48, 8, 2, 256, None, None, False),  # head_dim 256, Qwen3.5's 8/2 heads
        (1, 48, 2, 1, 256, 16, 30.0, False),    # head_dim 256, window and softcap (Gemma3)
        (1, 64, 8, 2, 128, None, None, False),  # G=4 at head_dim 128
        (2, 48, 8, 2, 128, 5, None, False),     # G=4, a window inside one 16-row tile
        (1, 96, 8, 2, 128, 3, 20.0, True),      # G=4, window 3, softcap, segments
    ],
)
def test_k2_plain_matches_pallas(B, S, Hq, Hkv, D, window, softcap, seg):
    q, k, v = rnd(B, S, Hq, D, seed=1), rnd(B, S, Hkv, D, seed=2), rnd(B, S, Hkv, D, seed=3)
    sg = segments(B, S) if seg else None
    ref = jflash.flash_attention_causal(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if sg is None else jnp.asarray(sg), scale=D ** -0.5, block_q=16,
        block_k=16, window=window, softcap=softcap, interpret=True)
    got = k23.flash_attention_causal_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        None if sg is None else torch.tensor(sg), scale=D ** -0.5, window=window,
        softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)


@pytest.mark.parametrize(
    "B,ctx,S,T,Hq,Hkv,D,window,softcap",
    [
        (1, 40, 32, 128, 4, 2, 32, None, None),  # GQA continuation mid-buffer
        (2, 17, 48, 96, 2, 2, 16, None, None),   # ragged ctx, padded q blocks
        (1, 0, 32, 64, 8, 1, 8, None, None),     # ctx=0 through the cached kernel
        (1, 30, 32, 128, 4, 2, 32, 8, None),     # window
        (1, 20, 16, 64, 2, 2, 16, None, 30.0),   # softcap
        (1, 100, 32, 128, 2, 2, 16, None, None),  # padded tail: positions past T-1
        (1, 40, 32, 128, 8, 2, 256, None, None),  # head_dim 256, Qwen3.5's 8/2 heads
        (1, 100, 32, 128, 2, 1, 256, 24, 30.0),   # head_dim 256, window, softcap, tail
        (1, 100, 48, 128, 8, 2, 128, None, None),  # G=4 at head_dim 128, a ragged tail
        (2, 90, 48, 128, 8, 2, 128, 5, None),      # G=4, window 5, tail past T-1
    ],
)
def test_k3_plain_matches_pallas(B, ctx, S, T, Hq, Hkv, D, window, softcap):
    """Both crane_tpu continuation kernels (flash_attention_cached and
    quant_cached_attention(bits=16)) compute what K3 computes. Slots past
    the live region hold stale data, which causal masking must hide."""
    q = rnd(B, S, Hq, D, seed=4, scale=2.0)
    k, v = rnd(B, T, Hkv, D, seed=5), rnd(B, T, Hkv, D, seed=6)
    k[:, ctx + S:] = 99.0
    pos = np.broadcast_to(np.arange(S)[None] + ctx, (B, S)).astype(np.int32)
    got = k23.flash_attention_cached_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos),
        scale=D ** -0.5, window=window, softcap=softcap).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = jflash.flash_attention_cached(
        *args, jnp.asarray(pos), scale=D ** -0.5, block_q=16, block_k=16,
        window=window, softcap=softcap, interpret=True)
    ref16 = quant_cached_attention(
        *args, None, None, jnp.asarray(pos), bits=16, scale=D ** -0.5, block_q=16,
        block_k=16, window=window, logit_softcap=softcap, interpret=True)
    live = min(S, T - ctx)  # rows whose position lies inside the buffer
    np.testing.assert_allclose(got[:, :live], np.asarray(ref)[:, :live], **CACHED_TOL)
    np.testing.assert_allclose(got[:, :live], np.asarray(ref16)[:, :live], **CACHED_TOL)
    assert np.isfinite(got).all()  # pad rows are defined (clamped), no NaN


@pytest.mark.parametrize("window,softcap", [(None, None), (64, 30.0), (7, None)])
def test_k1_plain_matches_pallas(window, softcap):
    """Ragged kv_valid including an empty row (which writes zeros) and a
    full one."""
    B, T, Hq, Hkv, D = 4, 256, 4, 2, 64
    q = rnd(B, 1, Hq, D, seed=7)
    k, v = rnd(B, T, Hkv, D, seed=8), rnd(B, T, Hkv, D, seed=9)
    valid = np.array([0, 1, 125, T], np.int32)
    ref = quant_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, jnp.asarray(valid),
        bits=16, scale=0.125, window=window, logit_softcap=softcap, block_t=128,
        interpret=True)
    got = k1.fp_decode_attention_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(valid),
        scale=0.125, window=window, logit_softcap=softcap).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, np.asarray(ref), **DECODE_TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (64, 30.0)])
def test_k1_plain_matches_pallas_head_dim_256(window, softcap):
    """K1 at head_dim 256 with Qwen3.5's 8 query / 2 KV heads (G = 4)."""
    B, T, Hq, Hkv, D = 4, 256, 8, 2, 256
    q = rnd(B, 1, Hq, D, seed=14)
    k, v = rnd(B, T, Hkv, D, seed=15), rnd(B, T, Hkv, D, seed=16)
    valid = np.array([0, 3, 130, T], np.int32)
    ref = quant_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, jnp.asarray(valid),
        bits=16, scale=D ** -0.5, window=window, logit_softcap=softcap, block_t=128,
        interpret=True)
    got = k1.fp_decode_attention_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(valid),
        scale=D ** -0.5, window=window, logit_softcap=softcap).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, np.asarray(ref), **DECODE_TOL)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    """On a CPU tensor each wrapper is its plain version, bit for bit, and
    no launch is counted."""
    q, k, v = (torch.tensor(rnd(1, 32, 4, 16, seed=s)) for s in (10, 11, 12))
    kv = torch.tensor(rnd(1, 64, 2, 16, seed=13))
    pos = torch.arange(8, 40, dtype=torch.int32)[None]
    valid = torch.tensor([40], dtype=torch.int32)
    kernels.reset_launch_counts()
    pairs = [
        (k23.flash_attention_causal(q, k[:, :, :2], v[:, :, :2], scale=0.25, window=8),
         k23.flash_attention_causal_plain(q, k[:, :, :2], v[:, :, :2], scale=0.25, window=8)),
        (k23.flash_attention_cached(q, kv, kv, pos, scale=0.25, softcap=5.0),
         k23.flash_attention_cached_plain(q, kv, kv, pos, scale=0.25, softcap=5.0)),
        (k1.fp_decode_attention(q[:, :1], kv, kv, valid, scale=0.25),
         k1.fp_decode_attention_plain(q[:, :1], kv, kv, valid, scale=0.25)),
    ]
    for got, ref in pairs:
        assert torch.equal(got, ref)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_wrappers_raise_on_a_device_without_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device gets an error, not the plain version."""
    q = torch.empty(1, 4, 4, 16, device="meta")
    kv = torch.empty(1, 8, 2, 16, device="meta")
    pos = torch.empty(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k23.flash_attention_causal(q, kv[:, :4], kv[:, :4], scale=0.25)
    with pytest.raises(ValueError, match="no kernel"):
        k23.flash_attention_cached(q, kv, kv, pos, scale=0.25)
    with pytest.raises(ValueError, match="no kernel"):
        k1.fp_decode_attention(q[:, :1], kv, kv, pos[:, 0], scale=0.25)
