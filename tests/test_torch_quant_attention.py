"""The plain PyTorch versions of the port's quantized kernels (K4-K6) against
crane_tpu's Pallas kernels run in interpret mode, on the same inputs.

K4 ``quant_decode_attention_plain`` <-> ``quant_decode_attention(bits=8|4)``;
K5 ``quant_cached_attention_plain`` <-> ``quant_cached_attention(bits=8|4)``;
K6 ``quant_matmul_plain`` <-> ``quant_matmul``. The caches are filled by
crane_tpu's ``QuantLayerKVCache`` and handed to the port as they are stored.
Tolerances for K4 and K5 are the ones tests/test_quant_attention.py holds the
Pallas kernels to. On a CPU tensor each wrapper runs its plain version and
launches nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.ops.kv_cache import QuantLayerKVCache as JQCache
from crane_tpu.ops.linear import quantize_weight as jquantize
from crane_tpu.ops.pallas.quant_attention import quant_cached_attention, quant_decode_attention
from crane_tpu.ops.pallas.quant_matmul import quant_matmul
from crane_tpu_torch.ops import cuda as kernels
from crane_tpu_torch.ops.cuda import quant_attention as k45
from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul as k6_wrapper
from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul_plain

torch.set_num_threads(2)

DECODE_TOL = dict(rtol=1e-4, atol=2e-5)
CACHED_TOL = dict(rtol=1e-4, atol=2e-5)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a))


def filled_cache(bits, B, T, Hkv, D, lengths, seed):
    """A crane_tpu quantized cache with row b written at [0, lengths[b]) and
    the rest left as zeros."""
    cache = JQCache.empty(B, T, Hkv, D, bits=bits)
    for b, n in enumerate(lengths):
        if n:
            k, v = rnd(1, n, Hkv, D, seed=seed + b), rnd(1, n, Hkv, D, seed=seed + 50 + b)
            cache = cache.update(jnp.asarray(k), jnp.asarray(v), jnp.asarray(0), row=jnp.asarray(b))
    return cache


def operands(cache):
    return cache.k, cache.v, cache.k_scale, cache.v_scale


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,softcap,D", [(None, None, 64), (64, None, 64), (None, 30.0, 32),
                                              (7, 20.0, 64), (None, None, 256), (64, 30.0, 256)])
def test_k4_plain_matches_pallas(bits, window, softcap, D):
    """A ragged batch with an empty row (which writes zeros) and a full one."""
    B, T, Hq, Hkv = 4, 256, 4, 2
    valid = np.array([0, 1, 125, T], np.int32)
    cache = filled_cache(bits, B, T, Hkv, D, valid, seed=1)
    q = rnd(B, 1, Hq, D, seed=9)
    ref = quant_decode_attention(
        jnp.asarray(q), *operands(cache), jnp.asarray(valid), n_kv_heads=Hkv, bits=bits,
        scale=0.125, window=window, logit_softcap=softcap, block_t=128, interpret=True)
    got = k45.quant_decode_attention_plain(
        t(q), *(t(a) for a in operands(cache)), t(valid), bits=bits, scale=0.125,
        window=window, logit_softcap=softcap).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, np.asarray(ref), **DECODE_TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("ctx,S,window,softcap", [(30, 32, None, None), (30, 32, 24, None),
                                                  (30, 32, None, 30.0), (0, 48, 24, 30.0),
                                                  (100, 32, None, None)])
def test_k5_plain_matches_pallas(bits, ctx, S, window, softcap):
    """Continuation chunks over a quantized buffer: mid-buffer, a window, a
    softcap, a fresh chunk, and a padded tail whose positions pass the
    buffer's end (clamped to T - 1). Codes and scales beyond the live region
    hold garbage, which the causal mask must hide."""
    B, T, Hq, Hkv, D = 2, 128, 4, 2, 32
    live = min(ctx + S, T)
    cache = filled_cache(bits, B, T, Hkv, D, [live, live], seed=3)
    k, v, ks, vs = (np.array(a) for a in operands(cache))
    k[:, live:], v[:, live:] = 99, -77
    ks[:, :, live:], vs[:, :, live:] = 1e9, 1e9
    q = rnd(B, S, Hq, D, seed=4)
    pos = np.broadcast_to(np.arange(S)[None] + ctx, (B, S)).astype(np.int32)
    ref = quant_cached_attention(
        jnp.asarray(q), *map(jnp.asarray, (k, v, ks, vs)), jnp.asarray(pos), n_kv_heads=Hkv,
        bits=bits, scale=D ** -0.5, window=window, logit_softcap=softcap, block_q=16,
        block_k=32, interpret=True)
    got = k45.quant_cached_attention_plain(
        t(q), *map(t, (k, v, ks, vs)), t(pos), bits=bits, scale=D ** -0.5, window=window,
        logit_softcap=softcap).numpy()
    rows = min(S, T - ctx)  # rows whose position lies inside the buffer
    np.testing.assert_allclose(got[:, :rows], np.asarray(ref)[:, :rows], **CACHED_TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("ctx,S,window", [(30, 32, None), (100, 32, 24)])
def test_k5_plain_matches_pallas_head_dim_256(bits, ctx, S, window):
    """K5 at head_dim 256 with Qwen3.5's 8 query / 2 KV heads, mid-buffer
    and with a padded tail past the buffer's end."""
    B, T, Hq, Hkv, D = 1, 128, 8, 2, 256
    live = min(ctx + S, T)
    cache = filled_cache(bits, B, T, Hkv, D, [live], seed=5)
    q = rnd(B, S, Hq, D, seed=6)
    pos = (np.arange(S)[None] + ctx).astype(np.int32)
    ref = quant_cached_attention(
        jnp.asarray(q), *operands(cache), jnp.asarray(pos), n_kv_heads=Hkv, bits=bits,
        scale=D ** -0.5, window=window, block_q=16, block_k=32, interpret=True)
    got = k45.quant_cached_attention_plain(
        t(q), *(t(a) for a in operands(cache)), t(pos), bits=bits, scale=D ** -0.5,
        window=window).numpy()
    rows = min(S, T - ctx)
    np.testing.assert_allclose(got[:, :rows], np.asarray(ref)[:, :rows], **CACHED_TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,I,O", [(1, 256, 384), (8, 512, 128), (40, 1536, 256)])
def test_k6_plain_matches_pallas(bits, M, I, O):
    """The TPU kernel rounds x to bf16 before its product, even for a
    float32 x; the plain version keeps x in float32. So the two agree to
    the bf16 rounding of x (relative 2**-9 per term) summed over I terms of
    random sign: an error below 2**-8 * |x| @ |w| per output."""
    x = rnd(M, I, seed=5)
    qw = jquantize(jnp.asarray(rnd(I, O, seed=6)), bits=bits)
    ref = np.asarray(quant_matmul(jnp.asarray(x), qw.codes, qw.scales, bits=bits,
                                  block_i=128, block_o=128, interpret=True))
    got = quant_matmul_plain(t(x), t(qw.codes), t(qw.scales), bits=bits).numpy()
    bound = 2.0 ** -8 * (np.abs(x) @ np.abs(np.asarray(qw.dequant(jnp.float32)))) + 1e-5
    assert (np.abs(got - ref) <= bound).all()
    # without the rounding of x the two are the same product
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(
        quant_matmul_plain(t(xb), t(qw.codes), t(qw.scales), bits=bits).numpy(), ref,
        rtol=2e-4, atol=2e-4)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    """On a CPU tensor each quantized wrapper is its plain version, bit for
    bit, and no launch of any variant is counted."""
    cache = filled_cache(4, 1, 64, 2, 16, [40], seed=7)
    ops = [t(a) for a in operands(cache)]
    q = torch.tensor(rnd(1, 8, 4, 16, seed=8))
    pos = torch.arange(32, 40, dtype=torch.int32)[None]
    valid = torch.tensor([40], dtype=torch.int32)
    qw = jquantize(jnp.asarray(rnd(32, 16, seed=9)), bits=8)
    x = torch.tensor(rnd(3, 32, seed=10))
    kernels.reset_launch_counts()
    pairs = [
        (k45.quant_decode_attention(q[:, :1], *ops, valid, bits=4, scale=0.25, window=8),
         k45.quant_decode_attention_plain(q[:, :1], *ops, valid, bits=4, scale=0.25, window=8)),
        (k45.quant_cached_attention(q, *ops, pos, bits=4, scale=0.25, logit_softcap=5.0),
         k45.quant_cached_attention_plain(q, *ops, pos, bits=4, scale=0.25, logit_softcap=5.0)),
        (k6_wrapper(x, t(qw.codes), t(qw.scales), bits=8),
         quant_matmul_plain(x, t(qw.codes), t(qw.scales), bits=8)),
    ]
    for got, ref in pairs:
        assert torch.equal(got, ref)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    assert {"quant_matmul[w4]", "quant_decode_attention[kv8]",
            "quant_cached_attention[kv4]"} <= set(kernels.KERNELS)


def test_wrappers_raise_on_a_device_without_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device gets an error, not the plain version."""
    q = torch.empty(1, 4, 4, 64, device="meta")
    codes = torch.empty(1, 8, 128, dtype=torch.int8, device="meta")
    sc = torch.empty(1, 2, 8, device="meta")
    pos = torch.empty(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k45.quant_decode_attention(q[:, :1], codes, codes, sc, sc, pos[:, 0], bits=8, scale=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        k45.quant_cached_attention(q, codes, codes, sc, sc, pos, bits=8, scale=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        k6_wrapper(q[0, 0], codes[0, :4], sc[0, 0], bits=8)
