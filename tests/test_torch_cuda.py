"""The port's CUDA kernels and its main path on the card, against the plain
PyTorch versions on the same inputs.

Skipped unless ``CRANE_CUDA_TESTS=1`` and a CUDA device is visible. The
machine with the card has no jax, and tests/conftest.py imports it, so run:

    CRANE_CUDA_TESTS=1 python -m pytest --noconftest -q tests/test_torch_cuda.py

This file imports neither jax nor crane_tpu's jax modules.
"""

import contextlib
import dataclasses
import os

import pytest
import torch

from crane_tpu_torch.models.auto import map_hf_weights, quantize_params, transformer_config_from_hf
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
from crane_tpu_torch.models.init import QWEN3_TINY, hf_state_dict, init_params
from crane_tpu_torch.ops import cuda as kernels
from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.cuda import decode_attention as k1
from crane_tpu_torch.ops.cuda import flash_attention as k23
from crane_tpu_torch.ops.cuda import quant_attention as k45
from crane_tpu_torch.ops.cuda.gdn_scan import (
    CHUNK_MIN_S,
    ROUTES,
    chunk_kernel_info,
    gdn_route,
    gdn_scan,
    gdn_scan_plain,
    gdn_scan_route,
)
from crane_tpu_torch.ops.cuda import moe as k8
from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache
from crane_tpu_torch.ops.linear import QuantizedWeight, quantize_weight
from crane_tpu_torch.ops.sampling import SamplingParams
from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm
from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions

pytestmark = pytest.mark.cuda

# float32 kernels against float32 plain versions: the same sums in another
# order, with __expf; bf16 ones: two roundings of the output (see chip_smoke.py).
# The quantized kernels (K4-K6) are held against their plain versions run in
# float32 on the same codes, so the bf16 cases see only the kernel's rounding.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5), torch.bfloat16: dict(rtol=2 ** -6, atol=1e-3)}


@pytest.fixture
def dev():
    if os.environ.get("CRANE_CUDA_TESTS") != "1" or not torch.cuda.is_available():
        pytest.skip("CUDA kernel tests need CRANE_CUDA_TESTS=1 and a CUDA device")
    return torch.device("cuda")


def rnd(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 8), (128, 16, 2), (64, 12, 4), (256, 8, 2)])
@pytest.mark.parametrize("opts", [{}, {"window": 19}, {"softcap": 7.0}])
def test_k2_k3_match_plain(dev, dtype, D, Hq, Hkv, opts):
    gen = torch.Generator(device=dev).manual_seed(D + Hq)
    S = 77  # a ragged last q-tile and k-tile
    q, k, v = (rnd(gen, 2, S, h, D, dtype=dtype) for h in (Hq, Hkv, Hkv))
    got = k23.flash_attention_causal(q, k, v, scale=D ** -0.5, **opts)
    ref = k23.flash_attention_causal_plain(q, k, v, scale=D ** -0.5, **opts)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    seg = torch.zeros(2, S, dtype=torch.int32, device=dev)
    seg[1, 3:60] = 4
    got = k23.flash_attention_causal(q, k, v, seg, scale=D ** -0.5, **opts)
    ref = k23.flash_attention_causal_plain(q, k, v, seg, scale=D ** -0.5, **opts)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])

    T = 200
    kc, vc = rnd(gen, 2, T, Hkv, D, dtype=dtype), rnd(gen, 2, T, Hkv, D, dtype=dtype)
    pos = torch.stack([torch.arange(40, 40 + S), torch.arange(150, 150 + S)]).to(
        device=dev, dtype=torch.int32)  # row 1 runs past the buffer: clamped
    got = k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5, **opts)
    ref = k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5, **opts)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 300])
def test_k2_k3_edges_match_plain(dev, dtype, G, S):
    """The edges of K2, K3 and K3-S (bf16: the tensor-core kernel; float32:
    the CUDA-core one) against their plain versions: S around the 64-row
    and 64-key tiles, G query heads per kv-head (16 / G positions a block
    row set at G = 4), windows of 1 (inside one 16-row mma tile), 7 and 100,
    softcap, segments with a run above the diagonal; K3 rows at other
    offsets per batch row with a tail past T - 1; K3-S at negative
    positions (out 0, m = -inf, l = 0) and bitwise K3's output."""
    D, Hkv = 128, 2
    Hq = G * Hkv
    gen = torch.Generator(device=dev).manual_seed(S * 10 + G)
    q, k, v = (rnd(gen, 2, S, h, D, dtype=dtype) for h in (Hq, Hkv, Hkv))
    seg = torch.zeros(2, S, dtype=torch.int32, device=dev)
    seg[1, S // 4:] = 5  # its early queries see keys far above their diagonal
    for sg, opts in ((None, {}), (None, {"window": 1}), (None, {"window": 7}),
                     (None, {"window": 100}), (None, {"softcap": 5.0}), (seg, {}),
                     (seg, {"window": 7})):
        got = k23.flash_attention_causal(q, k, v, sg, scale=D ** -0.5, **opts)
        ref = k23.flash_attention_causal_plain(q, k, v, sg, scale=D ** -0.5, **opts)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])

    T = 400
    kc, vc = rnd(gen, 2, T, Hkv, D, dtype=dtype), rnd(gen, 2, T, Hkv, D, dtype=dtype)
    pos = torch.stack([torch.arange(S) + 40, torch.arange(S) + 350]).to(dev, torch.int32)
    for opts in ({}, {"window": 1}, {"window": 7}, {"window": 100}, {"softcap": 5.0}):
        got = k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5, **opts)
        ref = k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5, **opts)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])

    pos = torch.stack([torch.arange(S) - 500, torch.arange(S) - S // 2]).to(dev, torch.int32)
    out, m, l = k23.flash_attention_cached_with_stats(q, kc, vc, pos, scale=D ** -0.5)
    r_out, r_m, r_l = k23.flash_attention_cached_with_stats_plain(
        q.cpu().float(), kc.cpu().float(), vc.cpu().float(), pos.cpu(), scale=D ** -0.5)
    assert torch.equal(out, k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5))
    _check_stats(out, m, l, r_out, r_m, r_l, dtype)
    assert (l[0] == 0).all() and (m[0] == -torch.inf).all() and (out[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_k2_k3_run_at_each_head_dim(dev, dtype, D):
    """Each head dim launches (output over torch.empty's garbage agrees with
    the plain version, one launch counted); a refused launch raises, as a
    head dim the C entry does not take shows; bf16 rows must start on a
    16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(D)
    q, k, v = (rnd(gen, 1, 130, h, D, dtype=dtype) for h in (8, 2, 2))
    kernels.reset_launch_counts()
    got = k23.flash_attention_causal(q, k, v, scale=D ** -0.5)
    assert kernels.launch_counts()["flash_attention_causal"] == 1
    torch.testing.assert_close(got.float(), k23.flash_attention_causal_plain(
        q, k, v, scale=D ** -0.5).float(), **TOL[dtype])
    err = build.lib().crane_flash_attention(
        build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(), None,
        None, None, None, 1, 130, 130, 8, 2, D + 32, 0.1, 0, 0.0, build.stream_ptr(q.device))
    with pytest.raises(RuntimeError, match="launch failed"):
        build.check_launch("crane_flash_attention", err)
    if dtype == torch.bfloat16:
        info = k23.mma_kernel_info(D)
        assert info["threads"] == 128 and 0 < info["registers"] <= 255, info
        misaligned = torch.empty(q.numel() + 1, dtype=dtype, device=dev)[1:].view(q.shape)
        with pytest.raises(ValueError, match="16-byte"):
            k23.flash_attention_causal(misaligned, k, v, scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 8), (128, 16, 2), (128, 24, 3), (256, 8, 2),
                                     (256, 16, 2)])
@pytest.mark.parametrize("opts", [{}, {"window": 33}, {"logit_softcap": 9.0}])
def test_k1_matches_plain(dev, dtype, D, Hq, Hkv, opts):
    gen = torch.Generator(device=dev).manual_seed(D * Hq)
    T = 300
    q = rnd(gen, 6, 1, Hq, D, dtype=dtype)
    kc, vc = rnd(gen, 6, T, Hkv, D, dtype=dtype), rnd(gen, 6, T, Hkv, D, dtype=dtype)
    valid = torch.tensor([0, 1, 31, 32, 299, 300], dtype=torch.int32, device=dev)
    got = k1.fp_decode_attention(q, kc, vc, valid, scale=D ** -0.5, **opts)
    ref = k1.fp_decode_attention_plain(q, kc, vc, valid, scale=D ** -0.5, **opts)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # the empty row
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])

    for q, kc, vc, valid, kw in _split_cases(gen, dtype, Hq, Hkv, D, 16, opts):
        got = k1.fp_decode_attention(q, kc, vc, valid, scale=D ** -0.5, **kw)
        ref = k1.fp_decode_attention_plain(q, kc, vc, valid, scale=D ** -0.5, **kw)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
        out, m, l = k1.fp_decode_attention_with_stats(q, kc, vc, valid, scale=D ** -0.5, **kw)
        assert torch.equal(out, got)
        _check_stats(out, m, l, *k1.fp_decode_attention_with_stats_plain(
            q.cpu().float(), kc.cpu().float(), vc.cpu().float(), valid.cpu(), scale=D ** -0.5,
            **kw), dtype)


def _split_cases(gen, dtype, Hq, Hkv, D, bits, opts):
    """(q, k, v, kv_valid, options) of the split-KV route's edges, each
    checked to take the split count it names (``decode_split_count``, the
    count the wrapper launches at ``bits``): one row of a 4096-slot cache
    with 4000 live slots (split), with ``opts`` and with a window of 1000
    across the shares; two rows with fewer live slots than splits (0 and
    3); and a batch whose B * Hkv blocks already fill the card (one block
    per (row, kv-head), no scratch)."""
    sms = k1.sm_count(gen.device.index or 0)
    fill = -(-sms // Hkv)
    for B, T, valid in ((1, 4096, [4000]), (2, 4096, [0, 3]), (fill, 300, None)):
        q = rnd(gen, B, 1, Hq, D, dtype=dtype)
        n = k1.decode_split_count(q, Hkv, T, bits)
        assert (n == 1) == (B == fill), (B, T, n)
        assert B != 2 or max(valid) < n  # fewer live slots than splits
        if valid is None:
            valid = torch.randint(0, T + 1, (B,), generator=gen, device=gen.device).tolist()
        k, v = (rnd(gen, B, T, Hkv, D, dtype=dtype) for _ in range(2))
        valid = torch.tensor(valid, dtype=torch.int32, device=gen.device)
        yield q, k, v, valid, opts
        if B == 1:
            yield q, k, v, valid, {**opts, "window": 1000}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,I,O", [(1, 1024, 3072), (8, 3072, 1024), (256, 1024, 2048),
                                   (3, 1024, 152064), (5, 96, 40)])
def test_k6_matches_plain(dev, dtype, bits, M, I, O):
    """The path's shapes (decode, 256-token chunks, the padded-vocab head)
    and an O that is no multiple of 16 (byte loads, masked edge)."""
    gen = torch.Generator(device=dev).manual_seed(M + O)
    w = quantize_weight(rnd(gen, I, O, dtype=torch.float32) * I ** -0.5, bits=bits)
    x = rnd(gen, M, I, dtype=dtype)
    got = quant_matmul(x, w.codes, w.scales, bits=bits)
    ref = quant_matmul_plain(x.float(), w.codes, w.scales, bits=bits)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 8), (128, 16, 8), (128, 24, 3), (256, 8, 2),
                                     (256, 16, 2)])
@pytest.mark.parametrize("opts", [{}, {"window": 33}, {"logit_softcap": 9.0}])
def test_k4_k5_match_plain(dev, dtype, bits, D, Hq, Hkv, opts):
    gen = torch.Generator(device=dev).manual_seed(D * Hq + bits)
    T = 300
    cache = QuantLayerKVCache.empty(6, T, Hkv, D, bits=bits, device=dev)
    cache.update(rnd(gen, 6, T, Hkv, D, dtype=dtype), rnd(gen, 6, T, Hkv, D, dtype=dtype), 0)
    ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    q = rnd(gen, 6, 1, Hq, D, dtype=dtype)
    valid = torch.tensor([0, 1, 31, 32, 299, 300], dtype=torch.int32, device=dev)
    got = k45.quant_decode_attention(q, *ops, valid, bits=bits, scale=D ** -0.5, **opts)
    ref = k45.quant_decode_attention_plain(q.float(), *ops, valid, bits=bits, scale=D ** -0.5,
                                           **opts)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # the empty row
    torch.testing.assert_close(got.float(), ref, **TOL[dtype])

    for qs, k, v, valid, kw in _split_cases(gen, dtype, Hq, Hkv, D, bits, opts):
        c = QuantLayerKVCache.empty(k.shape[0], k.shape[1], Hkv, D, bits=bits, device=dev)
        c.update(k, v, 0)
        sops = (c.k, c.v, c.k_scale, c.v_scale)
        got = k45.quant_decode_attention(qs, *sops, valid, bits=bits, scale=D ** -0.5, **kw)
        ref = k45.quant_decode_attention_plain(qs.float(), *sops, valid, bits=bits,
                                               scale=D ** -0.5, **kw)
        torch.testing.assert_close(got.float(), ref, **TOL[dtype])
        out, m, l = k45.quant_decode_attention_with_stats(qs, *sops, valid, bits=bits,
                                                          scale=D ** -0.5, **kw)
        assert torch.equal(out, got)
        _check_stats(out, m, l, *k45.quant_decode_attention_with_stats_plain(
            qs.cpu().float(), *(t.cpu() for t in sops), valid.cpu(), bits=bits,
            scale=D ** -0.5, **kw), dtype)

    S = 77  # a ragged last q-tile
    q = rnd(gen, 6, S, Hq, D, dtype=dtype)
    starts = torch.tensor([0, 40, 100, 150, 223, 260], device=dev)  # the last runs past T
    pos = (starts[:, None] + torch.arange(S, device=dev)[None]).to(torch.int32)
    got = k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5, **opts)
    ref = k45.quant_cached_attention_plain(q.float(), *ops, pos, bits=bits, scale=D ** -0.5,
                                           **opts)
    torch.testing.assert_close(got.float(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,V,init", [(1, 300, 16, 128, 128, True), (8, 256, 16, 128, 128, False),
                                           (2, 77, 3, 64, 40, True), (1, 33, 2, 256, 64, False),
                                           (1, 1, 4, 128, 128, True)])
def test_k7_matches_plain(dev, dtype, B, S, H, K, V, init):
    """K7 against the step-by-step scan: the Qwen3.5 shape (H=16,
    K=V=128) at batch 1 and 8, a V that fills no block, K 64 and 256, one
    step. y is compared in its dtype, the state in float32."""
    gen = torch.Generator(device=dev).manual_seed(S + K)
    q, k = rnd(gen, B, S, H, K, dtype=dtype), rnd(gen, B, S, H, K, dtype=dtype)
    v = rnd(gen, B, S, H, V, dtype=dtype)
    g = -torch.rand(B, S, H, generator=gen, device=dev) * 0.5
    beta = torch.rand(B, S, H, generator=gen, device=dev)
    s0 = torch.randn(B, H, K, V, generator=gen, device=dev) * 0.3 if init else None
    kernels.reset_launch_counts()
    y, s = gdn_scan(q, k, v, g, beta, s0)
    assert kernels.launch_counts()[f"gdn_scan[{gdn_route(S)}]"] == 1
    yr, sr = gdn_scan_plain(q, k, v, g, beta, s0)
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), **TOL[dtype])
    torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4)


def _k7_inputs(gen, B, S, H, K, V, dtype, case):
    """q, k, v, g, beta of an adversarial K7 case: "random" (g in [-0.5,
    0]), "g-40" (g down to -40), "beta1" (beta = 1, keys sharing most of one
    direction, where T's entries grow) and "pad" (g = 0 and beta = 0 over a
    run of steps across a chunk boundary)."""
    q, k = rnd(gen, B, S, H, K, dtype=dtype), rnd(gen, B, S, H, K, dtype=dtype)
    v = rnd(gen, B, S, H, V, dtype=dtype)
    g = -torch.rand(B, S, H, generator=gen, device=gen.device) * (40.0 if case == "g-40" else 0.5)
    beta = torch.rand(B, S, H, generator=gen, device=gen.device)
    if case == "beta1":
        k = (4.0 * rnd(gen, 1, 1, H, K, dtype=torch.float32) + 0.3 * k.float()).to(dtype)
        beta = torch.ones_like(beta)
    if case == "pad":
        g[:, S // 3:2 * S // 3] = 0.0
        beta[:, S // 3:2 * S // 3] = 0.0
    return q, k, v, g, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "g-40", "beta1", "pad"])
@pytest.mark.parametrize("S", [1, 8, CHUNK_MIN_S - 1, CHUNK_MIN_S, 63, 64, 65, 130, 1000])
def test_k7_routes_match_plain(dev, dtype, case, S):
    """Both K7 routes (the sequential scan and the chunkwise kernels),
    each forced at every S on both sides of S0 and of
    the 64-step chunk, against the plain scan: y in its dtype, the state to
    chip_smoke's 1e-4 + 1e-4 |plain|, with and without an initial state."""
    gen = torch.Generator(device=dev).manual_seed(S + len(case))
    # S = 130 at B=8, H=16, V=128: a grid that fills the card, 32 state columns a block
    B, H, K, V = {1000: (1, 4, 128, 128), 130: (8, 16, 128, 128)}.get(S, (2, 3, 128, 40))
    q, k, v, g, beta = _k7_inputs(gen, B, S, H, K, V, dtype, case)
    s0 = torch.randn(B, H, K, V, generator=gen, device=dev) * 0.3
    kernels.reset_launch_counts()
    for init in (None, s0):
        yr, sr = gdn_scan_plain(q, k, v, g, beta, init)
        for route in ROUTES:
            y, s = gdn_scan_route(route, q, k, v, g, beta, init)
            torch.testing.assert_close(y.float(), yr.float(), **TOL[dtype], msg=route)
            torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4, msg=route)
    assert kernels.launch_counts()["gdn_scan[chunk]"] == kernels.launch_counts()["gdn_scan[scan]"] == 2


@pytest.mark.parametrize("K", [64, 128, 256])
def test_k7_chunk_route_key_dims_and_info(dev, K):
    """The chunkwise route at each key dim (dynamic shared memory above 48
    KB) from the wrapper, with a V that fills no state block; neither
    kernel spills."""
    gen = torch.Generator(device=dev).manual_seed(K)
    q, k, v, g, beta = _k7_inputs(gen, 2, CHUNK_MIN_S + 44, 2, K, 40, torch.float32, "random")
    s0 = torch.randn(2, 2, K, 40, generator=gen, device=dev) * 0.3
    kernels.reset_launch_counts()
    y, s = gdn_scan(q, k, v, g, beta, s0)
    assert kernels.launch_counts()["gdn_scan[chunk]"] == 1
    assert kernels.launch_counts()["gdn_scan[scan]"] == 0
    yr, sr = gdn_scan_plain(q, k, v, g, beta, s0)
    torch.testing.assert_close(y, yr, **TOL[torch.float32])
    torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4)
    for dtype in (torch.float32, torch.bfloat16):
        info = chunk_kernel_info(dtype, K)
        assert ("state32" in info) == (K <= 128), info
        assert all(kernel["local_bytes"] == 0 for kernel in info.values()), info


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 16, 8), (64, 12, 4), (256, 8, 2)])
def test_with_stats_kernels_match_plain(dev, dtype, bits, D, Hq, Hkv):
    """K1-S / K4-S (decode) and K3-S / K5-S (chunks) against their plain
    versions, at a slab's local lengths (0 included) and slab-local positions
    below, inside and past the slab; out is bitwise the no-stats kernel's."""
    gen = torch.Generator(device=dev).manual_seed(D + Hq + bits)
    T = 300
    k, v = rnd(gen, 6, T, Hkv, D, dtype=dtype), rnd(gen, 6, T, Hkv, D, dtype=dtype)
    if bits == 16:
        ops, ops_plain = (k, v, None, None), (k.float(), v.float(), None, None)
    else:
        cache = QuantLayerKVCache.empty(6, T, Hkv, D, bits=bits, device=dev)
        cache.update(k, v, 0)
        ops = ops_plain = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    q = rnd(gen, 6, 1, Hq, D, dtype=dtype)
    valid = torch.tensor([0, 1, 31, 32, 299, 300], dtype=torch.int32, device=dev)
    out, m, l = k45.decode_attention_with_stats(q, *ops, valid, bits=bits, scale=D ** -0.5)
    r_out, r_m, r_l = k45.decode_attention_with_stats(q.cpu().float(), *(
        None if a is None else a.cpu() for a in ops_plain), valid.cpu(), bits=bits,
        scale=D ** -0.5)
    no_stats = (k1.fp_decode_attention(q, k, v, valid, scale=D ** -0.5) if bits == 16 else
                k45.quant_decode_attention(q, *ops, valid, bits=bits, scale=D ** -0.5))
    assert torch.equal(out, no_stats)
    _check_stats(out, m, l, r_out, r_m, r_l, dtype)
    assert (l[0] == 0).all() and (m[0] == -torch.inf).all() and (out[0] == 0).all()

    S = 77
    q = rnd(gen, 6, S, Hq, D, dtype=dtype)
    starts = torch.tensor([-200, -40, 0, 100, 250, 290], device=dev)  # below, into, past
    pos = (starts[:, None] + torch.arange(S, device=dev)[None]).to(torch.int32)
    out, m, l = k45.cached_attention_with_stats(q, *ops, pos, bits=bits, scale=D ** -0.5)
    r_out, r_m, r_l = k45.cached_attention_with_stats(q.cpu().float(), *(
        None if a is None else a.cpu() for a in ops_plain), pos.cpu(), bits=bits,
        scale=D ** -0.5)
    no_stats = (k23.flash_attention_cached(q, k, v, pos, scale=D ** -0.5) if bits == 16 else
                k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5))
    assert torch.equal(out, no_stats)
    _check_stats(out, m, l, r_out, r_m, r_l, dtype)
    assert (l[0] == 0).all() and (out[0] == 0).all()  # a chunk wholly before the slab


def _decode_call(bits, dtype, dev, B, T, Hq, Hkv, D, seed):
    """A K1 (bits 16) or K4 call on random operands: (fn(kv_valid) ->
    out, kv_valid)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = rnd(gen, B, 1, Hq, D, dtype=dtype)
    k, v = (rnd(gen, B, T, Hkv, D, dtype=dtype) for _ in range(2))
    valid = torch.full((B,), T // 2, dtype=torch.int32, device=dev)
    if bits == 16:
        return (lambda kv_valid: k1.fp_decode_attention(q, k, v, kv_valid, scale=D ** -0.5)), valid
    c = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device=dev)
    c.update(k, v, 0)
    ops = (c.k, c.v, c.k_scale, c.v_scale)
    return (lambda kv_valid: k45.quant_decode_attention(q, *ops, kv_valid, bits=bits,
                                                        scale=D ** -0.5)), valid


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 16, 8), (256, 8, 2)])
def test_decode_graph_replay_equals_eager(dev, bits, D, Hq, Hkv):
    """K1 and K4 captured in a CUDA graph at one stream over a 16K cache
    (the split route, its ticket counters and scratch) and replayed with new
    kv_valid values, 0 and T included, give the eager call's bits: the split
    comes from shapes alone."""
    fn, valid = _decode_call(bits, torch.bfloat16, dev, 1, 16384, Hq, Hkv, D, D + bits)
    assert k1.decode_splits(1, Hkv, 16384, k1.sm_count(0)) > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(valid)  # warm on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(valid)
    for n in (16000, 1, 0, 9999, 16384, 300):
        valid.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(valid)), n


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_ticket_merge_repeats_and_resets(dev, bits, dtype):
    """The ticket merge of the split partials gives the same bits launch
    after launch and leaves the counters at zero; the C entries refuse a
    split launch given no counters (cudaErrorInvalidValue)."""
    B, T, Hq, Hkv, D = 2, 8192, 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(bits)
    q = rnd(gen, B, 1, Hq, D, dtype=dtype)
    k, v = (rnd(gen, B, T, Hkv, D, dtype=dtype) for _ in range(2))
    valid = torch.tensor([7, 8000], dtype=torch.int32, device=dev)
    if bits == 16:
        ops, entry = (k, v), build.lib().crane_decode_attention
        ticket = k1.fp_decode_attention(q, k, v, valid, scale=D ** -0.5)
    else:
        c = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device=dev)
        c.update(k, v, 0)
        ops, entry = (c.k, c.v, c.k_scale, c.v_scale), build.lib().crane_quant_decode_attention
        ticket = k45.quant_decode_attention(q, *ops, valid, bits=bits, scale=D ** -0.5)
    n, acc, ml, _, scratch = k1.split_operands(q, Hkv, T, bits)
    assert n > 1
    refused = torch.zeros_like(q)
    cuda_error_invalid_value = 1
    assert entry(
        build.dtype_code(q), *([bits] if bits != 16 else []), q.data_ptr(),
        *(t.data_ptr() for t in ops), valid.data_ptr(), refused.data_ptr(), None, None, acc,
        ml, None, B, T, Hq, Hkv, D, D ** -0.5, 0, 0.0, n,
        build.stream_ptr(dev)) == cuda_error_invalid_value
    assert (refused == 0).all()
    for _ in range(3):
        again = (k1.fp_decode_attention(q, k, v, valid, scale=D ** -0.5) if bits == 16 else
                 k45.quant_decode_attention(q, *ops, valid, bits=bits, scale=D ** -0.5))
        assert torch.equal(again, ticket)
    torch.cuda.synchronize()
    assert (k1._counters[q.device] == 0).all()


def test_decode_kernels_compile_without_spills(dev):
    """Every K1 and K4 instance: 256 threads, within the register file, no
    local (spill) memory."""
    infos = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128, 256):
            for G in range(1, 9):
                infos.append(k1.kernel_info(dtype, D, G))
                infos += [k45.decode_kernel_info(dtype, bits, D, G) for bits in (8, 4)]
    for info in infos:
        assert info["threads"] == 256 and 0 < info["registers"] <= 255, info
        assert info["local_bytes"] == 0, info


def _kernel_names(fn) -> set[str]:
    """The device kernels one call of ``fn`` runs (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_k5_bf16_edges_match_plain(dev, bits, G, D):
    """The tensor-core K5 and K5-S in bf16 against their plain versions run
    in float32 on the same codes: G query heads per kv-head (G = 16 gives 4
    positions a 64-row tile), S around the 64-row tile, T = 333 (no multiple
    of the key tile), rows at other offsets with a tail past T - 1, windows
    of 1, 7 and 100 and a softcap; K5-S at positions wholly before the
    buffer (out 0, m = -inf, l = 0) and into it, bitwise K5's output."""
    Hkv, T = 2, 333
    Hq = G * Hkv
    gen = torch.Generator(device=dev).manual_seed(D * G + bits)
    cache = QuantLayerKVCache.empty(2, T, Hkv, D, bits=bits, device=dev)
    cache.update(rnd(gen, 2, T, Hkv, D, dtype=torch.bfloat16),
                 rnd(gen, 2, T, Hkv, D, dtype=torch.bfloat16), 0)
    ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    for S in (1, 63, 65, 130):
        q = rnd(gen, 2, S, Hq, D, dtype=torch.bfloat16)
        pos = torch.stack([torch.arange(S) + 40, torch.arange(S) + T - 30]).to(dev, torch.int32)
        for opts in ({}, {"window": 1}, {"window": 7}, {"window": 100}, {"logit_softcap": 5.0}):
            got = k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5, **opts)
            ref = k45.quant_cached_attention_plain(q.float(), *ops, pos, bits=bits,
                                                   scale=D ** -0.5, **opts)
            torch.testing.assert_close(got.float(), ref, **TOL[torch.bfloat16])
    q = rnd(gen, 2, 77, Hq, D, dtype=torch.bfloat16)
    pos = torch.stack([torch.arange(77) - 500, torch.arange(77) - 40]).to(dev, torch.int32)
    out, m, l = k45.quant_cached_attention_with_stats(q, *ops, pos, bits=bits, scale=D ** -0.5)
    r_out, r_m, r_l = k45.quant_cached_attention_with_stats_plain(
        q.cpu().float(), *(t.cpu() for t in ops), pos.cpu(), bits=bits, scale=D ** -0.5)
    assert torch.equal(out, k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5))
    _check_stats(out, m, l, r_out, r_m, r_l, torch.bfloat16)
    assert (l[0] == 0).all() and (m[0] == -torch.inf).all() and (out[0] == 0).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [3, 4, 17, 100, 256])
@pytest.mark.parametrize("I,O", [(1024, 3072), (3072, 1024), (1008, 1040)])
def test_k6_bf16_edges_match_plain(dev, bits, M, I, O):
    """K6 in bf16 at M around the tensor-core route's threshold (M0 - 1
    takes the CUDA-core kernel), the chunk's shapes, an I that is no
    multiple of 32 and an O that is no multiple of the output tile; the
    kernel that ran is the one the route names."""
    from crane_tpu_torch.ops.cuda.quant_matmul import MMA_MIN_M

    assert MMA_MIN_M == 4
    gen = torch.Generator(device=dev).manual_seed(M * 7 + I + O + bits)
    w = quantize_weight(rnd(gen, I, O, dtype=torch.float32) * I ** -0.5, bits=bits)
    x = rnd(gen, M, I, dtype=torch.bfloat16)
    got = quant_matmul(x, w.codes, w.scales, bits=bits)
    torch.testing.assert_close(got.float(), quant_matmul_plain(x.float(), w.codes, w.scales,
                                                               bits=bits),
                               **TOL[torch.bfloat16])
    names = _kernel_names(lambda: quant_matmul(x, w.codes, w.scales, bits=bits))
    mma = any("quant_matmul_mma_kernel" in n for n in names)
    assert mma == (M >= MMA_MIN_M), names


@pytest.mark.parametrize("bits", [8, 4])
def test_float32_stays_on_the_cuda_cores(dev, bits):
    """float32 K5 and K6 (at M = 256) run the CUDA-core kernels, in full
    float32: held to the float32 tolerance, which a bf16-operand product
    would miss."""
    gen = torch.Generator(device=dev).manual_seed(bits)
    w = quantize_weight(rnd(gen, 1024, 1024, dtype=torch.float32) * 1024 ** -0.5, bits=bits)
    x = rnd(gen, 256, 1024, dtype=torch.float32)
    torch.testing.assert_close(quant_matmul(x, w.codes, w.scales, bits=bits),
                               quant_matmul_plain(x, w.codes, w.scales, bits=bits),
                               **TOL[torch.float32])
    names = _kernel_names(lambda: quant_matmul(x, w.codes, w.scales, bits=bits))
    assert any("quant_matmul_kernel<float" in n for n in names), names
    cache = QuantLayerKVCache.empty(1, 300, 2, 128, bits=bits, device=dev)
    cache.update(rnd(gen, 1, 300, 2, 128, dtype=torch.float32),
                 rnd(gen, 1, 300, 2, 128, dtype=torch.float32), 0)
    ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    q = rnd(gen, 1, 77, 8, 128, dtype=torch.float32)
    pos = (torch.arange(77, device=dev) + 200).to(torch.int32)[None]
    torch.testing.assert_close(k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=0.1),
                               k45.quant_cached_attention_plain(q, *ops, pos, bits=bits,
                                                                scale=0.1),
                               **TOL[torch.float32])
    names = _kernel_names(lambda: k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=0.1))
    assert any("quant_cached_kernel<float" in n for n in names), names
    names = _kernel_names(lambda: k45.quant_cached_attention(q.bfloat16(), *ops, pos, bits=bits,
                                                             scale=0.1))
    assert any("flash_mma_kernel" in n and "QuantTiles" in n for n in names), names


def test_quant_mma_kernels_compile_without_spills(dev):
    """The compiled tensor-core K5 and K6 instances: 128 threads, within the
    register file, no local (spill) memory."""
    from crane_tpu_torch.ops.cuda.quant_matmul import MMA_TILES, mma_kernel_info

    infos = [k45.mma_kernel_info(D, bits) for D in (64, 128, 256) for bits in (8, 4)]
    infos += [mma_kernel_info(t, bits) for t in range(len(MMA_TILES)) for bits in (8, 4)]
    for info in infos:
        assert info["threads"] == 128 and 0 < info["registers"] <= 255, info
        assert info["local_bytes"] == 0, infos


def _check_stats(out, m, l, r_out, r_m, r_l, dtype):
    """The kernel's (out, m, l) against the plain float32 run: out to the
    dtype's tolerance; m and l to 1e-5 + 1e-5 |plain| where l > 0, and
    m = -inf, l = 0 where the plain run saw no slot."""
    torch.testing.assert_close(out.float().cpu(), r_out, **TOL[dtype])
    seen = r_l > 0
    m, l = m.cpu(), l.cpu()
    torch.testing.assert_close(m[seen], r_m[seen], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l[seen], r_l[seen], rtol=1e-5, atol=1e-5)
    assert (l[~seen] == 0).all() and (m[~seen] == -torch.inf).all()


def test_launch_counts_and_refusals(dev):
    q = torch.zeros(1, 4, 2, 64, device=dev)
    valid = torch.ones(1, dtype=torch.int32, device=dev)
    pos = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    k23.flash_attention_causal(q, q, q, scale=0.1)
    k23.flash_attention_cached(q, q, q, pos, scale=0.1)
    k1.fp_decode_attention(q[:, :1], q, q, valid, scale=0.1)
    k45.decode_attention_with_stats(q[:, :1], q, q, None, None, valid, bits=16, scale=0.1)
    k45.cached_attention_with_stats(q, q, q, None, None, pos, bits=16, scale=0.1)
    for bits in (8, 4):
        c = QuantLayerKVCache.empty(1, 4, 2, 64, bits=bits, device=dev)
        ops = (c.k, c.v, c.k_scale, c.v_scale)
        k45.quant_decode_attention(q[:, :1], *ops, valid, bits=bits, scale=0.1)
        k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=0.1)
        k45.decode_attention_with_stats(q[:, :1], *ops, valid, bits=bits, scale=0.1)
        k45.cached_attention_with_stats(q, *ops, pos, bits=bits, scale=0.1)
        w = quantize_weight(torch.ones(64, 16, device=dev), bits=bits)
        quant_matmul(q[0, 0], w.codes, w.scales, bits=bits)
    gdn_scan(q, q, q, q[..., 0], q[..., 0])  # S = 4: the sequential scan
    qs = torch.zeros(1, CHUNK_MIN_S, 2, 64, device=dev)
    gdn_scan(qs, qs, qs, qs[..., 0], qs[..., 0])  # the chunkwise route
    ex = torch.zeros(4, 64, 16, device=dev)
    sel = torch.zeros(3, 2, dtype=torch.int64, device=dev)
    k8.moe_experts(q[0, :3, 0].contiguous(), sel.float(), sel, ex, ex,
                   ex.transpose(1, 2).contiguous())
    assert kernels.launch_counts() == {name: 1 for name in kernels.KERNELS}
    odd = torch.zeros(1, 4, 2, 96, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        k23.flash_attention_causal(odd, odd, odd, scale=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        k23.flash_attention_causal(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2), scale=0.1)
    with pytest.raises(TypeError):
        k1.fp_decode_attention(q[:, :1].half(), q.half(), q.half(), valid, scale=0.1)
    with pytest.raises(ValueError, match="bits"):
        k45.quant_decode_attention(q[:, :1], *ops, valid, bits=2, scale=0.1)
    with pytest.raises(ValueError, match="codes"):  # int4 codes read as int8
        k45.quant_cached_attention(q, *ops, pos, bits=8, scale=0.1)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(q[0, 0], w.codes.float(), w.scales, bits=4)
    with pytest.raises(ValueError, match="do not fit"):
        quant_matmul(q[0, 0], w.codes, w.scales, bits=8)
    with pytest.raises(ValueError, match="key head dim"):
        gdn_scan(odd, odd, odd, odd[..., 0], odd[..., 0])
    with pytest.raises(ValueError, match="multiples of 8"):
        k8.moe_experts(q[0, :3, 0, :60].contiguous(), sel.float(), sel, ex[:, :60].contiguous(),
                       ex[:, :60].contiguous(), ex.transpose(1, 2)[:, :, :60].contiguous())
    with pytest.raises(TypeError, match="int64"):
        k8.moe_experts(q[0, :3, 0].contiguous(), sel.float(), sel.int(), ex, ex,
                       ex.transpose(1, 2).contiguous())
    assert kernels.launch_counts() == {name: 1 for name in kernels.KERNELS}


@pytest.fixture
def lms(dev):
    """A tiny Qwen3 with a kernel-sized head dim, in float32 on the card and
    on the CPU, same weights."""
    cfg = dataclasses.replace(QWEN3_TINY, head_dim=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    cpu = CausalLM(cfg, params, dtype=torch.float32)
    gpu = CausalLM(cfg, {k: _to(v, dev) for k, v in params.items()}, dtype=torch.float32)
    return cpu, gpu


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(tree.codes.to(dev), tree.scales.to(dev), tree.block, tree.bits)
    return tree.to(dev)


def test_generate_on_card_matches_cpu(lms):
    cpu, gpu = lms
    prompt = list(range(3, 140, 2))
    logits_c, _ = cpu.prefill(cpu.init_cache(1, 128), [prompt], [len(prompt)])
    logits_g, _ = gpu.prefill(gpu.init_cache(1, 128), [prompt], [len(prompt)])
    torch.testing.assert_close(logits_g.cpu(), logits_c, rtol=1e-4, atol=1e-4)
    gen = GenerationConfig.greedy(24)
    assert gpu.generate(prompt, gen) == cpu.generate(prompt, gen)


@pytest.fixture(params=[8, 4], ids=["w8kv8", "w4kv4"])
def quant_lms(lms, request):
    """The same tiny model with ISQ weights (int4: the tied head too), in
    float32 on the card and on the CPU, same codes; and its KV bits."""
    cpu, _ = lms
    params = quantize_params(cpu.params, bits=request.param)
    dev = torch.device("cuda")
    return (CausalLM(cpu.config, params, dtype=torch.float32),
            CausalLM(cpu.config, _to(params, dev), dtype=torch.float32), request.param)


def test_quant_generate_on_card_matches_cpu(quant_lms):
    cpu, gpu, bits = quant_lms
    prompt = list(range(3, 140, 2))
    logits_c, _ = cpu.prefill(cpu.init_cache(1, 256, quant_bits=bits), [prompt], [len(prompt)])
    logits_g, _ = gpu.prefill(gpu.init_cache(1, 256, quant_bits=bits), [prompt], [len(prompt)])
    torch.testing.assert_close(logits_g.cpu(), logits_c, rtol=1e-4, atol=1e-4)
    gen = GenerationConfig.greedy(24, kv_quant_bits=bits)
    assert gpu.generate(prompt, gen) == cpu.generate(prompt, gen)


def test_quant_engine_on_card_matches_cpu(quant_lms):
    cpu, gpu, bits = quant_lms
    assert _engine_tokens(cpu, bits) == _engine_tokens(gpu, bits)


def test_engine_on_card_matches_cpu(lms):
    assert _engine_tokens(lms[0]) == _engine_tokens(lms[1])


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_sp_generate_on_card_matches_unsharded(lms, bits):
    """Four slabs on the one card: generate and the engine give the
    unsharded port's tokens, and only the with-stats kernels read the
    sharded caches."""
    _, gpu = lms
    slm = sp_shard_lm(gpu, make_sp_mesh(4, ["cuda:0"] * 4))
    prompt = list(range(3, 140, 2))
    gen = GenerationConfig.greedy(24, kv_quant_bits=bits)
    expected = gpu.generate(prompt, gen)
    kernels.reset_launch_counts()
    assert slm.generate(prompt, gen) == expected
    counts = kernels.launch_counts()
    stats = ("fp_decode_attention_with_stats" if bits is None else
             f"quant_decode_attention_with_stats[kv{bits}]")
    plain = "fp_decode_attention" if bits is None else f"quant_decode_attention[kv{bits}]"
    # 4 slabs x 2 layers x 3 decode blocks of 8 steps
    assert counts[stats] == 4 * 2 * 24 and counts[plain] == 0
    assert _engine_tokens(slm, bits) == _engine_tokens(gpu, bits)


def _engine_tokens(lm, kv_quant_bits=None):
    """Three greedy requests (chunked admission, continuation chunks) through
    the engine; their tokens."""
    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    prompts = [list(range(1, 1 + n)) for n in (5, 40, 90)]
    engine = InferenceEngine(lm, max_slots=2, max_seq_len=256, prefill_chunk=32,
                             bucket_align=32, decode_tokens_per_seq=4, kv_quant_bits=kv_quant_bits)
    qs = [engine.submit(EngineRequest(f"r{i}", p, 12, greedy)) for i, p in enumerate(prompts)]
    for _ in range(1000):
        if not engine.step() and engine.request_q.empty():
            break
    return [_drain(q) for q in qs]


def _drain(q):
    toks = []
    while True:
        r = q.get(timeout=30)
        assert r.error is None, r.error
        if r.finished:
            return toks
        toks.append(r.token)


# a tiny Qwen3.5-shaped hybrid whose head dims the kernels take: GDN K=64,
# attention D=64
TINY_HYBRID = {
    "model_type": "qwen3_5", "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
    "intermediate_size": 128, "rms_norm_eps": 1e-6, "rope_theta": 1e7,
    "tie_word_embeddings": True, "partial_rotary_factor": 0.25,
    "layer_types": ["linear_attention"] * 3 + ["full_attention"],
    "linear_num_value_heads": 4, "linear_num_key_heads": 2, "linear_key_head_dim": 64,
    "linear_value_head_dim": 32, "linear_conv_kernel_dim": 4,
}


# the tiny hybrid with Qwen3-Next's sparse MLP: 16 experts of 32, top-4, a
# shared expert (K8 in every layer)
TINY_MOE = dict(TINY_HYBRID, model_type="qwen3_next", tie_word_embeddings=False,
                num_experts=16, num_experts_per_tok=4, moe_intermediate_size=32,
                shared_expert_intermediate_size=32, norm_topk_prob=True, decoder_sparse_step=1,
                mlp_only_layers=[])


@pytest.fixture
def hybrid_lms(dev):
    """The tiny hybrid in float32 on the card (K7 for every prefill) and on
    the CPU (the chunked form), same weights."""
    cfg = transformer_config_from_hf(TINY_HYBRID)
    sd = hf_state_dict(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    return (CausalLM(cfg, map_hf_weights(cfg, sd, torch.float32), dtype=torch.float32),
            CausalLM(cfg, map_hf_weights(cfg, sd, torch.float32, dev), dtype=torch.float32))


def test_hybrid_generate_on_card_matches_cpu(hybrid_lms):
    """Prefills of 127 and 300 steps (K7's sequential scan and its
    chunkwise route) and greedy generation, the card against the CPU."""
    cpu, gpu = hybrid_lms
    prompt = list(range(3, 200, 2))
    for ids, S, T in ((prompt, 127, 128), ([3 + 7 * i % 250 for i in range(280)], 300, 512)):
        kernels.reset_launch_counts()
        padded = [ids + [0] * (S - len(ids))]
        logits_c, _ = cpu.prefill(cpu.init_cache(1, T), padded, [len(ids)])
        logits_g, _ = gpu.prefill(gpu.init_cache(1, T), padded, [len(ids)])
        counts = kernels.launch_counts()
        assert counts[f"gdn_scan[{gdn_route(S)}]"] == 3  # one a GDN layer
        assert counts["gdn_scan[chunk]"] + counts["gdn_scan[scan]"] == 3
        torch.testing.assert_close(logits_g.cpu(), logits_c, rtol=1e-4, atol=1e-4)
    assert gdn_route(127) == "scan" and gdn_route(300) == "chunk"
    gen = GenerationConfig.greedy(24)
    assert gpu.generate(prompt, gen) == cpu.generate(prompt, gen)


def test_hybrid_engine_on_card_matches_cpu(hybrid_lms):
    assert _engine_tokens(hybrid_lms[0]) == _engine_tokens(hybrid_lms[1])


# tiny llama-like configs whose heads the kernels do not take, and the kinds
# of attention call that go to a plain version by shape
ROUTED = {
    "head_dim 96": (dict(num_heads=4, num_kv_heads=2, head_dim=96), {"decode", "prefill", "chunk"}),
    "16 on 1": (dict(num_heads=16, num_kv_heads=1, head_dim=64), {"decode"}),
}


@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_heads_on_card_match_cpu(dev, name):
    """Heads the kernels do not take serve on the card through the plain
    versions: a fresh prefill, a continuation chunk and a decode step agree
    with the port on the CPU in float32, generate and the engine give the
    same tokens, and attention_block.plain_routes counts the routed kinds;
    a direct kernel call with those heads still raises."""
    from crane_tpu_torch.models.modules.transformer import (
        attention_block,
        forward_hidden,
        make_cache,
    )

    fields, kinds = ROUTED[name]
    cfg = dataclasses.replace(QWEN3_TINY, qk_norm=False, max_position_embeddings=512, **fields)
    params = init_params(cfg, torch.Generator().manual_seed(11), device="cpu", dtype=torch.float32)
    cpu = CausalLM(cfg, params, dtype=torch.float32)
    gpu = CausalLM(cfg, {k: _to(v, dev) for k, v in params.items()}, dtype=torch.float32)
    for kind in attention_block.plain_routes:
        attention_block.plain_routes[kind] = 0
    kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(5)
    steps = [(torch.randint(1, 500, (2, 20), generator=gen), 0, False),
             (torch.randint(1, 500, (2, 12), generator=gen), 20, True),
             (torch.randint(1, 500, (2, 1), generator=gen), 32, True)]
    hidden = []
    for lm in (cpu, gpu):
        cache = make_cache(cfg, 2, 48, torch.float32, device=lm.device)
        hs = []
        for toks, start, read in steps:
            pos = torch.full((2,), start, dtype=torch.int32, device=lm.device) \
                if toks.shape[1] == 1 else start
            h, cache = forward_hidden(cfg, lm.params, toks.to(lm.device, torch.int32), cache, pos,
                                      lm.rope, read_cache=read)
            hs.append(h.cpu())
        hidden.append(hs)
    for h_cpu, h_gpu in zip(*hidden):
        torch.testing.assert_close(h_gpu, h_cpu, rtol=1e-4, atol=1e-4)
    assert {k for k, n in attention_block.plain_routes.items() if n} == kinds
    counts = kernels.launch_counts()
    assert counts["fp_decode_attention"] == 0  # every decode of these heads is routed
    assert (counts["flash_attention_causal"] > 0) == ("prefill" not in kinds)
    prompt = list(range(3, 60, 2))
    gen_cfg = GenerationConfig.greedy(16)
    assert gpu.generate(prompt, gen_cfg) == cpu.generate(prompt, gen_cfg)
    assert _engine_tokens(cpu) == _engine_tokens(gpu)
    q = torch.zeros(1, 1, cfg.num_heads, cfg.head_dim, device=dev)
    kv = torch.zeros(1, 4, cfg.num_kv_heads, cfg.head_dim, device=dev)
    with pytest.raises(ValueError):
        k1.fp_decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32, device=dev), scale=0.1)


# -- decode blocks as CUDA graphs, and speculation (models/graphs.py) ---------

GRAPH_PATHS = ["bf16", "f32", "w8kv8", "w4kv4", "hybrid", "sp", "moe"]


def _path_lm(dev, path):
    """(model on the card, KV bits) of one served decode path, tiny and
    with heads the kernels take."""
    if path in ("hybrid", "moe"):
        cfg = transformer_config_from_hf(TINY_HYBRID if path == "hybrid" else TINY_MOE)
        sd = hf_state_dict(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
        return CausalLM(cfg, map_hf_weights(cfg, sd, torch.bfloat16, dev),
                        dtype=torch.bfloat16), None
    dtype = torch.float32 if path == "f32" else torch.bfloat16
    cfg = dataclasses.replace(QWEN3_TINY, head_dim=64)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype),
                 dev)
    bits = {"w8kv8": 8, "w4kv4": 4}.get(path)
    if bits is not None:
        params = quantize_params(params, bits=bits)
    lm = CausalLM(cfg, params, dtype=dtype)
    return (sp_shard_lm(lm, make_sp_mesh(4, ["cuda:0"] * 4)) if path == "sp" else lm), bits


def _ragged_state(lm, B, bits, sampled=False, T=256):
    """A B-row cache after a ragged prefill (rows of 5 + 11 i tokens), the
    first tokens, recent rings, sampling params (greedy, or with half the
    rows sampling) and a ragged active mask (every third row idle at B=8)."""
    dev = lm.device
    lens = [5 + 11 * i for i in range(B)]
    padded = [[(7 * i + 3 * j) % 200 + 1 for j in range(n)] + [0] * (128 - n)
              for i, n in enumerate(lens)]
    logits, cache = lm.prefill(lm.init_cache(B, T, quant_bits=bits), padded, lens)
    sp = SamplingParams.make(B, do_sample=False, device=dev)
    if sampled:
        for r in range(0, B, 2):
            sp.set_row(r, temperature=0.9, top_k=0, top_p=0.9, repetition_penalty=1.1,
                       do_sample=True)
    active = torch.tensor([i % 3 != 2 for i in range(B)], device=dev)
    recent = torch.full((B, 16), -1, dtype=torch.int32, device=dev)
    return cache, logits.argmax(-1).to(torch.int32), recent, sp, active


def _blocks(lm, B, bits, eager, sampled=False, seed=0, n_blocks=3, steps=4):
    """n_blocks masked decode blocks from _ragged_state, as graphs or as the
    eager loop; their tokens and the lengths after, on the host."""
    cache, toks, recent, sp, active = _ragged_state(lm, B, bits, sampled)
    gen = torch.Generator(device=lm.device).manual_seed(seed)
    outs = []
    with graphs.eager() if eager else contextlib.nullcontext():
        for _ in range(n_blocks):
            out, cache, recent = lm.decode_active(cache, toks, recent, sp, gen, active, steps)
            toks = out[:, -1]
            outs.append(out)
    return torch.cat(outs, dim=1).cpu(), cache.lengths.cpu()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_blocks_equal_eager(dev, path, B):
    """Three masked blocks of four greedy steps, replayed as CUDA graphs,
    give the eager loop's tokens and lengths on every served decode path
    (dense bf16 and float32, w8 kv8, w4 kv4, the GDN hybrid, four sp slabs
    on the card), at B=1 and at B=8 with every third row idle."""
    lm, bits = _path_lm(dev, path)
    start = graphs.captures
    got = _blocks(lm, B, bits, eager=False)
    assert graphs.captures == start + 1  # one program, replayed three times
    ref = _blocks(lm, B, bits, eager=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_graph_sampling_reproducible(dev):
    """Half the rows sampling (top-p, penalty) from one seed: two graph runs
    give the same tokens, and so does the eager loop (the generator is
    registered with the graph, and a replay draws what the loop draws)."""
    lm, _ = _path_lm(dev, "bf16")
    runs = [_blocks(lm, 8, None, eager=False, sampled=True, seed=11) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][0], _blocks(lm, 8, None, eager=True, sampled=True, seed=11)[0])


@pytest.mark.parametrize("path", ["bf16", "w4kv4", "sp"])
def test_graph_counts_equal_eager(dev, path):
    """The launch counts and plain-route counts after N graph replays equal
    the eager loop's for the same blocks (the capture's launches are added
    once a replay, and the capture's own taken back)."""
    lm, bits = _path_lm(dev, path)
    counts = {}
    for eager in (True, False):
        cache, toks, recent, sp, active = _ragged_state(lm, 8, bits)
        gen = torch.Generator(device=dev)
        kernels.reset_launch_counts()
        launches, routes = graphs.counts()
        with graphs.eager() if eager else contextlib.nullcontext():
            for _ in range(3):
                lm.decode_active(cache, toks, recent, sp, gen, active, 4)
        after = graphs.counts()
        counts[eager] = ({k: n - launches[k] for k, n in after[0].items()},
                         {k: n - routes[k] for k, n in after[1].items()})
    assert counts[False] == counts[True]
    assert sum(counts[False][0].values()) > 0


@pytest.mark.parametrize("path", ["bf16", "w8kv8", "w4kv4", "sp"])
def test_spec_graphs_equal_eager(dev, path):
    """Speculation's blocks as graphs against the eager loop: two blocks of
    three chained rounds of k=8 drafts (verify chunks of 9 rows at ragged
    starts), then a plain block that writes the history rows: tokens,
    accepted counts, lengths and history equal."""
    lm, bits = _path_lm(dev, path)
    B, k = 8, 8
    res = {}
    for eager in (True, False):
        cache, toks, recent, sp, active = _ragged_state(lm, B, bits)
        lens = cache.lengths.tolist()
        history = torch.zeros((B, 256 + k + 2), dtype=torch.int32, device=dev)
        for i, n in enumerate(lens):
            history[i, :n] = torch.tensor([(7 * i + 3 * j) % 200 + 1 for j in range(n)])
            history[i, n] = toks[i]
        outs = []
        with graphs.eager() if eager else contextlib.nullcontext():
            for _ in range(2):
                t, a, cache, history = lm.spec_rounds(cache, history, active, 3, k, 3)
                outs += [t.cpu(), a.cpu()]
            cur = history.gather(1, cache.lengths.long()[:, None])[:, 0]
            o, cache, recent, history = lm.decode_active_hist(
                cache, cur, recent, sp, torch.Generator(device=dev), active, 4, history)
            outs.append(o.cpu())
        res[eager] = outs + [cache.lengths.cpu(), history.cpu()]
    for got, ref in zip(res[False], res[True]):
        assert torch.equal(got, ref)


def test_speculative_generate_on_card_matches_plain(dev):
    """generate(speculative="ngram") through the verify graph equals plain
    greedy generate on the card (bf16, w4 kv4), for spec_k 1 and 8."""
    for path in ("bf16", "w4kv4"):
        lm, bits = _path_lm(dev, path)
        prompt = [5, 6, 7, 8] * 10 + [3, 14, 15]
        plain = lm.generate(prompt, GenerationConfig.greedy(40, kv_quant_bits=bits))
        for spec_k in (1, 8):
            assert lm.generate(prompt, GenerationConfig.greedy(
                40, kv_quant_bits=bits, speculative="ngram", spec_k=spec_k)) == plain


def test_engine_captures_nothing_after_warmup(dev):
    """warmup captures every decode program serving reaches; then a mix of
    speculative greedy streams and a sampled request is served with no
    capture, and the greedy tokens equal the plain engine's."""
    lm, _ = _path_lm(dev, "bf16")
    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    sampled = SamplingOptions(temperature=0.8, top_p=0.9, repetition_penalty=1.1)
    prompts = [[5, 6, 7, 8] * 6, list(range(3, 40)), [9, 8, 7, 9, 8, 7]]

    def serve(engine, with_sampled):
        engine.warmup()
        captured = graphs.captures
        qs = [engine.submit(EngineRequest(f"g{i}", p, 40, greedy)) for i, p in enumerate(prompts)]
        if with_sampled:  # a short sampled request: speculation engages once it is done
            qs.append(engine.submit(EngineRequest("s", [1, 2, 3], 4, sampled)))
        for _ in range(2000):
            if not engine.step() and engine.request_q.empty():
                break
        return [_drain(q) for q in qs], graphs.captures - captured

    spec = InferenceEngine(lm, max_slots=4, max_seq_len=256, speculative="ngram", spec_rounds=4)
    got, captured = serve(spec, True)
    assert captured == 0 and spec.stats.spec_steps > 0 and len(got[3]) == 4
    plain, captured = serve(InferenceEngine(lm, max_slots=4, max_seq_len=256), False)
    assert captured == 0 and got[:3] == plain


# -- slot prefills as CUDA graphs (CausalLM.prefill_graphs) -------------------

# where the replayed prefill's argmax and the eager one's part, the eager
# logits at the two tokens must lie within this (chip_smoke.py's LOGIT_TIE)
PREFILL_LOGIT_TIE = 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 8), (128, 16, 8), (256, 8, 2)])
def test_k3_row_pointer_equals_the_row_view(dev, dtype, D, Hq, Hkv):
    """K3 given the cache row on the device (``kv_rows``) over a 5-row
    cache equals K3 on that row's view, bit for bit, at the first and last
    slot and at starts 0, 300 and the buffer's end; a chunk that crosses
    the buffer's end is clamped alike."""
    gen = torch.Generator(device=dev).manual_seed(D + Hq)
    B, T, S = 5, 1024, 256
    k, v = (rnd(gen, B, T, Hkv, D, dtype=dtype) for _ in range(2))
    q = rnd(gen, 1, S, Hq, D, dtype=dtype)
    for slot in (0, B - 1):
        rows = torch.tensor([slot], dtype=torch.int32, device=dev)
        for start in (0, 300, T - S, T - S // 2):
            pos = (start + torch.arange(S, device=dev, dtype=torch.int32))[None]
            got = k23.flash_attention_cached(q, k, v, pos, scale=D ** -0.5, kv_rows=rows)
            ref = k23.flash_attention_cached(q, k[slot:slot + 1], v[slot:slot + 1], pos,
                                             scale=D ** -0.5)
            assert torch.equal(got, ref), (slot, start)
    with pytest.raises(TypeError, match="kv_rows"):
        k23.flash_attention_cached(q, k, v, pos, scale=0.1, kv_rows=rows.long())


def _prefill_calls(lm, buckets, slots=(0, 3), starts=(64, 512)):
    """Each bucket's fresh prefill at ``slots`` and continuation chunks
    there at ``starts``, over a 4-row cache whose rows hold 1024 tokens of
    their own; the logits of each call, the cache after, and the launch
    counts they added."""
    dev = lm.device
    B, T = 4, 2048
    ctx = [[(11 * r + 5 * j) % 400 + 1 for j in range(1024)] for r in range(B)]
    _, cache = lm.prefill(lm.init_cache(B, T), ctx, [1024] * B)
    kernels.reset_launch_counts()
    launches, _ = graphs.counts()
    out = []
    for b in buckets:
        for slot in slots:
            toks = [[(3 * j + b + slot) % 400 + 1 for j in range(b)]]
            logits, cache = lm.prefill_slot(cache, toks, slot, b - 7)
            out.append(logits)
            for start in starts:
                logits, cache = lm.prefill_slot_continue(cache, toks, slot, start, b - 3)
                out.append(logits)
    counts = {k: n - launches[k] for k, n in graphs.counts()[0].items() if n != launches[k]}
    return torch.cat(out).cpu(), cache, counts


@pytest.mark.parametrize("path", ["bf16", "f32"])
def test_prefill_replays_equal_eager(dev, path):
    """Fresh prefills and continuation chunks at every chat bucket (64-512),
    at two slots and two starts, replayed as CUDA graphs against
    graphs.eager(): each call's argmax is the eager one's or ties on the
    eager logits within PREFILL_LOGIT_TIE; the K/V written agree; the K2/K3
    launch counts are the eager path's; one program per (kind, bucket)."""
    lm, _ = _path_lm(dev, path)
    buckets = (64, 128, 256, 512)
    start = graphs.captures
    got, cache, counts = _prefill_calls(lm, buckets)
    assert graphs.captures - start == 2 * len(buckets)
    with graphs.eager():
        ref, ref_cache, ref_counts = _prefill_calls(lm, buckets)
    assert counts == ref_counts and counts["flash_attention_causal"] == 2 * 4 * 2
    assert counts["flash_attention_cached"] == 2 * 4 * 2 * 2
    picked, ref_picked = got.argmax(-1), ref.argmax(-1)
    rows = torch.arange(ref.shape[0])
    gaps = ref[rows, ref_picked] - ref[rows, picked]
    assert bool((gaps <= PREFILL_LOGIT_TIE).all()), gaps.max()
    for a, b in zip(cache.layers, ref_cache.layers):
        for x, y in ((a.k, b.k), (a.v, b.v)):
            err = (x.float() - y.float()).norm() / y.float().norm()
            assert err < (1e-5 if path == "f32" else 1e-2), err


def test_served_mix_after_warm_prefills_captures_nothing(dev):
    """The chat cell's engine flags on a tiny float32 model: warmup
    captures every prefill bucket, the benchmark's warm_prefills then
    replays them, and a short mix (a short prompt, a chunked one, a second
    turn past a reused prefix) is served with no capture; its greedy tokens
    equal the eager engine's."""
    from crane_bench import system
    from crane_bench.spec import HERE, read_json

    lm, _ = _path_lm(dev, "f32")
    mix = read_json(HERE / "traffic" / "chat.json")
    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    first = [(7 * j) % 400 + 1 for j in range(300)]
    prompts = [("a", first), ("b", list(range(3, 40))),
               ("c", [(5 * j) % 400 + 1 for j in range(1300)])]

    def serve():
        engine = InferenceEngine(lm, max_slots=16, max_seq_len=4096, prefill_chunk=512)
        engine.warmup()
        captured = graphs.captures
        system.warm_prefills(engine, mix)
        outs = {}
        for batch in (prompts, [("a2", first + [9, 8, 7] * 40)]):
            qs = {rid: engine.submit(EngineRequest(rid, p, 16, greedy)) for rid, p in batch}
            for _ in range(2000):
                if not engine.step() and engine.request_q.empty():
                    break
            outs.update({rid: _drain(q) for rid, q in qs.items()})
        return outs, graphs.captures - captured, engine.stats.prefix_tokens_reused

    got, captured, reused = serve()
    assert captured == 0 and reused >= 256
    with graphs.eager():
        ref, _, _ = serve()
    assert got == ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("S", [5, 9])
@pytest.mark.parametrize("B", [1, 8])
def test_verify_chunk_attention_matches_plain(dev, dtype, bits, S, B):
    """K3 (bits 16) and K5 (kv8, kv4) and their -S forms at a verify
    chunk's shapes: S = k + 1 rows at a different start on every row of the
    batch, Qwen3-0.6B's heads (16 on 8, D=128) over a 512-slot cache, one
    row ending at the buffer's last slot."""
    gen = torch.Generator(device=dev).manual_seed(S * B + bits)
    T, Hq, Hkv, D = 512, 16, 8, 128
    k, v = rnd(gen, B, T, Hkv, D, dtype=dtype), rnd(gen, B, T, Hkv, D, dtype=dtype)
    q = rnd(gen, B, S, Hq, D, dtype=dtype)
    starts = torch.tensor([T - S, 0, 1, 63, 64, 200, 301, 450][:B], device=dev)
    pos = (starts[:, None] + torch.arange(S, device=dev)[None]).to(torch.int32)
    if bits == 16:
        ops = (k, v)
        got = k23.flash_attention_cached(q, k, v, pos, scale=D ** -0.5)
        ref = k23.flash_attention_cached_plain(q, k, v, pos, scale=D ** -0.5)
    else:
        c = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device=dev)
        c.update(k, v, 0)
        ops = (c.k, c.v, c.k_scale, c.v_scale)
        got = k45.quant_cached_attention(q, *ops, pos, bits=bits, scale=D ** -0.5)
        ref = k45.quant_cached_attention_plain(q.float(), *ops, pos, bits=bits, scale=D ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    out, m, l = k45.cached_attention_with_stats(q, *ops, *([None, None] if bits == 16 else []),
                                                pos, bits=bits, scale=D ** -0.5)
    assert torch.equal(out, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [9, 72])
@pytest.mark.parametrize("I,O", [(1024, 2048), (1024, 3072), (3072, 1024)])
def test_k6_verify_rows_match_plain(dev, dtype, bits, M, I, O):
    """K6 at a verify forward's rows: M = B (k + 1), 9 for generate and 72
    for eight engine slots, at Qwen3-0.6B's projections."""
    gen = torch.Generator(device=dev).manual_seed(M + I + O + bits)
    w = quantize_weight(rnd(gen, I, O, dtype=torch.float32) * I ** -0.5, bits=bits)
    x = rnd(gen, M, I, dtype=dtype)
    got = quant_matmul(x, w.codes, w.scales, bits=bits)
    torch.testing.assert_close(got.float(), quant_matmul_plain(x.float(), w.codes, w.scales,
                                                               bits=bits), **TOL[dtype])


def _grad_calls(dev):
    """A call of every kernel wrapper on small inputs on the card; ``req``
    makes its first input require grad."""
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (rnd(gen, 1, s, h, 64, dtype=torch.bfloat16) for s, h in ((4, 2), (8, 1), (8, 1)))
    qd = rnd(gen, 1, 1, 2, 64, dtype=torch.bfloat16)
    cache = QuantLayerKVCache.empty(1, 8, 1, 64, bits=8, device=dev)
    cache.update(k, v, 0)
    ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    valid = torch.tensor([5], dtype=torch.int32, device=dev)
    pos = torch.arange(4, 8, dtype=torch.int32, device=dev)[None]
    w = quantize_weight(rnd(gen, 64, 16, dtype=torch.float32), bits=8)
    g = -torch.rand(1, 5, 2, generator=gen, device=dev)
    ex = rnd(gen, 4, 64, 16, dtype=torch.bfloat16)
    exd = rnd(gen, 4, 16, 64, dtype=torch.bfloat16)
    picks = torch.tensor([[0, 1], [2, 3], [1, 0]], device=dev)
    return {
        "K1": lambda req: k1.fp_decode_attention(req(qd), k, v, valid, scale=0.125),
        "K1-S": lambda req: k1.fp_decode_attention_with_stats(req(qd), k, v, valid, scale=0.125),
        "K2": lambda req: k23.flash_attention_causal(req(q), k[:, :4].contiguous(),
                                                      v[:, :4].contiguous(), scale=0.125),
        "K3": lambda req: k23.flash_attention_cached(req(q), k, v, pos, scale=0.125),
        "K3-S": lambda req: k23.flash_attention_cached_with_stats(req(q), k, v, pos, scale=0.125),
        "K4": lambda req: k45.quant_decode_attention(req(qd), *ops, valid, bits=8, scale=0.125),
        "K4-S": lambda req: k45.quant_decode_attention_with_stats(req(qd), *ops, valid, bits=8,
                                                                  scale=0.125),
        "K5": lambda req: k45.quant_cached_attention(req(q), *ops, pos, bits=8, scale=0.125),
        "K5-S": lambda req: k45.quant_cached_attention_with_stats(req(q), *ops, pos, bits=8,
                                                                  scale=0.125),
        "K8": lambda req: k8.moe_experts(req(rnd(gen, 3, 64, dtype=torch.bfloat16)),
                                         torch.ones(3, 2, device=dev), picks, ex, ex, exd),
        "K6": lambda req: quant_matmul(req(rnd(gen, 3, 64, dtype=torch.bfloat16)), w.codes,
                                       w.scales, bits=8),
        "K7": lambda req: gdn_scan(req(rnd(gen, 1, 5, 2, 64, dtype=torch.bfloat16)),
                                   rnd(gen, 1, 5, 2, 64, dtype=torch.bfloat16),
                                   rnd(gen, 1, 5, 2, 64, dtype=torch.bfloat16), g, g.sigmoid()),
    }


@pytest.mark.parametrize("kernel", ["K1", "K1-S", "K2", "K3", "K3-S", "K4", "K4-S", "K5", "K5-S",
                                    "K6", "K7", "K8"])
def test_wrappers_refuse_inputs_that_require_grad(dev, kernel):
    """A kernel's output has no ``grad_fn``: under grad mode each wrapper
    refuses an input that requires grad before it launches; under
    ``no_grad`` the same call launches."""
    call = _grad_calls(dev)[kernel]
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        call(lambda t: t.clone().requires_grad_(True))
    assert kernels.launch_counts() == before
    with torch.no_grad():
        call(lambda t: t.clone().requires_grad_(True))
    assert kernels.launch_counts() != before


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_sharded_generate_on_card_matches_unsharded(dev, dp, tp):
    """A tiny float32 model (heads of 64, which the kernels take) split over
    a mesh of the one card: the engine's greedy tokens equal the unsharded
    engine's, and each shard launches the kernels at its local heads."""
    from crane_tpu_torch.parallel.inference import shard_lm
    from crane_tpu_torch.parallel.sharding import make_mesh

    cfg = dataclasses.replace(QWEN3_TINY, head_dim=64)
    lm = CausalLM(cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                                   dtype=torch.float32), dtype=torch.float32)
    slm = shard_lm(lm, make_mesh(dp, tp, [dev] * (dp * tp)))
    prompts = [[3, 14, 15, 92, 6], [7, 8, 9], [5] * 70, [1, 2]]

    def serve(model):
        engine = InferenceEngine(model, max_slots=4, max_seq_len=256, decode_tokens_per_seq=4)
        queues = [engine.submit(EngineRequest(f"r{i}", p, 12, SamplingOptions(
            do_sample=False, repetition_penalty=1.0))) for i, p in enumerate(prompts)]
        for _ in range(300):
            if not engine.step() and engine.request_q.empty():
                break
        out = []
        for q in queues:
            toks = []
            while not (r := q.get(timeout=60)).finished:
                if r.token is not None:
                    toks.append(r.token)
            assert r.error is None, r.error
            out.append(toks)
        return out

    kernels.reset_launch_counts()
    ref = serve(lm)
    ref_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert serve(slm) == ref
    got = kernels.launch_counts()
    assert got["fp_decode_attention"] == dp * tp * ref_counts["fp_decode_attention"] > 0
    assert got["flash_attention_causal"] == tp * ref_counts["flash_attention_causal"] > 0


# Qwen3-0.6B's fused widths at I = 1024: q|k|v (2048 + 1024 + 1024) and
# gate|up (3072 + 3072)
FUSED_PARTS = {"qkv": (2048, 1024, 1024), "gate_up": (3072, 3072)}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 3, 8, 256])
@pytest.mark.parametrize("kind", ["qkv", "gate_up"])
def test_k6_fused_widths_match_plain_and_the_unfused_products(dev, bits, M, kind):
    """K6 on a fused weight (models/fuse.py) against its plain version, and
    against the unfused products concatenated: bit for bit where the
    reduction over I runs in the same order at both widths (the CUDA-core
    kernel at M < 4; the tensor-core kernel where mma_plan gives the fused
    weight and the part the same cluster split), else within the kernel
    bound. (chip_smoke.py's check_fused_k6 reads the instance that ran from
    a profiler trace.)"""
    from crane_tpu_torch.models.fuse import fuse_layer
    from crane_tpu_torch.ops.cuda.quant_matmul import MMA_MIN_M, mma_plan

    gen = torch.Generator(device=dev).manual_seed(M + bits + len(kind))
    parts = [quantize_weight(rnd(gen, 1024, o, dtype=torch.float32) * 1024 ** -0.5, bits=bits)
             for o in FUSED_PARTS[kind]]
    layer = ({"attn": dict(zip(("wq", "wk", "wv"), parts))} if kind == "qkv"
             else {"mlp": dict(zip(("gate", "up"), parts))})
    fused_layer = fuse_layer(layer)
    w = fused_layer["attn"]["wqkv"] if kind == "qkv" else fused_layer["mlp"]["gate_up"]
    assert w.packed == (bits == 4) and w.shape == (1024, sum(FUSED_PARTS[kind]))
    x = rnd(gen, M, 1024, dtype=torch.bfloat16)
    got = quant_matmul(x, w.codes, w.scales, bits=bits)
    torch.testing.assert_close(got.float(), quant_matmul_plain(x.float(), w.codes, w.scales,
                                                               bits=bits),
                               **TOL[torch.bfloat16])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fused_plan = mma_plan(M, 1024, w.shape[1], bits, sms)
    o = 0
    for p in parts:
        ref = quant_matmul(x, p.codes, p.scales, bits=bits)
        piece = got[:, o:o + p.shape[1]]
        if M < MMA_MIN_M or mma_plan(M, 1024, p.shape[1], bits, sms)[1] == fused_plan[1]:
            assert torch.equal(piece, ref), (M, p.shape, fused_plan)
        else:
            torch.testing.assert_close(piece.float(), ref.float(), **TOL[torch.bfloat16])
        o += p.shape[1]


@pytest.mark.parametrize("quant", [None, 4], ids=["bf16", "w4-kv4"])
def test_fused_layer_runs_the_kernels_on_contiguous_kv(dev, quant):
    """A fused tiny model (heads of 64, which the kernels take) on the card:
    a fresh prefill feeds K2 the sliced v (a view of the fused product
    unless made contiguous: the wrappers refuse views), a chunk K3 or K5,
    decode K1 or K4; logits match the unfused model's and greedy tokens
    equal them (float32 activations, so cuBLAS's choice of algorithm at
    the wider product moves them by float32 rounding only). At w4 kv4 a
    decode step launches K6 three times fewer a layer."""
    cfg = dataclasses.replace(QWEN3_TINY, head_dim=64)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.float32)
    if quant:
        params = quantize_params(params, bits=quant)
    fused = CausalLM(cfg, params, dtype=torch.float32, fuse=True)
    unfused = CausalLM(cfg, params, dtype=torch.float32, fuse=False)
    assert "wqkv" in fused.params["layers"][0]["attn"]
    ids = [[(7 * i + 3) % cfg.vocab_size for i in range(40)]]
    kernels.reset_launch_counts()
    logits = [lm.prefill(lm.init_cache(1, 128, quant_bits=quant), ids, [40])[0]
              for lm in (fused, unfused)]
    assert kernels.launch_counts()["flash_attention_causal"] == 2 * cfg.num_layers
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-4, atol=1e-4)
    gen = GenerationConfig.greedy(16, kv_quant_bits=quant)
    assert fused.generate(ids[0], gen) == unfused.generate(ids[0], gen)
    steps = []
    for lm in (fused, unfused):
        _, cache = lm.prefill(lm.init_cache(1, 128, quant_bits=quant), ids, [40])
        # a continuation chunk over the cache, then one decode step
        lm.prefill(cache, [ids[0][:8]], [8], start=40)
        kernels.reset_launch_counts()
        with graphs.eager():
            lm.decode_steps(cache, torch.ones(1, dtype=torch.int32, device=dev),
                            torch.full((1, 8), -1, dtype=torch.int32, device=dev),
                            SamplingParams.make(1, do_sample=False, device=dev),
                            torch.Generator(device=dev), 1)
        steps.append(kernels.launch_counts())
    if quant:
        assert steps[1]["quant_matmul[w4]"] - steps[0]["quant_matmul[w4]"] == 3 * cfg.num_layers
        assert steps[0]["quant_decode_attention[kv4]"] == cfg.num_layers
    else:
        assert steps[0]["fp_decode_attention"] == cfg.num_layers


# -- K8: the routed experts (ops/cuda/moe.py) ----------------------------------

# (experts, picks, hidden, expert width): Qwen3-Next-80B-A3B's and LFM2-24B-A2B's
MOE_SHAPES = {"next": (512, 10, 2048, 512), "lfm2": (64, 4, 2048, 1536)}


@pytest.fixture(scope="module")
def moe_experts_bf16():
    """Both expert shapes' weights in bf16 on the card (3.2 GB and 1.2 GB)."""
    if os.environ.get("CRANE_CUDA_TESTS") != "1" or not torch.cuda.is_available():
        pytest.skip("CUDA kernel tests need CRANE_CUDA_TESTS=1 and a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(24)
    out = {}
    for name, (n, k, E, I) in MOE_SHAPES.items():
        out[name] = (rnd(gen, n, E, I, dtype=torch.bfloat16) * E ** -0.5,
                     rnd(gen, n, E, I, dtype=torch.bfloat16) * E ** -0.5,
                     rnd(gen, n, I, E, dtype=torch.bfloat16) * I ** -0.5)
    return out


def _moe_picks(gen, T, n, k, dev):
    """x-independent router picks: the top k of random softmax scores,
    renormalised (w float32, sel int64)."""
    probs = torch.softmax(torch.randn(T, n, generator=gen, device=dev) * 3, -1)
    w, sel = torch.topk(probs, k, dim=-1)
    return w / w.sum(-1, keepdim=True), sel


@pytest.mark.parametrize("shape", list(MOE_SHAPES))
@pytest.mark.parametrize("T", [1, 8, 32, 512])
def test_k8_matches_plain(dev, moe_experts_bf16, shape, T):
    """K8 against its plain version at both expert shapes, decode rows to a
    512-token chunk; two launches give the same bits."""
    n, k, E, I = MOE_SHAPES[shape]
    gate, up, down = moe_experts_bf16[shape]
    gen = torch.Generator(device=dev).manual_seed(T)
    x = rnd(gen, T, E, dtype=torch.bfloat16)
    w, sel = _moe_picks(gen, T, n, k, dev)
    got = k8.moe_experts(x, w, sel, gate, up, down)
    ref = k8.moe_experts_plain(x, w, sel, gate, up, down)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[torch.bfloat16])
    assert torch.equal(got, k8.moe_experts(x, w, sel, gate, up, down))


@pytest.mark.parametrize("T", [1, 40, 300])
@pytest.mark.parametrize("act", k8.ACTS)
def test_k8_float32_and_edges_match_plain(dev, T, act):
    """The float32 (CUDA-core) form, and bf16 with every token on the same
    k experts (T pairs an expert: several row tiles), an expert width that
    is not a multiple of a column tile, and gelu."""
    n, k, E, I = 24, 3, 136, 40
    gen = torch.Generator(device=dev).manual_seed(T)
    for dtype in (torch.float32, torch.bfloat16):
        gate, up = (rnd(gen, n, E, I, dtype=dtype) * E ** -0.5 for _ in range(2))
        down = rnd(gen, n, I, E, dtype=dtype) * I ** -0.5
        x = rnd(gen, T, E, dtype=dtype)
        w, sel = _moe_picks(gen, T, n, k, dev)
        for picks in (sel, torch.tensor([[5, 0, 23]], device=dev).expand(T, 3).contiguous()):
            got = k8.moe_experts(x, w, picks, gate, up, down, act=act)
            ref = k8.moe_experts_plain(x, w, picks, gate, up, down, act=act)
            torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("shape", list(MOE_SHAPES))
def test_k8_shards_match_plain(dev, moe_experts_bf16, shape):
    """A tensor-parallel shard (``offset``, ``partial``): float32 partials
    that match the plain version's and sum to the whole layer."""
    n, k, E, I = MOE_SHAPES[shape]
    gate, up, down = moe_experts_bf16[shape]
    gen = torch.Generator(device=dev).manual_seed(2)
    x = rnd(gen, 32, E, dtype=torch.bfloat16)
    w, sel = _moe_picks(gen, 32, n, k, dev)
    parts = []
    for t in range(2):
        cut = slice(t * n // 2, (t + 1) * n // 2)
        args = (x, w, sel, gate[cut], up[cut], down[cut])
        part = k8.moe_experts(*args, offset=t * n // 2, partial=True)
        assert part.dtype == torch.float32
        torch.testing.assert_close(part, k8.moe_experts_plain(*args, offset=t * n // 2,
                                                              partial=True),
                                   **TOL[torch.bfloat16])
        parts.append(part)
    whole = k8.moe_experts(x, w, sel, gate, up, down, partial=True)
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-5)


def test_k8_graph_replay_equals_eager(dev, moe_experts_bf16):
    """K8 captured in a CUDA graph at Qwen3-Next's 32-row decode shape and
    replayed with new tokens and picks gives the eager call's bits: the
    grouping runs on the device and the grids come from shapes alone."""
    n, k, E, I = MOE_SHAPES["next"]
    gate, up, down = moe_experts_bf16["next"]
    gen = torch.Generator(device=dev).manual_seed(7)
    x = rnd(gen, 32, E, dtype=torch.bfloat16)
    w, sel = _moe_picks(gen, 32, n, k, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k8.moe_experts(x, w, sel, gate, up, down)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k8.moe_experts(x, w, sel, gate, up, down)
    for seed in range(4):
        x.copy_(rnd(gen, 32, E, dtype=torch.bfloat16))
        nw, nsel = _moe_picks(gen, 32, n, k, dev)
        if seed == 3:  # every row on the same experts
            nsel = nsel[:1].expand(32, k).contiguous()
        w.copy_(nw)
        sel.copy_(nsel)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k8.moe_experts(x, w, sel, gate, up, down)), seed


def test_k8_grouping_matches_plain(dev):
    """The device grouping's order, first slots and work items against the
    plain version's sort, in a shard and across row tiles."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for T, n, k, offset, m, bm in [(32, 512, 10, 0, 512, 16), (512, 64, 4, 0, 64, 64),
                                   (300, 64, 8, 16, 32, 16), (1, 512, 10, 256, 256, 16)]:
        _, sel = _moe_picks(gen, T, n, k, dev)
        order, start, items, n_items = k8.moe_group(sel, m, offset, bm)
        r_order, r_start, r_items = k8.moe_group_plain(sel.cpu(), m, offset, bm)
        assert start.cpu().tolist() == r_start.tolist()
        assert order[:int(start[-1])].cpu().tolist() == r_order.tolist()
        assert int(n_items) == len(r_items) <= len(items)
        assert items[:int(n_items)].cpu().tolist() == r_items.tolist()


def test_k8_compiles_without_spills(dev):
    for gate_up in (True, False):
        for bm in k8.ROW_TILES:
            info = k8.kernel_info(gate_up, bm)
            assert info["local_bytes"] == 0, (gate_up, bm, info)
            assert info["rows"] == bm and info["threads"] == 128


@pytest.fixture
def moe_lms(dev):
    """The tiny MoE hybrid in float32 on the card (K8's CUDA-core form) and
    on the CPU (the dense dispatch), same weights."""
    cfg = transformer_config_from_hf(TINY_MOE)
    sd = hf_state_dict(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    return (CausalLM(cfg, map_hf_weights(cfg, sd, torch.float32), dtype=torch.float32),
            CausalLM(cfg, map_hf_weights(cfg, sd, torch.float32, dev), dtype=torch.float32))


def test_moe_generate_on_card_matches_cpu(moe_lms):
    """A 300-token prefill's logits and greedy generation, K8 on the card
    against the CPU's dense dispatch; every MoE layer call a K8 launch."""
    cpu, gpu = moe_lms
    ids = [3 + 7 * i % 250 for i in range(280)]
    padded = [ids + [0] * 20]
    kernels.reset_launch_counts()
    logits_g, _ = gpu.prefill(gpu.init_cache(1, 512), padded, [len(ids)])
    assert kernels.launch_counts()["moe_experts[gate_up]"] == gpu.config.num_layers
    logits_c, _ = cpu.prefill(cpu.init_cache(1, 512), padded, [len(ids)])
    torch.testing.assert_close(logits_g.cpu(), logits_c, rtol=1e-4, atol=1e-4)
    gen = GenerationConfig.greedy(24)
    prompt = list(range(3, 200, 2))
    assert gpu.generate(prompt, gen) == cpu.generate(prompt, gen)
