#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``crane_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It needs no network, no checkpoint and no
tokenizer: weights are random, drawn from a seeded ``torch.Generator``, and
requests are token ids. Phases, each reported on its own line:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compile the kernels under ``crane_tpu_torch/csrc/`` with ``nvcc``;
3. kernels: K1 (decode), K2 (fresh prefill), K3 (continuation), K4
   (quantized decode), K5 (quantized continuation), K6 (quantized-weight
   matmul) and K7 (the GDN scan) against their plain PyTorch versions on
   the card, at the main paths' shapes (K1-K5 also at head_dim 256 with
   Qwen3.5's 8 query / 2 KV heads), each with its time beside the plain
   version's (K7 also beside the chunked route's, crane_tpu's default);
4. model: full-width Qwen3-0.6B; a 300-token prefill on the card agrees
   with the same prefill in float32 on the CPU; 64 greedy tokens through
   ``CausalLM.generate``; prefill ms and decode tok/s;
5. engine: ``InferenceEngine`` serves six concurrent requests (chunked
   admission, prefix reuse, one sampled request); every request finishes,
   the statistics reconcile, and K1, K2 and K3 were each launched by this
   main path;
6. quantized model: the same weights quantized in situ to int4 (head
   included); the 300-token prefill, and one decode step into an int8 and
   one into an int4 KV cache, agree with the same codes run in float32 on
   the CPU; 64 greedy tokens through ``generate`` on an int4 cache;
7. quantized engine: the six-request mix with int8 weights on an int8 KV
   cache, then with int4 weights on an int4 cache; K4, K5 and K6 were
   launched, at each bit width, by this quantized path;
8. hybrid model: full-width Qwen3.5-0.8B (18 Gated-DeltaNet and 6 gated
   attention layers, head_dim 256) with random bf16 weights in the HF
   layout, mapped by ``map_hf_weights``; the 300-token prefill run in
   float32 on the card (the kernels in float32) agrees with the same
   prefill in float32 on the CPU, and the bf16 prefill's distance from it
   is reported beside the CPU's own bf16 distance; 64 greedy tokens
   through ``generate`` in bf16; prefill ms and decode tok/s;
9. hybrid engine: the six-request mix on the hybrid model (prefix reuse
   off); K1, K2, K3 (at head_dim 256) and K7 were each launched by this
   hybrid path.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero,
and so does a run with no CUDA device, or outside a checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bf16 tolerance of a kernel against its plain version on the same inputs:
# both round the output to bf16 (at most half an ulp each, 2**-9 relative)
# and sum in float32 in other orders, so |kernel - plain| <= ATOL + RTOL*|plain|
# with RTOL two bf16 ulps and ATOL for outputs near zero.
KERNEL_RTOL = 2.0 ** -6
KERNEL_ATOL = 1e-3

# K7 against the plain scan: y is written in v's dtype (bf16 here), so it is
# held to the kernel bound above; the final state stays float32 in both and
# differs only by the order of float32 sums over a few hundred steps of a
# contractive update, so it is held to STATE_ATOL + STATE_RTOL * |plain|.
STATE_RTOL = 1e-4
STATE_ATOL = 1e-4

# model check: the card against float32 on the CPU, same weights.
# Activations round to bf16 (2**-9 relative) at every op of 28 layers, so
# the last-token logits may drift by a few percent of their spread: the
# relative L2 error must stay under LOGIT_REL_L2, and the greedy top-1 must
# agree unless the CPU's top two logits lie within LOGIT_TIE of each other
# (then either token is a correct greedy choice within the error bound).
LOGIT_REL_L2 = 5e-2
LOGIT_TIE = 0.05


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL) -> float:
    """max |got - ref|, raising unless every element is finite and within
    atol + rtol * |ref| (by default the kernel bound above)."""
    import torch

    err = (got.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3g} over the bound")
    return err.max().item()


def timed_row(name, src, replaces, errs, kernel_fn, plain_fn, shape, iters=20) -> dict:
    """The kernel's JSON row: its worst error over the cases and its time
    beside the plain version's at ``shape``, taken in turns (plain, kernel,
    kernel, plain) so drift hits both alike."""
    ms, plain_ms = paired_ms(kernel_fn, plain_fn, iters)
    log("kernels", f"{name}: max|err| {max(errs):.3g} (bound {KERNEL_ATOL:g} + 2^-6*|ref|), "
                   f"{ms:.4f} ms vs plain {plain_ms:.4f} ms at {shape}")
    return {"name": name, "route": "cuda", "source": f"crane_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0, "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms}


def paired_ms(kernel_fn, plain_fn, iters=20) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two timings taken in turns
    plain, kernel, kernel, plain."""
    p1, k1_ms, k2_ms, p2 = (cuda_ms(f, iters) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1_ms + k2_ms) / 2, (p1 + p2) / 2


def check_kernels() -> list[dict]:
    """Phase 3: K1-K3 against their plain versions in bf16 at the dense
    path's shapes (Hq=16, Hkv=8, D=128, plus D=64). Returns the JSON rows,
    launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    Hq, Hkv = 16, 8
    # K2: fresh prefill, S=1024, with each option
    errs = []
    for D in (64, 128):
        q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
        seg = torch.zeros(1, 1024, dtype=torch.int32, device="cuda")
        seg[0, 100:356] = 1
        seg[0, 700:760] = 2
        for label, seg_arg, kw in (("plain", None, {}), ("window=256", None, {"window": 256}),
                                   ("softcap=30", None, {"softcap": 30.0}),
                                   ("segments", seg, {})):
            got = k23.flash_attention_causal(q, k, v, seg_arg, scale=D ** -0.5, **kw)
            ref = k23.flash_attention_causal_plain(q, k, v, seg_arg, scale=D ** -0.5, **kw)
            errs.append(compare(f"K2 D={D} {label}", got, ref))
    rows = [timed_row("flash_attention_causal", "flash_attention.cu",
                      "crane_tpu/ops/pallas/flash_attention.py:187", errs,
                      lambda: k23.flash_attention_causal(q, k, v, scale=D ** -0.5),
                      lambda: k23.flash_attention_causal_plain(q, k, v, scale=D ** -0.5),
                      "B=1 S=1024 Hq=16 Hkv=8 D=128")]

    # K3: a 256-token chunk at offsets 0, 512 and 1000 of a T=2048 buffer
    errs = []
    for D in (64, 128):
        kc, vc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D)
        for off in (0, 512, 1000):
            q = rnd(1, 256, Hq, D)
            pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None].contiguous()
            got = k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5)
            ref = k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5)
            errs.append(compare(f"K3 D={D} offset={off}", got, ref))
    rows.append(timed_row("flash_attention_cached", "flash_attention.cu",
                          "crane_tpu/ops/pallas/flash_attention.py:384", errs,
                          lambda: k23.flash_attention_cached(q, kc, vc, pos, scale=D ** -0.5),
                          lambda: k23.flash_attention_cached_plain(q, kc, vc, pos, scale=D ** -0.5),
                          "B=1 S=256 at offset 1000, T=2048, Hq=16 Hkv=8 D=128"))

    # K1: B=8 rows over T=2048, ragged kv_valid including 0 and T
    errs = []
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    for D in (64, 128):
        q = rnd(8, 1, Hq, D)
        kc, vc = rnd(8, 2048, Hkv, D), rnd(8, 2048, Hkv, D)
        for label, kw in (("plain", {}), ("window=256", {"window": 256}),
                          ("softcap=30", {"logit_softcap": 30.0})):
            got = k1.fp_decode_attention(q, kc, vc, valid, scale=D ** -0.5, **kw)
            ref = k1.fp_decode_attention_plain(q, kc, vc, valid, scale=D ** -0.5, **kw)
            errs.append(compare(f"K1 D={D} {label}", got, ref))
    rows.append(timed_row("fp_decode_attention", "decode_attention.cu",
                          "crane_tpu/ops/pallas/quant_attention.py:266", errs,
                          lambda: k1.fp_decode_attention(q, kc, vc, valid, scale=D ** -0.5),
                          lambda: k1.fp_decode_attention_plain(q, kc, vc, valid, scale=D ** -0.5),
                          "B=8 T=2048 ragged kv_valid, Hq=16 Hkv=8 D=128"))
    return rows


# kv_valid of the decode kernels' cases: ragged, with an empty and a full row
RAGGED_VALID = [0, 1, 17, 300, 1000, 1500, 2047, 2048]
# (in, out) of Qwen3-0.6B's quantized linears: q, k/v, o, gate/up, down, and
# the int4 head over the vocabulary padded to a multiple of 512
LINEAR_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
                 (1024, 152064)]


def check_quant_kernels() -> list[dict]:
    """Phase 3, quantized half: K6 (w8, w4) at M in {1, 8, 256} on every
    quantized linear of the path, K4 and K5 (kv8, kv4) at D in {64, 128}
    with a window and a softcap. Each kernel is held against its plain
    version computed in float32 from the same codes; it is timed against
    the plain version in bf16, the path's dtype. One JSON row per kernel and
    bit width, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache
    from crane_tpu_torch.ops.linear import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows = []
    for bits in (8, 4):
        errs = []
        for I, O in LINEAR_SHAPES:
            w = quantize_weight(rnd(I, O) * I ** -0.5, bits=bits)
            for M in (1, 8, 256):
                x = rnd(M, I).to(torch.bfloat16)
                got = quant_matmul(x, w.codes, w.scales, bits=bits)
                ref = quant_matmul_plain(x.float(), w.codes, w.scales, bits=bits)
                errs.append(compare(f"K6 w{bits} M={M} I={I} O={O}", got, ref))
                if I == 1024 and O in (3072, 152064) and M in (1, 8):
                    t = [cuda_ms(f) for f in (
                        lambda: quant_matmul_plain(x, w.codes, w.scales, bits=bits),
                        lambda: quant_matmul(x, w.codes, w.scales, bits=bits))]
                    log("kernels", f"K6 w{bits} M={M} I={I} O={O}: {t[1]:.4f} ms vs plain {t[0]:.4f} ms")
        w = quantize_weight(rnd(1024, 3072) * 1024 ** -0.5, bits=bits)
        x = rnd(8, 1024).to(torch.bfloat16)
        rows.append(timed_row(f"quant_matmul[w{bits}]", "quant_matmul.cu",
                              "crane_tpu/ops/pallas/quant_matmul.py:" + ("102" if bits == 8 else "115"),
                              errs, lambda: quant_matmul(x, w.codes, w.scales, bits=bits),
                              lambda: quant_matmul_plain(x, w.codes, w.scales, bits=bits),
                              "M=8 I=1024 O=3072 (gate/up at 8 slots)"))

    kws = (("plain", {}), ("window=256", {"window": 256}), ("softcap=30", {"logit_softcap": 30.0}))
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    for bits in (8, 4):
        dec_errs, chunk_errs = [], []
        # head_dim 256 (Qwen3.5's 8/2 heads) first: the rows are timed at
        # the last shape, D=128 with Qwen3-0.6B's 16/8 heads
        for D, Hq, Hkv in ((256, 8, 2), (64, 16, 8), (128, 16, 8)):
            cache = QuantLayerKVCache.empty(8, 2048, Hkv, D, bits=bits, device="cuda")
            cache.update(rnd(8, 2048, Hkv, D).to(torch.bfloat16),
                         rnd(8, 2048, Hkv, D).to(torch.bfloat16), 0)
            ops = (cache.k, cache.v, cache.k_scale, cache.v_scale)
            row = cache.row(3)
            row_ops = (row.k, row.v, row.k_scale, row.v_scale)
            qd = rnd(8, 1, Hq, D).to(torch.bfloat16)
            qc = rnd(1, 256, Hq, D).to(torch.bfloat16)
            for label, kw in kws:
                got = k45.quant_decode_attention(qd, *ops, valid, bits=bits, scale=D ** -0.5, **kw)
                ref = k45.quant_decode_attention_plain(qd.float(), *ops, valid, bits=bits,
                                                       scale=D ** -0.5, **kw)
                dec_errs.append(compare(f"K4 kv{bits} D={D} {label}", got, ref))
                for off in (0, 512, 1000):
                    pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None]
                    got = k45.quant_cached_attention(qc, *row_ops, pos, bits=bits,
                                                     scale=D ** -0.5, **kw)
                    ref = k45.quant_cached_attention_plain(qc.float(), *row_ops, pos, bits=bits,
                                                           scale=D ** -0.5, **kw)
                    chunk_errs.append(compare(f"K5 kv{bits} D={D} offset={off} {label}", got, ref))
            if D == 256:
                log_times(f"K4 kv{bits} B=8 T=2048 ragged, Hq=8 Hkv=2 D=256",
                          lambda: k45.quant_decode_attention(qd, *ops, valid, bits=bits,
                                                             scale=D ** -0.5),
                          lambda: k45.quant_decode_attention_plain(qd, *ops, valid, bits=bits,
                                                                   scale=D ** -0.5))
                log_times(f"K5 kv{bits} B=1 S=256 at offset 1000, T=2048, Hq=8 Hkv=2 D=256",
                          lambda: k45.quant_cached_attention(qc, *row_ops, pos, bits=bits,
                                                             scale=D ** -0.5),
                          lambda: k45.quant_cached_attention_plain(qc, *row_ops, pos, bits=bits,
                                                                   scale=D ** -0.5))
        rows.append(timed_row(
            f"quant_decode_attention[kv{bits}]", "quant_decode_attention.cu",
            "crane_tpu/ops/pallas/quant_attention.py:367", dec_errs,
            lambda: k45.quant_decode_attention(qd, *ops, valid, bits=bits, scale=D ** -0.5),
            lambda: k45.quant_decode_attention_plain(qd, *ops, valid, bits=bits, scale=D ** -0.5),
            "B=8 T=2048 ragged kv_valid, Hq=16 Hkv=8 D=128"))
        rows.append(timed_row(
            f"quant_cached_attention[kv{bits}]", "quant_cached_attention.cu",
            "crane_tpu/ops/pallas/quant_attention.py:647", chunk_errs,
            lambda: k45.quant_cached_attention(qc, *row_ops, pos, bits=bits, scale=D ** -0.5),
            lambda: k45.quant_cached_attention_plain(qc, *row_ops, pos, bits=bits,
                                                     scale=D ** -0.5),
            "B=1 S=256 at offset 1000, T=2048, Hq=16 Hkv=8 D=128"))
    return rows


def log_times(label, kernel_fn, plain_fn) -> None:
    ms, plain_ms = paired_ms(kernel_fn, plain_fn)
    log("kernels", f"{label}: {ms:.4f} ms vs plain {plain_ms:.4f} ms")


# the head_dim 256 rows of K1-K3 count the launches of the hybrid path,
# under the wrapper's own counter
D256 = "[D256]"


def check_d256_kernels() -> list[dict]:
    """Phase 3, head_dim 256: K2, K3 and K1 in bf16 with Qwen3.5's 8 query
    and 2 KV heads (G = 4), with each option, at the shapes of the hybrid
    path (a 1024-token prefill, 256-token chunks into a 2048-slot row, 8
    ragged decode rows). One JSON row each, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda import decode_attention as k1
    from crane_tpu_torch.ops.cuda import flash_attention as k23

    gen = torch.Generator(device="cuda").manual_seed(2560)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    Hq, Hkv, D = 8, 2, 256
    scale = D ** -0.5
    q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
    seg = torch.zeros(1, 1024, dtype=torch.int32, device="cuda")
    seg[0, 100:356] = 1
    errs = []
    for label, seg_arg, kw in (("plain", None, {}), ("window=256", None, {"window": 256}),
                               ("softcap=30", None, {"softcap": 30.0}), ("segments", seg, {})):
        errs.append(compare(f"K2 D=256 {label}",
                            k23.flash_attention_causal(q, k, v, seg_arg, scale=scale, **kw),
                            k23.flash_attention_causal_plain(q, k, v, seg_arg, scale=scale, **kw)))
    rows = [timed_row("flash_attention_causal" + D256, "flash_attention.cu",
                      "crane_tpu/ops/pallas/flash_attention.py:187", errs,
                      lambda: k23.flash_attention_causal(q, k, v, scale=scale),
                      lambda: k23.flash_attention_causal_plain(q, k, v, scale=scale),
                      "B=1 S=1024 Hq=8 Hkv=2 D=256")]

    errs = []
    kc, vc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D)
    for off in (0, 512, 1000):
        qc = rnd(1, 256, Hq, D)
        pos = (torch.arange(256, dtype=torch.int32, device="cuda") + off)[None].contiguous()
        for label, kw in (("plain", {}), ("window=256", {"window": 256})):
            errs.append(compare(f"K3 D=256 offset={off} {label}",
                                k23.flash_attention_cached(qc, kc, vc, pos, scale=scale, **kw),
                                k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale,
                                                                 **kw)))
    rows.append(timed_row("flash_attention_cached" + D256, "flash_attention.cu",
                          "crane_tpu/ops/pallas/flash_attention.py:384", errs,
                          lambda: k23.flash_attention_cached(qc, kc, vc, pos, scale=scale),
                          lambda: k23.flash_attention_cached_plain(qc, kc, vc, pos, scale=scale),
                          "B=1 S=256 at offset 1000, T=2048, Hq=8 Hkv=2 D=256"))

    errs = []
    valid = torch.tensor(RAGGED_VALID, dtype=torch.int32, device="cuda")
    qd = rnd(8, 1, Hq, D)
    kc, vc = rnd(8, 2048, Hkv, D), rnd(8, 2048, Hkv, D)
    for label, kw in (("plain", {}), ("window=256", {"window": 256}),
                      ("softcap=30", {"logit_softcap": 30.0})):
        errs.append(compare(f"K1 D=256 {label}",
                            k1.fp_decode_attention(qd, kc, vc, valid, scale=scale, **kw),
                            k1.fp_decode_attention_plain(qd, kc, vc, valid, scale=scale, **kw)))
    rows.append(timed_row("fp_decode_attention" + D256, "decode_attention.cu",
                          "crane_tpu/ops/pallas/quant_attention.py:266", errs,
                          lambda: k1.fp_decode_attention(qd, kc, vc, valid, scale=scale),
                          lambda: k1.fp_decode_attention_plain(qd, kc, vc, valid, scale=scale),
                          "B=8 T=2048 ragged kv_valid, Hq=8 Hkv=2 D=256"))
    return rows


def check_gdn_kernel() -> dict:
    """Phase 3, K7: the GDN scan against its plain version (the step-by-
    step recurrence) at the hybrid path's shape, H=16 and K=V=128, bf16 q,
    k, v and float32 g, beta: batch 1 at S = 1, 300 and 1000, each from zero
    and from a random initial state, and batch 8 at S=256. Each case is
    timed against the plain scan and the chunked route (crane_tpu's
    default). Returns the JSON row, timed at B=1 S=1000, launches 0."""
    import torch

    from crane_tpu_torch.ops.cuda.gdn_scan import gdn_scan, gdn_scan_plain
    from crane_tpu_torch.ops.gdn import gdn_recurrence_chunked

    gen = torch.Generator(device="cuda").manual_seed(77)
    H, K, V = 16, 128, 128
    errs, row = [], None
    for B, S in ((1, 1), (1, 300), (1, 1000), (8, 256)):
        q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for d in (K, K, V))
        g = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.5
        beta = torch.rand(B, S, H, generator=gen, device="cuda")
        inits = (None, torch.randn(B, H, K, V, generator=gen, device="cuda") * 0.3) \
            if B == 1 else (None,)
        for s0 in inits:
            label = f"K7 B={B} S={S} {'init state' if s0 is not None else 'zero state'}"
            y, st = gdn_scan(q, k, v, g, beta, s0)
            yr, sr = gdn_scan_plain(q, k, v, g, beta, s0)
            errs.append(compare(f"{label} y", y, yr))
            compare(f"{label} state", st, sr, rtol=STATE_RTOL, atol=STATE_ATOL)
        it = 2 if S >= 300 else 5  # the plain scan runs S steps of small launches
        p1, ch1, k1_ms, k2_ms, ch2, p2 = (
            cuda_ms(f, n, warmup=1) for f, n in (
                (lambda: gdn_scan_plain(q, k, v, g, beta), it),
                (lambda: gdn_recurrence_chunked(q, k, v, g, beta), 5),
                (lambda: gdn_scan(q, k, v, g, beta), 20),
                (lambda: gdn_scan(q, k, v, g, beta), 20),
                (lambda: gdn_recurrence_chunked(q, k, v, g, beta), 5),
                (lambda: gdn_scan_plain(q, k, v, g, beta), it)))
        ms, plain_ms, chunked_ms = (k1_ms + k2_ms) / 2, (p1 + p2) / 2, (ch1 + ch2) / 2
        log("kernels", f"K7 B={B} S={S} H={H} K=V={K}: {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                       f"chunked route {chunked_ms:.4f} ms")
        if (B, S) == (1, 1000):
            row = {"name": "gdn_scan", "route": "cuda", "source": "crane_tpu_torch/csrc/gdn_scan.cu",
                   "replaces": "crane_tpu/ops/pallas/gdn_scan.py:126", "launches": 0,
                   "ms": ms, "plain_ms": plain_ms, "chunked_ms": chunked_ms}
    row["max_abs_err"] = max(errs)
    log("kernels", f"gdn_scan: max|err| of y {max(errs):.3g} (bound {KERNEL_ATOL:g} + 2^-6*|ref|), "
                   f"state within {STATE_ATOL:g} + {STATE_RTOL:g}*|ref|")
    return row


def check_model():
    """Phase 4: full-width Qwen3-0.6B, random bf16 weights on the card."""
    import torch

    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import QWEN3_0_6B, init_params
    from crane_tpu_torch.ops.sampling import SamplingParams

    cfg = QWEN3_0_6B
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    lm = CausalLM(cfg, params, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen, device="cuda").tolist()

    # the same prefill on the card (kernels, bf16) and on the CPU (plain
    # versions, float32), on the same weights
    cache = lm.init_cache(1, 512)
    logits_gpu, _ = lm.prefill(cache, [prompt], [300])
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    lm_cpu = CausalLM(cfg, cpu_params, dtype=torch.float32)
    logits_cpu, _ = lm_cpu.prefill(lm_cpu.init_cache(1, 512), [prompt], [300])
    del lm_cpu, cpu_params
    compare_logits("model", "prefill logits card bf16 vs cpu f32", logits_gpu[0], logits_cpu[0])

    prefill_ms, decode_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("model", f"Qwen3-0.6B bf16, {cfg.num_layers} layers: prefill 300 tokens (bucket 512) "
                 f"{prefill_ms:.2f} ms, decode 63 tokens at batch 1 {decode_tps:.1f} tok/s; "
                 f"generate(64) matches")
    return lm


# Qwen3.5-0.8B's text model, as its published config.json gives it
# (huggingface.co/Qwen/Qwen3.5-0.8B, "text_config"): 24 layers as
# [gdn, gdn, gdn, full] x 6, hidden 1024, MLP 3584, 8 query / 2 KV heads of
# 256 with a sigmoid output gate and rotary on a quarter of each head
# (rot_dim 64, theta 1e7), 16 key and 16 value GDN heads of 128 with a
# 4-tap conv, vocabulary 248320, tied head, unit-offset RMSNorm (eps 1e-6).
# The text weights come to ~0.75 B parameters.
QWEN3_5_0_8B = {
    "model_type": "qwen3_5", "vocab_size": 248320, "hidden_size": 1024,
    "num_hidden_layers": 24, "num_attention_heads": 8, "num_key_value_heads": 2,
    "head_dim": 256, "intermediate_size": 3584, "rms_norm_eps": 1e-6,
    "rope_theta": 10000000.0, "partial_rotary_factor": 0.25,
    "max_position_embeddings": 262144, "tie_word_embeddings": True,
    "layer_types": (["linear_attention"] * 3 + ["full_attention"]) * 6,
    "linear_num_key_heads": 16, "linear_num_value_heads": 16,
    "linear_key_head_dim": 128, "linear_value_head_dim": 128,
    "linear_conv_kernel_dim": 4,
}


def check_hybrid_model():
    """Phase 8: full-width Qwen3.5-0.8B on the card. Random weights in the
    HF layout from a seeded generator go through map_hf_weights in bf16.

    The prefill check runs the same weights in float32 on the card and on
    the CPU. In bf16 this random-weight hybrid cannot meet LOGIT_REL_L2 on
    any device: its q and k are nearly orthogonal, so q . S cancels to a
    few hundredths of its terms and the gated RMSNorm rescales the result,
    magnifying every bf16 rounding upstream of it (on the CPU alone, bf16
    against float32 reads about 0.08 at 24 layers; the dense Qwen3-0.6B
    reads about 0.017). So the bf16 prefill's distance from the float32
    reference is measured and logged beside the CPU's own bf16 distance,
    and bf16 stays the path that generate and the engine drive."""
    import torch

    from crane_tpu_torch.models.auto import map_hf_weights, transformer_config_from_hf
    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.init import hf_state_dict

    cfg = transformer_config_from_hf(QWEN3_5_0_8B)
    gen = torch.Generator(device="cuda").manual_seed(35)
    params = map_hf_weights(cfg, hf_state_dict(cfg, gen, torch.bfloat16), torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    lm = CausalLM(cfg, params, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen, device="cuda").tolist()

    def prefill(model):
        return model.prefill(model.init_cache(1, 512), [prompt], [300])[0][0]

    logits_bf16 = prefill(lm)
    logits_f32 = prefill(CausalLM(cfg, _tree(params, lambda t: t.float()), dtype=torch.float32))
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    logits_cpu = prefill(CausalLM(cfg, cpu_params, dtype=torch.float32))
    logits_cpu_bf16 = prefill(CausalLM(cfg, _tree(params, lambda t: t.cpu()), dtype=torch.bfloat16))
    del cpu_params
    compare_logits("hybrid-model", "Qwen3.5-0.8B prefill logits card f32 vs cpu f32",
                   logits_f32, logits_cpu)
    for label, got in (("card bf16", logits_bf16), ("cpu bf16", logits_cpu_bf16)):
        rel_l2, top = logits_distance(got, logits_cpu)
        log("hybrid-model", f"Qwen3.5-0.8B prefill logits {label} vs cpu f32: rel L2 {rel_l2:.4g}, "
                            f"top-1 {top} vs {int(logits_cpu.argmax())}")

    prefill_ms, decode_tps = time_generate(lm, prompt, GenerationConfig.greedy(64))
    log("hybrid-model", f"Qwen3.5-0.8B bf16, {cfg.num_layers} layers ({n_params / 1e9:.3f} B "
                        f"parameters): prefill 300 tokens (bucket 512) {prefill_ms:.2f} ms, "
                        f"decode 63 tokens at batch 1 {decode_tps:.1f} tok/s; generate(64) matches")
    return lm


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def logits_distance(got, ref) -> tuple[float, int]:
    """(relative L2 error, greedy top-1) of finite card logits against the
    CPU reference; raises on non-finite logits or a shape mismatch."""
    import torch

    got, ref = got.float().cpu(), ref.float().cpu()
    if not torch.isfinite(got).all() or got.shape != ref.shape:
        raise AssertionError(f"card logits not finite or of shape {tuple(got.shape)}")
    return ((got - ref).norm() / ref.norm()).item(), int(got.argmax())


def compare_logits(phase: str, label: str, got, ref) -> None:
    """Card logits against the CPU float32 reference: finite, of the vocab's
    shape, relative L2 error within LOGIT_REL_L2, and the same greedy top-1
    unless the reference's top two lie within LOGIT_TIE."""
    rel_l2, _ = logits_distance(got, ref)
    got, ref = got.float().cpu(), ref.float().cpu()
    top2 = ref.topk(2)
    margin = (top2.values[0] - top2.values[1]).item()
    top_gpu, top_cpu = int(got.argmax()), int(top2.indices[0])
    tie_ok = ref[top_gpu].item() >= top2.values[0].item() - LOGIT_TIE
    log(phase, f"{label}: rel L2 {rel_l2:.4g} (limit {LOGIT_REL_L2:g}), "
               f"max|err| {(got - ref).abs().max().item():.4g}, logit std {ref.std().item():.4g}, "
               f"top-1 card {top_gpu} cpu {top_cpu}, cpu top-2 margin {margin:.4g}")
    if rel_l2 > LOGIT_REL_L2:
        raise AssertionError(f"{label}: card logits disagree with the CPU float32 reference")
    if top_gpu != top_cpu and not (margin < LOGIT_TIE and tie_ok):
        raise AssertionError(f"{label}: greedy top-1 of the card disagrees with the CPU reference")


def time_generate(lm, prompt, gen_cfg) -> tuple[float, float]:
    """The generate path's own steps, timed: prefill ms and decode tok/s at
    batch 1 (host clock, synchronised); then ``generate`` must return the
    same greedy tokens."""
    import torch

    from crane_tpu_torch.ops.sampling import SamplingParams

    n = gen_cfg.max_new_tokens
    padded = [prompt + [0] * (512 - len(prompt))]
    for _ in range(2):  # the second run is the measurement
        cache = lm.init_cache(1, 512, quant_bits=gen_cfg.kv_quant_bits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cache, padded, [len(prompt)])
        first = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    sp = SamplingParams.make(1, do_sample=False, device=lm.device)
    recent = torch.full((1, 64), -1, dtype=torch.int32, device="cuda")
    gen_dec = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    toks, _, _ = lm.decode_steps(cache, first, recent, sp, gen_dec, n - 1)
    manual = [int(first[0])] + toks[0].tolist()
    decode_s = time.perf_counter() - t0
    out = lm.generate(prompt, gen_cfg)
    if out != manual or len(out) != n or not all(0 <= t < lm.config.vocab_size for t in out):
        raise AssertionError("generate() disagrees with its own prefill + decode steps")
    return prefill_ms, (n - 1) / decode_s


def check_quant_model(lm):
    """Phase 6: the bf16 model's weights quantized in situ to int4 on the
    card (the tied head too); the same codes, with float32 scales and every
    other weight in float32, on the CPU. The 300-token prefill, card against
    CPU; then one decode step into the card's int8 and into its int4 KV
    cache after that prefill, against the same step on the CPU over a copy
    of the same cache (the KV codes are the card's: a bf16 key and its
    float32 counterpart can round to neighbouring int4 codes, which is the
    cache's quantization error, not the step's); then 64 greedy tokens
    through generate on an int4 cache."""
    import torch

    from crane_tpu_torch.models.auto import quantize_params
    from crane_tpu_torch.models.causal_lm import CausalLM, GenerationConfig
    from crane_tpu_torch.models.modules.transformer import forward_hidden, lm_logits
    from crane_tpu_torch.ops.kv_cache import KVCache, QuantLayerKVCache
    from crane_tpu_torch.ops.linear import QuantizedWeight

    cfg = lm.config
    params = quantize_params(lm.params, bits=4)
    if not isinstance(params.get("lm_head"), QuantizedWeight):
        raise AssertionError("int4 ISQ did not quantize the tied head")
    lm4 = CausalLM(cfg, params, dtype=torch.bfloat16)
    cpu_params = _tree(params, lambda t: t.to("cpu", torch.float32))
    cpu4 = CausalLM(cfg, cpu_params, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (300,), generator=gen).tolist()

    caches = {}
    for kv_bits in (8, 4):  # the prefill attends its own K/V, whatever the cache
        logits_gpu, caches[kv_bits] = lm4.prefill(lm4.init_cache(1, 512, quant_bits=kv_bits),
                                                  [prompt], [300])
    logits_cpu, _ = cpu4.prefill(cpu4.init_cache(1, 512), [prompt], [300])
    compare_logits("quant-model", "int4-weight prefill logits card bf16 vs cpu f32",
                   logits_gpu[0], logits_cpu[0])

    nxt = int(logits_cpu[0].argmax())
    for kv_bits, cache in caches.items():
        cpu_cache = KVCache(
            layers=tuple(QuantLayerKVCache(k=c.k.cpu(), v=c.v.cpu(), k_scale=c.k_scale.cpu(),
                                           v_scale=c.v_scale.cpu(), bits=c.bits,
                                           n_kv_heads=c.n_kv_heads) for c in cache.layers),
            lengths=cache.lengths.cpu())
        logits = []
        for model, c in ((lm4, cache), (cpu4, cpu_cache)):
            tok = torch.tensor([[nxt]], dtype=torch.int32, device=model.device)
            hidden, _ = forward_hidden(cfg, model.params, tok, c, c.lengths, model.rope)
            logits.append(lm_logits(cfg, model.params, hidden)[0, 0])
        compare_logits("quant-model",
                       f"decode step on the int{kv_bits} KV cache card bf16 vs cpu f32", *logits)
    del cpu4, cpu_params, caches

    prefill_ms, decode_tps = time_generate(lm4, prompt, GenerationConfig.greedy(64, kv_quant_bits=4))
    log("quant-model", f"Qwen3-0.6B int4 weights on an int4 KV cache: prefill 300 tokens "
                       f"(bucket 512) {prefill_ms:.2f} ms, decode 63 tokens at batch 1 "
                       f"{decode_tps:.1f} tok/s; generate(64) matches")
    return params


def _tree(tree, fn):
    """``fn`` over every dense tensor of a parameter tree; a QuantizedWeight
    moves to the CPU with its int8 codes and float32 scales unchanged."""
    from crane_tpu_torch.ops.linear import QuantizedWeight

    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, fn) for v in tree)
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(codes=tree.codes.cpu(), scales=tree.scales.cpu(),
                               block=tree.block, bits=tree.bits)
    return fn(tree)


def check_engine(lm, phase: str = "engine", kv_quant_bits: int | None = None) -> None:
    """Phases 5, 7 and 9: concurrent requests through the serving engine, on
    an fp or an int8/int4 KV cache. A hybrid model's engine keeps prefix
    reuse off, so the follow-up is admitted whole, in chunks."""
    import torch

    from crane_tpu_torch.serve.engine import (
        EngineRequest,
        FinishReason,
        InferenceEngine,
        SamplingOptions,
    )

    vocab = lm.config.vocab_size
    gen = torch.Generator().manual_seed(7)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    sampled = SamplingOptions(temperature=0.8, top_p=0.9, top_k=0,
                              repetition_penalty=1.1, do_sample=True)
    requests = [
        EngineRequest("p17", ids(17), 32, greedy),
        EngineRequest("p64", ids(64), 32, greedy),
        EngineRequest("p300", ids(300), 32, greedy),   # two chunks: K2 then K3 (or K5)
        EngineRequest("p1000", ids(1000), 24, greedy),  # four chunks
        EngineRequest("sampled", ids(120), 32, sampled),
    ]
    engine = InferenceEngine(lm, max_slots=8, max_seq_len=2048, prefill_chunk=256,
                             kv_quant_bits=kv_quant_bits)
    engine.warmup()
    queues = {r.request_id: engine.submit(r) for r in requests}
    results: dict[str, dict] = {rid: {"tokens": [], "reason": None} for rid in queues}
    followup = None
    t0 = time.perf_counter()
    for _ in range(20000):
        busy = engine.step()
        for rid, q in queues.items():
            while not q.empty():
                r = q.get_nowait()
                if r.error is not None:
                    raise AssertionError(f"request {rid} failed: {r.error}")
                if r.token is not None:
                    results[rid]["tokens"].append(r.token)
                if r.finished:
                    results[rid]["reason"] = r.finish_reason
        if followup is None and results["p300"]["reason"] is not None:
            # a later turn of the same conversation: the finished request's
            # prompt and output plus 300 new tokens, so the admission reuses
            # the resident prefix and continues through K3 (or K5); a hybrid
            # model admits it whole, in chunks
            prev = requests[2].prompt_ids + results["p300"]["tokens"]
            followup = EngineRequest("followup", prev + ids(300), 16, greedy)
            queues["followup"] = engine.submit(followup)
            results["followup"] = {"tokens": [], "reason": None}
        if followup is not None and not busy and engine.request_q.empty() \
                and all(r["reason"] is not None for r in results.values()):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    asked = {r.request_id: r.max_new_tokens for r in requests + [followup]}
    for rid, res in results.items():
        toks = res["tokens"]
        if res["reason"] != FinishReason.LENGTH or len(toks) != asked[rid] \
                or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{rid}: {len(toks)} of {asked[rid]} tokens, finish {res['reason']}")
    s = engine.stats
    prompt_total = sum(len(r.prompt_ids) for r in requests + [followup])
    hybrid = lm.config.gdn is not None
    reuse_ok = (s.prefix_hits == s.prefix_tokens_reused == 0 and not engine.prefix_cache
                if hybrid else s.prefix_hits == 1 and s.prefix_tokens_reused >= 256)
    if not (s.requests_received == s.requests_completed == len(asked)
            and s.requests_failed == s.requests_aborted == 0
            and s.generated_tokens == sum(asked.values())
            and s.prompt_tokens == prompt_total and reuse_ok):
        raise AssertionError(f"engine stats do not reconcile: {s.snapshot()}")
    log(phase, f"{len(asked)} requests finished in {wall:.2f} s, "
               f"{s.generated_tokens} tokens; prefix reuse {s.prefix_tokens_reused} tokens; "
               f"stats {json.dumps(s.snapshot())}")


def read_launches(path: str, rows: list[dict], counts: dict[str, int]) -> None:
    """Each row's launches from the path that drove it (a head_dim 256 row
    reads its wrapper's counter); fail for a kernel that path never
    launched."""
    log("launches", f"{path}: {json.dumps(counts)}")
    for row in rows:
        row["launches"] = counts[row["name"].removesuffix(D256)]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched by the {path}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "crane_tpu_torch")):
        print("chip_smoke.py runs from the root of a crane-tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible", file=sys.stderr)
        return 2

    from crane_tpu_torch.ops import cuda as kernels
    from crane_tpu_torch.ops.cuda import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    build.lib()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
                 f"({build.library_path().name})")

    rows = check_kernels()
    quant_rows = check_quant_kernels()
    hybrid_rows = check_d256_kernels() + [check_gdn_kernel()]

    # the dense main path: bf16 generation and serving (K1, K2, K3)
    kernels.reset_launch_counts()
    lm = check_model()
    check_engine(lm)
    read_launches("dense path", rows, kernels.launch_counts())

    # the quantized main path: int4 and int8 ISQ weights on int8 and int4
    # KV caches (K2 for fresh prefills, K4, K5 and K6 at each bit width)
    from crane_tpu_torch.models.auto import quantize_params
    from crane_tpu_torch.models.causal_lm import CausalLM

    kernels.reset_launch_counts()
    params4 = check_quant_model(lm)
    lm8 = CausalLM(lm.config, quantize_params(lm.params, bits=8), dtype=torch.bfloat16)
    check_engine(lm8, "quant-engine w8 kv8", kv_quant_bits=8)
    del lm8
    check_engine(CausalLM(lm.config, params4, dtype=torch.bfloat16), "quant-engine w4 kv4",
                 kv_quant_bits=4)
    counts = kernels.launch_counts()
    if counts["flash_attention_causal"] <= 0:
        raise AssertionError("the quantized path never launched K2")
    read_launches("quantized path", quant_rows, counts)
    del params4, lm

    # the hybrid main path: Qwen3.5-0.8B generation and serving (K1, K2, K3
    # at head_dim 256; K7 for every GDN prefill and continuation chunk)
    kernels.reset_launch_counts()
    lm35 = check_hybrid_model()
    check_engine(lm35, "hybrid-engine")
    read_launches("hybrid path", hybrid_rows, kernels.launch_counts())

    rows += quant_rows + hybrid_rows
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
