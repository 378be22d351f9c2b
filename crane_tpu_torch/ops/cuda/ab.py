"""Same-call A/B of the port's kernels and decode step on one card.

    python -m crane_tpu_torch.ops.cuda.ab [--other DIR] [--only CASES] [--json PATH]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It compiles the kernels it compares into small libraries of their own
(one ``nvcc`` per library, all started together, under ``build/ab/``), loads
them with ``ctypes`` and times the same C entry point on the same inputs in
alternating pairs (a, b, b, a, ...), each timing a run of launches queued
behind a device-side wait, so the events time the kernels and not the
host's rate of issuing them. It prints one line per case, with the median
of each side and their ratio.

- K6's two routes in this checkout, each forced at every M by building a
  copy with ``kMmaMinM`` past any M (the CUDA-core kernel) and one with it
  at 1 (the tensor-core kernel), over the quantized path's linear shapes
  and M in {1, 4, 8, 16, 64, 256}: the measurement behind ``kMmaMinM``.
- With ``--other DIR`` (another checkout, such as the parent commit
  unpacked with ``git archive`` into a directory ``.gitignore`` lists): K2
  and K3 in bf16 and K5 in bf16 (kv8, kv4) at the main path's shapes, that
  checkout's kernels against this one's; and the decode kernels K1, K4
  (kv8, kv4) and their with-stats forms in bf16 at the decode shapes (8
  ragged rows of a 2048-slot cache, one row of 16,000 live tokens in a
  16,384-slot cache without and with stats, 8 rows of a 4096-token sp slab
  with stats), each also split (``decode_splits``) against one block per
  (row, kv-head), and the split count the wrapper takes against half, one
  more and twice as many. Each decode call is first held to the kernel
  bound against its plain version.
- With ``--other DIR``, the wall time of a decode step of full-width
  Qwen3-0.6B (random weights from a seed, bf16 and w4 kv4, B=1 and B=8
  after a 300-token prefill into 2048-slot rows) on the host clock: one
  process per run, each importing one checkout's package, in turns other,
  this, this, other, ... (STEP_SCRIPT). The host sets the pace of a decode
  step, so this is where a wrapper's host work shows.

- K7's two routes in this checkout, the sequential scan against the
  chunkwise kernels, at H=16, K=V=128 (Qwen3.5-0.8B's GDN heads) in bf16,
  B in {1, 8} and S in {1, 8, 17, 32, 63, 64, 65, 128, 256, 300, 512,
  1000}: the measurement behind ``CHUNK_MIN_S``; with ``--other``, that
  checkout's K7 (its sequential scan before the chunkwise route) against
  the route this checkout's wrapper takes at each shape (this checkout's
  kernels normalize q and k themselves; the other's scan is given them
  normalized, so its row leaves out the wrapper's normalization). Each call
  is first held to the plain scan (S <= 300) or to the scan (longer). The
  chunkwise route's state pass at 16 columns a block against 32, each
  forced by a copy built with the choice fixed (the measurement behind
  taking 32 once B H V / 32 blocks fill the card).

``--only`` takes a comma-separated subset of ``k6,attention,decode,step,gdn``
(default all; attention, decode and step need ``--other``). ``--json PATH`` also writes
every case as ``[label, ms_a, ms_b]``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from crane_tpu_torch.ops.cuda import build

AB_DIR = build.BUILD_DIR.parent / "ab"
# device cycles the card waits before each timed run (about 2.5 ms)
BACKLOG_CYCLES = 5_000_000
PAIRS = 3
# (I, O) of Qwen3-0.6B's quantized linears and its int4 head (vocab padded)
LINEAR_SHAPES = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
                 (1024, 152064))
K6_ROWS = (1, 4, 8, 16, 64, 256)
# (D, Hq, Hkv): Qwen3-0.6B's heads, Qwen3.5-0.8B's, and head dim 64
HEADS = ((64, 16, 8), (128, 16, 8), (256, 8, 2))
# the decode cases: (label, B, T, kv_valid, with stats); each at Qwen3-0.6B's
# and Qwen3.5-0.8B's heads (the sp slab at Qwen3-0.6B's only)
DECODE_SHAPES = (
    ("B=8 T=2048 ragged", 8, 2048, (0, 1, 17, 300, 1000, 1500, 2047, 2048), False),
    ("B=1 T=16384 live 16000", 1, 16384, (16000,), False),
    ("B=1 T=16384 live 16000 with stats", 1, 16384, (16000,), True),
    ("B=8 sp slab T=4096 with stats", 8, 4096, (0, 1, 17, 300, 1000, 2048, 4095, 4096), True),
)
# K7's shapes: (B, S) at H=16, K=V=128
GDN_B = (1, 8)
GDN_S = (1, 8, 17, 32, 63, 64, 65, 128, 256, 300, 512, 1000)

# the decode C entries before the split-KV redesign took no scratch and no
# n_split (a checkout whose csrc/decode_attention.cu has no "n_split")
OLD_DECODE_SIGNATURES = {
    "crane_decode_attention": [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "crane_quant_decode_attention": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches queued behind a
    device-side wait (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(BACKLOG_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(a, b) -> tuple[float, float]:
    """Medians of ``PAIRS`` alternating timings of ``a`` and ``b``."""
    ta, tb = [], []
    for i in range(PAIRS):
        first, second = (a, b) if i % 2 == 0 else (b, a)
        t1, t2 = device_ms(first), device_ms(second)
        ta.append(t1 if i % 2 == 0 else t2)
        tb.append(t2 if i % 2 == 0 else t1)
    return sorted(ta)[PAIRS // 2], sorted(tb)[PAIRS // 2]


def _library(tag: str, csrc: Path, sources: tuple[str, ...], edit=None):
    """Start compiling ``sources`` of ``csrc`` (with the headers beside
    them; ``edit`` maps a source or header name to a (pattern, replacement)
    regular expression substitution) into ``build/ab/<tag>/lib.so``, a path
    of its own per checkout (a process loads a path once). Returns
    (process, library path)."""
    d = AB_DIR / tag
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for name in [f.name for f in csrc.glob("*.cuh")] + list(sources):
        text = (csrc / name).read_text()
        if edit and name in edit:
            text, n = re.subn(*edit[name], text)
            if n != 1:
                raise ValueError(f"{name}: {edit[name][0]!r} matched {n} times")
        (d / name).write_text(text)
    out = d / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           *(str(d / name) for name in sources)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def _entry(path: Path, name: str, signatures=build.SIGNATURES):
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = signatures[name]
    fn.restype = ctypes.c_int
    return fn


def _checked(fn):
    def call(*args):
        build.check_launch(fn.__name__, fn(*args))
    return call


def k6_routes(lib_cores: Path, lib_mma: Path, gen, log, results) -> None:
    from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul_plain
    from crane_tpu_torch.ops.linear import quantize_weight

    cores = _checked(_entry(lib_cores, "crane_quant_matmul"))
    mma = _checked(_entry(lib_mma, "crane_quant_matmul"))
    stream = build.stream_ptr(torch.device("cuda"))
    for bits in (8, 4):
        for I, O in LINEAR_SHAPES:
            w = quantize_weight(torch.randn(I, O, generator=gen, device="cuda") * I ** -0.5,
                                bits=bits)
            for M in K6_ROWS:
                if O > 4096 and M > 16:  # the head runs at the rows of a decode step
                    continue
                x = torch.randn(M, I, generator=gen, device="cuda").to(torch.bfloat16)
                out = torch.empty(M, O, dtype=torch.bfloat16, device="cuda")
                ref = quant_matmul_plain(x.float(), w.codes, w.scales, bits=bits)

                def run(fn):
                    return lambda: fn(1, bits, x.data_ptr(), w.codes.data_ptr(),
                                      w.scales.data_ptr(), out.data_ptr(), M, I, O, stream)

                for fn in (cores, mma):  # both routes compute K6's function
                    run(fn)()
                    torch.testing.assert_close(out.float(), ref, rtol=2 ** -6, atol=1e-3)
                label = f"K6 w{bits} M={M} I={I} O={O}: CUDA cores vs tensor cores"
                results.append((label, *ab_ms(run(cores), run(mma))))
                log(results[-1])


def attention_vs_other(lib_other: Path, lib_this: Path, gen, log, results) -> None:
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    stream = build.stream_ptr(torch.device("cuda"))
    flash = [_checked(_entry(p, "crane_flash_attention")) for p in (lib_other, lib_this)]
    quant = [_checked(_entry(p, "crane_quant_cached_attention")) for p in (lib_other, lib_this)]
    pos = (torch.arange(256, dtype=torch.int32, device="cuda") + 1000)[None].contiguous()
    for D, Hq, Hkv in HEADS:
        q, k, v = rnd(1, 1024, Hq, D), rnd(1, 1024, Hkv, D), rnd(1, 1024, Hkv, D)
        out = torch.empty_like(q)
        results.append((f"K2 bf16 S=1024 D={D} {Hq}/{Hkv}: other vs this", *ab_ms(*(
            (lambda f=f: f(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                           None, None, None, 1, 1024, 1024, Hq, Hkv, D, D ** -0.5, 0, 0.0,
                           stream)) for f in flash))))
        log(results[-1])
        kc, vc, qc = rnd(1, 2048, Hkv, D), rnd(1, 2048, Hkv, D), rnd(1, 256, Hq, D)
        oc = torch.empty_like(qc)
        results.append((f"K3 bf16 chunk 256 at 1000 of 2048, D={D} {Hq}/{Hkv}: other vs this",
                         *ab_ms(*((lambda f=f: f(1, qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                                 oc.data_ptr(), None, None, pos.data_ptr(), None,
                                                 1, 256, 2048, Hq, Hkv, D, D ** -0.5, 0, 0.0,
                                                 stream)) for f in flash))))
        log(results[-1])
        if D == 64:
            continue
        for bits in (8, 4):
            c = QuantLayerKVCache.empty(1, 2048, Hkv, D, bits=bits, device="cuda")
            c.update(kc, vc, 0)
            results.append((f"K5 bf16 kv{bits} chunk 256 at 1000 of 2048, D={D} {Hq}/{Hkv}: "
                            f"other vs this", *ab_ms(*(
                                (lambda f=f: f(1, bits, qc.data_ptr(), c.k.data_ptr(),
                                               c.v.data_ptr(), c.k_scale.data_ptr(),
                                               c.v_scale.data_ptr(), oc.data_ptr(), None, None,
                                               pos.data_ptr(), 1, 256, 2048, Hq, Hkv, D,
                                               D ** -0.5, 0, 0.0, stream)) for f in quant))))
            log(results[-1])


def decode_vs_other(lib_other: Path, lib_this: Path, other_splits: bool, gen, log,
                    results) -> None:
    """K1/K4 (and -S) cases: the other checkout's kernel against this one's
    as the wrappers launch it, and this one's split against n_split = 1 and
    other counts. ``other_splits``: the other checkout's entries take the
    split-KV arguments too."""
    from crane_tpu_torch.ops.cuda import quant_attention as k45
    from crane_tpu_torch.ops.cuda.decode_attention import decode_split_count
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache

    names = {16: "crane_decode_attention", 8: "crane_quant_decode_attention",
             4: "crane_quant_decode_attention"}
    stream = build.stream_ptr(torch.device("cuda"))
    other_sigs = build.SIGNATURES if other_splits else OLD_DECODE_SIGNATURES
    for label, B, T, valid_list, stats in DECODE_SHAPES:
        for D, Hq, Hkv in ((128, 16, 8), (256, 8, 2))[:1 if stats else 2]:
            valid = torch.tensor(valid_list, dtype=torch.int32, device="cuda")
            q = torch.randn(B, 1, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            out = torch.empty_like(q)
            m, l = (torch.empty(B, Hq, device="cuda") for _ in range(2))
            counters = torch.zeros(B * Hkv, dtype=torch.int32, device="cuda")
            for bits in (16, 8, 4):
                n = decode_split_count(q, Hkv, T, bits)  # as the wrapper launches it
                scratch = torch.empty(B * Hq * 2 * n * (D + 2), device="cuda")
                if bits == 16:
                    ops = (k, v)
                    plain = (lambda: k45.decode_attention_with_stats_plain(
                        q, k, v, None, None, valid, bits=16, scale=D ** -0.5)[0])
                else:
                    c = QuantLayerKVCache.empty(B, T, Hkv, D, bits=bits, device="cuda")
                    c.update(k, v, 0)
                    ops = (c.k, c.v, c.k_scale, c.v_scale)
                    plain = (lambda ops=ops: k45.quant_decode_attention_plain(
                        q.float(), *ops, valid, bits=bits, scale=D ** -0.5))
                head = [1] + ([bits] if bits != 16 else []) + [q.data_ptr()] + [
                    t.data_ptr() for t in ops] + [valid.data_ptr(), out.data_ptr(),
                                                  m.data_ptr() if stats else None,
                                                  l.data_ptr() if stats else None]
                shape = [B, T, Hq, Hkv, D, D ** -0.5, 0, 0.0]

                def call(fn, splits, n_split=n, head=head, scratch=scratch):
                    if not splits:
                        return lambda: fn(*head, *shape, stream)
                    acc = scratch.data_ptr()
                    ml = acc + B * Hq * n_split * D * 4
                    return lambda: fn(*head, acc, ml, counters.data_ptr(), *shape, n_split,
                                      stream)

                this = _checked(_entry(lib_this, names[bits]))
                other = _checked(_entry(lib_other, names[bits], other_sigs))
                ref = plain().float()
                for fn in (call(other, other_splits), call(this, True), call(this, True, 1),
                           call(this, True, 2 * n)):
                    fn()
                    torch.testing.assert_close(out.float(), ref, rtol=build.KERNEL_RTOL,
                                               atol=build.KERNEL_ATOL)
                kind = ("K1" if bits == 16 else f"K4 kv{bits}") + ("-S" if stats else "")
                case = f"{kind} bf16 {label}, D={D} {Hq}/{Hkv}"
                results.append((f"{case}: other vs this (n_split {n})",
                                *ab_ms(call(other, other_splits), call(this, True))))
                log(results[-1])
                if n > 1:
                    results.append((f"{case}: n_split 1 vs {n}",
                                    *ab_ms(call(this, True, 1), call(this, True))))
                    log(results[-1])
                    # the wrapper's count against half, one more and twice as many
                    for other_n in (n // 2, n + 1, 2 * n):
                        results.append((f"{case}: n_split {n} vs {other_n}",
                                        *ab_ms(call(this, True), call(this, True, other_n))))
                        log(results[-1])


def gdn_routes(lib_this: Path, lib_other: Path | None, libs_cols: tuple[Path, Path], gen, log,
               results) -> None:
    """K7: this checkout's scan against its chunkwise kernels at every
    (B, S), the chunkwise state pass at 16 columns a block against 32
    (``libs_cols``) from S = 128, and with another checkout the route this
    wrapper takes against that checkout's K7, each call checked first."""
    from crane_tpu_torch.ops.cuda.gdn_scan import (
        chunk_scratch_floats,
        gdn_route,
        gdn_scan_plain,
    )
    from crane_tpu_torch.ops.gdn import l2norm

    stream = build.stream_ptr(torch.device("cuda"))
    scan = _checked(_entry(lib_this, "crane_gdn_scan"))
    chunk = _checked(_entry(lib_this, "crane_gdn_chunk"))
    other = _checked(_entry(lib_other, "crane_gdn_scan")) if lib_other is not None else None
    narrow, wide = (_checked(_entry(p, "crane_gdn_chunk")) for p in libs_cols)
    H, K, V = 16, 128, 128
    for B in GDN_B:
        for S in GDN_S:
            q, k, v = (torch.randn(B, S, H, d, generator=gen, device="cuda").to(torch.bfloat16)
                       for d in (K, K, V))
            g = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.5
            beta = torch.rand(B, S, H, generator=gen, device="cuda")
            y = torch.empty_like(v)
            st = torch.empty(B, H, K, V, device="cuda")
            n = chunk_scratch_floats(B, S, H, K, V)
            scratch = torch.empty(n, device="cuda")
            head = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    beta.data_ptr(), None, y.data_ptr(), st.data_ptr())
            # the other checkout's scan takes q and k normalized by its wrapper
            qn, kn = (l2norm(q) * K ** -0.5).contiguous(), l2norm(k).contiguous()
            normed = (1, qn.data_ptr(), kn.data_ptr(), *head[3:])
            calls = {"scan": lambda: scan(*head, B, S, H, K, V, stream),
                     "chunk": lambda: chunk(*head, scratch.data_ptr(), n, B, S, H, K, V, stream)}
            if other is not None:
                calls["other"] = lambda: other(*normed, B, S, H, K, V, stream)
            if S >= 128:
                for cols, fn in ((16, narrow), (32, wide)):
                    calls[f"{cols} columns"] = (lambda fn=fn: fn(*head, scratch.data_ptr(), n, B,
                                                                  S, H, K, V, stream))
            ref = gdn_scan_plain(q, k, v, g, beta) if S <= 300 else None
            for name, fn in calls.items():
                fn()
                if ref is None:  # the chunkwise route against the scan
                    ref = (y.clone(), st.clone())
                    continue
                torch.testing.assert_close(y.float(), ref[0].float(), rtol=build.KERNEL_RTOL,
                                           atol=build.KERNEL_ATOL, msg=f"K7 {name} y")
                torch.testing.assert_close(st, ref[1], rtol=1e-4, atol=1e-4, msg=f"K7 {name} state")
            results.append((f"K7 bf16 B={B} S={S} H={H} K=V={K}: scan vs chunk",
                            *ab_ms(calls["scan"], calls["chunk"])))
            log(results[-1])
            if S >= 128:
                results.append((f"K7 bf16 B={B} S={S} H={H} K=V={K}: chunk state pass at 16 "
                                f"vs 32 columns a block", *ab_ms(calls["16 columns"],
                                                                 calls["32 columns"])))
                log(results[-1])
            if other is not None:
                route = gdn_route(S)
                results.append((f"K7 bf16 B={B} S={S} H={H} K=V={K}: other vs this ({route})",
                                 *ab_ms(calls["other"], calls[route])))
                log(results[-1])


# one run of the decode-step timing, in a process of its own that imports
# the package of the checkout it starts in; the last line it prints is
# "STEP" and {case: ms}: a step's wall time on the host clock, and the host
# time a K1 or K4 wrapper call takes to return (its launch queued) at a
# step's attention shapes
STEP_SCRIPT = '''
import json, time
import torch
from crane_tpu_torch.models.auto import quantize_params
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.init import QWEN3_0_6B as cfg, init_params
from crane_tpu_torch.ops.cuda import decode_attention as k1
from crane_tpu_torch.ops.cuda import quant_attention as k45
from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache
from crane_tpu_torch.ops.sampling import SamplingParams

gen = torch.Generator(device="cuda").manual_seed(0)
times = {}
D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
for B in (1, 8):
    q = torch.randn(B, 1, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, 2048, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    valid = torch.full((B,), 300, dtype=torch.int32, device="cuda")
    c = QuantLayerKVCache.empty(B, 2048, Hkv, D, bits=4, device="cuda")
    c.update(k, v, 0)
    for name, call in (("K1", lambda: k1.fp_decode_attention(q, k, v, valid, scale=0.1)),
                       ("K4 kv4", lambda: k45.quant_decode_attention(
                           q, c.k, c.v, c.k_scale, c.v_scale, valid, bits=4, scale=0.1))):
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        times[f"{name} wrapper B={B}: host time a call"] = (time.perf_counter() - t0) / CALLS * 1e3
        torch.cuda.synchronize()
params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
for label, kv_bits in (("bf16", None), ("w4 kv4", 4)):
    lm = CausalLM(cfg, params if kv_bits is None else quantize_params(params, bits=4),
                  dtype=torch.bfloat16)
    for B in (1, 8):
        ids = [i % cfg.vocab_size for i in range(1, 301)]
        _, cache = lm.prefill(lm.init_cache(B, 2048, quant_bits=kv_bits), [ids] * B, [300] * B)
        state = [cache]
        args = (torch.ones(B, dtype=torch.int32, device="cuda"),
                torch.full((B, 8), -1, dtype=torch.int32, device="cuda"),
                SamplingParams.make(B, do_sample=False, device="cuda"),
                torch.Generator(device="cuda"), 1)
        def step():
            _, state[0], _ = lm.decode_steps(state[0], *args)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        times[f"{label} B={B}"] = (time.perf_counter() - t0) / STEPS * 1e3
        del state, cache
    del lm
print("STEP " + json.dumps(times), flush=True)
'''
# decode steps a run times (after 3 warm ones), wrapper calls, and pairs of
# runs (the host clock spreads more than device time)
STEPS = 20
CALLS = 200
STEP_PAIRS = 5


def steps_vs_other(other_root: Path, log, results) -> None:
    """Wall time of a decode step, the other checkout's package against
    this one's: each checkout's kernels built side by side first, then
    STEP_PAIRS pairs of runs in turns (other, this, this, other, ...), one
    process a run, each run logged; the median of each side per case."""
    roots = {"other": other_root.resolve(), "this": build.CSRC.parents[1]}

    def start(root, code):
        return subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    builds = [start(root, "from crane_tpu_torch.ops.cuda import build; build.lib()")
              for root in roots.values()]
    for proc in builds:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"building a checkout's kernels failed:\n{text}")
    runs = {"other": [], "this": []}
    for i in range(STEP_PAIRS):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            proc = start(roots[side], f"STEPS, CALLS = {STEPS}, {CALLS}\n" + STEP_SCRIPT)
            text = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"the decode-step run in {roots[side]} failed:\n{text}")
            runs[side].append(json.loads(text.strip().splitlines()[-1].removeprefix("STEP ")))
            print(f"[ab] step run {i} {side}: {json.dumps(runs[side][-1])}", flush=True)
    for case in runs["this"][0]:
        other_ms, this_ms = (sorted(r[case] for r in runs[side])[STEP_PAIRS // 2]
                             for side in ("other", "this"))
        what = case if "wrapper" in case else f"decode step of Qwen3-0.6B {case} after 300 " \
                                              f"tokens, host clock"
        results.append((f"{what}: other vs this", other_ms, this_ms))
        log(results[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, help="another checkout to compare K2/K3/K5 with")
    parser.add_argument("--only", default="k6,attention,decode,step,gdn",
                        help="comma-separated subset of k6,attention,decode,step,gdn")
    parser.add_argument("--json", type=Path, help="write the cases here as JSON")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("the A/B needs a CUDA device")

    def log(case):
        label, a, b = case
        print(f"{label}: {a:.4f} ms vs {b:.4f} ms ({b / a:.3f}x)", flush=True)

    mma_src = ("quant_matmul.cu", "quant_matmul_mma.cu")
    attn_src = ("flash_attention.cu", "flash_attention_mma.cu", "quant_cached_attention.cu")
    decode_src = ("decode_attention.cu", "quant_decode_attention.cu",
                  "quant_decode_attention_int4.cu")
    jobs = {}
    if "k6" in only:
        jobs["k6_cores"] = _library("k6_cores", build.CSRC, mma_src, {
            "quant_matmul.cu": (r"constexpr int kMmaMinM = \d+;",
                                "constexpr int kMmaMinM = 1 << 30;")})
        jobs["k6_mma"] = _library("k6_mma", build.CSRC, mma_src, {
            "quant_matmul.cu": (r"constexpr int kMmaMinM = \d+;", "constexpr int kMmaMinM = 1;")})
    other = args.other / "crane_tpu_torch" / "csrc" if args.other is not None else None
    side = ("other_" + hashlib.sha1(str(other.resolve()).encode()).hexdigest()[:8]
            if other is not None else "")
    if other is not None and "attention" in only:
        jobs["attn_other"] = _library(f"attn_{side}", other, tuple(
            f for f in attn_src + ("quant_cached_attention_mma.cu",) if (other / f).exists()))
        jobs["attn_this"] = _library("attn_this", build.CSRC,
                                     attn_src + ("quant_cached_attention_mma.cu",))
    if other is not None and "decode" in only:
        jobs["dec_other"] = _library(f"dec_{side}", other,
                                     tuple(f for f in decode_src if (other / f).exists()))
        jobs["dec_this"] = _library("dec_this", build.CSRC, decode_src)
    if "gdn" in only:
        jobs["gdn_this"] = _library("gdn_this", build.CSRC, ("gdn_scan.cu", "gdn_chunk.cu"))
        for tag, test in (("gdn_narrow", "< 0"), ("gdn_wide", ">= 0")):
            jobs[tag] = _library(tag, build.CSRC, ("gdn_chunk.cu",), {
                "gdn_chunk.cu": (r">= sm_count\(\)\)", test + ")")})
        if other is not None:
            jobs["gdn_other"] = _library(f"gdn_{side}", other, ("gdn_scan.cu",))
    libs = {}
    for tag, (proc, path) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{text}")
        libs[tag] = path
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"[ab] {smi}; medians of {PAIRS} alternating pairs, device time", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    results: list = []
    if "k6" in only:
        k6_routes(libs["k6_cores"], libs["k6_mma"], gen, log, results)
    if "attn_other" in libs:
        attention_vs_other(libs["attn_other"], libs["attn_this"], gen, log, results)
    if "dec_other" in libs:
        decode_vs_other(libs["dec_other"], libs["dec_this"],
                        "n_split" in (other / "decode_attention.cu").read_text(), gen, log,
                        results)
    if "gdn_this" in libs:
        gdn_routes(libs["gdn_this"], libs.get("gdn_other"), (libs["gdn_narrow"], libs["gdn_wide"]),
                   gen, log, results)
    if other is not None and "step" in only:
        steps_vs_other(args.other, log, results)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
