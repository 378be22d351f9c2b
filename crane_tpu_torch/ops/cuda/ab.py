"""Same-call A/B of the port's kernels on one card, in device time.

    python -m crane_tpu_torch.ops.cuda.ab [--other DIR] [--json PATH]

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
  checkout's kernels against this one's.

``--json PATH`` also writes every case as ``[label, ms_a, ms_b]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
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
    them; ``edit`` maps a file name to a (pattern, replacement) regular
    expression substitution) into ``build/ab/<tag>/lib.so``. Returns
    (process, library path)."""
    d = AB_DIR / tag
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, d)
    for name in sources:
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


def _entry(path: Path, name: str):
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = build.SIGNATURES[name]
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, help="another checkout to compare K2/K3/K5 with")
    parser.add_argument("--json", type=Path, help="write the cases here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the A/B needs a CUDA device")

    def log(case):
        label, a, b = case
        print(f"{label}: {a:.4f} ms vs {b:.4f} ms ({b / a:.3f}x)", flush=True)

    mma_src = ("quant_matmul.cu", "quant_matmul_mma.cu")
    attn_src = ("flash_attention.cu", "flash_attention_mma.cu", "quant_cached_attention.cu")
    jobs = {
        "k6_cores": _library("k6_cores", build.CSRC, mma_src, {
            "quant_matmul.cu": (r"constexpr int kMmaMinM = \d+;",
                                "constexpr int kMmaMinM = 1 << 30;")}),
        "k6_mma": _library("k6_mma", build.CSRC, mma_src, {
            "quant_matmul.cu": (r"constexpr int kMmaMinM = \d+;", "constexpr int kMmaMinM = 1;")}),
    }
    if args.other is not None:
        other = args.other / "crane_tpu_torch" / "csrc"
        jobs["attn_other"] = _library("attn_other", other, tuple(
            f for f in attn_src + ("quant_cached_attention_mma.cu",) if (other / f).exists()))
        jobs["attn_this"] = _library("attn_this", build.CSRC,
                                     attn_src + ("quant_cached_attention_mma.cu",))
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
    k6_routes(libs["k6_cores"], libs["k6_mma"], gen, log, results)
    if args.other is not None:
        attention_vs_other(libs["attn_other"], libs["attn_this"], gen, log, results)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
