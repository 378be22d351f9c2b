"""The program's spans against the benchmark's host spans, and what the
program's tracing costs, on the card.

    python -m crane_bench.spancheck --workload <name> --seed <n> --seconds 20 [--json out.json]

One traced run of the cell (``run.run_cell`` with ``trace``), whose slice
puts each idle gap of the device down to a host span twice: by
``system.HostSpans`` (the ``breakdown``) and by the program's own timeline
(``crane_tpu_torch/utils/tracing.py``), where each ``model.prefill`` is
folded into the span it ran in, since ``HostSpans`` has none. Both are
printed per span name with the new per-layer metrics, the gaps the two put
down to different spans (and how much of them fell in a pass of the garbage
collector), the spans recorded per admission and per decode block, and the
mean ``engine.admit`` span.
Before the cell, the host cost of one span is timed: tracing off, on
without a profiler, and on under the benchmark's device-only profiler,
with the spans on a thread of their own as the engine's are.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time
from pathlib import Path

N_SPANS = 20000
ADMISSION = ("engine.admit", "engine.admit_chunk", "model.prefill", "request.queued",
             "request.ttft")
DECODE = ("engine.decode_block", "engine.emit_tokens", "engine.flush_inflight")


def span_cost_us(profiled: bool, enabled: bool) -> float:
    """Host microseconds a span with a request id and counts costs, timed
    on a thread of its own, with the device-only profiler running or not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from crane_tpu_torch.utils import tracing

    tracing.enable(enabled)
    out = {}

    def spans():
        t = time.perf_counter()
        for _ in range(N_SPANS):
            with tracing.span("cost.probe", rid="r", rows=1, slots=2, steps=8):
                pass
        out["us"] = (time.perf_counter() - t) / N_SPANS * 1e6

    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    if prof is not None:
        prof.start()
    worker = threading.Thread(target=spans)
    worker.start()
    worker.join()
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
    tracing.enable(False)
    tracing.reset()
    return out["us"]


def gap_owners(slice_, spans) -> list:
    """(start_ns, end_ns, name) of each idle gap of the slice, named by the
    innermost of ``spans`` (name, start_ns, end_ns, all of one thread, so
    nested) open at its middle: the rule of ``devtrace.Slice.idle_gaps``,
    gap by gap, in one sweep."""
    busy = slice_.busy_intervals()
    edges = [slice_.t0_ns] + [x for ab in busy for x in ab] + [slice_.t1_ns]
    spans = sorted(spans, key=lambda s: s[1])
    out, stack, j = [], [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while j < len(spans) and spans[j][1] <= mid:
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        out.append((a, b, stack[-1][0] if stack else None))
    return out


def differing_gaps(slice_, host, program) -> list:
    """The gaps the two span sets put down to different names: [ms, the
    host span's name, the program span's name, µs from the gap's middle to
    the nearest start or end of a program span, the middle in ns], longest
    first."""
    bounds = sorted(x for s in program for x in s[1:])
    rows = []
    for (a, b, h), (_, _, p) in zip(gap_owners(slice_, host), gap_owners(slice_, program)):
        if h != p:
            mid = (a + b) // 2
            near = min(abs(mid - x) for x in bounds) if bounds else None
            rows.append([(b - a) / 1e6, h, p, near / 1e3 if near is not None else None, mid])
    return sorted(rows, key=lambda r: -r[0])


def main(argv=None) -> int:
    from crane_bench import devtrace, program_spans, run
    from crane_bench.spec import find_cell, read_json
    from crane_tpu_torch.utils import tracing

    ap = argparse.ArgumentParser("crane_bench.spancheck")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    t_process = time.perf_counter()
    root = Path.cwd()
    cell = find_cell(read_json(root / "BENCHMARK.json"), args.workload, root)

    import torch
    torch.ones(1, device="cuda").sum().item()
    devtrace.warm_profiler()
    cost = {"off": span_cost_us(False, False), "enabled": span_cost_us(False, True),
            "profiled": span_cost_us(True, False)}

    slices = []

    class KeptSlice(devtrace.Slice):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            slices.append(self)

    devtrace.Slice = KeptSlice
    pauses = []  # the garbage collector's passes, on the tracing clock

    def collected(phase, info):
        if phase == "start":
            pauses.append([time.time_ns(), None, info["generation"]])
        elif pauses:
            pauses[-1][1] = time.time_ns()

    gc.callbacks.append(collected)
    out = run.run_cell(cell, args.seed, args.seconds, True, "cuda", t_process=t_process)
    gc.callbacks.remove(collected)
    sl = slices[0]
    pauses = [(a, b, g) for a, b, g in pauses if b is not None and b > sl.t0_ns and a < sl.t1_ns]

    def in_pause(ns):
        return any(a <= ns < b for a, b, _ in pauses)
    recs = program_spans.records(sl)
    host = dict(sl.idle_gaps())
    folded = [r._replace(name=r.parent) if r.name == "model.prefill" and r.parent else r
              for r in recs]
    program = program_spans.idle_by_span(sl, folded)
    window = sl.window_s
    differ = differing_gaps(sl, sl.host_spans, [(r.name, r.start_ns, r.end_ns) for r in folded
                                                 if not r.name.startswith(program_spans.WAITS)])
    agree = {}
    for name in ("engine.admit", "engine.admit_chunk", "engine.decode_block"):
        h, p = host.get(name, 0.0), program.get(name, 0.0)
        agree[name] = {"host_spans_s": h, "program_s": p,
                       "agree": abs(h - p) <= max(0.05 * h, 0.005)}
    metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    unfolded = program_spans.idle_by_span(sl, recs)
    admit_pp = 100.0 * (host.get("engine.admit", 0.0) + host.get("engine.admit_chunk", 0.0)) \
        / window
    program_pp = 100.0 * sum(unfolded.get(k, 0.0) for k in ADMISSION) / window
    n = {}
    for r in recs:
        n[r.name] = n.get(r.name, 0) + 1
    admits = [r for r in recs if r.name == "engine.admit"
              and sl.t0_ns <= r.start_ns <= sl.t1_ns]
    blocks = n.get("engine.decode_block", 0) + n.get("engine.spec_block", 0)
    per_admission = sum(n.get(k, 0) for k in ADMISSION) / max(len(admits), 1)
    per_block = sum(n.get(k, 0) for k in DECODE) / max(blocks, 1)
    mean_admit_ms = (sum(r.end_ns - r.start_ns for r in admits) / len(admits) / 1e6
                     if admits else None)
    admission_cost_ms = per_admission * cost["profiled"] / 1e3
    row = {
        "workload": args.workload, "seed": args.seed, "correct": out["result"]["correct"],
        "device": out["result"]["device"], "window_s": window,
        "idle_share": metrics.get("idle_share"),
        "metrics": metrics,
        "host_spans_idle_s": host, "program_idle_s": unfolded,
        "program_folded_idle_s": program, "agree": agree,
        "differing_gaps": [r[:4] for r in differ[:12]],
        "differing_s": sum(r[0] for r in differ) / 1e3,
        "differing_in_gc_s": sum(r[0] for r in differ if in_pause(r[4])) / 1e3,
        "gc_passes": [sum(1 for p in pauses if p[2] == g) for g in range(3)],
        "gc_s": sum(b - a for a, b, _ in pauses) / 1e9,
        "admission_idle_pp": {"host_spans": admit_pp, "program": program_pp,
                              "agree": abs(admit_pp - program_pp) <= 1.0},
        "span_us": cost, "records": n, "kept": len(recs),
        "spans_per_admission": per_admission, "spans_per_decode_block": per_block,
        "mean_admit_ms": mean_admit_ms,
        "admission_cost_share": (admission_cost_ms / mean_admit_ms if mean_admit_ms else None),
        "tracing_stats": tracing.stats(),
    }
    print(json.dumps(row, default=str), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(row, default=str, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
