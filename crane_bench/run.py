"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m crane_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start to the window's):
the kernel library (built by nvcc into the checkout's ``build/kernels/`` on
a checkout's first run, loaded after), the weights drawn on the card from
the seed, the engine built from the mix's server flags, its warm-up (the
decode blocks captured as CUDA graphs), one prefill of each bucket the mix
reaches, and the mix's ramp (``ramp_s`` of serving, so that the window
opens on a running system). The window: the mix's clients against the
engine's own thread for ``--seconds``. With ``--trace 1`` a slice in the middle of the window is
profiled and the per-layer metrics are read from it. Then the comparison
that decides ``correct`` (``crane_bench/check.py``) runs, after the
program's state is freed.

The last lines of standard error are the numbers compared, each beside its
limit; the last line of standard output is the result as JSON.
"""

import time

T_PROCESS = time.perf_counter()  # noqa: E402  (the set-up clock starts here)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# packages that the measured process must never load, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "crane_tpu")
GIB = 1024 ** 3


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``FORBIDDEN``, compared whole: ``crane_tpu_torch`` is not
    ``crane_tpu``."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    model: object
    hf: dict
    work: object      # crane_bench.work.SliceWork of the traced slice
    slice: object     # crane_bench.devtrace.Slice
    stats: dict       # the change of the engine's counters over the window


STAT_KEYS = ("prompt_tokens", "prefix_tokens_reused", "prefix_hits", "requests_completed",
             "requests_preempted", "generated_tokens", "engine_steps")


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, *,
             control: bool = False, t_process: float = T_PROCESS) -> dict:
    """Set up, serve the window and compare; returns the result line's
    fields (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    maybe ``breakdown``, then ``check``) and ``info`` beside them. With
    ``control`` the control that the cell's limits file names takes the
    program's place: its ``program_flags`` added to the mix's engine flags,
    or the ``reference_fp8`` tokens judged in place of the served ones. The
    benchmark's own runs never set it."""
    import torch

    from crane_bench import check, client, devtrace, stats, system, work

    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    flags = list(cell.mix["engine_flags"])
    if control and cell.limits["control"]["kind"] == "program_flags":
        flags += cell.limits["control"]["flags"]
    lm, engine = system.build(cell.hf, cell.model, seed, device, flags)
    engine.warmup()
    system.warm_prefills(engine, cell.mix)
    spans = system.HostSpans(engine) if trace else None
    if trace:
        devtrace.warm_profiler()
    engine.start()
    clients = client.Clients(engine, cell.mix, seed, cell.hf["vocab_size"],
                             lambda: engine._thread.is_alive())
    counters = {}

    def count(tag):
        counters[tag] = {k: getattr(engine.stats, k) for k in STAT_KEYS}

    slice_ = devtrace.Slice(spans.spans, spans.gate) if trace else None

    def open_window():
        counters["setup_s"] = time.perf_counter() - t_process
        count("open")

    t0, t1 = clients.run(cell.mix["ramp_s"], seconds, at_open=open_window,
                         during=slice_.run if trace else None, at_close=lambda: count("close"))
    setup_s = counters.pop("setup_s")
    engine.stop()
    if forbidden_modules():
        raise SystemExit(f"loaded during the window: {forbidden_modules()}")
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    records = clients.records
    delta = {k: counters["close"][k] - counters["open"][k] for k in STAT_KEYS}
    e2e = stats.end_to_end(records, t0, t1)
    values = {"output_tok_s": e2e["output_tok_s"], "ttft_p95_ms": e2e.get("ttft_p95_ms"),
              "tpot_p95_ms": e2e.get("tpot_p95_ms"), "peak_mem_gib": peak / GIB,
              "setup_s": setup_s}
    info = {"engine": delta, "n_ttft": e2e["n_ttft"], "n_tpot": e2e["n_tpot"],
            "clients_failure": clients.failure}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"attempted": e2e["attempted"], "failed": e2e["failed"]}
    if trace:
        ctx = Context(cell.model, cell.hf, work.slice_work(records, slice_.p0, slice_.p1),
                      slice_, delta)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
        out["breakdown"] = {"device_ops": slice_.top_ops(), "idle_gaps": slice_.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    out["metrics"] = metrics
    out["device"] = dev
    # the program's state goes before the reference runs
    lm.release_graphs()
    del lm, engine, clients, spans  # the spans' wrappers hold the engine too
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.compare(cell.model, cell.hf, seed, device, records, cell.mix["check"],
                            cell.limits, control)
    if clients_failed := info["clients_failure"]:
        verdict["correct"] = False
        verdict["info"]["failure"] = clients_failed
    out = {"correct": verdict["correct"], **out, "check": verdict["numbers"]}
    info["check"] = verdict["info"]
    return {"result": out, "info": info}


def check_lines(numbers: dict) -> list[str]:
    return [f"check {name} {n['value']} limit {n['limit']}" for name, n in numbers.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("crane_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from crane_bench.spec import find_cell, read_json

    root = Path.cwd()
    cell = find_cell(read_json(root / "BENCHMARK.json"), args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"crane_bench: {args.workload} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"crane_bench: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"info": run["info"]}, default=str), file=sys.stderr)
    for line in check_lines(run["result"]["check"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(run["result"]))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
