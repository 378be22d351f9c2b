"""The harness finds a configuration, a traffic mix, the limits and a
per-layer metric by the names in BENCHMARK.json, with no edit of its code:
a throwaway cell made of new files only runs."""

import json
import shutil
import types

import numpy as np

from crane_bench import run, work
from crane_bench.spec import HERE, find_cell
from crane_bench.tests.tiny import tiny_hf


def test_new_files_make_a_new_cell(tmp_path):
    base = tmp_path / "bench"
    for d in ("traffic", "limits", "models", "metrics"):
        shutil.copytree(HERE / d, base / d)
    (base / "configs").mkdir()
    hf = tiny_hf(json.loads((HERE / "configs" / "qwen3-0.6b.json").read_text()))
    (base / "configs" / "probe-q.json").write_text(json.dumps(hf))
    mix = json.loads((HERE / "traffic" / "decode-heavy.json").read_text())
    mix.update(clients=2, pool=16, ramp_s=0.2, engine_flags=["--max-concurrent", "2", "--max-seq-len", "512"],
               message={"median": 40, "min": 8, "max": 100, "sigma": 0.5},
               answer={"median": 12, "min": 4, "max": 24, "sigma": 0.5},
               check={"served_tokens": 32, "max_requests": 4})
    (base / "traffic" / "probe-mix.json").write_text(json.dumps(mix))
    (base / "limits" / "probe-q.probe-mix.json").write_text(
        json.dumps({"min_tokens": 8, "limits": {"mean_logit_gap": 1.0}}))
    (base / "metrics" / "probe.tokens.py").write_text(
        "def read(ctx):\n    return float(ctx.work.output_tokens) or None\n")
    bench = {
        "configs": [{"name": "probe-q", "file": "bench/configs/probe-q.json"}],
        "workloads": [{"name": "probe-q.probe-mix", "config": "probe-q", "traffic": "probe-mix",
                       "chips": 1}],
        "end_to_end": [{"name": "output_tok_s", "unit": "tokens/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "probe.tokens", "unit": "tokens",
                       "workloads": ["probe-q.probe-mix"]},
                      {"name": "mfu", "unit": "%", "workloads": ["some-other.cell"]}],
    }
    cell = find_cell(bench, "probe-q.probe-mix", tmp_path, base)
    assert cell.hf["hidden_size"] == 64 and cell.mix["clients"] == 2
    assert [m["name"] for m in cell.per_layer] == ["probe.tokens"]
    ctx = types.SimpleNamespace(work=work.SliceWork([], [], 3))
    assert cell.readers["probe.tokens"].read(ctx) == 3.0
    out = run.run_cell(cell, 17, 2.0, False, "cpu")["result"]
    assert set(out["metrics"]) == {"output_tok_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"
    assert np.isfinite(out["check"]["mean_logit_gap"]["value"])
