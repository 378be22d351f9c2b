"""Find a cell's configuration, traffic mix, limits, architecture module and
per-layer metric readers by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as a module (metric files carry dots in
    their names, so they are loaded by path, never by import name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, read from files."""

    name: str
    chips: int
    hf: dict               # the configuration as run (the config file)
    mix: dict              # the traffic mix's parameters
    limits: dict           # the limits of the comparison that decides `correct`
    model: ModuleType      # crane_bench/models/<model_type>.py
    end_to_end: list[dict]
    per_layer: list[dict]  # the metrics this cell reports in a traced run
    readers: dict          # per-layer metric name -> its reader module


def find_cell(bench: dict, workload: str, root: Path, base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``bench`` (the parsed ``BENCHMARK.json`` at
    ``root``): its config file, ``crane_bench/traffic/<traffic>.json``,
    ``crane_bench/limits/<workload>.json``, ``crane_bench/models/<model_type>.py``
    and ``crane_bench/metrics/<metric>.py`` for each per-layer metric it
    reports (``base`` in place of ``crane_bench/``). Raises KeyError for a
    name that is not there."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    hf = read_json(root / configs[w["config"]]["file"])
    mix = read_json(base / "traffic" / f"{w['traffic']}.json")
    limits = read_json(base / "limits" / f"{workload}.json")
    model = load_module(base / "models" / f"{hf['model_type']}.py",
                        f"crane_bench.models.{hf['model_type']}")

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    per_layer = [m for m in bench["per_layer"] if reports(m)]
    readers = {m["name"]: load_module(base / "metrics" / f"{m['name']}.py",
                                      f"crane_bench.metrics.{m['name']}")
               for m in per_layer}
    end_to_end = [m for m in bench["end_to_end"] if reports(m)]
    return Cell(workload, int(w["chips"]), hf, mix, limits, model, end_to_end, per_layer,
                readers)
