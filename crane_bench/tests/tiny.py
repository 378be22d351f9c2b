"""Tiny cells for the CPU tests: the benchmark's own cells with their widths
and lengths cut down, so that a whole run fits a test."""

from __future__ import annotations

import copy
from pathlib import Path

from crane_bench.spec import find_cell, read_json

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "qwen3": dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, intermediate_size=96, vocab_size=512,
                  max_position_embeddings=4096),
    "qwen3_next": dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=32, linear_num_key_heads=2,
                       linear_num_value_heads=4, linear_key_head_dim=16,
                       linear_value_head_dim=16, num_experts=8, num_experts_per_tok=2,
                       moe_intermediate_size=32, shared_expert_intermediate_size=32,
                       vocab_size=512, max_position_embeddings=4096),
}


def tiny_hf(hf: dict) -> dict:
    out = dict(hf, **TINY[hf["model_type"]])
    if "layer_types" in hf:
        out["layer_types"] = hf["layer_types"][:out["num_hidden_layers"]]
    return out


def tiny_cell(workload: str, clients: int = 4, limit: float = 1.0, f32: bool = False):
    """The cell ``workload`` of BENCHMARK.json at a CPU test's size: tiny
    widths, 4 slots of 1024 tokens, 128-token chunks, short messages and
    answers, a small check, the cell's own control (with ``f32`` the program
    serves in float32)."""
    cell = find_cell(read_json(ROOT / "BENCHMARK.json"), workload, ROOT)
    cell.hf = tiny_hf(cell.hf)
    mix = copy.deepcopy(cell.mix)
    mix.update(clients=clients, pool=64, ramp_s=0.5, system_prompt=min(mix["system_prompt"], 64),
               engine_flags=["--max-concurrent", "4", "--max-seq-len", "1024",
                             "--prefill-chunk", "128", *(("--dtype", "f32") if f32 else ())],
               check={"served_tokens": 64, "max_requests": 4})
    m = mix["message"]
    mix["message"] = dict(m, median=min(m["median"], 100), min=min(m["min"], 16),
                          max=min(m["max"], 300))
    mix["answer"] = dict(mix["answer"], median=24, min=8, max=48)
    cell.mix = mix
    cell.limits = {"min_tokens": 16, "limits": {"mean_logit_gap": limit},
                   "control": cell.limits["control"]}
    return cell
