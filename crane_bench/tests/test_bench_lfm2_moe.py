"""LFM2-24B-A2B's cell at its own size on the card: the control (the
reference in float8) fails its comparison, and so do the faults the
comparison must catch there, a frozen KV cache in the 10 attention layers
and half of the slots left out of the decode step. Unlike Qwen3-Next's cell,
this one catches a frozen KV cache: its bf16 run reads a mean gap of
0.578-0.613, the frozen cache 1.71-1.85, against the limit of 1.0."""

import pytest
import torch

from crane_bench import faults, run
from crane_bench.spec import find_cell, read_json
from crane_bench.tests.tiny import ROOT

CELL = "lfm2-24b-a2b.decode-heavy"


@pytest.mark.chip
@pytest.mark.parametrize("fault", [None, "frozen_kv", "half_slots"],
                         ids=["control", "frozen_kv", "half_slots"])
def test_control_and_faults_fail_at_the_cells_size(fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = find_cell(read_json(ROOT / "BENCHMARK.json"), CELL, ROOT)
    with faults.plant(fault):
        out = run.run_cell(cell, 2 ** 31 + 123, 20.0, False, "cuda", control=fault is None)
    assert not out["result"]["correct"], out["result"]["check"]
