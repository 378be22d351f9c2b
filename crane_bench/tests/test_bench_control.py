"""The control fails the comparison that the program passes.

Each cell's limits file names its control: for Qwen3-0.6B the program with
its own int8 path switched on (int8 weights and an int8 cache, the nearest
precision below the configuration's bf16); for Qwen3-Next, whose int8 path
leaves the experts, routers and GDN projections in bf16, the reference
computed in float8 (weights and activations of every product), its choice
at each position of the same prompts and tokens judged in the served
token's place. Here at a tiny size on the CPU and, with a card, at the
cell's own size."""

import pytest
import torch

from crane_bench import run
from crane_bench.spec import find_cell, read_json
from crane_bench.tests.tiny import ROOT, tiny_cell

SEED = 2 ** 31 + 5


# the float32 program reads 0 to 1e-7 here; the int8 control 3e-5 to 8e-5;
# the float8 reference about 0.1 to 1 on the tiny Qwen3-Next
@pytest.mark.parametrize("workload,limit", [("qwen3-0.6b.chat", 1e-5),
                                            ("qwen3-0.6b.rag", 1e-5),
                                            ("qwen3-next-80b-a3b.decode-heavy", 0.02)])
def test_control_fails_where_the_program_passes_tiny(workload, limit):
    cell = tiny_cell(workload, limit=limit, f32=True)
    cell.mix["check"] = {"served_tokens": 10 ** 6, "max_requests": 64}
    program = run.run_cell(cell, SEED, 3.0, False, "cpu")
    ctl = run.run_cell(cell, SEED, 3.0, False, "cpu", control=True)
    assert program["result"]["correct"], program["result"]["check"]
    assert not ctl["result"]["correct"], ctl["result"]["check"]


def test_fp8_reference_judged_in_the_served_tokens_place_tiny():
    # the same served tokens: the program's gap at rounding, the control's far above
    cell = tiny_cell("qwen3-0.6b.chat", limit=5e-4, f32=True)
    cell.limits["control"] = {"kind": "reference_fp8"}
    program = run.run_cell(cell, SEED, 3.0, False, "cpu")
    ctl = run.run_cell(cell, SEED, 3.0, False, "cpu", control=True)
    assert program["result"]["correct"], program["result"]["check"]
    assert not ctl["result"]["correct"], ctl["result"]["check"]
    assert ctl["info"]["check"]["judged"] == "the float8 reference's tokens"


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["qwen3-0.6b.chat", "qwen3-next-80b-a3b.decode-heavy",
                                      "qwen3-0.6b.rag", "qwen3-next-80b-a3b.rag"])
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = find_cell(read_json(ROOT / "BENCHMARK.json"), workload, ROOT)
    out = run.run_cell(cell, SEED, 20.0, False, "cuda", control=True)
    assert not out["result"]["correct"], out["result"]["check"]
