"""The comparison that decides ``correct`` catches a broken timed path.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a card skipped: ``run_cell`` is called with ``device="cpu"``), the
program serving in float32 so that a sound run reads a gap at rounding, and
sees ``correct`` come out true, or false with a fault of
``crane_bench.faults`` planted underneath: a token altered where it is
produced; a decode step that leaves the KV cache, or the Gated-DeltaNet
state, as it was; half of the slots left out of the decode step. (The
exchange between chips does not exist here: every cell runs on one card.)
With a card, the faults are read at the cells' own size, against the
cells' own limits.
"""

import pytest
import torch

from crane_bench import faults, run
from crane_bench.spec import find_cell, read_json
from crane_bench.tests.tiny import ROOT, tiny_cell

LIMIT = 1e-3  # a float32 program reads about 1e-6 against the float32 reference
NEXT = "qwen3-next-80b-a3b.decode-heavy"


def serve(workload, fault=None):
    cell = tiny_cell(workload, limit=LIMIT, f32=True)
    cell.mix["check"] = {"served_tokens": 10 ** 6, "max_requests": 64}
    with faults.plant(fault):
        return run.run_cell(cell, 2 ** 31 + 99, 3.0, False, "cpu")["result"]


@pytest.mark.parametrize("workload", ["qwen3-0.6b.chat", NEXT])
def test_sound_run_is_correct(workload):
    out = serve(workload)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("workload,fault", [
    ("qwen3-0.6b.chat", "altered_token"), (NEXT, "altered_token"),
    ("qwen3-0.6b.chat", "frozen_kv"), (NEXT, "frozen_kv"), (NEXT, "frozen_gdn_state"),
    ("qwen3-0.6b.chat", "half_slots"), (NEXT, "half_slots")])
def test_fault_is_caught(workload, fault):
    out = serve(workload, fault)
    assert not out["correct"], out["check"]


# At the cells' own size a frozen KV cache is read on Qwen3-0.6B, which runs the
# same cache write and K1: on Qwen3-Next, whose bf16 run already reads a mean gap
# of 0.29-0.36 on random weights, it reads about 0.5, under that cell's limit.
@pytest.mark.chip
@pytest.mark.parametrize("workload,fault", [
    (NEXT, "frozen_gdn_state"), (NEXT, "half_slots"),
    ("qwen3-0.6b.chat", "frozen_kv"), ("qwen3-0.6b.chat", "half_slots")])
def test_fault_is_caught_at_the_cells_size(workload, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = find_cell(read_json(ROOT / "BENCHMARK.json"), workload, ROOT)
    with faults.plant(fault):
        out = run.run_cell(cell, 2 ** 31 + 77, 20.0, False, "cuda")["result"]
    assert not out["correct"], out["check"]
