"""The end-to-end arithmetic over every request: percentiles, the rate, and
tails that a stall moves."""

import numpy as np
import pytest

from crane_bench import stats
from crane_bench.client import Record


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_matches_numpy_linear(q):
    xs = np.random.default_rng(q).exponential(size=257).tolist()
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)


def window(stall_at=None, stall=0.0, n=200, step=0.01, gap=0.002):
    """Synthetic requests: one submitted every ``step`` s, a first token 5 ms
    later, then 20 tokens ``gap`` s apart; from ``stall_at`` on, everything
    the engine does waits ``stall`` s longer."""
    recs = []
    for i in range(n):
        r = Record(f"r{i}", 0, i, 0, False, np.zeros(4, np.int64), 4, 20)
        r.submit_t = i * step
        delay = stall if stall_at is not None and r.submit_t >= stall_at else 0.0
        first = r.submit_t + 0.005 + delay
        r.times = [first + j * (gap + delay / 20) for j in range(20)]
        r.tokens = list(range(20))
        r.finish = "length"
        recs.append(r)
    return recs


def test_rate_counts_every_token_in_the_window():
    recs = window()
    out = stats.end_to_end(recs, 0.0, 1.0)
    inside = sum(1 for r in recs for t in r.times if 0.0 <= t < 1.0)
    assert out["output_tok_s"] == pytest.approx(inside / 1.0)
    assert out["attempted"] == 100 and out["failed"] == 0


def test_a_stall_moves_both_tails():
    calm = stats.end_to_end(window(), 0.0, 2.0)
    stalled = stats.end_to_end(window(stall_at=1.5, stall=0.2), 0.0, 2.0)
    assert stalled["ttft_p95_ms"] > calm["ttft_p95_ms"] * 5
    assert stalled["tpot_p95_ms"] > calm["tpot_p95_ms"] * 1.5


def test_a_request_without_a_first_token_fails():
    recs = window(n=10)
    recs[3].times, recs[3].tokens = [], []
    recs[5].error = "refused"
    out = stats.end_to_end(recs, 0.0, 1.0)
    assert out["attempted"] == 10 and out["failed"] == 2
