"""model.prefill_graph_share against values computed by hand, on
test_bench_program_spans.py's hand-set slice and timeline: the prefills
that start in the slice, their real tokens split by the ``graph`` count of
their ``model.prefill`` span. None without such spans, without the count
(a program that runs no prefill graphs), and where the program keeps no
timeline; 0 where every prefill ran eagerly."""

import pytest

from crane_bench.tests.test_bench_program_spans import SPANS, hand_slice, read, timeline  # noqa: F401
from crane_tpu_torch.utils import tracing

NAME = "model.prefill_graph_share"


def with_graph(flags):
    """SPANS with each ``model.prefill`` given the next ``graph`` count."""
    flags, out = iter(flags), []
    for name, a, b, rid, counts in SPANS:
        if name == "model.prefill":
            counts = {**counts, "graph": next(flags)}
        out.append((name, a, b, rid, counts))
    return out


@pytest.mark.parametrize("flags,value", [
    ((1, 0, 1), 100.0 * 100 / (100 + 64)),   # a replayed, b eager; e before the slice
    ((1, 1, 0), 100.0),
    ((0, 0, 1), 0.0),
])
def test_reader_gives_the_hand_value(timeline, flags, value):  # noqa: F811
    timeline(with_graph(flags))
    assert read(NAME, hand_slice()) == pytest.approx(value)


def test_reader_gives_none_without_the_count(timeline):  # noqa: F811
    sl = hand_slice()
    assert read(NAME, sl) is None          # an empty timeline
    timeline([("engine.emit_tokens", 10, 20, None, {})])
    assert read(NAME, sl) is None          # no prefill span
    timeline(SPANS)
    assert read(NAME, sl) is None          # prefill spans without a graph count


def test_reader_gives_none_where_the_program_keeps_no_timeline(timeline, monkeypatch):  # noqa: F811
    timeline(with_graph((1, 1, 1)))
    monkeypatch.delattr(tracing, "timeline")
    assert read(NAME, hand_slice()) is None
