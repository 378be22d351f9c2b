"""The five readers of the program's own spans against values computed by
hand, on a device trace and a timeline set by hand: a 1000 ms slice whose
device is busy over [0, 100], [300, 400], [600, 700] and [800, 1000] ms,
so idle over [100, 300] (inside a ``model.prefill`` within
``engine.admit``), [400, 600] (inside ``engine.decode_block``) and
[700, 800] (inside ``engine.admit_chunk``, after its prefill). Each reader
gives None where its spans are missing, and where the program keeps no
timeline."""

import types

import pytest

from crane_bench import devtrace, program_spans
from crane_bench.spec import HERE, load_module
from crane_tpu_torch.utils import tracing

T0 = 1_000_000_000_000
MS = 1_000_000
READERS = ("engine.queue_wait_share", "engine.decode_live_share",
           "engine.admit_host_idle_share", "model.prefill_idle_share",
           "model.prefill_pad_share")


def at(ms):
    return T0 + int(ms * MS)


def hand_slice():
    sl = devtrace.Slice([], None)
    sl.t0_ns, sl.t1_ns = at(0), at(1000)
    sl.events = [("k", at(a), at(b)) for a, b in ((0, 100), (300, 400), (600, 700), (800, 1000))]
    return sl


SPANS = [
    # name, start ms, end ms, rid, counts
    ("request.queued", -500, 90, "a", {}),
    ("model.prefill", 95, 250, "a", {"tokens": 100, "bucket": 128}),
    ("request.ttft", -500, 330, "a", {}),
    ("engine.admit", 90, 320, "a", {}),
    ("engine.spec_block", 10, 60, None, {"rows": 2, "slots": 4, "steps": 4}),
    ("engine.decode_block", 380, 650, None, {"rows": 3, "slots": 4, "steps": 8}),
    ("request.queued", 600, 690, "b", {}),
    ("model.prefill", 700, 720, "b", {"tokens": 64, "bucket": 64}),
    ("engine.admit_chunk", 690, 820, "b", {}),
    ("request.ttft", 600, 900, "b", {}),
    ("request.ttft", -100, 50, "c", {}),        # admitted before the slice: no wait kept
    ("request.queued", 900, 980, "d", {}),
    ("request.ttft", 900, 1200, "d", {}),       # first token after the slice
    ("model.prefill", -300, -200, "e", {"tokens": 1, "bucket": 64}),  # before the slice
]

HAND = {
    "engine.queue_wait_share": 100.0 * (590 + 90) / (830 + 300),
    "engine.decode_live_share": 100.0 * (3 * 8 + 2 * 4) / (4 * 8 + 4 * 4),
    "engine.admit_host_idle_share": 100.0 * 100 / 1000,
    "model.prefill_idle_share": 100.0 * 200 / 1000,
    "model.prefill_pad_share": 100.0 * (128 - 100) / (128 + 64),
}


@pytest.fixture()
def timeline():
    tracing.reset()
    tracing.enable(True)
    yield lambda spans: [tracing.record(n, at(a), at(b), rid=rid, **c)
                         for n, a, b, rid, c in spans]
    tracing.enable(False)
    tracing.reset()


def read(name, sl):
    reader = load_module(HERE / "metrics" / f"{name}.py", f"crane_bench.metrics.{name}")
    return reader.read(types.SimpleNamespace(slice=sl))


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_hand_value(timeline, name):
    timeline(SPANS)
    sl = hand_slice()
    assert read(name, sl) == pytest.approx(HAND[name])
    assert 100.0 * (1 - sl.busy_s / sl.window_s) == pytest.approx(50.0)


def test_idle_by_span_leaves_the_waits_out(timeline):
    timeline(SPANS)
    sl = hand_slice()
    idle = program_spans.idle_by_span(sl, program_spans.records(sl))
    assert idle == pytest.approx({"model.prefill": 0.2, "engine.decode_block": 0.2,
                                  "engine.admit_chunk": 0.1})


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_its_spans(timeline, name):
    sl = hand_slice()
    assert read(name, sl) is None          # an empty timeline
    timeline([("engine.emit_tokens", 10, 20, None, {})])
    assert read(name, sl) is None          # none of the reader's spans


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_where_the_program_keeps_no_timeline(timeline, name, monkeypatch):
    timeline(SPANS)
    monkeypatch.delattr(tracing, "timeline")
    assert read(name, hand_slice()) is None


def test_spancheck_names_each_gap_as_the_slice_does(timeline):
    from crane_bench import spancheck

    timeline(SPANS)
    sl = hand_slice()
    spans = [(r.name, r.start_ns, r.end_ns) for r in program_spans.records(sl)
             if not r.name.startswith(program_spans.WAITS)]
    sl.host_spans = spans
    by = {}
    for a, b, name in spancheck.gap_owners(sl, spans):
        name = name or "host: outside the engine's calls"
        by[name] = by.get(name, 0) + (b - a) / 1e9
    assert by == pytest.approx(dict(sl.idle_gaps()))
    moved = [(n, a, b) if n != "engine.decode_block" else (n, a + 140 * MS, b)
             for n, a, b in spans]
    assert spancheck.differing_gaps(sl, spans, moved) == [[200.0, "engine.decode_block", None,
                                                           pytest.approx(20_000.0), at(500)]]
