"""crane_tpu_torch's tracing timeline (``utils/tracing.py``) and the spans
the serving engine and the model record in it, on the CPU.

- Off (no profiler, ``enable`` not called): ``span`` and ``record`` enter
  no ``record_function``, read no clock and take no lock, and keep nothing.
- Under ``torch.profiler``: a span keeps its name, parent, request id and
  counts, and its start and end bracket the profiler's event of its
  ``record_function`` range, so the two share one clock; torch's flag
  ``_is_profiler_enabled`` follows the profiler's start and stop.
- ``enable(True)``: spans record without a profiler and ``stats`` counts;
  ``record`` keeps a span begun earlier; ``timeline`` returns what overlaps
  an interval and ``reset`` clears it.
- A tiny engine on a saved Qwen3 checkpoint serves three requests under a
  CPU profiler, one admitted in chunks: each request has one
  ``request.ttft`` and a ``request.queued`` with its id, every
  ``model.prefill`` counts no more real tokens than its bucket, and every
  ``engine.decode_block`` counts the slots live when it was dispatched.
"""

import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from crane_tpu_torch.utils import tracing
from tests.fixtures import make_tiny_qwen3_checkpoint

torch.set_num_threads(2)


@pytest.fixture()
def fresh():
    tracing.reset()
    tracing.enable(False)
    yield
    tracing.enable(False)
    tracing.reset()


class _Refused:
    def __call__(self, *a, **kw):
        raise AssertionError("called while tracing is off")

    def __enter__(self):
        raise AssertionError("lock taken while tracing is off")

    def __exit__(self, *exc):
        return False


def test_off_enters_no_range_reads_no_clock_takes_no_lock(fresh, monkeypatch):
    assert not autograd_profiler._is_profiler_enabled
    monkeypatch.setattr(tracing, "record_function", _Refused())
    monkeypatch.setattr(tracing, "_lock", _Refused())
    monkeypatch.setattr(time, "time_ns", _Refused())
    with tracing.span("engine.admit", rid="r0", rows=1):
        with tracing.span("model.prefill", tokens=3, bucket=64):
            pass
    tracing.record("request.queued", 0, rid="r0")
    tracing.record("request.ttft", 0, 5, rid="r0")

    @tracing.traced("decode")
    def step():
        return 7

    assert step() == 7
    monkeypatch.undo()
    assert tracing.timeline() == [] and tracing.stats() == {}


def test_profiler_flag_follows_start_and_stop(fresh):
    prof = profile(activities=[ProfilerActivity.CPU])
    assert not autograd_profiler._is_profiler_enabled
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        with tracing.span("during"):
            pass
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    with tracing.span("after"):
        pass
    assert [r.name for r in tracing.timeline()] == ["during"]


def test_profiler_records_spans_on_its_own_clock(fresh):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("engine.admit", rid="r7"):
            with tracing.span("model.prefill", tokens=5, bucket=64):
                torch.ones(8).sum()
            tracing.record("request.ttft", 123, rid="r7")
    inner, ttft, outer = tracing.timeline()
    assert (outer.name, outer.parent, outer.rid, outer.counts) == \
        ("engine.admit", None, "r7", {})
    assert (inner.name, inner.parent, inner.rid, inner.counts) == \
        ("model.prefill", "engine.admit", "r7", {"tokens": 5, "bucket": 64})
    assert (ttft.name, ttft.start_ns, ttft.parent, ttft.rid) == \
        ("request.ttft", 123, "engine.admit", "r7")
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= ttft.end_ns <= outer.end_ns
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("engine.admit", "model.prefill")}
    assert set(events) == {"engine.admit", "model.prefill"}
    for rec in (outer, inner):
        e = events[rec.name]
        assert rec.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= rec.end_ns
    # the profiler's stop ends the recording
    with tracing.span("after"):
        pass
    assert [r.name for r in tracing.timeline()] == ["model.prefill", "request.ttft",
                                                    "engine.admit"]
    assert tracing.stats()["model.prefill"][0] == 1


def test_enable_records_without_a_profiler(fresh):
    tracing.enable(True)
    t0 = tracing.clock_ns()
    with tracing.span("engine.decode_block", rows=2, slots=4, steps=8):
        with tracing.span("engine.emit_tokens"):
            pass
    tracing.record("request.queued", t0 - 10_000, rid="q")
    t1 = tracing.clock_ns()
    emit, block, queued = tracing.timeline()
    assert (emit.parent, block.parent, queued.parent) == ("engine.decode_block", None, None)
    assert block.counts == {"rows": 2, "slots": 4, "steps": 8}
    assert queued.start_ns == t0 - 10_000 and t0 <= queued.end_ns <= t1
    assert t0 <= block.start_ns <= block.end_ns <= t1
    assert {k: v[0] for k, v in tracing.stats().items()} == \
        {"engine.decode_block": 1, "engine.emit_tokens": 1, "request.queued": 1}
    # timeline(t0, t1) keeps what overlaps the interval
    assert tracing.timeline(t1 + 1) == []
    assert tracing.timeline(None, t0 - 20_000) == []
    assert [r.name for r in tracing.timeline(t0 - 5_000, t0 - 1_000)] == ["request.queued"]
    tracing.reset()
    assert tracing.timeline() == [] and tracing.stats() == {}


def test_timeline_keeps_the_newest(fresh, monkeypatch):
    import collections

    monkeypatch.setattr(tracing, "_timeline", collections.deque(maxlen=3))
    tracing.enable(True)
    for i in range(5):
        tracing.record(f"s{i}", 0, 1)
    assert [r.name for r in tracing.timeline()] == ["s2", "s3", "s4"]
    assert len(tracing.stats()) == 5


def test_spans_of_two_threads_keep_their_own_parents(fresh):
    import threading

    tracing.enable(True)
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"outer.{tag}", rid=tag):
            barrier.wait()
            with tracing.span(f"inner.{tag}"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    inner = {r.name: r for r in tracing.timeline() if r.name.startswith("inner")}
    assert (inner["inner.a"].parent, inner["inner.a"].rid) == ("outer.a", "a")
    assert (inner["inner.b"].parent, inner["inner.b"].rid) == ("outer.b", "b")


@pytest.fixture(scope="module")
def tiny_lm(tmp_path_factory):
    from crane_tpu_torch.models.auto import from_pretrained

    ckpt = make_tiny_qwen3_checkpoint(str(tmp_path_factory.mktemp("tracing") / "m"),
                                      vocab_size=320)
    return from_pretrained(ckpt, dtype=torch.float32, device="cpu")


def test_engine_spans_under_a_profiler(fresh, tiny_lm):
    from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions

    engine = InferenceEngine(tiny_lm, max_slots=2, max_seq_len=256, prefill_chunk=32,
                             bucket_align=16, decode_tokens_per_seq=4, prefix_cache=False)
    live = []
    dispatch = engine._run_decode

    def counted(n_steps):
        live.append(int(np.count_nonzero(engine.active)))
        return dispatch(n_steps)

    engine._run_decode = counted
    greedy = SamplingOptions(do_sample=False, repetition_penalty=1.0)
    rng = np.random.default_rng(0)
    prompts = {"a": 5, "b": 70, "c": 20}  # b admits in chunks of 32
    with profile(activities=[ProfilerActivity.CPU]):
        qs = {rid: engine.submit(EngineRequest(request_id=rid, max_new_tokens=6,
                                               prompt_ids=rng.integers(1, 300, n).tolist(),
                                               sampling=greedy))
              for rid, n in prompts.items()}
        for _ in range(300):
            if not engine.step() and engine.request_q.empty():
                break
        engine._flush_inflight()
    for q in qs.values():
        while not (r := q.get(timeout=30)).finished:
            pass
        assert r.error is None
    recs = tracing.timeline()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    for rid in prompts:
        ttft = [r for r in by["request.ttft"] if r.rid == rid]
        queued = [r for r in by["request.queued"] if r.rid == rid]
        assert len(ttft) == 1 and queued
        assert ttft[0].start_ns <= queued[0].start_ns <= queued[0].end_ns <= ttft[0].end_ns
        assert [r.rid for r in by["engine.admit"]].count(rid) == 1
    chunks = [r for r in by["engine.admit_chunk"]]
    assert {r.rid for r in chunks} == {"b"} and len(chunks) == 3  # 70 tokens in 32s
    prefills = by["model.prefill"]
    assert len(prefills) == 5 and {r.rid for r in prefills} == set(prompts)
    assert {r.parent for r in prefills} == {"engine.admit", "engine.admit_chunk"}
    assert all(0 < r.counts["tokens"] <= r.counts["bucket"] for r in prefills)
    assert sorted(r.counts["tokens"] for r in prefills) == [5, 6, 20, 32, 32]
    blocks = sorted(by["engine.decode_block"], key=lambda r: r.start_ns)
    assert [r.counts["rows"] for r in blocks] == live and max(live) == 2
    assert all(r.counts["slots"] == 2 and r.counts["steps"] in (1, 4) for r in blocks)
    assert by["engine.emit_tokens"]
