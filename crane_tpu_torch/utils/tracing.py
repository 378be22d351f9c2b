"""Tracing spans: named host ranges on the profiler's clock, kept in a
bounded in-memory timeline, with a per-name wall-time registry (port of
``crane_tpu/utils/tracing.py``, extended).

A span records only while something collects: while :func:`enable` is on,
or while a ``torch.profiler`` profile runs (torch's own flag for fast
Python checks, ``torch.autograd.profiler._is_profiler_enabled``, which every
profile start sets and every stop clears). Otherwise :func:`span` and
:func:`record` read that flag and return: they enter no
``record_function``, read no clock and take no lock.

A recorded span appends a :class:`Span` ``(name, start_ns, end_ns, parent,
rid, counts)`` to the timeline (the newest ``CAPACITY`` are kept):

- times are :func:`clock_ns`, ``time.time_ns()``, the clock of
  ``torch.profiler``'s (kineto's) events, so a span lies on the device
  trace of the same run;
- ``parent`` is the name of the enclosing span on the same thread;
- ``rid`` is the request a span belongs to, inherited from the enclosing
  span when not given;
- ``counts`` are the small integers passed as keywords.

It also adds its host seconds to the registry that :func:`stats` and
:func:`report` read, and while a profiler runs it enters
``torch.profiler.record_function(name)``, so the range is named in the
profiler's trace (crane_tpu enters ``jax.named_scope``). The wall time is
the host's: CUDA work launched inside a span may still run after it closes
unless the span ends in a sync. Nothing here allocates on a device.

Usage::

    with span("model.prefill", tokens=n, bucket=s):
        logits, cache = lm.prefill(...)

    record("request.queued", submitted_ns, rid=request_id)  # began earlier

    @traced("decode_step")
    def step(...): ...

    print(report())
    spans = timeline(t0_ns, t1_ns)
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

CAPACITY = 1 << 16  # records the timeline keeps, the newest


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    rid: Optional[str]
    counts: dict


_lock = threading.Lock()
_stats: dict = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, secs]
_timeline: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()  # .stack: the open spans of this thread
_enabled = False
_OFF = contextlib.nullcontext()


def clock_ns() -> int:
    """The tracing clock: ``time.time_ns()``, on which ``torch.profiler``
    places its events."""
    return time.time_ns()


def enable(on: bool = True) -> None:
    """Record spans without a profiler (a running profiler records them
    either way)."""
    global _enabled
    _enabled = on


def reset() -> None:
    """Clear the registry and the timeline."""
    with _lock:
        _stats.clear()
        _timeline.clear()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(rec: Span) -> None:
    with _lock:
        _timeline.append(rec)
        s = _stats[rec.name]
        s[0] += 1
        s[1] += (rec.end_ns - rec.start_ns) / 1e9


class _Recording:
    """One recorded span, open on the calling thread."""

    __slots__ = ("name", "rid", "counts", "parent", "start", "range")

    def __init__(self, name: str, rid: Optional[str], counts: dict):
        self.name, self.rid, self.counts = name, rid, counts
        self.range = None

    def __enter__(self):
        self.start = time.time_ns()
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.rid is None and outer is not None:
            self.rid = outer.rid
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _keep(Span(self.name, self.start, end, self.parent, self.rid, self.counts))
        return False


def span(name: str, rid: Optional[str] = None, **counts):
    """A context manager: the named range, recorded while something
    collects (see the module's docstring), else nothing."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Recording(name, rid, counts)


def record(name: str, start_ns: int, end_ns: Optional[int] = None, *,
           rid: Optional[str] = None, **counts) -> None:
    """Record a span that began before this call (a request's wait since
    ``start_ns`` on :func:`clock_ns`), ending at ``end_ns`` or now, inside
    the enclosing span of this thread."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    if end_ns is None:
        end_ns = time.time_ns()
    stack = _stack()
    parent = stack[-1].name if stack else None
    _keep(Span(name, start_ns, end_ns, parent, rid, counts))


def timeline(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> list:
    """The kept :class:`Span` records that overlap ``[t0_ns, t1_ns]`` (on
    :func:`clock_ns`; None leaves a side open), in the order they ended."""
    with _lock:
        recs = list(_timeline)
    return [r for r in recs
            if (t0_ns is None or r.end_ns >= t0_ns) and (t1_ns is None or r.start_ns <= t1_ns)]


def traced(name: str | None = None):
    """Decorator form of :func:`span`."""

    def wrap(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return inner

    return wrap


def stats() -> dict:
    """{name: (calls, total_seconds)} snapshot."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _stats.items()}


def report() -> str:
    """Sorted per-span table: calls, total ms, mean ms."""
    rows = sorted(stats().items(), key=lambda kv: -kv[1][1])
    lines = [f"{'span':<32} {'calls':>7} {'total ms':>10} {'mean ms':>9}"]
    for name, (calls, secs) in rows:
        lines.append(
            f"{name:<32} {calls:>7} {secs * 1e3:>10.2f} {secs * 1e3 / max(calls, 1):>9.3f}"
        )
    return "\n".join(lines)
