"""Tracing spans: a named range in the profiler's trace and host-side span
timing (port of ``crane_tpu/utils/tracing.py``).

:func:`span` enters ``torch.profiler.record_function(name)``, which names
the range in a ``torch.profiler`` trace (crane_tpu enters
``jax.named_scope``), and accumulates the host wall time of the span in a
thread-safe registry, so :func:`report` gives a quick profile without a
trace viewer. The wall time is the host's: CUDA work launched inside a span
may still run after it closes unless the span ends in a sync.

Usage::

    with span("prefill"):
        logits, cache = lm.prefill(...)

    @traced("decode_step")
    def step(...): ...

    print(report())
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

from torch.profiler import record_function

_lock = threading.Lock()
_stats: dict = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, secs]
_enabled = True


def enable(on: bool = True) -> None:
    """Turn the wall-time accounting on or off (the named range stays)."""
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def span(name: str):
    """A named range in the profiler's trace and host wall-time accounting."""
    if not _enabled:
        with record_function(name):
            yield
        return
    t0 = time.perf_counter()
    with record_function(name):
        yield
    dt = time.perf_counter() - t0
    with _lock:
        s = _stats[name]
        s[0] += 1
        s[1] += dt


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
