"""The program's own spans over a traced slice: the records of
``crane_tpu_torch/utils/tracing.py`` (``timeline``, on ``time.time_ns``, the
clock of the profiler's events), which a running profiler switches on.

A program without that timeline gives None, and so does each reader built
on it: its metric is then left out of the line.
"""

from __future__ import annotations

from crane_bench import devtrace

# spans of waiting, not of host work: no idle gap is put down to them
WAITS = "request."


def records(slice_) -> list | None:
    """The program's span records that overlap the slice, or None where the
    program keeps no timeline."""
    from crane_tpu_torch.utils import tracing

    timeline = getattr(tracing, "timeline", None)
    if timeline is None:
        return None
    return timeline(slice_.t0_ns, slice_.t1_ns)


def named(recs, *names: str) -> list:
    return [r for r in recs if r.name in names]


def started_in(slice_, recs) -> list:
    return [r for r in recs if slice_.t0_ns <= r.start_ns <= slice_.t1_ns]


def idle_by_span(slice_, recs) -> dict:
    """Idle device seconds of the slice by the innermost program span open at
    each gap's middle, by the rule of ``devtrace.Slice.idle_gaps`` (the
    ``request.*`` waits left out)."""
    twin = devtrace.Slice([(r.name, r.start_ns, r.end_ns) for r in recs
                           if not r.name.startswith(WAITS)], None)
    twin.events, twin.t0_ns, twin.t1_ns = slice_.events, slice_.t0_ns, slice_.t1_ns
    return dict(twin.idle_gaps())


def idle_share(slice_, *names: str) -> float | None:
    """The slice's idle seconds whose innermost span is one of ``names``,
    over its seconds, in %; None where none of them ran in the slice or the
    slice holds no device event."""
    if not slice_.events or slice_.window_s <= 0:
        return None
    recs = records(slice_)
    if not recs or not named(recs, *names):
        return None
    idle = idle_by_span(slice_, recs)
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / slice_.window_s
