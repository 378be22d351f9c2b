"""The device trace of a traced run: ``torch.profiler`` over a steady slice
inside the window (a whole window of a few-millisecond step would hold
millions of events), read into kernel intervals, the device's busy time,
its idle gaps, and the host span each gap fell in.

The profiler records device activity only (CUPTI sees every stream and
every kernel inside a CUDA-graph replay); what the host was doing comes
from :class:`~crane_bench.system.HostSpans`. Events are summed as they
stand, never through ``key_averages()``.
"""

from __future__ import annotations

import bisect
import time

import torch

# the longest slice; a shorter window gets a quarter of itself
SLICE_S = 4.0
TOP = 10
NEST = 4


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up, so the slice's own start
    does not pay CUPTI's first initialisation."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(8, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x + 1).sum().item()


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of each device event: kernels, copies and
    sets, no annotation and no event the profiler hides."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.is_async():
            continue
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Slice:
    """The profiled slice: started and stopped from the main thread while
    the clients and the engine run, each between two engine steps."""

    def __init__(self, host_spans: list, gate):
        self.host_spans = host_spans
        self.gate = gate  # held by the engine's steps (system.HostSpans)
        self.events: list[tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0
        self.p0 = self.p1 = 0.0  # the same bounds on time.perf_counter

    def run(self, window_start: float, window_end: float) -> None:
        """Profile ``SLICE_S`` (or a quarter of a shorter window) in the
        middle of the window ``[window_start, window_end)`` (perf_counter)."""
        from torch.profiler import ProfilerActivity, profile

        length = min(SLICE_S, (window_end - window_start) / 4)
        start = window_start + (window_end - window_start - length) / 2
        time.sleep(max(0.0, start - time.perf_counter()))
        prof = profile(activities=[ProfilerActivity.CUDA])
        with self.gate:  # between engine steps: nothing launches meanwhile
            prof.start()
        self.p0, self.t0_ns = time.perf_counter(), time.time_ns()
        time.sleep(length)
        self.p1, self.t1_ns = time.perf_counter(), time.time_ns()
        with self.gate:
            torch.cuda.synchronize()
            prof.stop()
        self.events = [(n, max(a, self.t0_ns), min(b, self.t1_ns))
                       for n, a, b in device_events(prof) if b > self.t0_ns and a < self.t1_ns]

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        return union([(a, b) for _, a, b in self.events])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_seconds(self, include: tuple[str, ...], exclude: tuple[str, ...] = ()) -> float:
        """Device seconds of the events whose name holds any of ``include``
        and none of ``exclude``."""
        return sum(b - a for n, a, b in self.events
                   if any(w in n for w in include) and not any(w in n for w in exclude)) / 1e9

    def top_ops(self) -> list[list]:
        by: dict[str, int] = {}
        for n, a, b in self.events:
            by[n] = by.get(n, 0) + (b - a)
        return [[n[:160], ns / 1e9] for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """Idle device seconds in the slice, summed by the innermost host
        span open at each gap's middle (``host: outside the engine's calls``
        where none was)."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for ab in busy for x in ab] + [self.t1_ns]
        spans = sorted(self.host_spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        by: dict[str, int] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            # spans nest at most a few deep: the innermost open one is among
            # the last few that started before the middle
            i = bisect.bisect_right(starts, mid)
            name = next((s[0] for s in reversed(spans[max(0, i - NEST):i]) if s[2] > mid),
                        "host: outside the engine's calls")
            by[name] = by.get(name, 0) + (b - a)
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
