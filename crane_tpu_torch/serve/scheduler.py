"""Prefill-priority FIFO scheduler (reference crane-serve/src/engine/scheduler.rs).

Waiting sequences are admitted one per engine step (one full-prompt prefill),
decode processes ALL running sequences. ``max_running`` is bounded by the
number of static KV slots.

A copy of ``crane_tpu/serve/scheduler.py``: the port imports nothing of ``crane_tpu``."""

from __future__ import annotations

from collections import deque
from typing import Optional

from crane_tpu_torch.serve.sequence import Sequence


class Scheduler:
    def __init__(self, max_running: int):
        self.max_running = max_running
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []

    def add(self, seq: Sequence):
        self.waiting.append(seq)

    def next_prefill(self) -> Optional[Sequence]:
        """Pop one waiting sequence if a slot is free (prefill priority)."""
        if self.waiting and len(self.running) < self.max_running:
            return self.waiting.popleft()
        return None

    def promote(self, seq: Sequence):
        self.running.append(seq)

    def finish(self, seq: Sequence):
        if seq in self.running:
            self.running.remove(seq)

    def requeue(self, seq: Sequence):
        """Preempted sequence goes to the END of the waiting queue — the
        head is the starved request the preemption made room for
        (reference longest-first preempt-and-requeue, engine/mod.rs:477-545)."""
        if seq in self.running:
            self.running.remove(seq)
        self.waiting.append(seq)

    def drop_waiting(self, request_id: str) -> bool:
        for s in list(self.waiting):
            if s.request_id == request_id:
                self.waiting.remove(s)
                return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
