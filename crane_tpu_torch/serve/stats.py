"""Engine statistics (reference crane-serve/src/engine/stats.rs:6-92).

Plain counters mutated only on the engine thread; snapshots are cheap dict
copies exposed at /v1/stats and the SGLang /server_info endpoint.

A copy of ``crane_tpu/serve/stats.py``: the port imports nothing of ``crane_tpu``."""

from __future__ import annotations

import time


class EngineStats:
    def __init__(self):
        self.started_at = time.monotonic()
        self.requests_received = 0
        self.requests_completed = 0
        self.requests_aborted = 0
        self.requests_failed = 0
        self.requests_preempted = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.prefill_time_s = 0.0
        self.decode_time_s = 0.0
        self.engine_steps = 0
        self.spec_steps = 0       # speculative verify forwards run
        self.spec_tokens = 0      # tokens emitted by speculative steps
        self.prefix_hits = 0          # admissions that reused a resident prefix
        self.prefix_tokens_reused = 0  # prompt tokens NOT re-prefilled

    def snapshot(self, *, running: int = 0, waiting: int = 0) -> dict:
        uptime = time.monotonic() - self.started_at
        return {
            "uptime_s": round(uptime, 3),
            "requests_received": self.requests_received,
            "requests_completed": self.requests_completed,
            "requests_aborted": self.requests_aborted,
            "requests_failed": self.requests_failed,
            "requests_preempted": self.requests_preempted,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "engine_steps": self.engine_steps,
            "spec_steps": self.spec_steps,
            "spec_tokens": self.spec_tokens,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "running": running,
            "waiting": waiting,
            "prefill_tok_s": round(
                self.prompt_tokens / self.prefill_time_s, 2
            ) if self.prefill_time_s > 0 else 0.0,
            "decode_tok_s": round(
                self.generated_tokens / self.decode_time_s, 2
            ) if self.decode_time_s > 0 else 0.0,
        }
