"""Per-request sequence state (reference crane-serve/src/engine/sequence.rs).

A Sequence tracks one in-flight request: prompt, generated tokens, sampling
parameters, streaming channel, and its KV slot. Responses flow through a
thread-safe queue to the HTTP layer (the reference's mpsc ``response_tx``).

A copy of ``crane_tpu/serve/sequence.py``: the port imports nothing of ``crane_tpu``."""

from __future__ import annotations

import dataclasses
import enum
import queue
import time
from typing import Optional


class FinishReason(str, enum.Enum):
    STOP = "stop"          # hit an EOS token
    LENGTH = "length"      # hit max_new_tokens / max_seq_len
    ABORT = "abort"        # cancelled by client or /abort_request
    ERROR = "error"


@dataclasses.dataclass
class SamplingOptions:
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    repetition_penalty: float = 1.05
    do_sample: bool = True
    seed: int = 0


@dataclasses.dataclass
class EngineRequest:
    request_id: str
    prompt_ids: list[int]
    max_new_tokens: int = 512
    sampling: SamplingOptions = dataclasses.field(default_factory=SamplingOptions)
    eos_token_ids: tuple[int, ...] = ()
    # OpenAI ``stop``: generation halts when any of these strings appears in
    # the decoded output; the matched string and everything after it is
    # never emitted. (The reference parses this field but never consumes it,
    # openai_api.rs:45 — here it is implemented.)
    stop_strings: tuple[str, ...] = ()


@dataclasses.dataclass
class EngineResponse:
    """One streamed event: a token, the end of stream, or an error."""

    request_id: str
    token: Optional[int] = None
    text: Optional[str] = None
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    error: Optional[str] = None
    n_prompt_tokens: int = 0
    n_generated: int = 0


class Sequence:
    def __init__(self, request: EngineRequest, response_q: "queue.Queue[EngineResponse]"):
        self.request = request
        self.response_q = response_q
        self.generated: list[int] = []
        self.slot: int = -1
        self.detok = None  # TokenOutputStream attached by the engine
        self.finish_reason: Optional[FinishReason] = None
        self.cancelled = False
        self.preempted = False
        self.submitted_at = time.monotonic()
        # on the tracing clock (utils/tracing.py): the submit, and the start
        # of the current wait for admission (the submit, or a preemption's
        # requeue)
        self.submitted_ns = self.queued_ns = time.time_ns()
        self.first_token_at: Optional[float] = None
        self.stopped_by_string = False
        self._stop_buf = ""

    @property
    def request_id(self) -> str:
        return self.request.request_id

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt_ids)

    def context_ids(self) -> list[int]:
        """Prompt + already-generated tokens — the prefill input when the
        sequence is (re)admitted after a preemption. Re-prefilling this
        reconstructs the evicted KV state exactly (static-slot translation
        of the reference's KV swap-out/swap-in)."""
        return list(self.request.prompt_ids) + self.generated

    def should_stop(self, token: int) -> Optional[FinishReason]:
        if token in self.request.eos_token_ids:
            return FinishReason.STOP
        if len(self.generated) >= self.request.max_new_tokens:
            return FinishReason.LENGTH
        return None

    def filter_stop(self, text: str) -> tuple[str, bool]:
        """Stop-string holdback filter: returns (emittable_text, stopped).
        Text is buffered so that no prefix of a stop string is ever emitted;
        on a match the text BEFORE the match is released and everything
        from the match on is dropped."""
        ss = self.request.stop_strings
        if not ss:
            return text, False
        self._stop_buf += text
        # earliest match POSITION wins (OpenAI semantics), not tuple order:
        # stop=["world", "lo"] on "hello world" must truncate at "lo"
        matches = [i for s in ss if (i := self._stop_buf.find(s)) >= 0]
        if matches:
            out = self._stop_buf[: min(matches)]
            self._stop_buf = ""
            return out, True
        keep = max(len(s) for s in ss) - 1
        if keep <= 0:
            out, self._stop_buf = self._stop_buf, ""
            return out, False
        out = self._stop_buf[:-keep] if len(self._stop_buf) > keep else ""
        self._stop_buf = self._stop_buf[len(out):]
        return out, False

    def flush_stop_buf(self) -> str:
        out, self._stop_buf = self._stop_buf, ""
        return out

    def send_token(self, token: int, text: Optional[str] = None):
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.response_q.put(
            EngineResponse(self.request_id, token=token, text=text,
                           n_generated=len(self.generated))
        )

    def send_finished(self, reason: FinishReason):
        self.finish_reason = reason
        self.response_q.put(
            EngineResponse(
                self.request_id, finished=True, finish_reason=reason,
                n_prompt_tokens=self.prompt_len, n_generated=len(self.generated),
            )
        )

    def send_error(self, message: str):
        self.finish_reason = FinishReason.ERROR
        self.response_q.put(
            EngineResponse(self.request_id, finished=True,
                           finish_reason=FinishReason.ERROR, error=message)
        )
