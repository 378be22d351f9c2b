"""Closed-loop clients of ``InferenceEngine``: one thread per client, each
sending its sessions' turns through ``engine.submit`` and stamping every
token it reads off its response queue on the host clock."""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from crane_bench import traffic
from crane_tpu_torch.serve.sequence import EngineRequest, SamplingOptions

# how long after the window closes a client may still wait for the first
# token of a request it sent inside the window
FIRST_TOKEN_GRACE_S = 60.0


@dataclasses.dataclass
class Record:
    """One request as its client saw it."""

    rid: str
    client: int
    session: int
    turn: int
    greedy: bool
    prompt: np.ndarray     # int64 token ids
    new_tokens: int        # prompt tokens not already in the session's earlier turns
    max_new: int
    submit_t: float = 0.0
    times: list = dataclasses.field(default_factory=list)   # host clock of each token
    tokens: list = dataclasses.field(default_factory=list)
    finish: str | None = None
    error: str | None = None

    @property
    def complete(self) -> bool:
        """Finished by its length, every token received."""
        return self.finish == "length" and len(self.tokens) == self.max_new


class Clients:
    """The mix's clients over one engine. :meth:`run` opens the window, lets
    every client send until it closes, then waits for the first token of
    each request still running (at most ``FIRST_TOKEN_GRACE_S``), aborts
    them and joins the threads."""

    def __init__(self, engine, mix: dict, seed: int, vocab: int, engine_alive):
        self.engine = engine
        self.seed = seed
        self.vocab = vocab
        self.engine_alive = engine_alive
        self.sessions = traffic.client_sessions(mix, seed)
        self.system = traffic.system_prompt_ids(mix, seed, vocab)
        s = mix["sampling"]
        self._sampled = SamplingOptions(temperature=s["temperature"], top_k=s["top_k"],
                                        top_p=s["top_p"],
                                        repetition_penalty=s["repetition_penalty"],
                                        do_sample=True)
        self._greedy = SamplingOptions(repetition_penalty=1.0, do_sample=False)
        self.records: list[Record] = []
        self._lock = threading.Lock()
        self.t_end = float("inf")
        self.failure: str | None = None

    def _client(self, c: int) -> None:
        ids = traffic.id_stream(self.seed, c)
        for session in self.sessions[c]:
            prev: Record | None = None
            for k, turn in enumerate(session.turns):
                if time.perf_counter() >= self.t_end:
                    return
                msg = ids.integers(0, self.vocab, turn.message, dtype=np.int64)
                if prev is None:
                    prompt = np.concatenate([self.system, msg])
                    new = len(prompt)
                else:
                    prompt = np.concatenate([prev.prompt, np.asarray(prev.tokens, np.int64), msg])
                    # the previous answer's last token was never fed to the model
                    new = len(prompt) - (len(prev.prompt) + len(prev.tokens) - 1)
                rec = Record(f"c{c}s{session.index}t{k}", c, session.index, k, session.greedy,
                             prompt, new, turn.answer)
                with self._lock:
                    self.records.append(rec)
                req = EngineRequest(rec.rid, prompt.tolist(), max_new_tokens=turn.answer,
                                    sampling=self._greedy if session.greedy else self._sampled,
                                    eos_token_ids=())
                rec.submit_t = time.perf_counter()
                q = self.engine.submit(req)
                if not self._read(rec, q):
                    return
                prev = rec

    def _read(self, rec: Record, q) -> bool:
        """Read ``rec``'s responses to the end; False when the client stops.
        The engine puts a decode block's tokens together: one wake takes
        every response waiting, so the clients hold the interpreter lock
        once a block each and not once a token."""
        while True:
            try:
                batch = [q.get(timeout=1.0)]
            except queue.Empty:
                if not self.engine_alive():
                    self.failure = "the engine thread died"
                    return False
                continue
            now = time.perf_counter()
            while True:
                try:
                    batch.append(q.get_nowait())
                except queue.Empty:
                    break
            for resp in batch:
                if resp.error is not None:
                    rec.error = resp.error
                    rec.finish = "error"
                    return False
                if resp.token is not None:
                    rec.times.append(now)
                    rec.tokens.append(int(resp.token))
                if resp.finished:
                    rec.finish = resp.finish_reason.value if resp.finish_reason else "unknown"
                    return rec.complete

    def run(self, ramp: float, seconds: float, at_open=None, during=None,
            at_close=None) -> tuple[float, float]:
        """Serve ``ramp`` seconds, then the window of ``seconds``; returns the
        window's (start, end) on the host clock. The clients start together
        when the ramp starts, so the window opens on a running system, not
        on every client's first request at once. ``at_open()`` and
        ``at_close()`` are called as the window opens and closes;
        ``during(t0, t_end)``, called on this thread in between, returns
        before the window ends (the traced slice)."""
        threads = [threading.Thread(target=self._client, args=(c,), name=f"client{c}",
                                    daemon=True) for c in range(len(self.sessions))]
        t0 = time.perf_counter() + ramp
        self.t_end = t0 + seconds
        for t in threads:
            t.start()
        time.sleep(max(0.0, t0 - time.perf_counter()))
        if at_open is not None:
            at_open()
        if during is not None:
            during(t0, self.t_end)
        time.sleep(max(0.0, self.t_end - time.perf_counter()))
        t1 = self.t_end
        if at_close is not None:
            at_close()
        grace = t1 + FIRST_TOKEN_GRACE_S
        while time.perf_counter() < grace and self.engine_alive():
            with self._lock:
                waiting = [r for r in self.records if r.finish is None and not r.times]
            if not waiting:
                break
            time.sleep(0.01)
        with self._lock:
            running = [r for r in self.records if r.finish is None]
        for r in running:
            self.engine.abort(r.rid)
        for t in threads:
            t.join(timeout=30.0)
        if any(t.is_alive() for t in threads):
            self.failure = self.failure or "a client did not finish after the window"
        return t0, t1
