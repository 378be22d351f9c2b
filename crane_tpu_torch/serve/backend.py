"""Capped-concurrency model backends for models outside the slot engine.

Reference behavior (crane-serve ``src/backend.rs``): every
loaded model is served through a ModelBackend handle holding the model behind
a concurrency cap (a Mutex == cap 1). The static-slot engine covers CausalLM
(continuous batching); models with bespoke forwards — Gemma3n (AltUp / PLE /
KV-sharing) and single-sequence VLMs — serve through this backend instead, so
every factory-loadable model is reachable over HTTP.

A copy of ``crane_tpu/serve/backend.py``: the port imports nothing of
``crane_tpu``.
"""

from __future__ import annotations

import asyncio
import threading
import concurrent.futures
from typing import Optional, Sequence

import numpy as np

from crane_tpu_torch.tokenizer.token_stream import TokenOutputStream


class LoopStreamer:
    """TokenStreamer that bridges decoded text pieces from the generation
    thread into an asyncio queue on the server's event loop (``None`` marks
    the end; an exception is forwarded as a final ``(exc,)`` tuple)."""

    def __init__(self, tokenizer, loop: asyncio.AbstractEventLoop):
        self.stream = TokenOutputStream(tokenizer)
        self.loop = loop
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.n_tokens = 0
        self.cancelled = threading.Event()

    def cancel(self):
        """Stop the producing generate loop (SSE client disconnected) —
        generate_greedy treats a False append as early stop."""
        self.cancelled.set()

    def append(self, token_id: int):
        if self.cancelled.is_set():
            return False
        self.n_tokens += 1
        piece = self.stream.next_token(token_id)
        if piece:
            self.loop.call_soon_threadsafe(self.queue.put_nowait, piece)
        return True

    def finalize(self):
        rest = self.stream.decode_rest()

        def _fin():
            if rest:
                self.queue.put_nowait(rest)
            self.queue.put_nowait(None)

        self.loop.call_soon_threadsafe(_fin)

    def fail(self, exc: BaseException):
        self.loop.call_soon_threadsafe(self.queue.put_nowait, (exc,))


class TextBackend:
    """One loaded text model + tokenizer behind a ``concurrency``-wide
    executor. The model must expose
    ``generate_greedy(ids [1, S], max_new_tokens, eos=(), streamer=None)``.
    """

    def __init__(
        self,
        model,
        tokenizer,
        *,
        eos_token_ids: Sequence[int] = (),
        concurrency: int = 1,
        name: str = "text",
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.eos_token_ids = tuple(eos_token_ids)
        self.name = name
        self.pool = concurrent.futures.ThreadPoolExecutor(concurrency, name)

    def generate_sync(
        self, ids: Sequence[int], max_new_tokens: int, streamer=None
    ) -> list[int]:
        return self.model.generate_greedy(
            np.asarray([list(ids)], np.int32), max_new_tokens,
            eos=self.eos_token_ids, streamer=streamer,
        )

    async def generate(self, ids, max_new_tokens: int) -> tuple[str, int]:
        """Non-streaming: returns (text, n_generated)."""
        from crane_tpu_torch.generation.streamer import CollectStreamer

        loop = asyncio.get_running_loop()
        st = CollectStreamer(self.tokenizer)
        out = await loop.run_in_executor(
            self.pool, self.generate_sync, list(ids), max_new_tokens, st
        )
        return st.text, len(out)

    def generate_stream(self, ids, max_new_tokens: int) -> LoopStreamer:
        """Streaming: kicks generation off on the pool and returns the
        loop-bridged streamer to drain."""
        loop = asyncio.get_running_loop()
        st = LoopStreamer(self.tokenizer, loop)

        def run():
            try:
                self.generate_sync(list(ids), max_new_tokens, st)
            except BaseException as e:  # surfaced to the SSE consumer
                st.fail(e)

        self.pool.submit(run)
        return st
