"""Token streamers (reference generation/streamer.rs:7-107).

``TokenStreamer`` protocol: ``append(token_id) -> bool | None`` (False stops
generation), ``finalize()``. ``TextStreamer`` prints incrementally;
``AsyncTextStreamer`` feeds a queue for SSE/async consumers (the channel-based
variant in the reference).

A copy of ``crane_tpu/generation/streamer.py``: the port imports nothing of
``crane_tpu``."""

from __future__ import annotations

import queue
import sys
from typing import Optional

from crane_tpu_torch.tokenizer.token_stream import TokenOutputStream


class TokenStreamer:
    def append(self, token_id: int):  # pragma: no cover - interface
        return True

    def finalize(self):  # pragma: no cover - interface
        pass


class TextStreamer(TokenStreamer):
    def __init__(self, tokenizer, out=None):
        self.stream = TokenOutputStream(tokenizer)
        self.out = out or sys.stdout
        self.text = ""

    def append(self, token_id: int):
        piece = self.stream.next_token(token_id)
        if piece:
            self.text += piece
            self.out.write(piece)
            self.out.flush()
        return True

    def finalize(self):
        rest = self.stream.decode_rest()
        if rest:
            self.text += rest
            self.out.write(rest)
            self.out.flush()


class CollectStreamer(TokenStreamer):
    """Collects decoded text without printing (tests, SDK)."""

    def __init__(self, tokenizer):
        self.stream = TokenOutputStream(tokenizer)
        self.pieces: list[str] = []

    def append(self, token_id: int):
        piece = self.stream.next_token(token_id)
        if piece:
            self.pieces.append(piece)
        return True

    def finalize(self):
        rest = self.stream.decode_rest()
        if rest:
            self.pieces.append(rest)

    @property
    def text(self) -> str:
        return "".join(self.pieces)


class AsyncTextStreamer(TokenStreamer):
    """Queue-backed streamer for async consumers. ``None`` marks the end."""

    def __init__(self, tokenizer, maxsize: int = 0):
        self.stream = TokenOutputStream(tokenizer)
        self.q: "queue.Queue[Optional[str]]" = queue.Queue(maxsize)

    def append(self, token_id: int):
        piece = self.stream.next_token(token_id)
        if piece:
            self.q.put(piece)
        return True

    def finalize(self):
        rest = self.stream.decode_rest()
        if rest:
            self.q.put(rest)
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item
