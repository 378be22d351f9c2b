"""Incremental UTF-8-safe detokenization.

A copy of ``crane_tpu/tokenizer/token_stream.py``: the port imports nothing
of ``crane_tpu``.

Reference behavior: TokenOutputStream (crane-core
``utils/token_output_stream.rs``) — decode the growing token buffer and emit only the
stable suffix, holding back bytes that might still change (multi-token UTF-8
sequences, byte-fallback tokens)."""

from __future__ import annotations

from typing import Optional


class TokenOutputStream:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.tokens: list[int] = []
        self.prev_index = 0
        self.current_index = 0

    def next_token(self, token_id: int) -> Optional[str]:
        """Append a token; return newly-stable text, or None if held back."""
        prev_text = self._decode(self.tokens[self.prev_index : self.current_index])
        self.tokens.append(token_id)
        text = self._decode(self.tokens[self.prev_index :])
        if len(text) > len(prev_text) and not text.endswith("�"):
            out = text[len(prev_text) :]
            self.prev_index = self.current_index
            self.current_index = len(self.tokens)
            return out
        return None

    def decode_rest(self) -> Optional[str]:
        """Flush any remaining held-back text."""
        prev_text = self._decode(self.tokens[self.prev_index : self.current_index])
        text = self._decode(self.tokens[self.prev_index :])
        if len(text) > len(prev_text):
            return text[len(prev_text) :]
        return None

    def decode_all(self) -> str:
        return self._decode(self.tokens)

    def clear(self):
        self.tokens.clear()
        self.prev_index = 0
        self.current_index = 0

    def _decode(self, ids: list[int]) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=True)
