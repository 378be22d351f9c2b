"""Tekken tokenizer: Mistral's tiktoken-style byte-level BPE (``tekken.json``).

The reference loads released Voxtral checkpoints through mistral-rs's
``Tekkenizer`` (crane-core src/models/voxtral_tts/
model.rs:315-329). This is a from-scratch reader of the same public file
format so real ``tekken.json`` files work here too:

  {"config": {"pattern": <regex>, "default_vocab_size": N,
              "default_num_special_tokens": K, "version": "v7"},
   "vocab": [{"rank": i, "token_bytes": <base64>, "token_str": ...}, ...],
   "special_tokens": [{"rank": i, "token_str": "...", "is_control": true}]}

Token ids are special-offset: id = K + rank for BPE tokens, id = rank for
special tokens. Encoding is greedy regex pre-splitting followed by standard
lowest-rank-first byte-pair merging. Only the first
``default_vocab_size - K`` BPE ranks are active (files can carry a larger
trained vocab than the model uses).

A copy of ``crane_tpu/tokenizer/tekken.py``: the port imports nothing of
``crane_tpu``. ``regex`` is imported at first use (the machine with the card
has none, and loads no Tekkenizer).
"""

from __future__ import annotations

import base64
import json

# Files predating the explicit "special_tokens" field (version <= v3) use
# this fixed list (mistral-common's deprecated default specials).
_V3_SPECIALS = [
    "<unk>", "<s>", "</s>", "[INST]", "[/INST]",
    "[AVAILABLE_TOOLS]", "[/AVAILABLE_TOOLS]", "[TOOL_RESULTS]",
    "[/TOOL_RESULTS]", "[TOOL_CALLS]", "[IMG]", "<pad>", "[IMG_BREAK]",
    "[IMG_END]", "[PREFIX]", "[MIDDLE]", "[SUFFIX]",
]


class Tekkenizer:
    def __init__(
        self,
        vocab: list[bytes],
        special_tokens: list[str],
        pattern: str,
        vocab_size: int,
    ):
        self.num_special_tokens = len(special_tokens)
        self.vocab_size = vocab_size
        n_bpe = vocab_size - self.num_special_tokens
        self._tokens = vocab[:n_bpe]
        self._ranks = {b: i for i, b in enumerate(self._tokens)}
        self._specials = {s: i for i, s in enumerate(special_tokens)}
        self._special_list = list(special_tokens)
        import regex

        self._pat = regex.compile(pattern)

    # ── construction ──────────────────────────────────────────────────────
    @classmethod
    def from_file(cls, path: str) -> "Tekkenizer":
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        cfg = raw["config"]
        vocab = [None] * len(raw["vocab"])
        for e in raw["vocab"]:
            vocab[e["rank"]] = base64.b64decode(e["token_bytes"])
        n = cfg.get("default_num_special_tokens", 1000)
        if raw.get("special_tokens"):
            # mistral-common pads an explicit list to default_num_special_tokens
            # with placeholders — the BPE id offset is ALWAYS n, even when the
            # file only lists the ~30 defined controls
            sp = [None] * max(len(raw["special_tokens"]), n)
            for e in raw["special_tokens"]:
                sp[e["rank"]] = e["token_str"]
            for i, s in enumerate(sp):
                if s is None:
                    sp[i] = f"<SPECIAL_{i}>"
        else:
            sp = _V3_SPECIALS + [
                f"<SPECIAL_{i}>" for i in range(len(_V3_SPECIALS), n)
            ]
        return cls(
            vocab, sp, cfg["pattern"],
            cfg.get("default_vocab_size", len(sp) + len(vocab)),
        )

    # ── ids <-> tokens ────────────────────────────────────────────────────
    @property
    def bos_id(self) -> int:
        return self._specials.get("<s>", 1)

    @property
    def eos_id(self) -> int:
        return self._specials.get("</s>", 2)

    def token_to_id(self, s: str) -> int | None:
        if s in self._specials:
            return self._specials[s]
        r = self._ranks.get(s.encode("utf-8"))
        return None if r is None else r + self.num_special_tokens

    # ── encode / decode ───────────────────────────────────────────────────
    def _bpe(self, piece: bytes) -> list[int]:
        r = self._ranks.get(piece)
        if r is not None:
            return [r]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_i, best_rank = -1, None
            for i in range(len(parts) - 1):
                rank = self._ranks.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_i, best_rank = i, rank
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [self._ranks[p] for p in parts]

    def encode(self, text: str, bos: bool = False, eos: bool = False) -> list[int]:
        off = self.num_special_tokens
        ids: list[int] = [self.bos_id] if bos else []
        for piece in self._pat.findall(text):
            ids.extend(r + off for r in self._bpe(piece.encode("utf-8")))
        if eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids, *, include_specials: bool = False) -> str:
        out: list[bytes] = []
        for i in ids:
            i = int(i)
            if i < self.num_special_tokens:
                if include_specials:
                    out.append(self._special_list[i].encode("utf-8"))
            else:
                out.append(self._tokens[i - self.num_special_tokens])
        return b"".join(out).decode("utf-8", errors="replace")
