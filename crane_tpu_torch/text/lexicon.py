"""TSV word-to-IPA lexicon (reference g2p/lexicon.rs).

The reference compiles ``word\\tIPA`` TSV files into an FST with a packed
IPA buffer; the behaviors that matter to callers are reproduced here over a
plain dict (CPython interns the strings; the FST exists in Rust to avoid
per-entry allocations, which Python can't meaningfully win back):

- heteronyms keep EVERY distinct pronunciation; ``get`` returns the
  lexicographically-first alternative, ``get_all`` returns all of them
- duplicate (word, IPA) pairs are deduped
- entries are matched exactly; callers normalize case themselves

A copy of ``crane_tpu/text/lexicon.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import gzip


class Lexicon:
    def __init__(self, entries: dict[str, tuple[str, ...]]):
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, word: str) -> bool:
        return word in self._entries

    def get(self, word: str) -> str | None:
        """Lexicographically-first pronunciation, or None."""
        alts = self._entries.get(word)
        return alts[0] if alts else None

    def get_all(self, word: str) -> tuple[str, ...]:
        return self._entries.get(word, ())

    @classmethod
    def from_tsv(cls, path: str) -> "Lexicon":
        """``word\\tIPA`` per line; blank lines and ``#`` comments skipped;
        ``.gz`` paths are decompressed. Multiple lines for one word collect
        as sorted alternatives (lexicon.rs multi-pronunciation packing)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            try:
                return cls.from_tsv_text(f.read())
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from None

    @classmethod
    def from_tsv_text(cls, content: str) -> "Lexicon":
        """Same format as :meth:`from_tsv`, from in-memory TSV content
        (reference GermanG2p::new takes lexicon content, german.rs:45-47)."""
        raw: dict[str, set] = {}
        # split on \n only: splitlines() also breaks on \x0b/\x85/\u2028,
        # which can legitimately appear inside IPA fields
        for lineno, line in enumerate(content.split("\n"), 1):
            line = line.rstrip("\r")
            if not line or line.startswith("#"):
                continue
            if "\t" not in line:
                raise ValueError(f"line {lineno}: expected word\\tIPA")
            word, ipa = line.split("\t", 1)
            if not word or not ipa:
                raise ValueError(f"line {lineno}: empty word or IPA")
            raw.setdefault(word, set()).add(ipa)
        return cls({w: tuple(sorted(alts)) for w, alts in raw.items()})

    @classmethod
    def from_pairs(cls, pairs) -> "Lexicon":
        raw: dict[str, set] = {}
        for word, ipa in pairs:
            raw.setdefault(word, set()).add(ipa)
        return cls({w: tuple(sorted(alts)) for w, alts in raw.items()})
