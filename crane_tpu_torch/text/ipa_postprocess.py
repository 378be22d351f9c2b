"""Single-pass IPA postprocessing (reference g2p/ipa_postprocess.rs).

Three fixed passes regardless of table size: NFC normalization, one
leftmost-longest multi-pattern replacement pass (non-cascading: patterns
match the ORIGINAL text only, never another rule's output), and one combined
vocab-filter / whitespace-collapse / unknown-codepoint-coercion pass.

A copy of ``crane_tpu/text/ipa_postprocess.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import bisect
import re
import unicodedata


class IpaNormalizer:
    """Compiled once per (language, vocoder) pair.

    ``replacements``: ordered (pattern, replacement) pairs — compiled into a
    single alternation with longer patterns winning at equal start positions
    (the reference's Aho-Corasick MatchKind::LeftmostLongest). ``vocab``:
    codepoints the vocoder accepts; anything else is coerced to the nearest
    codepoint (by Unicode scalar) in ``coerce_pool``, or dropped when the
    pool is empty (the Kokoro case; Piper populates it).
    """

    def __init__(self, replacements, vocab, coerce_pool=()):
        self._repl = dict(replacements)
        if self._repl:
            pattern = "|".join(
                re.escape(p)
                for p in sorted(self._repl, key=len, reverse=True)
            )
            self._re = re.compile(pattern)
        else:
            self._re = None
        self._vocab = set(vocab)
        self._pool = sorted(set(coerce_pool) & self._vocab or set(coerce_pool))

    def _coerce(self, c: str) -> str:
        if not self._pool:
            return ""
        cp = ord(c)
        i = bisect.bisect_left([ord(p) for p in self._pool], cp)
        cands = []
        if i > 0:
            cands.append(self._pool[i - 1])
        if i < len(self._pool):
            cands.append(self._pool[i])
        return min(cands, key=lambda p: abs(ord(p) - cp))

    def normalize(self, ipa: str) -> str:
        s = unicodedata.normalize("NFC", ipa)
        if self._re is not None:
            s = self._re.sub(lambda m: self._repl[m.group(0)], s)
        out = []
        prev_space = True  # collapse leading whitespace too
        for c in s:
            if c.isspace():
                if not prev_space:
                    out.append(" ")
                    prev_space = True
                continue
            if c not in self._vocab:
                c = self._coerce(c)
                if not c:
                    continue
            out.append(c)
            prev_space = False
        while out and out[-1] == " ":
            out.pop()
        return "".join(out)
