"""Grapheme-to-phoneme engine: text normalization, numeral expansion,
lexicon lookup with letter-to-sound fallback.

Reference behavior (crane-core src/models/g2p/, ~6k LoC):
``Phonemizer`` trait, lexicon lookup, rule engines, numeral expansion, text
normalization, IPA postprocessing, and an OOV model with beam search + LRU
cache (kokoro_tts/README.md:20-43). This module implements the deterministic
core (normalization, cardinal/ordinal/decimal/currency/year expansion,
lexicon + rule fallback, LRU-cached OOV hook); a neural OOV model can be
plugged in via ``oov_fn``.

A copy of ``crane_tpu/text/g2p.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Callable, Optional

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"), (100, "hundred")]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    """Cardinal English number name (reference numeral expansion)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[rest] if rest else "")
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale) + " " + name
            rest = n % scale
            return head + (" " + number_to_words(rest) if rest else "")
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ") if " " in words else ("", "", words)
    h2, _, l2 = last.rpartition("-") if "-" in last else ("", "", last)
    if l2 in _ORDINAL_SPECIAL:
        o = _ORDINAL_SPECIAL[l2]
    elif l2.endswith("y"):
        o = l2[:-1] + "ieth"
    else:
        o = l2 + "th"
    last = (h2 + "-" if h2 else "") + o
    return (head + " " if head else "") + last


def year_to_words(n: int) -> str:
    """Common speech forms: 1984 -> nineteen eighty-four, 1900 -> nineteen
    hundred, 2005 -> twenty oh five, 2000 -> two thousand."""
    if 1000 <= n <= 9999 and n % 1000 != 0:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return number_to_words(hi) + " hundred"
        if lo < 10:
            return number_to_words(hi) + " oh " + _ONES[lo]
        return number_to_words(hi) + " " + number_to_words(lo)
    return number_to_words(n)


_ABBREV = {
    "mr": "mister", "mrs": "missus", "dr": "doctor", "st": "saint",
    "vs": "versus", "etc": "et cetera", "no": "number",
}


def normalize_text(text: str) -> str:
    """Expand numerals, currency, ordinals, years, abbreviations; squeeze
    whitespace. Mirrors the reference's normalization stage."""
    def currency(m):
        amount = m.group(1).replace(",", "")
        if "." in amount:
            d, c = amount.split(".")
            out = number_to_words(int(d)) + (" dollars" if int(d) != 1 else " dollar")
            if int(c):
                out += " and " + number_to_words(int(c)) + (
                    " cents" if int(c) != 1 else " cent"
                )
            return out
        v = int(amount)
        return number_to_words(v) + (" dollars" if v != 1 else " dollar")

    text = re.sub(r"\$([0-9][0-9,]*(?:\.[0-9]{1,2})?)", currency, text)
    text = re.sub(
        r"\b([0-9]+)(st|nd|rd|th)\b", lambda m: ordinal_to_words(int(m.group(1))), text
    )
    text = re.sub(
        r"\b(1[1-9][0-9]{2}|20[0-9]{2})\b", lambda m: year_to_words(int(m.group(1))), text
    )

    def decimal(m):
        d, c = m.group(1), m.group(2)
        return (
            number_to_words(int(d)) + " point " + " ".join(_ONES[int(x)] for x in c)
        )

    text = re.sub(r"\b([0-9]+)\.([0-9]+)\b", decimal, text)
    text = re.sub(
        r"\b[0-9][0-9,]*\b",
        lambda m: number_to_words(int(m.group(0).replace(",", ""))),
        text,
    )
    text = re.sub(
        r"\b(" + "|".join(_ABBREV) + r")\.",
        lambda m: _ABBREV[m.group(1).lower()],
        text,
        flags=re.IGNORECASE,
    )
    return re.sub(r"\s+", " ", text).strip()


def letter_to_sound(word: str) -> str:
    """Full hand-written English LTS engine (english_rules.rs parity —
    function words, affix decomposition, context-sensitive graphemes,
    magic-e/r-colored/open-closed vowels, stress insertion); see
    :mod:`crane_tpu_torch.text.english_rules`."""
    from crane_tpu_torch.text.english_rules import hand_oov_rules_ipa

    return hand_oov_rules_ipa(word)


@dataclasses.dataclass
class Phonemizer:
    """Three-tier phonemizer (reference g2p/mod.rs + languages/english.rs):
    lexicon lookup -> letter-to-sound rules -> neural OOV model, with an
    optional IPA postprocessing pass, LRU-cached per word like the
    reference's OOV cache.

    ``lexicon``: a plain dict OR a :class:`crane_tpu_torch.text.lexicon.Lexicon`
    (TSV-compiled, multi-pronunciation). ``oov_fn``: callable word -> IPA
    (e.g. ``OovModel(...).phonemize_word`` — beam-search encoder-decoder,
    crane_tpu_torch.text.oov); rules handle the word when it's absent or raises.
    ``postprocess``: an :class:`crane_tpu_torch.text.ipa_postprocess.IpaNormalizer`
    applied to the final string.
    """

    lexicon: object = dataclasses.field(default_factory=dict)
    oov_fn: Optional[Callable[[str], str]] = None
    word_sep: str = " "
    postprocess: object = None
    use_builtin_lexicon: bool = True

    def __post_init__(self):
        self._oov_cached = functools.lru_cache(maxsize=4096)(self._phonemize_word)
        if self.use_builtin_lexicon:
            from crane_tpu_torch.text.seed_lexicon import SEED_LEXICON

            self._seed = SEED_LEXICON
        else:
            self._seed = {}

    def _lookup(self, word: str) -> Optional[str]:
        # works for plain dicts and Lexicon alike (Lexicon.get returns the
        # lexicographically-first alternative; get_all for heteronym access)
        hit = self.lexicon.get(word)
        if hit is not None:
            return hit
        return self._seed.get(word)

    def _phonemize_word(self, word: str) -> str:
        lex = self._lookup(word)
        if lex is not None:
            return lex
        if self.oov_fn is not None:
            try:
                out = self.oov_fn(word)
                if out:
                    return out
            except Exception:
                pass  # tier miss, not a hard failure (english.rs semantics)
        return letter_to_sound(word)

    def phonemize(self, text: str) -> str:
        text = normalize_text(text)
        words = re.findall(r"[a-zA-Z']+", text)
        out = self.word_sep.join(self._oov_cached(w.lower()) for w in words)
        if self.postprocess is not None:
            out = self.postprocess.normalize(out)
        return out

    @classmethod
    def from_assets(cls, lexicon_tsv: str | None = None,
                    oov_dir: str | None = None, **kw) -> "Phonemizer":
        """Build from released assets: a ``word\\tIPA`` TSV lexicon and/or a
        Moonshine-TTS OOV model directory (onnx-config.json + model.onnx)."""
        lex: object = {}
        if lexicon_tsv:
            from crane_tpu_torch.text.lexicon import Lexicon

            lex = Lexicon.from_tsv(lexicon_tsv)
        oov = None
        if oov_dir:
            from crane_tpu_torch.text.oov import OovModel

            oov = OovModel.from_dir(oov_dir).phonemize_word
        return cls(lexicon=lex, oov_fn=oov, **kw)


class MultilingualPhonemizer:
    """Language-routing phonemizer (reference ``LanguageG2p``,
    g2p/languages/mod.rs): ``en*`` -> the English three-tier engine,
    ``de*`` -> :class:`crane_tpu_torch.text.german.GermanG2p`. Exposes the
    2-argument ``text_to_ipa(text, language)`` protocol KokoroTts injects."""

    def __init__(self, english: "Phonemizer | None" = None, german=None):
        self.english = english or Phonemizer()
        if german is None:
            from crane_tpu_torch.text.german import GermanG2p

            german = GermanG2p("")  # rules-only until a lexicon is supplied
        self.german = german

    def text_to_ipa(self, text: str, language: str = "en_us") -> str:
        if str(language).lower().startswith("de"):
            return self.german.text_to_ipa(text)
        return self.english.phonemize(text)

    def phonemize(self, text: str) -> str:
        return self.text_to_ipa(text)
