"""German (de) grapheme-to-phoneme engine.

Reference behavior (crane-core src/models/g2p/languages/
german.rs + german_compound.rs + german_numerals.rs + german_rules.rs):
three tiers — case-cascading lexicon lookup (exact -> title-case ->
lowercase, german.rs:105-133), compound-word decomposition for whole-word
misses (longest-component-first with backtracking, primary stress kept on
the first component only, german_compound.rs), and hand-written
letter-to-sound rules as the final fallback (orthographic syllabification,
ich/ach-laut split, st/sp palatalization at morpheme starts, Dehnungs-h and
open-syllable vowel lengthening, -ig softening, final-obstruent devoicing,
prefix/suffix stress heuristics, german_rules.rs). Digit runs expand to
German cardinals (ones-before-tens compounding, long-scale nouns,
german_numerals.rs) before any lookup.

A copy of ``crane_tpu/text/german.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

from crane_tpu_torch.text.lexicon import Lexicon

IPA_PRIMARY_STRESS = "ˈ"
IPA_SECONDARY_STRESS = "ˌ"


# ── numerals (german_numerals.rs) ───────────────────────────────────────────

_ONES_BOUND = ["", "ein", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
               "acht", "neun"]
_TEENS = ["zehn", "elf", "zwölf", "dreizehn", "vierzehn", "fünfzehn",
          "sechzehn", "siebzehn", "achtzehn", "neunzehn"]
_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
         "siebzig", "achtzig", "neunzig"]
_LARGE_SCALES = [("Million", "Millionen"), ("Milliarde", "Milliarden"),
                 ("Billion", "Billionen"), ("Billiarde", "Billiarden"),
                 ("Trillion", "Trillionen")]


def _two_digit_words(n: int, standalone_one: bool) -> str:
    if n < 10:
        if n == 1 and standalone_one:
            return "eins"
        return _ONES_BOUND[n]
    if n < 20:
        return _TEENS[n - 10]
    tens = _TENS[n // 10]
    ones = n % 10
    return tens if ones == 0 else f"{_ONES_BOUND[ones]}und{tens}"


def _three_digit_words(n: int, standalone_one: bool) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES_BOUND[hundreds]}hundert")
    if rest:
        parts.append(_two_digit_words(rest, standalone_one))
    return " ".join(parts)


def german_cardinal(n: int) -> str:
    """German cardinal spelling: ones-before-tens compounding joined by
    ``und``; bound ``ein`` vs standalone ``eins``; long-scale gendered
    scale nouns (``eine Million`` / ``zwei Millionen``); invariant
    ``tausend`` (german_numerals.rs:65-144)."""
    if n == 0:
        return "null"
    if n >= 1000 ** (len(_LARGE_SCALES) + 2):
        # beyond Trillionen (>= 10^21): read digit-by-digit instead of
        # crashing the request on a scale the table doesn't name
        digits = ("null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
                  "sieben", "acht", "neun")
        return " ".join(digits[int(d)] for d in str(n))
    groups = []
    while n > 0:
        groups.append(n % 1000)
        n //= 1000
    out = []
    for scale in range(len(groups) - 1, -1, -1):
        group = groups[scale]
        if group == 0:
            continue
        if scale == 0:
            out.append(_three_digit_words(group, True))
        elif scale == 1:
            out.append(f"{_three_digit_words(group, False)} tausend")
        else:
            singular, plural = _LARGE_SCALES[scale - 2]
            if group == 1:
                out.append(f"eine {singular}")
            else:
                out.append(f"{_three_digit_words(group, False)} {plural}")
    return " ".join(out)


def expand_numerals(text: str, cardinal=german_cardinal) -> str:
    """Expand standalone digit runs (not adjacent to a letter on either
    side) to cardinal words; runs inside identifiers like ``abc123`` stay
    untouched (numeral_expand.rs:61-110)."""
    out = []
    i, n = 0, len(text)
    last = 0
    while i < n:
        if not text[i].isdigit():
            i += 1
            continue
        start = i
        while i < n and text[i].isdigit():
            i += 1
        before = text[start - 1] if start > 0 else ""
        after = text[i] if i < n else ""
        if (before and before.isalpha()) or (after and after.isalpha()):
            continue
        out.append(text[last:start])
        out.append(cardinal(int(text[start:i])))
        last = i
    if not out:
        return text
    out.append(text[last:])
    return "".join(out)


# ── lexicon cascade (german.rs:105-133) ─────────────────────────────────────


def _title_case(word: str) -> str:
    return word[:1].upper() + word[1:] if word else word


def lookup_cascade(lexicon: Lexicon, word: str):
    """Exact surface form, then title-case, then fully lowercased — the
    German lexicon is not uniformly lowercase (nouns capitalize), so
    case-folding every key would silently miss one form or the other."""
    hit = lexicon.get(word)
    if hit is not None:
        return hit
    if not (word[:1].isupper() if word else False):
        hit = lexicon.get(_title_case(word))
        if hit is not None:
            return hit
    if any(c.isupper() for c in word):
        return lexicon.get(word.lower())
    return None


# ── compound decomposition (german_compound.rs) ─────────────────────────────

MIN_COMPONENT_LEN = 4
MAX_COMPONENTS = 4
MIN_COMPOUND_LEN = 12
MAX_COMPOUND_LEN = 40


def _find_split(lexicon: Lexicon, remaining: str, components_left: int):
    """Longest-prefix-first backtracking cover of ``remaining`` by lexicon
    hits; the whole remainder is tried as a final component before any
    split (german_compound.rs:69-106)."""
    if components_left == 0:
        return None
    total = len(remaining)
    if total >= MIN_COMPONENT_LEN:
        ipa = lookup_cascade(lexicon, remaining)
        if ipa is not None:
            return [(remaining, ipa)]
    if components_left == 1 or total < 2 * MIN_COMPONENT_LEN:
        return None
    for prefix_len in range(total - MIN_COMPONENT_LEN, MIN_COMPONENT_LEN - 1, -1):
        prefix = remaining[:prefix_len]
        prefix_ipa = lookup_cascade(lexicon, prefix)
        if prefix_ipa is None:
            continue
        rest = _find_split(lexicon, remaining[prefix_len:], components_left - 1)
        if rest is not None:
            return [(prefix, prefix_ipa)] + rest
    return None


def _assemble_ipa(components) -> str:
    """Concatenate component IPA; components after the first downgrade
    primary to secondary stress (compound stress stays on the first
    component, german_compound.rs:110-127)."""
    out = []
    for idx, (_, ipa) in enumerate(components):
        if idx == 0:
            out.append(ipa)
        else:
            out.append(ipa.replace(IPA_PRIMARY_STRESS, IPA_SECONDARY_STRESS))
    return "".join(out)


def decompose(lexicon: Lexicon, word: str):
    """Split a lexicon-missing word into 2..4 lexicon-hitting components
    (length-gated: > 12 and <= 40 codepoints) and assemble their IPA with
    compound stress; None when no full cover exists."""
    n = len(word)
    if n <= MIN_COMPOUND_LEN or n > MAX_COMPOUND_LEN:
        return None
    components = _find_split(lexicon, word, MAX_COMPONENTS)
    if components is None or len(components) < 2:
        return None
    return _assemble_ipa(components)


# ── hand rules (german_rules.rs) ────────────────────────────────────────────

UNSTRESSED_PREFIXES = [
    "entgegen", "durch", "wider", "miss", "nach", "bei", "mit", "ver", "zer",
    "ent", "emp", "ge", "be", "er",
]
STRESSED_SUFFIXES = ["ung", "schaft", "tion", "ismus"]

_GERMAN_LETTERS = set("abcdefghijklmnopqrstuvwxyzäöüß")
_VOWELS = set("aeiouyäöü")
_LONG_VOWEL = {"a": "aː", "e": "eː", "i": "iː", "o": "oː", "u": "uː",
               "ä": "ɛː", "ö": "øː", "ü": "yː", "y": "yː"}
_SHORT_VOWEL = {"a": "a", "i": "ɪ", "o": "ɔ", "u": "ʊ", "ä": "ɛ", "ö": "ø",
                "ü": "ʏ", "y": "ʏ"}
_DEVOICE = {"b": "p", "d": "t", "ɡ": "k", "v": "f", "z": "s"}


def _is_vowel(c: str) -> bool:
    return c in _VOWELS


def _normalize_for_rules(word: str) -> str:
    return "".join(
        c for c in word.lower() if c in _GERMAN_LETTERS or c == "-"
    )


def _vowel_nucleus_spans(letters: str):
    """Diphthongs (au/ei/eu/ai/äu/ey/oi), ``ie`` not before a vowel, doubled
    vowels, else single vowels (german_rules.rs:112-144)."""
    spans = []
    i, n = 0, len(letters)
    while i < n:
        if not _is_vowel(letters[i]):
            i += 1
            continue
        if i + 1 < n:
            a, b = letters[i], letters[i + 1]
            is_diph = (a in "aeä" and b == "u") or (a in "eao" and b == "i") \
                or (a == "e" and b == "y")
            is_ie = a == "i" and b == "e" and not (
                i + 2 < n and _is_vowel(letters[i + 2]))
            is_doubled = a == b and a in "aoeiu"
            if is_diph or is_ie or is_doubled:
                spans.append((i, i + 2))
                i += 2
                continue
        spans.append((i, i + 1))
        i += 1
    return spans


def _syllabify_segment(w: str):
    """Everything up to and including a vowel nucleus forms one syllable;
    trailing consonants join the NEXT syllable; a vowel-free run is one
    syllable (german_rules.rs:150-171)."""
    if not w:
        return []
    spans = _vowel_nucleus_spans(w)
    if not spans:
        return [(0, len(w))]
    out, start = [], 0
    for idx, (_, e) in enumerate(spans):
        end = e if idx + 1 < len(spans) else len(w)
        out.append((start, end))
        start = e
    return out


def _build_syllables(word: str):
    """Hyphens mark morpheme boundaries (for st/sp palatalization and /h/)
    and are stripped; each segment syllabifies independently."""
    compact = []
    morpheme_starts = []
    syllables = []
    abs_pos = 0
    for segment in word.split("-"):
        if not segment:
            continue
        starts = [False] * len(segment)
        starts[0] = True
        morpheme_starts.extend(starts)
        for s, e in _syllabify_segment(segment):
            syllables.append((abs_pos + s, abs_pos + e))
        compact.append(segment)
        abs_pos += len(segment)
    return "".join(compact), syllables, morpheme_starts


def _unstressed_prefix_len(word: str) -> int:
    for pref in UNSTRESSED_PREFIXES:
        if len(word) > len(pref) and word.startswith(pref):
            return len(pref)
    return 0


def _stress_syllable_index(syllables, word: str) -> int:
    n = len(syllables)
    if n <= 1:
        return 0
    if any(word.endswith(suf) for suf in STRESSED_SUFFIXES):
        return n - 1
    plen = _unstressed_prefix_len(word)
    if plen > 0:
        acc = 0
        for idx, (s, e) in enumerate(syllables):
            acc += e - s
            if acc >= plen:
                return min(idx + 1, n - 1)
    return 0


def _ch_ipa(word: str, i: int) -> str:
    """/x/ after a back vowel (looking through a silent Dehnungs-h), /ç/
    otherwise (german_rules.rs:233-262)."""
    if i == 0:
        return "ç"
    j = i - 1
    before = None
    if _is_vowel(word[j]):
        before = word[j]
    elif word[j] == "h" and j > 0 and _is_vowel(word[j - 1]):
        before = word[j - 1]
    return "x" if before in ("a", "o", "u") else "ç"


def _following_consonant_run_len(word: str, start: int, morpheme_starts) -> int:
    n = 0
    for j in range(start, len(word)):
        if _is_vowel(word[j]) or morpheme_starts[j]:
            break
        n += 1
    return n


def _try_context_grapheme(syl: str, i: int, word: str, gi: int,
                          morpheme_starts, out: list):
    if syl.startswith("tsch", i):
        out.append("tʃ")
        return 4
    if syl.startswith("sch", i):
        out.append("ʃ")
        return 3
    if syl.startswith("chs", i):
        out.append("ks")
        return 3
    if syl.startswith("ch", i):
        out.append(_ch_ipa(word, gi))
        return 2
    if syl.startswith("ng", i):
        out.append("ŋ")
        return 2
    if syl.startswith("nk", i):
        out.append("ŋk")
        return 2
    if syl.startswith("pf", i):
        out.append("pf")
        return 2
    if syl.startswith("qu", i):
        out.append("kv")
        return 2
    if syl.startswith("st", i) and morpheme_starts[gi]:
        out.append("ʃt")
        return 2
    if syl.startswith("sp", i) and morpheme_starts[gi]:
        out.append("ʃp")
        return 2
    return None


def _try_fixed_consonant(syl: str, i: int, gi: int, morpheme_starts, out: list):
    c = syl[i]
    if c == "h":
        # morpheme-initial /h/ is real; post-vocalic Dehnungs-h and
        # mid-cluster h are silent
        if morpheme_starts[gi]:
            out.append("h")
        return 1
    if c == "ß":
        out.append("s")
        return 1
    if syl.startswith("tz", i):
        out.append("ts")
        return 2
    if c == "z":
        out.append("ts")
        return 1
    if syl.startswith("ck", i):
        out.append("k")
        return 2
    if c == "c" and i + 1 < len(syl) and syl[i + 1] in "ei":
        out.append("ts")
        return 2
    if c == "c":
        out.append("k")
        return 1
    if c == "x":
        out.append("ks")
        return 1
    if c == "q" and (i + 1 >= len(syl) or syl[i + 1] != "u"):
        out.append("k")
        return 1
    if c == "j":
        out.append("j")
        return 1
    if c == "v":
        out.append("f")
        return 1
    if c == "w":
        out.append("v")
        return 1
    if c == "y":
        out.append("ʏ")
        return 1
    return None


def _try_vowel(syl: str, i: int, word: str, gi: int, morpheme_starts, out: list):
    n = len(syl)
    c = syl[i]
    if syl.startswith("au", i):
        out.append("aʊ̯")
        return 2
    if syl.startswith("ei", i) or syl.startswith("ai", i) or syl.startswith("ey", i):
        out.append("aɪ̯")
        return 2
    if syl.startswith("oi", i):
        out.append("ɔʏ̯")
        return 2
    if syl.startswith("eu", i) or syl.startswith("äu", i):
        out.append("ɔʏ̯")
        return 2
    if syl.startswith("ie", i) and not (i + 2 < n and _is_vowel(syl[i + 2])):
        out.append("iː")
        return 2
    if i + 1 < n and _is_vowel(c) and syl[i + 1] == c and c in "aoeiu":
        out.append(_LONG_VOWEL[c])
        return 2
    # Dehnungs-h lengthens (even "e", overriding its schwa reduction)
    if _is_vowel(c) and i + 1 < n and syl[i + 1] == "h":
        out.append(_LONG_VOWEL[c])
        return 2
    # syllable-final -er vocalizes to [ɐ]
    if c == "e" and i + 2 == n and syl[i + 1] == "r":
        out.append("ɐ")
        return 2
    # open-syllable lengthening: syllable-final single vowel with <= 1
    # consonant before the next vowel / morpheme boundary / word end
    if (
        i + 1 == n
        and _is_vowel(c)
        and c != "e"
        and _following_consonant_run_len(word, gi + 1, morpheme_starts) <= 1
    ):
        out.append(_LONG_VOWEL[c])
        return 1
    if _is_vowel(c):
        if c == "e":
            is_schwa = i == n - 1 or (i + 2 == n and syl[i + 1] in "nlmrs")
            out.append("ə" if is_schwa else "ɛ")
        else:
            out.append(_SHORT_VOWEL[c])
        return 1
    return None


def _apply_ig_fix(syl: str, out: list):
    """Syllable-final -ig softens its /ɡ/ to /ç/ unless the i is part of a
    diphthong (german_rules.rs:266-280)."""
    if not syl.endswith("ig"):
        return
    if len(syl) >= 3 and _is_vowel(syl[-3]):
        return
    if out and out[-1].endswith("ɡ"):
        out[-1] = out[-1][:-1] + "ç"


def _final_devoice(ipa: str) -> str:
    if ipa and ipa[-1] in _DEVOICE:
        return ipa[:-1] + _DEVOICE[ipa[-1]]
    return ipa


def _syllable_to_ipa(syl: str, word: str, morpheme_starts, span_start: int) -> str:
    out: list = []
    i, n = 0, len(syl)
    while i < n:
        gi = span_start + i
        consumed = _try_context_grapheme(syl, i, word, gi, morpheme_starts, out)
        if consumed is None:
            consumed = _try_fixed_consonant(syl, i, gi, morpheme_starts, out)
        if consumed is None:
            consumed = _try_vowel(syl, i, word, gi, morpheme_starts, out)
        if consumed is not None:
            i += consumed
            continue
        c = syl[i]
        if c == "r":
            out.append("ʁ")
        elif syl.startswith("ss", i):
            out.append("s")
            i += 2
            continue
        elif c == "s":
            prev_v = i > 0 and _is_vowel(syl[i - 1])
            next_v = i + 1 < n and _is_vowel(syl[i + 1])
            out.append("z" if prev_v and next_v else "s")
        elif c in "bdfklmnpt":
            out.append(c)
        elif c == "g":
            out.append("ɡ")
        i += 1
    _apply_ig_fix(syl, out)
    return _final_devoice("".join(out))


def hand_rules_ipa(word: str) -> str:
    """OOV German word -> approximate IPA via the full rule chain; empty
    string when the word has no recognized German letters."""
    chars = _normalize_for_rules(word)
    compact, syllables, morpheme_starts = _build_syllables(chars)
    if not syllables:
        return ""
    stress_idx = _stress_syllable_index(syllables, compact)
    ipas = [
        _syllable_to_ipa(compact[s:e], compact, morpheme_starts, s)
        for s, e in syllables
    ]
    if 0 <= stress_idx < len(ipas) and ipas[stress_idx]:
        ipas[stress_idx] = IPA_PRIMARY_STRESS + ipas[stress_idx]
    return "".join(ipas)


# ── engine (german.rs) ──────────────────────────────────────────────────────


def _trim_edge_punctuation(token: str) -> str:
    def word_char(c):
        return c.isalnum() or not c.isascii()

    start = next((i for i, c in enumerate(token) if word_char(c)), None)
    if start is None:
        return ""
    end = next(i for i in range(len(token) - 1, -1, -1) if word_char(token[i]))
    return token[start : end + 1]


class GermanG2p:
    """Three-tier German phonemizer over a case-preserving lexicon; see the
    module docstring. Accepts TSV content or a prebuilt Lexicon."""

    def __init__(self, lexicon):
        if isinstance(lexicon, str):
            lexicon = Lexicon.from_tsv_text(lexicon)
        self.lexicon = lexicon

    @classmethod
    def from_tsv(cls, path: str) -> "GermanG2p":
        return cls(Lexicon.from_tsv(path))

    def text_to_ipa(self, text: str) -> str:
        """Space-joined IPA; digits expand to German cardinals first; words
        that resolve to nothing are skipped (german.rs:72-100)."""
        text = expand_numerals(text)
        out = []
        for token in text.split():
            word = _trim_edge_punctuation(token)
            if not word:
                continue
            ipa = lookup_cascade(self.lexicon, word)
            if ipa is None:
                ipa = decompose(self.lexicon, word)
            if ipa is None:
                ipa = hand_rules_ipa(word)
            if ipa:
                out.append(ipa)
        return " ".join(out)

    # Phonemizer-protocol alias (matches the English engine's entry point)
    def phonemize(self, text: str) -> str:
        return self.text_to_ipa(text)
