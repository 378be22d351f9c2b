"""Hand-written English letter-to-sound rules (OOV fallback tier).

Reference behavior (crane-core src/models/g2p/languages/
english_rules.rs): function-word overrides, suffix/prefix decomposition
with per-stem stress, greedy multi-letter grapheme scan (with dedicated
context rules for ``ough``, ``gh``, ``th``, silent initial ``kn/wr/gn/ps``,
silent final ``-mb`` and magic-e), context-sensitive single vowels
(r-colored, magic-e lengthening, open/closed syllables) and soft ``c``/``g``,
then a primary stress mark before the highest-priority vowel when none is
present.

A copy of ``crane_tpu/text/english_rules.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

IPA_PRIMARY_STRESS = "ˈ"
IPA_SECONDARY_STRESS = "ˌ"

FUNCTION_WORDS = {
    "the": "ðə", "a": "ə", "an": "æn", "to": "tə", "of": "əv", "and": "ænd",
    "or": "ɔɹ", "are": "ɑɹ", "was": "wəz", "were": "wɝ", "from": "fɹʌm",
    "have": "hæv", "has": "hæz", "been": "bɪn", "do": "du", "does": "dʌz",
    "your": "jɔɹ", "you": "ju", "they": "ðeɪ", "their": "ðɛɹ", "there": "ðɛɹ",
}

# longest-first within each cluster; "gh"/"th" resolved by context logic,
# "ough" handled inline before this table
LITERALS = [
    ("tch", "tʃ"), ("dge", "dʒ"), ("ation", "eɪʃən"), ("tion", "ʃən"),
    ("sion", "ʒən"),
    ("sure", "ʒɚ"), ("ture", "tʃɚ"), ("augh", "ɔː"), ("eigh", "eɪ"),
    ("igh", "aɪ"), ("oar", "ɔɹ"), ("our", "aʊɹ"), ("oor", "ɔɹ"),
    ("ear", "ɪɹ"), ("eer", "ɪɹ"), ("ier", "ɪɹ"), ("air", "ɛɹ"),
    ("are", "ɛɹ"), ("ire", "aɪɹ"), ("ure", "jʊɹ"), ("ould", "ʊd"),
    ("ore", "ɔɹ"), ("ook", "ʊk"),
    # CER-measured round-5 contexts (tests/test_g2p_cer.py history):
    # "ose" = GOAT + voiced s (those/chose/close/nose; net win despite
    # purpose-class misses), "alk" silent-l (talk/walk/chalk), "eir" =
    # SQUARE (their/heirs), "all" = THOUGHT-l (all/ball/call/also), "uy"
    # = PRICE (buy/guy)
    ("ose", "oʊz"), ("alk", "ɔːk"), ("eir", "ɛɹ"), ("all", "ɔːl"),
    ("uy", "aɪ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("au", "ɔː"), ("aw", "ɔː"), ("ea", "iː"),
    ("ee", "iː"), ("ei", "eɪ"), ("ey", "eɪ"), ("eu", "juː"), ("ew", "juː"),
    ("ie", "iː"), ("oa", "oʊ"), ("oe", "oʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"),
    ("oo", "uː"), ("ou", "aʊ"), ("ow", "oʊ"), ("ph", "f"), ("gh", ""),
    ("ng", "ŋ"), ("ch", "tʃ"), ("sh", "ʃ"), ("th", "θ"), ("wh", "w"),
    ("qu", "kw"), ("ck", "k"), ("sch", "sk"), ("ss", "s"), ("ll", "l"),
    ("mm", "m"), ("nn", "n"), ("ff", "f"), ("pp", "p"), ("tt", "t"),
    ("zz", "z"), ("rr", "ɹ"), ("dd", "d"), ("bb", "b"), ("gg", "ɡ"),
]

# -tion/-sion/-sure/-ture live in LITERALS, deliberately not here
SUFFIXES = [
    ("ness", "nəs"), ("ment", "mənt"), ("able", "əbəl"), ("ible", "əbəl"),
    ("less", "ləs"), ("ful", "fəl"), ("ous", "əs"), ("ive", "ɪv"),
    ("ly", "li"),
]

# re/mis/pre measured CER-negative in the reference and excluded
PREFIXES = [("un", "ʌn"), ("dis", "dɪs")]

MIN_STEM_LEN = 3

# stress-placement priority by vowel quality (english_rules.rs:177-183)
VOWEL_PREFIXES = [
    "aɪ", "aʊ", "eɪ", "oʊ", "ɔɪ", "juː", "iː", "uː", "ɑː", "ɔː", "ɜː",
    "ɛɹ", "ɑɹ", "ɔɹ", "ɪɹ", "ʊɹ", "aɪɹ", "ɪə", "eə", "ʊə", "iə", "ə",
    "ɪ", "ɛ", "æ", "ʌ", "ʊ", "ɑ", "ɔ", "i", "u", "e", "o", "ɚ", "ɝ", "ɒ",
]

_TH_VOICED = {
    "the", "this", "that", "they", "them", "then", "than", "there", "these",
    "those", "though", "thus", "thence", "thy", "thee", "thou", "thine",
    "with", "within", "without", "theyre", "theirs", "theres",
}

_VOWELS = set("aeiouy")
# ʌ/u/i were missing until round 5 — their absence made
# _contains_vowel_sound treat "hʌm"/"hu" as vowel-less, so the
# silent-final-e rule never fired after a STRUT or GOOSE nucleus
# (home -> hʌmɛ, whose -> husi); CER 0.1771 -> 0.1717 from ʌ alone
_VOWEL_IPA = set("æɛɪɔʊɑɒəɚɝɨʉʌuiː")


def _is_vowel(c: str) -> bool:
    return c in _VOWELS


def _is_consonant(c: str) -> bool:
    return c.isascii() and c.islower() and c.isalpha() and c not in _VOWELS


def _next_vowel_index(w: str, start: int):
    for j in range(start, len(w)):
        if _is_vowel(w[j]):
            return j
    return None


def _last_ipa_unit_is_vowel(ipa: str) -> bool:
    return bool(ipa) and ipa[-1] in _VOWEL_IPA


def _contains_vowel_sound(ipa: str) -> bool:
    return any(c in _VOWEL_IPA for c in ipa)


def _magic_e_lengthens(w: str, vowel_i: int) -> bool:
    """Silent trailing ``e`` lengthening the vowel at ``vowel_i``: exactly
    one consonant between the vowel and the final ``e`` (make vs mac)."""
    n = len(w)
    if vowel_i >= n or not w.endswith("e") or n < vowel_i + 3:
        return False
    j = vowel_i + 1
    if j >= n - 1:
        return False
    second_last = w[n - 2]
    if not _is_consonant(second_last):
        return False
    mid = w[j : n - 1]
    if not mid or any(_is_vowel(c) for c in mid):
        return False
    return len(mid) == 1


_R_COLORED = {"a": "ɑɹ", "e": "ɛɹ", "i": "ɪɹ", "o": "ɔɹ", "u": "ʊɹ", "y": "aɪɹ"}


def _oov_vowel(w: str, i: int):
    """R-colored, then magic-e, then the open/closed syllable heuristic."""
    n = len(w)
    if (
        i + 1 < n and w[i + 1] == "r" and w[i] in _R_COLORED
        # r-coloring needs the r to close the syllable: an intervocalic or
        # doubled r starts the NEXT syllable and the vowel stays plain
        # (carry = kæri, not kɑɹi)
        and not (i + 2 < n and (w[i + 2] == "r" or _is_vowel(w[i + 2])))
    ):
        return _R_COLORED[w[i]], 2
    # word-final y in a polysyllable is the unstressed close vowel (easy =
    # izi, not izaɪ); monosyllables (my, fly) keep aɪ via the open-syllable
    # branch below. (This + the r guard: lexicon-holdout CER
    # 0.2405 -> 0.2253, crane_tpu/text/cer.py)
    if (
        w[i] == "y" and i == n - 1
        and any(_is_vowel(c) for c in w[:i])
    ):
        return "i", 1
    magic = _magic_e_lengthens(w, i)
    nv = _next_vowel_index(w, i + 1)
    if nv is not None:
        between = w[i + 1 : nv]
        closed = bool(between) and not any(_is_vowel(c) for c in between)
    else:
        closed = i + 1 < len(w) and not _is_vowel(w[i + 1])
    c = w[i]
    if c == "o" and i + 1 < n:
        # o before nasals/v is the STRUT vowel even in magic-e words (come,
        # money, month, love, done) — but not before ng (long, song)
        nxt = w[i + 1]
        if nxt in "mv" or (nxt == "n" and not w.startswith("ng", i + 1)):
            if closed or magic:
                return "ʌ", 1
        # o before a voiceless fricative cluster is the THOUGHT vowel
        # (often, office, off, cost, across)
        if nxt in "fs" and closed:
            return "ɔː", 1
    if c == "a":
        return ("eɪ" if magic else "æ" if closed else "ɑː"), 1
    if c == "e":
        if magic:
            return "iː", 1
        if i == len(w) - 1:
            # a PRONOUNCED word-final e is the FLEECE vowel (he, she, be,
            # we, me — this branch is only reached when the silent-final-e
            # rule declined because no earlier vowel sound exists)
            return "iː", 1
        return ("ɛ" if closed else "iː"), 1
    if c in "iy":
        return ("aɪ" if magic else "ɪ" if closed else "aɪ"), 1
    if c == "o":
        return ("oʊ" if magic else "ɒ" if closed else "oʊ"), 1
    if c == "u":
        return ("juː" if magic else "ʌ" if closed else "uː"), 1
    return "ə", 1


def _is_silent_final_mb(w: str, i: int) -> bool:
    """Silent ``b`` in word-final ``-mb`` (or before -s/-ed/-ing/-ness);
    -er/-le style suffixes and mid-word mb sound both consonants."""
    if i + 1 >= len(w) or w[i] != "m" or w[i + 1] != "b":
        return False
    return w[i + 2 :] in ("", "s", "ed", "ing", "ness")


_CONSONANT_IPA = {
    "j": "dʒ", "x": "ks", "r": "ɹ", "h": "h", "b": "b", "d": "d", "f": "f",
    "l": "l", "m": "m", "n": "n", "p": "p", "s": "s", "t": "t", "v": "v",
    "w": "w", "z": "z",
}


def _push_single_consonant(out: list, w: str, i: int):
    nxt = w[i + 1] if i + 1 < len(w) else ""
    soft = nxt in ("e", "i", "y")
    c = w[i]
    if c == "c":
        out.append("s" if soft else "k")
    elif c == "g":
        out.append("dʒ" if soft else "ɡ")
    elif c in ("q", "k"):
        out.append("k")
    else:
        out.append(_CONSONANT_IPA.get(c, ""))


def _strip_suffix(letters: str):
    for suffix, ipa in SUFFIXES:
        if len(letters) >= len(suffix) + MIN_STEM_LEN and letters.endswith(suffix):
            stem = letters[: -len(suffix)]
            if any(_is_vowel(c) for c in stem):  # every syllable needs a nucleus
                return stem, ipa
    return None


def _strip_prefix(letters: str):
    for prefix, ipa in PREFIXES:
        if len(letters) >= len(prefix) + MIN_STEM_LEN and letters.startswith(prefix):
            stem = letters[len(prefix) :]
            # consonant guard: rejects "unit"/"ready"-style coincidences
            if stem and _is_consonant(stem[0]):
                return ipa, stem
    return None


def _oov_grapheme_to_ipa(word: str) -> str:
    letters = "".join(c for c in word if c.isascii() and c.islower() and c.isalpha())
    if not letters:
        return ""
    if letters in FUNCTION_WORDS:
        return FUNCTION_WORDS[letters]

    # suffix then prefix decomposition, stem stressed before re-joining so
    # the final stress pass can't land inside the affix
    hit = _strip_suffix(letters)
    if hit is not None:
        stem, suffix_ipa = hit
        return add_primary_stress_if_missing(_oov_grapheme_to_ipa(stem)) + suffix_ipa
    hit = _strip_prefix(letters)
    if hit is not None:
        prefix_ipa, stem = hit
        return prefix_ipa + add_primary_stress_if_missing(_oov_grapheme_to_ipa(stem))

    voiced_th = letters in _TH_VOICED
    w = letters
    n = len(w)
    out: list = []
    i = 0
    while i < n:
        # silent initial kn-/gn-/wr-/ps- (word start only)
        if i == 0 and n >= 2 and (
            (w[0] in "kg" and w[1] == "n") or w[:2] in ("wr", "ps")
        ):
            i += 1
            continue
        # initial y before a vowel is the glide (young = jʌŋ, not a vowel
        # cluster)
        if i == 0 and w[0] == "y" and n >= 2 and _is_vowel(w[1]):
            out.append("j")
            i += 1
            continue
        # wh before o: the w is silent and the h sounds (who, whose,
        # whole); the pronoun stems themselves (who/whose/whom) take the
        # GOOSE vowel while whole/wholly keep the o for the magic-e path
        if w.startswith("who", i):
            if w[i + 3 :] in ("", "se", "m"):
                out.append("hu")
                i += 3
            else:
                out.append("h")
                i += 2
            continue
        # ew/eu after a coronal is the plain long u (new = nu, not nju)
        if w.startswith("ew", i) or w.startswith("eu", i):
            prev = w[i - 1] if i > 0 else ""
            out.append("uː" if prev in "nlrstdzj" else "juː")
            i += 2
            continue
        # -cial/-tial = ʃəl (social, special, partial)
        if w.startswith("cial", i) or w.startswith("tial", i):
            out.append("ʃəl")
            i += 4
            continue
        # intervocalic th before -er is voiced (mother, weather, together)
        if w.startswith("ther", i) and i > 0 and _is_vowel(w[i - 1]):
            out.append("ð")
            i += 2
            continue
        # word-initial unstressed a + single consonant + vowel (about,
        # again, along, away) reduces to schwa; clusters (after, angry)
        # and aCC patterns keep the full vowel, and so does the aCe
        # magic-e monosyllable (ate, age, ace) where the "vowel" at w[2]
        # is the silent final e
        if (
            i == 0 and w[0] == "a" and n >= 3
            and _is_consonant(w[1]) and _is_vowel(w[2])
            and not (n == 3 and w[2] == "e")
        ):
            out.append("ə")
            i += 1
            continue
        # word-final -nge is n + soft g (change, range, strange) — the plain
        # ng -> ŋ literal would swallow the affricate
        if w.startswith("nge", i) and i + 3 == n:
            out.append("ndʒ")
            i += 3
            continue
        # word-final unstressed -er after a consonant is the schwar
        # (teacher, number, water; beer/pier keep their literals via the
        # vowel guard)
        if w.startswith("er", i) and i + 2 == n and i > 0 and _is_consonant(w[i - 1]):
            out.append("ɚ")
            i += 2
            continue
        # word-final unstressed -le after a consonant is the syllabic l
        # (able, little, people) — CER-measured round 5
        if (
            w.startswith("le", i) and i + 2 == n and i > 0
            and _is_consonant(w[i - 1])
            and _contains_vowel_sound("".join(out))
        ):
            out.append("əl")
            i += 2
            continue
        # word-final unstressed -en after a consonant reduces (open,
        # seven, garden) — CER-measured round 5
        if (
            w.startswith("en", i) and i + 2 == n and i > 0
            and _is_consonant(w[i - 1])
            and _contains_vowel_sound("".join(out))
        ):
            out.append("ən")
            i += 2
            continue
        # word-initial u in an open syllable is the glide vowel (use, unit,
        # usually)
        if (
            i == 0 and w[0] == "u" and n >= 3
            and _is_consonant(w[1]) and _is_vowel(w[2])
        ):
            out.append("juː")
            i += 1
            continue
        # word-final single s after a voiced letter sound is the voiced
        # sibilant (plural/3sg morphology: says, theirs, wins, dogs)
        if (
            w[i] == "s" and i == n - 1 and i > 0
            and w[i - 1] in "bdgvlmnrwyz" + "aeiou"
            and w[i - 1] != "s"
        ):
            out.append("z")
            i += 1
            continue
        if _is_silent_final_mb(w, i):
            out.append("m")
            i += 2
            continue
        # silent final e, but never the word's only vowel (he/be/she)
        if w[i] == "e" and i == n - 1 and _contains_vowel_sound("".join(out)):
            i += 1
            continue
        # context-sensitive "ough" (not in LITERALS)
        if w.startswith("ough", i):
            if i + 4 < n and w[i + 4] == "t":
                out.append("aʊt" if w[max(0, i - 2) : i] == "dr" else "ɔːt")
                i += 5
            else:
                # through/throughout take GOOSE; other bare -ough stay GOAT
                prev = w[i - 1] if i > 0 else ""
                out.append("uː" if prev == "r" else "oʊ")
                i += 4
            continue
        matched = False
        for grapheme, ipa in LITERALS:
            if not w.startswith(grapheme, i):
                continue
            if grapheme == "gh":
                if not _last_ipa_unit_is_vowel("".join(out)):
                    out.append("ɡ")
            elif grapheme == "th":
                out.append("ð" if voiced_th else "θ")
            else:
                out.append(ipa)
            i += len(grapheme)
            matched = True
            break
        if matched:
            continue
        if _is_vowel(w[i]):
            ipa, consumed = _oov_vowel(w, i)
            out.append(ipa)
            i += consumed
        elif _is_consonant(w[i]):
            _push_single_consonant(out, w, i)
            i += 1
        else:
            i += 1
    return "".join(out)


def _vowel_nucleus_positions(ipa: str) -> list[int]:
    """Start indices of vowel nuclei, greedy longest-first scan."""
    by_len = sorted(VOWEL_PREFIXES, key=len, reverse=True)
    out, i = [], 0
    while i < len(ipa):
        for v in by_len:
            if ipa.startswith(v, i):
                out.append(i)
                i += len(v)
                break
        else:
            i += 1
    return out


def add_primary_stress_if_missing(ipa: str) -> str:
    """Insert the primary stress mark before the highest-priority vowel,
    unless any stress mark is already present; long words with two or more
    nuclei before the primary also get initial secondary stress
    (infor-MA-tion -> ˌɪnfəɹˈmeɪʃən — reference english_rules.rs places
    secondary stress the same way)."""
    if not ipa or IPA_PRIMARY_STRESS in ipa or IPA_SECONDARY_STRESS in ipa:
        return ipa
    for prefix in VOWEL_PREFIXES:
        pos = ipa.find(prefix)
        if pos >= 0:
            marked = ipa[:pos] + IPA_PRIMARY_STRESS + ipa[pos:]
            nuclei = _vowel_nucleus_positions(ipa)
            before = [p for p in nuclei if p < pos]
            # only genuinely long derivations carry audible secondary
            # stress; short words with a late primary do not
            if len(before) >= 2 and len(nuclei) >= 4:
                first = before[0]
                marked = (
                    marked[:first] + IPA_SECONDARY_STRESS + marked[first:]
                )
            return marked
    return IPA_PRIMARY_STRESS + ipa


def hand_oov_rules_ipa(word: str) -> str:
    """OOV English word -> approximate IPA (the final fallback tier)."""
    return add_primary_stress_if_missing(_oov_grapheme_to_ipa(word.lower()))
