"""CER (character error rate) harness for the letter-to-sound rules.

The reference selected its English LTS rules by measuring CER against a
pronunciation lexicon and keeping only rules that lowered it (e.g. the
re/mis/pre prefixes "measured CER-negative and excluded",
english_rules.rs — cited in crane_tpu/text/english_rules.py:50). This module
is that measurement: predict every lexicon word with the hand rules and
report the mean character error rate against the lexicon IPA. Rule changes
land only with a before/after CER (tests/test_g2p_cer.py pins the bound).

A copy of ``crane_tpu/text/cer.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

IPA_STRESS = "ˈˌ"


def edit_distance(a: str, b: str) -> int:
    """Plain Levenshtein over unicode codepoints."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def cer(pred: str, gold: str) -> float:
    return edit_distance(pred, gold) / max(len(gold), 1)


def strip_stress(ipa: str) -> str:
    return "".join(c for c in ipa if c not in IPA_STRESS)


# transcription-convention canonicalization: tie-bar-less affricate
# ligatures, length marks and glyph variants differ between lexica without
# any pronunciation difference — CER must not count them as errors
_CANON = [("tʃ", "ʧ"), ("dʒ", "ʤ"), ("ː", ""), ("ɡ", "g"), ("ɒ", "ɑ"),
          ("ɝ", "ɚ"), ("ɚ", "əɹ")]


def canonical(ipa: str) -> str:
    for a, b in _CANON:
        ipa = ipa.replace(a, b)
    return ipa


def lts_cer(
    lexicon: dict[str, str] | None = None,
    *,
    with_stress: bool = False,
    exclude: frozenset[str] | None = None,
) -> tuple[float, list[tuple[str, str, str, float]]]:
    """Mean CER of :func:`hand_oov_rules_ipa` over ``lexicon`` (default: the
    built-in seed lexicon), treating every entry as an unseen word.

    ``exclude`` defaults to the rules' own FUNCTION_WORDS table — those are
    memorized verbatim, so scoring them would measure table lookup, not
    letter-to-sound generalization. Returns (mean_cer, rows) with rows =
    (word, predicted, gold, cer) sorted worst-first for error analysis.
    """
    from crane_tpu_torch.text.english_rules import FUNCTION_WORDS, hand_oov_rules_ipa

    if lexicon is None:
        from crane_tpu_torch.text.seed_lexicon import SEED_LEXICON

        lexicon = SEED_LEXICON
    if exclude is None:
        exclude = frozenset(FUNCTION_WORDS)

    rows = []
    for word, gold in lexicon.items():
        if word in exclude or not word.isalpha() or not word.isascii():
            continue
        pred = canonical(hand_oov_rules_ipa(word))
        gold_c = canonical(gold)
        if not with_stress:
            pred, gold_c = strip_stress(pred), strip_stress(gold_c)
        rows.append((word, pred, gold_c, cer(pred, gold_c)))
    rows.sort(key=lambda r: -r[3])
    mean = sum(r[3] for r in rows) / max(len(rows), 1)
    return mean, rows


if __name__ == "__main__":  # error-analysis CLI: python -m crane_tpu_torch.text.cer
    mean, rows = lts_cer()
    print(f"LTS CER over {len(rows)} held-out lexicon words: {mean:.4f}")
    print("worst 30:")
    for word, pred, gold, c in rows[:30]:
        print(f"  {word:16s} pred={pred:18s} gold={gold:18s} cer={c:.2f}")
