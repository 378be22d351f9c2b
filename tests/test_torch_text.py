"""The port's copies of the G2P modules (``text/``) and the Tekken tokenizer
against crane_tpu's, on the same inputs (CPU).

The copies import nothing of crane_tpu: ``text/oov.py`` runs its graph
through the port's copy of ``onnx/``, and ``tokenizer/tekken.py`` imports
``regex`` at first use. Each function here gives crane_tpu's output.
"""

import numpy as np
import pytest

from crane_tpu.text import cer as jcer
from crane_tpu.text import english_rules as jrules
from crane_tpu.text import g2p as jg2p
from crane_tpu.text import german as jgerman
from crane_tpu.text import ipa_postprocess as jipa
from crane_tpu.text import lexicon as jlex
from crane_tpu.text import oov as joov
from crane_tpu.tokenizer.tekken import Tekkenizer as JTekkenizer
from crane_tpu_torch.text import cer, english_rules, g2p, german, ipa_postprocess, lexicon, oov
from crane_tpu_torch.tokenizer.tekken import Tekkenizer
from tests.test_g2p import _tiny_oov_dir
from tests.test_tekken import _tekken_file

ENGLISH = ["Hello world, this is 2024.", "On May 3rd I paid $12.50 for 1.5 kg of apples.",
           "Dr. Smith's cat jumped over the lazy zorbtrag!", "the 21st century",
           "Mr. Jones read 1,234 books in 1999 and 2005", "   spaced    out   text   "]
GERMAN = ["Guten Morgen, wie geht es dir?", "Die Straßenbahnhaltestelle ist 23 Meter weit.",
          "Ich habe 1998 über 101 Bücher gelesen.", "Eichhörnchen fressen Nüsse"]
WORDS = ["cat", "through", "nation", "pleasure", "knight", "zorbtrag", "bouquet", "rhythm",
         "photograph", "mystify", "cheese", "who", "would", "ocean"]


def test_english_phonemizer_and_normalization():
    for text in ENGLISH:
        assert g2p.normalize_text(text) == jg2p.normalize_text(text)
        assert g2p.Phonemizer().phonemize(text) == jg2p.Phonemizer().phonemize(text)
    for n in (0, 7, 13, 21, 100, 1001, 123456):
        assert g2p.number_to_words(n) == jg2p.number_to_words(n)
        assert g2p.ordinal_to_words(n) == jg2p.ordinal_to_words(n)
    for y in (1905, 1999, 2000, 2024):
        assert g2p.year_to_words(y) == jg2p.year_to_words(y)
    for w in WORDS:
        assert g2p.letter_to_sound(w) == jg2p.letter_to_sound(w)
        assert english_rules.hand_oov_rules_ipa(w) == jrules.hand_oov_rules_ipa(w)
    lexicon_override = {"hello": "XYZ"}
    assert g2p.Phonemizer(lexicon=lexicon_override).phonemize("hello there") == \
        jg2p.Phonemizer(lexicon=lexicon_override).phonemize("hello there")


@pytest.mark.parametrize("language", ["en_us", "en_gb", "de", "de_de"])
def test_multilingual_phonemizer(language):
    texts = GERMAN if language.startswith("de") else ENGLISH
    got, ref = g2p.MultilingualPhonemizer(), jg2p.MultilingualPhonemizer()
    for text in texts:
        assert got.text_to_ipa(text, language) == ref.text_to_ipa(text, language)


def test_german_pieces():
    for n in (0, 1, 17, 21, 99, 101, 1000, 1998, 2024, 1000001):
        assert german.german_cardinal(n) == jgerman.german_cardinal(n)
    lex = "Haltestelle\thaltəʃtɛlə\nStraße\tʃtʁaːsə\nBahn\tbaːn\n"
    for text in GERMAN:
        assert german.expand_numerals(text) == jgerman.expand_numerals(text)
        for tsv in ("", lex):
            assert german.GermanG2p(tsv).phonemize(text) == jgerman.GermanG2p(tsv).phonemize(text)
    for w in ("Straße", "Mädchen", "ich", "König", "Bach", "Verantwortung"):
        assert german.hand_rules_ipa(w) == jgerman.hand_rules_ipa(w)


def test_lexicon_ipa_postprocess_and_cer(tmp_path):
    p = tmp_path / "lex.tsv"
    p.write_text("# comment\nread\tɹid\nread\tɹɛd\nhello\thəˈloʊ\n")
    lex, jl = lexicon.Lexicon.from_tsv(str(p)), jlex.Lexicon.from_tsv(str(p))
    assert len(lex) == len(jl) == 2
    assert lex.get_all("read") == jl.get_all("read") and lex.get("hello") == jl.get("hello")
    (tmp_path / "bad.tsv").write_text("word-without-tab\n")
    with pytest.raises(ValueError):
        lexicon.Lexicon.from_tsv(str(tmp_path / "bad.tsv"))
    rules = [("eɪ", "A"), ("e", "i"), ("A", "a")]
    vocab = set("abɹiʧAðeɪ $")
    for ipa in ("eɪ", "e", "  a   x b  ", "ðeɪ ɹeɪ"):
        assert ipa_postprocess.IpaNormalizer(rules, vocab).normalize(ipa) == \
            jipa.IpaNormalizer(rules, vocab).normalize(ipa)
    assert ipa_postprocess.IpaNormalizer([], set("abc"), coerce_pool=set("ac")).normalize("bd") \
        == jipa.IpaNormalizer([], set("abc"), coerce_pool=set("ac")).normalize("bd")
    for a, b in (("", ""), ("abc", "axc"), ("kitten", "sitting")):
        assert cer.edit_distance(a, b) == jcer.edit_distance(a, b)
        assert cer.cer(a, b + "x") == jcer.cer(a, b + "x")
    assert cer.canonical("ˈhɛˌloʊ") == jcer.canonical("ˈhɛˌloʊ")
    mean, rows = cer.lts_cer()
    jmean, jrows = jcer.lts_cer()
    assert mean == jmean and rows == jrows


def test_oov_model_through_the_copied_evaluator(tmp_path):
    d = _tiny_oov_dir(tmp_path)
    m, jm = oov.OovModel.from_dir(d), joov.OovModel.from_dir(d)
    for word in ("cat", "rat", "bake", "zq"):
        assert m.predict_phonemes(word) == jm.predict_phonemes(word)
        assert m.predict_phonemes_beam(word, beam_width=3) == \
            jm.predict_phonemes_beam(word, beam_width=3)
    lex = tmp_path / "lex.tsv"
    lex.write_text("zyxqj\tZZZ\n")
    p = g2p.Phonemizer.from_assets(lexicon_tsv=str(lex), oov_dir=d)
    jp = jg2p.Phonemizer.from_assets(lexicon_tsv=str(lex), oov_dir=d)
    for text in ("zyxqj hello qqqqz", "cat in a hat"):
        assert p.phonemize(text) == jp.phonemize(text)


def test_tekkenizer(tmp_path):
    path = _tekken_file(tmp_path, [b"he", b"ll", b"llo", b"hello", b" hello", b"lo", b"wor"],
                        extra_vocab=3)
    tok, jtok = Tekkenizer.from_file(path), JTekkenizer.from_file(path)
    for text in ("hello", "hello world", " hello hello\n", "\x01\x02", "héllo ünïcode 123 !!",
                 ""):
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert tok.decode(ids) == jtok.decode(ids)
    assert (tok.bos_id, tok.eos_id, tok.vocab_size) == (jtok.bos_id, jtok.eos_id, jtok.vocab_size)
    assert tok.token_to_id("[INST]") == jtok.token_to_id("[INST]")
    assert np.array_equal(tok.encode("hello"), [8 + 256 + 3])
