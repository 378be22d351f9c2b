"""Kokoro TTS of crane_tpu_torch against crane_tpu (CPU, float32).

- the pipeline copied as it is: IPA normalization, 510-codepoint chunking,
  style rows, vocab and voice files, ``phonemes_to_ids``, give crane_tpu's
  results on the same inputs;
- the native net, crane_tpu's ``init_kokoro_net`` weights carried across by
  ``utils/bridge.py`` ``kokoro_params_from_jax`` (the 1-D convs WIO there,
  PyTorch's here): ``_gru_scan`` both ways (crane_tpu's own gate formula,
  not ``nn.GRU``'s), ``_ada_in`` (the population std), ``_conv1d``,
  ``encode_text``, ``synthesize_frames`` within 2e-4; the durations equal
  (where a value lies within 1e-4 of a rounding boundary either count is
  taken: the tie rule), and the waveform of ``KokoroSynthesizer`` over them;
- ``KokoroTts.generate_speech`` across two 510-codepoint chunks and through
  the copied ``text/g2p.Phonemizer``, equal to crane_tpu's; the SDK adapter;
- the port's own default draw (a seeded ``torch.Generator``) at crane_tpu's
  scales.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_tpu.models import kokoro_tts as jk
from crane_tpu_torch.models import kokoro_tts as tk
from crane_tpu_torch.utils.bridge import kokoro_params_from_jax
from tests.test_kokoro import VOCAB

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 1e-5
# a waveform (tanh of O(1) values, 40 samples a frame through three AdaIN
# blocks): 2e-4 relative, and 1e-4 absolute for the samples near zero
WAVE_ATOL = 1e-4
TIE = 1e-4  # a duration value this close to a .5 boundary may round either way


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    cfg = jk.KokoroNetConfig(vocab_size=len(VOCAB) + 4, dim=16, hop=40, max_duration=8)
    jparams = jk.init_kokoro_net(cfg, seed=0)
    tcfg = tk.KokoroNetConfig(vocab_size=cfg.vocab_size, dim=16, hop=40, max_duration=8)
    return cfg, jparams, tcfg, kokoro_params_from_jax(jparams, device="cpu")


# -- the pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("language", ["en_us", "de"])
def test_normalizer(language):
    for ipa in ("haʊ eɪ aɪ ɔɪ oʊ əʊ", "t͡ʃiz tʃiz d͡ʒʌmp", "bɝd fɚ", "abéc", ""):
        assert tk.KokoroIpaNormalizer(language, VOCAB).normalize(ipa) == \
            jk.KokoroIpaNormalizer(language, VOCAB).normalize(ipa)


def test_chunks_rows_and_files(tmp_path):
    texts = ["  hello world  ", "aaa bbb ccc", "abcdefghij", "   ", " ".join(["syllable"] * 200),
             " ".join(["hOm"] * 300)]
    for text in texts:
        for max_cp in (4, 7, 50, 510):
            assert tk.chunk_phonemes(text, max_cp) == jk.chunk_phonemes(text, max_cp)
    for n in (0, 1, 12, 9999):
        assert tk.style_row_index(n, 510) == jk.style_row_index(n, 510)
    (tmp_path / "tokenizer.json").write_text(json.dumps({"model": {"vocab": VOCAB}}))
    assert tk.parse_vocab(str(tmp_path / "tokenizer.json")) == VOCAB
    np.arange(3 * tk.STYLE_DIM, dtype="<f4").tofile(tmp_path / "v.bin")
    np.testing.assert_array_equal(tk.load_voice_bin(str(tmp_path / "v.bin")),
                                  jk.load_voice_bin(str(tmp_path / "v.bin")))
    np.zeros(tk.STYLE_DIM + 1, dtype="<f4").tofile(tmp_path / "bad.bin")
    with pytest.raises(ValueError):
        tk.load_voice_bin(str(tmp_path / "bad.bin"))


# -- the net ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan(nets, reverse):
    _, jparams, _, params = nets
    x = rnd(1, 11, 16)
    close(tk._gru_scan(params["encoder"]["gru_f"], torch.from_numpy(x), reverse=reverse),
          jk._gru_scan(jparams["encoder"]["gru_f"], jnp.asarray(x), reverse=reverse))


def test_ada_in_and_conv(nets):
    _, jparams, _, params = nets
    x, style = rnd(2, 9, 16, scale=2.0), rnd(3, tk.STYLE_DIM)
    close(tk._ada_in(torch.from_numpy(x), torch.from_numpy(style), params["duration"]["ada"]),
          jk._ada_in(jnp.asarray(x), jnp.asarray(style), jparams["duration"]["ada"]))
    res, jres = params["decoder"]["res"][0], jparams["decoder"]["res"][0]
    for (w, b), (jw, jb) in (
            ((params["encoder"]["convs"][0]["w"], params["encoder"]["convs"][0]["b"]),
             (jparams["encoder"]["convs"][0]["w"], jparams["encoder"]["convs"][0]["b"])),
            ((res["w1"], res["b1"]), (jres["w1"], jres["b1"]))):
        close(tk._conv1d(torch.from_numpy(x), w, b), jk._conv1d(jnp.asarray(x), jw, jb))


def durations_tied(got, ref, values) -> None:
    """Equal durations, or a difference only where the value lies within TIE
    of a .5 boundary (and the counts are its two neighbours)."""
    got, ref, values = np.asarray(got), np.asarray(ref), np.asarray(values)
    for i in np.flatnonzero(got != ref):
        assert abs(got[i] - ref[i]) == 1 and abs(values[i] % 1 - 0.5) < TIE, (i, values[i])


@pytest.mark.parametrize("speed", [1.0, 0.5, 2.0])
def test_encoder_durations_and_waveform(nets, speed):
    cfg, jparams, tcfg, params = nets
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, 23)
    style = rnd(5, tk.STYLE_DIM)
    jfeats = jk.encode_text(jparams["encoder"], jnp.asarray(ids))
    feats = tk.encode_text(params["encoder"], torch.from_numpy(ids))
    close(feats, jfeats)
    ref = np.asarray(jk.predict_durations(jparams["duration"], jfeats, jnp.asarray(style), speed,
                                          cfg.max_duration))
    got = tk.predict_durations(params["duration"], feats, torch.from_numpy(style), speed,
                               tcfg.max_duration)
    values = tk.duration_values(params["duration"], feats, torch.from_numpy(style), speed)
    durations_tied(got, ref, values)
    assert got.dtype == torch.int32 and (got >= 1).all() and (got <= tcfg.max_duration).all()
    frames = np.repeat(np.asarray(jfeats), ref, axis=0)
    close(tk.synthesize_frames(params["decoder"], torch.from_numpy(frames),
                               torch.from_numpy(style), tcfg.hop),
          jk.synthesize_frames(jparams["decoder"], jnp.asarray(frames), jnp.asarray(style),
                               cfg.hop))
    synth, jsynth = tk.KokoroSynthesizer(tcfg, params), jk.KokoroSynthesizer(cfg, jparams)
    if np.array_equal(got.numpy(), ref):
        close(synth(ids, style, speed), jsynth(ids, style, speed), atol=WAVE_ATOL)


def test_round_half_to_even():
    """Durations round as jnp.round does: half to even."""
    v = torch.tensor([0.5, 1.5, 2.5, 3.5, 2.4999, 2.5001])
    np.testing.assert_array_equal(torch.round(v).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v.numpy()))))


def test_generate_speech_across_chunks(nets):
    """A phoneme string over 510 codepoints splits in two chunks, each with
    the style row of its length; crane_tpu's waveform, and the SDK adapter's."""
    from crane_tpu.sdk.audio import KokoroTts as JAdapter
    from crane_tpu_torch.generation.config import SpeechOptions
    from crane_tpu_torch.sdk.audio import KokoroTts as TAdapter

    cfg, jparams, tcfg, params = nets
    voices = {"af_heart": rnd(6, 510, tk.STYLE_DIM), "bm_alt": rnd(7, 510, tk.STYLE_DIM)}
    jt = jk.KokoroTts(VOCAB, voices, jk.KokoroSynthesizer(cfg, jparams))
    tt = tk.KokoroTts(VOCAB, voices, tk.KokoroSynthesizer(tcfg, params))
    phonemes = " ".join(["hOm", "bɜɹd", "wɜɹld"] * 50)
    assert len(tk.chunk_phonemes(phonemes)) == 2
    for voice in ("af_heart", "bm_alt"):
        got, sr = tt.generate_speech(phonemes, voice=voice)
        ref, _ = jt.generate_speech(phonemes, voice=voice)
        assert sr == 24_000 and got.shape == ref.shape
        close(got, ref, atol=WAVE_ATOL)
    adapter = TAdapter(tt)
    assert [(v.name, v.languages) for v in adapter.voices()] == \
        [(v.name, v.languages) for v in JAdapter(jt).voices()] == [("af_heart", ["en"]),
                                                                  ("bm_alt", ["en"])]
    close(adapter.generate_speech("hO wɜɹld", SpeechOptions(voice="bm_alt")),
          jt.generate_speech("hO wɜɹld", voice="bm_alt")[0], atol=WAVE_ATOL)
    with pytest.raises(KeyError):
        tt.generate_speech("hO", voice="nope")
    with pytest.raises(ValueError):
        tt.generate_speech("éé")


def test_generate_speech_through_the_phonemizer(nets):
    from crane_tpu.text.g2p import Phonemizer as JPhonemizer
    from crane_tpu_torch.text.g2p import Phonemizer

    cfg, jparams, tcfg, params = nets
    voices = {"af_heart": rnd(8, 510, tk.STYLE_DIM)}
    text = "Hello world, the quick brown fox jumps over the lazy dog."
    jt = jk.KokoroTts(VOCAB, voices, jk.KokoroSynthesizer(cfg, jparams), phonemizer=JPhonemizer())
    tt = tk.KokoroTts(VOCAB, voices, tk.KokoroSynthesizer(tcfg, params), phonemizer=Phonemizer())
    assert Phonemizer().phonemize(text) == JPhonemizer().phonemize(text)
    close(tt.generate_speech(text)[0], jt.generate_speech(text)[0], atol=WAVE_ATOL)


def test_default_draw_scales():
    cfg = tk.KokoroNetConfig()
    a = tk.init_kokoro_net(cfg, seed=1, device="cpu")
    b = tk.init_kokoro_net(cfg, seed=1, device="cpu")
    assert torch.equal(a["encoder"]["convs"][0]["w"], b["encoder"]["convs"][0]["w"])
    w = a["encoder"]["convs"][0]["w"]
    assert w.shape == (128, 128, 5) and abs(w.std().item() - (5 * 128) ** -0.5) < 2e-3
    assert abs(a["encoder"]["embed"].std().item() - 0.02) < 1e-3
    assert a["duration"]["w1"].shape == (128, 128, 3)
    assert abs(a["decoder"]["head_w"].std().item() - 128 ** -0.5) < 2e-3
    wav = tk.KokoroSynthesizer(cfg, a)(np.arange(10), rnd(9, tk.STYLE_DIM), 1.0)
    assert wav.shape[0] % cfg.hop == 0 and np.isfinite(wav).all() and np.abs(wav).max() <= 1
