"""The port's log-mel frontend (``crane_tpu_torch/audio/mel.py``) and the
ASR half of its audio SDK against crane_tpu (CPU, float32).

- the Slaney filterbank and the Hann window byte-equal to crane_tpu's;
- ``log_mel_spectrogram`` in its three modes ("whisper" power/log10 with
  the dynamic-range clamp; "ln"; "ln" over the magnitude spectrum with the
  "stft" center pad, the TTS speaker encoder's frontend) on the same seeded
  waveforms, within 1e-4 relative tolerance; signals shorter than the
  reflect pad, which JAX reflects again;
- the SDK adapters hand the options through as crane_tpu's do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.audio import mel as jmel
from crane_tpu_torch.audio import mel as tmel

torch.set_num_threads(2)

MODES = {
    "whisper": dict(n_mels=128),
    "ln": dict(n_mels=80, log_mode="ln"),
    "ln magnitude stft-pad": dict(n_mels=80, log_mode="ln", spectrum="magnitude",
                                  center_pad="stft", n_fft=1024, hop_length=256,
                                  sampling_rate=24000, fmax=12000.0),
}


def wave(seed: int, n: int) -> np.ndarray:
    """A few tones plus noise, made from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 220.0), (0.2, 1330.0), (0.1, 3100.0)))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("mode", list(MODES))
def test_filterbank_and_window_byte_equal(mode):
    jc, tc = jmel.MelConfig(**MODES[mode]), tmel.MelConfig(**MODES[mode])
    assert tc.filters.tobytes() == jc.filters.tobytes()
    assert tc.window.tobytes() == jc.window.tobytes()
    assert tmel.mel_filter_bank(201, 128, 0.0, 8000.0, 16000).tobytes() == \
        jmel.mel_filter_bank(201, 128, 0.0, 8000.0, 16000).tobytes()


@pytest.mark.parametrize("n", [16000, 24321, 8000])
@pytest.mark.parametrize("mode", list(MODES))
def test_log_mel_matches_crane_tpu(mode, n):
    x = wave(n, n)
    jc, tc = jmel.MelConfig(**MODES[mode]), tmel.MelConfig(**MODES[mode])
    ref = np.asarray(jmel.log_mel_spectrogram(jc, jnp.asarray(x)))
    got = tmel.log_mel_spectrogram(tc, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 150, 401])
def test_reflect_pad_longer_than_the_signal(n):
    """jnp.pad reflects again where the pad passes the signal's end (a
    clip shorter than n_fft / 2); the port's gather does the same."""
    np.testing.assert_array_equal(tmel.reflect_index(n, 200),
                                  np.pad(np.arange(n), (200, 200), mode="reflect"))
    x = wave(n, n)
    cfg = dict(n_mels=80, log_mode="ln")
    ref = np.asarray(jmel.log_mel_spectrogram(jmel.MelConfig(**cfg), jnp.asarray(x)))
    got = tmel.log_mel_spectrogram(tmel.MelConfig(**cfg), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_asr_adapters_pass_the_options_through():
    from crane_tpu.generation.config import TranscribeOptions as JOpts
    from crane_tpu.sdk import audio as jsdk
    from crane_tpu_torch.generation.config import TranscribeOptions
    from crane_tpu_torch.sdk import audio as tsdk

    class Model:
        tokenizer = None

        def __init__(self):
            self.seen = []

        def transcribe(self, wav, **kw):
            self.seen.append(kw)
            return "text"

        def transcribe_ids(self, wav, opts):
            self.seen.append(opts.max_new_tokens)
            return [4, 5]

    wav = np.zeros(16000, np.float32)
    for sdk, opts in ((jsdk, JOpts(context="ctx", max_new_tokens=7)),
                      (tsdk, TranscribeOptions(context="ctx", max_new_tokens=7))):
        m = Model()
        q = sdk.Qwen3AsrAdapter(m)
        assert q.transcribe(wav, opts) == sdk.Transcript(text="text", tokens=[])
        assert m.seen == [{"context": "ctx", "max_new_tokens": 7}]
        assert q.input_sample_rate() == 16000
        assert list(next(q.transcribe_stream(wav, opts)).text) == list("text")
        ms = sdk.MoonshineAsr(m)
        assert ms.transcribe(wav, opts) == sdk.Transcript(text="", tokens=[4, 5])
        assert ms.supported_languages() == []
    assert tsdk.QWEN3_ASR_LANGUAGES == jsdk.QWEN3_ASR_LANGUAGES
    assert tsdk.Qwen3AsrAdapter(None).supported_languages() == list(jsdk.QWEN3_ASR_LANGUAGES)
