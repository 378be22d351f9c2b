"""The native VAD net and the streaming state machine of crane_tpu_torch
against crane_tpu (CPU, float32).

- ``VadModel`` (an ``nn.Module``: rfft features, three-tap SAME convs, an
  LSTM cell, a sigmoid head) with crane_tpu's ``init_vad_params`` carried
  across by ``utils/bridge.py``: per-chunk probabilities and LSTM states
  over a stream of seeded chunks within 1e-5;
- ``Vad.segment_audio`` gives crane_tpu's segments with the energy model
  (tests/test_vad.py's patterns) and with the native net on both sides;
- the port's own default draw (a seeded ``torch.Generator``, not
  ``jax.random``) has crane_tpu's scales; the ONNX path loads through the
  port's evaluator (tests/test_torch_onnx.py holds it against crane_tpu's)
  and, as crane_tpu's, fails on a missing file.
"""

import numpy as np
import pytest
import torch

from crane_tpu.models import silero_vad as jv
from crane_tpu_torch.models import silero_vad as tv
from crane_tpu_torch.utils.bridge import audio_params_from_jax
from tests.test_vad import make_audio

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nets():
    jparams = jv.init_vad_params(jv.VadModelConfig(), seed=4)
    return jv.VadModel(params=jparams), tv.VadModel(params=audio_params_from_jax(jparams),
                                                    device="cpu")


def test_probabilities_and_states_match(nets):
    jm, tm = nets
    rng = np.random.default_rng(0)
    js, ts = jm.initial_state(), tm.initial_state()
    for i in range(12):
        chunk = (rng.standard_normal(512) * (0.02 if i % 3 else 0.5)).astype(np.float32)
        jp, js = jm(chunk, js)
        tp, ts = tm(chunk, ts)
        assert abs(tp - jp) <= 1e-5
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


PATTERNS = {
    "one utterance": [(False, 500), (True, 1000), (False, 500)],
    "blip": [(False, 500), (True, 60), (False, 800)],
    "bridged silence": [(False, 400), (True, 500), (False, 60), (True, 500), (False, 400)],
    "split": [(False, 400), (True, 500), (False, 600), (True, 500), (False, 400)],
    "open at the end": [(False, 300), (True, 700)],
}


@pytest.mark.parametrize("name", list(PATTERNS))
@pytest.mark.parametrize("sr", [16000, 8000])
def test_segments_match_with_the_energy_model(name, sr):
    audio = make_audio(PATTERNS[name], sr=sr)
    kw = dict(sample_rate=sr, min_silence_duration_ms=200)
    ref = jv.Vad(jv.VadConfig(**kw), model=jv.energy_vad()).segment_audio(audio)
    got = tv.Vad(tv.VadConfig(**kw), model=tv.energy_vad()).segment_audio(audio)
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in ref]


def test_segments_match_with_the_native_net(nets):
    jm, tm = nets
    audio = make_audio([(False, 300), (True, 900), (False, 700), (True, 400)])
    audio = audio + 0.01 * np.random.default_rng(5).standard_normal(len(audio)).astype(np.float32)
    # random weights keep p near 0.49-0.5 on this audio: thresholds at
    # least 1.9e-4 from every chunk's p (two segments), and far below them
    # (one)
    for threshold, offset, n in ((0.4965, 0.002, 2), (0.3, 0.15, 1)):
        cfg = dict(threshold=threshold, neg_threshold_offset=offset,
                   min_speech_duration_ms=60, min_silence_duration_ms=60)
        ref = jv.Vad(jv.VadConfig(**cfg), model=jm).segment_audio(audio)
        got = tv.Vad(tv.VadConfig(**cfg), model=tm).segment_audio(audio)
        assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in ref]
        assert len(got) == n


def test_default_draw_and_the_onnx_refusal():
    a, b = tv.VadModel(seed=1, device="cpu"), tv.VadModel(seed=1, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.convs[0].weight
    assert w.shape == (16, 129, 3) and abs(w.std().item() - (3 * 129) ** -0.5) < 0.01
    assert a.lstm.bias_hh.abs().sum() == 0
    p, (h, c) = a(np.zeros(512, np.float32), a.initial_state())
    assert 0.0 <= p <= 1.0 and h.shape == c.shape == (64,)
    with pytest.raises(FileNotFoundError):
        tv.load_silero_onnx("no-such-model.onnx")
