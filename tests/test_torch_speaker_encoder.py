"""The ECAPA-TDNN speaker encoder in crane_tpu_torch against crane_tpu (CPU,
float32): ``ecapa_forward``'s embedding of seeded log-mels, and
``SpeakerEncoder.__call__`` from a 24 kHz waveform (the magnitude log-mel of
``audio/mel.py`` at the speaker constants, then the net), within 1e-4
relative; on weights mapped by each package from the same state dict, and
carried across from crane_tpu's tree by ``utils/bridge.py``; at
tests/test_speaker_encoder.py's tiny shapes and at a second config with
dilations whose reflect pads outgrow a short clip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.models import speaker_encoder as jse
from crane_tpu_torch.models import speaker_encoder as tse
from crane_tpu_torch.utils.bridge import ECAPA_CONV_KEYS, audio_params_from_jax

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)

CONFIGS = {
    "tiny": dict(mel_dim=128, enc_dim=32, enc_channels=(32, 32, 48), enc_kernel_sizes=(5, 3, 1),
                 enc_dilations=(1, 2, 1), enc_attention_channels=8, enc_res2net_scale=4,
                 enc_se_channels=8),
    "wide dilations": dict(mel_dim=40, enc_dim=24, enc_channels=(32, 32, 32, 64),
                           enc_kernel_sizes=(5, 3, 3, 1), enc_dilations=(1, 3, 5, 1),
                           enc_attention_channels=16, enc_res2net_scale=4, enc_se_channels=8),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jcfg, tcfg = jse.EcapaConfig(**CONFIGS[request.param]), \
        tse.EcapaConfig(**CONFIGS[request.param])
    sd = jse.random_speaker_encoder_state_dict(jcfg, seed=3)
    return (jse.SpeakerEncoder(jcfg, jse.map_speaker_encoder_weights(jcfg, sd)),
            tse.SpeakerEncoder(tcfg, tse.map_speaker_encoder_weights(tcfg, sd)))


@pytest.mark.parametrize("frames", [3, 40, 150])
def test_ecapa_forward_matches(pair, frames):
    jm, tm = pair
    mel = np.random.default_rng(frames).normal(size=(2, tm.cfg.mel_dim, frames)) \
        .astype(np.float32)
    ref = np.asarray(jse.ecapa_forward(jm.cfg, jm.params, jnp.asarray(mel)))
    got = tse.ecapa_forward(tm.cfg, tm.params, torch.from_numpy(mel)).numpy()
    assert got.shape == (2, tm.cfg.enc_dim)
    np.testing.assert_allclose(got, ref, **FEAT)
    bridged = audio_params_from_jax(jm.params, conv_keys=ECAPA_CONV_KEYS)
    np.testing.assert_allclose(tse.ecapa_forward(tm.cfg, bridged, torch.from_numpy(mel)).numpy(),
                               ref, **FEAT)


@pytest.mark.parametrize("seconds", [0.05, 1.0, 3.0])
def test_embedding_from_a_waveform_matches(pair, seconds):
    jm, tm = pair
    n = int(seconds * 24000)
    t = np.arange(n) / 24000
    wav = (0.3 * np.sin(2 * np.pi * 180 * t)
           + 0.05 * np.random.default_rng(n).normal(size=n)).astype(np.float32)
    np.testing.assert_allclose(tm(wav), jm(wav), **FEAT)
    assert tm.similarity(np.ones((tm.cfg.mel_dim, 9), np.float32),
                         np.ones((tm.cfg.mel_dim, 9), np.float32)) == pytest.approx(1.0)


def test_random_state_dict_matches_crane_tpus():
    cfg = tse.EcapaConfig(**CONFIGS["tiny"])
    ref = jse.random_speaker_encoder_state_dict(jse.EcapaConfig(**CONFIGS["tiny"]), seed=5)
    got = tse.random_speaker_encoder_state_dict(cfg, seed=5)
    assert list(ref) == list(got) and all(np.array_equal(ref[k], got[k]) for k in ref)
    assert tse.speaker_encoder_shapes(cfg) == {k: v.shape for k, v in got.items()}
