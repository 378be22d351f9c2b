"""The Qwen3-TTS speech tokenizer in crane_tpu_torch against crane_tpu (CPU,
float32).

- the decoder (the 16-codebook RVQGAN, here tests/test_qwen3_tts.py's tiny
  one): the upsampled length and the clip, causality (later frames change
  no earlier sample), ``decode_chunk`` and ``chunked_decode`` against the
  whole decode, and the audio against crane_tpu's on the same weights
  (mapped by each package, and carried across by ``utils/bridge.py``)
  within 1e-4 relative; the random state dict and ``init_decoder_params``
  drawn as crane_tpu draws them;
- the Mimi-style encoder on tests/test_speech_encoder_parity.py's setup
  (transformers' MimiModel at tiny shapes): the SEANet latent and the
  transformer's output within 1e-4 of crane_tpu's, and the codes equal to
  crane_tpu's and to MimiModel.encode's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.models import speech_tokenizer as jst
from crane_tpu_torch.models import speech_tokenizer as tst
from crane_tpu_torch.utils.bridge import params_from_jax
from tests.test_qwen3_tts import _decoder_sd, _tiny_decoder_cfg
from tests.test_speech_encoder_parity import VALID_NQ, setup  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def decoders():
    cfg = _tiny_decoder_cfg()
    sd = _decoder_sd(cfg)
    return (jst.SpeechTokenizerDecoder(cfg, jst.map_decoder_weights(cfg, sd)),
            tst.SpeechTokenizerDecoder(cfg, tst.map_decoder_weights(cfg, sd)))


def codes(cfg, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.codebook_size,
                                                size=(1, T, cfg.num_quantizers))


def test_decoder_upsample_shape_and_clip(decoders):
    _, dec = decoders
    audio = dec.decode(codes(dec.config, 12, 0))
    assert audio.shape == (1, 12 * dec.config.total_upsample)
    assert np.all(np.abs(audio) <= 1.0) and np.abs(audio).max() > 0


def test_decoder_is_causal(decoders):
    _, dec = decoders
    T, up = 24, dec.config.total_upsample
    c = codes(dec.config, T, 1)
    c2 = c.copy()
    c2[:, -8:] = (c2[:, -8:] + 7) % dec.config.codebook_size
    a1, a2 = dec.decode(c), dec.decode(c2)
    np.testing.assert_allclose(a1[:, : (T - 8) * up], a2[:, : (T - 8) * up], atol=1e-6)
    assert np.abs(a1[:, (T - 8) * up:] - a2[:, (T - 8) * up:]).max() > 1e-6


@pytest.mark.parametrize("T", [7, 30])
def test_decode_matches_crane_tpu(decoders, T):
    jdec, dec = decoders
    c = codes(dec.config, T, T)
    np.testing.assert_allclose(dec.decode(c), jdec.decode(c), **FEAT)
    # the same tree carried across from crane_tpu's params
    bridged = tst.SpeechTokenizerDecoder(dec.config, params_from_jax(jdec.params))
    np.testing.assert_allclose(bridged.decode(c), jdec.decode(c), **FEAT)


def test_codes_past_the_table_read_its_last_row(decoders):
    """A code past a codebook (a predictor vocabulary wider than the
    decoder's 2048 bins) decodes as crane_tpu's clamping gather decodes it."""
    jdec, dec = decoders
    c = codes(dec.config, 6, 8) + dec.config.codebook_size // 2
    assert (c >= dec.config.codebook_size).any()
    np.testing.assert_allclose(dec.decode(c), jdec.decode(c), **FEAT)


def test_chunked_decode_against_the_whole_decode(decoders):
    """With full left context every chunk sees all before it, so chunked
    decoding reproduces the whole decode; with the bounded context of
    streaming it keeps the length and equals crane_tpu's chunks."""
    jdec, dec = decoders
    T = 30
    c = codes(dec.config, T, 2)
    full = dec.decode(c)
    np.testing.assert_allclose(dec.chunked_decode(c, chunk_size=10, left_context=T), full,
                               atol=1e-5)
    bounded = dec.chunked_decode(c, chunk_size=10, left_context=8)
    assert bounded.shape == full.shape
    np.testing.assert_allclose(bounded, jdec.chunked_decode(c, chunk_size=10, left_context=8),
                               **FEAT)
    # one streaming chunk: 5 new frames after 4 of context
    chunk = dec.decode_chunk(c[:, 6:15], 4)
    assert chunk.shape == (1, 5 * dec.config.total_upsample)
    np.testing.assert_allclose(chunk, jdec.decode_chunk(c[:, 6:15], 4), **FEAT)


def test_random_state_dicts_and_init_params_match():
    cfg = _tiny_decoder_cfg()
    ref, got = jst.random_decoder_state_dict(cfg, seed=4), tst.random_decoder_state_dict(cfg, 4)
    assert ref.keys() == got.keys() and all(np.array_equal(ref[k], got[k]) for k in ref)
    c = codes(cfg, 9, 5)
    np.testing.assert_allclose(
        tst.SpeechTokenizerDecoder(cfg, tst.init_decoder_params(cfg, 4)).decode(c),
        jst.SpeechTokenizerDecoder(cfg, jst.init_decoder_params(cfg, 4)).decode(c), **FEAT)
    ecfg = jst.SpeechEncoderConfig(
        num_filters=8, hidden_size=24, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, head_dim=8, upsampling_ratios=(4, 3),
        codebook_size=32, codebook_dim=12, num_quantizers=6, num_semantic_quantizers=1,
        sliding_window=8, vector_quantization_hidden_dimension=12, valid_num_quantizers=4)
    ref, got = jst.random_encoder_state_dict(ecfg, 7), tst.random_encoder_state_dict(ecfg, 7)
    assert ref.keys() == got.keys() and all(np.array_equal(ref[k], got[k]) for k in ref)
    wav = (np.random.default_rng(6).normal(size=3000) * 0.2).astype(np.float32)
    np.testing.assert_array_equal(
        tst.SpeechTokenizerEncoder(ecfg, tst.init_encoder_params(ecfg, 7))(wav),
        jst.SpeechTokenizerEncoder(ecfg, jst.init_encoder_params(ecfg, 7))(wav))


@pytest.fixture(scope="module")
def encoders(setup):  # noqa: F811
    model, cfg, jparams = setup
    sd = {"encoder." + k: v for k, v in model.state_dict().items()}
    return model, cfg, jparams, tst.map_encoder_weights(cfg, sd)


def test_encoder_latents_match(encoders):
    model, cfg, jp, tp = encoders
    wav = np.random.default_rng(0).normal(size=(1, 1, 480)).astype(np.float32) * 0.3
    ref = jst.encoder_seanet(cfg, jp, jnp.asarray(wav))
    got = tst.encoder_seanet(cfg, tp, torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FEAT)
    ref_t = jst.encoder_transformer(cfg, jp["transformer"], ref.transpose(0, 2, 1))
    got_t = tst.encoder_transformer(cfg, tp["transformer"], got.transpose(1, 2))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **FEAT)
    bridged = params_from_jax(jp)
    np.testing.assert_allclose(tst.encoder_seanet(cfg, bridged, torch.from_numpy(wav)).numpy(),
                               np.asarray(ref), **FEAT)


@pytest.mark.parametrize("n", [1200, 2400])
def test_encoder_codes_match(encoders, n):
    model, cfg, jp, tp = encoders
    wav = np.random.default_rng(n).normal(size=n).astype(np.float32) * 0.3
    got = tst.SpeechTokenizerEncoder(cfg, tp).encode(wav)
    assert got.dtype == np.int32 and got.shape[1] == VALID_NQ
    np.testing.assert_array_equal(got, jst.SpeechTokenizerEncoder(cfg, jp).encode(wav))
    with torch.no_grad():
        ref = model.encode(torch.from_numpy(wav[None, None]),
                           num_quantizers=VALID_NQ).audio_codes[0].numpy().T
    np.testing.assert_array_equal(got, ref)
    # batched input keeps the batch axis
    assert tst.SpeechTokenizerEncoder(cfg, tp).encode(np.stack([wav, wav])).shape == \
        (2, *got.shape)
