"""CSM (backbone + depth decoder over Mimi) in crane_tpu_torch against
crane_tpu (CPU, float32), on tests/test_csm_tts_parity.py's tiny checkpoint
(transformers' CsmForConditionalGeneration, saved): greedy codes equal to
crane_tpu's (and to transformers' generate, the JAX test's oracle), the
voice-clone ``audio_context`` splice (the prompt embeddings and the codes),
positions past the backbone's rope table (a long request, a long
prompt), a tied-codebook checkpoint's missing backbone table, speech through the
codec within 1e-4, the trees carried across by ``utils/bridge.py``, and
each frame as one replay of the stand-in graph with the eager frames'
codes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.models.csm_tts import load_csm as jload
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.csm_tts import CsmTtsModel, load_csm
from crane_tpu_torch.utils.bridge import params_from_jax
from tests.test_csm_tts_parity import tiny  # noqa: F401
from tests.test_torch_graphs import stand_in  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair(tiny):  # noqa: F811
    model, d = tiny
    return model, jload(d, dtype=jnp.float32, with_codec=True), \
        load_csm(d, with_codec=True, device="cpu")


@pytest.mark.parametrize("text", [[5, 17, 42, 9, 3], [7], list(range(20, 60))])
def test_greedy_codes_match(pair, text):
    model, jm, tm = pair
    got = tm.generate_codes(text, max_frames=8)
    ref = jm.generate_codes(text, max_frames=8)
    assert got.dtype == np.int32 and got.shape[1] == 4 and len(got) > 0
    np.testing.assert_array_equal(got, ref)
    with torch.no_grad():
        hf = model.generate(input_ids=torch.tensor([text]), max_new_tokens=8, do_sample=False,
                            depth_decoder_do_sample=False, output_audio=False)[0].numpy()
    np.testing.assert_array_equal(got[:len(hf)], hf[:len(got)])


@pytest.mark.parametrize("n_text", [250, 270])
def test_positions_past_the_rope_table_match(pair, n_text):
    """Frames past the backbone's 256 rope positions, and a prompt longer
    than the table (its bucket padded to 512): the port reads the table's
    last row there, as crane_tpu's gather does, and gives its codes."""
    _, jm, tm = pair
    text = [(7 * i) % 200 for i in range(n_text)]
    max_pos = tm.config.backbone.max_position_embeddings
    got = tm.generate_codes(text, max_frames=12, stop_on_eos=False)
    assert len(got) == 12 and n_text + len(got) > max_pos
    np.testing.assert_array_equal(got, jm.generate_codes(text, max_frames=12, stop_on_eos=False))


def test_voice_clone_splice_matches(pair):
    model, jm, tm = pair
    cfg = model.config
    wav = (np.random.default_rng(3).standard_normal(40 * 24) * 0.1).astype(np.float32)
    n_audio = tm.codec.encode(wav[None], num_quantizers=4).shape[-1]
    ids = np.asarray([5, 17] + [cfg.audio_token_id] * n_audio + [cfg.audio_eos_token_id] + [9, 3],
                     np.int32)
    np.testing.assert_allclose(tm.prompt_embeds(ids, wav).numpy(),
                               np.asarray(jm.prompt_embeds(ids, wav)), **FEAT)
    got = tm.generate_codes(ids, audio_context=wav, max_frames=5)
    np.testing.assert_array_equal(got, jm.generate_codes(ids, audio_context=wav, max_frames=5))
    with pytest.raises(AssertionError):
        tm.prompt_embeds(np.delete(ids, 2), wav)  # one placeholder short


def test_speech_through_the_codec_matches(pair):
    from crane_tpu.sdk.audio import CsmTts as JCsmTts
    from crane_tpu_torch.generation.config import SpeechOptions
    from crane_tpu_torch.sdk.audio import CsmTts

    _, jm, tm = pair
    wav = tm.generate_speech([5, 17, 42], max_frames=4)
    assert wav.ndim == 1 and np.isfinite(wav).all()
    np.testing.assert_allclose(wav, jm.generate_speech([5, 17, 42], max_frames=4), **FEAT)

    class Tok:
        def encode(self, s):
            return [5 + ord(c) % 30 for c in s]

    adapter = CsmTts(tm, Tok(), max_frames=3)
    assert adapter.audio_info().sample_rate == 24000 and adapter.supports_voice_cloning()
    assert adapter.voices() == []
    out = adapter.generate_speech("hi there", SpeechOptions(max_new_tokens=8))
    np.testing.assert_allclose(out, JCsmTts(jm, Tok(), max_frames=3).generate_speech("hi there"),
                               **FEAT)
    assert [c.shape for c in adapter.generate_speech_stream("hi there")] == [out.shape]


def test_tied_codebook_checkpoint_and_bridge(pair, tiny, tmp_path):  # noqa: F811
    """transformers saves the tied table once (the checkpoint has no
    backbone audio table, and both loaders take the depth decoder's); a copy
    that states the table explicitly gives the same codes; crane_tpu's tree
    carried across gives crane_tpu's codes."""
    import shutil

    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict, save_state_dict

    _, jm, tm = pair
    d = tmp_path / "tied"
    d.mkdir()
    sd = load_state_dict(tiny[1])
    key = "backbone_model.embed_tokens.embed_audio_tokens.weight"
    assert key not in sd
    sd[key] = sd["depth_decoder.model.embed_tokens.weight"].clone()
    save_state_dict(sd, str(d / "model.safetensors"))
    shutil.copy(f"{tiny[1]}/config.json", d)
    text = [5, 17, 42]
    want = jm.generate_codes(text, max_frames=6)
    np.testing.assert_array_equal(load_csm(str(d), device="cpu").generate_codes(text, max_frames=6),
                                  want)
    bridged = CsmTtsModel(tm.config, params_from_jax(jm.params))
    np.testing.assert_array_equal(bridged.generate_codes(text, max_frames=6), want)


def test_each_frame_is_one_replay(pair, stand_in):  # noqa: F811
    _, _, tm = pair
    tm.release_graphs()
    text = [5, 17, 42, 9, 3]
    with graphs.eager():
        eager = tm.generate_codes(text, max_frames=6)
    replays = graphs.replays
    got = tm.generate_codes(text, max_frames=6)
    np.testing.assert_array_equal(got, eager)
    assert graphs.replays - replays == len(got) and len(stand_in) == 1
    tm.release_graphs()
