"""Qwen2-Audio in crane_tpu_torch against crane_tpu (CPU, float32), on the
tiny checkpoint of tests/test_qwen2_audio_parity.py loaded by both
packages' ``load_qwen2_audio``.

- the tower and projector (``encode_project``) on a seeded mel, within
  1e-4 relative; the weights the port maps equal crane_tpu's through the
  bridge (conv weights in PyTorch's layout);
- the spliced prefill's logits within 2e-4 and 8 greedy ids identical,
  the prefill going through ``embeds_prefill`` (K3's plain version here)
  and the steps through ``greedy_decode_step`` (K1's);
- ``generate`` from a waveform and ``transcribe`` give crane_tpu's ids and
  text, and ``models/factory.py`` returns the port's ``AudioLLM``;
- a checkpoint with a top-level ``lm_head.weight``, which crane_tpu's
  loader refuses (a reference fault, ROADMAP Queue 3), loads in the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.models import qwen2_audio as jqa
from crane_tpu_torch.models import qwen2_audio as tqa
from crane_tpu_torch.utils.bridge import audio_params_from_jax
from tests.test_qwen2_audio_parity import AUDIO_TOKEN
from tests.test_qwen2_audio_parity import tiny  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair(tiny):  # noqa: F811
    _, d = tiny
    return jqa.load_qwen2_audio(d, dtype=jnp.float32), tqa.load_qwen2_audio(d, device="cpu")


def mel(seed):
    return np.random.default_rng(seed).standard_normal((1, 16, 100)).astype(np.float32)


def test_tower_matches_crane_tpu(pair):
    jm, tm = pair
    x = mel(0)
    ref = np.asarray(jqa._encode_project(jm.audio_config, jm.params, jnp.asarray(x)))
    got = tqa.encode_project(tm.audio_config, tm.params, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 25, 64)
    np.testing.assert_allclose(got, ref, **FEAT)


def test_mapped_weights_equal_the_bridged_tree(pair):
    jm, tm = pair
    bridged = audio_params_from_jax({"encoder": jm.params["encoder"],
                                     "proj_w": jm.params["proj_w"]})
    enc = tm.params["encoder"]
    assert enc["conv1_w"].shape == (32, 16, 3)  # [Cout, Cin, k]
    for name in ("conv1_w", "conv2_w", "pos_embed"):
        torch.testing.assert_close(enc[name], bridged["encoder"][name], rtol=0, atol=0)
    torch.testing.assert_close(enc["layers"][1]["wk"], bridged["encoder"]["layers"][1]["wk"],
                               rtol=0, atol=0)
    torch.testing.assert_close(tm.params["proj_w"], bridged["proj_w"], rtol=0, atol=0)


def test_prefill_logits_and_greedy_ids_match(pair):
    jm, tm = pair
    from crane_tpu.models.modules.transformer import make_cache as jcache
    from crane_tpu.utils.buckets import bucket_length

    x = mel(1)
    n = jqa.audio_feature_lengths(100)
    ids = [5, 6] + [AUDIO_TOKEN] * n + [7, 8]
    feats = jqa._encode_project(jm.audio_config, jm.params, jnp.asarray(x))
    embeds = jm.params["embed"][jnp.asarray(ids)][None]
    pos = np.where(np.asarray(ids) == AUDIO_TOKEN)[0]
    embeds = embeds.at[0, pos].set(feats[0, :n])
    S = len(ids)
    embeds = jnp.pad(embeds, ((0, 0), (0, bucket_length(S, floor=64) - S), (0, 0)))
    ref_logits, cache = jqa._audio_prefill(jm.config, jm.params, jm.rope,
                                           jcache(jm.config, 1, 256, jnp.float32), embeds,
                                           jnp.asarray(S, jnp.int32))
    ref = [int(jnp.argmax(ref_logits, -1)[0])]
    cur = jnp.asarray(ref, jnp.int32)
    for _ in range(7):
        cur, cache = jqa._audio_decode_step(jm.config, jm.params, jm.rope, cache, cur)
        ref.append(int(cur[0]))

    tfeats = tqa.encode_project(tm.audio_config, tm.params, torch.from_numpy(x))[0, :n]
    logits, _ = tm.prefill(ids, tfeats, 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **LOGITS)
    assert tm.generate_from_features(ids, tfeats, max_new_tokens=8) == ref


def test_generate_and_transcribe_from_a_waveform(pair):
    jm, tm = pair
    t = np.arange(15999, dtype=np.float32) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 300 * t)
           + 0.05 * np.random.default_rng(3).standard_normal(15999)).astype(np.float32)
    n = jm.n_audio_tokens(len(wav))
    assert tm.n_audio_tokens(len(wav)) == n
    ids = [5] + [AUDIO_TOKEN] * n + [7]
    assert tm.generate(ids, wav, max_new_tokens=6) == jm.generate(ids, wav, max_new_tokens=6)
    eos = jm.generate(ids, wav, max_new_tokens=6)[2]
    jm.eos_token_ids = tm.eos_token_ids = (eos,)
    try:
        ref = jm.generate(ids, wav, max_new_tokens=6)
        assert ref[-1] == eos and tm.generate(ids, wav, max_new_tokens=6) == ref
    finally:
        jm.eos_token_ids = tm.eos_token_ids = ()
    if jm.tokenizer is not None:
        assert tm.transcribe(wav, max_new_tokens=4) == jm.transcribe(wav, max_new_tokens=4)


def test_factory_returns_the_ports_audio_llm(tiny):  # noqa: F811
    from crane_tpu_torch.models.factory import detect_model_type, load_model

    _, d = tiny
    assert detect_model_type(d) == "qwen2_audio"
    assert type(load_model(d, dtype=torch.float32, device="cpu")) is tqa.AudioLLM


def test_a_top_level_lm_head_loads(tiny, tmp_path):  # noqa: F811
    """A checkpoint whose head is stored as ``lm_head.weight`` (not under
    ``language_model.``): crane_tpu's ``load_qwen2_audio`` takes the truth
    value of the array (``sd.get(...) or sd.get(...)``) and raises; the
    port loads it with the same head (ROADMAP Queue 3)."""
    import shutil

    from safetensors.numpy import load_file, save_file

    _, d = tiny
    moved = tmp_path / "top_level_head"
    shutil.copytree(d, moved)
    sd = load_file(str(moved / "model.safetensors"))
    head = sd.pop("language_model.lm_head.weight")
    sd["lm_head.weight"] = head
    save_file(sd, str(moved / "model.safetensors"), metadata={"format": "pt"})
    with pytest.raises(ValueError, match="truth value"):
        jqa.load_qwen2_audio(str(moved), dtype=jnp.float32)
    tm = tqa.load_qwen2_audio(str(moved), device="cpu")
    torch.testing.assert_close(tm.params["lm_head"], torch.from_numpy(head).T, rtol=0, atol=0)
