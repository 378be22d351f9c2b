"""Whisper in crane_tpu_torch against crane_tpu (CPU, float32), on the tiny
checkpoint of tests/test_whisper_parity.py loaded by both packages'
``load_whisper``.

- the encoder states and the cross K/V on a seeded mel, within 1e-4
  relative; conv weights in PyTorch's layout, equal to crane_tpu's through
  the bridge;
- greedy ids identical from the forced prompt (with and without forced
  ids), through the port's one-token step (a graph replay on the card,
  eager here) over the kept cache and cross buffers, twice in a row;
- the cap at ``max_target_positions`` (the cache drops writes past it, so
  generation stops short of them), and ``transcribe_ids`` from a waveform.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.models import whisper as jw
from crane_tpu.ops.kv_cache import KVCache, LayerKVCache
from crane_tpu_torch.models import whisper as tw
from crane_tpu_torch.utils.bridge import audio_params_from_jax
from tests.test_torch_graphs import stand_in  # noqa: F401
from tests.test_whisper_parity import tiny  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)


def redraw(tree, rng):
    """The tree with every weight of two or more dims drawn anew, normal
    with std fan_in ** -0.5: HF's initialization (std 0.02) makes a tiny
    decoder repeat one token, so greedy ids would show little."""
    if isinstance(tree, dict):
        return {k: redraw(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(redraw(v, rng) for v in tree)
    a = np.asarray(tree)
    if a.ndim < 2:
        return tree
    fan_in = int(np.prod(a.shape[:-1]))
    return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * fan_in ** -0.5)


@pytest.fixture(scope="module", params=["checkpoint", "redrawn"])
def pair(tiny, request):  # noqa: F811
    _, d = tiny
    jm, tm = jw.load_whisper(d, dtype=jnp.float32), tw.load_whisper(d, device="cpu")
    if request.param == "redrawn":
        params = redraw(jm.params, np.random.default_rng(0))
        jm = jw.WhisperModel(jm.config, params, dtype=jnp.float32)
        tm = tw.WhisperModel(tw.WhisperConfig(**dataclasses.asdict(jm.config)),
                             audio_params_from_jax(params))
    return jm, tm


def mel(seed, frames=150):
    return np.random.default_rng(seed).standard_normal((1, 16, frames)).astype(np.float32)


def crane_ids(jm, x, forced, n):
    """crane_tpu's greedy ids (its ``transcribe_ids`` body on a given mel)."""
    cfg = jm.config
    _, enc_kv = jw._encode_kv(cfg, jm.params, jnp.asarray(x))
    n = min(n, cfg.max_target_positions - len(forced) - 2)
    cache = KVCache(layers=tuple(LayerKVCache.empty(1, cfg.max_target_positions, cfg.num_heads,
                                                    cfg.head_dim, jnp.float32)
                                 for _ in range(cfg.decoder_layers)),
                    lengths=jnp.zeros((1,), jnp.int32))
    tok, cache = jw._decode_step(cfg, jm.params, cache,
                                 jnp.asarray([[cfg.decoder_start_token_id, *forced]], jnp.int32),
                                 enc_kv)
    out = []
    for _ in range(n):
        t = int(tok[0])
        if t == cfg.eos_token_id:
            break
        out.append(t)
        tok, cache = jw._decode_step(cfg, jm.params, cache, tok[:, None], enc_kv)
    return out


def test_encoder_and_cross_kv_match(pair):
    jm, tm = pair
    x = mel(0)
    enc, kv = jw._encode_kv(jm.config, jm.params, jnp.asarray(x))
    tenc, tkv = tw.encode_kv(tm.config, tm.params, torch.from_numpy(x))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), **FEAT)
    for (k, v), (tk, tv) in zip(kv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(k), **FEAT)
        np.testing.assert_allclose(tv.numpy(), np.asarray(v), **FEAT)
    bridged = audio_params_from_jax(jm.params)
    assert tm.params["encoder"]["conv2_w"].shape == (64, 64, 3)
    for name in ("conv1_w", "conv2_w"):
        torch.testing.assert_close(tm.params["encoder"][name], bridged["encoder"][name],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("forced", [(), (9, 17)])
def test_greedy_ids_match(pair, forced):
    jm, tm = pair
    for seed in (1, 2):  # the second utterance reuses the kept cache and buffers
        x = mel(seed)
        ref = crane_ids(jm, x, forced, 20)
        assert tm.transcribe_features(torch.from_numpy(x), forced_ids=forced,
                                      max_new_tokens=20) == ref


def test_generation_stops_short_of_max_target_positions(pair):
    jm, tm = pair
    x = mel(4)
    cap = jm.config.max_target_positions
    ref = crane_ids(jm, x, (), 10 * cap)
    got = tm.transcribe_features(torch.from_numpy(x), max_new_tokens=10 * cap)
    assert got == ref and len(got) <= cap - 2


def test_transcribe_ids_from_a_waveform(pair):
    jm, tm = pair
    t = np.arange(24000, dtype=np.float32) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    np.testing.assert_allclose(tm.extract_features(wav).numpy(),
                               np.asarray(jm.extract_features(wav)), rtol=1e-4, atol=1e-4)
    assert tm.transcribe_ids(wav, max_new_tokens=12) == jm.transcribe_ids(wav, max_new_tokens=12)


def test_steps_replay_one_program(pair, stand_in, monkeypatch):  # noqa: F811
    """Through the graph dispatch (a stand-in for the card's CUDA graph,
    whose capture sees an all-false ``active`` mask and must write
    nothing): one program, captured once and replayed once a step, the same
    ids as the eager steps."""
    from crane_tpu_torch.models import graphs

    jm, tm = pair
    x = mel(5)
    with graphs.eager():
        eager = tm.transcribe_features(torch.from_numpy(x), max_new_tokens=20)
    tm.release_graphs()
    step, calls = tm.step, []
    monkeypatch.setattr(tm, "step", lambda *a: calls.append(1) or step(*a))
    start = graphs.replays
    got = tm.transcribe_features(torch.from_numpy(x), max_new_tokens=20)
    assert got == eager
    assert len(stand_in) == len(tm._programs) == 1
    assert graphs.replays - start == len(calls) >= max(len(got) - 1, 1)
    tm.release_graphs()
