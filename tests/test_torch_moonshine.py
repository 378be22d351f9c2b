"""Moonshine in crane_tpu_torch against crane_tpu (CPU, float32), on the
tiny checkpoint of tests/test_moonshine_parity.py loaded by both packages'
``load_moonshine``.

- the frontend (k127/s64 conv, tanh, the single-group GroupNorm over
  (C, T), k7/s3 and k3/s2 with GELU) and the encoder states (partial GPT-J
  rotary) within 1e-4 relative, at several lengths;
- greedy ids identical through ``transcribe_ids`` (the one-token step a
  graph replay on the card, eager here; rope tables and cache sized by
  ``bucket_length(max_new + 8, floor=64)``), a clip under 1024 samples
  zero-padded, and two utterances of different lengths on one model;
- the weights the port maps equal crane_tpu's through the bridge.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.generation.config import TranscribeOptions as JOpts
from crane_tpu.models import moonshine as jms
from crane_tpu_torch.generation.config import TranscribeOptions
from crane_tpu_torch.models import moonshine as tms
from crane_tpu_torch.utils.bridge import audio_params_from_jax
from tests.test_torch_graphs import stand_in  # noqa: F401
from tests.test_moonshine_parity import _wav
from tests.test_moonshine_parity import tiny  # noqa: F401

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
    jm, tm = jms.load_moonshine(d, dtype=jnp.float32), tms.load_moonshine(d, device="cpu")
    if request.param == "redrawn":
        params = redraw(jm.params, np.random.default_rng(0))
        jm = jms.MoonshineModel(jm.config, params, dtype=jnp.float32)
        tm = tms.MoonshineModel(tms.MoonshineConfig(**dataclasses.asdict(jm.config)),
                                audio_params_from_jax(params))
    return jm, tm


@pytest.mark.parametrize("n", [16000, 5000, 1100])
def test_frontend_and_encoder_match(pair, n):
    jm, tm = pair
    wav = _wav(n)[None]
    ref = np.asarray(jms.encoder_frontend(jm.config, jm.params["frontend"], jnp.asarray(wav)))
    got = tms.encoder_frontend(tm.config, tm.params["frontend"], torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, ref, **FEAT)
    ref = np.asarray(jms.encode(jm.config, jm.params, jnp.asarray(wav)))
    got = tms.encode(tm.config, tm.params, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, ref, **FEAT)


def test_mapped_weights_equal_the_bridged_tree(pair):
    jm, tm = pair
    bridged = audio_params_from_jax(jm.params)
    front = tm.params["frontend"]
    assert front["conv1_w"].shape[1:] == (1, 127) and front["gn_w"].ndim == 1
    for name in ("conv1_w", "conv2_w", "conv3_w", "gn_w", "gn_b"):
        torch.testing.assert_close(front[name], bridged["frontend"][name], rtol=0, atol=0)
    torch.testing.assert_close(tm.params["proj_out"], bridged["proj_out"], rtol=0, atol=0)


def test_greedy_ids_match(pair):
    jm, tm = pair
    t = np.arange(20000) / 16000
    speechy = (0.2 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t)).astype(np.float32)
    for wav in (_wav(), speechy, _wav(700), _wav()):  # the last replays the first's step
        for new in (12, 3):
            ref = jm.transcribe_ids(wav, JOpts(max_new_tokens=new))
            assert tm.transcribe_ids(wav, TranscribeOptions(max_new_tokens=new)) == ref


def test_steps_replay_one_program(pair, stand_in, monkeypatch):  # noqa: F811
    """Through the graph dispatch (a stand-in for the card's CUDA graph,
    whose capture sees an all-false ``active`` mask and must write
    nothing): one program, captured once and replayed once a step, the same
    ids as the eager steps."""
    from crane_tpu_torch.models import graphs

    jm, tm = pair
    with graphs.eager():
        eager = tm.transcribe_ids(_wav(), TranscribeOptions(max_new_tokens=20))
    tm.release_graphs()
    step, calls = tm.step, []
    monkeypatch.setattr(tm, "step", lambda *a: calls.append(1) or step(*a))
    start = graphs.replays
    got = tm.transcribe_ids(_wav(), TranscribeOptions(max_new_tokens=20))
    assert got == eager
    assert len(stand_in) == len(tm._programs) == 1
    assert graphs.replays - start == len(calls) >= max(len(got) - 1, 1)
    tm.release_graphs()
