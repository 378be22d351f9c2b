"""The Mimi codec in crane_tpu_torch against crane_tpu and transformers'
MimiModel (CPU, float32), on tests/test_mimi_parity.py's tiny checkpoint:
decode within 1e-4 relative of crane_tpu's (and within 2e-3 of MimiModel's,
the JAX test's bound), encode codes equal to both, chunked decode with full
left context equal to the one-shot decode and with the streaming overlap
equal to crane_tpu's chunks, and crane_tpu's tree carried across by
``utils/bridge.py`` (``MIMI_CONV_KEYS``).
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from crane_tpu.models.mimi import MimiCodec as JMimi
from crane_tpu_torch.models.mimi import MimiCodec, map_mimi_weights
from crane_tpu_torch.utils.bridge import MIMI_CONV_KEYS, audio_params_from_jax
from tests.test_mimi_parity import tiny  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def codecs(tiny):  # noqa: F811
    model, d = tiny
    return model, JMimi.from_pretrained(d), MimiCodec.from_pretrained(d, device="cpu")


def test_codes_past_the_table_read_its_last_row(codecs):
    """CSM's audio vocabulary holds 2051 ids for Mimi's 2048 codewords: a code
    past the table decodes as crane_tpu's clamping gather decodes it."""
    _, jc, tc = codecs
    codes = np.random.default_rng(7).integers(0, 70, (1, 4, 9)).astype(np.int64)
    assert (codes >= 64).any()
    np.testing.assert_allclose(tc.decode(codes), jc.decode(codes), **FEAT)
    np.testing.assert_allclose(tc.decode(codes), tc.decode(np.minimum(codes, 63)), **FEAT)


@pytest.mark.parametrize("T", [1, 10, 31])
def test_decode_matches(codecs, T):
    model, jc, tc = codecs
    codes = np.random.default_rng(T).integers(0, 64, (2, 4, T)).astype(np.int64)
    got = tc.decode(codes)
    np.testing.assert_allclose(got, jc.decode(codes), **FEAT)
    with torch.no_grad():
        ref = model.decode(torch.from_numpy(codes)).audio_values.numpy()[:, 0]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n,nq", [(240, 4), (1000, 4), (480, 2)])
def test_encode_matches(codecs, n, nq):
    model, jc, tc = codecs
    audio = np.random.default_rng(n).standard_normal((1, n)).astype(np.float32) * 0.1
    got = tc.encode(audio, num_quantizers=nq)
    np.testing.assert_array_equal(got, jc.encode(audio, num_quantizers=nq))
    with torch.no_grad():
        ref = model.encode(torch.from_numpy(audio)[:, None, :], num_quantizers=nq).audio_codes
    np.testing.assert_array_equal(got, ref.numpy())


def test_chunked_decode(codecs):
    _, jc, tc = codecs
    codes = np.random.default_rng(2).integers(0, 64, (1, 4, 23)).astype(np.int64)
    full = tc.decode(codes)
    exact = tc.chunked_decode(codes, chunk=8, overlap=23)
    assert exact.shape == full.shape
    np.testing.assert_allclose(exact, full, rtol=1e-4, atol=1e-5)
    approx = tc.chunked_decode(codes, chunk=8, overlap=3)
    np.testing.assert_allclose(approx, jc.chunked_decode(codes, chunk=8, overlap=3), **FEAT)


def test_bridged_tree_matches_the_ports_mapping(codecs, tiny):  # noqa: F811
    model, jc, tc = codecs
    bridged = MimiCodec(tc.config, audio_params_from_jax(jc.params, conv_keys=MIMI_CONV_KEYS))
    mapped = MimiCodec(tc.config, map_mimi_weights(tc.config, {
        k: v.detach() for k, v in model.state_dict().items()}))
    codes = np.random.default_rng(4).integers(0, 64, (1, 4, 12)).astype(np.int64)
    for codec in (bridged, mapped):
        np.testing.assert_allclose(codec.decode(codes), tc.decode(codes), **FEAT)
