"""The OCR nets and pipeline of crane_tpu_torch against crane_tpu (CPU, float32).

- ``db_detector`` and ``ctc_recognizer`` on crane_tpu's weights carried
  across by ``utils/bridge.py`` ``ocr_params_from_jax`` (HWIO there,
  PyTorch's OIHW here), within 2e-4: XLA's ``SAME`` padding at stride 2
  (``(0, 1)`` on an even side, which ``Conv2d(padding=1)`` would shift by a
  pixel), the bilinear 2x up-sampling, the tanh GELU (``F.gelu``'s default
  would miss);
- the copied pipeline: its NumPy resize byte-equal to PIL's bilinear (which
  crane_tpu calls, and the card's machine lacks), preprocessing, DB regions,
  CTC decoding and reading order as crane_tpu's;
- ``PaddleOcrPipeline.recognize`` over the native nets: the same regions
  and texts as crane_tpu's on a synthetic page (the detector's head rescaled
  so that random weights outline its text lines);
- the port's own default draw (a seeded ``torch.Generator``) at crane_tpu's
  scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from crane_tpu.ocr import nets as jn
from crane_tpu.ocr import pipeline as jp
from crane_tpu_torch.ocr import nets as tn
from crane_tpu_torch.ocr import pipeline as tp
from crane_tpu_torch.utils.bridge import ocr_params_from_jax

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 1e-5


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def synthetic_page(seed: int, h: int, w: int) -> np.ndarray:
    """White page with dark noisy bars where text lines would be."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    rows = max(2, h // 60)
    for i in range(rows):
        y = 8 + i * (h - 16) // rows
        x0, x1 = int(rng.integers(4, w // 5)), int(rng.integers(w // 2, w - 4))
        img[y:y + max(6, h // 30), x0:x1] = rng.integers(0, 80, (max(6, h // 30), x1 - x0, 3))
    return img


def contrast_head(params: dict, x: np.ndarray, net, scale: float = -3.0) -> dict:
    """The detector's tree with its output head rescaled: the head's logits
    on ``x`` standardized and scaled by ``scale``, so that a random net's
    near-uniform map (std about 0.06 around 0.6) outlines the page's text
    lines instead. numpy leaves in, numpy leaves out."""
    prob = np.asarray(net(params, x))
    z = np.log(prob / (1 - prob))
    s = scale / z.std()
    head = {"w": np.asarray(params["head2"]["w"]) * s,
            "b": (np.asarray(params["head2"]["b"]) - z.mean()) * s}
    return {**params, "head2": head}


@pytest.fixture(scope="module")
def detector():
    return {k: {n: np.asarray(a) for n, a in v.items()}
            for k, v in jn.init_detector_params(channels=8, seed=1).items()}


@pytest.fixture(scope="module")
def recognizer():
    return jn.init_recognizer_params(n_classes=9, channels=16, layers=2, heads=2, seed=2)


# -- the nets --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 3, 64, 96), (2, 3, 96, 64), (1, 3, 160, 224)])
def test_detector(detector, shape):
    x = rnd(sum(shape), *shape)
    got = tn.db_detector(ocr_params_from_jax(detector), torch.from_numpy(x))
    ref = jn.db_detector(detector, jnp.asarray(x))
    assert got.shape == ref.shape == (shape[0], 1) + shape[2:]
    close(got, ref)


def test_stride_two_same_padding(detector):
    """XLA pads an even side (0, 1) at stride 2 with k=3; Conv2d(padding=1)
    pads (1, 1), the same size shifted by a pixel."""
    p = ocr_params_from_jax(detector)["stem"]
    x = torch.from_numpy(rnd(7, 1, 3, 32, 48))
    ref = jn._conv(jnp.asarray(x.numpy()), detector["stem"], stride=2)
    close(tn._conv(x, p, stride=2), ref)
    shifted = F.conv2d(x, p["w"], p["b"], stride=2, padding=1)
    assert shifted.shape == tuple(ref.shape)
    assert np.abs(shifted.numpy() - np.asarray(ref)).max() > 1e-2


def test_upsampling_is_jax_bilinear():
    import jax

    x = rnd(8, 2, 3, 5, 7)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, 10, 14), "bilinear")
    close(tn._up2(torch.from_numpy(x)), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("heads,width", [(2, 80), (4, 48), (2, 200)])
def test_recognizer(recognizer, heads, width):
    x = rnd(width, 2, 3, 48, width)
    got = tn.ctc_recognizer(ocr_params_from_jax(recognizer), torch.from_numpy(x), heads=heads)
    ref = jn.ctc_recognizer(recognizer, jnp.asarray(x), heads=heads)
    assert got.shape == ref.shape == (2, width // 8, 9)
    close(got, ref)


def test_gelu_is_the_tanh_form():
    v = torch.tensor([1.0])
    import jax

    tanh_form = float(jax.nn.gelu(jnp.float32(1.0)))
    assert abs(F.gelu(v, approximate="tanh").item() - tanh_form) < 1e-6
    assert abs(F.gelu(v).item() - tanh_form) > 1e-4


# -- the pipeline ---------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((100, 200), (96, 192)), ((1000, 500), (960, 480)),
                                     ((48, 13), (48, 200)), ((37, 91), (48, 118)),
                                     ((7, 5), (48, 34)), ((33, 17), (5, 3)), ((64, 64), (64, 64)),
                                     ((300, 400), (123, 77))])
def test_resize_is_pil_bilinear(src, dst):
    img = np.random.default_rng(src[0] * dst[1]).integers(0, 256, src + (3,), np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.Resampling.BILINEAR))
    got = tp._resize(img, dst[1], dst[0])
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jp._resize(img, dst[1], dst[0]))


def test_pipeline_pieces():
    img = synthetic_page(3, 250, 330)
    got, ref = tp.detect_preprocess(img), jp.detect_preprocess(img)
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[0], ref[0])
    prob = np.clip(rnd(4, 64, 80) * 0.3 + 0.5, 0, 1)
    prob[10:20, 5:40] = 0.95
    assert tp.db_regions(prob, (80, 64), (330, 250)) == jp.db_regions(prob, (80, 64), (330, 250))
    boxes = [(10, 20, 120, 60, 0.9), (5, 100, 300, 140, 0.8), (200, 20, 260, 50, 0.7)]
    gb, go = tp.prepare_crops(img, boxes)
    rb, ro = jp.prepare_crops(img, boxes)
    np.testing.assert_array_equal(gb, rb)
    assert go == ro
    logits = rnd(5, 30, 9)
    dictionary = ["", *"abcdefg", " "]
    assert tp.ctc_greedy_decode(logits, dictionary) == jp.ctc_greedy_decode(logits, dictionary)
    regions = [tp.OcrRegion(l, t, l + 20, t + 10, "x", 1.0) for l, t in ((100, 10), (5, 13),
                                                                          (5, 50), (60, 52))]
    jregions = [jp.OcrRegion(r.left, r.top, r.right, r.bottom, r.text, r.confidence)
                for r in regions]
    assert [(r.left, r.top) for r in tp.sort_reading_order(regions)] == \
        [(r.left, r.top) for r in jp.sort_reading_order(jregions)]


def test_recognize_with_native_nets(detector, recognizer, tmp_path):
    """The whole pipeline over the native nets on both sides: the same
    regions (boxes) and texts."""
    img = synthetic_page(9, 200, 300)
    x, _ = jp.detect_preprocess(img)
    det = contrast_head(detector, jnp.asarray(x), jn.db_detector)
    dictionary = ["", *"abcdefg", " "]
    (tmp_path / "dict.txt").write_text("\n".join("abcdefg") + "\n")
    assert tp.load_dictionary(str(tmp_path / "dict.txt")) == dictionary
    tdet, trec = ocr_params_from_jax(det), ocr_params_from_jax(recognizer)
    got = tp.PaddleOcrPipeline(tn.NetCallable(tn.db_detector, tdet),
                               tn.NetCallable(tn.ctc_recognizer, trec, heads=2),
                               dictionary, rec_batch_size=2).recognize(img)
    ref = jp.PaddleOcrPipeline(lambda a: jn.db_detector(det, a),
                               lambda b: jn.ctc_recognizer(recognizer, b, heads=2),
                               dictionary, rec_batch_size=2).recognize(img)
    assert len(ref.regions) >= 2
    assert [(r.left, r.top, r.right, r.bottom, r.text) for r in got.regions] == \
        [(r.left, r.top, r.right, r.bottom, r.text) for r in ref.regions]
    assert got.text == ref.text
    close([r.confidence for r in got.regions], [r.confidence for r in ref.regions])


def test_default_draw_scales():
    det = tn.init_detector_params(24, seed=3, device="cpu")
    assert det["down2"]["w"].shape == (48, 24, 3, 3)
    assert abs(det["down2"]["w"].std().item() - (9 * 24) ** -0.5) < 5e-3
    assert torch.equal(det["stem"]["w"], tn.init_detector_params(24, seed=3, device="cpu")["stem"]["w"])
    rec = tn.init_recognizer_params(100, seed=4, device="cpu")
    assert rec["c4"]["w"].shape == (64, 64, 3, 3) and len(rec["encoder"]) == 2
    assert abs(rec["encoder"][0]["wqkv"].std().item() - 64 ** -0.5) < 5e-3
    out = tn.ctc_recognizer(rec, torch.zeros(1, 3, 48, 64))
    assert out.shape == (1, 8, 100)
