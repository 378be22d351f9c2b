"""Two-stage OCR pipeline: text detection -> crop recognition -> reading order.

Reference behavior (crane-core src/models/paddleocr_v6/
pipeline.rs:1-365): PaddleOCR v6 runs a DB-style detector over a
limit-side-960, /32-aligned resize of the page, extracts text candidates from
the probability map by connected components (prob > 0.3, mean score > 0.6,
axis-aligned unclip grow 0.25), crops each box, resizes crops to height 48
preserving aspect, batches them width-sorted with -1 padding, runs a CTC
recognizer, greedy-decodes (collapse repeats, skip blank 0), and sorts regions
into reading order (same-line when |Δtop| <= 0.6 * mean height -> by left,
else by top).

The detector/recognizer are injected as callables (the native nets of
``crane_tpu_torch.ocr.nets`` on the card, the ONNX graphs, or any
array->array function), while the inherently sequential postprocessing
(flood fill, CTC collapse, ordering) stays in NumPy on the host — the same
split the reference uses (Candle ONNX compute + CPU postproc).

A copy of ``crane_tpu/ocr/pipeline.py``: the port imports nothing of
``crane_tpu``. One change: crane_tpu resizes with PIL, which the machine
with the card lacks, so :func:`_resize` here is PIL's bilinear resampling
of uint8 images written out in NumPy (its fixed-point filter weights and
two passes), byte-equal to PIL's (tests/test_torch_ocr.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass
class OcrRegion:
    left: int
    top: int
    right: int
    bottom: int
    text: str
    confidence: float


@dataclasses.dataclass
class OcrDocument:
    text: str
    regions: list


def load_dictionary(path: str) -> list[str]:
    """CTC label list: index 0 is the blank, then the dict file, then space."""
    with open(path, encoding="utf-8") as f:
        chars = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    return [""] + chars + [" "]


def _round_to_32(value: float) -> int:
    return max(32, int(round(value / 32.0) * 32))


# PIL's fixed-point precision for 8-bit resampling (Resample.c PRECISION_BITS)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for the bilinear filter (support 1),
    normalised to fixed point as ``normalize_coeffs_8bpc`` does: (the first
    source index of each output ``[out]``, integer weights ``[out, k]``)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) / filterscale), 0.0)
        total = w.sum()
        weights[xx, :xmax] = w / total if total != 0.0 else w
        starts[xx] = xmin
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(weights < 0, -0.5 + weights * one, 0.5 + weights * one)
    return starts, np.trunc(fixed).astype(np.int64)


def _resample_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along ``axis`` of an ``[H, W, C]``
    uint8 image: integer sums from half a unit, shifted and clipped."""
    in_size = image.shape[axis]
    starts, weights = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(image, axis, 0).astype(np.int64)
    k = weights.shape[1]
    idx = np.minimum(starts[:, None] + np.arange(k)[None, :], in_size - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k):
        acc += src[idx[:, j]] * weights[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image, as PIL's
    ``Image.resize(..., BILINEAR)`` (Triangle filter, widened when it
    shrinks): the horizontal pass, then the vertical one, each only where
    the size changes."""
    out = np.asarray(image, np.uint8)
    if out.ndim == 2:
        out = out[:, :, None]
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0)
    return out.reshape((height, width) + np.shape(image)[2:])


def detect_preprocess(image: np.ndarray, limit_side: int = 960):
    """Page image [H, W, 3] uint8 -> ImageNet-normalized NCHW f32 input,
    resized so max(side) <= limit_side and both sides are multiples of 32."""
    src_h, src_w = image.shape[:2]
    ratio = min(limit_side / max(src_w, src_h), 1.0)
    width = _round_to_32(src_w * ratio)
    height = _round_to_32(src_h * ratio)
    resized = _resize(image, width, height).astype(np.float32) / 255.0
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    x = (resized - mean) / std
    return x.transpose(2, 0, 1)[None], (width, height)


def db_regions(
    prob_map: np.ndarray,
    resized_size: tuple,
    source_size: tuple,
    *,
    thresh: float = 0.3,
    box_thresh: float = 0.6,
    min_pixels: int = 3,
    grow: float = 0.25,
) -> list:
    """DB detector postprocess: 4-connected components of ``prob > thresh``,
    keep components with mean prob > box_thresh, grow the axis-aligned box by
    ``grow`` per side (unclip_ratio~1.5 approximation) and map to source-image
    pixel coordinates. Returns (left, top, right, bottom, score) tuples."""
    H, W = prob_map.shape
    rw, rh = resized_size
    sw, sh = source_size
    binary = prob_map > thresh
    visited = np.zeros_like(binary, dtype=bool)
    boxes = []
    ys, xs = np.nonzero(binary)
    for seed_y, seed_x in zip(ys.tolist(), xs.tolist()):
        if visited[seed_y, seed_x]:
            continue
        stack = [(seed_x, seed_y)]
        visited[seed_y, seed_x] = True
        x0 = x1 = seed_x
        y0 = y1 = seed_y
        score = 0.0
        count = 0
        while stack:
            cx, cy = stack.pop()
            x0, x1 = min(x0, cx), max(x1, cx)
            y0, y1 = min(y0, cy), max(y1, cy)
            score += float(prob_map[cy, cx])
            count += 1
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                nx, ny = cx + dx, cy + dy
                if 0 <= nx < W and 0 <= ny < H and not visited[ny, nx] and binary[ny, nx]:
                    visited[ny, nx] = True
                    stack.append((nx, ny))
        score /= count
        if count < min_pixels or score < box_thresh:
            continue
        gx = int(np.ceil((x1 - x0 + 1) * grow))
        gy = int(np.ceil((y1 - y0 + 1) * grow))
        x0, y0 = max(0, x0 - gx), max(0, y0 - gy)
        x1, y1 = min(W - 1, x1 + gx), min(H - 1, y1 + gy)
        to_src_x = (sw / rw) * (rw / W)
        to_src_y = (sh / rh) * (rh / H)
        left = int(np.floor(x0 * to_src_x))
        top = int(np.floor(y0 * to_src_y))
        right = min(int(np.ceil((x1 + 1) * to_src_x)), sw)
        bottom = min(int(np.ceil((y1 + 1) * to_src_y)), sh)
        if right > left + 2 and bottom > top + 2:
            boxes.append((left, top, right, bottom, score))
    return boxes


def prepare_crops(image: np.ndarray, boxes: list, *, rec_height: int = 48):
    """Crop each box, resize to the recognizer height preserving aspect,
    BGR-normalize ((x/255 - 0.5)/0.5 — the python reference feeds cv2 BGR),
    and batch width-sorted with -1 padding. Returns (batch NCHW, boxes)."""
    prepared = []
    for box in boxes:
        left, top, right, bottom, score = box
        crop = image[top:bottom, left:right]
        width = max(1, int(crop.shape[1] / crop.shape[0] * rec_height))
        prepared.append((width, crop, box))
    prepared.sort(key=lambda item: item[0])
    max_width = max(width for width, _, _ in prepared)
    batch = np.full((len(prepared), 3, rec_height, max_width), -1.0, np.float32)
    for i, (width, crop, _) in enumerate(prepared):
        resized = _resize(crop, width, rec_height).astype(np.float32)
        normed = (resized / 255.0 - 0.5) / 0.5
        batch[i, :, :, :width] = normed[..., ::-1].transpose(2, 0, 1)  # RGB->BGR
    return batch, [box for _, _, box in prepared]


def ctc_greedy_decode(logits: np.ndarray, dictionary: list) -> tuple:
    """Greedy CTC: per-step argmax, collapse repeats, skip blank index 0.
    Returns (text, mean score of emitted steps)."""
    indices = logits.argmax(-1)
    scores = logits.max(-1)
    text = []
    kept = []
    prev = -1
    for idx, score in zip(indices.tolist(), scores.tolist()):
        if idx != 0 and idx != prev and idx < len(dictionary):
            text.append(dictionary[idx])
            kept.append(score)
        prev = idx
    return "".join(text), (float(np.mean(kept)) if kept else 0.0)


def sort_reading_order(regions: list) -> list:
    """Line-aware ordering: two regions on the same text line (|Δtop| <= 0.6 *
    mean height) order left-to-right, otherwise top-to-bottom."""

    def cmp(a: OcrRegion, b: OcrRegion) -> int:
        avg_h = ((a.bottom - a.top) + (b.bottom - b.top)) / 2.0
        if abs(a.top - b.top) <= avg_h * 0.6:
            return (a.left > b.left) - (a.left < b.left)
        return (a.top > b.top) - (a.top < b.top)

    return sorted(regions, key=functools.cmp_to_key(cmp))


class PaddleOcrPipeline:
    """Detector + recognizer + dictionary -> full-page OCR.

    ``detector``: callable NCHW f32 -> prob map (accepts [1,3,H,W], returns
    [1,1,h,w] or [h,w]). ``recognizer``: callable NCHW f32 -> CTC logits
    [B, T, n_classes]. Both are typically the native nets (ocr/nets.py)."""

    def __init__(self, detector, recognizer, dictionary: list, *, rec_batch_size: int | None = None):
        self.detector = detector
        self.recognizer = recognizer
        self.dictionary = dictionary
        self.rec_batch_size = rec_batch_size

    def detect(self, image: np.ndarray) -> list:
        x, resized = detect_preprocess(image)
        out = np.asarray(self.detector(x))
        prob = out.reshape(out.shape[-2], out.shape[-1])
        return db_regions(prob, resized, (image.shape[1], image.shape[0]))

    def recognize(self, image: np.ndarray) -> OcrDocument:
        image = np.asarray(image)
        boxes = self.detect(image)
        regions = []
        if boxes:
            batch, ordered = prepare_crops(image, boxes)
            step = self.rec_batch_size or len(batch)
            for start in range(0, len(batch), step):
                chunk = batch[start:start + step]
                logits = np.asarray(self.recognizer(chunk))
                for (left, top, right, bottom, det_score), lg in zip(
                    ordered[start:start + step], logits
                ):
                    text, rec_score = ctc_greedy_decode(lg, self.dictionary)
                    if text.strip():
                        regions.append(OcrRegion(
                            left, top, right, bottom, text,
                            min(rec_score, det_score),
                        ))
        regions = sort_reading_order(regions)
        text = "\n".join(r.text for r in regions if r.text.strip())
        return OcrDocument(text=text, regions=regions)


# ---------------------------------------------------------------------------
# Production ONNX checkpoints (reference paddleocr_v6/model.rs:16-18,
# pp-ocrv6_small_{det,rec}.onnx + ppocrv6_dict.txt)

DETECTOR_FILE = "pp-ocrv6_small_det.onnx"
RECOGNIZER_FILE = "pp-ocrv6_small_rec.onnx"
DICTIONARY_FILE = "ppocrv6_dict.txt"


class _OnnxNet:
    """Single-input/single-output ONNX graph as an NCHW callable
    (reference io_names(), model.rs:62-101)."""

    def __init__(self, session):
        self.session = session
        self.input = session.input_names[0]
        self.output = session.output_names[0]

    def __call__(self, x: "np.ndarray"):
        return self.session.run({self.input: np.asarray(x, np.float32)})[self.output]


def load_paddleocr_onnx(model_dir: str, *, rec_batch_size: int | None = 8) -> PaddleOcrPipeline:
    """Load the released PP-OCR v6 ONNX checkpoint directory into the
    pipeline (DB postprocessing, crop batching, CTC decode, reading order
    all run natively around the ONNX forwards — the same split as the
    reference's pipeline.rs around its evaluator)."""
    import os

    from crane_tpu_torch.onnx import Session, read_file

    det_path = os.path.join(model_dir, DETECTOR_FILE)
    rec_path = os.path.join(model_dir, RECOGNIZER_FILE)
    dict_path = os.path.join(model_dir, DICTIONARY_FILE)
    for p in (det_path, rec_path, dict_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"PaddleOCR v6 checkpoint incomplete at {model_dir}: missing "
                f"{os.path.basename(p)} (expected {DETECTOR_FILE}, "
                f"{RECOGNIZER_FILE}, {DICTIONARY_FILE})"
            )
    detector = _OnnxNet(Session(read_file(det_path)))
    recognizer = _OnnxNet(Session(read_file(rec_path)))
    dictionary = load_dictionary(dict_path)
    return PaddleOcrPipeline(
        detector, recognizer, dictionary, rec_batch_size=rec_batch_size
    )
