"""Image preprocessing for Qwen-VL-style models: smart-resize + normalize +
merge-block-major patch extraction.

Reference behavior (crane-core src/models/qwen3_5/processor.rs
:64-202): smart-resize rounds each side to the NEAREST multiple of
patch*merge (not ceil) with pixel-budget clamping, PIL-BICUBIC resampling,
then patches laid out merge-block-major ``(t, h_block, w_block, intra_h,
intra_w, c, t_patch, p_h, p_w)``. Bit-matched to HF Qwen2VLImageProcessor —
the reference's own test strategy uses a positionally-encoded image because
"every summary statistic stays identical while scrambling the image"
(processor.rs:249-316).

A copy of ``crane_tpu/models/image_processing.py`` (it imports no jax): the
port imports nothing of ``crane_tpu``. PIL is imported inside
:func:`preprocess_image` only; the machine with the card has none, and its
callers there hand :func:`patchify` normalized pixel arrays.
"""

from __future__ import annotations

import math

import numpy as np

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> tuple[int, int]:
    """Round to the NEAREST multiple of ``factor``; clamp total pixels."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_image(
    image,
    *,
    patch_size: int = 16,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
    mean=OPENAI_CLIP_MEAN,
    std=OPENAI_CLIP_STD,
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """PIL image (or HxWxC uint8 array) -> (patches ``[S, C*T*P*P]`` f32,
    grid (t, h, w))."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    image = image.convert("RGB")
    w, h = image.size
    rh, rw = smart_resize(
        h, w, factor=patch_size * merge_size,
        min_pixels=min_pixels, max_pixels=max_pixels,
    )
    # PIL BICUBIC == the reference's CatmullRom match (processor.rs:100-104)
    image = image.resize((rw, rh), Image.BICUBIC)
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    arr = arr.transpose(2, 0, 1)  # CHW
    return patchify(arr[None], patch_size, merge_size, temporal_patch_size)


def patchify(
    frames: np.ndarray,  # [T_frames, C, H, W]
    patch_size: int,
    merge_size: int,
    temporal_patch_size: int,
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """Merge-block-major flattened patches (HF _preprocess arrangement)."""
    if frames.shape[0] % temporal_patch_size != 0:
        reps = temporal_patch_size - frames.shape[0] % temporal_patch_size
        frames = np.concatenate([frames, np.repeat(frames[-1:], reps, axis=0)], axis=0)
    T, C, H, W = frames.shape
    grid_t = T // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    patches = frames.reshape(
        grid_t, temporal_patch_size, C,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w, C * temporal_patch_size * patch_size * patch_size
    )
    return flat, (grid_t, grid_h, grid_w)
