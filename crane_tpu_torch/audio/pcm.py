"""PCM/WAV utilities (reference crane/src/audio/pcm.rs:68-287):
encode/decode WAV (PCM16 + float32), f32<->i16 conversion, linear resampling.
Pure numpy + stdlib struct — no external audio deps.

A copy of ``crane_tpu/audio/pcm.py``: the port imports nothing of
``crane_tpu``.
"""

from __future__ import annotations

import io
import struct

import numpy as np


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(x, np.float32) * 32767.0), -32768, 32767).astype(np.int16)


def i16_to_f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.int16).astype(np.float32) / 32768.0


def encode_wav(samples: np.ndarray, sample_rate: int, *, float32: bool = False) -> bytes:
    """Mono (``[N]``) or multi-channel (``[N, C]``) f32 samples -> WAV bytes."""
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, ch = samples.shape
    if float32:
        fmt, bps, data = 3, 32, samples.astype("<f4").tobytes()
    else:
        fmt, bps, data = 1, 16, f32_to_i16(samples).astype("<i2").tobytes()
    block = ch * bps // 8
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(data)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, fmt, ch, sample_rate,
                          sample_rate * block, block, bps))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)
    return buf.getvalue()


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (mono f32 samples ``[N]``, sample_rate). Multi-channel
    input is averaged to mono (reference load_wav_f32 behavior)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt")
            audio_fmt, ch, rate, _, _, bps = fmt
            if audio_fmt == 1 and bps == 16:
                x = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
            elif audio_fmt == 3 and bps == 32:
                x = np.frombuffer(body, "<f4").astype(np.float32)
            elif audio_fmt == 1 and bps == 8:
                x = (np.frombuffer(body, np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"unsupported WAV format {audio_fmt}/{bps}bit")
            if ch > 1:
                x = x.reshape(-1, ch).mean(axis=1)
            samples = x
        pos += 8 + size + (size & 1)
    if samples is None or fmt is None:
        raise ValueError("no data chunk")
    return samples, fmt[2]


def resample(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resampling (reference pcm.rs resample)."""
    if src_rate == dst_rate:
        return np.asarray(x, np.float32)
    n_out = int(round(len(x) * dst_rate / src_rate))
    t_out = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    return np.interp(t_out, np.arange(len(x)), np.asarray(x, np.float64)).astype(np.float32)


def load_wav_f32(path: str, target_rate: int | None = None) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        x, rate = decode_wav(f.read())
    if target_rate is not None and rate != target_rate:
        x, rate = resample(x, rate, target_rate), target_rate
    return x, rate


def save_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    with open(path, "wb") as f:
        f.write(encode_wav(samples, sample_rate))
