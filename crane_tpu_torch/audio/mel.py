"""Log-mel spectrogram frontend.

Port of ``crane_tpu/audio/mel.py``. Reference behavior
(crane-core ``src/models/modules/mel.rs:1-8``,
``qwen3_asr/feature_extractor.rs:1-21``): parameterized Hann-STFT -> Slaney
mel filterbank -> log, with two distinct configs (Whisper-style for ASR:
n_fft 400, hop 160, fmax 8000, log10 + dynamic-range norm, drop last frame;
plain ln for the TTS speaker encoder). Bit-matched against transformers'
WhisperFeatureExtractor in crane_tpu's tests.

The filterbank and the window are numpy (a copy of crane_tpu's, which the
port does not import); the STFT runs in torch on the waveform's device: the
frames are a gather, the spectrum ``torch.fft.rfft`` in float32 (cuFFT on
the card, as XLA's ``rfft`` on the TPU; no Pallas kernel in crane_tpu).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def hertz_to_mel_slaney(freq):
    freq = np.asarray(freq, np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
        mels,
    )


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank
    ``[num_frequency_bins, num_mel_filters]`` (transformers semantics)."""
    mel_min = hertz_to_mel_slaney(min_frequency)
    mel_max = hertz_to_mel_slaney(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= np.expand_dims(enorm, 0)
    return fb.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 128
    sampling_rate: int = 16000
    fmin: float = 0.0
    fmax: float = 8000.0
    # "whisper": log10 + dyn-range clamp + (x+4)/4 + drop last frame
    # "ln": natural log of (mel + eps)
    log_mode: str = "whisper"
    # "power": |X|^2 (Whisper); "magnitude": sqrt(|X|^2 + 1e-9) (the TTS
    # speaker-encoder frontend, reference modules/mel.rs:138-141)
    spectrum: str = "power"
    # reflect-pad amount per side: "fft" = n_fft//2 (torch.stft center);
    # "stft" = (n_fft - hop)/2 (reference compute_mel_spectrogram, :102-104)
    center_pad: str = "fft"

    @functools.cached_property
    def filters(self) -> np.ndarray:
        return mel_filter_bank(
            self.n_fft // 2 + 1, self.n_mels, self.fmin, self.fmax, self.sampling_rate
        )

    @functools.cached_property
    def window(self) -> np.ndarray:
        n = np.arange(self.n_fft)
        return (0.5 - 0.5 * np.cos(2 * np.pi * n / self.n_fft)).astype(np.float32)


def reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of ``np.pad(x, (pad, pad), mode="reflect")`` into ``x [n]``.
    ``jnp.pad`` reflects again where the pad is longer than the signal;
    ``F.pad``'s reflect mode refuses that, so the port gathers."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def log_mel_spectrogram(cfg: MelConfig, waveform: torch.Tensor) -> torch.Tensor:
    """waveform ``[N]`` -> log-mel ``[n_mels, T]`` float32, on the
    waveform's device."""
    pad = cfg.n_fft // 2 if cfg.center_pad == "fft" else (cfg.n_fft - cfg.hop_length) // 2
    device = waveform.device
    x = waveform.float()[torch.as_tensor(reflect_index(waveform.shape[0], pad), device=device)]
    n_frames = 1 + (x.shape[0] - cfg.n_fft) // cfg.hop_length
    idx = (torch.arange(n_frames, device=device)[:, None] * cfg.hop_length
           + torch.arange(cfg.n_fft, device=device)[None, :])
    frames = x[idx] * torch.as_tensor(cfg.window, device=device)
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2  # [T, n_freq]
    if cfg.spectrum == "magnitude":
        spec = torch.sqrt(spec + 1e-9)
    mel = spec @ torch.as_tensor(cfg.filters, device=device)  # [T, n_mels]
    if cfg.log_mode == "whisper":
        log_spec = torch.log10(torch.clamp(mel, min=1e-10)).T  # [n_mels, T]
        log_spec = log_spec[:, :-1]
        log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
        return (log_spec + 4.0) / 4.0
    return torch.log(torch.clamp(mel, min=1e-5)).T
