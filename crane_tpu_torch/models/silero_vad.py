"""Voice activity detection: streaming VAD with segment extraction.

Port of ``crane_tpu/models/silero_vad.py``. Reference behavior (crane-core
``src/models/silero_vad/model.rs``): the reference runs the Silero conv-RNN
via its ONNX evaluator and drives a chunked 512/256-sample streaming state
machine (``Vad::segment_audio``) with ``VadConfig`` thresholds (threshold +
hysteresis, min speech/silence durations, speech padding) producing
``Segment``s (model.rs:35-90, 372-440, 703-840; 8 k/16 k sample rates
:18-22).

The probability model is crane_tpu's small native net as an ``nn.Module``
(:class:`VadModel`: rfft features, three-tap SAME convs, one LSTM cell, a
sigmoid head) on the caller's device; the state machine is host Python,
copied as it is (per-chunk control flow, not tensor math), and accepts any
``prob_fn(chunk, state) -> (p, state)``. crane_tpu draws the net's default
weights with ``jax.random``, which the port cannot reproduce: the port
draws them from a seeded ``torch.Generator`` (ROADMAP Queue 3), and
``crane_tpu``'s weights come across through ``utils/bridge.py``. The
released checkpoint's ONNX graph runs through the port's copy of the NumPy
ONNX evaluator (:class:`OnnxVadModel`, :func:`load_silero_onnx`, copied from
``crane_tpu`` as they are: host code, no tensor of the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass
class VadConfig:
    sample_rate: int = 16000  # 8000 or 16000
    threshold: float = 0.5
    neg_threshold_offset: float = 0.15  # hysteresis: neg = threshold - offset
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 100
    speech_pad_ms: int = 30
    window_size_samples: int = 512  # 256 for 8 kHz

    def __post_init__(self):
        if self.sample_rate not in (8000, 16000):
            raise ValueError("sample_rate must be 8000 or 16000")
        if self.sample_rate == 8000 and self.window_size_samples == 512:
            self.window_size_samples = 256

    @property
    def neg_threshold(self) -> float:
        return self.threshold - self.neg_threshold_offset

    def ms_to_samples(self, ms: int) -> int:
        return ms * self.sample_rate // 1000


@dataclasses.dataclass
class Segment:
    start: int  # sample index
    end: int

    def duration_s(self, sample_rate: int) -> float:
        return (self.end - self.start) / sample_rate


# -- native conv+LSTM probability model --------------------------------------


@dataclasses.dataclass(frozen=True)
class VadModelConfig:
    window: int = 512
    n_fft: int = 256
    conv_channels: tuple = (16, 32, 32, 64)
    lstm_hidden: int = 64


class VadModel(torch.nn.Module):
    """The native probability net. ``params`` is the weight tree in the
    port's layout (``convs`` ``[{"w": [Cout, Cin, 3], "b"}]``, ``lstm``
    ``{"wi": [C, 4h], "wh": [h, 4h], "b": [4h]}``, ``head`` ``{"w": [h, 1],
    "b": [1]}``; crane_tpu's tree through
    ``utils.bridge.audio_params_from_jax``); without it the weights are
    drawn from ``torch.Generator().manual_seed(seed)`` at crane_tpu's
    scales (normal, std fan_in ** -0.5; biases zero). Calling the model on
    a chunk ``[window]`` and the LSTM state gives (the speech probability as
    a float, the new state), the contract :class:`Vad` reads."""

    def __init__(self, cfg: VadModelConfig | None = None, params: dict | None = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg = cfg or VadModelConfig()
        n_freq, h = cfg.n_fft // 2 + 1, cfg.lstm_hidden
        chans = (n_freq, *cfg.conv_channels)
        self.convs = torch.nn.ModuleList(
            torch.nn.Conv1d(cin, cout, 3, padding=1) for cin, cout in zip(chans, chans[1:]))
        self.lstm = torch.nn.LSTMCell(chans[-1], h)
        self.head = torch.nn.Linear(h, 1)
        n = torch.arange(cfg.n_fft, dtype=torch.float32)
        self.register_buffer("hann", 0.5 - 0.5 * torch.cos(2 * torch.pi * n / cfg.n_fft),
                             persistent=False)
        self.load_tree(params if params is not None else self._draw(seed))
        self.to(default_device(device))

    def _draw(self, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        cfg = self.cfg
        chans = (cfg.n_fft // 2 + 1, *cfg.conv_channels)
        h = cfg.lstm_hidden

        def normal(*shape, fan_in):
            return torch.randn(*shape, generator=gen) * fan_in ** -0.5

        return {
            "convs": [{"w": normal(cout, cin, 3, fan_in=3 * cin), "b": torch.zeros(cout)}
                      for cin, cout in zip(chans, chans[1:])],
            "lstm": {"wi": normal(chans[-1], 4 * h, fan_in=chans[-1]),
                     "wh": normal(h, 4 * h, fan_in=h), "b": torch.zeros(4 * h)},
            "head": {"w": normal(h, 1, fan_in=h), "b": torch.zeros(1)},
        }

    @torch.no_grad()
    def load_tree(self, params: dict) -> None:
        """Copy a weight tree in the port's layout into the module: the LSTM
        cell's gates are ``x @ wi + h @ wh + b`` (i, f, g, o), its
        ``bias_hh`` zero."""
        for conv, p in zip(self.convs, params["convs"]):
            conv.weight.copy_(p["w"])
            conv.bias.copy_(p["b"])
        self.lstm.weight_ih.copy_(params["lstm"]["wi"].T)
        self.lstm.weight_hh.copy_(params["lstm"]["wh"].T)
        self.lstm.bias_ih.copy_(params["lstm"]["b"])
        self.lstm.bias_hh.zero_()
        self.head.weight.copy_(params["head"]["w"].T)
        self.head.bias.copy_(params["head"]["b"])

    def initial_state(self):
        h = self.cfg.lstm_hidden
        return (torch.zeros(h, device=self.hann.device), torch.zeros(h, device=self.hann.device))

    def probability(self, chunk: torch.Tensor, state) -> tuple[torch.Tensor, tuple]:
        """chunk ``[window]`` -> (speech probability, a 0-d tensor; the new
        LSTM state ``(h, c)``, each ``[hidden]``)."""
        n = self.cfg.n_fft
        frames = chunk.reshape(-1, n // 2)
        # overlapping frames of n with hop n/2
        frames = torch.cat([frames[:-1], frames[1:]], dim=-1)
        spec = torch.fft.rfft(frames * self.hann, dim=-1).abs()  # [T, n_freq]
        x = torch.log1p(spec).T[None]  # [1, n_freq, T]
        for conv in self.convs:
            x = torch.relu(conv(x))
        feat = x[0].mean(dim=1)  # [C]
        h, c = self.lstm(feat, state)
        return torch.sigmoid(self.head(h))[0], (h, c)

    @torch.no_grad()
    def forward(self, chunk: np.ndarray, state):
        p, state = self.probability(
            torch.as_tensor(np.asarray(chunk, np.float32), device=self.hann.device), state)
        return float(p), state


def energy_vad(scale: float = 20.0) -> Callable:
    """Synthetic probability model: sigmoid of RMS energy (test oracle)."""

    def fn(chunk, state):
        rms = float(np.sqrt(np.mean(np.square(np.asarray(chunk, np.float64)))))
        return 1.0 / (1.0 + np.exp(-scale * (rms - 0.1))), state

    return fn


# -- released-checkpoint path (ONNX) -----------------------------------------


class OnnxVadModel:
    """Probability model over the released Silero VAD ONNX graph, evaluated
    by ``crane_tpu_torch.onnx`` (reference model.rs:527-585): per chunk the
    previous chunk's tail (context, 64 samples @16 kHz / 32 @8 kHz) is
    prepended, so the graph sees ``input`` ``[1, context+window]``, plus
    ``sr`` (int64 scalar) and the recurrent ``state`` ``[2, 1, 128]``; the
    graph's first output is the speech probability, the second the next
    state (output order, not names — model.rs:558-576)."""

    def __init__(self, session, sample_rate: int = 16000, state_dim: int | None = None):
        if sample_rate not in (8000, 16000):
            raise ValueError(f"unsupported sample rate {sample_rate}")
        self.session = session
        self.sample_rate = sample_rate
        self.context_size = 64 if sample_rate == 16000 else 32
        ins = list(session.input_names)
        if len(ins) != 3:
            raise ValueError(f"expected 3 graph inputs (input, sr, state), got {ins}")
        self.in_input, self.in_sr, self.in_state = ins
        if state_dim is None:
            # released graph declares state [2, B, 128]; trust its spec
            spec = session.model.graph.input_specs.get(self.in_state)
            state_dim = int(spec[1][-1]) if spec and spec[1][-1] > 0 else 128
        self.state_dim = state_dim

    def initial_state(self):
        return (
            np.zeros((2, 1, self.state_dim), np.float32),
            np.zeros((1, self.context_size), np.float32),
        )

    def __call__(self, chunk: np.ndarray, state):
        st, ctx = state
        x = np.concatenate([ctx, np.asarray(chunk, np.float32)[None]], axis=1)
        out = self.session.run({
            self.in_input: x,
            self.in_sr: np.asarray(self.sample_rate, np.int64),
            self.in_state: st,
        })
        names = self.session.output_names
        prob = float(np.asarray(out[names[0]]).reshape(-1)[0])
        new_state = np.asarray(out[names[1]], np.float32)
        return prob, (new_state, x[:, -self.context_size :])


def load_silero_onnx(path: str, sample_rate: int = 16000) -> OnnxVadModel:
    """Load a released Silero VAD ``model.onnx`` (onnx-community/silero-vad)
    as a ``Vad``-compatible probability model."""
    from crane_tpu_torch.onnx import Session, read_file

    return OnnxVadModel(Session(read_file(path)), sample_rate)


# -- streaming state machine (reference Vad::segment_audio) ------------------


class Vad:
    def __init__(self, config: VadConfig | None = None, model: Optional[Callable] = None):
        self.config = config or VadConfig()
        self.model = model or VadModel()
        self.reset()

    def reset(self):
        self.state = self.model.initial_state() if hasattr(self.model, "initial_state") else None
        self.triggered = False
        self.current_start = 0
        self.temp_end = 0
        self.pos = 0
        self.segments: list[Segment] = []

    def process_chunk(self, chunk: np.ndarray) -> Optional[Segment]:
        """Feed one window; returns a completed Segment when one closes."""
        cfg = self.config
        p, self.state = self.model(chunk, self.state)
        done = None
        if p >= cfg.threshold:
            if not self.triggered:
                self.triggered = True
                self.current_start = max(0, self.pos - cfg.ms_to_samples(cfg.speech_pad_ms))
            self.temp_end = 0
        elif p < cfg.neg_threshold and self.triggered:
            if self.temp_end == 0:
                self.temp_end = self.pos + len(chunk)
            elif self.pos + len(chunk) - self.temp_end >= cfg.ms_to_samples(cfg.min_silence_duration_ms):
                end = self.temp_end + cfg.ms_to_samples(cfg.speech_pad_ms)
                seg = Segment(self.current_start, end)
                if seg.end - seg.start >= cfg.ms_to_samples(cfg.min_speech_duration_ms):
                    self.segments.append(seg)
                    done = seg
                self.triggered = False
                self.temp_end = 0
        self.pos += len(chunk)
        return done

    def flush(self, total_samples: int | None = None) -> Optional[Segment]:
        """Close any in-flight segment at end of stream. ``total_samples``
        clamps the end so zero-padded tail windows can't push it past the
        real audio (and the speech_pad applies as it does mid-stream)."""
        if self.triggered:
            end = self.temp_end if self.temp_end else self.pos
            end += self.config.ms_to_samples(self.config.speech_pad_ms)
            if total_samples is not None:
                end = min(end, total_samples)
            seg = Segment(self.current_start, end)
            self.triggered = False
            if seg.end - seg.start >= self.config.ms_to_samples(
                self.config.min_speech_duration_ms
            ):
                self.segments.append(seg)
                return seg
        return None

    def segment_audio(self, audio: np.ndarray) -> list[Segment]:
        """Whole-file segmentation: chunk, stream, flush."""
        self.reset()
        w = self.config.window_size_samples
        audio = np.asarray(audio, np.float32)
        for i in range(0, len(audio) - w + 1, w):
            self.process_chunk(audio[i : i + w])
        tail = len(audio) % w
        if tail:
            self.process_chunk(np.pad(audio[len(audio) - tail :], (0, w - tail)))
        self.flush(total_samples=len(audio))
        # padded ends from process_chunk are clamped to the real audio too
        self.segments = [
            Segment(s.start, min(s.end, len(audio))) for s in self.segments
        ]
        return self.segments
