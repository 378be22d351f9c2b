"""Audio SDK, speech-recognition half: the Asr protocol and its adapters
(reference crane/src/audio/asr.rs: transcribe(...), streaming variants;
crane-serve holds trait objects of these).

A copy of the ASR half of ``crane_tpu/sdk/audio.py`` (``AudioInfo``,
``Transcript``, ``Asr``, ``AsrBase``, ``QWEN3_ASR_LANGUAGES``,
``Qwen3AsrAdapter``, ``MoonshineAsr``): the port imports nothing of
``crane_tpu``. The speech-synthesis half waits for the TTS models (ROADMAP
Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Protocol

import numpy as np

from crane_tpu_torch.generation.config import TranscribeOptions


@dataclasses.dataclass
class AudioInfo:
    sample_rate: int
    channels: int = 1


@dataclasses.dataclass
class Transcript:
    text: str
    tokens: list[int] = dataclasses.field(default_factory=list)
    language: Optional[str] = None
    is_final: bool = True


class Asr(Protocol):
    def input_sample_rate(self) -> int: ...

    def transcribe(
        self, samples: np.ndarray, options: TranscribeOptions | None = None
    ) -> Transcript: ...


class AsrBase:
    """Default Asr behaviors (reference crane/src/audio/asr.rs:58-90):
    ``transcribe_stream`` wraps ``transcribe`` in a single-item stream
    (AsrStream::once) and ``supported_languages`` is empty service-discovery
    metadata unless a model overrides it."""

    def transcribe_stream(
        self, samples: np.ndarray, options: TranscribeOptions | None = None
    ) -> Iterator[Transcript]:
        yield self.transcribe(samples, options)

    def supported_languages(self) -> list[str]:
        return []


# BCP-47 codes Qwen3-ASR claims per its model card, sorted
# (reference crane/src/audio/asr_qwen3.rs:10-13).
QWEN3_ASR_LANGUAGES = (
    "ar", "cs", "da", "de", "el", "en", "es", "fa", "fi", "fil", "fr", "hi",
    "hu", "id", "it", "ja", "ko", "mk", "ms", "nl", "pl", "pt", "ro", "ru",
    "sv", "th", "tr", "vi", "yue", "zh",
)


class Qwen3AsrAdapter(AsrBase):
    """Asr adapter over Qwen3-ASR (AuT encoder + Qwen3 LLM)."""

    def __init__(self, model):
        self.model = model

    def input_sample_rate(self) -> int:
        return 16000

    def supported_languages(self) -> list[str]:
        return list(QWEN3_ASR_LANGUAGES)

    def transcribe(
        self, samples: np.ndarray, options: TranscribeOptions | None = None
    ) -> Transcript:
        options = options or TranscribeOptions()
        text = self.model.transcribe(
            samples,
            context=options.context or "",
            max_new_tokens=options.max_new_tokens,
        )
        return Transcript(text=text, tokens=[])


class MoonshineAsr(AsrBase):
    """Asr adapter over the Moonshine encoder-decoder."""

    def __init__(self, model):
        self.model = model

    def input_sample_rate(self) -> int:
        return 16000

    def transcribe(
        self, samples: np.ndarray, options: TranscribeOptions | None = None
    ) -> Transcript:
        ids = self.model.transcribe_ids(samples, options)
        text = self.model.tokenizer.decode(ids) if self.model.tokenizer else ""
        return Transcript(text=text, tokens=ids)
