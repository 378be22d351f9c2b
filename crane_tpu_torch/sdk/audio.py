"""Audio SDK: the Tts and Asr protocols and their adapters (reference
crane/src/audio/{tts.rs,asr.rs}: audio_info(), generate_speech(...),
transcribe(...), streaming variants; crane-serve holds trait objects of
these).

A copy of ``crane_tpu/sdk/audio.py``: its ASR adapters (``AudioInfo``,
``Transcript``, ``Asr``, ``AsrBase``, ``QWEN3_ASR_LANGUAGES``,
``Qwen3AsrAdapter``, ``MoonshineAsr``) and its TTS adapters (``VoiceInfo``,
``Tts``, ``kokoro_voice_language``, ``VOXTRAL_LANGUAGE_PREFIXES``,
``voxtral_voice_languages``, ``CsmTts``, ``Qwen3Tts``, ``KokoroTts``,
``VoxtralTts``) over the port's models: the port imports nothing of
``crane_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Protocol

import numpy as np

from crane_tpu_torch.generation.config import SpeechOptions, TranscribeOptions


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


@dataclasses.dataclass(frozen=True)
class VoiceInfo:
    """One voice a TTS model can produce, for service discovery
    (reference crane/src/audio/tts.rs:13-27)."""

    name: str
    languages: list[str] = dataclasses.field(default_factory=list)


class Tts(Protocol):
    def audio_info(self) -> AudioInfo: ...

    def voices(self) -> list[VoiceInfo]: ...

    def generate_speech(
        self, text: str, options: SpeechOptions | None = None
    ) -> np.ndarray: ...

    def supports_voice_cloning(self) -> bool: ...


def kokoro_voice_language(name: str) -> str:
    """Kokoro voice names carry a single-character language prefix
    (reference crane/src/audio/tts_kokoro.rs:25-37); unknown -> en."""
    first = name[:1]
    return {
        "a": "en", "b": "en", "e": "es", "f": "fr", "h": "hi",
        "i": "it", "j": "ja", "k": "ko", "p": "pt", "z": "zh",
    }.get(first, "en")


# ISO 639-1 codes used as voice-name prefixes for Voxtral's non-English
# presets (reference crane/src/audio/tts_voxtral.rs:12).
VOXTRAL_LANGUAGE_PREFIXES = ("ar", "de", "es", "fr", "hi", "it", "nl", "pt")


def voxtral_voice_languages(name: str) -> list[str]:
    """Non-English Voxtral presets are named ``<lang>_<style>``; English
    presets have no prefix (reference tts_voxtral.rs:23-27). A naming
    heuristic, not config-derived."""
    prefix = name.split("_", 1)[0]
    return [prefix if prefix in VOXTRAL_LANGUAGE_PREFIXES else "en"]


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


class CsmTts:
    """Tts adapter over the two-level AR codec TTS."""

    def __init__(self, model, tokenizer=None, *, max_frames: int = 1000):
        self.model = model
        self.tokenizer = tokenizer or model.__dict__.get("tokenizer")
        self.max_frames = max_frames

    def audio_info(self) -> AudioInfo:
        sr = 24000
        if self.model.codec is not None:
            sr = self.model.codec.config.sampling_rate
        return AudioInfo(sample_rate=sr)

    def supports_voice_cloning(self) -> bool:
        return self.model.codec is not None

    def voices(self) -> list[VoiceInfo]:
        return []  # CSM voices come from reference audio, not named presets

    def generate_speech(self, text: str, options: SpeechOptions | None = None) -> np.ndarray:
        options = options or SpeechOptions()
        if self.tokenizer is None:
            raise ValueError("TTS adapter needs a text tokenizer")
        ids = self.tokenizer.encode(text)
        max_frames = min(self.max_frames, options.max_new_tokens)
        return self.model.generate_speech(ids, max_frames=max_frames)

    def generate_voice_clone(
        self,
        text: str,
        reference_audio: np.ndarray,
        options: SpeechOptions | None = None,
    ) -> np.ndarray:
        """Clone the voice of ``reference_audio`` (codec-frame ICL context —
        reference generate_voice_clone, qwen3_tts/model.rs:389-480)."""
        options = options or SpeechOptions()
        ids = self.tokenizer.encode(text)
        codes = self.model.generate_codes(
            ids, audio_context=np.asarray(reference_audio, np.float32),
            max_frames=min(self.max_frames, options.max_new_tokens),
        )
        if codes.shape[0] == 0:
            return np.zeros((0,), np.float32)
        return self.model.codec.chunked_decode(codes.T[None], chunk=300, overlap=25)[0]

    def generate_speech_stream(
        self, text: str, options: SpeechOptions | None = None
    ) -> Iterator[np.ndarray]:
        # default single-shot stream (reference TtsStream::once)
        yield self.generate_speech(text, options)


class Qwen3Tts:
    """Tts adapter over the Qwen3-TTS Talker/CodePredictor model, with true
    frame-chunked streaming (reference prepare_streaming/generate_one_frame,
    qwen3_tts/modeling.rs:1497-1658 + chunked decode :1650-1698)."""

    def __init__(self, model, *, stream_frames: int = 25, left_context: int = 25):
        self.model = model
        self.stream_frames = stream_frames
        self.left_context = left_context

    def audio_info(self) -> AudioInfo:
        sr = self.model.decoder.sample_rate if self.model.decoder else 24000
        return AudioInfo(sample_rate=sr)

    def supports_voice_cloning(self) -> bool:
        return self.model.speaker_encoder is not None

    def voices(self) -> list[VoiceInfo]:
        """CustomVoice checkpoints expose their named speakers; each voice
        supports every talker language except "auto" and dialect aliases,
        as ISO codes, sorted (reference tts_qwen3.rs:61-96)."""
        from crane_tpu_torch.models.qwen3_tts import LANGUAGE_NAME_TO_CODE

        s = self.model.sp_tokens
        if not s.speaker_ids:
            return []
        dialects = {v for v in s.spk_is_dialect.values() if isinstance(v, str)}
        langs = sorted(
            LANGUAGE_NAME_TO_CODE.get(n, n)
            for n in s.language_ids
            if n != "auto" and n not in dialects
        )
        return [VoiceInfo(name=n, languages=list(langs)) for n in sorted(s.speaker_ids)]

    def generate_speech(self, text: str, options: SpeechOptions | None = None) -> np.ndarray:
        options = options or SpeechOptions()
        wav, _ = self.model.generate_speech(
            text, options.language or "auto", options.voice, options
        )
        return wav

    def generate_voice_clone(
        self,
        text: str,
        reference_audio: np.ndarray,
        reference_text: str = "",
        options: SpeechOptions | None = None,
    ) -> np.ndarray:
        options = options or SpeechOptions()
        if self.model.speaker_encoder is None:
            raise ValueError("no speaker encoder loaded")
        spk = self.model.speaker_encoder(np.asarray(reference_audio, np.float32))
        ref_codes = self.model.encode_reference(reference_audio)
        ids = self.model.tokenizer.encode(text)
        ref_ids = self.model.tokenizer.encode(reference_text) if reference_text else []
        codes = self.model.generate_voice_clone_codes(
            ids, ref_ids, ref_codes, spk, options.language or "auto", options
        )
        if codes.shape[0] == 0:
            return np.zeros(0, np.float32)
        return self.model.decoder.chunked_decode(codes[None], 300, 25)[0]

    def generate_speech_stream(
        self, text: str, options: SpeechOptions | None = None
    ) -> Iterator[np.ndarray]:
        """Yield PCM chunks as frames are generated: every ``stream_frames``
        talker frames, decode the new frames with ``left_context`` frames of
        warm-up context (trimmed), so audio starts before synthesis ends."""
        options = options or SpeechOptions()
        m = self.model
        ids = m.tokenizer.encode(text)
        state = m.prepare_streaming(ids, options.language or "auto", options.voice, options)
        emitted = 0
        remaining = options.max_new_tokens
        while remaining > 0:
            # one device dispatch per stream chunk (a frame block), instead
            # of one per frame
            out = m.generate_frames(state, self.stream_frames)
            done = out is None or state.finished
            if out is not None:
                remaining -= len(out)
            pending = len(state.codes) - emitted
            if pending > 0:
                ctx = min(self.left_context, emitted)
                chunk = np.asarray(
                    state.codes[emitted - ctx : len(state.codes)], np.int32
                )[None]
                yield m.decoder.decode_chunk(chunk, ctx)[0]
                emitted = len(state.codes)
            if done:
                break


class KokoroTts:
    """Tts adapter over the Kokoro pipeline (reference tts_kokoro.rs)."""

    def __init__(self, model):
        self.model = model

    def audio_info(self) -> AudioInfo:
        from crane_tpu_torch.models.kokoro_tts import SAMPLE_RATE

        return AudioInfo(sample_rate=SAMPLE_RATE)

    def supports_voice_cloning(self) -> bool:
        return False

    def voices(self) -> list[VoiceInfo]:
        return [
            VoiceInfo(name=n, languages=[kokoro_voice_language(n)])
            for n in self.model.available_voices()
        ]

    def generate_speech(self, text: str, options: SpeechOptions | None = None) -> np.ndarray:
        options = options or SpeechOptions()
        wav, _sr = self.model.generate_speech(
            text,
            language=options.language or "en_us",
            voice=options.voice,
            speed=options.speed,
        )
        return wav

    def generate_speech_stream(
        self, text: str, options: SpeechOptions | None = None
    ) -> Iterator[np.ndarray]:
        yield self.generate_speech(text, options)


class VoxtralTts:
    """Tts adapter over Voxtral's 3-stage TTS (reference tts_voxtral.rs)."""

    def __init__(self, model, *, max_frames: int = 250):
        self.model = model
        self.max_frames = max_frames

    def audio_info(self) -> AudioInfo:
        return AudioInfo(sample_rate=self.model.cfg.sample_rate)

    def supports_voice_cloning(self) -> bool:
        return False

    def voices(self) -> list[VoiceInfo]:
        return [
            VoiceInfo(name=n, languages=voxtral_voice_languages(n))
            for n in sorted(self.model.voices)
        ]

    def generate_speech(self, text: str, options: SpeechOptions | None = None) -> np.ndarray:
        options = options or SpeechOptions()
        wav, _sr = self.model.generate_speech(
            text, voice=options.voice,
            max_frames=min(self.max_frames, options.max_new_tokens),
        )
        return wav

    def generate_speech_stream(
        self, text: str, options: SpeechOptions | None = None
    ) -> Iterator[np.ndarray]:
        yield self.generate_speech(text, options)


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
