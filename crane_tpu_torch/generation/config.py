"""Generation configuration, mirroring the reference's GenerationConfig
(crane-core ``generation/mod.rs``).

A copy of ``crane_tpu/generation/config.py``: the port imports nothing of
``crane_tpu``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 512
    temperature: float = 0.7
    top_k: int = 0  # 0 = disabled; capped at 64 in-graph like the reference
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    repeat_last_n: int = 64
    do_sample: bool = False
    pad_token_id: int | None = None
    eos_token_ids: tuple[int, ...] = ()
    seed: int = 0
    report_speed: bool = False
    # Qwen chat templates: None lets the template default win (rendered as
    # jinja UNDEFINED — reference autotokenizer.rs:500-506)
    enable_thinking: bool | None = None
    # KV-cache quantization: None (fp), 8 (int8) or 4 (nibble-packed int4 —
    # the reference's CRANE_KV_QUANT long-context lever, qwen3_5/kv_cache.rs)
    kv_quant_bits: int | None = None
    # tokens decoded per device dispatch (lax.scan block; 1 = per-token loop)
    decode_block: int = 8
    # speculative decoding: "ngram" = prompt-lookup drafts (propose the
    # continuation of the last n-gram's previous occurrence, verify all K
    # drafts in ONE forward, emit the accepted prefix). Greedy-only
    # (do_sample=False, repetition_penalty=1.0); other configs fall back to
    # block decode. Not in the reference — a TPU-native extension: one
    # K+1-wide forward reads the weights once, so accepted drafts are
    # nearly free tokens on a bandwidth-bound decode.
    speculative: str | None = None
    spec_k: int = 8       # drafts verified per forward
    spec_ngram: int = 3   # lookup n-gram length

    @staticmethod
    def greedy(max_new_tokens: int = 512, **kw) -> "GenerationConfig":
        return GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False, **kw)


@dataclasses.dataclass
class SpeechOptions:
    """TTS options (reference generation/mod.rs:5-40)."""

    voice: str | None = None
    language: str | None = None
    speed: float = 1.0
    max_new_tokens: int = 2048
    seed: int = 0
    # sampling (vendor Qwen3-TTS defaults: top-k 50 then top-p w/ temperature)
    temperature: float = 0.9
    top_p: float = 1.0
    repetition_penalty: float = 1.05


@dataclasses.dataclass
class TranscribeOptions:
    """ASR options — greedy by default (reference generation/mod.rs:41-62)."""

    language: str | None = None
    context: str | None = None
    max_new_tokens: int = 448
