"""Model factory: pick the right loader from a checkpoint's config.

Port of ``crane_tpu/models/factory.py``. Reference behavior: crane-core's
model detection cascade chooses a backend from the checkpoint contents
(model_factory — SURVEY.md §2.3/§2.9: config fields for safetensors, the
GGUF header for .gguf files). GGUF files route to the GGUF loader; HF
directories dispatch on ``model_type``: multimodal configs to their VLM,
Gemma3n to its own stack, everything else to the shared dense/hybrid causal
LM. Every loader places the model on ``device`` (the card unless the caller
asks for the CPU).
"""

from __future__ import annotations

import os


def detect_model_type(path: str) -> str:
    """'gguf' | the HF config.json model_type."""
    if path.endswith(".gguf") or os.path.isfile(path):
        return "gguf"
    from crane_tpu_torch.models.auto import load_hf_config

    return load_hf_config(path).get("model_type", "llama")


def _pick(kwargs: dict, *names: str) -> dict:
    return {k: v for k, v in kwargs.items() if k in names}


def load_model(path: str, **kwargs):
    """Load whatever lives at ``path`` with the appropriate model class.

    Returns one of: CausalLM (text LMs incl. hybrid GDN/MoE), Qwen3VLModel,
    Gemma3VLModel, Gemma3nLM, PaddleOcrVL, Qwen3AsrModel, AudioLLM
    (Qwen2-Audio), Qwen3TTSModel, or the GGUF-backed CausalLM.
    ``dtype`` and ``device`` go to every loader; the text loaders take their
    other keywords (``quant_bits``, ``max_seq``) too."""
    mt = detect_model_type(path)
    if mt == "gguf":
        from crane_tpu_torch.loaders.gguf_model import from_gguf

        return from_gguf(path, **kwargs)
    if mt == "qwen3_vl":
        from crane_tpu_torch.models.qwen3_vl import load_qwen3_vl

        return load_qwen3_vl(path, **_pick(kwargs, "dtype", "device"))
    if mt == "gemma3":
        from crane_tpu_torch.models.auto import load_hf_config

        if "vision_config" in load_hf_config(path):
            from crane_tpu_torch.models.gemma3_vl import load_gemma3_vl

            return load_gemma3_vl(path, **_pick(kwargs, "dtype", "device"))
    if mt in ("gemma3n", "gemma3n_text"):
        from crane_tpu_torch.models.gemma3n import from_pretrained as g3n

        return g3n(path, **_pick(kwargs, "dtype", "max_seq", "device"))
    if mt in ("paddleocr_vl", "paddleocr"):
        from crane_tpu_torch.models.paddleocr_vl import load_paddleocr_vl

        return load_paddleocr_vl(path, **_pick(kwargs, "dtype", "device"))
    if mt == "qwen3_tts":
        from crane_tpu_torch.models.qwen3_tts import load_qwen3_tts

        return load_qwen3_tts(path, **_pick(kwargs, "dtype", "device"))
    if mt in ("qwen3_asr", "qwen3_omni_moe_asr"):
        from crane_tpu_torch.models.qwen3_asr import load_qwen3_asr

        return load_qwen3_asr(path, **_pick(kwargs, "dtype", "device"))
    if mt == "qwen2_audio":
        from crane_tpu_torch.models.qwen2_audio import load_qwen2_audio

        return load_qwen2_audio(path, **_pick(kwargs, "dtype", "device"))
    from crane_tpu_torch.models.auto import from_pretrained

    return from_pretrained(path, **kwargs)
