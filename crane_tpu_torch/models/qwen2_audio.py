"""Audio-conditioned LLM (ASR / audio chat): whisper-style encoder + embed
splicing into a causal LM.

Port of ``crane_tpu/models/qwen2_audio.py``. Reference behavior (crane-core
``src/models/qwen3_asr/``): a Whisper feature extractor (``audio/mel.py``),
an audio encoder over mel frames, audio embeds spliced over
``<|audio_pad|>`` positions in a ChatML prompt, then greedy AR decode
(model.rs:106-190; SURVEY.md §3.6).

Architecture follows Qwen2-Audio (the HF parity oracle): conv(k3,p1)+gelu ->
conv(k3,s2,p1)+gelu -> +sinusoidal positions -> pre-LN bidirectional
transformer -> avg-pool(2) -> layer-norm -> linear projector -> text hidden;
the text model is the shared transformer (qwen2 config). The convs keep
PyTorch's ``[Cout, Cin, k]`` weights (crane_tpu stores WIO); the tower's
attention is plain, as crane_tpu's. The mel is always padded to
``max_mel_frames``, so the tower always sees ``max_source_positions``
positions. The spliced prompt's prefill runs over the cache (K3), and each
greedy step is one replay of a CUDA graph on the card
(``embeds_decode.greedy_decode_step``; K1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from crane_tpu_torch.models.modules.embeds_decode import (
    embeds_prefill,
    greedy_decode_step,
    splice_prompt,
)
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    make_cache,
    make_rope_tables,
)
from crane_tpu_torch.models.modules.vision import affine, bidirectional_attention, layer_norm
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    d_model: int
    num_layers: int
    num_heads: int
    ffn_dim: int
    num_mel_bins: int = 128
    max_source_positions: int = 1500

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def max_mel_frames(self) -> int:
        return self.max_source_positions * 2


def audio_feature_lengths(mel_len: int) -> int:
    """mel frames -> post-pool feature count (HF _get_feat_extract_output_lengths)."""
    feat = (mel_len - 1) // 2 + 1
    return (feat - 2) // 2 + 1


def audio_encode(cfg: AudioEncoderConfig, p: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel ``[B, n_mels, T_mel]`` (padded to max_mel_frames) -> ``[B, T/4, D]``."""
    x = F.gelu(F.conv1d(mel, p["conv1_w"], p["conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, p["conv2_w"], p["conv2_b"], stride=2, padding=1))
    x = x.transpose(1, 2)  # [B, T, E]
    x = x + p["pos_embed"][: x.shape[1]]

    B, T, E = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    for lp in p["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], 1e-5)
        q = affine(h, lp["wq"], lp["bq"]).reshape(B, T, H, D)
        k = (h @ lp["wk"]).reshape(B, T, H, D)
        v = affine(h, lp["wv"], lp["bv"]).reshape(B, T, H, D)
        x = x + affine(bidirectional_attention(q, k, v).reshape(B, T, E), lp["wo"], lp["bo"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], 1e-5)
        h = F.gelu(affine(h, lp["fc1_w"], lp["fc1_b"]))
        x = x + affine(h, lp["fc2_w"], lp["fc2_b"])

    # avg-pool(2) over time, then final norm
    x = x.reshape(B, T // 2, 2, E).mean(dim=2)
    return layer_norm(x, p["ln_post_w"], p["ln_post_b"], 1e-5)


@torch.no_grad()
def encode_project(cfg: AudioEncoderConfig, params: dict, mel: torch.Tensor) -> torch.Tensor:
    """The tower and the projector: mel -> text-hidden audio features."""
    feats = audio_encode(cfg, params["encoder"], mel)
    return affine(feats, params["proj_w"], params["proj_b"])


class AudioLLM:
    """Qwen2-Audio: the tower, its projector and the text model. ``generate``
    keeps its batch-1 cache per length across calls (a second utterance
    replays the step the first captured), so calls must not overlap;
    :meth:`release_graphs` drops the caches and the captured steps."""

    def __init__(
        self,
        text_config: TransformerConfig,
        audio_config: AudioEncoderConfig,
        params: dict,
        *,
        audio_token_id: int,
        tokenizer=None,
        eos_token_ids: Sequence[int] = (),
        dtype=torch.float32,
    ):
        self.config = text_config
        self.audio_config = audio_config
        self.params = params
        self.audio_token_id = audio_token_id
        self.tokenizer = tokenizer
        self.eos_token_ids = tuple(eos_token_ids)
        self.dtype = dtype
        self.device = params["embed"].device
        self.rope = make_rope_tables(text_config, self.device)
        self.mel_config = MelConfig(n_mels=audio_config.num_mel_bins)
        self._programs: dict = {}  # the captured decode step (models/graphs.py)
        self._caches: dict = {}

    def release_graphs(self) -> None:
        """Drop the captured decode steps and the kept caches."""
        self._programs.clear()
        self._caches.clear()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def extract_features(self, wav: np.ndarray) -> tuple[torch.Tensor, int]:
        """16 kHz waveform -> (padded mel ``[1, mels, max_frames]``, mel_len)."""
        mel = log_mel_spectrogram(self.mel_config, self._t(wav, torch.float32))
        mel_len = mel.shape[1]
        maxf = self.audio_config.max_mel_frames
        if mel_len > maxf:
            mel, mel_len = mel[:, :maxf], maxf
        return F.pad(mel, (0, maxf - mel_len))[None], mel_len

    def n_audio_tokens(self, wav_len: int) -> int:
        mel_len = min(wav_len // self.mel_config.hop_length, self.audio_config.max_mel_frames)
        return audio_feature_lengths(mel_len)

    def _cache(self, max_seq: int):
        if max_seq not in self._caches:
            self._caches[max_seq] = make_cache(self.config, 1, max_seq, self.dtype,
                                               device=self.device)
        return self._caches[max_seq]

    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[int],
        wav: Optional[np.ndarray] = None,
        *,
        max_new_tokens: int = 256,
    ) -> list[int]:
        """Greedy decode with audio embeds spliced at audio-token positions."""
        feats = None
        if wav is not None:
            mel, mel_len = self.extract_features(wav)
            n = audio_feature_lengths(mel_len)
            feats = encode_project(self.audio_config, self.params, mel.to(self.dtype))[0, :n]
        return self.generate_from_features(input_ids, feats, max_new_tokens=max_new_tokens)

    @torch.no_grad()
    def prefill(self, input_ids: Sequence[int], feats: Optional[torch.Tensor],
                max_new_tokens: int):
        """The spliced prompt prefilled over the kept cache of
        ``bucket_length(S + max_new_tokens, floor=256)`` slots: (last-token
        logits ``[1, V]`` float32, the cache)."""
        embeds, S = splice_prompt(self.params["embed"], input_ids, self.audio_token_id, feats,
                                  self.dtype)
        cache = self._cache(bucket_length(S + max_new_tokens, floor=256))
        return embeds_prefill(self.config, self.params, self.rope, cache, embeds, S)

    @torch.no_grad()
    def generate_from_features(self, input_ids: Sequence[int], feats: Optional[torch.Tensor],
                               *, max_new_tokens: int = 256) -> list[int]:
        """``generate`` after the tower: the prompt with ``feats`` spliced
        in, prefilled over the cache, then greedy steps to EOS."""
        logits, cache = self.prefill(input_ids, feats, max_new_tokens)
        cur = torch.argmax(logits, -1).to(torch.int32)
        out = []
        while len(out) < max_new_tokens:
            out.append(int(cur[0]))
            if out[-1] in self.eos_token_ids or len(out) == max_new_tokens:
                break
            cur, cache = greedy_decode_step(self._programs, self.config, self.params,
                                            self.rope, cache, cur)
        return out

    @staticmethod
    def build_prompt(n_audio_tokens: int) -> str:
        """The default ChatML transcription prompt (crane_tpu's
        ``transcribe``'s)."""
        return (f"<|im_start|>user\nAudio 1: {'<|AUDIO|>' * n_audio_tokens}\n"
                "Transcribe the audio.<|im_end|>\n<|im_start|>assistant\n")

    def transcribe(self, wav: np.ndarray, prompt_builder=None, **kw) -> str:
        """ChatML ASR prompt (reference model.rs:106-190) -> text."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached")
        n = self.n_audio_tokens(len(wav))
        prompt = (prompt_builder or self.build_prompt)(n)
        ids = self.tokenizer.encode(prompt)
        out = self.generate(ids, wav, **kw)
        return self.tokenizer.decode(out)


def audio_config_from_hf(hf: dict) -> AudioEncoderConfig:
    ac = hf["audio_config"]
    return AudioEncoderConfig(
        d_model=ac["d_model"],
        num_layers=ac["encoder_layers"],
        num_heads=ac["encoder_attention_heads"],
        ffn_dim=ac["encoder_ffn_dim"],
        num_mel_bins=ac.get("num_mel_bins", 128),
        max_source_positions=ac.get("max_source_positions", 1500),
    )


def split_state_dict(sd: dict) -> tuple[dict, dict, dict]:
    """(the tower's tensors, the projector's, the language model's under
    ``model.`` names and ``lm_head.weight``)."""
    def strip(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def under(prefix, fallback):
        return prefix if any(k.startswith(prefix) for k in sd) else fallback

    text_sd = {"model." + k: v for k, v in strip(
        under("model.language_model.", "language_model.model.")).items()}
    for hk in ("lm_head.weight", "language_model.lm_head.weight"):
        if hk in sd:
            text_sd["lm_head.weight"] = sd[hk]
            break
    a_sd = strip(under("model.audio_tower.", "audio_tower."))
    proj_sd = strip(under("model.multi_modal_projector.", "multi_modal_projector."))
    return a_sd, proj_sd, text_sd


def map_audio_weights(cfg: AudioEncoderConfig, a_sd: dict, proj_sd: dict,
                      dtype=torch.float32, device=None) -> dict:
    """The tower's HF tensors -> ``{"encoder": ..., "proj_w", "proj_b"}``:
    linears ``[in, out]``, conv weights ``[Cout, Cin, k]`` as stored."""
    def t(x):
        return torch.as_tensor(x).T.contiguous().to(device=device, dtype=dtype)

    def a(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    layers = []
    for i in range(cfg.num_layers):
        lp = f"layers.{i}."
        layers.append({
            "ln1_w": a(a_sd[lp + "self_attn_layer_norm.weight"]),
            "ln1_b": a(a_sd[lp + "self_attn_layer_norm.bias"]),
            "ln2_w": a(a_sd[lp + "final_layer_norm.weight"]),
            "ln2_b": a(a_sd[lp + "final_layer_norm.bias"]),
            "wq": t(a_sd[lp + "self_attn.q_proj.weight"]),
            "bq": a(a_sd[lp + "self_attn.q_proj.bias"]),
            "wk": t(a_sd[lp + "self_attn.k_proj.weight"]),
            "wv": t(a_sd[lp + "self_attn.v_proj.weight"]),
            "bv": a(a_sd[lp + "self_attn.v_proj.bias"]),
            "wo": t(a_sd[lp + "self_attn.out_proj.weight"]),
            "bo": a(a_sd[lp + "self_attn.out_proj.bias"]),
            "fc1_w": t(a_sd[lp + "fc1.weight"]), "fc1_b": a(a_sd[lp + "fc1.bias"]),
            "fc2_w": t(a_sd[lp + "fc2.weight"]), "fc2_b": a(a_sd[lp + "fc2.bias"]),
        })
    return {
        "encoder": {
            "conv1_w": a(a_sd["conv1.weight"]), "conv1_b": a(a_sd["conv1.bias"]),
            "conv2_w": a(a_sd["conv2.weight"]), "conv2_b": a(a_sd["conv2.bias"]),
            "pos_embed": a(a_sd["embed_positions.weight"]),
            "layers": tuple(layers),
            "ln_post_w": a(a_sd["layer_norm.weight"]), "ln_post_b": a(a_sd["layer_norm.bias"]),
        },
        "proj_w": t(proj_sd["linear.weight"]),
        "proj_b": a(proj_sd["linear.bias"]),
    }


def load_qwen2_audio(model_dir: str, *, dtype=torch.float32, device=None) -> AudioLLM:
    """Load a Qwen2-Audio HF checkpoint onto ``device`` (the card unless the
    caller asks for the CPU)."""
    from crane_tpu_torch.models.auto import (
        load_hf_config,
        load_state_dict,
        map_hf_weights,
        read_eos_ids,
        transformer_config_from_hf,
    )

    device = default_device(device)
    hf = load_hf_config(model_dir)
    audio_cfg = audio_config_from_hf(hf)
    text_cfg = transformer_config_from_hf(hf["text_config"])
    a_sd, proj_sd, text_sd = split_state_dict(load_state_dict(model_dir))
    params = map_hf_weights(text_cfg, text_sd, dtype, device)
    params.update(map_audio_weights(audio_cfg, a_sd, proj_sd, dtype, device))

    tokenizer = None
    try:
        from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)
    except Exception:
        pass
    return AudioLLM(
        text_cfg, audio_cfg, params,
        audio_token_id=hf.get("audio_token_id", hf.get("audio_token_index")),
        tokenizer=tokenizer, eos_token_ids=read_eos_ids(model_dir), dtype=dtype,
    )
