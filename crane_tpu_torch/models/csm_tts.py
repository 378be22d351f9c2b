"""Two-level autoregressive codec TTS (Sesame CSM): a backbone talker and a
per-codebook depth decoder, decoding through the Mimi codec.

Port of ``crane_tpu/models/csm_tts.py``. Reference behavior (crane-core
``src/models/qwen3_tts/modeling.rs``): a talker predicts codebook 0 per
frame and a small depth transformer predicts the remaining codebooks
conditioned on the talker hidden state + code 0 (:259-472, :1327-1490);
frames feed back as the sum of codec embeddings; audio is decoded by the
Mimi codec. transformers' ``CsmForConditionalGeneration`` is the parity
oracle.

The backbone and the depth decoder reuse the shared transformer with custom
embeddings; generation is greedy per frame (codebook-0 EOS stops), as the
reference's generate_speech_codes loop. The backbone's prefill runs over its
cache (K3) and each backbone step is a one-token decode (K1). The depth
decoder recomputes all K positions once per codebook, as crane_tpu does:
K - 1 continuations of K tokens over its K-slot cache from slot 0 (K3 at
S=K). crane_tpu jits the depth frame and the backbone step separately and
reads code 0 on the host each frame; here the frame (the K - 1 depth
recomputes, the summed frame embedding, the backbone step and the next
frame's code-0 argmax) is one replay of one CUDA graph on the card
(``graphs.dispatch``, kind ``csm_frame``), and the host reads the frame's
codes and the next code 0 once a frame, where it checks for EOS. The model
owns the depth cache (rewritten whole by every recompute) and keeps the
backbone cache per length, so calls on one model must not overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    make_cache,
    make_rope_tables,
)
from crane_tpu_torch.ops.kv_cache import KVCache
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class CsmTtsConfig:
    backbone: TransformerConfig
    depth: TransformerConfig
    num_codebooks: int
    audio_vocab_size: int
    text_vocab_size: int
    codebook_eos_token_id: int = 0
    audio_token_id: int = -1
    audio_eos_token_id: int = -1


@torch.no_grad()
def _backbone_prefill(cfg, params, rope, cache, embeds, true_length: int):
    """The bucket-padded prompt ``[1, S_bucket, E]`` from position 0 over
    the cache (K3): (the last real position's hidden ``[E]``, the cache with
    its lengths at ``true_length``)."""
    tokens = torch.zeros(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
    lengths = torch.full((embeds.shape[0],), true_length, dtype=torch.int32,
                         device=embeds.device)
    hidden, cache = forward_hidden(cfg, params, tokens, cache, 0, rope, inputs_embeds=embeds,
                                   true_lengths=lengths)
    cache.lengths = lengths
    return hidden[0, true_length - 1], cache


def _backbone_step(cfg, params, rope, cache, frame_embed, active=None):
    """One backbone step from the summed frame embedding ``[E]`` (K1):
    (hidden ``[E]``, cache)."""
    tokens = torch.zeros((1, 1), dtype=torch.int32, device=frame_embed.device)
    hidden, cache = forward_hidden(cfg, params, tokens, cache, cache.lengths, rope,
                                   inputs_embeds=frame_embed[None, None, :], active=active)
    return hidden[0, 0], cache


def _depth_decode_frame(cfg, K, params, rope, depth_layers, h_last, c0):
    """Codebooks 1..K-1 by full recompute (K is small) over the depth cache.

    Position 0 carries the projected backbone hidden, position i>=1 carries
    code i-1's embedding; position i's logits (head weight i-1) give code
    i. ``c0`` is ``[1]``: a code stays a one-element tensor (indexing with a
    0-dim tensor reads it on the host, which a captured graph cannot).
    Returns the frame's codes ``[K]`` int32 (code 0 first)."""
    Va = params["audio_embed"].shape[0] // K
    proj = params["depth_projector"]
    device = h_last.device

    def embed(code, idx):
        return (params["depth_embed"][code.long() + idx * Va] @ proj)[0]

    seq = torch.zeros((K, proj.shape[1]), dtype=params["depth_embed"].dtype, device=device)
    seq[0] = h_last @ proj
    seq[1] = embed(c0, 0)
    codes = [c0.to(torch.int32)]
    tokens = torch.zeros((1, K), dtype=torch.int32, device=device)
    full = torch.full((1,), K, dtype=torch.int32, device=device)
    for i in range(1, K):
        cache = KVCache(layers=depth_layers, lengths=torch.zeros((1,), dtype=torch.int32,
                                                                  device=device))
        hidden, _ = forward_hidden(cfg, params["depth"], tokens, cache, 0, rope,
                                   inputs_embeds=seq[None], true_lengths=full)
        logits = hidden[0, i] @ params["codebooks_head"][i - 1]
        c_i = torch.argmax(logits).reshape(1).to(torch.int32)
        codes.append(c_i)
        if i + 1 < K:
            seq[i + 1] = embed(c_i, i)
    return torch.cat(codes)


class CsmTtsModel:
    """The backbone, the depth decoder and (optionally) the Mimi codec, on
    the parameters' device."""

    def __init__(self, config: CsmTtsConfig, params: dict, *, codec=None, dtype=torch.float32):
        self.config = config
        self.params = params
        self.codec = codec  # optional MimiCodec for codes -> waveform
        self.dtype = dtype
        self.device = params["lm_head"].device
        self.rope = make_rope_tables(config.backbone, self.device)
        self.depth_rope = make_rope_tables(config.depth, self.device)
        self._programs: dict = {}  # the captured frame programs (models/graphs.py)
        self._caches: dict = {}  # max_seq -> backbone cache
        self._depth_cache = make_cache(config.depth, 1, config.num_codebooks, dtype,
                                       device=self.device)

    def release_graphs(self) -> None:
        """Drop the captured frame programs and the kept backbone caches."""
        self._programs.clear()
        self._caches.clear()

    def frame_embed(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[K]`` -> summed backbone audio embedding ``[E]``."""
        K, Va = self.config.num_codebooks, self.config.audio_vocab_size
        offsets = torch.arange(K, dtype=torch.int64, device=codes.device) * Va
        return self.params["audio_embed"][codes.long() + offsets].sum(dim=0)

    @torch.no_grad()
    def prompt_embeds(self, ids: np.ndarray, audio_context: Optional[np.ndarray]) -> torch.Tensor:
        """Text embeds with voice-clone audio context spliced in: audio-token
        positions carry codec-frame embeddings of the reference audio, the
        audio-EOS position carries the EOS-frame embedding (reference
        voice-clone ICL prompt builders, qwen3_tts/modeling.rs:746-915)."""
        cfg = self.config
        embeds = self.params["text_embed"][torch.as_tensor(ids, device=self.device).long()][None]
        if audio_context is None:
            return embeds
        if self.codec is None:
            raise ValueError("voice cloning needs the codec attached")
        codes = self.codec.encode(np.asarray(audio_context)[None], num_quantizers=cfg.num_codebooks)
        frames = torch.as_tensor(codes[0].T, device=self.device).long()  # [T', K]
        K, Va = cfg.num_codebooks, cfg.audio_vocab_size
        offsets = torch.arange(K, device=self.device) * Va
        frame_embeds = self.params["audio_embed"][frames + offsets].sum(dim=1)
        (pos,) = np.where(ids == cfg.audio_token_id)
        assert len(pos) == frame_embeds.shape[0], (len(pos), frame_embeds.shape)
        embeds = embeds.clone()
        embeds[0, torch.as_tensor(pos, device=self.device)] = frame_embeds.to(embeds.dtype)
        eos_frame = torch.full((K,), cfg.codebook_eos_token_id, device=self.device)
        eos_embed = self.params["audio_embed"][eos_frame + offsets].sum(dim=0)
        (epos,) = np.where(ids == cfg.audio_eos_token_id)
        if len(epos):
            embeds[0, torch.as_tensor(epos, device=self.device)] = eos_embed.to(embeds.dtype)
        return embeds

    def _cache(self, max_seq: int) -> KVCache:
        if max_seq not in self._caches:
            self._caches[max_seq] = make_cache(self.config.backbone, 1, max_seq, self.dtype,
                                               device=self.device)
        return self._caches[max_seq]

    def _frame_body(self, *, layers, h_last, c0, lengths, active, out, h_next):
        """One frame: the depth decoder's codes from (``h_last``, ``c0``),
        the backbone step on their summed embedding (its KV write dropped
        for an inactive row), and the next frame's code 0. ``out`` gets the
        frame's K codes and then the next code 0; ``lengths`` rolls in
        place."""
        cfg = self.config
        K = cfg.num_codebooks
        codes = _depth_decode_frame(cfg.depth, K, self.params, self.depth_rope,
                                    layers[cfg.backbone.num_layers:], h_last, c0)
        cache = KVCache(layers=layers[:cfg.backbone.num_layers], lengths=lengths)
        h, cache = _backbone_step(cfg.backbone, self.params["backbone"], self.rope, cache,
                                  self.frame_embed(codes).to(self.dtype), active)
        out[:K] = codes
        out[K] = torch.argmax(h @ self.params["lm_head"]).to(torch.int32)
        h_next.copy_(h)
        lengths.copy_(cache.lengths)

    def decode_frame(self, cache: KVCache, h_last: torch.Tensor, c0: torch.Tensor):
        """One frame from (``h_last [E]``, code 0 ``[1]`` int32): one replay
        of the frame program on the card (eagerly on the CPU and under
        ``graphs.eager()``). Returns (``[K + 1]`` int32: the frame's codes,
        then the next frame's code 0; the next ``h_last``); the cache's
        lengths roll in place."""
        inputs = dict(h_last=h_last, c0=c0, lengths=cache.lengths,
                      active=torch.ones((1,), dtype=torch.bool, device=self.device))
        both = KVCache(layers=tuple(cache.layers) + tuple(self._depth_cache.layers),
                       lengths=cache.lengths)
        res = graphs.dispatch(self._programs, self.device, "csm_frame", self._frame_body, both,
                              inputs, {"out": ((self.config.num_codebooks + 1,), torch.int32),
                                       "h_next": (tuple(h_last.shape), h_last.dtype)})
        return res["out"], res["h_next"]

    @torch.no_grad()
    def generate_codes(
        self,
        text_ids,
        *,
        audio_context: Optional[np.ndarray] = None,
        max_frames: int = 125,
        stop_on_eos: bool = True,
    ) -> np.ndarray:
        """Greedy frame loop -> audio codes ``[T, K]`` (reference
        generate_speech_codes, modeling.rs:1327-1490). ``audio_context`` is a
        24 kHz reference waveform for voice cloning."""
        cfg = self.config
        K = cfg.num_codebooks
        ids = np.asarray(list(text_ids), np.int32)
        S = len(ids)
        embeds = self.prompt_embeds(ids, audio_context)
        embeds = F.pad(embeds, (0, 0, 0, bucket_length(S, floor=32) - S))
        cache = self._cache(bucket_length(S + max_frames, floor=256))
        cache.lengths.zero_()
        h_last, cache = _backbone_prefill(cfg.backbone, self.params["backbone"], self.rope,
                                          cache, embeds.to(self.dtype), S)
        c0 = torch.argmax(h_last @ self.params["lm_head"]).to(torch.int32).reshape(1)
        c0_host = int(c0[0])
        frames = []
        for _ in range(max_frames):
            if stop_on_eos and c0_host == cfg.codebook_eos_token_id:
                break
            out, h_last = self.decode_frame(cache, h_last, c0)
            vals = out.cpu().numpy()
            frames.append(vals[:K])
            c0, c0_host = out[K:], int(vals[K])
        return np.stack(frames).astype(np.int32) if frames else np.zeros((0, K), np.int32)

    def generate_speech(self, text_ids, *, max_frames: int = 125) -> np.ndarray:
        """text ids -> 24 kHz waveform via the Mimi codec (chunked decode)."""
        codes = self.generate_codes(text_ids, max_frames=max_frames)
        if self.codec is None:
            raise ValueError("no codec attached")
        if codes.shape[0] == 0:
            return np.zeros((0,), np.float32)
        return self.codec.chunked_decode(codes.T[None], chunk=300, overlap=25)[0]


def csm_config_from_hf(hf: dict) -> CsmTtsConfig:
    """CsmTtsConfig from a CSM config.json (with ``depth_decoder_config``)."""
    dd = hf["depth_decoder_config"]

    def tcfg(h, vocab):
        return TransformerConfig(
            vocab_size=vocab,
            hidden_size=h["hidden_size"],
            num_layers=h["num_hidden_layers"],
            num_heads=h["num_attention_heads"],
            num_kv_heads=h.get("num_key_value_heads", h["num_attention_heads"]),
            head_dim=h.get("head_dim") or h["hidden_size"] // h["num_attention_heads"],
            intermediate_size=h["intermediate_size"],
            rms_norm_eps=h.get("rms_norm_eps", 1e-6),
            rope_theta=h.get("rope_theta", 10000.0),
            max_position_embeddings=h.get("max_position_embeddings", 2048),
        )

    return CsmTtsConfig(
        backbone=tcfg(hf, hf["vocab_size"]),
        depth=tcfg(dd, dd["vocab_size"]),
        num_codebooks=hf["num_codebooks"],
        audio_vocab_size=hf["vocab_size"],
        text_vocab_size=hf.get("text_vocab_size", 128256),
        codebook_eos_token_id=hf.get("codebook_eos_token_id", 0),
        audio_token_id=hf.get("audio_token_id", -1),
        audio_eos_token_id=hf.get("audio_eos_token_id", -1),
    )


def map_csm_weights(cfg: CsmTtsConfig, sd: dict, dtype=torch.float32, device=None) -> dict:
    """CsmForConditionalGeneration names (torch tensors) -> the params tree.
    A checkpoint saved with tied codebook embeddings lacks
    ``backbone_model.embed_tokens.embed_audio_tokens.weight``; the depth
    decoder's table stands in for it."""
    from crane_tpu_torch.models.auto import map_hf_weights

    sd = dict(sd)
    if "backbone_model.embed_tokens.embed_audio_tokens.weight" not in sd:
        sd["backbone_model.embed_tokens.embed_audio_tokens.weight"] = sd[
            "depth_decoder.model.embed_tokens.weight"]
    bb_sd = {k.replace("backbone_model.", "model."): v for k, v in sd.items()
             if k.startswith("backbone_model.") and "embed_tokens" not in k}
    bb_sd["model.embed_tokens.weight"] = sd["backbone_model.embed_tokens.embed_audio_tokens.weight"]
    backbone = map_hf_weights(cfg.backbone, bb_sd, dtype, device)
    backbone.pop("lm_head", None)
    dd_sd = {k.replace("depth_decoder.model.", "model."): v for k, v in sd.items()
             if k.startswith("depth_decoder.model.") and "embed_tokens" not in k
             and "projector" not in k}
    dd_sd["model.embed_tokens.weight"] = sd["depth_decoder.model.embed_tokens.weight"]
    depth = map_hf_weights(cfg.depth, dd_sd, dtype, device)
    depth.pop("lm_head", None)

    def a(n):
        return sd[n].to(device=device, dtype=dtype)

    def t(n):
        return sd[n].T.contiguous().to(device=device, dtype=dtype)

    return {
        "backbone": backbone,
        "depth": depth,
        "text_embed": a("embed_text_tokens.weight"),
        "audio_embed": a("backbone_model.embed_tokens.embed_audio_tokens.weight"),
        "depth_embed": a("depth_decoder.model.embed_tokens.weight"),
        "depth_projector": t("depth_decoder.model.inputs_embeds_projector.weight"),
        "lm_head": t("lm_head.weight"),
        # [K-1, hidden, vocab]
        "codebooks_head": a("depth_decoder.codebooks_head.weight"),
    }


def load_csm(model_dir: str, *, dtype=torch.float32, with_codec: bool = False,
             device=None) -> CsmTtsModel:
    """Load a CSM checkpoint directory onto ``device`` (the card unless the
    caller asks for the CPU); with ``with_codec`` the Mimi codec from its
    ``codec_config`` and ``codec_model.*`` tensors (float32)."""
    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict
    from crane_tpu_torch.models.auto import load_hf_config

    device = default_device(device)
    hf = load_hf_config(model_dir)
    cfg = csm_config_from_hf(hf)
    sd = load_state_dict(model_dir)
    params = map_csm_weights(cfg, sd, dtype, device)
    codec = None
    if with_codec:
        from crane_tpu_torch.models.mimi import MimiCodec, map_mimi_weights, mimi_config_from_hf

        ccfg = mimi_config_from_hf(hf["codec_config"])
        codec_sd = {k.replace("codec_model.", ""): v for k, v in sd.items()
                    if k.startswith("codec_model.")}
        codec = MimiCodec(ccfg, map_mimi_weights(ccfg, codec_sd, device=device))
    return CsmTtsModel(cfg, params, codec=codec, dtype=dtype)
