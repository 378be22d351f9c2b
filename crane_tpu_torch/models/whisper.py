"""Whisper ASR: mel encoder + causal decoder with cross-attention.

Port of ``crane_tpu/models/whisper.py``. The reference's ASR stack is built
on Whisper-style frontends (qwen3_asr/feature_extractor.rs uses the exact
Whisper mel constants); this is the classic Whisper model itself: conv
frontend + sinusoidal positions + bidirectional encoder; token/learned-
position decoder with a self-attention KV cache and cross-attention K/V
computed once per utterance. Greedy transcription with forced decoder ids.
Numerics match HF transformers WhisperForConditionalGeneration.

The convs keep PyTorch's ``[Cout, Cin, k]`` weights (crane_tpu stores WIO).
Every attention here is plain, as in crane_tpu. The decoder's one-token
step, the part a transcription repeats, is one replay of a CUDA graph on
the card (``graphs.dispatch``) over the model's kept self-attention cache
and fixed cross K/V buffers, which each utterance's encoder output is
copied into; the forced prompt runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from crane_tpu_torch.generation.config import TranscribeOptions
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.modules.vision import affine, bidirectional_attention, layer_norm
from crane_tpu_torch.ops.attention import gqa_attention
from crane_tpu_torch.ops.kv_cache import KVCache, LayerKVCache
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    ffn_dim: int = 1536
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _mha_full(cfg, lp, prefix, x, kv_src):
    """Bidirectional MHA over [B,T,E] (encoder self / decoder cross)."""
    B, S, E = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    T = kv_src.shape[1]
    q = affine(x, lp[prefix + "wq"], lp[prefix + "bq"]).reshape(B, S, H, D)
    k = (kv_src @ lp[prefix + "wk"]).reshape(B, T, H, D)
    v = affine(kv_src, lp[prefix + "wv"], lp[prefix + "bv"]).reshape(B, T, H, D)
    o = bidirectional_attention(q, k, v).reshape(B, S, E)
    return affine(o, lp[prefix + "wo"], lp[prefix + "bo"])


def whisper_encode(cfg: WhisperConfig, p: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel ``[B, mels, 2*max_src]`` -> encoder states ``[B, max_src, E]``."""
    x = F.gelu(F.conv1d(mel, p["conv1_w"], p["conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, p["conv2_w"], p["conv2_b"], stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + p["pos_embed"][: x.shape[1]]
    for lp in p["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], 1e-5)
        x = x + _mha_full(cfg, lp, "attn_", h, h)
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], 1e-5)
        h = F.gelu(affine(h, lp["fc1_w"], lp["fc1_b"]))
        x = x + affine(h, lp["fc2_w"], lp["fc2_b"])
    return layer_norm(x, p["ln_post_w"], p["ln_post_b"], 1e-5)


def _decoder_layers(cfg, params, x, cache, positions, cache_positions, enc_kv):
    """The decoder stack over ``x [B, S, E]`` at ``positions [B, S]``, its
    K/V written at ``cache_positions`` (an ``int`` start, or ``[B]`` per
    row; a row outside the buffer writes nothing)."""
    B, S, E = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    new_layers = list(cache.layers)
    for i, lp in enumerate(params["decoder_layers"]):
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], 1e-5)
        q = affine(h, lp["self_wq"], lp["self_bq"]).reshape(B, S, H, D)
        k = (h @ lp["self_wk"]).reshape(B, S, H, D)
        v = affine(h, lp["self_wv"], lp["self_bv"]).reshape(B, S, H, D)
        new_layers[i] = cache.layers[i].update(k, v, cache_positions)
        out = gqa_attention(q, new_layers[i].k, new_layers[i].v, positions, scale=D ** -0.5)
        x = x + affine(out.reshape(B, S, E), lp["self_wo"], lp["self_bo"])

        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], 1e-5)
        ek, ev = enc_kv[i]
        q = affine(h, lp["cross_wq"], lp["cross_bq"]).reshape(B, S, H, D)
        o = bidirectional_attention(q, ek, ev).reshape(B, S, E)
        x = x + affine(o, lp["cross_wo"], lp["cross_bo"])

        h = layer_norm(x, lp["ln3_w"], lp["ln3_b"], 1e-5)
        h = F.gelu(affine(h, lp["fc1_w"], lp["fc1_b"]))
        x = x + affine(h, lp["fc2_w"], lp["fc2_b"])
    x = layer_norm(x, params["decoder_norm_w"], params["decoder_norm_b"], 1e-5)
    return x, KVCache(layers=tuple(new_layers), lengths=cache.lengths + S)


@torch.no_grad()
def encode_kv(cfg: WhisperConfig, params: dict, mel: torch.Tensor):
    """mel -> (encoder states ``[B, T, E]``, the decoder layers' cross K/V,
    each ``[B, T, H, D]``)."""
    enc = whisper_encode(cfg, params["encoder"], mel)
    B, T, _ = enc.shape
    H, D = cfg.num_heads, cfg.head_dim
    enc_kv = tuple(
        ((enc @ lp["cross_wk"]).reshape(B, T, H, D),
         affine(enc, lp["cross_wv"], lp["cross_bv"]).reshape(B, T, H, D))
        for lp in params["decoder_layers"]
    )
    return enc, enc_kv


def decode_logits(cfg: WhisperConfig, params: dict, cache: KVCache, tokens: torch.Tensor,
                  enc_kv, write=None):
    """tokens ``[B, S]`` (the forced prompt, or one step) at the cache's
    lengths -> (the last position's float32 logits ``[B, V]``, the cache
    with ``lengths + S``). Their K/V go to ``write`` (by default the
    lengths for one token, the first row's length for the prompt)."""
    B, S = tokens.shape
    positions = cache.lengths[:, None] + torch.arange(S, dtype=torch.int32,
                                                      device=tokens.device)[None, :]
    x = params["embed"][tokens.long()] + params["dec_pos_embed"][positions.long()]
    if write is None:
        write = cache.lengths if S == 1 else int(cache.lengths[0])
    hidden, cache = _decoder_layers(cfg, params, x, cache, positions, write, enc_kv)
    return (hidden[:, -1] @ params["embed"].T).float(), cache


@torch.no_grad()
def decode_step(cfg: WhisperConfig, params: dict, cache: KVCache, tokens: torch.Tensor, enc_kv):
    """tokens ``[B, S]`` -> (the greedy next token ``[B]`` int32, the
    cache with ``lengths + S``)."""
    logits, cache = decode_logits(cfg, params, cache, tokens, enc_kv)
    return torch.argmax(logits, -1).to(torch.int32), cache


class WhisperModel:
    """The encoder, the decoder, ``transcribe``. The decoder's cache and the
    cross K/V buffers are kept across utterances (so the step captured once
    replays), so calls must not overlap; :meth:`release_graphs` drops them."""

    def __init__(self, config: WhisperConfig, params: dict, *, tokenizer=None,
                 dtype=torch.float32):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = params["embed"].device
        self.mel_config = MelConfig(n_mels=config.num_mel_bins, log_mode="whisper")
        self._programs: dict = {}  # the captured decode step (models/graphs.py)
        self._cache = None
        self._cross: dict = {}  # encoder length -> fixed cross K/V buffers

    def release_graphs(self) -> None:
        """Drop the captured steps, the kept cache and the cross buffers."""
        self._programs.clear()
        self._cache = None
        self._cross.clear()

    def extract_features(self, wav: np.ndarray) -> torch.Tensor:
        """16 kHz waveform -> 30 s padded mel ``[1, mels, 3000]``."""
        n = self.config.max_source_positions * 2 * self.mel_config.hop_length
        wav = np.asarray(wav, np.float32)[:n]
        wav = np.pad(wav, (0, n - len(wav)))
        return log_mel_spectrogram(self.mel_config, torch.as_tensor(wav, device=self.device))[None]

    def _step_body(self, *, layers, enc_len, tokens, lengths, active, out):
        """One greedy step of ``tokens [B]`` over the cache ``layers`` and the
        cross buffers of ``enc_len``: the next tokens into ``out``, the
        active rows' lengths rolled in place (an inactive row writes no KV)."""
        cache = KVCache(layers=layers, lengths=lengths)
        write = torch.where(active, lengths, layers[0].max_seq)
        logits, _ = decode_logits(self.config, self.params, cache, tokens[:, None],
                                  self._cross[enc_len], write)
        out.copy_(torch.argmax(logits, -1))
        lengths.add_(active.to(torch.int32))

    def step(self, cache: KVCache, token: torch.Tensor, enc_len: int):
        """One greedy step ``[B]`` -> ``[B]`` over ``cache`` (lengths rolled
        in place) and the cross buffers of ``enc_len``: a graph replay on
        the card, eager elsewhere and under ``graphs.eager()``."""
        B = token.shape[0]
        inputs = dict(tokens=token, lengths=cache.lengths,
                      active=torch.ones((B,), dtype=torch.bool, device=token.device))
        out = graphs.dispatch(self._programs, token.device, "whisper_step", self._step_body,
                              cache, inputs, {"out": ((B,), torch.int32)},
                              enc_len=enc_len)["out"]
        return out, cache

    def _decoder_cache(self) -> KVCache:
        cfg = self.config
        if self._cache is None:
            self._cache = KVCache(
                layers=tuple(LayerKVCache.empty(1, cfg.max_target_positions, cfg.num_heads,
                                                cfg.head_dim, self.dtype, self.device)
                             for _ in range(cfg.decoder_layers)),
                lengths=torch.zeros((1,), dtype=torch.int32, device=self.device))
        self._cache.lengths.zero_()
        return self._cache

    @torch.no_grad()
    def transcribe_features(self, mel: torch.Tensor, *, forced_ids: Sequence[int] = (),
                            max_new_tokens: int = 128) -> list[int]:
        """Greedy ids from a mel ``[1, mels, 2*T]``, stopping before EOS."""
        cfg = self.config
        enc, enc_kv = encode_kv(cfg, self.params, mel.to(self.dtype))
        cross = graphs.kept_copies(self._cross, enc.shape[1], enc_kv)
        # cache writes past max_target_positions are dropped, which would
        # leave the decoder attending a stale window: cap generation to the
        # positions that actually fit
        max_new_tokens = min(max_new_tokens, cfg.max_target_positions - len(forced_ids) - 2)
        prompt = torch.tensor([[cfg.decoder_start_token_id, *forced_ids]], dtype=torch.int32,
                              device=self.device)
        tok, cache = decode_step(cfg, self.params, self._decoder_cache(), prompt, cross)
        out = []
        while len(out) < max_new_tokens:
            t = int(tok[0])
            if t == cfg.eos_token_id:
                break
            out.append(t)
            if len(out) < max_new_tokens:
                tok, cache = self.step(cache, tok, enc.shape[1])
        return out

    def transcribe_ids(self, wav: np.ndarray, *, forced_ids: Sequence[int] = (),
                       max_new_tokens: int = 128) -> list[int]:
        return self.transcribe_features(self.extract_features(wav), forced_ids=forced_ids,
                                        max_new_tokens=max_new_tokens)

    def transcribe(self, wav: np.ndarray, opts: TranscribeOptions | None = None, **kw) -> str:
        if opts is not None and "max_new_tokens" not in kw:
            kw["max_new_tokens"] = opts.max_new_tokens
        ids = self.transcribe_ids(wav, **kw)
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached")
        return self.tokenizer.decode(ids)


def config_from_hf(hf: dict) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        encoder_layers=hf["encoder_layers"],
        decoder_layers=hf["decoder_layers"],
        num_heads=hf["encoder_attention_heads"],
        ffn_dim=hf["encoder_ffn_dim"],
        num_mel_bins=hf["num_mel_bins"],
        max_source_positions=hf.get("max_source_positions", 1500),
        max_target_positions=hf.get("max_target_positions", 448),
        decoder_start_token_id=hf.get("decoder_start_token_id", 50258),
        eos_token_id=hf.get("eos_token_id", 50257),
    )


def map_whisper_weights(cfg: WhisperConfig, sd: dict, dtype=torch.float32, device=None) -> dict:
    """An HF Whisper state dict (with or without the ``model.`` prefix) ->
    the param tree: linears ``[in, out]``, conv weights as stored."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def t(n):
        return torch.as_tensor(sd[pre + n]).T.contiguous().to(device=device, dtype=dtype)

    def a(n):
        return torch.as_tensor(sd[pre + n]).to(device=device, dtype=dtype)

    def attn(lp, hf_prefix, mine_prefix):
        return {
            mine_prefix + "wq": t(lp + hf_prefix + ".q_proj.weight"),
            mine_prefix + "bq": a(lp + hf_prefix + ".q_proj.bias"),
            mine_prefix + "wk": t(lp + hf_prefix + ".k_proj.weight"),
            mine_prefix + "wv": t(lp + hf_prefix + ".v_proj.weight"),
            mine_prefix + "bv": a(lp + hf_prefix + ".v_proj.bias"),
            mine_prefix + "wo": t(lp + hf_prefix + ".out_proj.weight"),
            mine_prefix + "bo": a(lp + hf_prefix + ".out_proj.bias"),
        }

    def mlp(lp):
        return {"fc1_w": t(lp + "fc1.weight"), "fc1_b": a(lp + "fc1.bias"),
                "fc2_w": t(lp + "fc2.weight"), "fc2_b": a(lp + "fc2.bias")}

    enc_layers = []
    for i in range(cfg.encoder_layers):
        lp = f"encoder.layers.{i}."
        enc_layers.append({
            **attn(lp, "self_attn", "attn_"),
            "ln1_w": a(lp + "self_attn_layer_norm.weight"),
            "ln1_b": a(lp + "self_attn_layer_norm.bias"),
            "ln2_w": a(lp + "final_layer_norm.weight"),
            "ln2_b": a(lp + "final_layer_norm.bias"),
            **mlp(lp),
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        lp = f"decoder.layers.{i}."
        dec_layers.append({
            **attn(lp, "self_attn", "self_"),
            **attn(lp, "encoder_attn", "cross_"),
            "ln1_w": a(lp + "self_attn_layer_norm.weight"),
            "ln1_b": a(lp + "self_attn_layer_norm.bias"),
            "ln2_w": a(lp + "encoder_attn_layer_norm.weight"),
            "ln2_b": a(lp + "encoder_attn_layer_norm.bias"),
            "ln3_w": a(lp + "final_layer_norm.weight"),
            "ln3_b": a(lp + "final_layer_norm.bias"),
            **mlp(lp),
        })
    return {
        "encoder": {
            "conv1_w": a("encoder.conv1.weight"), "conv1_b": a("encoder.conv1.bias"),
            "conv2_w": a("encoder.conv2.weight"), "conv2_b": a("encoder.conv2.bias"),
            "pos_embed": a("encoder.embed_positions.weight"),
            "layers": tuple(enc_layers),
            "ln_post_w": a("encoder.layer_norm.weight"), "ln_post_b": a("encoder.layer_norm.bias"),
        },
        "decoder_layers": tuple(dec_layers),
        "decoder_norm_w": a("decoder.layer_norm.weight"),
        "decoder_norm_b": a("decoder.layer_norm.bias"),
        "embed": a("decoder.embed_tokens.weight"),
        "dec_pos_embed": a("decoder.embed_positions.weight"),
    }


def load_whisper(model_dir: str, *, dtype=torch.float32, device=None) -> WhisperModel:
    """Load an HF Whisper checkpoint onto ``device`` (the card unless the
    caller asks for the CPU)."""
    from crane_tpu_torch.models.auto import load_hf_config, load_state_dict

    device = default_device(device)
    cfg = config_from_hf(load_hf_config(model_dir))
    params = map_whisper_weights(cfg, load_state_dict(model_dir), dtype, device)
    tokenizer = None
    try:
        from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)
    except Exception:
        pass
    return WhisperModel(cfg, params, tokenizer=tokenizer, dtype=dtype)

