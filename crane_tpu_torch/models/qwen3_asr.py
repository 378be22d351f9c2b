"""Qwen3-ASR: the "AuT" chunked-conv audio encoder + Qwen3 LLM backbone.

Port of ``crane_tpu/models/qwen3_asr.py``. Reference behavior (crane-core
``src/models/qwen3_asr/``):

- ``audio_encoder.rs:1-33``: mel frames split into non-overlapping chunks of
  ``n_window*2`` (=100) frames; each chunk independently passes three
  stride-2 3x3 Conv2d+GELU layers (1 -> dhs channels, mel axis 128->16),
  flattens channel-major to ``[tokens, dhs*16]``, projects via bias-free
  ``conv_out`` to d_model, and adds a per-chunk Whisper-style sinusoidal
  positional encoding. Chunk outputs concatenate along time, then
  ``encoder_layers`` pre-norm LayerNorm+GELU transformer blocks run with
  self-attention restricted to independent ``n_window_infer``-frame windows
  (a hard correctness requirement), then ``ln_post``;
- ``modeling.rs:25-60``: MultiModalProjector = linear_1 -> GELU -> linear_2
  (d_model -> output_dim), checkpoint path ``model.multi_modal_projector``;
- ``model.rs:25-37, 106-190``: fixed ChatML prompt with ``<|audio_start|>``
  + N x ``<|audio_pad|>`` + ``<|audio_end|>``, audio embeds spliced over the
  pad positions, greedy AR decode;
- ``feature_extractor.rs``: WhisperFeatureExtractor (n_fft 400, hop 160,
  128 Slaney mels, fmax 8000, log10 + dyn-range norm, no 30 s padding,
  min_length 8000-sample zero-pad).

The chunk dimension is the batch dimension of one 3-conv stack; the convs
are NCHW / OIHW, which is PyTorch's layout already. Token validity and the
window-block mask are built on the host from the mel length. The tower's
attention is plain products and a float32 softmax, as crane_tpu's is plain
XLA. The text side is the shared transformer: the spliced prompt's prefill
runs over the cache (K3), and the greedy decode runs in blocks of 16 steps,
each block one replay of one CUDA graph on the card
(``embeds_decode.greedy_decode_block``; K1 in every step), with EOS checked
on the host once a block, as crane_tpu's ``lax.scan`` block does.
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
    greedy_decode_block,
    splice_prompt,
)
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    make_cache,
    make_rope_tables,
)
from crane_tpu_torch.models.modules.vision import affine, layer_norm
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device

_NEG_INF = torch.finfo(torch.float32).min

# device-side greedy steps per host EOS check (crane_tpu's ``block``)
DECODE_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class AuTConfig:
    """Audio tower config (reference config.rs; 0.6B: d_model 896 / 18
    layers / n_window 50 / n_window_infer 800 / output_dim 1024)."""

    d_model: int = 896
    num_layers: int = 18
    num_heads: int = 14
    ffn_dim: int = 3584
    num_mel_bins: int = 128
    downsample_hidden_size: int = 480
    output_dim: int = 1024
    n_window: int = 50
    n_window_infer: int = 800
    max_source_positions: int = 1500

    @property
    def chunk_frames(self) -> int:
        return self.n_window * 2  # raw mel frames per conv chunk

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def post_conv_mel_bins(self) -> int:
        m = self.num_mel_bins
        for _ in range(3):
            m = _conv_len(m)
        return m

    @property
    def tokens_per_chunk(self) -> int:
        t = self.chunk_frames
        for _ in range(3):
            t = _conv_len(t)
        return t

    @property
    def window_tokens(self) -> int:
        """Attention-window size in tokens (HF: padded-chunk tokens x
        (n_window_infer // chunk_frames))."""
        return self.tokens_per_chunk * (self.n_window_infer // self.chunk_frames)


def _conv_len(n: int) -> int:
    """Output length of one k=3 s=2 p=1 conv."""
    return (n - 1) // 2 + 1


def feat_extract_output_lengths(cfg: AuTConfig, mel_len: int) -> int:
    """Encoder output token count for ``mel_len`` raw mel frames (HF
    _get_feat_extract_output_lengths, generalized to the config chunk)."""
    full, leave = divmod(mel_len, cfg.chunk_frames)
    tail = _conv_len(_conv_len(_conv_len(leave))) if leave else 0
    return full * cfg.tokens_per_chunk + tail


def sinusoid_table(length: int, channels: int) -> np.ndarray:
    """Whisper-style fixed PE: [sin || cos] concatenated (not interleaved)."""
    assert channels % 2 == 0, channels
    log_inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 conv, NCHW / OIHW."""
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride=2, padding=1)


def _attn(cfg: AuTConfig, p: dict, x: torch.Tensor, block_mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional MHA restricted to window blocks. x ``[T, E]``; float32
    logits, masked with the float32 minimum (pad slots see themselves)."""
    T = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    q = affine(x, p["wq"], p["bq"]).reshape(T, H, D)
    k = affine(x, p["wk"], p["bk"]).reshape(T, H, D)
    v = affine(x, p["wv"], p["bv"]).reshape(T, H, D)
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * (D ** -0.5)
    s = torch.where(block_mask[None, :, :], s, _NEG_INF)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("hqk,khd->qhd", a, v).reshape(T, H * D)
    return affine(o, p["wo"], p["bo"])


def aut_encode(
    cfg: AuTConfig,
    p: dict,
    mel: torch.Tensor,
    valid_tokens: torch.Tensor,
    block_mask: torch.Tensor,
) -> torch.Tensor:
    """mel ``[n_chunks, n_mels, chunk_frames]`` (zero-padded tail) ->
    ``[n_chunks * tokens_per_chunk, output_dim]``.

    ``valid_tokens [T]`` bool marks real (non-pad) token slots;
    ``block_mask [T, T]`` is the window-block attention mask (both built on
    the host by :func:`encoder_masks` from the mel length)."""
    x = mel[:, None, :, :]  # [n_chunks, 1, mels, frames]
    x = F.gelu(_conv2d(x, p["conv1_w"], p["conv1_b"]))
    x = F.gelu(_conv2d(x, p["conv2_w"], p["conv2_b"]))
    x = F.gelu(_conv2d(x, p["conv3_w"], p["conv3_b"]))
    # [n, C, mel', t'] -> [n, t', C * mel'] (channel-major flatten, HF order)
    n, c, f, t = x.shape
    x = x.permute(0, 3, 1, 2).reshape(n, t, c * f)
    x = x @ p["conv_out"].to(x.dtype)  # [n, t', d_model], bias-free
    x = x + p["pos_embed"][None, :t, :].to(x.dtype)

    h = x.reshape(n * t, cfg.d_model)
    # zero out pad slots so they contribute nothing through residuals
    h = torch.where(valid_tokens[:, None], h, torch.zeros((), dtype=h.dtype, device=h.device))
    for layer in p["layers"]:
        r = h
        h = layer_norm(h, layer["attn_ln_w"], layer["attn_ln_b"], 1e-5)
        h = r + _attn(cfg, layer, h, block_mask)
        r = h
        h = layer_norm(h, layer["ffn_ln_w"], layer["ffn_ln_b"], 1e-5)
        h = F.gelu(affine(h, layer["fc1_w"], layer["fc1_b"]))
        h = affine(h, layer["fc2_w"], layer["fc2_b"])
        h = r + h
    h = layer_norm(h, p["ln_post_w"], p["ln_post_b"], 1e-5)
    h = F.gelu(affine(h, p["proj1_w"], p["proj1_b"]))
    return affine(h, p["proj2_w"], p["proj2_b"])  # [T, output_dim]


def encoder_masks(cfg: AuTConfig, mel_len: int, n_chunks: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side static masks for ``aut_encode``.

    Valid tokens: per padded chunk slot of ``tokens_per_chunk`` tokens, the
    first ``conv_len^3(chunk_mel_frames)`` are real. Window blocks: real
    tokens are numbered consecutively and grouped into ``window_tokens``
    blocks (HF cu_seqlens); pad slots attend only to themselves (their
    output is discarded)."""
    tpc = cfg.tokens_per_chunk
    T = n_chunks * tpc
    valid = np.zeros(T, np.bool_)
    for ci in range(n_chunks):
        left = mel_len - ci * cfg.chunk_frames
        if left <= 0:
            break
        frames = min(left, cfg.chunk_frames)
        valid[ci * tpc : ci * tpc + _conv_len(_conv_len(_conv_len(frames)))] = True
    block_id = np.full(T, -1, np.int64)
    block_id[valid] = np.arange(valid.sum()) // cfg.window_tokens
    mask = (block_id[:, None] == block_id[None, :]) & valid[:, None] & valid[None, :]
    np.fill_diagonal(mask, True)  # pad slots self-attend (softmax stays finite)
    return valid, mask


class Qwen3AsrModel:
    """AuT encoder + Qwen3 text backbone, transcribe API (model.rs:106-190).

    The parameters' device is the model's. ``generate`` keeps its batch-1
    cache per length across calls (so a second utterance replays the decode
    block the first captured, as a jitted function compiles once), so calls
    on one model must not overlap; :meth:`release_graphs` drops the caches
    and the captured blocks."""

    def __init__(
        self,
        text_config: TransformerConfig,
        audio_config: AuTConfig,
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
        self._programs: dict = {}  # the captured decode blocks (models/graphs.py)
        self._caches: dict = {}

    def release_graphs(self) -> None:
        """Drop the captured decode blocks and the kept caches."""
        self._programs.clear()
        self._caches.clear()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    # -- audio frontend -------------------------------------------------------
    def extract_features(self, wav: np.ndarray) -> tuple[torch.Tensor, int]:
        """16 kHz f32 -> (chunked mel ``[n_chunks, mels, chunk]``, mel_len).
        min_length zero-pad per feature_extractor.rs (0.5 s)."""
        wav = np.asarray(wav, np.float32)
        if len(wav) < 8000:
            wav = np.pad(wav, (0, 8000 - len(wav)))
        mel = log_mel_spectrogram(self.mel_config, self._t(wav))
        mel_len = mel.shape[1]
        ck = self.audio_config.chunk_frames
        n_chunks = -(-mel_len // ck)
        mel = F.pad(mel, (0, n_chunks * ck - mel_len))
        return mel.T.reshape(n_chunks, ck, -1).permute(0, 2, 1), mel_len

    def n_audio_tokens(self, wav_len: int) -> int:
        n = max(wav_len, 8000)
        # centered STFT, whisper drop-last-frame convention
        mel_len = n // self.mel_config.hop_length
        return feat_extract_output_lengths(self.audio_config, mel_len)

    @torch.no_grad()
    def encode_audio(self, wav: np.ndarray) -> torch.Tensor:
        """waveform -> ``[n_tokens, output_dim]`` audio embeddings."""
        mel, mel_len = self.extract_features(wav)
        valid, mask = encoder_masks(self.audio_config, mel_len, mel.shape[0])
        feats = aut_encode(self.audio_config, self.params["audio"], mel.to(self.dtype),
                           self._t(valid), self._t(mask))
        return feats[self._t(np.where(valid)[0]).long()]

    # -- generation -----------------------------------------------------------
    def _cache(self, max_seq: int):
        if max_seq not in self._caches:
            self._caches[max_seq] = make_cache(self.config, 1, max_seq, self.dtype,
                                               device=self.device)
        return self._caches[max_seq]

    @torch.no_grad()
    def prefill(self, input_ids: Sequence[int], feats: Optional[torch.Tensor],
                max_new_tokens: int):
        """The prompt's embeddings with ``feats [n, output_dim]`` spliced
        over its audio tokens, padded to the 64-floor bucket and prefilled
        over the kept cache of ``bucket_length(S + max_new_tokens + 16,
        floor=256)`` slots (a block writes past EOS): (last-token logits
        ``[1, V]`` float32, the cache)."""
        embeds, S = splice_prompt(self.params["embed"], input_ids, self.audio_token_id, feats,
                                  self.dtype)
        cache = self._cache(bucket_length(S + max_new_tokens + DECODE_BLOCK, floor=256))
        return embeds_prefill(self.config, self.params, self.rope, cache, embeds, S)

    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[int],
        wav: Optional[np.ndarray] = None,
        *,
        max_new_tokens: int = 256,
    ) -> list[int]:
        feats = self.encode_audio(wav) if wav is not None else None
        logits, cache = self.prefill(input_ids, feats, max_new_tokens)
        cur = torch.argmax(logits, -1).to(torch.int32)
        out = [int(cur[0])]
        eos = set(self.eos_token_ids)
        while len(out) < max_new_tokens and out[-1] not in eos:
            toks, cache = greedy_decode_block(self._programs, self.config, self.params,
                                              self.rope, cache, cur, DECODE_BLOCK)
            for t in toks[0].tolist():
                out.append(t)
                if t in eos:
                    break
            cur = toks[:, -1]
        if out and out[0] in eos:  # prefill emitted EOS immediately
            return out[:1]
        return out[:max_new_tokens]

    def build_prompt(self, n_audio_tokens: int, context: str = "") -> str:
        """The reference's fixed ASR prompt (model.rs:25-37); ``context``
        fills the system turn (hotwords / style hints)."""
        return (
            f"<|im_start|>system\n{context}<|im_end|>\n<|im_start|>user\n"
            "<|audio_start|>" + "<|audio_pad|>" * n_audio_tokens
            + "<|audio_end|><|im_end|>\n<|im_start|>assistant\n"
        )

    def transcribe(self, wav: np.ndarray, *, context: str = "", **kw) -> str:
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached")
        n = self.n_audio_tokens(len(wav))
        ids = self.tokenizer.encode(self.build_prompt(n, context))
        out = self.generate(ids, wav, **kw)
        eos = set(self.eos_token_ids)
        return self.tokenizer.decode([t for t in out if t not in eos])


def map_aut_weights(cfg: AuTConfig, a_sd: dict, dtype=torch.float32, device=None) -> dict:
    """HF/reference audio-tower state dict (keys relative to the tower:
    conv2d1..3, conv_out, layers.N.*, ln_post) + projector (proj1/proj2 or
    ``_projector.linear_1/linear_2``) -> the tower's param tree: linears
    ``[in, out]``, convs OIHW as stored."""
    def t(n):
        return torch.as_tensor(a_sd[n]).T.contiguous().to(device=device, dtype=dtype)

    def arr(n):
        return torch.as_tensor(a_sd[n]).to(device=device, dtype=dtype)

    def proj(hf_omni: str, hf_asr: str, suffix: str, transpose: bool):
        name = f"{hf_omni}.{suffix}" if f"{hf_omni}.{suffix}" in a_sd else f"{hf_asr}.{suffix}"
        return t(name) if transpose else arr(name)

    layers = []
    for i in range(cfg.num_layers):
        L = f"layers.{i}."
        layers.append({
            "wq": t(L + "self_attn.q_proj.weight"), "bq": arr(L + "self_attn.q_proj.bias"),
            "wk": t(L + "self_attn.k_proj.weight"), "bk": arr(L + "self_attn.k_proj.bias"),
            "wv": t(L + "self_attn.v_proj.weight"), "bv": arr(L + "self_attn.v_proj.bias"),
            "wo": t(L + "self_attn.out_proj.weight"), "bo": arr(L + "self_attn.out_proj.bias"),
            "attn_ln_w": arr(L + "self_attn_layer_norm.weight"),
            "attn_ln_b": arr(L + "self_attn_layer_norm.bias"),
            "ffn_ln_w": arr(L + "final_layer_norm.weight"),
            "ffn_ln_b": arr(L + "final_layer_norm.bias"),
            "fc1_w": t(L + "fc1.weight"), "fc1_b": arr(L + "fc1.bias"),
            "fc2_w": t(L + "fc2.weight"), "fc2_b": arr(L + "fc2.bias"),
        })
    return {
        "conv1_w": arr("conv2d1.weight"), "conv1_b": arr("conv2d1.bias"),
        "conv2_w": arr("conv2d2.weight"), "conv2_b": arr("conv2d2.bias"),
        "conv3_w": arr("conv2d3.weight"), "conv3_b": arr("conv2d3.bias"),
        "conv_out": t("conv_out.weight"),
        "pos_embed": torch.as_tensor(sinusoid_table(cfg.max_source_positions, cfg.d_model))
                          .to(device=device, dtype=dtype),
        "layers": layers,
        "ln_post_w": arr("ln_post.weight"), "ln_post_b": arr("ln_post.bias"),
        "proj1_w": proj("proj1", "_projector.linear_1", "weight", True),
        "proj1_b": proj("proj1", "_projector.linear_1", "bias", False),
        "proj2_w": proj("proj2", "_projector.linear_2", "weight", True),
        "proj2_b": proj("proj2", "_projector.linear_2", "bias", False),
    }


def audio_config_from_hf(hf: dict) -> AuTConfig:
    ac = hf.get("audio_config", hf)
    return AuTConfig(
        d_model=ac.get("d_model", 896),
        num_layers=ac.get("encoder_layers", 18),
        num_heads=ac.get("encoder_attention_heads", 14),
        ffn_dim=ac.get("encoder_ffn_dim", 3584),
        num_mel_bins=ac.get("num_mel_bins", 128),
        downsample_hidden_size=ac.get("downsample_hidden_size", 480),
        output_dim=ac.get("output_dim", 1024),
        n_window=ac.get("n_window", 50),
        n_window_infer=ac.get("n_window_infer", 800),
        max_source_positions=ac.get("max_source_positions", 1500),
    )


def split_state_dict(sd: dict) -> tuple[dict, dict]:
    """(the tower's tensors with the projector under ``_projector.``, the
    language model's under ``model.`` names and ``lm_head.weight``)."""
    def strip(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    lm_prefix = "model.language_model." if any(
        k.startswith("model.language_model.") for k in sd
    ) else "language_model.model."
    text_sd = {"model." + k: v for k, v in strip(lm_prefix).items()}
    for hk in ("lm_head.weight", "language_model.lm_head.weight", "model.lm_head.weight"):
        if hk in sd:
            text_sd["lm_head.weight"] = sd[hk]
            break
    a_sd = strip("model.audio_tower.") or strip("audio_tower.")
    for k, v in (strip("model.multi_modal_projector.") or strip("multi_modal_projector.")).items():
        a_sd["_projector." + k] = v
    return a_sd, text_sd


def load_qwen3_asr(model_dir: str, *, dtype=torch.float32, device=None) -> Qwen3AsrModel:
    """Load a Qwen3-ASR HF checkpoint onto ``device`` (the card unless the
    caller asks for the CPU): audio tower at ``model.audio_tower``,
    projector at ``model.multi_modal_projector``, LLM at
    ``model.language_model`` (reference modeling.rs:84-103)."""
    from crane_tpu_torch.models.auto import (
        load_hf_config,
        load_state_dict,
        map_hf_weights,
        read_eos_ids,
        transformer_config_from_hf,
    )
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    device = default_device(device)
    hf = load_hf_config(model_dir)
    audio_cfg = audio_config_from_hf(hf)
    text_cfg = transformer_config_from_hf(hf.get("text_config", hf))
    a_sd, text_sd = split_state_dict(load_state_dict(model_dir))
    params = map_hf_weights(text_cfg, text_sd, dtype, device)
    params["audio"] = map_aut_weights(audio_cfg, a_sd, dtype, device)

    tok = AutoTokenizer.from_pretrained(model_dir)
    audio_token_id = hf.get("audio_token_id") or tok.token_to_id("<|audio_pad|>")
    return Qwen3AsrModel(
        text_cfg, audio_cfg, params,
        audio_token_id=int(audio_token_id),
        tokenizer=tok,
        eos_token_ids=read_eos_ids(model_dir),
        dtype=dtype,
    )


def init_aut_params(cfg: AuTConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Random audio-tower params at ``cfg`` shapes (benchmarks / dry-runs),
    the tree :func:`map_aut_weights` produces, drawn from numpy's generator
    as crane_tpu's ``init_aut_params`` draws them (the same seed gives the
    same values)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.02):
        return torch.as_tensor(rng.normal(size=shape) * scale).to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    C, d, f = cfg.downsample_hidden_size, cfg.d_model, cfg.ffn_dim
    layers = [
        {
            "wq": r(d, d), "bq": zeros(d), "wk": r(d, d), "bk": zeros(d),
            "wv": r(d, d), "bv": zeros(d), "wo": r(d, d), "bo": zeros(d),
            "attn_ln_w": ones(d), "attn_ln_b": zeros(d),
            "ffn_ln_w": ones(d), "ffn_ln_b": zeros(d),
            "fc1_w": r(d, f), "fc1_b": zeros(f),
            "fc2_w": r(f, d), "fc2_b": zeros(d),
        }
        for _ in range(cfg.num_layers)
    ]
    return {
        "conv1_w": r(C, 1, 3, 3), "conv1_b": zeros(C),
        "conv2_w": r(C, C, 3, 3), "conv2_b": zeros(C),
        "conv3_w": r(C, C, 3, 3), "conv3_b": zeros(C),
        "conv_out": r(C * cfg.post_conv_mel_bins, d),
        "pos_embed": torch.as_tensor(sinusoid_table(cfg.max_source_positions, d))
                          .to(device=device, dtype=dtype),
        "layers": layers,
        "ln_post_w": ones(d), "ln_post_b": zeros(d),
        "proj1_w": r(d, d), "proj1_b": zeros(d),
        "proj2_w": r(d, cfg.output_dim), "proj2_b": zeros(cfg.output_dim),
    }
