"""Moonshine ASR: conv frontend + transformer encoder-decoder.

Port of ``crane_tpu/models/moonshine.py``. Reference behavior (crane-core
``src/models/moonshine_asr/model.rs:6-160``): the reference runs Moonshine
through its vendored ONNX evaluator with explicit per-layer KV-cache I/O;
crane_tpu implements the architecture natively (SURVEY.md §7), and so does
the port: raw 16 kHz waveform -> conv1(k127,s64)+tanh -> groupnorm ->
conv2(k7,s3)+gelu -> conv3(k3,s2)+gelu -> bidirectional encoder (partial
GPT-J rotary) -> causal decoder with cross-attention (encoder K/V computed
once per utterance) and a gated MLP. Numerics match HF transformers
MoonshineForConditionalGeneration.

The convs keep PyTorch's ``[Cout, Cin, k]`` weights (crane_tpu stores WIO).
Every attention is plain, as in crane_tpu. Each greedy step is one replay
of a CUDA graph on the card (``graphs.dispatch``), keyed like crane_tpu's
jit by the encoder length and the cache's slots, over the model's kept
cache and fixed cross K/V buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.generation.config import TranscribeOptions
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.modules.vision import bidirectional_attention
from crane_tpu_torch.ops.attention import gqa_attention
from crane_tpu_torch.ops.kv_cache import KVCache, LayerKVCache
from crane_tpu_torch.ops.rope import apply_rope_embeds, rope_table
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class MoonshineConfig:
    vocab_size: int = 32768
    hidden_size: int = 288
    intermediate_size: int = 1152
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    partial_rotary_factor: float = 0.9
    rope_theta: float = 10000.0
    decoder_start_token_id: int = 1
    eos_token_id: int = 2
    # ~6.5 tokens/sec of audio (reference token_rate heuristic)
    token_rate: float = 6.5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.encoder_heads

    @property
    def rot_dim(self) -> int:
        r = int(self.head_dim * self.partial_rotary_factor)
        return r - (r % 2)


def _rope(x: torch.Tensor, cos_h: torch.Tensor, sin_h: torch.Tensor) -> torch.Tensor:
    """Moonshine uses GPT-J interleaved partial rotary (pairs (2i, 2i+1))."""
    return apply_rope_embeds(x, cos_h, sin_h, mode="interleaved")


def rope_tables(cfg: MoonshineConfig, max_pos: int, device=None):
    return rope_table(cfg.rot_dim, max_pos, theta=cfg.rope_theta, device=device)


def _ln(x, w, eps=1e-5):
    """LayerNorm without a bias, in float32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def encoder_frontend(cfg: MoonshineConfig, p: dict, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, N] -> features [B, T, E] (valid convs, NCW)."""
    x = torch.tanh(F.conv1d(wav[:, None, :], p["conv1_w"], stride=64))
    # GroupNorm(num_groups=1): normalize over (C, T) jointly
    xf = x.float()
    mu = xf.mean(dim=(1, 2), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    x = ((xf - mu) * torch.rsqrt(var + 1e-5) * p["gn_w"].float()[None, :, None]
         + p["gn_b"].float()[None, :, None]).to(x.dtype)
    x = F.gelu(F.conv1d(x, p["conv2_w"], p["conv2_b"], stride=3))
    x = F.gelu(F.conv1d(x, p["conv3_w"], p["conv3_b"], stride=2))
    return x.transpose(1, 2)


def encode(cfg: MoonshineConfig, params: dict, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, N] -> encoder states [B, T, E]."""
    x = encoder_frontend(cfg, params["frontend"], wav)
    B, T, _ = x.shape
    H, D = cfg.encoder_heads, cfg.head_dim
    cos, sin = rope_tables(cfg, T, x.device)
    cos, sin = cos[None].expand(B, T, -1), sin[None].expand(B, T, -1)
    for p in params["encoder_layers"]:
        h = _ln(x, p["ln1"])
        q = _rope((h @ p["attn"]["wq"]).reshape(B, T, H, D), cos, sin)
        k = _rope((h @ p["attn"]["wk"]).reshape(B, T, H, D), cos, sin)
        v = (h @ p["attn"]["wv"]).reshape(B, T, H, D)
        x = x + bidirectional_attention(q, k, v).reshape(B, T, H * D) @ p["attn"]["wo"]
        h = _ln(x, p["ln2"])
        h = F.gelu(h @ p["mlp"]["fc1_w"] + p["mlp"]["fc1_b"])
        x = x + (h @ p["mlp"]["fc2_w"] + p["mlp"]["fc2_b"])
    return _ln(x, params["encoder_norm"])


def _decoder_step_layers(cfg, params, x, cache, positions, cache_positions, enc_kv,
                         rope_cos, rope_sin):
    """The decoder stack; ``enc_kv`` = [(k, v) per layer], precomputed."""
    B, S, _ = x.shape
    H, D = cfg.decoder_heads, cfg.head_dim
    for i, p in enumerate(params["decoder_layers"]):
        h = _ln(x, p["ln1"])
        q = _rope((h @ p["self_attn"]["wq"]).reshape(B, S, H, D), rope_cos, rope_sin)
        k = _rope((h @ p["self_attn"]["wk"]).reshape(B, S, H, D), rope_cos, rope_sin)
        v = (h @ p["self_attn"]["wv"]).reshape(B, S, H, D)
        layer = cache.layers[i].update(k, v, cache_positions)
        out = gqa_attention(q, layer.k, layer.v, positions, scale=D ** -0.5)
        x = x + out.reshape(B, S, H * D) @ p["self_attn"]["wo"]

        h = _ln(x, p["ln2"])
        ek, ev = enc_kv[i]
        q = (h @ p["cross_attn"]["wq"]).reshape(B, S, H, D)
        x = x + bidirectional_attention(q, ek, ev).reshape(B, S, H * D) @ p["cross_attn"]["wo"]

        h = _ln(x, p["ln3"])
        hh, gate = torch.chunk(h @ p["mlp"]["fc1_w"] + p["mlp"]["fc1_b"], 2, dim=-1)
        x = x + ((F.silu(gate) * hh) @ p["mlp"]["fc2_w"] + p["mlp"]["fc2_b"])
    return _ln(x, params["decoder_norm"])


@torch.no_grad()
def encode_and_kv(cfg: MoonshineConfig, params: dict, wav: torch.Tensor):
    """wav -> (encoder states, the decoder layers' cross K/V)."""
    enc = encode(cfg, params, wav)
    B, T, _ = enc.shape
    H, D = cfg.decoder_heads, cfg.head_dim
    enc_kv = tuple(
        ((enc @ p["cross_attn"]["wk"]).reshape(B, T, H, D),
         (enc @ p["cross_attn"]["wv"]).reshape(B, T, H, D))
        for p in params["decoder_layers"]
    )
    return enc, enc_kv


def decode_logits(cfg: MoonshineConfig, params: dict, cache: KVCache, token: torch.Tensor,
                  enc_kv, rope, write=None) -> torch.Tensor:
    """One decoder step of ``token [B]`` at the cache's lengths (its K/V
    written at ``write``, by default the lengths; the lengths are left as
    they are) over the cross K/V and the ``rope`` (cos, sin) tables ->
    float32 logits ``[B, V]``."""
    cos_tab, sin_tab = rope
    pos = cache.lengths[:, None]
    x = params["embed"][token[:, None].long()]
    hidden = _decoder_step_layers(cfg, params, x, cache, pos,
                                  cache.lengths if write is None else write, enc_kv,
                                  cos_tab[pos.long()], sin_tab[pos.long()])
    return (hidden[:, 0] @ params["proj_out"]).float()


class MoonshineModel:
    """transcribe(): greedy AR decode (the reference's ASR default,
    generation/mod.rs:41-62). The decoder cache (per slot count) and the
    cross K/V buffers (per encoder length) are kept across utterances, so
    a captured step replays, and calls must not overlap;
    :meth:`release_graphs` drops them."""

    def __init__(self, config: MoonshineConfig, params: dict, *, tokenizer=None,
                 dtype=torch.float32):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = params["embed"].device
        self._programs: dict = {}  # the captured decode steps (models/graphs.py)
        self._caches: dict = {}  # slots -> the decoder cache
        self._rope: dict = {}  # slots -> the rope tables
        self._cross: dict = {}  # encoder length -> fixed cross K/V buffers

    def release_graphs(self) -> None:
        """Drop the captured steps and the kept caches and buffers."""
        for kept in (self._programs, self._caches, self._rope, self._cross):
            kept.clear()

    def _cache(self, slots: int) -> KVCache:
        cfg = self.config
        if slots not in self._caches:
            self._caches[slots] = KVCache(
                layers=tuple(LayerKVCache.empty(1, slots, cfg.decoder_heads, cfg.head_dim,
                                                self.dtype, self.device)
                             for _ in range(cfg.decoder_layers)),
                lengths=torch.zeros((1,), dtype=torch.int32, device=self.device))
            self._rope[slots] = rope_tables(cfg, slots, self.device)
        self._caches[slots].lengths.zero_()
        return self._caches[slots]

    def _step_body(self, *, layers, enc_len, tokens, lengths, active, out):
        """One greedy step of ``tokens [B]``: the next tokens into ``out``,
        the active rows' lengths rolled in place (an inactive row writes no
        KV)."""
        cache = KVCache(layers=layers, lengths=lengths)
        write = torch.where(active, lengths, layers[0].max_seq)
        logits = decode_logits(self.config, self.params, cache, tokens, self._cross[enc_len],
                               self._rope[layers[0].max_seq], write)
        out.copy_(torch.argmax(logits, -1))
        lengths.add_(active.to(torch.int32))

    def step(self, cache: KVCache, token: torch.Tensor, enc_len: int):
        """One greedy step ``[B]`` -> ``[B]`` (lengths rolled in place): a
        graph replay on the card, eager elsewhere and under
        ``graphs.eager()``."""
        B = token.shape[0]
        inputs = dict(tokens=token, lengths=cache.lengths,
                      active=torch.ones((B,), dtype=torch.bool, device=token.device))
        out = graphs.dispatch(self._programs, token.device, "moonshine_step", self._step_body,
                              cache, inputs, {"out": ((B,), torch.int32)},
                              enc_len=enc_len)["out"]
        return out, cache

    @torch.no_grad()
    def transcribe_ids(self, wav: np.ndarray, opts: TranscribeOptions | None = None) -> list[int]:
        cfg = self.config
        opts = opts or TranscribeOptions()
        wav = np.asarray(wav)
        # the conv frontend (k=127,s=64 -> k=7,s=3 -> k=3,s=2, VALID) needs
        # ~0.9k samples for one output frame: zero-pad sub-56 ms uploads
        if wav.shape[-1] < 1024:
            wav = np.pad(wav, (0, 1024 - wav.shape[-1]))
        wav_t = torch.as_tensor(wav, device=self.device).to(self.dtype)[None]
        enc, enc_kv = encode_and_kv(cfg, self.params, wav_t)
        enc_len = enc.shape[1]
        graphs.kept_copies(self._cross, enc_len, enc_kv)
        max_new = min(opts.max_new_tokens, int(wav.shape[-1] / 16000 * cfg.token_rate) + 8)
        # bucket the decode cache/rope so the per-duration token budget
        # reuses the captured step of its bucket
        cache = self._cache(bucket_length(max_new + 8, floor=64))
        tok = torch.tensor([cfg.decoder_start_token_id], dtype=torch.int32, device=self.device)
        out = []
        for _ in range(max_new):
            tok, cache = self.step(cache, tok, enc_len)
            t = int(tok[0])
            if t == cfg.eos_token_id:
                break
            out.append(t)
        return out

    def transcribe(self, wav: np.ndarray, opts: TranscribeOptions | None = None) -> str:
        ids = self.transcribe_ids(wav, opts)
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached")
        return self.tokenizer.decode(ids)


def config_from_hf(hf: dict) -> MoonshineConfig:
    return MoonshineConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        encoder_layers=hf["encoder_num_hidden_layers"],
        decoder_layers=hf["decoder_num_hidden_layers"],
        encoder_heads=hf["encoder_num_attention_heads"],
        decoder_heads=hf["decoder_num_attention_heads"],
        partial_rotary_factor=hf.get("partial_rotary_factor", 0.9),
        rope_theta=hf.get("rope_theta", 10000.0),
        decoder_start_token_id=hf.get("decoder_start_token_id", 1),
        eos_token_id=hf.get("eos_token_id", 2),
    )


def map_moonshine_weights(cfg: MoonshineConfig, sd: dict, dtype=torch.float32,
                          device=None) -> dict:
    """An HF Moonshine state dict -> the param tree: linears ``[in, out]``,
    conv weights as stored, the GroupNorm affine ``[C]``; ``proj_out`` is
    the embedding's transpose when the checkpoint ties it."""
    def t(n):
        return torch.as_tensor(sd[n]).T.contiguous().to(device=device, dtype=dtype)

    def a(n):
        return torch.as_tensor(sd[n]).to(device=device, dtype=dtype)

    def attn(prefix):
        return {"wq": t(prefix + ".q_proj.weight"), "wk": t(prefix + ".k_proj.weight"),
                "wv": t(prefix + ".v_proj.weight"), "wo": t(prefix + ".o_proj.weight")}

    def mlp(lp):
        return {"fc1_w": t(lp + "mlp.fc1.weight"), "fc1_b": a(lp + "mlp.fc1.bias"),
                "fc2_w": t(lp + "mlp.fc2.weight"), "fc2_b": a(lp + "mlp.fc2.bias")}

    e, d = "model.encoder.", "model.decoder."
    frontend = {
        "conv1_w": a(e + "conv1.weight"),
        "conv2_w": a(e + "conv2.weight"), "conv2_b": a(e + "conv2.bias"),
        "conv3_w": a(e + "conv3.weight"), "conv3_b": a(e + "conv3.bias"),
        "gn_w": a(e + "groupnorm.weight"), "gn_b": a(e + "groupnorm.bias"),
    }
    enc_layers = tuple(
        {"ln1": a(f"{e}layers.{i}.input_layernorm.weight"),
         "ln2": a(f"{e}layers.{i}.post_attention_layernorm.weight"),
         "attn": attn(f"{e}layers.{i}.self_attn"), "mlp": mlp(f"{e}layers.{i}.")}
        for i in range(cfg.encoder_layers))
    dec_layers = tuple(
        {"ln1": a(f"{d}layers.{i}.input_layernorm.weight"),
         "ln2": a(f"{d}layers.{i}.post_attention_layernorm.weight"),
         "ln3": a(f"{d}layers.{i}.final_layernorm.weight"),
         "self_attn": attn(f"{d}layers.{i}.self_attn"),
         "cross_attn": attn(f"{d}layers.{i}.encoder_attn"), "mlp": mlp(f"{d}layers.{i}.")}
        for i in range(cfg.decoder_layers))
    return {
        "frontend": frontend,
        "encoder_layers": enc_layers,
        "encoder_norm": a(e + "layer_norm.weight"),
        "decoder_layers": dec_layers,
        "decoder_norm": a(d + "norm.weight"),
        "embed": a(d + "embed_tokens.weight"),
        "proj_out": t("proj_out.weight" if "proj_out.weight" in sd else d + "embed_tokens.weight"),
    }


def load_moonshine(model_dir: str, *, dtype=torch.float32, device=None) -> MoonshineModel:
    """Load an HF Moonshine checkpoint onto ``device`` (the card unless the
    caller asks for the CPU)."""
    from crane_tpu_torch.models.auto import load_hf_config, load_state_dict

    device = default_device(device)
    cfg = config_from_hf(load_hf_config(model_dir))
    params = map_moonshine_weights(cfg, load_state_dict(model_dir), dtype, device)
    tokenizer = None
    try:
        from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)
    except Exception:
        pass
    return MoonshineModel(cfg, params, tokenizer=tokenizer, dtype=dtype)
