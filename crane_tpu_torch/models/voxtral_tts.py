"""Voxtral TTS: hybrid autoregressive + flow-matching text-to-speech.

Port of ``crane_tpu/models/voxtral_tts.py``. Reference behavior (crane-core
``src/models/voxtral_tts/``): three stages (README.md:6-34) —

1. **LLM backbone** (modeling.rs): Ministral-style decoder (26 layers, GQA
   32/8 of 96, dim 3072, interleaved RoPE theta=1e6) consumes the prompt
   ``[BOS, BEGIN_AUDIO, voice-embeddings..., INST_END, text..., INST,
   BEGIN_AUDIO]`` and then, per audio frame, the summed 37-codebook embedding
   of the previous frame's codes.
2. **Acoustic transformer** (modeling.rs:400-640): 3-layer *bidirectional*
   transformer (no rope, no mask). Per frame it predicts one semantic code
   (greedy over an 8192+2-entry padded head, EMPTY=0 and padding masked) and
   36 acoustic codes by flow matching: 7 Euler steps over a 3-token sequence
   [noise-proj, time-proj, llm-proj] with classifier-free guidance alpha=1.2
   (unconditional branch zeros the llm token), then FSQ quantization
   (clamp to [-1,1], 21 levels, +2 special-token offset).
3. **Codec decoder** (codec.rs): codes -> semantic VQ lookup
   (embedding_sum / cluster_usage) + FSQ dequant -> causal conv (k=3) ->
   4 stages of {ALiBi sliding-window transformer layers (full-width QK norm,
   LayerScale, SwiGLU) + causal transpose-conv upsample} with window sizes
   2<<stage -> causal output conv (k=7) to 240-sample patches -> 24 kHz PCM
   (1920 samples/frame).

The backbone is the port's shared ``forward_hidden`` with ``inputs_embeds``.
Its heads of 96 are a shape no attention kernel takes, so each of its
attention calls runs the plain version and counts in
``attention_block.plain_routes``, as crane_tpu sends them to XLA's
``gqa_attention`` (its Pallas route wants ``D % 128 == 0``). The acoustic
transformer and the codec are plain PyTorch, as they are plain einsums and
convs in crane_tpu. The codec runs in NWC layout; its conv weights are
PyTorch's (``[Cout, Cin, k]``, transposed convs ``[Cin, Cout, k]``, the
checkpoint's own), where crane_tpu keeps WIO and pre-flips the transposed
ones (``utils/bridge.py`` :func:`voxtral_params_from_jax` carries them
across). The reflect padding of a causal conv indexes the input itself: for
a one- or two-frame input the pad is as long as the input, where numpy and
jax reflect again and ``F.pad`` raises (ROADMAP Queue 3).

Generation. crane_tpu jits a frame step (semantic argmax, flow matching,
FSQ, the 37-code embedding sum) and a decode step and reads the semantic code
on the host each frame to stop at END_AUDIO. Here a block of frames (each
the frame step, then the backbone's decode step) is one function
(``_frame_block_body``); on the card it is one replay of one CUDA graph
(``graphs.dispatch``, kind ``voxtral_frames``), on the CPU it runs eagerly,
chosen by device. END_AUDIO is a device flag per frame that the host reads
after the block; a decode step after an END, or after the last allowed frame,
is masked inactive (no KV write, the length stays), so frames past them
change nothing the caller sees, and no decode step runs after the last
allowed frame. Each frame's flow-matching noise is one
``torch.randn(n_acoustic)`` in frame order from the model's generator,
seeded by ``seed`` and registered with the block's graph: not
``jax.random``'s stream (ROADMAP Queue 3). The model keeps one backbone
cache, so the captured blocks read the same buffers every replay: calls on
one model must not overlap.
"""

from __future__ import annotations

import dataclasses
import math

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
from crane_tpu_torch.ops.norm import rms_norm
from crane_tpu_torch.utils.device import default_device

# Prompt special tokens (reference model.rs:22-32, Tekken tokenizer ids)
BOS = 1
BEGIN_AUDIO = 25
INST = 35
INST_END = 36
# Semantic codebook special codes: EMPTY_AUDIO=0, END_AUDIO=1, codes from 2
END_AUDIO_CODE = 1

CFG_ALPHA = 1.2
FLOW_INTERVALS = 7
TIME_EMB_THETA = 10_000.0
BLOCK_FRAMES = 16  # frames a block of generate (one graph replay on the card)


@dataclasses.dataclass(frozen=True)
class AcousticArgs:
    dim: int = 3072
    n_layers: int = 3
    n_heads: int = 24
    n_kv_heads: int = 24
    head_dim: int = 128
    hidden_dim: int = 8192


@dataclasses.dataclass(frozen=True)
class CodecArgs:
    dim: int = 1024
    hidden_dim: int = 4096
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    qk_norm_eps: float = 1e-6
    norm_eps: float = 0.01
    semantic_dim: int = 256
    patch_size: int = 240
    transformer_lengths: tuple = (2, 2, 2, 2)
    conv_kernels: tuple = (3, 4, 4, 4)
    conv_strides: tuple = (1, 2, 2, 2)

    @property
    def samples_per_frame(self) -> int:
        up = 1
        for s in self.conv_strides[1:len(self.transformer_lengths)]:
            up *= s
        return up * self.patch_size

    def window_size(self, stage: int) -> int:
        return 2 << stage


@dataclasses.dataclass(frozen=True)
class VoxtralConfig:
    dim: int = 3072
    n_layers: int = 26
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 96
    hidden_dim: int = 9216
    vocab_size: int = 131072
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    semantic_codebook_size: int = 8192
    n_acoustic: int = 36
    fsq_levels: int = 21
    sample_rate: int = 24_000
    acoustic: AcousticArgs = AcousticArgs()
    codec: CodecArgs = CodecArgs()

    @property
    def semantic_valid_end(self) -> int:
        return self.semantic_codebook_size + 2

    @property
    def semantic_padded(self) -> int:
        return ((self.semantic_valid_end + 127) // 128) * 128

    @property
    def n_codebooks(self) -> int:
        return 1 + self.n_acoustic

    def llm_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.dim,
            num_layers=self.n_layers,
            num_heads=self.n_heads,
            num_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            intermediate_size=self.hidden_dim,
            rms_norm_eps=self.norm_eps,
            rope_theta=self.rope_theta,
            max_position_embeddings=self.max_seq_len,
            rope_mode="interleaved",
            tie_word_embeddings=True,  # logits head unused (semantic head instead)
        )


def codebook_offsets(cfg: VoxtralConfig, device=None) -> torch.Tensor:
    """Start offset of each of the 37 codebooks in the concatenated embedding
    table: semantic (8192+2 entries) then 36 x FSQ (21+2 entries)."""
    sem = cfg.semantic_valid_end
    ac = cfg.fsq_levels + 2
    return torch.tensor([0] + [sem + i * ac for i in range(cfg.n_acoustic)], dtype=torch.int32,
                        device=device)


def embed_frame_codes(table: torch.Tensor, offsets: torch.Tensor,
                      codes: torch.Tensor) -> torch.Tensor:
    """Sum the 37 per-codebook embeddings of one frame: codes ``[..., 37]``
    (local indices) -> ``[..., dim]``."""
    return table[(codes + offsets).long()].sum(dim=-2)


# ---------------------------------------------------------------------------
# Acoustic transformer (bidirectional, 3-token sequences)


def _bidir_layer(p: dict, x: torch.Tensor, *, n_heads: int, head_dim: int,
                 eps: float) -> torch.Tensor:
    """Pre-norm bidirectional attention + SwiGLU (no rope, no mask)."""
    B, S, E = x.shape
    h = rms_norm(x, p["input_ln"], eps=eps)
    q = (h @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (h @ p["wk"]).reshape(B, S, n_heads, head_dim)
    v = (h @ p["wv"]).reshape(B, S, n_heads, head_dim)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * head_dim ** -0.5
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", attn, v).reshape(B, S, n_heads * head_dim)
    x = x + o @ p["wo"]
    h = rms_norm(x, p["post_ln"], eps=eps)
    return x + (F.silu(h @ p["gate"]) * (h @ p["up"])) @ p["down"]


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[cos(t f_i)... sin(t f_i)...]``
    (float32)."""
    half = dim // 2
    inv_freq = torch.exp(
        -math.log(TIME_EMB_THETA) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    angle = t * inv_freq
    return torch.cat([torch.cos(angle), torch.sin(angle)])


def flow_times(device=None) -> torch.Tensor:
    """The Euler steps' times ``i * (1 / FLOW_INTERVALS)`` in float32 ``[7]``."""
    dt = np.float32(1.0 / FLOW_INTERVALS)
    return torch.tensor([np.float32(i) * dt for i in range(FLOW_INTERVALS)], dtype=torch.float32,
                        device=device)


def time_tokens(cfg: VoxtralConfig, p: dict) -> torch.Tensor:
    """Each Euler step's time token ``[7, dim]``: the time embedding in the
    weights' dtype through ``time_proj``. It depends on the weights alone, so
    a model computes it once (:class:`VoxtralTts`)."""
    times = flow_times(p["time_proj"].device)
    emb = torch.stack([time_embedding(t, cfg.acoustic.dim) for t in times])
    return emb.to(p["time_proj"].dtype) @ p["time_proj"]


def predict_semantic_logits(cfg: VoxtralConfig, p: dict, llm_hidden: torch.Tensor) -> torch.Tensor:
    """Masked semantic logits: EMPTY (0) and padding beyond the valid range
    are -inf; greedy argmax over the rest picks the frame's semantic code."""
    logits = (llm_hidden @ p["semantic_head"]).float()
    idx = torch.arange(logits.shape[-1], device=logits.device)
    invalid = (idx == 0) | (idx >= cfg.semantic_valid_end)
    return torch.where(invalid, -torch.inf, logits)


def flow_latent(cfg: VoxtralConfig, p: dict, llm_hidden: torch.Tensor, noise: torch.Tensor,
                tokens: torch.Tensor | None = None) -> torch.Tensor:
    """7 Euler steps of CFG flow matching from ``noise``: the acoustic
    latent ``[36]`` that :func:`fsq_quantize` turns into codes.

    Each step runs the 3-layer bidirectional transformer on a fixed
    ``[2 (cond/uncond), 3 (noise/time/llm), dim]`` batch; the velocity is the
    acoustic head over the normed first position, combined as
    ``alpha * v_cond + (1 - alpha) * v_uncond``. ``tokens`` are the steps'
    time tokens (:func:`time_tokens`), computed here when not given.
    """
    ac = cfg.acoustic
    dt = 1.0 / FLOW_INTERVALS
    if tokens is None:
        tokens = time_tokens(cfg, p)
    tok2 = torch.stack([llm_hidden @ p["llm_proj"], torch.zeros_like(llm_hidden)])  # [2, dim]
    x = noise
    for i in range(FLOW_INTERVALS):
        tok0 = x @ p["input_proj"]
        seq = torch.stack([tok0.expand(2, ac.dim), tokens[i].expand(2, ac.dim), tok2], dim=1)
        for lp in p["layers"]:
            seq = _bidir_layer(lp, seq, n_heads=ac.n_heads, head_dim=ac.head_dim,
                               eps=cfg.norm_eps)
        normed = rms_norm(seq[:, 0], p["norm"], eps=cfg.norm_eps)
        v = normed @ p["acoustic_head"]  # [2, 36]
        v = CFG_ALPHA * v[0] + (1.0 - CFG_ALPHA) * v[1]
        x = x + v * dt
    return x


def flow_match(cfg: VoxtralConfig, p: dict, llm_hidden: torch.Tensor, noise: torch.Tensor,
               tokens: torch.Tensor | None = None) -> torch.Tensor:
    """7 Euler steps of CFG flow matching -> 36 FSQ codes in ``[2, 2+levels)``
    (:func:`flow_latent`, then :func:`fsq_quantize`)."""
    return fsq_quantize(flow_latent(cfg, p, llm_hidden, noise, tokens), cfg.fsq_levels)


def fsq_quantize(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Clamp to [-1, 1], scale to [0, levels-1], round (half to even), +2
    special offset; each step in x's dtype, as crane_tpu's."""
    half = (levels - 1) / 2.0
    return (torch.round(x.clamp(-1.0, 1.0) * half + half) + 2).to(torch.int32)


def fsq_dequantize(codes: torch.Tensor, levels: int) -> torch.Tensor:
    """Inverse of :func:`fsq_quantize` (codes include the +2 offset)."""
    c = (codes - 2).clamp(0, levels - 1).float()
    return c * (2.0 / (levels - 1)) - 1.0


# ---------------------------------------------------------------------------
# Codec decoder


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    return torch.pow(2.0, -8.0 / n_heads * (torch.arange(n_heads, dtype=torch.float32,
                                                          device=device) + 1))


def alibi_sliding_bias(seq_len: int, window: int, slopes: torch.Tensor) -> torch.Tensor:
    """``[H, T, T]`` additive bias: causal + sliding window + per-head linear
    distance penalty ``slope * (j - i)`` (codec.rs:103-129)."""
    i = torch.arange(seq_len, device=slopes.device)[:, None]
    j = torch.arange(seq_len, device=slopes.device)[None, :]
    blocked = j > i
    if window > 0:
        blocked = blocked | (j <= i - window)
    dist = (j - i).float()
    bias = slopes[:, None, None] * dist[None]
    return torch.where(blocked[None], -torch.inf, bias)


def reflect_left_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Indices ``[pad + n]`` of an input of ``n`` rows left-padded by ``pad``
    in numpy's ``reflect`` mode, which reflects again where the pad is as
    long as the input (``[5, 6]`` padded by 2 reads ``[5, 6, 5, 6]``; one row
    repeats). ``F.pad(mode="reflect")`` refuses such a pad."""
    i = torch.arange(-pad, n, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def causal_conv1d_nwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                      stride: int = 1) -> torch.Tensor:
    """Causal conv with REFLECT left padding of (k - stride) (codec.rs:70-89,
    172-180). x ``[B, T, Cin]``; w ``[Cout, Cin, k]``."""
    k = w.shape[-1]
    pad = k - stride
    xc = x.transpose(1, 2)
    if pad > 0:
        xc = xc.index_select(2, reflect_left_index(x.shape[1], pad, x.device))
    if xc.shape[2] < k:  # shorter than the kernel: no output row, as in XLA
        return x.new_zeros((x.shape[0], 0, w.shape[0]))
    return F.conv1d(xc, w, b, stride=stride).transpose(1, 2)


def causal_conv_transpose1d_nwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                                stride: int) -> torch.Tensor:
    """Causal transpose conv with right trim of (k - stride) (codec.rs:217-230).
    x ``[B, T, Cin]``; w ``[Cin, Cout, k]`` (PyTorch's layout). Output
    ``[B, T*stride, Cout]``."""
    k = w.shape[-1]
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride).transpose(1, 2)
    trim = k - stride
    return y[:, : y.shape[1] - trim] if trim > 0 else y


def _codec_layer(p: dict, x: torch.Tensor, bias: torch.Tensor, *, cfg: CodecArgs) -> torch.Tensor:
    """Pre-norm ALiBi attention + LayerScale, pre-norm SwiGLU + LayerScale.
    QK norms apply over the FULL concatenated head width (codec.rs:274-318)."""
    B, T, E = x.shape
    h = rms_norm(x, p["attn_norm"], eps=cfg.norm_eps)
    q = rms_norm(h @ p["wq"], p["q_norm"], eps=cfg.qk_norm_eps)
    k = rms_norm(h @ p["wk"], p["k_norm"], eps=cfg.qk_norm_eps)
    v = h @ p["wv"]
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.n_heads != cfg.n_kv_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * cfg.head_dim ** -0.5
    logits = logits.float() + bias[None]
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", attn, v).reshape(B, T, cfg.n_heads * cfg.head_dim)
    x = x + (o @ p["wo"]) * p["attn_scale"]
    h = rms_norm(x, p["ffn_norm"], eps=cfg.norm_eps)
    ff = (F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
    return x + ff * p["ffn_scale"]


def codec_embed(cfg: VoxtralConfig, p: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, T, 37]`` (+2 offset included) -> latents ``[B, T, 292]``:
    semantic VQ lookup concat FSQ dequant."""
    sem_idx = (codes[..., 0] - 2).clamp(0, p["semantic_codebook"].shape[0] - 1)
    sem = p["semantic_codebook"][sem_idx.long()]
    ac = fsq_dequantize(codes[..., 1:], cfg.fsq_levels).to(sem.dtype)
    return torch.cat([sem, ac], dim=-1)


@torch.no_grad()
def codec_decode(cfg: VoxtralConfig, p: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, n_frames, 37]`` int (with +2 offset) -> PCM ``[B, samples]``."""
    cc = cfg.codec
    x = codec_embed(cfg, p, codes)
    x = causal_conv1d_nwc(x, p["input_conv"]["w"], p["input_conv"]["b"],
                          stride=cc.conv_strides[0])
    slopes = alibi_slopes(cc.n_heads, x.device)
    for s, stage in enumerate(p["stages"]):
        bias = alibi_sliding_bias(x.shape[1], cc.window_size(s), slopes)
        for lp in stage["layers"]:
            x = _codec_layer(lp, x, bias, cfg=cc)
        if stage.get("upsample") is not None:
            up = stage["upsample"]
            x = causal_conv_transpose1d_nwc(x, up["w"], up["b"], stride=cc.conv_strides[s + 1])
    x = causal_conv1d_nwc(x, p["output_conv"]["w"], p["output_conv"]["b"], stride=1)
    B, T, patch = x.shape
    return x.reshape(B, T * patch)


def codec_decode_chunk(cfg: VoxtralConfig, p: dict, chunk_codes: torch.Tensor,
                       context_frames: int) -> torch.Tensor:
    """Decode ``[B, ctx + new, 37]`` and trim the context prefix samples."""
    wav = codec_decode(cfg, p, chunk_codes)
    trim = context_frames * cfg.codec.samples_per_frame
    return wav[:, trim:]


def codec_chunked_decode(cfg: VoxtralConfig, p: dict, codes: torch.Tensor, *, chunk_size: int,
                         left_context: int = 16) -> torch.Tensor:
    """Streaming decode in overlapping chunks; equals full decode when the
    left context covers the causal receptive field (reference: >= 15)."""
    if chunk_size <= 0:
        return codec_decode(cfg, p, codes)
    n = codes.shape[1]
    parts = []
    pos = 0
    while pos < n:
        end = min(pos + chunk_size, n)
        ctx = min(pos, left_context)
        parts.append(codec_decode_chunk(cfg, p, codes[:, pos - ctx:end], ctx))
        pos = end
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# Weight loading / init


def fold_weight_norm(weight_v: np.ndarray, weight_g: np.ndarray) -> np.ndarray:
    """PyTorch weight_norm (dim=0): w = g * v / ||v||, norm over all dims
    except 0 (codec.rs:36-68)."""
    v = np.asarray(weight_v, np.float32)
    g = np.asarray(weight_g, np.float32).reshape(v.shape[0], *([1] * (v.ndim - 1)))
    norm = np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def init_voxtral_params(cfg: VoxtralConfig, seed: int = 0, dtype=torch.float32,
                        device=None) -> dict:
    """Random weights of the full 3-stage stack at crane_tpu's scales
    (linears and convs ``fan_in ** -0.5``, tables 0.02 and 0.1, unit norms,
    LayerScales 0.1, zero biases), drawn in float32 from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless the caller asks for
    the CPU) and cast to ``dtype``; the backbone by
    :func:`~crane_tpu_torch.models.init.init_params` from ``seed + 1``.
    Conv weights are PyTorch's layouts."""
    from crane_tpu_torch.models.init import init_params

    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ac, cc = cfg.acoustic, cfg.codec

    def nrm(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    def lin(i, o):
        return nrm((i, o), i ** -0.5)

    def ac_layer():
        qd, kd = ac.n_heads * ac.head_dim, ac.n_kv_heads * ac.head_dim
        return {
            "wq": lin(ac.dim, qd), "wk": lin(ac.dim, kd), "wv": lin(ac.dim, kd),
            "wo": lin(qd, ac.dim),
            "input_ln": full(ac.dim, 1.0), "post_ln": full(ac.dim, 1.0),
            "gate": lin(ac.dim, ac.hidden_dim), "up": lin(ac.dim, ac.hidden_dim),
            "down": lin(ac.hidden_dim, ac.dim),
        }

    def codec_layer():
        qd, kd = cc.n_heads * cc.head_dim, cc.n_kv_heads * cc.head_dim
        return {
            "wq": lin(cc.dim, qd), "wk": lin(cc.dim, kd), "wv": lin(cc.dim, kd),
            "wo": lin(qd, cc.dim),
            "q_norm": full(qd, 1.0), "k_norm": full(kd, 1.0),
            "attn_norm": full(cc.dim, 1.0), "ffn_norm": full(cc.dim, 1.0),
            "attn_scale": full(cc.dim, 0.1), "ffn_scale": full(cc.dim, 0.1),
            "w1": lin(cc.dim, cc.hidden_dim), "w2": lin(cc.hidden_dim, cc.dim),
            "w3": lin(cc.dim, cc.hidden_dim),
        }

    def conv(k, cin, cout, transposed=False):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        return {"w": nrm(shape, (k * cin) ** -0.5), "b": full(cout, 0.0)}

    n_stages = len(cc.transformer_lengths)
    stages = []
    for s in range(n_stages):
        stage = {"layers": tuple(codec_layer() for _ in range(cc.transformer_lengths[s]))}
        stage["upsample"] = (conv(cc.conv_kernels[s + 1], cc.dim, cc.dim, transposed=True)
                             if s < n_stages - 1 else None)
        stages.append(stage)

    sem = cfg.semantic_valid_end
    acsz = cfg.fsq_levels + 2
    table_rows = sem + cfg.n_acoustic * acsz
    embed_dim = cc.semantic_dim + cfg.n_acoustic

    llm_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return {
        "llm": init_params(cfg.llm_config(), llm_gen, device=device, dtype=dtype),
        "codebook_table": nrm((table_rows, cfg.dim), 0.02),
        "acoustic": {
            "layers": tuple(ac_layer() for _ in range(ac.n_layers)),
            "norm": full(ac.dim, 1.0),
            "input_proj": lin(cfg.n_acoustic, ac.dim),
            "time_proj": lin(ac.dim, ac.dim),
            "llm_proj": lin(ac.dim, ac.dim),
            "semantic_head": lin(ac.dim, cfg.semantic_padded),
            "acoustic_head": lin(ac.dim, cfg.n_acoustic),
        },
        "codec": {
            "semantic_codebook": nrm((cfg.semantic_codebook_size, cc.semantic_dim), 0.1),
            "input_conv": conv(cc.conv_kernels[0], embed_dim, cc.dim),
            "stages": tuple(stages),
            "output_conv": conv(7, cc.dim, cc.patch_size),
        },
    }


def _f32(v) -> np.ndarray:
    """A state-dict value (torch tensor of any dtype, or array) as float32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def map_voxtral_weights(cfg: VoxtralConfig, sd: dict, dtype=torch.bfloat16, device=None) -> dict:
    """Map a Voxtral safetensors state dict (Mistral-style names,
    modeling.rs:29-80 + codec.rs; torch tensors or numpy arrays) to the
    port's tree ([in, out] linears; conv weights folded from their weight
    norm and kept in PyTorch's layouts) in ``dtype`` on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = default_device(device)

    def t(name):
        return torch.as_tensor(sd[name]).T.contiguous().to(device=device, dtype=dtype)

    def a(name):
        return torch.as_tensor(sd[name]).to(device=device, dtype=dtype)

    def host(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)

    llm_layers = []
    for i in range(cfg.n_layers):
        lp = f"layers.{i}."
        llm_layers.append({
            "attn": {
                "wq": t(lp + "attention.wq.weight"),
                "wk": t(lp + "attention.wk.weight"),
                "wv": t(lp + "attention.wv.weight"),
                "wo": t(lp + "attention.wo.weight"),
            },
            "mlp": {
                "gate": t(lp + "feed_forward.w1.weight"),
                "up": t(lp + "feed_forward.w3.weight"),
                "down": t(lp + "feed_forward.w2.weight"),
            },
            "input_ln": a(lp + "attention_norm.weight"),
            "post_ln": a(lp + "ffn_norm.weight"),
        })
    llm = {
        "embed": a("mm_audio_embeddings.tok_embeddings.weight"),
        "layers": tuple(llm_layers),
        "final_norm": a("norm.weight"),
    }

    ap = "acoustic_transformer."
    ac_layers = []
    for i in range(cfg.acoustic.n_layers):
        lp = f"{ap}layers.{i}."
        ac_layers.append({
            "wq": t(lp + "attention.wq.weight"),
            "wk": t(lp + "attention.wk.weight"),
            "wv": t(lp + "attention.wv.weight"),
            "wo": t(lp + "attention.wo.weight"),
            "input_ln": a(lp + "attention_norm.weight"),
            "post_ln": a(lp + "ffn_norm.weight"),
            "gate": t(lp + "feed_forward.w1.weight"),
            "up": t(lp + "feed_forward.w3.weight"),
            "down": t(lp + "feed_forward.w2.weight"),
        })
    acoustic = {
        "layers": tuple(ac_layers),
        "norm": a(ap + "norm.weight"),
        "input_proj": t(ap + "input_projection.weight"),
        "time_proj": t(ap + "time_projection.weight"),
        "llm_proj": t(ap + "llm_projection.weight"),
        "semantic_head": t(ap + "semantic_codebook_output.weight"),
        "acoustic_head": t(ap + "acoustic_codebook_output.weight"),
    }

    tp = "audio_tokenizer."

    def wn_conv(prefix):
        """A weight-normed conv (torch ``[out, in, k]``) or transposed conv
        (``[in, out, k]``), folded and kept in that layout."""
        w = fold_weight_norm(_f32(sd[prefix + ".conv.parametrizations.weight.original1"]),
                             _f32(sd[prefix + ".conv.parametrizations.weight.original0"]))
        b = sd.get(prefix + ".conv.bias")
        return {"w": host(w), "b": host(_f32(b)) if b is not None else None}

    def codec_layer(prefix):
        return {
            "wq": t(prefix + "attention.wq.weight"),
            "wk": t(prefix + "attention.wk.weight"),
            "wv": t(prefix + "attention.wv.weight"),
            "wo": t(prefix + "attention.wo.weight"),
            "q_norm": a(prefix + "attention.q_norm.weight"),
            "k_norm": a(prefix + "attention.k_norm.weight"),
            "attn_norm": a(prefix + "attention_norm.weight"),
            "ffn_norm": a(prefix + "ffn_norm.weight"),
            "attn_scale": a(prefix + "attention_scale"),
            "ffn_scale": a(prefix + "ffn_scale"),
            "w1": t(prefix + "feed_forward.w1.weight"),
            "w2": t(prefix + "feed_forward.w2.weight"),
            "w3": t(prefix + "feed_forward.w3.weight"),
        }

    cc = cfg.codec
    emb_sum = _f32(sd[tp + "quantizer.semantic_codebook.embedding_sum"])
    usage = _f32(sd[tp + "quantizer.semantic_codebook.cluster_usage"])
    semantic_codebook = emb_sum / np.clip(usage, 1e-5, None)[:, None]

    n_stages = len(cc.transformer_lengths)
    stages = []
    block_idx = 1
    for s in range(n_stages):
        layers = tuple(
            codec_layer(f"{tp}decoder_blocks.{block_idx}.layers.{l}.")
            for l in range(cc.transformer_lengths[s])
        )
        block_idx += 1
        upsample = None
        if s < n_stages - 1:
            upsample = wn_conv(f"{tp}decoder_blocks.{block_idx}")
            block_idx += 1
        stages.append({"layers": layers, "upsample": upsample})

    codec = {
        "semantic_codebook": host(semantic_codebook),
        "input_conv": wn_conv(tp + "decoder_blocks.0"),
        "stages": tuple(stages),
        "output_conv": wn_conv(tp + "output_proj"),
    }
    table = a("mm_audio_embeddings.audio_codebook_embeddings.embeddings.weight")
    return {"llm": llm, "codebook_table": table, "acoustic": acoustic, "codec": codec}


# ---------------------------------------------------------------------------
# Generation


def build_prompt_segments(text_token_ids: list) -> list:
    """``[BOS, BEGIN_AUDIO, 'voice', INST_END, text..., INST, BEGIN_AUDIO]``
    (reference model.rs:231-244). 'voice' marks where voice embeddings splice."""
    return [BOS, BEGIN_AUDIO, "voice", INST_END, *[int(t) for t in text_token_ids], INST,
            BEGIN_AUDIO]


class VoxtralTts:
    """End-to-end Voxtral TTS: prompt -> AR semantic frames + flow-matched
    acoustic codes -> codec PCM, on the parameters' device."""

    def __init__(self, cfg: VoxtralConfig, params: dict, voices: dict | None = None,
                 max_seq: int = 1024):
        self.cfg = cfg
        self.params = params
        self.voices = voices or {}
        self.max_seq = max_seq
        self.tokenizer = None  # Tekkenizer, set by load_voxtral_tts
        self.llm_cfg = cfg.llm_config()
        self.device = params["codebook_table"].device
        self.dtype = params["codebook_table"].dtype
        self.rope = make_rope_tables(self.llm_cfg, self.device)
        self.offsets = codebook_offsets(cfg, self.device)
        with torch.no_grad():
            self._time_tokens = time_tokens(cfg, params["acoustic"])
        self._programs: dict = {}  # the captured frame blocks (models/graphs.py)
        self._cache = None  # the backbone's kept cache
        self._generator = torch.Generator(device=self.device)

    def release_graphs(self) -> None:
        """Drop the captured frame blocks and the kept backbone cache."""
        self._programs.clear()
        self._cache = None

    def _prompt_embeds(self, text_ids: list, voice_embed) -> torch.Tensor:
        embed = self.params["llm"]["embed"]
        parts = []
        for seg in build_prompt_segments(text_ids):
            if seg == "voice":
                if voice_embed is not None:
                    parts.append(torch.as_tensor(np.asarray(voice_embed, np.float32),
                                                 device=self.device).to(self.dtype))
            else:
                parts.append(embed[torch.tensor([seg], device=self.device)])
        return torch.cat(parts, dim=0)[None]

    def _voice(self, voice: str | None):
        if voice is not None:
            if voice not in self.voices:
                raise KeyError(f"unknown voice {voice!r}; available: {sorted(self.voices)}")
            return self.voices[voice]
        return next(iter(self.voices.values())) if self.voices else None

    @torch.no_grad()
    def prefill(self, text_ids: list, voice: str | None = None) -> torch.Tensor:
        """The prompt through the backbone from position 0 over the kept
        cache (its length then the prompt's): the last hidden ``[1, dim]``."""
        embeds = self._prompt_embeds(text_ids, self._voice(voice))
        if self._cache is None:
            self._cache = make_cache(self.llm_cfg, 1, self.max_seq, self.dtype,
                                     device=self.device)
        cache = self._cache
        cache.lengths.zero_()
        tokens = torch.zeros(embeds.shape[:2], dtype=torch.int32, device=self.device)
        hidden, new = forward_hidden(self.llm_cfg, self.params["llm"], tokens, cache, 0, self.rope,
                                     inputs_embeds=embeds)
        cache.lengths.copy_(new.lengths)
        return hidden[:, -1]

    def _frame_block_body(self, *, layers, generator, n_frames, hidden, lengths, step, limit,
                          active, frames, ended, hidden_out):
        """``n_frames`` frames from the backbone's hidden ``[1, dim]``: per
        frame the semantic argmax, one noise draw, flow matching, the summed
        code embedding and the backbone's decode step (crane_tpu's
        ``frame_step`` and ``decode_step``). Frame i's codes go to
        ``frames[i]``, its END_AUDIO flag to ``ended[i]``. A decode step runs
        active only while ``active`` holds, no END has come and the next
        frame (number ``step + i + 1``) is below ``limit``; ``lengths`` rolls
        in place and the last hidden goes to ``hidden_out``."""
        cfg, p = self.cfg, self.params
        cache = KVCache(layers=layers, lengths=lengths)
        tokens = torch.zeros((1, 1), dtype=torch.int32, device=hidden.device)
        h, live = hidden, active
        for i in range(n_frames):
            sem = predict_semantic_logits(cfg, p["acoustic"], h[0]).argmax().to(torch.int32)
            noise = torch.randn((cfg.n_acoustic,), generator=generator, device=h.device,
                                dtype=torch.float32).to(self.dtype)
            codes = torch.cat([sem[None], flow_match(cfg, p["acoustic"], h[0], noise,
                                                     self._time_tokens)])
            frames[i] = codes
            end = sem == END_AUDIO_CODE
            ended[i] = end
            live = live & ~end & (step + i + 1 < limit)
            emb = embed_frame_codes(p["codebook_table"], self.offsets, codes)
            hidden_new, cache = forward_hidden(self.llm_cfg, p["llm"], tokens, cache, cache.lengths,
                                               self.rope, inputs_embeds=emb[None, None, :],
                                               active=live)
            h = hidden_new[:, -1]
        lengths.copy_(cache.lengths)
        hidden_out.copy_(h)

    @torch.no_grad()
    def generate_codes(self, text_ids: list, *, voice: str | None = None, max_frames: int = 64,
                       seed: int = 0, block_frames: int = BLOCK_FRAMES) -> np.ndarray:
        """Text token ids (no BOS/EOS) -> codes ``[n_frames, 37]`` int32,
        greedy semantic decoding that stops at END_AUDIO, in blocks of
        ``block_frames`` frames (one graph replay each on the card). The
        noise is drawn per frame from ``seed``."""
        h = self.prefill(text_ids, voice)
        cache = self._cache
        self._generator.manual_seed(seed)
        one = torch.ones((1,), dtype=torch.bool, device=self.device)
        limit = torch.tensor([max_frames], dtype=torch.int32, device=self.device)
        kept, done = [], 0
        while done < max_frames:
            res = graphs.dispatch(
                self._programs, self.device, "voxtral_frames", self._frame_block_body, cache,
                dict(hidden=h, lengths=cache.lengths, active=one, limit=limit,
                     step=torch.tensor([done], dtype=torch.int32, device=self.device)),
                {"frames": ((block_frames, self.cfg.n_codebooks), torch.int32),
                 "ended": ((block_frames,), torch.bool),
                 "hidden_out": ((1, self.cfg.dim), self.dtype)},
                generator=self._generator, n_frames=block_frames)
            ended = res["ended"].cpu().numpy()
            k = min(int(np.argmax(ended)) if ended.any() else block_frames, max_frames - done)
            kept.append(res["frames"][:k].cpu().numpy())
            done += k
            if k < block_frames:
                break
            h = res["hidden_out"]
        codes = np.concatenate(kept) if kept else np.zeros((0, self.cfg.n_codebooks))
        return codes.astype(np.int32)

    def generate(self, text_ids: list, *, voice: str | None = None,
                 max_frames: int = 64, seed: int = 0,
                 block_frames: int = BLOCK_FRAMES) -> tuple[np.ndarray, int]:
        """Text token ids (no BOS/EOS) -> (waveform [n_samples], sample_rate):
        :meth:`generate_codes`, then the codec."""
        codes = self.generate_codes(text_ids, voice=voice, max_frames=max_frames, seed=seed,
                                    block_frames=block_frames)
        if not len(codes):
            return np.zeros((0,), np.float32), self.cfg.sample_rate
        wav = codec_decode(self.cfg, self.params["codec"],
                           torch.as_tensor(codes, device=self.device)[None])
        return wav[0].float().cpu().numpy(), self.cfg.sample_rate

    def generate_speech(self, text: str, *, voice: str | None = None,
                        max_frames: int = 250, seed: int = 0):
        """Text -> (waveform, sample_rate) via the attached Tekken tokenizer
        (text is encoded WITHOUT BOS/EOS — build_prompt_segments adds the
        prompt specials, reference model.rs:228-244)."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer attached (load via load_voxtral_tts)")
        return self.generate(self.tokenizer.encode(text), voice=voice,
                             max_frames=max_frames, seed=seed)


# ── checkpoint loading ──────────────────────────────────────────────────


def config_from_params_json(raw: dict) -> VoxtralConfig:
    """Parse the released checkpoint's ``params.json`` (reference
    model.rs:45-185: top-level dims + ``multimodal.audio_model_args`` +
    ``multimodal.audio_tokenizer_args`` with comma-separated stage lists)."""
    mm = raw.get("multimodal", {})
    am = mm.get("audio_model_args", {})
    at = mm.get("audio_tokenizer_args", {})
    ac = am.get("acoustic_transformer_args", {})

    def csv(v, default):
        if v is None:
            return tuple(default)
        if isinstance(v, str):
            return tuple(int(x) for x in v.split(","))
        return tuple(int(x) for x in v)

    d = AcousticArgs()
    acoustic = AcousticArgs(
        dim=ac.get("dim", d.dim), n_layers=ac.get("n_layers", d.n_layers),
        n_heads=ac.get("n_heads", d.n_heads),
        n_kv_heads=ac.get("n_kv_heads", d.n_kv_heads),
        head_dim=ac.get("head_dim", d.head_dim),
        hidden_dim=ac.get("hidden_dim", d.hidden_dim),
    )
    c = CodecArgs()
    codec = CodecArgs(
        dim=at.get("dim", c.dim), hidden_dim=at.get("hidden_dim", c.hidden_dim),
        n_heads=at.get("n_heads", c.n_heads),
        n_kv_heads=at.get("n_kv_heads", c.n_kv_heads),
        head_dim=at.get("head_dim", c.head_dim),
        qk_norm_eps=at.get("qk_norm_eps", c.qk_norm_eps),
        norm_eps=at.get("norm_eps", c.norm_eps),
        semantic_dim=at.get("semantic_dim", c.semantic_dim),
        patch_size=at.get("pretransform_patch_size", c.patch_size),
        transformer_lengths=csv(
            at.get("decoder_transformer_lengths_str"), c.transformer_lengths
        ),
        conv_kernels=csv(at.get("decoder_convs_kernels_str"), c.conv_kernels),
        conv_strides=csv(at.get("decoder_convs_strides_str"), c.conv_strides),
    )
    v = VoxtralConfig()
    return VoxtralConfig(
        dim=raw.get("dim", v.dim), n_layers=raw.get("n_layers", v.n_layers),
        n_heads=raw.get("n_heads", v.n_heads),
        n_kv_heads=raw.get("n_kv_heads", v.n_kv_heads),
        head_dim=raw.get("head_dim", v.head_dim),
        hidden_dim=raw.get("hidden_dim", v.hidden_dim),
        vocab_size=raw.get("vocab_size", v.vocab_size),
        rope_theta=raw.get("rope_theta", v.rope_theta),
        norm_eps=raw.get("norm_eps", v.norm_eps),
        max_seq_len=min(raw.get("max_seq_len", v.max_seq_len), 65536),
        semantic_codebook_size=am.get(
            "semantic_codebook_size", v.semantic_codebook_size
        ),
        n_acoustic=am.get("n_acoustic_codebook", v.n_acoustic),
        fsq_levels=am.get("acoustic_codebook_size", v.fsq_levels),
        sample_rate=at.get("sampling_rate", v.sample_rate),
        acoustic=acoustic, codec=codec,
    )


def load_voice_embedding(path: str) -> np.ndarray:
    """Pre-computed voice embedding ``.pt`` -> ``[N, dim]`` f32. The file is
    a torch ZIP whose single entry is a raw bf16 ``[N, 3072]`` tensor
    (reference model.rs:249-312 reads the raw buffer the same way; we also
    accept a plain ``.npy``)."""
    if path.endswith(".npy"):
        return np.load(path)
    import zipfile

    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        entry = next(
            (n for n in ("voice_embed/data/0", "archive/data/0", "data/0")
             if n in names),
            None,
        )
        if entry is None:  # any */data/N tensor payload
            cands = [n for n in names if "/data/" in n and not n.endswith("/")]
            if not cands:
                raise ValueError(f"no tensor data entry in {path}: {names}")
            entry = cands[0]
        raw = z.read(entry)
    dim = 3072  # codec-encoder output width (reference model.rs:249-252)
    if len(raw) % (dim * 2):
        raise ValueError(f"{path}: {len(raw)} bytes is not [N, {dim}] bf16")
    u16 = np.frombuffer(raw, np.uint16).reshape(-1, dim)
    return (u16.astype(np.uint32) << 16).view(np.float32)


def load_voxtral_tts(model_dir: str, *, dtype=torch.bfloat16, device=None):
    """Load a released Voxtral TTS checkpoint directory (reference
    model.rs:353-417): ``params.json`` + ``tekken.json`` +
    ``consolidated.safetensors`` + ``voice_embedding/*.pt`` onto ``device``
    (the card unless the caller asks for the CPU). Returns
    ``(VoxtralTts, Tekkenizer | None)``; the model also keeps the tokenizer
    at ``.tokenizer``."""
    import glob
    import json
    import os

    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict

    device = default_device(device)
    cfg_path = os.path.join(model_dir, "params.json")
    cfg = VoxtralConfig()
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = config_from_params_json(json.load(f))
    params = map_voxtral_weights(cfg, load_state_dict(model_dir), dtype, device)

    voices = {}
    for pat in ("voice_embedding/*.pt", "voice_embedding/*.npy", "voices/*.npy"):
        for p in glob.glob(os.path.join(model_dir, pat)):
            name = os.path.splitext(os.path.basename(p))[0]
            voices.setdefault(name, load_voice_embedding(p))

    tok = None
    tekken_path = os.path.join(model_dir, "tekken.json")
    if os.path.exists(tekken_path):
        from crane_tpu_torch.tokenizer.tekken import Tekkenizer

        tok = Tekkenizer.from_file(tekken_path)

    model = VoxtralTts(cfg, params, voices=voices, max_seq=1024)
    model.tokenizer = tok
    return model, tok
