"""Qwen3-TTS speech tokenizer v2: 16-codebook RVQGAN decoder (+ chunked
decode) and the Mimi-style encoder for voice-clone reference audio.

Port of ``crane_tpu/models/speech_tokenizer.py``. Reference behavior
(crane-core ``src/models/qwen3_tts/speech_tokenizer_v2.rs``): codes
``[B, 16, T]`` -> split residual VQ decode (semantic codebook 0 via
rvq_first, acoustic 1..15 via rvq_rest, summed) -> causal pre_conv (k=3) ->
8-layer sliding-window(72) RoPE transformer with LayerScale + SwiGLU
(:406-483) -> two x2 upsample stages (causal transposed conv + ConvNeXt
block, :536-575, :666-698) -> decoder tail: conv(7) -> four DecoderBlocks
(SnakeBeta + transposed conv x[8,5,4,3] + 3 dilated residual units,
:605-664) -> SnakeBeta -> conv(7) -> clamp(-1, 1). total_upsample =
2*2*8*5*4*3 = 1920 -> 24 kHz at 12.5 Hz frames. ``chunked_decode`` decodes
overlapping chunks with ``left_context`` frames of warm-up that get trimmed
(:1650-1698) — the streaming TTS building block.

All compute is float32 (the reference forces F32: SnakeBeta's exp/sin/sqr
chain is precision-sensitive, :1475-1481). The convs are ``[B, C, T]`` with
``[Cout, Cin, K]`` weights, PyTorch's layout, as crane_tpu keeps them; a
transposed conv takes torch's ``ConvTranspose1d`` weight ``[Cin, Cout, K]``
as stored. crane_tpu computes everything here with plain XLA ops (no Pallas
kernel), so the port runs ``F.conv1d``, ``F.conv_transpose1d`` and plain
products; a decode runs eagerly, once a streaming chunk, its launches few
and large. Weight layout matches the released ``speech_tokenizer/``
safetensors (prefixes ``decoder.`` and ``encoder.``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.models.modules.vision import layer_norm
from crane_tpu_torch.ops.rope import apply_rope_embeds, rope_table
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class SpeechDecoderConfig:
    codebook_size: int = 2048
    hidden_size: int = 1024
    latent_dim: int = 1024
    codebook_dim: int = 1024
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 64
    sliding_window: int = 72
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-5
    num_hidden_layers: int = 8
    num_quantizers: int = 16
    upsample_rates: tuple = (8, 5, 4, 3)
    upsampling_ratios: tuple = (2, 2)
    decoder_dim: int = 1536
    rope_theta: float = 10000.0
    output_sample_rate: int = 24000

    @property
    def total_upsample(self) -> int:
        n = 1
        for r in tuple(self.upsample_rates) + tuple(self.upsampling_ratios):
            n *= r
        return n


# ── primitive layers (all [B, C, T] float32) ─────────────────────────────


def causal_conv(x, w, b, *, stride=1, dilation=1, groups=1, pad_mode="zero"):
    """Reference CausalConvNet (:484-533): left pad (K_eff - stride), plus
    right pad to the ideal frame count. ``pad_mode="replicate"`` edge-pads
    instead (the Mimi encoder's frame-rate downsample conv)."""
    K = w.shape[-1]
    eff = (K - 1) * dilation + 1
    pad = max(eff - stride, 0)
    L = x.shape[-1]
    n_frames = (L - eff + pad) / stride + 1.0
    ideal = (math.ceil(n_frames) - 1) * stride + (eff - pad)
    extra = max(ideal - L, 0)
    if pad_mode == "replicate":
        x = torch.cat([x[..., :1].expand(*x.shape[:-1], pad), x,
                       x[..., -1:].expand(*x.shape[:-1], extra)], dim=-1)
    else:
        x = F.pad(x, (pad, extra))
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def causal_trans_conv(x, w, b, *, stride):
    """Reference CausalTransConvNet (:536-575): torch ConvTranspose1d
    (weight ``[Cin, Cout, K]`` as stored, padding=0), then trim (K - stride)
    from the right."""
    K = w.shape[-1]
    y = F.conv_transpose1d(x, w, b, stride=stride)
    trim = max(K - stride, 0)
    return y[..., : y.shape[-1] - trim] if trim else y


def snake_beta(p, x):
    """x + sin^2(alpha*x) / (beta + eps), alpha/beta stored in log space."""
    a = torch.exp(p["alpha"])[None, :, None]
    b = torch.exp(p["beta"])[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.sin(a * x) ** 2


def _rms(x, w, eps):
    v = (x.float() ** 2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(v + eps)) * w


def _rope(x, cos, sin):
    """Half-split RoPE of ``[B, T, H, D]`` at positions 0..T-1 (``cos``/``sin``
    ``[T, D/2]``)."""
    return apply_rope_embeds(x, cos[None], sin[None])


def _window_mask(T: int, window: int, device) -> torch.Tensor:
    """``[T, T]`` bool: query i sees keys j with i - window < j <= i."""
    ti = torch.arange(T, device=device)
    return (ti[None, :] <= ti[:, None]) & (ti[:, None] - ti[None, :] < window)


def tokenizer_transformer(cfg: SpeechDecoderConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x ``[B, T, latent]`` -> ``[B, T, latent]``: input_proj -> 8 layers
    (RMS pre-norms, sliding-window causal RoPE attention, LayerScale,
    SwiGLU) -> norm -> output_proj."""
    B, T, _ = x.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = x @ p["input_proj_w"] + p["input_proj_b"]
    cos, sin = rope_table(D, T, theta=cfg.rope_theta, device=x.device)
    mask = _window_mask(T, cfg.sliding_window, x.device)
    G = H // Hkv
    for layer in p["layers"]:
        r = h
        n = _rms(h, layer["input_ln"], cfg.rms_norm_eps)
        q = _rope((n @ layer["wq"]).reshape(B, T, H, D), cos, sin)
        k = _rope((n @ layer["wk"]).reshape(B, T, Hkv, D), cos, sin)
        v = (n @ layer["wv"]).reshape(B, T, Hkv, D)
        qg = q.reshape(B, T, Hkv, G, D)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float()) * (D ** -0.5)
        s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqt,btkd->bqkgd", a, v).reshape(B, T, H * D)
        h = r + (o @ layer["wo"]) * layer["attn_scale"]
        r = h
        n = _rms(h, layer["post_ln"], cfg.rms_norm_eps)
        m = (F.silu(n @ layer["gate"]) * (n @ layer["up"])) @ layer["down"]
        h = r + m * layer["mlp_scale"]
    h = _rms(h, p["norm"], cfg.rms_norm_eps)
    return h @ p["output_proj_w"] + p["output_proj_b"]


def convnext_block(p, x):
    """ConvNeXt block on [B, C, T] (:666-698)."""
    r = x
    h = causal_conv(x, p["dw_w"], p["dw_b"], groups=x.shape[1])
    h = h.transpose(1, 2)  # [B, T, C]
    h = layer_norm(h, p["ln_w"], p["ln_b"], 1e-6)
    h = F.gelu(h @ p["pw1_w"] + p["pw1_b"])
    h = h @ p["pw2_w"] + p["pw2_b"]
    h = h * p["gamma"]
    return r + h.transpose(1, 2)


def residual_unit(p, x, *, dilation):
    h = snake_beta(p["act1"], x)
    h = causal_conv(h, p["conv1_w"], p["conv1_b"], dilation=dilation)
    h = snake_beta(p["act2"], h)
    h = causal_conv(h, p["conv2_w"], p["conv2_b"])
    return x + h


def decoder_block(p, x, *, up):
    h = snake_beta(p["first_act"], x)
    h = causal_trans_conv(h, p["up_w"], p["up_b"], stride=up)
    for unit, dil in zip(p["units"], (1, 3, 9)):
        h = residual_unit(unit, h, dilation=dil)
    return h


def rvq_decode(cfg: SpeechDecoderConfig, p: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, K, T]`` int -> latent ``[B, codebook_dim, T]`` via the
    split RVQ: codebook 0 through rvq_first, 1..K-1 through rvq_rest, sum. A
    code past a table reads its last row, as crane_tpu's gather clamps it."""
    def rvq(branch, sub):  # sub: [B, k, T]
        acc = None
        for i in range(sub.shape[1]):
            table = branch["embeddings"][i]
            q = table[sub[:, i].long().clamp(0, table.shape[0] - 1)]  # [B, T, dim]
            acc = q if acc is None else acc + q
        return acc @ branch["out_proj"]  # [B, T, codebook_dim]

    first = rvq(p["rvq_first"], codes[:, :1])
    if codes.shape[1] > 1:
        first = first + rvq(p["rvq_rest"], codes[:, 1:])
    return first.transpose(1, 2)


@torch.no_grad()
def decode_frames(cfg: SpeechDecoderConfig, p: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, num_quantizers, T]`` -> audio ``[B, 1, T * 1920]`` float32."""
    h = rvq_decode(cfg, p, codes)
    h = causal_conv(h, p["pre_conv_w"], p["pre_conv_b"])
    h = tokenizer_transformer(cfg, p["pre_transformer"], h.transpose(1, 2)).transpose(1, 2)
    for stage, ratio in zip(p["upsample"], cfg.upsampling_ratios):
        h = causal_trans_conv(h, stage["up_w"], stage["up_b"], stride=ratio)
        h = convnext_block(stage["convnext"], h)
    h = causal_conv(h, p["head_conv_w"], p["head_conv_b"])
    for block, up in zip(p["blocks"], cfg.upsample_rates):
        h = decoder_block(block, h, up=up)
    h = snake_beta(p["final_act"], h)
    h = causal_conv(h, p["out_conv_w"], p["out_conv_b"])
    return torch.clamp(h, -1.0, 1.0)


def _params_device(p) -> torch.device:
    while isinstance(p, (dict, list, tuple)):
        p = next(iter(p.values())) if isinstance(p, dict) else p[0]
    return p.device


class SpeechTokenizerDecoder:
    """Codes -> 24 kHz waveform, with reference-parity chunked decoding, on
    the parameters' device."""

    def __init__(self, config: SpeechDecoderConfig, params: dict):
        self.config = config
        self.params = params
        self.device = _params_device(params)

    @property
    def sample_rate(self) -> int:
        return self.config.output_sample_rate

    def decode(self, codes) -> np.ndarray:
        """codes ``[B, T, K]`` (frame-major, talker output order) -> audio
        ``[B, samples]`` float32 numpy."""
        c = torch.as_tensor(np.asarray(codes), device=self.device).long().transpose(1, 2)
        return decode_frames(self.config, self.params, c)[:, 0, :].cpu().numpy()

    def decode_chunk(self, chunk_codes, context_frames: int) -> np.ndarray:
        """One streaming chunk ``[B, ctx+new, K]``: decode, trim the warm-up
        context audio, return only the new frames' audio
        (reference :1682-1698)."""
        audio = self.decode(chunk_codes)
        return audio[:, context_frames * self.config.total_upsample:]

    def chunked_decode(self, codes, chunk_size: int = 300, left_context: int = 25) -> np.ndarray:
        """Reference chunked_decode(:1650-1680): decode ``chunk_size``-frame
        windows with ``left_context`` frames of overlap, trim the context."""
        codes = np.asarray(codes)
        T = codes.shape[1]
        out = []
        start = 0
        while start < T:
            ctx = min(left_context, start)
            end = min(start + chunk_size, T)
            out.append(self.decode_chunk(codes[:, start - ctx:end], ctx))
            start = end
        return np.concatenate(out, axis=1)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def map_decoder_weights(cfg: SpeechDecoderConfig, sd: dict, prefix: str = "decoder.",
                        device=None) -> dict:
    """Map the released speech-tokenizer safetensors (``decoder.*``; torch
    tensors or numpy arrays) to the params tree, float32 on ``device``.
    Codebooks are usage-normalized at load (embedding_sum /
    clamp(cluster_usage), :700-736); linears are ``[in, out]``."""
    def g(n):
        return _f32(sd[prefix + n], device)

    def t(n):
        return g(n).T.contiguous()

    def rvq(name, n_q):
        embs = []
        for i in range(n_q):
            s = g(f"quantizer.{name}.vq.layers.{i}._codebook.embedding_sum")
            key = f"quantizer.{name}.vq.layers.{i}._codebook.cluster_usage"
            usage = g(key) if prefix + key in sd else torch.ones(s.shape[0], device=s.device)
            embs.append(s / torch.clamp(usage, min=1e-5)[:, None])
        w = g(f"quantizer.{name}.output_proj.weight")
        if w.ndim == 3:
            w = w[:, :, 0]
        return {"embeddings": embs, "out_proj": w.T.contiguous()}

    def conv(n):
        b = f"{n}.conv.bias"
        return g(n + ".conv.weight"), (g(b) if prefix + b in sd else None)

    def snake(n):
        return {"alpha": g(n + ".alpha"), "beta": g(n + ".beta")}

    def res_unit(n):
        c1w, c1b = conv(n + ".conv1")
        c2w, c2b = conv(n + ".conv2")
        return {"act1": snake(n + ".act1"), "conv1_w": c1w, "conv1_b": c1b,
                "act2": snake(n + ".act2"), "conv2_w": c2w, "conv2_b": c2b}

    layers = []
    for i in range(cfg.num_hidden_layers):
        L = f"pre_transformer.layers.{i}."
        layers.append({
            "wq": t(L + "self_attn.q_proj.weight"), "wk": t(L + "self_attn.k_proj.weight"),
            "wv": t(L + "self_attn.v_proj.weight"), "wo": t(L + "self_attn.o_proj.weight"),
            "input_ln": g(L + "input_layernorm.weight"),
            "post_ln": g(L + "post_attention_layernorm.weight"),
            "attn_scale": g(L + "self_attn_layer_scale.scale"),
            "mlp_scale": g(L + "mlp_layer_scale.scale"),
            "gate": t(L + "mlp.gate_proj.weight"), "up": t(L + "mlp.up_proj.weight"),
            "down": t(L + "mlp.down_proj.weight"),
        })
    pre_transformer = {
        "input_proj_w": t("pre_transformer.input_proj.weight"),
        "input_proj_b": g("pre_transformer.input_proj.bias"),
        "output_proj_w": t("pre_transformer.output_proj.weight"),
        "output_proj_b": g("pre_transformer.output_proj.bias"),
        "norm": g("pre_transformer.norm.weight"),
        "layers": layers,
    }

    upsample = []
    for i in range(len(cfg.upsampling_ratios)):
        uw, ub = conv(f"upsample.{i}.0")
        n = f"upsample.{i}.1"
        dw, db = conv(n + ".dwconv")
        upsample.append({
            "up_w": uw, "up_b": ub,
            "convnext": {
                "dw_w": dw, "dw_b": db,
                "ln_w": g(n + ".norm.weight"), "ln_b": g(n + ".norm.bias"),
                "pw1_w": t(n + ".pwconv1.weight"), "pw1_b": g(n + ".pwconv1.bias"),
                "pw2_w": t(n + ".pwconv2.weight"), "pw2_b": g(n + ".pwconv2.bias"),
                "gamma": g(n + ".gamma"),
            },
        })

    blocks = []
    for i in range(len(cfg.upsample_rates)):
        n = f"decoder.{i + 1}.block"
        uw, ub = conv(n + ".1")
        blocks.append({"first_act": snake(n + ".0"), "up_w": uw, "up_b": ub,
                       "units": [res_unit(f"{n}.{j}") for j in (2, 3, 4)]})

    pc_w, pc_b = conv("pre_conv")
    h_w, h_b = conv("decoder.0")
    n_blocks = len(cfg.upsample_rates)
    o_w, o_b = conv(f"decoder.{n_blocks + 2}")
    return {
        "rvq_first": rvq("rvq_first", 1),
        "rvq_rest": rvq("rvq_rest", cfg.num_quantizers - 1),
        "pre_conv_w": pc_w, "pre_conv_b": pc_b,
        "pre_transformer": pre_transformer,
        "upsample": upsample,
        "head_conv_w": h_w, "head_conv_b": h_b,
        "blocks": blocks,
        "final_act": snake(f"decoder.{n_blocks + 1}"),
        "out_conv_w": o_w, "out_conv_b": o_b,
    }


def _read_config(model_dir: str) -> dict:
    import json
    import os

    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_speech_tokenizer(model_dir: str, *, device=None) -> SpeechTokenizerDecoder:
    """Load from a released ``speech_tokenizer/`` directory (config.json with
    decoder_config + safetensors with ``decoder.*`` tensors) onto ``device``
    (the card unless the caller asks for the CPU)."""
    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict

    device = default_device(device)
    raw = _read_config(model_dir)
    dc = raw.get("decoder_config", raw)
    cfg = SpeechDecoderConfig(
        codebook_size=dc.get("codebook_size", 2048),
        hidden_size=dc.get("hidden_size", 1024),
        latent_dim=dc.get("latent_dim", 1024),
        codebook_dim=dc.get("codebook_dim", 1024),
        num_attention_heads=dc.get("num_attention_heads", 16),
        num_key_value_heads=dc.get("num_key_value_heads", 16),
        head_dim=dc.get("head_dim", 64),
        sliding_window=dc.get("sliding_window", 72),
        intermediate_size=dc.get("intermediate_size", 3072),
        rms_norm_eps=dc.get("rms_norm_eps", 1e-5),
        num_hidden_layers=dc.get("num_hidden_layers", 8),
        num_quantizers=dc.get("num_quantizers", 16),
        upsample_rates=tuple(dc.get("upsample_rates", (8, 5, 4, 3))),
        upsampling_ratios=tuple(dc.get("upsampling_ratios", (2, 2))),
        decoder_dim=dc.get("decoder_dim", 1536),
        rope_theta=dc.get("rope_theta", 10000.0),
        output_sample_rate=raw.get("output_sample_rate", 24000),
    )
    sd = load_state_dict(model_dir)
    return SpeechTokenizerDecoder(cfg, map_decoder_weights(cfg, sd, device=device))


# ── Mimi-style encoder (reference audio -> codec codes, voice clone) ───────
#
# Reference: speech_tokenizer_v2.rs — the model ships an encoder under the
# ``encoder.*`` prefix of the same speech_tokenizer safetensors; the
# reference PREFERS its HF-Mimi-semantics path (HfMimiEncoder, :1382-1472)
# over its own conv-then-elu variant, so the behavior spec here is the HF
# Mimi encoder: SEANet tower (ELU *before* each conv in residual blocks) ->
# x2 conv downsample -> 8-layer LayerNorm/GELU sliding-window transformer
# with LayerScale -> split residual VQ (1 semantic + N acoustic codebooks,
# nearest-neighbor on usage-normalized codebooks), trimmed to
# ``valid_num_quantizers`` (:1324-1364, 1449-1472).


@dataclasses.dataclass(frozen=True)
class SpeechEncoderConfig:
    """Reference EncoderConfig defaults (speech_tokenizer_v2.rs:77-185)."""

    num_filters: int = 64
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    compress: int = 2
    # decoder-order ratios; the encoder strides are these reversed
    upsampling_ratios: tuple = (8, 6, 5, 4)
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 250
    vector_quantization_hidden_dimension: int = 256
    valid_num_quantizers: int = 16
    input_sample_rate: int = 24000

    @property
    def encoder_strides(self) -> tuple:
        return tuple(reversed(self.upsampling_ratios))


def encoder_seanet(cfg: SpeechEncoderConfig, p: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio ``[B, 1, N]`` float32 -> latent ``[B, hidden, T]`` at 12.5 Hz:
    SEANet downsampling tower then the x2 frame-rate conv (HF Mimi order —
    ELU before residual convs and before every downsample/last conv)."""
    h = causal_conv(audio, p["first_w"], p["first_b"])
    for block, stride in zip(p["blocks"], cfg.encoder_strides):
        for j, unit in enumerate(block["units"]):
            u = causal_conv(F.elu(h), unit["conv1_w"], unit["conv1_b"],
                            dilation=cfg.dilation_growth_rate ** j)
            u = causal_conv(F.elu(u), unit["conv2_w"], unit["conv2_b"])
            h = h + u
        h = causal_conv(F.elu(h), block["down_w"], block["down_b"], stride=stride)
    h = causal_conv(F.elu(h), p["last_w"], p["last_b"])
    # ConvDownsample1d(compress=2): k=4, stride=2, no bias, REPLICATE padding
    # (:1294-1298; HF MimiModel passes pad_mode="replicate" here)
    return causal_conv(h, p["downsample_w"], None, stride=2, pad_mode="replicate")


def encoder_transformer(cfg: SpeechEncoderConfig, layers: list, x: torch.Tensor) -> torch.Tensor:
    """x ``[B, T, D]`` -> ``[B, T, D]``: LayerNorm pre-norms, sliding-window
    causal RoPE attention, LayerScale, GELU MLP (fc1/fc2) — the encoder
    transformer (:980-1058); projections are identity (dim == d_model)."""
    B, T, _ = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    cos, sin = rope_table(hd, T, theta=cfg.rope_theta, device=x.device)
    mask = _window_mask(T, cfg.sliding_window, x.device)
    h = x
    for layer in layers:
        n = layer_norm(h, layer["input_ln_w"], layer["input_ln_b"], cfg.norm_eps)
        q = _rope((n @ layer["wq"]).reshape(B, T, H, hd), cos, sin)
        k = _rope((n @ layer["wk"]).reshape(B, T, H, hd), cos, sin)
        v = (n @ layer["wv"]).reshape(B, T, H, hd)
        s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * (hd ** -0.5)
        s = torch.where(mask[None, None], s, torch.full_like(s, -math.inf))
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqt,bthd->bqhd", a, v).reshape(B, T, H * hd)
        h = h + (o @ layer["wo"]) * layer["attn_scale"]
        n = layer_norm(h, layer["post_ln_w"], layer["post_ln_b"], cfg.norm_eps)
        m = F.gelu(n @ layer["fc1"]) @ layer["fc2"]
        h = h + m * layer["mlp_scale"]
    return h


def codebook_table(layer: dict) -> torch.Tensor:
    """Usage-normalized codebook ``[bins, dim]`` (embed_sum / clamp(usage))."""
    return layer["embed_sum"] / torch.clamp(layer["usage"], min=1e-5)[:, None]


def codeword_distances(res: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[B, T, C]`` of residuals ``[B, T, dim]`` to the
    codewords ``[C, dim]``, in the expanded form the reference argmins."""
    return (res ** 2).sum(-1, keepdim=True) - 2.0 * (res @ emb.T) + (emb ** 2).sum(-1)[None, None]


def rvq_encode_branch(branch: dict, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """x ``[B, D, T]`` -> codes ``[B, n_layers, T]``: pointwise input_proj
    then the residual nearest-neighbor chain (:1219-1243)."""
    res = torch.einsum("bdt,nd->btn", x, branch["input_proj"])  # [B, T, dim]
    codes = []
    for layer in branch["layers"][:n_layers]:
        emb = codebook_table(layer)  # [C, dim]
        code = torch.argmin(codeword_distances(res, emb), dim=-1)  # [B, T]
        res = res - emb[code]
        codes.append(code)
    return torch.stack(codes, dim=1).to(torch.int32)


@torch.no_grad()
def encode_audio(cfg: SpeechEncoderConfig, p: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio ``[B, 1, N]`` float32 -> codes ``[B, T, valid_num_quantizers]``
    (semantic codebook first — the talker's codebook-0 stream)."""
    h = encoder_seanet(cfg, p, audio)
    h = encoder_transformer(cfg, p["transformer"], h.transpose(1, 2)).transpose(1, 2)
    sem = rvq_encode_branch(p["semantic"], h, cfg.num_semantic_quantizers)
    n_aco = cfg.valid_num_quantizers - cfg.num_semantic_quantizers
    if n_aco > 0:
        sem = torch.cat([sem, rvq_encode_branch(p["acoustic"], h, n_aco)], dim=1)
    return sem.transpose(1, 2)


class SpeechTokenizerEncoder:
    """24 kHz reference audio -> ``[T, n_q]`` codec codes (voice clone), on
    the parameters' device."""

    def __init__(self, config: SpeechEncoderConfig, params: dict):
        self.config = config
        self.params = params
        self.device = _params_device(params)

    @property
    def sample_rate(self) -> int:
        return self.config.input_sample_rate

    def encode(self, audio) -> np.ndarray:
        """audio mono float32 ``[N]`` (or ``[B, N]``) in [-1, 1] at 24 kHz ->
        codes ``[T, n_q]`` int32 (``[B, T, n_q]`` for batched input)."""
        a = np.asarray(audio, np.float32)
        squeeze = a.ndim == 1
        if squeeze:
            a = a[None]
        x = torch.as_tensor(a[:, None, :], device=self.device)
        codes = encode_audio(self.config, self.params, x).cpu().numpy()
        return codes[0] if squeeze else codes

    def __call__(self, audio) -> np.ndarray:
        return self.encode(audio)


def _encoder_layer_indices(cfg: SpeechEncoderConfig):
    """SEANet layer indices in the checkpoint (res units / downsample convs
    interleave with parameterless ELU entries — :1275-1281)."""
    blocks, idx = [], 1
    for _ in cfg.encoder_strides:
        units = list(range(idx, idx + cfg.num_residual_layers))
        down = idx + cfg.num_residual_layers + 1
        blocks.append((units, down))
        idx = down + 1
    return blocks, idx + 1  # (per-block indices, last-conv index)


def map_encoder_weights(cfg: SpeechEncoderConfig, sd: dict, prefix: str = "encoder.",
                        device=None) -> dict:
    """Map the released speech-tokenizer ``encoder.*`` tensors (HF MimiModel
    encoder-side layout) to the params tree, float32 on ``device``."""
    def g(n):
        return _f32(sd[prefix + n], device)

    def conv(n):
        b = f"{n}.conv.bias"
        return g(n + ".conv.weight"), (g(b) if prefix + b in sd else None)

    block_idx, last_idx = _encoder_layer_indices(cfg)
    blocks = []
    for units_idx, down_idx in block_idx:
        units = []
        for u in units_idx:
            c1w, c1b = conv(f"encoder.layers.{u}.block.1")
            c2w, c2b = conv(f"encoder.layers.{u}.block.3")
            units.append({"conv1_w": c1w, "conv1_b": c1b, "conv2_w": c2w, "conv2_b": c2b})
        dw, db = conv(f"encoder.layers.{down_idx}")
        blocks.append({"units": units, "down_w": dw, "down_b": db})

    layers = []
    for i in range(cfg.num_hidden_layers):
        L = f"encoder_transformer.layers.{i}."

        def t(n):
            return g(L + n).T.contiguous()

        layers.append({
            "wq": t("self_attn.q_proj.weight"), "wk": t("self_attn.k_proj.weight"),
            "wv": t("self_attn.v_proj.weight"), "wo": t("self_attn.o_proj.weight"),
            "fc1": t("mlp.fc1.weight"), "fc2": t("mlp.fc2.weight"),
            "input_ln_w": g(L + "input_layernorm.weight"),
            "input_ln_b": g(L + "input_layernorm.bias"),
            "post_ln_w": g(L + "post_attention_layernorm.weight"),
            "post_ln_b": g(L + "post_attention_layernorm.bias"),
            "attn_scale": g(L + "self_attn_layer_scale.scale"),
            "mlp_scale": g(L + "mlp_layer_scale.scale"),
        })

    def rvq_branch(name, n_layers):
        q = f"quantizer.{name}_residual_vector_quantizer."
        branch = {"input_proj": g(q + "input_proj.weight")[:, :, 0].contiguous(), "layers": []}
        for i in range(n_layers):
            c = f"{q}layers.{i}.codebook."
            usage = (g(c + "cluster_usage") if prefix + c + "cluster_usage" in sd
                     else torch.ones(cfg.codebook_size, device=device))
            branch["layers"].append({"embed_sum": g(c + "embed_sum"), "usage": usage})
        return branch

    fw, fb = conv("encoder.layers.0")
    lw, lb = conv(f"encoder.layers.{last_idx}")
    n_aco = cfg.valid_num_quantizers - cfg.num_semantic_quantizers
    return {
        "first_w": fw, "first_b": fb,
        "blocks": blocks,
        "last_w": lw, "last_b": lb,
        "downsample_w": g("downsample.conv.weight"),
        "transformer": layers,
        "semantic": rvq_branch("semantic", cfg.num_semantic_quantizers),
        "acoustic": rvq_branch("acoustic", n_aco),
    }


def load_speech_tokenizer_encoder(model_dir: str, *, device=None) -> "SpeechTokenizerEncoder | None":
    """Build the encoder from a released ``speech_tokenizer/`` directory onto
    ``device`` (the card unless the caller asks for the CPU). Returns None
    when the checkpoint ships no ``encoder.*`` tensors."""
    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict

    device = default_device(device)
    sd = load_state_dict(model_dir)
    if not any(k.startswith("encoder.") for k in sd):
        return None
    raw = _read_config(model_dir)
    ec = raw.get("encoder_config", {})
    cfg = SpeechEncoderConfig(
        num_filters=ec.get("num_filters", 64),
        hidden_size=ec.get("hidden_size", 512),
        intermediate_size=ec.get("intermediate_size", 2048),
        num_hidden_layers=ec.get("num_hidden_layers", 8),
        num_attention_heads=ec.get("num_attention_heads", 8),
        num_key_value_heads=ec.get("num_key_value_heads", 8),
        head_dim=ec.get("head_dim", 64),
        kernel_size=ec.get("kernel_size", 7),
        last_kernel_size=ec.get("last_kernel_size", 3),
        residual_kernel_size=ec.get("residual_kernel_size", 3),
        num_residual_layers=ec.get("num_residual_layers", 1),
        upsampling_ratios=tuple(ec.get("upsampling_ratios", (8, 6, 5, 4))),
        codebook_size=ec.get("codebook_size", 2048),
        codebook_dim=ec.get("codebook_dim", 256),
        num_quantizers=ec.get("num_quantizers", 32),
        num_semantic_quantizers=ec.get("num_semantic_quantizers", 1),
        norm_eps=ec.get("norm_eps", 1e-5),
        rope_theta=ec.get("rope_theta", 10000.0),
        sliding_window=ec.get("sliding_window", 250),
        vector_quantization_hidden_dimension=ec.get("vector_quantization_hidden_dimension", 256),
        valid_num_quantizers=raw.get("encoder_valid_num_quantizers", 16),
        input_sample_rate=raw.get("output_sample_rate", 24000),
    )
    return SpeechTokenizerEncoder(cfg, map_encoder_weights(cfg, sd, device=device))


def random_encoder_state_dict(cfg: SpeechEncoderConfig, seed: int = 0) -> dict:
    """Random state dict with the released checkpoint's ``encoder.*`` key
    layout (tests / dry-runs; real shapes, arbitrary values): numpy arrays
    drawn as crane_tpu draws them (the same seed gives the same values)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    sd, e = {}, "encoder."
    sd[e + "encoder.layers.0.conv.weight"] = r(cfg.num_filters, 1, cfg.kernel_size)
    sd[e + "encoder.layers.0.conv.bias"] = r(cfg.num_filters)
    block_idx, last_idx = _encoder_layer_indices(cfg)
    ch = cfg.num_filters
    for (units_idx, down_idx), stride in zip(block_idx, cfg.encoder_strides):
        for u in units_idx:
            sd[e + f"encoder.layers.{u}.block.1.conv.weight"] = r(
                ch // cfg.compress, ch, cfg.residual_kernel_size)
            sd[e + f"encoder.layers.{u}.block.1.conv.bias"] = r(ch // cfg.compress)
            sd[e + f"encoder.layers.{u}.block.3.conv.weight"] = r(ch, ch // cfg.compress, 1)
            sd[e + f"encoder.layers.{u}.block.3.conv.bias"] = r(ch)
        sd[e + f"encoder.layers.{down_idx}.conv.weight"] = r(2 * ch, ch, 2 * stride)
        sd[e + f"encoder.layers.{down_idx}.conv.bias"] = r(2 * ch)
        ch *= 2
    sd[e + f"encoder.layers.{last_idx}.conv.weight"] = r(cfg.hidden_size, ch, cfg.last_kernel_size)
    sd[e + f"encoder.layers.{last_idx}.conv.bias"] = r(cfg.hidden_size)
    sd[e + "downsample.conv.weight"] = r(cfg.hidden_size, cfg.hidden_size, 4)
    H, hd = cfg.num_attention_heads, cfg.head_dim
    for i in range(cfg.num_hidden_layers):
        L = f"{e}encoder_transformer.layers.{i}."
        sd[L + "self_attn.q_proj.weight"] = r(H * hd, cfg.hidden_size)
        sd[L + "self_attn.k_proj.weight"] = r(H * hd, cfg.hidden_size)
        sd[L + "self_attn.v_proj.weight"] = r(H * hd, cfg.hidden_size)
        sd[L + "self_attn.o_proj.weight"] = r(cfg.hidden_size, H * hd)
        sd[L + "mlp.fc1.weight"] = r(cfg.intermediate_size, cfg.hidden_size)
        sd[L + "mlp.fc2.weight"] = r(cfg.hidden_size, cfg.intermediate_size)
        sd[L + "input_layernorm.weight"] = np.ones(cfg.hidden_size, np.float32)
        sd[L + "input_layernorm.bias"] = np.zeros(cfg.hidden_size, np.float32)
        sd[L + "post_attention_layernorm.weight"] = np.ones(cfg.hidden_size, np.float32)
        sd[L + "post_attention_layernorm.bias"] = np.zeros(cfg.hidden_size, np.float32)
        sd[L + "self_attn_layer_scale.scale"] = np.full(cfg.hidden_size, 0.01, np.float32)
        sd[L + "mlp_layer_scale.scale"] = np.full(cfg.hidden_size, 0.01, np.float32)
    dim = cfg.vector_quantization_hidden_dimension
    for name, nq in (("semantic", cfg.num_semantic_quantizers),
                     ("acoustic", cfg.num_quantizers - cfg.num_semantic_quantizers)):
        q = f"{e}quantizer.{name}_residual_vector_quantizer."
        sd[q + "input_proj.weight"] = r(dim, cfg.hidden_size, 1)
        for i in range(nq):
            sd[q + f"layers.{i}.codebook.embed_sum"] = r(cfg.codebook_size, dim, scale=1.0)
            sd[q + f"layers.{i}.codebook.cluster_usage"] = np.ones(cfg.codebook_size, np.float32)
    return sd


def init_encoder_params(cfg: SpeechEncoderConfig, seed: int = 0, device=None) -> dict:
    """Random encoder params at ``cfg`` shapes (tests / dry-runs)."""
    return map_encoder_weights(cfg, random_encoder_state_dict(cfg, seed), device=device)


def decoder_state_shapes(cfg: SpeechDecoderConfig) -> dict:
    """The released checkpoint's ``decoder.*`` names and shapes at ``cfg``,
    in the order crane_tpu draws them."""
    shapes, d = {}, "decoder."
    half = cfg.codebook_dim // 2
    for name, nq in (("rvq_first", 1), ("rvq_rest", cfg.num_quantizers - 1)):
        for i in range(nq):
            shapes[f"{d}quantizer.{name}.vq.layers.{i}._codebook.embedding_sum"] = \
                (cfg.codebook_size, half)
            shapes[f"{d}quantizer.{name}.vq.layers.{i}._codebook.cluster_usage"] = \
                (cfg.codebook_size,)
        shapes[f"{d}quantizer.{name}.output_proj.weight"] = (cfg.codebook_dim, half, 1)
    shapes[d + "pre_conv.conv.weight"] = (cfg.latent_dim, cfg.codebook_dim, 3)
    shapes[d + "pre_conv.conv.bias"] = (cfg.latent_dim,)
    pt = d + "pre_transformer."
    shapes[pt + "input_proj.weight"] = (cfg.hidden_size, cfg.latent_dim)
    shapes[pt + "input_proj.bias"] = (cfg.hidden_size,)
    shapes[pt + "output_proj.weight"] = (cfg.latent_dim, cfg.hidden_size)
    shapes[pt + "output_proj.bias"] = (cfg.latent_dim,)
    shapes[pt + "norm.weight"] = (cfg.hidden_size,)
    H, Hkv, hd, E = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size
    for i in range(cfg.num_hidden_layers):
        L = f"{pt}layers.{i}."
        shapes[L + "self_attn.q_proj.weight"] = (H * hd, E)
        shapes[L + "self_attn.k_proj.weight"] = (Hkv * hd, E)
        shapes[L + "self_attn.v_proj.weight"] = (Hkv * hd, E)
        shapes[L + "self_attn.o_proj.weight"] = (E, H * hd)
        for n in ("input_layernorm.weight", "post_attention_layernorm.weight",
                  "self_attn_layer_scale.scale", "mlp_layer_scale.scale"):
            shapes[L + n] = (E,)
        shapes[L + "mlp.gate_proj.weight"] = (cfg.intermediate_size, E)
        shapes[L + "mlp.up_proj.weight"] = (cfg.intermediate_size, E)
        shapes[L + "mlp.down_proj.weight"] = (E, cfg.intermediate_size)
    C = cfg.latent_dim
    for i, ratio in enumerate(cfg.upsampling_ratios):
        shapes[f"{d}upsample.{i}.0.conv.weight"] = (C, C, ratio)
        shapes[f"{d}upsample.{i}.0.conv.bias"] = (C,)
        n = f"{d}upsample.{i}.1."
        shapes.update({n + "dwconv.conv.weight": (C, 1, 7), n + "dwconv.conv.bias": (C,),
                       n + "norm.weight": (C,), n + "norm.bias": (C,),
                       n + "pwconv1.weight": (4 * C, C), n + "pwconv1.bias": (4 * C,),
                       n + "pwconv2.weight": (C, 4 * C), n + "pwconv2.bias": (C,),
                       n + "gamma": (C,)})
    shapes[d + "decoder.0.conv.weight"] = (cfg.decoder_dim, C, 7)
    shapes[d + "decoder.0.conv.bias"] = (cfg.decoder_dim,)
    for i, up in enumerate(cfg.upsample_rates):
        n = f"{d}decoder.{i + 1}.block."
        ind, outd = cfg.decoder_dim >> i, cfg.decoder_dim >> (i + 1)
        shapes.update({n + "0.alpha": (ind,), n + "0.beta": (ind,),
                       n + "1.conv.weight": (ind, outd, 2 * up), n + "1.conv.bias": (outd,)})
        for j in (2, 3, 4):
            shapes.update({n + f"{j}.act1.alpha": (outd,), n + f"{j}.act1.beta": (outd,),
                           n + f"{j}.conv1.conv.weight": (outd, outd, 7),
                           n + f"{j}.conv1.conv.bias": (outd,),
                           n + f"{j}.act2.alpha": (outd,), n + f"{j}.act2.beta": (outd,),
                           n + f"{j}.conv2.conv.weight": (outd, outd, 1),
                           n + f"{j}.conv2.conv.bias": (outd,)})
    nb = len(cfg.upsample_rates)
    outd = cfg.decoder_dim >> nb
    shapes[f"{d}decoder.{nb + 1}.alpha"] = (outd,)
    shapes[f"{d}decoder.{nb + 1}.beta"] = (outd,)
    shapes[f"{d}decoder.{nb + 2}.conv.weight"] = (1, outd, 7)
    shapes[f"{d}decoder.{nb + 2}.conv.bias"] = (1,)
    return shapes


def random_decoder_state_dict(cfg: SpeechDecoderConfig, seed: int = 0) -> dict:
    """Random state dict with the released checkpoint's key layout
    (benchmarks / dry-runs / tests; real shapes, arbitrary values): numpy
    arrays drawn as crane_tpu draws them (the same seed gives the same
    values): norms and codebook usage ones, norm biases zeros, layer scales
    0.01, ConvNeXt gammas 0.1, the rest normal with std 0.05."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in decoder_state_shapes(cfg).items():
        if name.endswith(("cluster_usage", "norm.weight")):
            sd[name] = np.ones(shape, np.float32)
        elif name.endswith("norm.bias"):
            sd[name] = np.zeros(shape, np.float32)
        elif name.endswith("layer_scale.scale"):
            sd[name] = np.full(shape, 0.01, np.float32)
        elif name.endswith("gamma"):
            sd[name] = np.full(shape, 0.1, np.float32)
        else:
            sd[name] = (rng.normal(size=shape) * 0.05).astype(np.float32)
    return sd


def init_decoder_params(cfg: SpeechDecoderConfig, seed: int = 0, device=None) -> dict:
    """Random decoder params at ``cfg`` shapes (benchmarks / dry-runs)."""
    return map_decoder_weights(cfg, random_decoder_state_dict(cfg, seed), device=device)
