"""Mimi neural audio codec — CSM's speech tokenizer for TTS and voice clone.

Port of ``crane_tpu/models/mimi.py``. Reference behavior (crane-core
``src/models/qwen3_tts/speech_tokenizer_v2.rs``): a Mimi/RVQGAN-style codec
— RVQ codebook decode, SEANet conv decoder with upsampling, plus an encoder
for reference audio (voice cloning), and ``chunked_decode(codes, 300, 25)``
streaming decode with left-context overlap trim (model.rs:34-66). HF
transformers' MimiModel is the parity oracle: SEANet encoder -> windowed
causal transformer -> stride-2 downsample -> split RVQ (1 semantic + N
acoustic), and the mirror decode path. Encodec-style "extra padding" conv
semantics are reproduced exactly (the speech tokenizer's ``causal_conv``,
which computes the same padding).

crane_tpu runs the convs channels-last with ``[k, Cin, Cout]`` weights; the
port keeps PyTorch's ``[B, C, T]`` and the checkpoint's ``[Cout, Cin, k]``
(transposed convs: ``[Cin, Cout / groups, k]``, as stored, the frame-rate
upsample depthwise with ``upsample_groups`` groups). The transformers run
``[B, T, C]`` through the port's plain ``ops/attention.py``
``gqa_attention`` with the 250-token window, as crane_tpu's do: no Pallas
kernel is on this path, and none is here. A decode runs eagerly, once a
chunk of 300 frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.models.modules.vision import layer_norm
from crane_tpu_torch.models.speech_tokenizer import causal_conv
from crane_tpu_torch.ops.attention import gqa_attention
from crane_tpu_torch.ops.rope import apply_rope_embeds, rope_table
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class MimiCodecConfig:
    sampling_rate: int = 24000
    frame_rate: float = 12.5
    encodec_frame_rate: float = 25.0
    hidden_size: int = 512
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: tuple = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    # transformer
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    rope_theta: float = 10000.0
    sliding_window: int = 250
    norm_eps: float = 1e-5
    upsample_groups: int = 512

    @property
    def upsample_stride(self) -> int:
        return 2  # encodec_frame_rate / frame_rate


# -- encodec conv semantics ([B, C, T]) ----------------------------------------


def _conv_transpose(x, w_t, b, *, stride, groups=1):
    """torch ConvTranspose1d (padding=0, weight ``[Cin, Cout/groups, k]``)
    then Mimi's causal right-trim of ``k - stride``."""
    k = w_t.shape[-1]
    y = F.conv_transpose1d(x, w_t, b, stride=stride, groups=groups)
    trim = k - stride
    return y[..., : y.shape[-1] - trim] if trim > 0 else y


def _resnet_block(p, x, *, dilation, pad_mode="zero"):
    h = causal_conv(F.elu(x), p["conv1_w"], p["conv1_b"], dilation=dilation, pad_mode=pad_mode)
    h = causal_conv(F.elu(h), p["conv2_w"], p["conv2_b"], pad_mode=pad_mode)
    return x + h  # identity shortcut (use_conv_shortcut=False in Mimi)


# -- SEANet encoder / decoder --------------------------------------------------


def seanet_encode(cfg: MimiCodecConfig, p: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio ``[B, 1, N]`` -> latent ``[B, hidden, T]``."""
    x = causal_conv(audio, p["init_w"], p["init_b"])
    for stage, ratio in zip(p["stages"], reversed(cfg.upsampling_ratios)):
        for j, rb in enumerate(stage["res"]):
            x = _resnet_block(rb, x, dilation=cfg.dilation_growth_rate ** j)
        x = causal_conv(F.elu(x), stage["down_w"], stage["down_b"], stride=ratio)
    return causal_conv(F.elu(x), p["final_w"], p["final_b"])


def seanet_decode(cfg: MimiCodecConfig, p: dict, latent: torch.Tensor) -> torch.Tensor:
    """latent ``[B, hidden, T]`` -> audio ``[B, 1, N]``."""
    x = causal_conv(latent, p["init_w"], p["init_b"])
    for stage, ratio in zip(p["stages"], cfg.upsampling_ratios):
        x = _conv_transpose(F.elu(x), stage["up_w"], stage["up_b"], stride=ratio)
        for j, rb in enumerate(stage["res"]):
            x = _resnet_block(rb, x, dilation=cfg.dilation_growth_rate ** j)
    return causal_conv(F.elu(x), p["final_w"], p["final_b"])


# -- windowed causal transformer ([B, T, E]) -----------------------------------


def mimi_transformer(cfg: MimiCodecConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    H, D = cfg.num_attention_heads, cfg.head_dim
    cos, sin = rope_table(D, T, theta=cfg.rope_theta, device=x.device)
    pos = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    cos_bs, sin_bs = cos[None].expand(B, T, -1), sin[None].expand(B, T, -1)
    for lp in p["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        q = apply_rope_embeds((h @ lp["wq"]).reshape(B, T, H, D), cos_bs, sin_bs)
        k = apply_rope_embeds((h @ lp["wk"]).reshape(B, T, H, D), cos_bs, sin_bs)
        v = (h @ lp["wv"]).reshape(B, T, H, D)
        o = gqa_attention(q, k, v, pos, scale=D ** -0.5, window=cfg.sliding_window)
        x = x + lp["scale1"] * (o.reshape(B, T, H * D) @ lp["wo"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        x = x + lp["scale2"] * (F.gelu(h @ lp["fc1"]) @ lp["fc2"])
    return x


# -- residual vector quantizer -------------------------------------------------


def rvq_decode(p: dict, codes: torch.Tensor, n_sem: int) -> torch.Tensor:
    """codes ``[B, K, T]`` int -> latent ``[B, T, hidden]``.

    ``p["sem_codebooks"]``, ``p["ac_codebooks"]``: ``[n, codebook_size,
    dim]`` (embed_sum / usage normalized at load); ``p["sem_out"]``,
    ``p["ac_out"]``: output projections ``[dim, hidden]``. A code past the
    table (CSM's audio vocabulary holds 2051 ids for 2048 codewords) reads
    the last row, as crane_tpu's gather clamps it."""
    codes = codes.long().clamp(0, p["sem_codebooks"].shape[1] - 1)
    K = codes.shape[1]
    sem_sum = sum(p["sem_codebooks"][i][codes[:, i]] for i in range(n_sem))  # [B, T, dim]
    out = sem_sum @ p["sem_out"]
    if K > n_sem:
        ac_sum = sum(p["ac_codebooks"][i - n_sem][codes[:, i]] for i in range(n_sem, K))
        out = out + ac_sum @ p["ac_out"]
    return out


def _quantize_chain(x, codebooks, in_proj, n):
    """x ``[B, T, hidden]`` -> codes ``[B, n, T]``: the input projection,
    then the residual nearest-codeword chain."""
    resid = x @ in_proj  # [B, T, dim]
    idxs = []
    for i in range(n):
        cb = codebooks[i]  # [size, dim]
        d = (resid ** 2).sum(-1, keepdim=True) - 2 * resid @ cb.T + (cb ** 2).sum(-1)[None, None]
        idx = torch.argmin(d, dim=-1)
        idxs.append(idx)
        resid = resid - cb[idx]
    return torch.stack(idxs, dim=1)


def rvq_encode(p: dict, latent: torch.Tensor, num_quantizers: int, n_sem: int) -> torch.Tensor:
    """latent ``[B, T, hidden]`` -> codes ``[B, K, T]`` int32."""
    codes = [_quantize_chain(latent, p["sem_codebooks"], p["sem_in"], n_sem)]
    if num_quantizers > n_sem:
        codes.append(_quantize_chain(latent, p["ac_codebooks"], p["ac_in"],
                                     num_quantizers - n_sem))
    return torch.cat(codes, dim=1).to(torch.int32)


# -- full codec ----------------------------------------------------------------


@torch.no_grad()
def mimi_decode(cfg: MimiCodecConfig, params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, K, T]`` -> audio ``[B, N]``."""
    latent = rvq_decode(params["rvq"], codes, cfg.num_semantic_quantizers).transpose(1, 2)
    latent = _conv_transpose(latent, params["upsample_w"], None, stride=cfg.upsample_stride,
                             groups=cfg.upsample_groups)
    latent = mimi_transformer(cfg, params["dec_transformer"], latent.transpose(1, 2))
    return seanet_decode(cfg, params["decoder"], latent.transpose(1, 2))[:, 0]


@torch.no_grad()
def mimi_encode(cfg: MimiCodecConfig, params: dict, audio: torch.Tensor,
                num_quantizers: int) -> torch.Tensor:
    """audio ``[B, N]`` -> codes ``[B, num_quantizers, T]`` int32."""
    x = seanet_encode(cfg, params["encoder"], audio[:, None, :])
    x = mimi_transformer(cfg, params["enc_transformer"], x.transpose(1, 2)).transpose(1, 2)
    x = causal_conv(x, params["downsample_w"], None, stride=cfg.upsample_stride,
                    pad_mode="replicate")
    return rvq_encode(params["rvq"], x.transpose(1, 2), num_quantizers,
                      cfg.num_semantic_quantizers)


def map_mimi_weights(cfg: MimiCodecConfig, sd: dict, dtype=torch.float32, device=None) -> dict:
    """Map an HF MimiModel state dict (torch tensors or numpy arrays) to the
    port's param tree: convs as stored (``[Cout, Cin, k]``; transposed convs
    ``[Cin, Cout / groups, k]``), linears ``[in, out]``, codebooks
    normalized in float64 then cast, as crane_tpu does."""
    def a(n):
        return torch.as_tensor(sd[n]).to(device=device, dtype=dtype)

    def t(n):
        return a(n).T.contiguous()

    def seanet(prefix: str, *, decoder: bool) -> dict:
        idx = 0
        p: dict = {"init_w": a(f"{prefix}.layers.{idx}.conv.weight"),
                   "init_b": a(f"{prefix}.layers.{idx}.conv.bias")}
        idx += 1
        stages = []
        ratios = list(cfg.upsampling_ratios) if decoder else list(reversed(cfg.upsampling_ratios))
        for _ in ratios:
            stage: dict = {"res": []}
            if decoder:
                idx += 1  # ELU
                stage["up_w"] = a(f"{prefix}.layers.{idx}.conv.weight")  # [Cin, Cout/g, k]
                stage["up_b"] = a(f"{prefix}.layers.{idx}.conv.bias")
                idx += 1
            for _ in range(cfg.num_residual_layers):
                stage["res"].append({
                    "conv1_w": a(f"{prefix}.layers.{idx}.block.1.conv.weight"),
                    "conv1_b": a(f"{prefix}.layers.{idx}.block.1.conv.bias"),
                    "conv2_w": a(f"{prefix}.layers.{idx}.block.3.conv.weight"),
                    "conv2_b": a(f"{prefix}.layers.{idx}.block.3.conv.bias"),
                })
                idx += 1
            if not decoder:
                idx += 1  # ELU
                stage["down_w"] = a(f"{prefix}.layers.{idx}.conv.weight")
                stage["down_b"] = a(f"{prefix}.layers.{idx}.conv.bias")
                idx += 1
            stages.append(stage)
        idx += 1  # final ELU
        p["stages"] = tuple(stages)
        p["final_w"] = a(f"{prefix}.layers.{idx}.conv.weight")
        p["final_b"] = a(f"{prefix}.layers.{idx}.conv.bias")
        return p

    def transformer(prefix: str) -> dict:
        layers = []
        for i in range(cfg.num_hidden_layers):
            lp = f"{prefix}.layers.{i}."
            layers.append({
                "ln1_w": a(lp + "input_layernorm.weight"),
                "ln1_b": a(lp + "input_layernorm.bias"),
                "ln2_w": a(lp + "post_attention_layernorm.weight"),
                "ln2_b": a(lp + "post_attention_layernorm.bias"),
                "wq": t(lp + "self_attn.q_proj.weight"),
                "wk": t(lp + "self_attn.k_proj.weight"),
                "wv": t(lp + "self_attn.v_proj.weight"),
                "wo": t(lp + "self_attn.o_proj.weight"),
                "fc1": t(lp + "mlp.fc1.weight"),
                "fc2": t(lp + "mlp.fc2.weight"),
                "scale1": a(lp + "self_attn_layer_scale.scale"),
                "scale2": a(lp + "mlp_layer_scale.scale"),
            })
        return {"layers": tuple(layers)}

    def rvq_params() -> dict:
        def f64(n):
            return torch.as_tensor(sd[n]).to(torch.float64)

        def chain(prefix: str, n: int):
            cbs = [f64(f"{prefix}.layers.{i}.codebook.embed_sum")
                   / torch.clamp(f64(f"{prefix}.layers.{i}.codebook.cluster_usage"),
                                 min=1e-5)[:, None]
                   for i in range(n)]
            return torch.stack(cbs).to(device=device, dtype=dtype)

        def proj(n):
            return a(n)[:, :, 0].T.contiguous()

        n_sem = cfg.num_semantic_quantizers
        n_ac = cfg.num_quantizers - n_sem
        sq = "quantizer.semantic_residual_vector_quantizer"
        aq = "quantizer.acoustic_residual_vector_quantizer"
        return {
            "sem_codebooks": chain(sq, n_sem),
            "ac_codebooks": chain(aq, n_ac) if n_ac else None,
            "sem_in": proj(sq + ".input_proj.weight"),
            "sem_out": proj(sq + ".output_proj.weight"),
            "ac_in": proj(aq + ".input_proj.weight") if n_ac else None,
            "ac_out": proj(aq + ".output_proj.weight") if n_ac else None,
        }

    return {
        "encoder": seanet("encoder", decoder=False),
        "decoder": seanet("decoder", decoder=True),
        "enc_transformer": transformer("encoder_transformer"),
        "dec_transformer": transformer("decoder_transformer"),
        "rvq": rvq_params(),
        "downsample_w": a("downsample.conv.weight"),
        "upsample_w": a("upsample.conv.weight"),
    }


def mimi_config_from_hf(hf: dict) -> MimiCodecConfig:
    """A MimiCodecConfig from an HF MimiModel config (or CSM's
    ``codec_config``)."""
    return MimiCodecConfig(
        sampling_rate=hf.get("sampling_rate", 24000),
        frame_rate=hf.get("frame_rate", 12.5),
        hidden_size=hf["hidden_size"],
        num_filters=hf["num_filters"],
        num_residual_layers=hf.get("num_residual_layers", 1),
        upsampling_ratios=tuple(hf["upsampling_ratios"]),
        kernel_size=hf.get("kernel_size", 7),
        last_kernel_size=hf.get("last_kernel_size", 3),
        residual_kernel_size=hf.get("residual_kernel_size", 3),
        dilation_growth_rate=hf.get("dilation_growth_rate", 2),
        codebook_size=hf["codebook_size"],
        codebook_dim=hf.get("codebook_dim") or hf.get("vector_quantization_hidden_dimension", 256),
        num_quantizers=hf["num_quantizers"],
        num_semantic_quantizers=hf.get("num_semantic_quantizers", 1),
        num_hidden_layers=hf.get("num_hidden_layers", 8),
        num_attention_heads=hf.get("num_attention_heads", 8),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf.get("num_attention_heads", 8),
        intermediate_size=hf.get("intermediate_size", 2048),
        rope_theta=hf.get("rope_theta", 10000.0),
        sliding_window=hf.get("sliding_window", 250),
        norm_eps=hf.get("norm_eps", 1e-5),
        upsample_groups=hf.get("upsample_groups", hf["hidden_size"]),
    )


class MimiCodec:
    """The codec on the parameters' device; numpy in and out."""

    def __init__(self, config: MimiCodecConfig, params: dict):
        self.config = config
        self.params = params
        self.device = params["upsample_w"].device

    def decode(self, codes) -> np.ndarray:
        """codes ``[B, K, T]`` -> audio ``[B, N]``."""
        c = torch.as_tensor(np.asarray(codes), device=self.device)
        return mimi_decode(self.config, self.params, c).float().cpu().numpy()

    def encode(self, audio, num_quantizers: int | None = None) -> np.ndarray:
        """audio ``[B, N]`` -> codes ``[B, K, T]`` int32."""
        nq = num_quantizers or self.config.num_quantizers
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        return mimi_encode(self.config, self.params, x, nq).cpu().numpy()

    @classmethod
    def from_pretrained(cls, model_dir: str, *, device=None) -> "MimiCodec":
        """Load from an HF MimiModel checkpoint directory onto ``device`` (the
        card unless the caller asks for the CPU)."""
        import json
        import os

        from crane_tpu_torch.loaders.safetensors_loader import load_state_dict

        device = default_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = mimi_config_from_hf(json.load(f))
        return cls(cfg, map_mimi_weights(cfg, load_state_dict(model_dir), device=device))

    def chunked_decode(self, codes, chunk: int = 300, overlap: int = 25) -> np.ndarray:
        """Streaming decode with left-context overlap trim (reference
        speech_tokenizer_v2.rs chunked_decode(codes, 300, 25)): each chunk is
        decoded with ``overlap`` frames of left context whose samples are
        trimmed from the output."""
        codes = np.asarray(codes)
        T = codes.shape[2]
        ups = int(np.prod(self.config.upsampling_ratios) * self.config.upsample_stride)
        outs = []
        start = 0
        while start < T:
            ctx = min(overlap, start)
            end = min(start + chunk, T)
            outs.append(self.decode(codes[:, :, start - ctx:end])[:, ctx * ups:])
            start = end
        return np.concatenate(outs, axis=1)
