"""ECAPA-TDNN speaker encoder for voice-clone x-vectors, checkpoint-parity.

Port of ``crane_tpu/models/speaker_encoder.py``. Reference behavior
(crane-core ``src/models/qwen3_tts/modeling.rs:953-1223``): SpeakerEncoder =
initial TDNN (reflect-padded conv + ReLU) -> SE-Res2Net blocks (tdnn1 k=1 ->
Res2Net chunked dilated convs -> tdnn2 k=1 -> squeeze-excitation, +
residual) -> multi-layer feature aggregation over the SE block outputs ->
attentive statistics pooling (attention = softmax_T(conv(tanh(relu(conv([x,
mean, std])))))) -> k=1 conv to ``enc_dim``. No batch norms, no output
normalization — the layout matches the released checkpoint's
``speaker_encoder.*`` tensors exactly.

Input is a log-mel at the reference's speaker constants (model.rs:417-435):
n_fft=1024, hop=256, 128 mels, 24 kHz, fmin=0, fmax=12000, Hann,
reflect-padded by (n_fft-hop)/2, MAGNITUDE spectrum, ln compression
(``audio/mel.py``'s ``log_mode="ln"``, ``spectrum="magnitude"``,
``center_pad="stft"``).

crane_tpu runs the net channels-last with ``[k, Cin, Cout]`` weights; the
port keeps PyTorch's ``[B, C, T]`` and ``[Cout, Cin, k]`` (the checkpoint's
own layout) and runs ``F.conv1d``. crane_tpu has no Pallas kernel here, and
nor does the port: the net runs once a voice-clone request, eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram

SPEAKER_MEL = MelConfig(
    n_fft=1024, hop_length=256, n_mels=128, sampling_rate=24000,
    fmin=0.0, fmax=12000.0, log_mode="ln", spectrum="magnitude",
    center_pad="stft",
)


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    """Reference SpeakerEncoderConfig defaults (modeling.rs:151-195)."""

    mel_dim: int = 128
    enc_dim: int = 1024
    enc_channels: tuple = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: tuple = (5, 3, 3, 3, 1)
    enc_dilations: tuple = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    sample_rate: int = 24000


def _reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``jnp.pad(..., mode="reflect")`` of ``[B, C, T]`` along T, which
    reflects again where a pad is longer than the signal (``F.pad``'s reflect
    mode refuses that), as a gather."""
    T = x.shape[-1]
    i = np.arange(-left, T + right)
    if T == 1:
        i = np.zeros_like(i)
    else:
        period = 2 * (T - 1)
        i = np.mod(i, period)
        i = np.where(i >= T, period - i, i)
    return x[..., torch.as_tensor(i, device=x.device)]


def _reflect_conv(x, w, b, *, dilation=1):
    """x ``[B, C, T]``; w ``[Cout, Cin, k]``; reflect SAME padding with the
    reference's asymmetric split (modeling.rs:959-972: left = total//2)."""
    k = w.shape[-1]
    total = dilation * (k - 1)
    left = total // 2
    if total:
        x = _reflect_pad(x, left, total - left)
    return F.conv1d(x, w, b, dilation=dilation)


def tdnn_block(p, x, *, dilation=1):
    """Reflect-padded conv + ReLU (modeling.rs:976-988)."""
    return F.relu(_reflect_conv(x, p["w"], p["b"], dilation=dilation))


def res2net_block(p, x, *, scale, dilation):
    """Res2Net over channel chunks (modeling.rs:990-1029): chunk 0 passes
    through; chunk 1 is convolved alone; chunk i>=2 is convolved after
    adding the previous chunk's conv output."""
    parts = torch.chunk(x, scale, dim=1)
    outs = [parts[0]]
    prev = None
    for i in range(1, scale):
        inp = parts[i] if prev is None else parts[i] + prev
        prev = tdnn_block(p["blocks"][i - 1], inp, dilation=dilation)
        outs.append(prev)
    return torch.cat(outs, dim=1)


def se_block(p, x):
    """Squeeze-excitation (modeling.rs:1031-1053): global T-mean ->
    conv1(k=1)+ReLU -> conv2(k=1)+sigmoid channel gates."""
    s = x.mean(dim=2, keepdim=True)
    s = F.relu(F.conv1d(s, p["w1"], p["b1"]))
    s = torch.sigmoid(F.conv1d(s, p["w2"], p["b2"]))
    return x * s


def se_res2net_block(p, x, *, scale, dilation):
    """tdnn1(k=1) -> Res2Net -> tdnn2(k=1) -> SE, + residual
    (modeling.rs:1055-1080)."""
    h = tdnn_block(p["tdnn1"], x)
    h = res2net_block(p["res2net"], h, scale=scale, dilation=dilation)
    h = tdnn_block(p["tdnn2"], h)
    h = se_block(p["se"], h)
    return x + h


def attentive_stats_pool(p, x):
    """Attentive statistics pooling (modeling.rs:1082-1130): attention
    logits = conv(tanh(relu(tdnn([x, mean, std])))), softmax over T;
    output = [weighted mean, weighted std] with the reference's 1e-5
    variance epsilon. x ``[B, C, T]`` -> ``[B, 2C]``."""
    mu = x.mean(dim=2, keepdim=True)
    sg = torch.sqrt(((x - mu) ** 2).mean(dim=2, keepdim=True) + 1e-5)
    ctx = torch.cat([x, mu.expand_as(x), sg.expand_as(x)], dim=1)
    a = torch.tanh(tdnn_block(p["tdnn"], ctx))
    a = F.conv1d(a, p["conv_w"], p["conv_b"])
    a = torch.softmax(a, dim=2)  # over T
    mean = (a * x).sum(dim=2)
    var = (a * (x - mean[:, :, None]) ** 2).sum(dim=2)
    std = torch.sqrt(var + 1e-5)
    return torch.cat([mean, std], dim=-1)


@torch.no_grad()
def ecapa_forward(cfg: EcapaConfig, params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel ``[B, n_mels, T]`` -> speaker embedding ``[B, enc_dim]``
    (modeling.rs:1149-1223). Not normalized — the talker consumes it raw."""
    x = tdnn_block(params["blocks"][0], mel, dilation=cfg.enc_dilations[0])
    feats = []
    for p, d in zip(params["blocks"][1:], cfg.enc_dilations[1:-1]):
        x = se_res2net_block(p, x, scale=cfg.enc_res2net_scale, dilation=d)
        feats.append(x)
    h = tdnn_block(params["mfa"], torch.cat(feats, dim=1), dilation=cfg.enc_dilations[-1])
    pooled = attentive_stats_pool(params["asp"], h)
    return pooled @ params["fc_w"][:, :, 0].T + params["fc_b"]


def map_speaker_encoder_weights(cfg: EcapaConfig, sd: dict, prefix: str = "speaker_encoder.",
                                device=None) -> dict:
    """Map the released checkpoint's ``speaker_encoder.*`` tensors (torch
    Conv1d ``[Cout, Cin, k]``, kept so; torch tensors or numpy arrays) to the
    params tree, float32 on ``device``."""
    def arr(n):
        return torch.as_tensor(sd[n]).to(device=device, dtype=torch.float32)

    def w(n):
        return arr(prefix + n + ".weight")

    def b(n):
        return arr(prefix + n + ".bias")

    def tdnn(n):
        return {"w": w(n + ".conv"), "b": b(n + ".conv")}

    n = len(cfg.enc_channels)
    blocks = [tdnn("blocks.0")]
    for i in range(1, n - 1):
        B = f"blocks.{i}."
        blocks.append({
            "tdnn1": tdnn(B + "tdnn1"),
            "res2net": {"blocks": [tdnn(f"{B}res2net_block.blocks.{j}")
                                   for j in range(cfg.enc_res2net_scale - 1)]},
            "tdnn2": tdnn(B + "tdnn2"),
            "se": {"w1": w(B + "se_block.conv1"), "b1": b(B + "se_block.conv1"),
                   "w2": w(B + "se_block.conv2"), "b2": b(B + "se_block.conv2")},
        })
    return {
        "blocks": blocks,
        "mfa": tdnn("mfa"),
        "asp": {"tdnn": tdnn("asp.tdnn"), "conv_w": w("asp.conv"), "conv_b": b("asp.conv")},
        "fc_w": w("fc"), "fc_b": b("fc"),
    }


def speaker_encoder_shapes(cfg: EcapaConfig, prefix: str = "speaker_encoder.") -> dict:
    """The checkpoint's ``speaker_encoder.*`` names and shapes at ``cfg``."""
    shapes: dict = {}

    def conv(name, cin, cout, k):
        shapes[name + ".weight"] = (cout, cin, k)
        shapes[name + ".bias"] = (cout,)

    ch, ks = cfg.enc_channels, cfg.enc_kernel_sizes
    n = len(ch)
    conv(prefix + "blocks.0.conv", cfg.mel_dim, ch[0], ks[0])
    s = cfg.enc_res2net_scale
    for i in range(1, n - 1):
        B = f"{prefix}blocks.{i}."
        conv(B + "tdnn1.conv", ch[i - 1], ch[i], 1)
        for j in range(s - 1):
            conv(f"{B}res2net_block.blocks.{j}.conv", ch[i] // s, ch[i] // s, ks[i])
        conv(B + "tdnn2.conv", ch[i], ch[i], 1)
        conv(B + "se_block.conv1", ch[i], cfg.enc_se_channels, 1)
        conv(B + "se_block.conv2", cfg.enc_se_channels, ch[i], 1)
    conv(prefix + "mfa.conv", sum(ch[1:n - 1]), ch[-1], ks[-1])
    conv(prefix + "asp.tdnn.conv", 3 * ch[-1], cfg.enc_attention_channels, 1)
    conv(prefix + "asp.conv", cfg.enc_attention_channels, ch[-1], 1)
    conv(prefix + "fc", 2 * ch[-1], cfg.enc_dim, 1)
    return shapes


def random_speaker_encoder_state_dict(cfg: EcapaConfig, seed: int = 0) -> dict:
    """Random state dict in the released ``speaker_encoder.*`` layout
    (tests / dry-runs; real shapes, arbitrary values): numpy arrays drawn as
    crane_tpu draws them (the same seed gives the same values)."""
    rng = np.random.default_rng(seed)
    sd: dict = {}
    for name, shape in speaker_encoder_shapes(cfg).items():
        if name.endswith(".bias"):
            sd[name] = np.zeros(shape, np.float32)
        else:
            cout, cin, k = shape
            sd[name] = (rng.normal(size=shape) * (k * cin) ** -0.5).astype(np.float32)
    return sd


def init_ecapa_params(cfg: EcapaConfig, seed: int = 0, device=None) -> dict:
    """Random params at ``cfg`` shapes (tests / dry-runs)."""
    return map_speaker_encoder_weights(cfg, random_speaker_encoder_state_dict(cfg, seed),
                                       device=device)


class SpeakerEncoder:
    """Raw 24 kHz audio (or a precomputed log-mel) -> speaker x-vector, on
    the parameters' device (the CPU when none are given)."""

    def __init__(self, cfg: EcapaConfig | None = None, params: dict | None = None):
        self.cfg = cfg or EcapaConfig()
        self.params = params if params is not None else init_ecapa_params(self.cfg)
        self.device = self.params["fc_w"].device
        self.mel_cfg = dataclasses.replace(
            SPEAKER_MEL, n_mels=self.cfg.mel_dim, sampling_rate=self.cfg.sample_rate
        )

    def embed(self, mel) -> np.ndarray:
        """log-mel ``[n_mels, T]`` (or batched) -> embedding ``[B, enc_dim]``."""
        mel = torch.as_tensor(np.asarray(mel, np.float32), device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        return ecapa_forward(self.cfg, self.params, mel).cpu().numpy()

    def __call__(self, audio) -> np.ndarray:
        """audio mono float32 ``[N]`` at ``cfg.sample_rate`` -> ``[enc_dim]``
        (the SDK's ``model.speaker_encoder`` contract; reference
        model.rs:411-450 computes exactly this mel -> ECAPA chain)."""
        wav = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        mel = log_mel_spectrogram(self.mel_cfg, wav)
        return ecapa_forward(self.cfg, self.params, mel[None]).cpu().numpy()[0]

    def similarity(self, mel_a, mel_b) -> float:
        ea, eb = self.embed(mel_a)[0], self.embed(mel_b)[0]
        ea = ea / np.linalg.norm(ea).clip(1e-9)
        eb = eb / np.linalg.norm(eb).clip(1e-9)
        return float(np.dot(ea, eb))
