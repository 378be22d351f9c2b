"""The native detector / recognizer nets of the two-stage OCR pipeline.

Port of ``crane_tpu/ocr/nets.py``. Reference behavior: PaddleOCR v6 small
det/rec ONNX graphs (crane-core ``src/models/paddleocr_v6/model.rs:1-128``)
— a DB-style segmentation detector emitting a text-probability map at input
resolution, and an SVTR-style recognizer emitting CTC logits ``[B, T, C]``
with T = W/8. crane_tpu runs compact nets of that shape natively, with its
own parameterization; so does the port, as plain PyTorch on the caller's
device (crane_tpu computes them with XLA's convolutions and einsums, no
Pallas kernel).

Where a line-by-line port would part from crane_tpu:

- ``SAME`` padding with stride 2 pads ``(0, 1)`` on an even input (k=3), as
  XLA does, where ``Conv2d(padding=1)`` would pad ``(1, 1)`` and shift the
  output by a pixel: :func:`_same_pad` pads explicitly;
- ``jax.nn.gelu`` is the tanh approximation: ``F.gelu(approximate="tanh")``;
- the 2x up-sampling is ``jax.image.resize(..., "bilinear")``, whose
  half-pixel triangle weights (renormalised at the edges) equal
  ``F.interpolate(mode="bilinear", align_corners=False)`` when it enlarges.

Conv weights are PyTorch's ``[Cout, Cin, kh, kw]`` (crane_tpu's are HWIO;
``utils/bridge.py`` :func:`~crane_tpu_torch.utils.bridge.ocr_params_from_jax`
carries them across). crane_tpu draws the default weights with
``jax.random``; the port draws them from a seeded ``torch.Generator`` at the
same scales (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crane_tpu_torch.utils.device import default_device


def _same_pad(x: torch.Tensor, k: tuple[int, int], stride: tuple[int, int]) -> torch.Tensor:
    """XLA's ``SAME`` padding of an NCHW input for a ``k`` kernel at
    ``stride``: out = ceil(in / s), the total pad split with the odd pixel
    on the bottom / right."""
    pads = []
    for size, kk, s in zip(x.shape[-1:-3:-1], k[::-1], stride[::-1]):
        total = max((-(-size // s) - 1) * s + kk - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv_hw(x: torch.Tensor, p: dict, *, stride: tuple[int, int]) -> torch.Tensor:
    """NCHW conv + bias with ``SAME`` padding and (sh, sw) strides."""
    w = p["w"]
    return F.conv2d(_same_pad(x, tuple(w.shape[2:]), stride), w, p["b"], stride=stride)


def _conv(x: torch.Tensor, p: dict, *, stride: int = 1) -> torch.Tensor:
    return _conv_hw(x, p, stride=(stride, stride))


def _block(x: torch.Tensor, p: dict, *, stride: int = 1) -> torch.Tensor:
    return torch.relu(_conv(x, p, stride=stride))


def _up2(t: torch.Tensor) -> torch.Tensor:
    return F.interpolate(t, scale_factor=2.0, mode="bilinear", align_corners=False)


@torch.no_grad()
def db_detector(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[B,3,H,W] (H,W % 32 == 0) -> text probability map [B,1,H,W].

    DB shape: stride-2 backbone to /16, top-down FPN merge, head upsampled
    back to input resolution with a sigmoid binarization."""
    c1 = _block(x, params["stem"], stride=2)      # /2
    c2 = _block(c1, params["down1"], stride=2)    # /4
    c3 = _block(c2, params["down2"], stride=2)    # /8
    c4 = _block(c3, params["down3"], stride=2)    # /16
    p3 = _block(c3, params["lat2"]) + _up2(_block(c4, params["lat3"]))
    p2 = _block(c2, params["lat1"]) + _up2(p3)
    h = _block(p2, params["head1"])               # /4
    h = _up2(_up2(h))                             # /1
    return torch.sigmoid(_conv(h, params["head2"]))


def _layer_norm(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = t.mean(-1, keepdim=True)
    var = ((t - mu) ** 2).mean(-1, keepdim=True)
    return (t - mu) * torch.rsqrt(var + 1e-6) * w + b


@torch.no_grad()
def ctc_recognizer(params: dict, x: torch.Tensor, *, heads: int = 4) -> torch.Tensor:
    """[B,3,48,W] crops -> CTC logits [B, W/8, n_classes].

    SVTR shape: conv stack collapsing height 48 -> 1 while keeping width at
    W/8, then a small bidirectional transformer encoder over the width axis,
    then the CTC projection."""
    h = _block(x, params["c1"])                                   # 48 x W
    h = torch.relu(_conv_hw(h, params["c2"], stride=(2, 2)))      # 24 x W/2
    h = torch.relu(_conv_hw(h, params["c3"], stride=(2, 2)))      # 12 x W/4
    h = torch.relu(_conv_hw(h, params["c4"], stride=(2, 2)))      # 6  x W/8
    h = h.amax(dim=2).transpose(1, 2)                             # [B,T,C] height pool
    for p in params["encoder"]:
        # pre-norm bidirectional self-attention + GELU MLP
        a = _layer_norm(h, p["ln1_w"], p["ln1_b"])
        B, T, C = a.shape
        qkv = (a @ p["wqkv"]).reshape(B, T, 3, heads, C // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bthd,bshd->bhts", q, k) * (C // heads) ** -0.5
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, C)
        h = h + o @ p["wo"]
        m = _layer_norm(h, p["ln2_w"], p["ln2_b"])
        h = h + F.gelu(m @ p["w1"], approximate="tanh") @ p["w2"]
    return h @ params["ctc_w"] + params["ctc_b"]


def _drawer(seed: int, device):
    """(normal draw at a scale, zeros) on ``device`` from a CPU
    ``torch.Generator`` seeded with ``seed``."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)

    def nrm(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return nrm, zeros, device


def init_detector_params(channels: int = 24, seed: int = 0, device=None) -> dict:
    """The detector's weights at crane_tpu's scales (normal, std
    ``fan_in ** -0.5``; zero biases), drawn from a seeded ``torch.Generator``
    on ``device`` (the card unless the caller asks for the CPU)."""
    nrm, zeros, _ = _drawer(seed, device)
    C = channels

    def conv(kh, kw, cin, cout):
        return {"w": nrm((cout, cin, kh, kw), (kh * kw * cin) ** -0.5), "b": zeros(cout)}

    return {
        "stem": conv(3, 3, 3, C),
        "down1": conv(3, 3, C, C),
        "down2": conv(3, 3, C, 2 * C),
        "down3": conv(3, 3, 2 * C, 2 * C),
        "lat1": conv(1, 1, C, C),
        "lat2": conv(1, 1, 2 * C, C),
        "lat3": conv(1, 1, 2 * C, C),
        "head1": conv(3, 3, C, C),
        "head2": conv(3, 3, C, 1),
    }


def init_recognizer_params(
    n_classes: int, channels: int = 64, layers: int = 2, heads: int = 4, seed: int = 0,
    device=None,
) -> dict:
    """The recognizer's weights at crane_tpu's scales, drawn from a seeded
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    the CPU). ``heads`` is the caller's to pass to :func:`ctc_recognizer`."""
    nrm, zeros, device = _drawer(seed, device)
    C = channels

    def conv(cin, cout):
        return {"w": nrm((cout, cin, 3, 3), (9 * cin) ** -0.5), "b": zeros(cout)}

    def enc():
        return {
            "ln1_w": torch.ones((C,), device=device), "ln1_b": zeros(C),
            "ln2_w": torch.ones((C,), device=device), "ln2_b": zeros(C),
            "wqkv": nrm((C, 3 * C), C ** -0.5),
            "wo": nrm((C, C), C ** -0.5),
            "w1": nrm((C, 2 * C), C ** -0.5),
            "w2": nrm((2 * C, C), (2 * C) ** -0.5),
        }

    return {
        "c1": conv(3, C // 2),
        "c2": conv(C // 2, C // 2),
        "c3": conv(C // 2, C),
        "c4": conv(C, C),
        "encoder": tuple(enc() for _ in range(layers)),
        "ctc_w": nrm((C, n_classes), C ** -0.5),
        "ctc_b": zeros(n_classes),
    }


class NetCallable:
    """An array -> array callable over a net for
    :class:`~crane_tpu_torch.ocr.pipeline.PaddleOcrPipeline`: the NCHW
    float32 array goes to the parameters' device, the net runs there, and
    the result comes back as a NumPy array."""

    def __init__(self, net, params: dict, **kw):
        self.net, self.params, self.kw = net, params, kw
        self.device = next(iter(_leaves(params))).device

    def __call__(self, x):
        t = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return self.net(self.params, t, **self.kw).float().cpu().numpy()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
