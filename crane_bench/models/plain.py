"""Plain float32 operations the architectures' references share: written from
the published descriptions (HF transformers' modeling files), with no
kernel, cache or batching. Weights are HF's ``[out, in]`` tensors."""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F


def exact_float32() -> None:
    """Matrix products in full float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32)


class _Products(threading.local):
    fp8 = False


_products = _Products()


@contextlib.contextmanager
def fp8_products():
    """Every product's activations rounded to float8 e4m3 rows inside (the
    control: the reference computed in fp8, its weights drawn so too)."""
    _products.fp8 = True
    try:
        yield
    finally:
        _products.fp8 = False


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if _products.fp8:
        from crane_bench.weights import fp8_rows

        x = fp8_rows(x)
    return x @ f32(w).T


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, offset: float = 0.0) -> torch.Tensor:
    """``x / rms(x) * (offset + w)`` over the last axis."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (offset + f32(w))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, rot: int) -> torch.Tensor:
    """Rotary embedding of the first ``rot`` dims of ``x [L, H, D]`` at
    ``positions [L]``, halves rotated against each other (HF ``rotate_half``);
    the rest pass through."""
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], -1)
    return torch.cat([xr * cos + rotated * sin, xp], -1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     block: int = 1024) -> torch.Tensor:
    """Softmax attention of ``q [L, H, D]`` over ``k, v [L, Hkv, D]`` (query
    heads grouped over the key heads), each position over itself and every
    earlier one; queries in blocks of ``block`` rows. Returns ``[L, H, D]``."""
    L, H, D = q.shape
    g = H // k.shape[1]
    kh = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, L, D]
    vh = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(L, device=q.device)
    for s in range(0, L, block):
        qb = q[s:s + block].transpose(0, 1)  # [H, b, D]
        scores = (qb @ kh.transpose(1, 2)) * scale  # [H, b, L]
        rows = torch.arange(s, s + qb.shape[1], device=q.device)
        scores = scores.masked_fill(keys[None, None, :] > rows[None, :, None], float("-inf"))
        out[s:s + block] = (torch.softmax(scores, -1) @ vh).transpose(0, 1)
    return out


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, gate)) * linear(x, up), down)
