"""Normalization ops (port of ``crane_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    eps: float = 1e-6,
    weight_offset: float = 0.0,
) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to x's dtype.
    ``weight_offset=1.0`` gives the unit-offset variant ``x_hat * (1 + w)``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if weight_offset != 0.0:
        w = w + weight_offset
    return (normed * w).to(x.dtype)


def gated_rms_norm(
    x: torch.Tensor,
    gate: torch.Tensor,
    weight: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """RMSNorm(x) * weight * silu(gate), the GDN output norm, in float32
    and cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps) * weight.float()
    g = gate.float()
    return (normed * (g * torch.sigmoid(g))).to(x.dtype)
