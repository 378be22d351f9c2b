"""Elementwise activations (port of ``crane_tpu/ops/activations.py``).

``snake`` is the periodic Snake activation ``x + sin^2(alpha x) / alpha``
of vocoder-style nets, and ``atan2`` the two-argument arctangent of an ONNX
Atan2 fusion. crane_tpu writes each as one XLA expression, with no Pallas
kernel; here each is plain PyTorch.
"""

from __future__ import annotations

import torch


def snake(x: torch.Tensor, alpha) -> torch.Tensor:
    """Snake activation ``x + sin^2(alpha x) / alpha``.

    ``alpha`` is a positive per-channel (broadcast against ``x``) or scalar
    frequency. Computed in float32 and cast back to ``x``'s dtype; an
    ``alpha`` of exactly 0 is the identity (the limit)."""
    xf = x.float()
    af = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    s = torch.sin(af * xf)
    zero = af == 0.0
    out = torch.where(zero, xf, xf + s * s / torch.where(zero, 1.0, af))
    return out.to(x.dtype)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Two-argument arctangent in float32, cast back to ``y``'s dtype."""
    return torch.atan2(y.float(), x.float()).to(y.dtype)
