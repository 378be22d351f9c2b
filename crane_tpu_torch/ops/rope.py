"""Rotary position embeddings (port of ``crane_tpu/ops/rope.py``).

Half-width float32 cos/sin tables ``[max_pos, rot_dim / 2]``; rotation in
float32, either half-split (NeoX / HF) or interleaved, with partial rotary
passing the tail dims through.
"""

from __future__ import annotations

import torch


def inv_frequencies(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim)
    )


def rope_table(
    rot_dim: int, max_pos: int, *, theta: float = 10000.0, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-width cos/sin tables, each ``[max_pos, rot_dim // 2]`` float32."""
    if rot_dim % 2:
        raise ValueError(f"rot_dim must be even, got {rot_dim}")
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_frequencies(rot_dim, theta, device))
    return torch.cos(freqs), torch.sin(freqs)


def _rotate_half_split(x, c, s):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def _rotate_interleaved(x, c, s):
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1).reshape(x.shape)


def apply_rope_embeds(
    x: torch.Tensor, cos_bs: torch.Tensor, sin_bs: torch.Tensor, *, mode: str = "half"
) -> torch.Tensor:
    """x ``[B, S, H, D]``; cos_bs/sin_bs pre-gathered ``[B, S, R/2]``."""
    rot = 2 * cos_bs.shape[-1]
    c = cos_bs[:, :, None, :].float()
    s = sin_bs[:, :, None, :].float()
    xr = x[..., :rot].float()
    if mode == "half":
        rotated = _rotate_half_split(xr, c, s)
    elif mode == "interleaved":
        rotated = _rotate_interleaved(xr, c, s)
    else:
        raise ValueError(f"unknown rope mode: {mode!r}")
    rotated = rotated.to(x.dtype)
    if rot == x.shape[-1]:
        return rotated
    return torch.cat((rotated, x[..., rot:]), dim=-1)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str = "half",
) -> torch.Tensor:
    """Apply RoPE to x ``[B, S, H, D]`` at ``positions [B, S]`` from the
    half-width tables ``[max_pos, R/2]`` (``R <= D``)."""
    idx = positions.long()
    return apply_rope_embeds(x, cos[idx], sin[idx], mode=mode)


def mrope_cos_sin(
    positions3: torch.Tensor,
    rot_dim: int,
    mrope_section: tuple[int, int, int],
    *,
    theta: float = 10000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved multimodal RoPE tables from 3-D (T, H, W) positions.

    positions3 ``[3, B, S]`` (a tensor on the model's device, so a captured
    decode block derives it from the cache's lengths with no host integer)
    -> (cos, sin) each ``[B, S, rot_dim / 2]`` float32. Frequency column i
    belongs to H when ``i % 3 == 1 and i < 3 * sec_h``, to W when
    ``i % 3 == 2 and i < 3 * sec_w``, else to T (HF Qwen3VL
    ``apply_interleaved_mrope``). Where the three streams are equal this is
    standard RoPE."""
    device = positions3.device
    half = rot_dim // 2
    freqs = positions3[..., None].float() * inv_frequencies(rot_dim, theta, device)
    _, sec_h, sec_w = mrope_section
    idx = torch.arange(half, device=device)
    own_h = (idx % 3 == 1) & (idx < 3 * sec_h)
    own_w = (idx % 3 == 2) & (idx < 3 * sec_w)
    mixed = torch.where(own_h, freqs[1], torch.where(own_w, freqs[2], freqs[0]))
    return torch.cos(mixed), torch.sin(mixed)
