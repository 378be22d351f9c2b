"""The device an entry point places a model on when its caller names none."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as given; by default the card (``cuda``). With no card and
    no ``device`` this raises: the port runs on the CPU only when asked
    (``device="cpu"``), never by falling back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
