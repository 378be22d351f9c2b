"""Safetensors checkpoint loading (single-file and sharded-index).

Port of ``crane_tpu/loaders/safetensors_loader.py``: the same file
resolution (``model.safetensors.index.json``, else ``model.safetensors``,
else every ``.safetensors`` file in the directory), with torch tensors in
place of JAX arrays. Tensors load on the host in their stored dtype; the
caller casts and moves them. ``safetensors`` is imported inside the
functions: the machine with the card has no such package, and the port's
modules import there.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import torch


def resolve_safetensors_files(model_dir: str) -> list[str]:
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return [os.path.join(model_dir, f) for f in sorted(set(weight_map.values()))]
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return [single]
    files = sorted(os.path.join(model_dir, f) for f in os.listdir(model_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors checkpoint under {model_dir}")
    return files


def iter_safetensors(model_dir: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield (name, tensor) for every tensor in the checkpoint."""
    from safetensors import safe_open

    for path in resolve_safetensors_files(model_dir):
        with safe_open(path, framework="pt") as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def load_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    return dict(iter_safetensors(model_dir))


def save_state_dict(state: dict[str, torch.Tensor], path: str) -> None:
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in state.items()}, path)
