"""HuggingFace-hub fallback for checkpoint/tokenizer paths.

The reference's tokenizer loader falls back to downloading from the hub when
the argument is not a local directory (autotokenizer.rs:232-258), and its
fixture fetcher pulls from an HF dataset (test_data.rs:1-15). Same behavior
here: every public ``from_pretrained``-style entry point accepts either a
local directory or a hub repo id ("Qwen/Qwen3-0.6B"); hub ids resolve
through ``huggingface_hub.snapshot_download`` into the standard HF cache, so
the download happens once per machine.

Weight-format note: only the files a JAX inference load needs are fetched —
config/tokenizer/template json, ``*.safetensors`` (+ index) and GGUF. Torch
``.bin`` pickles are deliberately excluded; every supported checkpoint
family publishes safetensors.

A copy of ``crane_tpu/utils/hub.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import os
import re

# org/name or bare name, no path separators beyond the single slash, no
# leading dot — mirrors the hub's repo-id grammar closely enough to never
# misclassify a relative filesystem path that actually exists
_HUB_ID = re.compile(r"^[\w.-]+(/[\w.-]+)?$")

_ALLOW = [
    "*.json",
    "*.safetensors",
    "*.safetensors.index.json",
    "*.jinja",
    "*.gguf",
    "*.txt",
    "tokenizer.model",
    "*.tiktoken",
]


def looks_like_hub_id(path: str) -> bool:
    return (
        not os.path.exists(path)
        and not path.startswith((".", "/", "~"))
        and bool(_HUB_ID.match(path))
    )


def resolve_checkpoint(path_or_id: str) -> str:
    """Return a local directory for ``path_or_id``.

    Local paths pass through untouched (including files, e.g. ``x.gguf``).
    A non-existent path matching the hub repo-id grammar is snapshot-
    downloaded (config/tokenizer/safetensors/gguf only) and the cache
    directory returned. Anything else raises FileNotFoundError with the
    reason spelled out.
    """
    if os.path.exists(path_or_id):
        return path_or_id
    if looks_like_hub_id(path_or_id):
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:  # pragma: no cover - baked into the image
            raise FileNotFoundError(
                f"{path_or_id} is not a local path and huggingface_hub is "
                f"not installed to fetch it"
            ) from e
        return snapshot_download(repo_id=path_or_id, allow_patterns=_ALLOW)
    raise FileNotFoundError(
        f"{path_or_id}: not a local path, and not a hub repo id "
        f"(expected 'org/name')"
    )
