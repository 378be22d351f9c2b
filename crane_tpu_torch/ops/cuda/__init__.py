"""The port's hand-written CUDA kernels for Hopper, one wrapper each.

Every wrapper launches its kernel on a CUDA tensor (or raises), runs its
plain PyTorch counterpart on a CPU tensor, and counts its launches in a
plain attribute ``launches``, so a run can show that the main path went
through the kernels. The quantized kernels count per bit width
(``launches`` is a dict, ``{"w8": n, "w4": n}`` or ``{"kv8": n, "kv4": n}``),
so a run can show each variant was launched (K8, ``moe_experts``, counts
each of its three C entries: ``{"group": n, "gate_up": n, "down": n}``); K2 also counts its launches
given ``segments`` (``flash_attention_causal.segment_launches``, reset with
the others). A with-stats form (K1-S, K3-S,
K4-S, K5-S) shares its kernel's launch path but counts on its own wrapper.
A launch captured into a CUDA graph counts once for each replay of the
graph (:func:`add_launch_counts`), so the counts read the same as the eager
loop's for the same work.

A kernel writes its output through raw pointers and has no backward, so
every wrapper first refuses an input that requires grad while grad mode is
on (``build.refuse_grad``), on the CPU as on the card: a caller that trains
asks for the plain versions by argument.

:func:`attention_kernel_takes` says which attention shapes the kernels take,
so a caller routes the others to the plain versions by shape, as crane_tpu
routes them to ``gqa_attention``; the wrappers themselves raise on them.
"""

from __future__ import annotations

from crane_tpu_torch.ops.cuda.decode_attention import (
    MAX_GROUP,
    fp_decode_attention,
    fp_decode_attention_with_stats,
)
from crane_tpu_torch.ops.cuda.flash_attention import (
    HEAD_DIMS,
    flash_attention_cached,
    flash_attention_cached_with_stats,
    flash_attention_causal,
)
from crane_tpu_torch.ops.cuda.gdn_scan import gdn_scan
from crane_tpu_torch.ops.cuda.moe import moe_experts
from crane_tpu_torch.ops.cuda.quant_attention import (
    quant_cached_attention,
    quant_cached_attention_with_stats,
    quant_decode_attention,
    quant_decode_attention_with_stats,
)
from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul


# what an attention call is: one query per row over the cache (K1/K4, their
# -S forms), a fresh prefill over its own K/V (K2), a continuation chunk
# over the cache (K3/K5, their -S forms)
ATTENTION_KINDS = ("decode", "prefill", "chunk")


def attention_kernel_takes(kind: str, head_dim: int, n_heads: int, n_kv_heads: int) -> bool:
    """True exactly when the ``kind`` attention kernels accept these heads:
    a head dim in ``HEAD_DIMS``, and for decode also at most ``MAX_GROUP``
    query heads per kv-head (the decode kernels keep a group's heads in
    registers)."""
    if kind not in ATTENTION_KINDS:
        raise ValueError(f"attention kind must be one of {ATTENTION_KINDS}, got {kind!r}")
    if head_dim not in HEAD_DIMS or n_heads % n_kv_heads:
        return False
    return kind != "decode" or n_heads // n_kv_heads <= MAX_GROUP


def _variants(name, fn):
    return {f"{name}[{v}]": fn for v in fn.launches}


# counted name -> wrapper; a variant ``name[v]`` reads ``launches[v]``
KERNELS = {
    "fp_decode_attention": fp_decode_attention,
    "fp_decode_attention_with_stats": fp_decode_attention_with_stats,
    "flash_attention_causal": flash_attention_causal,
    "flash_attention_cached": flash_attention_cached,
    "flash_attention_cached_with_stats": flash_attention_cached_with_stats,
    **_variants("quant_matmul", quant_matmul),
    **_variants("quant_decode_attention", quant_decode_attention),
    **_variants("quant_decode_attention_with_stats", quant_decode_attention_with_stats),
    **_variants("quant_cached_attention", quant_cached_attention),
    **_variants("quant_cached_attention_with_stats", quant_cached_attention_with_stats),
    **_variants("gdn_scan", gdn_scan),
    **_variants("moe_experts", moe_experts),
}


def _variant(name: str) -> str | None:
    return name[name.index("[") + 1:-1] if name.endswith("]") else None


def launch_counts() -> dict[str, int]:
    counts = {}
    for name, fn in KERNELS.items():
        v = _variant(name)
        counts[name] = fn.launches if v is None else fn.launches[v]
    return counts


def reset_launch_counts() -> None:
    flash_attention_causal.segment_launches = 0
    for name, fn in KERNELS.items():
        v = _variant(name)
        if v is None:
            fn.launches = 0
        else:
            fn.launches[v] = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta[name]`` to each named counter (a CUDA graph's replay adds
    the launches its capture recorded, :mod:`crane_tpu_torch.models.graphs`)."""
    for name, n in delta.items():
        fn, v = KERNELS[name], _variant(name)
        if v is None:
            fn.launches += n
        else:
            fn.launches[v] += n
