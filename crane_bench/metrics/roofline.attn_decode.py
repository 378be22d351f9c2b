"""roofline.attn_decode: K1 (``ops/cuda/decode_attention.py``,
``decode_split_kernel`` over fp rows) against the least time the decoded
tokens' key and value reads need at HBM bandwidth."""

from crane_bench import work

KERNELS = ("decode_split_kernel",)
NOT = ("QuantRows",)


def read(ctx):
    seconds = ctx.slice.device_seconds(KERNELS, NOT)
    least = work.decode_attention_least_s(ctx.model, ctx.hf, ctx.work)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
