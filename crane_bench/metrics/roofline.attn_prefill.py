"""roofline.attn_prefill: K2/K3 (``ops/cuda/flash_attention.py``, the bf16
``flash_mma_kernel`` and the float32 ``flash_attention_kernel``) against the
least time of the prefilled tokens' causal attention."""

from crane_bench import work

KERNELS = ("flash_mma_kernel", "flash_attention_kernel")
NOT = ("Quant",)


def read(ctx):
    seconds = ctx.slice.device_seconds(KERNELS, NOT)
    least = work.prefill_attention_least_s(ctx.model, ctx.hf, ctx.work)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
