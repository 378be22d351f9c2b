"""mfu: the model FLOPs of the tokens served in the traced slice (counted
from the configuration: the experts a token routes to, attention over its
context, a head product per token served) over the slice's seconds at the
H100's bf16 peak."""

from crane_bench import peaks, work


def read(ctx):
    flops = work.model_flops(ctx.model, ctx.hf, ctx.work)
    if flops <= 0 or ctx.slice.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.slice.window_s * peaks.BF16_FLOPS)
