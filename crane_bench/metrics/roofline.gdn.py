"""roofline.gdn: K7 (``ops/cuda/gdn_scan.py``: the chunkwise kernels and the
scan) against the least time of the prefilled tokens' gated-delta
recurrence."""

from crane_bench import work

KERNELS = ("gdn_chunk", "gdn_scan")


def read(ctx):
    seconds = ctx.slice.device_seconds(KERNELS)
    least = work.gdn_least_s(ctx.model, ctx.hf, ctx.work)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
