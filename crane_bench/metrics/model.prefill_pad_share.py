"""model.prefill_pad_share: the padding in the prefills that start in the
traced slice, sum(``bucket`` - ``tokens``) over sum(``bucket``), in %: the
counts of the program's ``model.prefill`` spans (``tokens`` the real
length, ``bucket`` the padded one)."""

from crane_bench import program_spans


def read(ctx):
    recs = program_spans.records(ctx.slice)
    if not recs:
        return None
    counts = [r.counts for r in program_spans.started_in(
        ctx.slice, program_spans.named(recs, "model.prefill"))
        if "tokens" in r.counts and "bucket" in r.counts]
    padded = sum(c["bucket"] for c in counts)
    if padded <= 0:
        return None
    return 100.0 * sum(c["bucket"] - c["tokens"] for c in counts) / padded
