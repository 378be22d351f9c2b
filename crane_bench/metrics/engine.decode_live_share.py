"""engine.decode_live_share: the decode rows that held a live sequence,
over all rows run, across the decode and speculative blocks dispatched in
the traced slice, in %: sum(``rows`` x ``steps``) over sum(``slots`` x
``steps``), the counts of the program's ``engine.decode_block`` and
``engine.spec_block`` spans (``rows`` live slots at dispatch, ``slots`` the
engine's slots, ``steps`` the block's steps or rounds)."""

from crane_bench import program_spans


def read(ctx):
    recs = program_spans.records(ctx.slice)
    if not recs:
        return None
    blocks = program_spans.started_in(
        ctx.slice, program_spans.named(recs, "engine.decode_block", "engine.spec_block"))
    run = sum(r.counts["slots"] * r.counts["steps"] for r in blocks)
    if run <= 0:
        return None
    return 100.0 * sum(r.counts["rows"] * r.counts["steps"] for r in blocks) / run
