"""model.prefill_graph_share: the real prefill tokens of the prefills that
start in the traced slice that ran as CUDA-graph replays, over all of them,
in %: the program's ``model.prefill`` spans' counts, ``tokens`` the real
length and ``graph`` 1 for a replay, 0 for the eager forward. A program
whose spans carry no ``graph`` count gives None."""

from crane_bench import program_spans


def read(ctx):
    recs = program_spans.records(ctx.slice)
    if not recs:
        return None
    counts = [r.counts for r in program_spans.started_in(
        ctx.slice, program_spans.named(recs, "model.prefill"))
        if "tokens" in r.counts and "graph" in r.counts]
    tokens = sum(c["tokens"] for c in counts)
    if tokens <= 0:
        return None
    return 100.0 * sum(c["tokens"] for c in counts if c["graph"]) / tokens
