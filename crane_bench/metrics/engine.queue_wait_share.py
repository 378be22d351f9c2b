"""engine.queue_wait_share: the share of time to first token spent waiting
for admission, in %, over the requests whose first token came in the
traced slice: the sum of their ``request.queued`` spans (submit to the
start of admission) over the sum of their ``request.ttft`` spans (submit
to the first token), both recorded by the program with the request's id.
A request whose admission began before the slice (no ``request.queued``
recorded) is left out."""

from crane_bench import program_spans


def read(ctx):
    recs = program_spans.records(ctx.slice)
    if not recs:
        return None
    t0, t1 = ctx.slice.t0_ns, ctx.slice.t1_ns
    ttft = {r.rid: r for r in program_spans.named(recs, "request.ttft")
            if t0 <= r.end_ns <= t1}
    waited: dict = {}
    for r in program_spans.named(recs, "request.queued"):
        first = ttft.get(r.rid)
        if first is not None and r.end_ns <= first.end_ns:
            waited[r.rid] = waited.get(r.rid, 0) + (r.end_ns - r.start_ns)
    total = sum(ttft[rid].end_ns - ttft[rid].start_ns for rid in waited)
    if total <= 0:
        return None
    return 100.0 * sum(waited.values()) / total
