"""engine.admit_host_idle_share: the traced slice's idle device seconds
whose innermost program span is ``engine.admit`` or ``engine.admit_chunk``
(the host's own work around an admission's forward, outside
``model.prefill``), over the slice's seconds, in %. Reads those spans from
the program's timeline (``crane_bench/program_spans.py``)."""

from crane_bench import program_spans


def read(ctx):
    return program_spans.idle_share(ctx.slice, "engine.admit", "engine.admit_chunk")
