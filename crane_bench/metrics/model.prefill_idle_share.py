"""model.prefill_idle_share: the traced slice's idle device seconds whose
innermost program span is ``model.prefill`` (the host launching an eager
prefill forward and its head), over the slice's seconds, in %. Reads that
span from the program's timeline (``crane_bench/program_spans.py``)."""

from crane_bench import program_spans


def read(ctx):
    return program_spans.idle_share(ctx.slice, "model.prefill")
