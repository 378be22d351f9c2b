"""Static-shape bucketing helpers.

XLA compiles one program per distinct shape; the reference's dynamic tensor
growth (KV regrow, ragged prompts) becomes bucketed padding here (SURVEY.md §7
"decode-loop shape discipline"). Buckets are powers of two with a floor, so a
run compiles O(log max_seq) prefill programs, each reused thereafter.

A copy of ``crane_tpu/utils/buckets.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations


def bucket_length(n: int, *, floor: int = 64, ceiling: int | None = None) -> int:
    b = floor
    while b < n:
        b *= 2
    if ceiling is not None:
        b = min(b, ceiling)
    return b


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
