"""The end-to-end arithmetic over every request the clients saw: rates,
tails and counts. Nothing here reads the engine's own statistics."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between the
    two nearest ranks (numpy's default method), over all ``values``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(records, t0: float, t1: float) -> dict:
    """The window ``[t0, t1)``'s numbers:

    - ``output_tok_s``: tokens the clients received in the window over its
      seconds;
    - ``ttft_p95_ms``: the 95th percentile, over every request submitted in
      the window that got a first token, of submit to first token;
    - ``tpot_p95_ms``: the 95th percentile, over every request with at
      least 2 tokens in the window, of (last - first) / (tokens - 1) of its
      tokens in the window;
    - ``attempted``: requests submitted in the window; ``failed``: those
      that ended in an error or never got a first token.
    """
    seconds = t1 - t0
    tokens = sum(1 for r in records for t in r.times if t0 <= t < t1)
    sent = [r for r in records if t0 <= r.submit_t < t1]
    ttft = [(r.times[0] - r.submit_t) * 1e3 for r in sent if r.times and r.error is None]
    tpot = []
    for r in records:
        inside = [t for t in r.times if t0 <= t < t1]
        if len(inside) >= 2:
            tpot.append((inside[-1] - inside[0]) * 1e3 / (len(inside) - 1))
    out = {
        "attempted": len(sent),
        "failed": len(sent) - len(ttft),
        "output_tok_s": tokens / seconds,
        "n_ttft": len(ttft),
        "n_tpot": len(tpot),
    }
    if ttft:
        out["ttft_p95_ms"] = percentile(ttft, 95)
    if tpot:
        out["tpot_p95_ms"] = percentile(tpot, 95)
    return out
