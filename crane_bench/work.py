"""The work the tokens served in a slice need, counted from the configuration
and the traffic, never from what the program did.

A token the clients received in the slice, other than a request's first,
is one decode forward at its position. A request whose first token came in
the slice had its new prompt tokens prefilled (a session's earlier turns
count once: only the tokens past the previous turn's context are new). Its
prefill is counted whole at its first token, so a prefill that began
before the slice counts in it and one still running at its end does not.
"""

from __future__ import annotations

import dataclasses

from crane_bench import peaks

KV_BYTES = 2  # the served cache's element (bf16)


@dataclasses.dataclass
class SliceWork:
    decode_contexts: list[int]          # keys each decoded token attended
    prefills: list[tuple[int, int]]     # (first new position, prompt length)
    output_tokens: int                  # tokens served (each one head product)


def slice_work(records, p0: float, p1: float) -> SliceWork:
    """The work of the slice ``[p0, p1)`` (host perf_counter)."""
    decode, prefills, out = [], [], 0
    for r in records:
        n = len(r.prompt)
        for j, t in enumerate(r.times):
            if not p0 <= t < p1:
                continue
            out += 1
            if j == 0:
                prefills.append((n - r.new_tokens, n))
            else:
                decode.append(n + j)  # the forward of token j-1 at position n+j-1
    return SliceWork(decode, prefills, out)


def _pairs(start: int, end: int) -> int:
    """Query-key pairs of causal attention for new positions start..end-1."""
    return (end * (end + 1) - start * (start + 1)) // 2


def model_flops(model, hf: dict, w: SliceWork) -> float:
    """FLOPs of the slice's tokens: each token's products (the experts it
    routes to, not the rest), attention over its context (4 H D per key), and
    one head product per token served."""
    body = model.body_flops(hf)
    attn = sum(4.0 * H * D for H, _, D in model.attention_layers(hf))
    flops = w.output_tokens * model.head_flops(hf)
    for ctx in w.decode_contexts:
        flops += body + attn * ctx
    for start, end in w.prefills:
        flops += body * (end - start) + attn * _pairs(start, end)
    return flops


def decode_attention_least_s(model, hf: dict, w: SliceWork) -> float:
    """The least time of the decoded tokens' attention: every key and value
    of the context read once from HBM."""
    per_key = sum(2 * Hkv * D * KV_BYTES for _, Hkv, D in model.attention_layers(hf))
    return per_key * sum(w.decode_contexts) / peaks.HBM_BYTES_S


def prefill_attention_least_s(model, hf: dict, w: SliceWork) -> float:
    """The least time of the prefills' causal attention, per request and
    layer the larger of its FLOPs (4 D per query-key pair and head) at the
    bf16 peak and its bytes (q and the output of the new tokens, k and v of
    the whole context, once) at HBM bandwidth."""
    total = 0.0
    for start, end in w.prefills:
        new = end - start
        for H, Hkv, D in model.attention_layers(hf):
            flops = 4.0 * H * D * _pairs(start, end)
            nbytes = KV_BYTES * (2 * new * H * D + 2 * end * Hkv * D)
            total += peaks.least_seconds(flops, nbytes)
    return total


def gdn_least_s(model, hf: dict, w: SliceWork) -> float:
    """The least time of the prefills' gated-delta recurrence, per request
    and layer the larger of its bytes (q and k at the key heads, v and the
    output at the value heads in bf16, g and beta in float32, once a token;
    the float32 state in and out once a request) at HBM bandwidth and its
    FLOPs (the three state products, 6 K V a token and value head) at the
    TF32 peak the kernel computes at."""
    total = 0.0
    for start, end in w.prefills:
        new = end - start
        for Hk, Hv, K, V in model.gdn_layers(hf):
            nbytes = new * (2 * (2 * Hk * K + 2 * Hv * V) + 2 * 4 * Hv) + 2 * 4 * Hv * K * V
            flops = 6.0 * new * Hv * K * V
            total += peaks.least_seconds(flops, nbytes, peaks.TF32_FLOPS)
    return total
