"""The comparison that decides ``correct``: the engine's own greedy tokens
from the timed window against the plain float32 reference.

Once the window has closed and the program's state is freed, a sample of
the greedy requests the engine finished, drawn from the seed and holding
the longest, is run through the reference (prompt and served tokens, one
forward each, layer by layer over the weights drawn anew from the seed).
At each served token the reference's logits give its gap: how far the
served token's logit lies below the reference's best. Every served token of
a greedy request passed through the slot prefill (whole, in chunks or past
a reused prefix) for its first token and through the decode blocks, as
CUDA-graph replays, for the rest. A token whose logit lies far below the
best was not the model's choice.
"""

from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from crane_bench.models import plain
from crane_bench.weights import Weights, fp8_rows


def choose(records, check: dict, seed: int) -> list:
    """The greedy requests the engine finished whose served tokens are
    compared: the longest (prompt and answer), then others in an order drawn
    from the seed, until ``served_tokens`` are covered or ``max_requests``
    are taken."""
    done = [r for r in records if r.greedy and r.complete]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), r.rid))
    rest = sorted((r for r in done if r is not longest), key=lambda r: r.rid)
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    chosen, served = [longest], len(longest.tokens)
    for i in order:
        if served >= check["served_tokens"] or len(chosen) >= check["max_requests"]:
            break
        chosen.append(rest[i])
        served += len(rest[i].tokens)
    return chosen


@torch.no_grad()
def final_states(model, hf: dict, seed: int, device, records, fp8: bool = False):
    """(each record's final hidden states ``[served, E]`` at the positions
    that predict its served tokens, the head ``[V, E]``), computed in
    float32 by the reference over its prompt and served tokens, layer by
    layer over the weights drawn anew from ``seed`` (with ``fp8``, the
    control: weights and every product's activations rounded to float8)."""
    plain.exact_float32()
    source = Weights(model, hf, seed, device, fp8=fp8)
    g = source.globals()
    seqs = [np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int64)]) for r in records]
    hs = [plain.f32(g["model.embed_tokens.weight"][torch.as_tensor(s, device=device)])
          for s in seqs]
    positions = [torch.arange(len(s), device=device) for s in seqs]
    with plain.fp8_products() if fp8 else contextlib.nullcontext():
        for i in range(hf["num_hidden_layers"]):
            hs = model.layers(hf, i, source.layer(i), hs, positions)
    source.release()
    xs = [model.final_norm(hf, g, h[len(r.prompt) - 1:]) for r, h in zip(records, hs)]
    if fp8:
        xs = [fp8_rows(x) for x in xs]
    head = plain.f32(model.head(hf, g))
    del hs, g
    gc.collect()
    return xs, head


def _blocks(x: torch.Tensor, head: torch.Tensor, size: int = 512):
    for s in range(0, x.shape[0], size):
        yield s, x[s:s + size] @ head.T


@torch.no_grad()
def reference_gaps(model, hf: dict, seed: int, device, records, tokens=None) -> list[np.ndarray]:
    """For each record, the float32 reference's gap at each of its served
    tokens (or of ``tokens``, one array a record): its best logit less the
    token's."""
    xs, head = final_states(model, hf, seed, device, records)
    out = []
    for r, x, toks in zip(records, xs, tokens or [r.tokens for r in records]):
        served = torch.as_tensor(np.asarray(toks), device=device).long()
        gaps = [logits.max(-1).values - logits.gather(1, served[s:s + 512, None])[:, 0]
                for s, logits in _blocks(x, head)]
        out.append(torch.cat(gaps).cpu().numpy())
    return out


@torch.no_grad()
def control_tokens(model, hf: dict, seed: int, device, records) -> list[np.ndarray]:
    """The control's choice at each served position of each record: the
    argmax of the reference computed in float8 (weights and activations of
    every product), over the same prompts and served tokens."""
    xs, head = final_states(model, hf, seed, device, records, fp8=True)
    out = [torch.cat([logits.argmax(-1) for _, logits in _blocks(x, head)]).cpu().numpy()
           for x in xs]
    del xs, head
    gc.collect()
    return out


def summary(gaps: np.ndarray) -> dict:
    return {"max_logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean()),
            "p99_logit_gap": float(np.percentile(gaps, 99)),
            "not_best_share": float((gaps > 0).mean())}


def compare(model, hf: dict, seed: int, device, records, check: dict, limits: dict,
            control: bool = False) -> dict:
    """The numbers compared, each beside its limit: the count of served
    tokens compared (at least ``min_tokens``) and each gap statistic the
    cell's ``limits`` name (at most its limit); the other statistics go to
    the diagnostics. With ``control`` and a limits file whose control is
    ``reference_fp8``, the fp8 reference's choice at each served position
    takes the place of the served token: it is the control that is judged."""
    chosen = choose(records, check, seed)
    numbers: dict = {"tokens": {"value": 0, "limit": limits["min_tokens"]}}
    info: dict = {"requests": len(chosen)}
    if not chosen:
        return {"correct": False, "numbers": numbers, "info": info}
    tokens = None
    if control and limits["control"]["kind"] == "reference_fp8":
        tokens = control_tokens(model, hf, seed, device, chosen)
        info["judged"] = "the float8 reference's tokens"
    per = reference_gaps(model, hf, seed, device, chosen, tokens=tokens)
    gaps = np.concatenate(per)
    stats = summary(gaps)
    numbers["tokens"]["value"] = int(gaps.size)
    correct = gaps.size >= limits["min_tokens"]
    for name, limit in limits["limits"].items():
        numbers[name] = {"value": stats[name], "limit": limit}
        correct = correct and stats[name] <= limit
    info.update(stats, first_token_max_gap=float(max(g[0] for g in per)),
                longest=int(max(len(r.prompt) + len(r.tokens) for r in chosen)),
                reused_turns=int(sum(r.turn > 0 for r in chosen)))
    return {"correct": bool(correct), "numbers": numbers, "info": info}
