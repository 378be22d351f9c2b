"""Conservative ONNX graph simplification, run once when a Session is built.

Mirrors the reference's optimizer behavior (crane-core/src/onnx/optimizer/
mod.rs:1-49): alias elimination (Identity/inference-Dropout), pattern fusion
for the two decompositions its production graphs hit — the exporter-emitted
``atan2(y, x)`` quadrant-correction subgraph (fuse_atan2.rs:1-60) and the
BigVGAN-style ``Snake`` activation ``x + sin(alpha*x)^2 / alpha``
(fuse_snake.rs:1-22) — then fixed-point constant folding + alias passes, and
a final dead-node / dead-initializer sweep. All passes are structural
rewrites on the parsed ``wire.Graph``; folding evaluates nodes with the same
eager evaluator the session uses, so a folded graph is value-identical by
construction.

The wins are the same as the reference's: the eager evaluator pays full
read+write passes per node, so collapsing the five-op Snake chain or folding
shape-computation subgraphs removes whole tensor traversals per call, not
just dispatch overhead.

A copy of ``crane_tpu/onnx/optimizer.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from crane_tpu_torch.onnx.wire import Graph, Node

# Ops that are value-nondeterministic or stateful: never constant-folded.
_NONDETERMINISTIC = {
    "RandomNormal", "RandomNormalLike", "RandomUniform", "RandomUniformLike",
    "Multinomial", "Bernoulli",
}
# Ops whose outputs alias their input unchanged in inference mode.
_ALIAS_OPS = {"Identity", "Dropout"}


@dataclasses.dataclass
class OptimizationReport:
    original_nodes: int = 0
    final_nodes: int = 0
    folded_nodes: int = 0
    removed_alias_nodes: int = 0
    removed_dead_nodes: int = 0
    removed_initializers: int = 0
    fused_atan2_nodes: int = 0
    fused_snake_nodes: int = 0


def _producers(nodes: list) -> dict:
    out = {}
    for n in nodes:
        for o in n.outputs:
            if o:
                out[o] = n
    return out


def _consumer_counts(graph: Graph) -> dict:
    counts: dict = {}
    for n in graph.nodes:
        for i in n.inputs:
            if i:
                counts[i] = counts.get(i, 0) + 1
    for o in graph.outputs:
        counts[o] = counts.get(o, 0) + 1
    return counts


def eliminate_alias_nodes(graph: Graph) -> int:
    """Remove Identity / inference-mode Dropout nodes by renaming their
    consumers' inputs to the alias source. Graph outputs keep their names:
    an alias feeding a graph output is kept (renaming an output would change
    the session's public surface)."""
    removed = 0
    out_names = set(graph.outputs)
    changed = True
    while changed:
        changed = False
        rename: dict = {}
        kept = []
        consumed = {i for n in graph.nodes for i in n.inputs if i}
        for n in graph.nodes:
            # Dropout may have a second (mask) output; only the data output
            # aliases, so the node is removable only while the mask is
            # entirely unused. Training-mode Dropout (ratio input + training
            # flag) still aliases at inference — the evaluator treats it as
            # a pass-through — so the rewrite stays value-identical.
            if (
                n.op_type in _ALIAS_OPS
                and n.inputs
                and n.inputs[0]
                and n.outputs
                and n.outputs[0] not in out_names
                and not any(
                    o and (o in out_names or o in consumed) for o in n.outputs[1:]
                )
            ):
                rename[n.outputs[0]] = n.inputs[0]
                removed += 1
                changed = True
            else:
                kept.append(n)
        if not changed:
            break
        # resolve chains a->b->c in one pass
        def res(name):
            seen = set()
            while name in rename and name not in seen:
                seen.add(name)
                name = rename[name]
            return name

        for n in kept:
            n.inputs = [res(i) if i else i for i in n.inputs]
        graph.nodes = kept
    return removed


def _find_input(inputs: list, producers: dict, op_type: str):
    """(matched, other) for a binary node where ``matched`` is produced by
    ``op_type`` — tries both operand orders (exporters emit either)."""
    if len(inputs) != 2:
        return None
    a, b = inputs
    if a in producers and producers[a].op_type == op_type:
        return a, b
    if b in producers and producers[b].op_type == op_type:
        return b, a
    return None


def fuse_atan2(graph: Graph) -> int:
    """Rewrite the exporter-emitted atan2 decomposition's terminal Where
    into a single Atan2(y, x) node (reference fuse_atan2.rs — the
    decomposition NaNs at Div(0,0) where real atan2 is well-defined):

      Div(y,x) -> Atan -> inner Where(Greater(y,_), Add(atan,pi), Sub(atan,pi))
      -> outer Where(Less(x,_), inner, atan)
    """
    producers = _producers(graph.nodes)
    fused = 0
    for node in graph.nodes:
        if node.op_type != "Where" or len(node.inputs) != 3:
            continue
        cond, true_b, false_b = node.inputs
        less = producers.get(cond)
        atan = producers.get(false_b)
        inner = producers.get(true_b)
        if not (less and less.op_type == "Less" and atan
                and atan.op_type == "Atan" and inner
                and inner.op_type == "Where" and len(inner.inputs) == 3):
            continue
        div = producers.get(atan.inputs[0])
        if not (div and div.op_type == "Div" and len(div.inputs) == 2):
            continue
        y, x = div.inputs
        if less.inputs[0] != x:
            continue
        greater = producers.get(inner.inputs[0])
        add = producers.get(inner.inputs[1])
        sub = producers.get(inner.inputs[2])
        if not (greater and greater.op_type == "Greater"
                and greater.inputs[0] == y
                and add and add.op_type == "Add"
                and sub and sub.op_type == "Sub"):
            continue
        # both correction branches must adjust the same atan output
        if atan.outputs[0] not in add.inputs or sub.inputs[0] != atan.outputs[0]:
            continue
        node.op_type = "Atan2"
        node.inputs = [y, x]
        node.attrs = {}
        fused += 1
    return fused


def fuse_snake(graph: Graph) -> int:
    """Rewrite the five-op Snake decomposition's terminal Add into a single
    Snake(x, alpha) node (reference fuse_snake.rs):

      Mul(alpha, x) -> Sin -> Pow(_, 2) -> Mul(inv_alpha_or_div, _) -> Add(x, _)

    Conservative on the 1/alpha factor: it accepts either
    ``Div(sin^2, alpha)`` or ``Mul(sin^2, recip)`` where ``recip`` is
    produced by ``Reciprocal(alpha)`` — forms whose value is exactly
    ``sin(alpha*x)^2 / alpha``. An exporter-baked constant ``1/alpha``
    initializer is NOT matched (its rounding differs from the runtime
    division, so the rewrite would not be value-identical).
    """
    producers = _producers(graph.nodes)
    fused = 0
    for node in graph.nodes:
        if node.op_type != "Add":
            continue
        m = _find_input(node.inputs, producers, "Div")
        scale_by_recip = False
        if m is None:
            m = _find_input(node.inputs, producers, "Mul")
            scale_by_recip = True
        if m is None:
            continue
        scaled_name, x_name = m
        scaled = producers[scaled_name]
        if len(scaled.inputs) != 2:
            continue
        if scale_by_recip:
            mm = _find_input(scaled.inputs, producers, "Pow")
            if mm is None:
                continue
            pow_name, recip_name = mm
            recip = producers.get(recip_name)
            if not (recip and recip.op_type == "Reciprocal"):
                continue
            alpha_name = recip.inputs[0]
        else:
            pow_name, alpha_name = scaled.inputs
        pown = producers.get(pow_name)
        if not (pown and pown.op_type == "Pow" and len(pown.inputs) == 2):
            continue
        exp = graph.initializers.get(pown.inputs[1])
        if exp is None:  # exporters also emit the exponent as a Constant node
            src = producers.get(pown.inputs[1])
            if src is not None and src.op_type == "Constant":
                exp = next(
                    (v for k, v in src.attrs.items()
                     if k in ("value", "value_float", "value_int")), None)
        if exp is None or np.asarray(exp).size != 1 or float(np.asarray(exp).reshape(())) != 2.0:
            continue
        sin = producers.get(pown.inputs[0])
        if not (sin and sin.op_type == "Sin"):
            continue
        mul = producers.get(sin.inputs[0])
        if not (mul and mul.op_type == "Mul" and len(mul.inputs) == 2):
            continue
        if alpha_name not in mul.inputs or x_name not in mul.inputs:
            continue
        if mul.inputs[0] == alpha_name and mul.inputs[1] == x_name:
            pass
        elif mul.inputs[0] == x_name and mul.inputs[1] == alpha_name:
            pass
        else:
            continue
        node.op_type = "Snake"
        node.inputs = [x_name, alpha_name]
        node.attrs = {}
        fused += 1
    return fused


def fold_constants(graph: Graph, evaluator, max_folded_elements: int) -> int:
    """Evaluate nodes whose inputs are all initializers and replace them with
    initializers. ``evaluator(node, ins)`` is the session's own ``_eval``
    bound with an empty env — a folded value is by construction the value
    the evaluator would have produced at run time. Results larger than
    ``max_folded_elements`` are discarded (keeping the node) so folding
    can't balloon the serialized-initializer footprint (e.g. a folded
    ConstantOfShape the size of the activation)."""
    folded = 0
    kept = []
    consts = graph.initializers
    for node in graph.nodes:
        # zero-input nodes (Constant) fold too — their value is static
        foldable = node.op_type not in _NONDETERMINISTIC and all(
            (not i) or i in consts for i in node.inputs
        )
        if not foldable:
            kept.append(node)
            continue
        try:
            ins = [consts[i] if i else None for i in node.inputs]
            outs = evaluator(node, ins)
        except Exception:
            kept.append(node)  # op the folder can't evaluate: leave in place
            continue
        if not isinstance(outs, tuple):
            outs = (outs,)
        vals = [np.asarray(v) for v in outs]
        if sum(v.size for v in vals) > max_folded_elements:
            kept.append(node)
            continue
        for name, val in zip(node.outputs, vals):
            if name:
                consts[name] = val
        folded += 1
    graph.nodes = kept
    return folded


def eliminate_dead(graph: Graph) -> tuple:
    """Drop nodes whose outputs are transitively unused and initializers no
    surviving node or graph output references."""
    live = set(graph.outputs)
    kept_rev = []
    for node in reversed(graph.nodes):
        if any(o and o in live for o in node.outputs):
            kept_rev.append(node)
            live.update(i for i in node.inputs if i)
    removed_nodes = len(graph.nodes) - len(kept_rev)
    graph.nodes = kept_rev[::-1]
    dead_inits = [k for k in graph.initializers if k not in live]
    for k in dead_inits:
        del graph.initializers[k]
    return removed_nodes, len(dead_inits)


def optimize(graph: Graph, evaluator, *, max_folded_elements: int = 1_000_000,
             max_passes: int = 8) -> OptimizationReport:
    """Run the full pass pipeline in the reference's order
    (optimizer/mod.rs:72-86): aliases, the two fusions, then constant-fold +
    alias to a fixed point, then one dead-node/initializer sweep."""
    report = OptimizationReport(original_nodes=len(graph.nodes))
    if any(isinstance(v, (Graph,)) for n in graph.nodes for v in n.attrs.values()):
        # graph-valued attributes (If/Loop/Scan bodies) may capture outer
        # names; skip everything except alias removal, like the reference's
        # skipped_dce_for_subgraphs guard
        report.removed_alias_nodes = eliminate_alias_nodes(graph)
        report.final_nodes = len(graph.nodes)
        return report
    report.removed_alias_nodes = eliminate_alias_nodes(graph)
    # fusions run BEFORE any folding (reference order, mod.rs:72-74): a fold
    # pass would collapse Reciprocal(alpha) into a bare constant and destroy
    # the Snake pattern's provable 1/alpha provenance
    report.fused_atan2_nodes = fuse_atan2(graph)
    report.fused_snake_nodes = fuse_snake(graph)
    for _ in range(max_passes):
        folded = fold_constants(graph, evaluator, max_folded_elements)
        aliases = eliminate_alias_nodes(graph)
        report.folded_nodes += folded
        report.removed_alias_nodes += aliases
        if folded == 0 and aliases == 0:
            break
    dead, inits = eliminate_dead(graph)
    report.removed_dead_nodes = dead
    report.removed_initializers = inits
    report.final_nodes = len(graph.nodes)
    return report
