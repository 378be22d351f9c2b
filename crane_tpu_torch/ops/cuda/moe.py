"""K8: the routed experts of a sparse-MoE layer (``csrc/moe_experts.cu``).

Replaces no TPU kernel: crane_tpu leaves the MoE dispatch to XLA
(``moe_block``'s dense one-hot product, or ``lax.ragged_dot``). For tokens
``x [T, E]`` and their k picks (``sel [T, k]`` int64 expert ids, ``w [T, k]``
float32 weights), with experts ``gate``, ``up [n, E, I]`` and ``down [n, I,
E]``::

    y[t] = sum over j of w[t, j] * down_e(act(gate_e(x_t)) * up_e(x_t)),  e = sel[t, j]

Each product sums in float32; ``h = act(g) * u`` is rounded once to x's
dtype; the k weighted rows of a token add in pick order in float32 and are
rounded once, or kept in float32 with ``partial`` (a tensor-parallel shard's
partial sum). The experts may be a shard's ``offset .. offset + n``: picks
outside that range add 0.

On a CUDA tensor :func:`moe_experts` launches the kernels or raises; on a CPU
tensor it runs :func:`moe_experts_plain`. The card runs three C entries a
call: the grouping (``crane_moe_group``, the pairs sorted by expert on the
device), gate|up with the activation, and down with the weight and the
combine; ``moe_experts.launches`` counts each (``group``, ``gate_up``,
``down``). The grids are sized from T, k and n alone, so a CUDA graph
captures a call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.cuda.quant_matmul import matmul_f32

# the activations the kernels take, by the code the C entries read (csrc Act)
ACTS = ("silu", "gelu_tanh")
# the bf16 kernels' row tiles (pair slots a work item) and column tiles
ROW_TILES = (16, 32, 64)
GATE_UP_COLS, DOWN_COLS = 64, 128
# the float32 (CUDA-core) form's row tile
F32_ROWS = 16
# a call's float32 pair rows ([T k, E]) stay under this many bytes: longer
# token runs go through in blocks of tokens
PAIR_ROWS_BYTES = 1 << 27
ENTRIES = ("group", "gate_up", "down")


def activation(act: str, g: torch.Tensor) -> torch.Tensor:
    if act == "silu":
        return F.silu(g)
    if act == "gelu_tanh":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"moe_experts: activation must be one of {ACTS}, got {act!r}")


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in float32 whatever the dtype: a bf16 product is
    exact in float32, so on the CPU (whose bf16 product rounds) the factors
    are widened first."""
    return matmul_f32(a, b) if a.is_cuda else a.float() @ b.float()


def row_tile(T: int, k: int, n: int) -> int:
    """The pair slots of a bf16 work item, from the rows an expert gets on
    average (T k / n): 16 up to 8 rows (a decode step: every expert's pairs
    fit one tile, so its weights are read once), 32 up to 24, else 64. An
    expert with more pairs than a tile reads its weights once a tile."""
    rows = T * k / n
    return 16 if rows <= 8 else 32 if rows <= 24 else 64


def max_items(pairs: int, n: int, bm: int) -> int:
    """The most work items ``pairs`` picks over n experts can need, at
    ``bm`` slots an item: sum over experts of ceil(c_e / bm) <= pairs / bm +
    (experts with a pair). The kernels' grids take this many."""
    return pairs // bm + min(n, pairs) + 1


# the bf16 kernels' reduction rows a stage and most blocks a cluster
# (moe_experts.cu kBK, kMaxSplitK)
MMA_BK, MMA_MAX_SPLIT = 64, 4


def split_count(blocks: int, K: int, sms: int) -> int:
    """The blocks of a cluster that split one tile's reduction of depth K,
    as the C entries choose them on a card of ``sms`` SMs (moe_experts.cu
    ``split_count``): doubled while the grid's ``blocks`` leave SMs without
    a block and each block keeps two k-tiles of MMA_BK. Block r sums k-tiles
    r, r + n, ...; the cluster's first block adds the others' sums in rank
    order."""
    k_tiles = -(-K // MMA_BK)
    n_split = 1
    while n_split < MMA_MAX_SPLIT and blocks * n_split < sms and 4 * n_split <= k_tiles:
        n_split *= 2
    return n_split


def mma_plan(T: int, k: int, n: int, E: int, I: int, sms: int) -> dict[str, int]:
    """What the bf16 kernels run for T tokens of k picks over n experts of
    widths E, I on a card of ``sms`` SMs: the row tile, the grid's work
    items, and each kernel's cluster split."""
    bm = row_tile(T, k, n)
    items = max_items(T * k, n, bm)
    return {"rows": bm, "items": items,
            "gate_up_split": split_count(items * -(-I // GATE_UP_COLS), E, sms),
            "down_split": split_count(items * -(-E // DOWN_COLS), I, sms)}


def moe_group_plain(sel: torch.Tensor, n: int, offset: int, bm: int):
    """What the grouping kernel writes, in plain PyTorch. sel ``[T, k]``.
    Returns (order ``[local]``: the pair index ``t k + j`` of each slot, the
    pairs sorted by expert and stably; start ``[n + 1]``: each local expert's
    first slot, start[n] the pairs routed to these experts; items ``[n_items,
    2]``: (expert, first slot) of each work item of ``bm`` slots, in expert
    order), int64."""
    flat = sel.reshape(-1).long() - offset
    local = (flat >= 0) & (flat < n)
    key = torch.where(local, flat, n)
    order = torch.argsort(key, stable=True)[:int(local.sum())]
    counts = torch.bincount(flat[local], minlength=n)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    items = [(e, int(start[e]) + i * bm) for e in range(n)
             for i in range(-(-int(counts[e]) // bm))]
    return order, start, torch.tensor(items, dtype=torch.int64).reshape(-1, 2)


def moe_experts_plain(x: torch.Tensor, w: torch.Tensor, sel: torch.Tensor,
                      gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, *,
                      act: str = "silu", offset: int = 0, partial: bool = False) -> torch.Tensor:
    """K8's contract in plain PyTorch, one expert's pairs at a time (the
    experts with no pair skipped). Returns ``[T, E]`` in x's dtype, or
    float32 with ``partial``."""
    T, E = x.shape
    n, k = gate.shape[0], sel.shape[1]
    order, start, _ = moe_group_plain(sel, n, offset, F32_ROWS)
    rows = torch.zeros((T * k, E), dtype=torch.float32, device=x.device)
    wf = w.reshape(-1).float()
    bounds = start.tolist()
    for e in range(n):
        pairs = order[bounds[e]:bounds[e + 1]]
        if not len(pairs):
            continue
        xs = x[torch.div(pairs, k, rounding_mode="floor")]
        h = (activation(act, _mm32(xs, gate[e])) * _mm32(xs, up[e])).to(x.dtype)
        rows[pairs] = _mm32(h, down[e]) * wf[pairs, None]
    flat = sel.reshape(-1) - offset
    mine = ((flat >= 0) & (flat < n)).reshape(T, k)
    rows = rows.reshape(T, k, E)
    y = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    for j in range(k):  # pick order, float32, as the combine adds
        y = y + torch.where(mine[:, j, None], rows[:, j], 0.0)
    return y if partial else y.to(x.dtype)


def _check(x, w, sel, gate, up, down, act):
    if x.ndim != 2 or sel.ndim != 2 or w.shape != sel.shape or sel.shape[0] != x.shape[0]:
        raise ValueError(f"moe_experts takes x [T, E], w and sel [T, k], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(sel.shape)}")
    T, E = x.shape
    n, E2, I = gate.shape
    if E2 != E or up.shape != gate.shape or down.shape != (n, I, E):
        raise ValueError(f"moe_experts: experts gate/up [n, E, I] and down [n, I, E] for E={E}, "
                         f"got {tuple(gate.shape)}, {tuple(up.shape)}, {tuple(down.shape)}")
    if E % 8 or I % 8:
        raise ValueError(f"moe_experts: E ({E}) and I ({I}) must be multiples of 8")
    if any(t.dtype != x.dtype for t in (gate, up, down)):
        raise TypeError("moe_experts: the experts must have x's dtype")
    if sel.dtype != torch.int64 or w.dtype != torch.float32:
        raise TypeError(f"moe_experts: sel int64 and w float32, got {sel.dtype}, {w.dtype}")
    if act not in ACTS:
        raise ValueError(f"moe_experts: activation must be one of {ACTS}, got {act!r}")


def moe_group(sel: torch.Tensor, n: int, offset: int, bm: int):
    """The grouping kernel on sel ``[T, k]`` int64 (on the card): the device
    buffers (order ``[T k]``, start ``[n + 1]``, items ``[max_items, 2]``,
    n_items ``[1]``, int32) of which the first ``start[n]`` slots and
    ``n_items`` items hold :func:`moe_group_plain`'s values. Reads nothing
    back to the host."""
    P = sel.numel()
    mi = max_items(P, n, bm)
    ints = torch.empty(P + n + 1 + 2 * mi + 1, dtype=torch.int32, device=sel.device)
    order, start = ints[:P], ints[P:P + n + 1]
    items, n_items = ints[P + n + 1:P + n + 1 + 2 * mi], ints[-1:]
    build.check_launch("crane_moe_group", build.lib().crane_moe_group(
        sel.data_ptr(), P, n, offset, bm, order.data_ptr(), start.data_ptr(), items.data_ptr(),
        n_items.data_ptr(), build.stream_ptr(sel.device)))
    moe_experts.launches["group"] += 1
    return order, start, items.view(mi, 2), n_items


def _launch(x, w, sel, gate, up, down, act, offset, out):
    """One block of tokens through the three C entries, into ``out``."""
    T, E = x.shape
    n, _, I = gate.shape
    k = sel.shape[1]
    P = T * k
    bm = F32_ROWS if x.dtype == torch.float32 else row_tile(T, k, n)
    mi = max_items(P, n, bm)
    order, start, items, n_items = moe_group(sel, n, offset, bm)
    h = torch.empty((P, I), dtype=x.dtype, device=x.device)
    rows = torch.empty((P, E), dtype=torch.float32, device=x.device)
    lib, stream, code = build.lib(), build.stream_ptr(x.device), build.dtype_code(x)
    build.check_launch("crane_moe_gate_up", lib.crane_moe_gate_up(
        code, bm, mi, x.data_ptr(), gate.data_ptr(), up.data_ptr(), order.data_ptr(),
        start.data_ptr(), items.data_ptr(), n_items.data_ptr(), h.data_ptr(), E, I, k,
        ACTS.index(act), stream))
    moe_experts.launches["gate_up"] += 1
    build.check_launch("crane_moe_down", lib.crane_moe_down(
        code, build.dtype_code(out), bm, mi, h.data_ptr(), down.data_ptr(), order.data_ptr(),
        start.data_ptr(), items.data_ptr(), n_items.data_ptr(), w.data_ptr(), sel.data_ptr(),
        rows.data_ptr(), out.data_ptr(), T, I, E, k, n, offset, stream))
    moe_experts.launches["down"] += 1


def moe_experts(x: torch.Tensor, w: torch.Tensor, sel: torch.Tensor, gate: torch.Tensor,
                up: torch.Tensor, down: torch.Tensor, *, act: str = "silu", offset: int = 0,
                partial: bool = False) -> torch.Tensor:
    """The routed experts (contract in the module docstring and
    :func:`moe_experts_plain`). Launches are counted per C entry:
    ``launches["group"]``, ``["gate_up"]``, ``["down"]`` (down with the
    combine)."""
    build.refuse_grad("moe_experts", x, w, gate, up, down)
    if x.device.type == "cpu":
        return moe_experts_plain(x, w, sel, gate, up, down, act=act, offset=offset,
                                 partial=partial)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts: no kernel for {x.device}")
    _check(x, w, sel, gate, up, down, act)
    build.require_cuda("moe_experts", x, w, sel, gate, up, down)
    T, E = x.shape
    out = torch.empty((T, E), dtype=torch.float32 if partial else x.dtype, device=x.device)
    block = max(1, PAIR_ROWS_BYTES // (sel.shape[1] * E * 4))
    for s in range(0, T, block):
        _launch(x[s:s + block], w[s:s + block], sel[s:s + block], gate, up, down, act, offset,
                out[s:s + block])
    return out


def kernel_info(gate_up: bool, bm: int) -> dict[str, int]:
    """The compiled bf16 gate|up (``gate_up``) or down kernel at row tile
    ``bm``: registers and local (spill) bytes a thread, shared memory bytes
    and threads a block, the tile's rows and columns. Builds the kernels on
    first use; needs the card."""
    info = (ctypes.c_int * 6)()
    build.check_launch("crane_moe_experts_info",
                       build.lib().crane_moe_experts_info(int(gate_up), bm, info))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads", "rows", "cols"), info))


moe_experts.launches = {v: 0 for v in ENTRIES}
