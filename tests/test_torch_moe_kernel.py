"""K8, the routed grouped-expert product (``crane_tpu_torch/ops/cuda/moe.py``,
``csrc/moe_experts.cu``), on the CPU.

The kernel cannot run here, so this file holds what the card relies on:

- the plain version against both of the reference's dispatches
  (``_moe_dispatch_dense``, ``_moe_dispatch_ragged``) in float32, at T 1 to
  512, under the softmax and the sigmoid router, on Qwen3-Next's expert
  shape (many narrow experts, top-10) and LFM2's (few wide ones, top-4)
  scaled down; experts with no, one and many pairs, every pair on one
  expert, and a tensor-parallel shard's ``expert_offset`` with ``partial``;
- the grouping the kernel does on the device (counts, first slots, the
  stable order, the work items and their bound) against a sort;
- an emulation of the kernels' arithmetic (16-deep float32 k-steps over
  64-row k-tiles, the cluster split's partial sums added in rank order, h
  rounded once, the weighted pair rows summed in pick order) against the
  plain version at the card tests' tolerance;
- that ``moe_block`` takes K8 by device and the plain dispatches on the CPU.
"""

import dataclasses

import pytest
import torch

from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.cuda import moe
from crane_tpu_torch.ops.cuda.build import KERNEL_ATOL, KERNEL_RTOL

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
# Qwen3-Next's expert shape (512 experts of 512, top-10, hidden 2048) and
# LFM2-24B-A2B's (64 of 1536, top-4) at a 32nd of the width, the expert
# counts a quarter
SHAPES = {"next": dict(n=128, k=10, E=64, I=16), "lfm2": dict(n=16, k=4, E=64, I=48)}


def config(shape, router):
    s = SHAPES[shape]
    cls = ttf.MoeRouterConfig if router == "sigmoid" else ttf.TransformerConfig
    kw = dict(moe_router="sigmoid", routed_scaling_factor=2.5) if router == "sigmoid" else {}
    return cls(vocab_size=32, hidden_size=s["E"], num_layers=1, num_heads=2, num_kv_heads=1,
               head_dim=32, intermediate_size=4 * s["E"], num_experts=s["n"],
               num_experts_per_tok=s["k"], moe_intermediate_size=s["I"], **kw)


def experts(gen, n, E, I, dtype=torch.float32, bias=False):
    def w(*shape):
        return (torch.randn(*shape, generator=gen) * shape[-2] ** -0.5).to(dtype)

    p = {"router": w(E, n), "experts_gate": w(n, E, I), "experts_up": w(n, E, I),
         "experts_down": w(n, I, E)}
    if bias:
        p["expert_bias"] = torch.randn(n, generator=gen) * 0.1
    return p


def run_plain(p, xt, w, sel, cfg, **kw):
    return moe.moe_experts_plain(xt, w, sel, p["experts_gate"], p["experts_up"],
                                 p["experts_down"], act=cfg.act, **kw)


@pytest.mark.parametrize("shape", ["next", "lfm2"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T", [1, 8, 32, 300, 512])
def test_plain_matches_both_dispatches(shape, router, T):
    cfg = config(shape, router)
    gen = torch.Generator().manual_seed(T + len(shape) + len(router))
    p = experts(gen, cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size,
                bias=router == "sigmoid")
    xt = torch.randn(T, cfg.hidden_size, generator=gen)
    w, sel = ttf.moe_route(cfg, p, xt)
    got = run_plain(p, xt, w, sel, cfg)
    torch.testing.assert_close(got, ttf._moe_dispatch_dense(cfg, p, xt, w, sel), **F32)
    torch.testing.assert_close(got, ttf._moe_dispatch_ragged(cfg, p, xt, w, sel), **F32)


def by_hand(p, xt, w, sel, act="silu"):
    """The contract, one pair at a time in float64."""
    y = torch.zeros(xt.shape, dtype=torch.float64)
    for t in range(xt.shape[0]):
        for j in range(sel.shape[1]):
            e = int(sel[t, j])
            g = xt[t].double() @ p["experts_gate"][e].double()
            h = moe.activation(act, g) * (xt[t].double() @ p["experts_up"][e].double())
            y[t] += float(w[t, j]) * (h @ p["experts_down"][e].double())
    return y.float()


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_plain_on_uneven_groups(act):
    """Experts with no pair, one pair and many pairs; k = 3 over 6 experts,
    expert 0 in every token, expert 5 in none."""
    gen = torch.Generator().manual_seed(5)
    p = experts(gen, 6, 32, 24)
    T = 40
    sel = torch.stack([torch.zeros(T, dtype=torch.int64),
                       1 + torch.arange(T) % 3,
                       torch.where(torch.arange(T) == 7, 4, 1 + (torch.arange(T) + 1) % 3)], 1)
    w = torch.rand(T, 3, generator=gen)
    xt = torch.randn(T, 32, generator=gen)
    counts = torch.bincount(sel.reshape(-1), minlength=6)
    assert counts[5] == 0 and counts[4] == 1 and counts[0] == T
    got = moe.moe_experts_plain(xt, w, sel, p["experts_gate"], p["experts_up"],
                                p["experts_down"], act=act)
    torch.testing.assert_close(got, by_hand(p, xt, w, sel, act), **F32)


def test_plain_with_every_pair_on_one_expert():
    gen = torch.Generator().manual_seed(6)
    p = experts(gen, 8, 32, 16)
    T = 70  # more pairs than any row tile
    sel = torch.full((T, 1), 3, dtype=torch.int64)
    w = torch.rand(T, 1, generator=gen)
    xt = torch.randn(T, 32, generator=gen)
    got = moe.moe_experts_plain(xt, w, sel, p["experts_gate"], p["experts_up"],
                                p["experts_down"])
    torch.testing.assert_close(got, by_hand(p, xt, w, sel), **F32)
    order, start, items = moe.moe_group_plain(sel, 8, 0, 16)
    assert start.tolist() == [0, 0, 0, 0] + [T] * 5
    assert items.tolist() == [[3, s] for s in range(0, T, 16)]


@pytest.mark.parametrize("shape", ["next", "lfm2"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_partials_sum_to_the_whole(shape, shards):
    """A tensor-parallel shard's experts ``offset .. offset + n/shards``
    with ``partial``: picks elsewhere add 0, the partials are float32, and
    they sum to the whole layer."""
    cfg = config(shape, "softmax")
    gen = torch.Generator().manual_seed(shards)
    p = experts(gen, cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size)
    xt = torch.randn(32, cfg.hidden_size, generator=gen)
    w, sel = ttf.moe_route(cfg, p, xt)
    whole = run_plain(p, xt, w, sel, cfg)
    m = cfg.num_experts // shards
    parts = []
    for t in range(shards):
        shard = {name: v[t * m:(t + 1) * m] for name, v in p.items() if name.startswith("experts_")}
        part = run_plain(shard, xt, w, sel, cfg, offset=t * m, partial=True)
        assert part.dtype == torch.float32
        torch.testing.assert_close(part, ttf._moe_dispatch_dense(
            cfg, shard, xt, w, sel, t * m, partial=True), **F32)
        parts.append(part)
    torch.testing.assert_close(sum(parts), whole, **F32)


def draw_sel(gen, T, k, n, kind):
    if kind == "random":
        return torch.stack([torch.randperm(n, generator=gen)[:k] for _ in range(T)])
    if kind == "one":
        return torch.full((T, k), n // 2, dtype=torch.int64)
    # "distinct": every pair its own expert where n allows
    return (torch.arange(T * k) % n).reshape(T, k)


@pytest.mark.parametrize("kind", ["random", "one", "distinct"])
@pytest.mark.parametrize("T,k,n,offset,bm", [(32, 10, 512, 0, 16), (1, 10, 512, 0, 16),
                                             (512, 10, 512, 0, 32), (512, 4, 64, 0, 64),
                                             (300, 8, 64, 16, 16), (77, 4, 64, 32, 32)])
def test_grouping_against_a_sort(kind, T, k, n, offset, bm):
    """The grouping's counts, first slots, order and work items against a
    stable sort of the picks; a shard's picks outside its experts get no
    slot; the items never pass the grid's ``max_items``."""
    gen = torch.Generator().manual_seed(T * k + n)
    sel = draw_sel(gen, T, k, n, kind)
    m = n - offset if offset else n  # the shard's experts
    m = min(m, n // 2) if offset else m
    order, start, items = moe.moe_group_plain(sel, m, offset, bm)
    flat = sel.reshape(-1)
    local = (flat >= offset) & (flat < offset + m)
    ref = [p for _, p in sorted((int(flat[p]), p) for p in range(T * k) if local[p])]
    assert order.tolist() == ref
    counts = torch.bincount(flat[local] - offset, minlength=m)
    assert start[1:].tolist() == torch.cumsum(counts, 0).tolist() and start[0] == 0
    assert (flat[order] - offset).tolist() == sorted((flat[local] - offset).tolist())
    # each expert's slots covered once, by items of bm slots in expert order
    covered = []
    for e, s in items.tolist():
        assert start[e] <= s < start[e + 1]
        covered += list(range(s, min(s + bm, int(start[e + 1]))))
    assert covered == list(range(int(start[-1])))
    assert len(items) <= moe.max_items(T * k, m, bm)


def test_row_tile_and_plan():
    """The row tile from rows an expert (16 at decode, 32 at Qwen3-Next's
    512-token chunk, 64 at LFM2's) and the cluster split only where the
    grid leaves SMs without a block."""
    assert [moe.row_tile(T, 10, 512) for T in (1, 8, 32, 300, 512)] == [16, 16, 16, 16, 32]
    assert [moe.row_tile(T, 4, 64) for T in (1, 8, 32, 300, 512)] == [16, 16, 16, 32, 64]
    assert moe.mma_plan(1, 10, 512, 2048, 512, 132)["gate_up_split"] == 2
    assert moe.mma_plan(32, 10, 512, 2048, 512, 132) == {
        "rows": 16, "items": 341, "gate_up_split": 1, "down_split": 1}
    assert moe.split_count(1, 1024, 132) == 4 and moe.split_count(1, 384, 132) == 2
    assert moe.split_count(1, 128, 132) == 1 and moe.split_count(132, 2048, 132) == 1
    for T, k, n in [(1, 10, 512), (32, 10, 512), (512, 4, 64), (2048, 10, 512)]:
        bm = moe.row_tile(T, k, n)
        gen = torch.Generator().manual_seed(T)
        for kind in ("random", "one", "distinct"):
            _, _, items = moe.moe_group_plain(draw_sel(gen, T, k, n, kind), n, 0, bm)
            assert len(items) <= moe.max_items(T * k, n, bm)


def tile_sum(a, b, split):
    """The mma tile loop's float32 sums of a @ b: 16-deep k-steps over
    64-row k-tiles, k-tile i summed by block i % split, the blocks' sums
    added to block 0's in rank order."""
    K = a.shape[1]
    tiles = list(range(0, K, moe.MMA_BK))
    out = None
    for r in range(split):
        acc = torch.zeros(a.shape[0], b.shape[1])
        for t0 in tiles[r::split]:
            for k0 in range(t0, min(t0 + moe.MMA_BK, K), 16):
                acc = acc + a[:, k0:k0 + 16] @ b[k0:k0 + 16]
        out = acc if out is None else out + acc
    return out


def k8_tile_loop(x, w, sel, gate, up, down, *, act="silu", offset=0, partial=False, sms=132):
    """K8's bf16 arithmetic on the CPU, item by item as the grid runs it:
    the grouping, gate|up over each item's gathered rows (h = act(g) u
    rounded once to bf16), down over its slots of h times each pair's
    weight into the pair's float32 row, then the combine in pick order."""
    T, E = x.shape
    n, _, I = gate.shape
    k = sel.shape[1]
    plan = moe.mma_plan(T, k, n, E, I, sms)
    bm = plan["rows"]
    order, start, items = moe.moe_group_plain(sel, n, offset, bm)
    h = torch.zeros(len(order), I)
    rows = torch.zeros(T * k, E)
    wf = w.reshape(-1).float()
    for e, s0 in items.tolist():
        s1 = min(s0 + bm, int(start[e + 1]))
        pairs = order[s0:s1]
        xs = x[pairs // k].float()
        g = tile_sum(xs, gate[e].float(), plan["gate_up_split"])
        u = tile_sum(xs, up[e].float(), plan["gate_up_split"])
        h[s0:s1] = (moe.activation(act, g) * u).to(x.dtype).float()
        rows[pairs] = tile_sum(h[s0:s1], down[e].float(), plan["down_split"]) * wf[pairs, None]
    flat = sel.reshape(-1) - offset
    mine = ((flat >= 0) & (flat < n)).reshape(T, k)
    y = torch.zeros(T, E)
    for j in range(k):
        y = y + torch.where(mine[:, j, None], rows.reshape(T, k, E)[:, j], 0.0)
    return y if partial else y.to(x.dtype)


@pytest.mark.parametrize("shape", ["next", "lfm2"])
@pytest.mark.parametrize("T", [1, 8, 32, 512])
@pytest.mark.parametrize("sms", [132, 100000])
def test_tile_loop_matches_plain(shape, T, sms):
    """The kernel's tile order against the plain version at the card's
    kernel bound, in bf16 at a 4th of the hidden width (E 512; I 256 and
    384) and Qwen3-Next's experts at 64; ``sms`` 100000 makes every grid
    split its reduction."""
    s = SHAPES[shape]
    n, k, E, I = min(s["n"], 64), s["k"], 512, 256 if shape == "next" else 384
    gen = torch.Generator().manual_seed(T + n)
    p = experts(gen, n, E, I, dtype=torch.bfloat16)
    xt = torch.randn(T, E, generator=gen).to(torch.bfloat16)
    cfg = dataclasses.replace(config(shape, "softmax"), num_experts=n)
    w, sel = ttf.moe_route(cfg, p, xt)
    if sms > 1000:
        plan = moe.mma_plan(T, k, n, E, I, sms)
        assert plan["gate_up_split"] > 1 and plan["down_split"] > 1
    got = k8_tile_loop(xt, w, sel, p["experts_gate"], p["experts_up"], p["experts_down"],
                       sms=sms)
    ref = moe.moe_experts_plain(xt, w, sel, p["experts_gate"], p["experts_up"],
                                p["experts_down"])
    torch.testing.assert_close(got.float(), ref.float(), rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_tile_loop_shard_partial():
    gen = torch.Generator().manual_seed(9)
    p = experts(gen, 32, 256, 64, dtype=torch.bfloat16)
    xt = torch.randn(48, 256, generator=gen).to(torch.bfloat16)
    sel = torch.stack([torch.randperm(32, generator=gen)[:4] for _ in range(48)])
    w = torch.rand(48, 4, generator=gen)
    shard = {name: v[16:] for name, v in p.items() if name.startswith("experts_")}
    args = (xt, w, sel, shard["experts_gate"], shard["experts_up"], shard["experts_down"])
    got = k8_tile_loop(*args, offset=16, partial=True)
    ref = moe.moe_experts_plain(*args, offset=16, partial=True)
    assert got.dtype == ref.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_moe_block_takes_k8_by_device(monkeypatch):
    """K8 on the card whatever ``CRANE_MOE_DISPATCH`` says; the reference's
    dispatches on the CPU, where ``moe_block`` never calls the kernel's
    wrapper."""
    monkeypatch.delenv("CRANE_MOE_DISPATCH", raising=False)
    assert ttf.moe_dispatch(torch.device("cuda")) == "kernel"
    assert ttf.moe_dispatch(torch.device("cpu")) == "dense"
    monkeypatch.setenv("CRANE_MOE_DISPATCH", "ragged")
    assert ttf.moe_dispatch(torch.device("cuda", 0)) == "kernel"
    assert ttf.moe_dispatch(torch.device("cpu")) == "ragged"

    def refuse(*a, **kw):
        raise AssertionError("moe_block called the kernel's wrapper on the CPU")

    monkeypatch.setattr(ttf, "moe_experts", refuse)
    cfg = config("lfm2", "sigmoid")
    gen = torch.Generator().manual_seed(3)
    p = experts(gen, cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size, bias=True)
    x = torch.randn(2, 5, cfg.hidden_size, generator=gen)
    xt = x.reshape(10, -1)
    w, sel = ttf.moe_route(cfg, p, xt)
    want = ttf._moe_dispatch_ragged(cfg, p, xt, w, sel).reshape(x.shape)
    torch.testing.assert_close(ttf.moe_block(cfg, p, x), want, rtol=0, atol=0)
    monkeypatch.delenv("CRANE_MOE_DISPATCH")
    want = ttf._moe_dispatch_dense(cfg, p, xt, w, sel).reshape(x.shape)
    torch.testing.assert_close(ttf.moe_block(cfg, p, x), want, rtol=0, atol=0)


def test_wrapper_on_the_cpu_is_the_plain_version_and_refuses_grad():
    gen = torch.Generator().manual_seed(4)
    p = experts(gen, 8, 32, 16)
    xt = torch.randn(5, 32, generator=gen)
    sel = torch.stack([torch.randperm(8, generator=gen)[:2] for _ in range(5)])
    w = torch.rand(5, 2, generator=gen)
    args = (xt, w, sel, p["experts_gate"], p["experts_up"], p["experts_down"])
    torch.testing.assert_close(moe.moe_experts(*args), moe.moe_experts_plain(*args), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no backward"):
        moe.moe_experts(xt.requires_grad_(), *args[1:])
