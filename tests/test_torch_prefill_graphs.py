"""The serving engine's slot prefills as CUDA-graph programs, held on the CPU.

A program is keyed by (fresh or continuing, bucket) alone: the slot, the
start and the true length are device inputs, so the cache write takes its
row on the device and K3 reads the row it is given (``kv_rows``). Here the
device-row write and the plain K3 are held to the ``cache.row(slot)`` path
bit for bit; the gate (``CausalLM.prefill_graphs``) to what it may take;
the buckets the engine's warmup captures to what its flags reach; and, through
tests/test_torch_graphs.py's stand-in graph, replays to the eager prefill.
On the card tests/test_torch_cuda.py runs the real graphs and K3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.init import QWEN3_TINY, init_params
from crane_tpu_torch.models.modules.gdn_layer import GdnConfig
from crane_tpu_torch.models.modules.transformer import attention_block
from crane_tpu_torch.ops.cuda.flash_attention import flash_attention_cached
from crane_tpu_torch.ops.kv_cache import LayerKVCache
from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions
from tests.test_torch_graphs import snapshot, stand_in  # noqa: F401

torch.set_num_threads(2)

GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)


def tiny_lm(cfg=QWEN3_TINY):
    """``cfg`` over attention-only weights of its widths (the gate reads
    the config and the cache alone)."""
    dense = dataclasses.replace(cfg, layer_types=None, gdn=None, num_experts=0)
    params = init_params(dense, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    return CausalLM(cfg, params, dtype=torch.float32)


@pytest.mark.parametrize("bucket", [64, 256])
@pytest.mark.parametrize("start", ["0", "64", "max_seq - bucket"])
@pytest.mark.parametrize("slot", ["0", "last"])
def test_device_row_write_and_k3_equal_the_row_view(slot, start, bucket):
    """A chunk written at (slot, start) given as device tensors, and K3's
    plain version reading the slot through ``kv_rows``, equal the write
    through ``cache.row(slot)`` at an ``int`` start and K3 over that row
    view, bit for bit: every buffer row and the attention output. The same
    write with the row inactive (its start pushed past the buffer, as a
    capture writes) leaves the cache as it was."""
    B, T, Hq, Hkv, D = 4, 512, 4, 2, 32
    slot = 0 if slot == "0" else B - 1
    start = {"0": 0, "64": 64, "max_seq - bucket": T - bucket}[start]
    g = torch.Generator().manual_seed(bucket + start + slot)
    k0, v0 = (torch.randn(B, T, Hkv, D, generator=g) for _ in range(2))
    k, v = (torch.randn(1, bucket, Hkv, D, generator=g) for _ in range(2))
    q = torch.randn(1, bucket, Hq, D, generator=g)
    pos = (start + torch.arange(bucket, dtype=torch.int32))[None]
    view = LayerKVCache(k0.clone(), v0.clone())
    row = view.row(slot).update(k, v, start)
    ref = flash_attention_cached(q, row.k, row.v, pos, scale=D ** -0.5)
    rows = torch.tensor([slot], dtype=torch.int32)
    dev = LayerKVCache(k0.clone(), v0.clone())
    dev.update(k, v, torch.tensor([start], dtype=torch.int32), row=rows)
    got = flash_attention_cached(q, dev.k, dev.v, pos, scale=D ** -0.5, kv_rows=rows)
    assert torch.equal(dev.k, view.k) and torch.equal(dev.v, view.v)
    assert torch.equal(got, ref)
    assert not torch.equal(view.k, k0)
    idle = LayerKVCache(k0.clone(), v0.clone())
    idle.update(k, v, torch.tensor([T], dtype=torch.int32), row=rows)
    assert torch.equal(idle.k, k0) and torch.equal(idle.v, v0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_cache_refuses_a_device_row(bits):
    """An int8/int4 cache, which the gate keeps eager, takes no device row:
    the write raises and leaves the cache as it was."""
    layer = tiny_lm().init_cache(2, 128, quant_bits=bits).layers[0]
    before = [t.clone() for t in (layer.k, layer.v, layer.k_scale, layer.v_scale)]
    Hkv, D = layer.k_scale.shape[1], QWEN3_TINY.head_dim
    k = torch.randn(1, 64, Hkv, D, generator=torch.Generator().manual_seed(bits))
    with pytest.raises(TypeError, match="row must be an int"):
        layer.update(k, k, torch.tensor([0], dtype=torch.int32),
                     row=torch.tensor([1], dtype=torch.int32))
    after = (layer.k, layer.v, layer.k_scale, layer.v_scale)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


GATE_CASES = {
    "qwen3": (dict(), {}, True),
    "gdn": (dict(layer_types=("gdn", "full"), gdn=GdnConfig(4, 2, 16, 16)), {}, False),
    "conv": (dict(layer_types=("conv", "full")), {}, False),
    "moe": (dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32), {}, False),
    "sliding": (dict(layer_types=("sliding", "full"), sliding_window=16), {}, False),
    "int8 cache": (dict(), {"quant_bits": 8}, False),
    "mesh": (dict(), {"mesh": True}, False),
    "eager": (dict(), {"eager": True}, False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_takes_attention_only_stacks_over_an_fp_cache(stand_in, case):  # noqa: F811
    """The gate, on a device that takes graphs (the stand-in's): true for
    a tiny Qwen3 over an fp cache; false for a GDN or short-conv layer,
    experts, a sliding window, an int8 cache, a mesh and under
    graphs.eager()."""
    fields, opts, expected = GATE_CASES[case]
    lm = tiny_lm(dataclasses.replace(QWEN3_TINY, **fields))
    if opts.get("mesh"):
        lm.mesh = (torch.device("cpu"),) * 2
    cache = lm.init_cache(2, 128, quant_bits=opts.get("quant_bits"))
    if opts.get("eager"):
        with graphs.eager():
            assert lm.prefill_graphs(cache) is expected
    else:
        assert lm.prefill_graphs(cache) is expected


FLAGS = {
    "chat": (dict(max_seq_len=4096, prefill_chunk=512), [64, 128, 256, 512],
             [64, 128, 256, 512]),
    "rag": (dict(max_seq_len=8448, prefill_chunk=2048), [64, 128, 256, 512, 1024, 2048],
            [64, 128, 256, 512, 1024, 2048]),
    "no chunk": (dict(max_seq_len=1000), [64, 128, 256, 512, 1024],
                 [64, 128, 256, 512]),
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_warmup_captures_the_buckets_the_flags_reach(stand_in, monkeypatch,  # noqa: F811
                                                       flags):
    """warmup captures one program per (kind, bucket) the engine's flags
    reach: chat's (4096-token slots, 512-token chunks), rag's (8448, 2048)
    and, without a chunk, a 1000-token buffer (rounded to 1024: fresh
    buckets to the whole buffer, continuations to 512), the largest first;
    on a model that runs no prefill graphs, warmup prefills once each way."""
    kw, fresh, cont = FLAGS[flags]
    lm = tiny_lm()
    engine = InferenceEngine(lm, max_slots=2, **kw)
    assert engine.prefill_buckets() == (fresh, cont)
    engine.warmup()
    keys = [(k[0], dict(k[1])["fresh"], k[-1][2][1][1]) for k in lm._programs
            if k[0].startswith("prefill")]
    assert sorted(b for kind, _, b in keys if kind == "prefill") == fresh
    assert sorted(b for kind, _, b in keys if kind == "prefill_continue") == cont
    assert keys[0][2] == max(fresh)
    calls = []
    for name in ("prefill_slot", "prefill_slot_continue"):
        def spy(cache, tokens, *args, _real=getattr(lm, name), _name=name):
            calls.append((_name, tokens.shape[1]))
            return _real(cache, tokens, *args)
        monkeypatch.setattr(lm, name, spy, raising=False)
    with graphs.eager():
        InferenceEngine(lm, max_slots=2, **kw).warmup()
    assert calls == [("prefill_slot", 64), ("prefill_slot_continue", 64)]


def slot_state(lm, B=3, T=256):
    """A 3-slot cache with rows 0 and 2 prefilled eagerly (20 and 70
    tokens)."""
    cache = lm.init_cache(B, T)
    rng = np.random.default_rng(5)
    with graphs.eager():
        for slot, n in ((0, 20), (2, 70)):
            padded = np.zeros((1, 128), np.int32)
            padded[0, :n] = rng.integers(1, 500, n)
            _, cache = lm.prefill_slot(cache, padded, slot, n)
    return cache


@pytest.mark.parametrize("head_dim", [64, 96])
def test_replays_equal_the_eager_prefill(stand_in, head_dim):  # noqa: F811
    """Fresh prefills and continuation chunks at two slots and two starts,
    replayed through the stand-in graph, equal the eager prefill: logits,
    every cache buffer, lengths; one program per (kind, bucket), its
    capture writing nothing the caller sees; the launch and plain-route
    counts equal (head dim 96, which no kernel takes, routes every call
    plain)."""
    lm = tiny_lm(dataclasses.replace(QWEN3_TINY, head_dim=head_dim))
    rng = np.random.default_rng(9)
    calls = []
    for slot in (1, 2):
        for start, n, bucket in ((0, 30, 64), (64, 50, 64), (128, 100, 128)):
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = rng.integers(1, 500, n)
            calls.append((slot, start, n, padded))
    runs = {}
    for mode in ("graph", "eager"):
        cache = slot_state(lm)
        before = dict(attention_block.plain_routes)
        outs = []
        with graphs.eager() if mode == "eager" else torch.no_grad():
            for slot, start, n, padded in calls:
                if start == 0:
                    logits, cache = lm.prefill_slot(cache, padded, slot, n)
                else:
                    logits, cache = lm.prefill_slot_continue(cache, padded, slot, start, n)
                outs.append(logits)
        routes = {k: attention_block.plain_routes[k] - before[k] for k in before}
        runs[mode] = (outs + snapshot(cache), routes)
    for got, ref in zip(*(runs[m][0] for m in ("graph", "eager"))):
        assert torch.equal(got, ref)
    assert runs["graph"][1] == runs["eager"][1]
    assert sum(runs["graph"][1].values()) == (0 if head_dim == 64 else 6 * 2)
    assert len(stand_in) == 3
    assert sorted((k[0], k[-1][2][1][1]) for k in lm._programs) == [
        ("prefill", 64), ("prefill_continue", 64), ("prefill_continue", 128)]


def test_capture_writes_nothing_the_caller_sees(stand_in, monkeypatch):  # noqa: F811
    """The capture pass of a continuation program runs with its row
    inactive: the cache is what it was until the replay writes the chunk."""
    lm = tiny_lm()
    cache = slot_state(lm)
    before = snapshot(cache)
    seen = []
    real = graphs._capture

    def capture_then_look(graph, fn, generator, device, pool=None):
        real(graph, fn, generator, device, pool)
        seen.append(snapshot(cache))

    monkeypatch.setattr(graphs, "_capture", capture_then_look)
    padded = np.zeros((1, 64), np.int32)
    padded[0, :10] = np.arange(3, 13)
    _, cache = lm.prefill_slot_continue(cache, padded, 2, 128, 10)
    assert len(seen) == 1
    for a, b in zip(seen[0], before):
        assert torch.equal(a, b)
    assert not torch.equal(cache.layers[0].k[2, 128:138], before[0][2, 128:138])
    assert cache.lengths.tolist() == [20, 0, 138]


@pytest.mark.parametrize("bad", ["slot", "length", "past the buffer"])
def test_replay_refuses_a_prefill_outside_the_cache(stand_in, bad):  # noqa: F811
    """A slot past the cache, a true length past the bucket, or a chunk
    past the buffer raise on the host, before any replay (on the card a
    device index out of range would end the process)."""
    lm = tiny_lm()
    cache = lm.init_cache(2, 128)
    padded = np.zeros((1, 64), np.int32)
    args = {"slot": (2, 64, 5), "length": (0, 0, 65), "past the buffer": (0, 128, 5)}[bad]
    with pytest.raises(ValueError, match="outside the cache"):
        lm.prefill_slot_continue(cache, padded, *args)
    assert not lm._programs


def test_chunked_and_reused_admissions_capture_nothing(stand_in):  # noqa: F811
    """After warmup, an engine with 256-token chunks over three 1024-token slots
    serves prompts whole, in chunks, and past a reused prefix (the second
    turn of a conversation) with no capture, and its tokens equal the
    eager engine's."""
    lm = tiny_lm()
    rng = np.random.default_rng(3)
    first = rng.integers(1, 500, 300).tolist()
    prompts = [("a", first), ("b", rng.integers(1, 500, 40).tolist()),
               ("c", rng.integers(1, 500, 700).tolist())]

    def serve(engine):
        engine.warmup()
        captured = graphs.captures
        outs = {}
        second = [("a2", first + [7, 8, 9] * 30)]  # shares a's 300-token prefix
        for batch in (prompts, second):
            qs = {rid: engine.submit(EngineRequest(rid, p, 6, GREEDY)) for rid, p in batch}
            for _ in range(400):
                if not engine.step() and engine.request_q.empty():
                    break
            for rid, q in qs.items():
                toks = []
                while not (r := q.get(timeout=10)).finished:
                    toks.append(r.token)
                outs[rid] = toks
        return outs, graphs.captures - captured, engine.stats.prefix_tokens_reused

    kw = dict(max_slots=3, max_seq_len=1024, prefill_chunk=256, decode_tokens_per_seq=4)
    got, captured, reused = serve(InferenceEngine(lm, **kw))
    assert captured == 0 and reused >= 256
    with graphs.eager():
        ref, _, _ = serve(InferenceEngine(lm, **kw))
    assert got == ref and all(len(t) == 6 for t in got.values())
