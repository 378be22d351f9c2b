"""The CUDA-graph programs of crane_tpu_torch's decode blocks, held on the CPU.

``models/graphs.py`` captures each decode block (plain, with history,
speculative rounds, verify) once and replays it; only the card can capture.
Here the tests set a stand-in for ``torch.cuda.CUDAGraph`` and for the
capture: the stand-in "captures" by running the block once on its static
buffers (with the all-false ``active`` mask a real capture sees, so it must
change nothing the caller can see) and "replays" by running it again. That
holds the graph module's bookkeeping against the eager loop: the program
keys, the copies into and out of the static buffers, the generator handed
to the graph, the launch and plain-route counts added per replay, and the
engine's warmup capturing every program serving reaches. The main path never
sees the stand-in; on the card tests/test_torch_cuda.py runs the real
graphs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.init import QWEN3_TINY, init_params
from crane_tpu_torch.models.modules.transformer import attention_block
from crane_tpu_torch.ops.sampling import SamplingParams
from crane_tpu_torch.serve.engine import EngineRequest, InferenceEngine, SamplingOptions

torch.set_num_threads(2)

GREEDY = SamplingOptions(do_sample=False, repetition_penalty=1.0)


class StandInGraph:
    """Records what the program hands a CUDA graph; a replay runs the
    captured block again with the launch counters left as they were (the
    program adds the capture's counts itself)."""

    def __init__(self):
        self.fn = None
        self.generators = []
        self.replays = 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        saved = graphs.counts()
        self.fn()
        graphs.set_counts(*saved)
        self.replays += 1


def stand_in_warm_up(fn, generator, device):
    """The warm-up without a side stream: ``fn`` once, its random draws
    taken back."""
    state = generator.get_state() if generator is not None else None
    fn()
    if generator is not None:
        generator.set_state(state)


def stand_in_capture(graph, fn, generator, device, pool=None):
    """The capture pass: ``fn`` once on the static buffers (its launch
    counts stay, as a capture's do; its random draws are taken back, as the
    capture draws none)."""
    if generator is not None:
        graph.register_generator_state(generator)
    graph.fn = fn
    stand_in_warm_up(fn, generator, device)


@pytest.fixture
def stand_in(monkeypatch):
    """CPU models take graphs through the stand-in; graphs.eager() still
    forces the eager loop."""
    made = []

    def new_graph():
        made.append(StandInGraph())
        return made[-1]

    monkeypatch.setattr(graphs, "_new_graph", new_graph)
    monkeypatch.setattr(graphs, "_warm_up", stand_in_warm_up)
    monkeypatch.setattr(graphs, "_capture", stand_in_capture)
    monkeypatch.setattr(graphs, "takes_graphs",
                        lambda device, mesh=(): not getattr(graphs._local, "eager", False))
    return made


def tiny_lm(**fields):
    cfg = dataclasses.replace(QWEN3_TINY, **fields)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    return CausalLM(cfg, params, dtype=torch.float32)


def state(lm, B=3, T=64):
    """A cache after a ragged prefill of B rows, their first tokens, recent
    rings, sampling params (row 1 samples) and a ragged active mask."""
    lens = [9, 20, 5][:B]
    rng = np.random.default_rng(1)
    padded = np.zeros((B, 64), np.int32)
    for i, n in enumerate(lens):
        padded[i, :n] = rng.integers(1, 200, n)
    logits, cache = lm.prefill(lm.init_cache(B, T), padded, lens)
    sp = SamplingParams.make(B, do_sample=False)
    sp.set_row(1, temperature=0.8, top_k=0, top_p=0.9, repetition_penalty=1.1, do_sample=True)
    recent = torch.full((B, 8), -1, dtype=torch.int32)
    active = torch.tensor([True, True, False])[:B]
    return cache, logits.argmax(-1).to(torch.int32), recent, sp, active


def snapshot(cache):
    return [t.clone() for layer in cache.layers for t in layer.tensors()] + [cache.lengths.clone()]


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_graph_block_equals_eager_loop(stand_in):
    """Three masked blocks of four steps (a greedy row, a sampled row with a
    penalty, an idle row) through programs equal the eager loop: tokens,
    cache buffers, lengths and recent rings; the sampled row from one seed.
    One program for the three calls, with the generator registered."""
    lm = tiny_lm()
    runs = {}
    for mode in ("graph", "eager"):
        cache, toks, recent, sp, active = state(lm)
        gen = torch.Generator().manual_seed(7)
        outs = []
        ctx = graphs.eager() if mode == "eager" else torch.no_grad()
        with ctx:
            for _ in range(3):
                out, cache, recent = lm.decode_active(cache, toks, recent, sp, gen, active, 4)
                toks = out[:, -1]
                outs.append(out)
        runs[mode] = outs + [recent] + snapshot(cache)
    assert_same(runs["graph"], runs["eager"])
    assert len(stand_in) == 1 and stand_in[0].replays == 3
    assert len(stand_in[0].generators) == 1


def test_capture_writes_nothing_the_caller_sees(stand_in, monkeypatch):
    """The capture pass runs with every row inactive: the caller's cache,
    lengths, ring and history are what they were until the first replay."""
    lm = tiny_lm()
    cache, toks, recent, sp, active = state(lm)
    history = torch.zeros((3, 80), dtype=torch.int32)
    before = snapshot(cache) + [recent.clone(), history.clone()]
    seen = []
    real = stand_in_capture

    def capture_then_look(graph, fn, generator, device, pool=None):
        real(graph, fn, generator, device)
        seen.append(snapshot(cache) + [recent.clone(), history.clone()])

    monkeypatch.setattr(graphs, "_capture", capture_then_look)
    lm.decode_active_hist(cache, toks, recent, sp, torch.Generator(), active, 2, history)
    assert_same(seen[0], before)
    assert not torch.equal(history, before[-1])  # the replay did write


@pytest.mark.parametrize("fails", [False, True], ids=["captures", "capture-raises"])
def test_capture_pauses_the_garbage_collector(stand_in, monkeypatch, fails):
    """A capture runs with the cyclic collector paused (a CUDA graph it
    freed mid-capture would invalidate the capture), and the collector runs
    again after it, also when the capture raises; the warm-up and the
    replays leave it on."""
    import gc

    lm = tiny_lm()
    cache, toks, recent, sp, active = state(lm)
    seen = []

    def capture_and_look(graph, fn, generator, device, pool=None):
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("capture invalidated")
        stand_in_capture(graph, fn, generator, device)

    def warm_up_and_look(fn, generator, device):
        seen.append(gc.isenabled())
        stand_in_warm_up(fn, generator, device)

    monkeypatch.setattr(graphs, "_capture", capture_and_look)
    monkeypatch.setattr(graphs, "_warm_up", warm_up_and_look)
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="invalidated"):
            lm.decode_active(cache, toks, recent, sp, torch.Generator(), active, 2)
    else:
        lm.decode_active(cache, toks, recent, sp, torch.Generator(), active, 2)
    assert seen == [True, False] and gc.isenabled()


def test_program_keys(stand_in):
    """A program is keyed as a jit is: the same cache, sizes and generator
    replay one program; another n_steps, generator or cache buffer, or the
    history variant, capture another."""
    lm = tiny_lm()
    cache, toks, recent, sp, active = state(lm)
    gen = torch.Generator()
    start = graphs.captures
    for _ in range(2):
        lm.decode_active(cache, toks, recent, sp, gen, active, 2)
    assert graphs.captures - start == 1
    lm.decode_active(cache, toks, recent, sp, gen, active, 3)
    lm.decode_active(cache, toks, recent, sp, torch.Generator(), active, 2)
    lm.decode_active_hist(cache, toks, recent, sp, gen, active, 2,
                          torch.zeros((3, 80), dtype=torch.int32))
    other, *_ = state(lm)
    lm.decode_active(other, toks, recent, sp, gen, active, 2)
    assert graphs.captures - start == 5 and len(lm._programs) == 5
    lm.release_graphs()
    assert not lm._programs


def test_programs_hold_their_generator_and_cache(stand_in):
    """A program holds the generator and the cache layers it was captured
    with, so neither id nor buffer can pass to another object while it
    lives: each new generator over the same cache captures its own program
    and draws from its own seed (two generators of one seed give the
    sampled row the same tokens, another seed others)."""
    lm = tiny_lm()
    cache, toks, recent, sp, active = state(lm)
    start, ring = snapshot(cache), recent.clone()
    outs = []
    for seed in (3, 3, 4):
        for t, saved in zip([t for layer in cache.layers for t in layer.tensors()]
                            + [cache.lengths], start):
            t.copy_(saved)
        gen = torch.Generator().manual_seed(seed)
        out, cache, _ = lm.decode_active(cache, toks, ring.clone(), sp, gen, active, 4)
        outs.append(out)
        program = list(lm._programs.values())[-1]
        assert program.generator is gen and program.keep is cache.layers
        del gen
    assert len(lm._programs) == 3
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0][1], outs[2][1])
    assert torch.equal(outs[0][0], outs[2][0])  # the greedy row


def test_outputs_outlive_the_next_replay(stand_in):
    """The tokens a block hands back are copies of its static output, so a
    block's tokens read after the next block's replay are still its own
    (the engine's depth-1 pipeline reads them one block late)."""
    lm = tiny_lm()
    cache, toks, recent, sp, active = state(lm)
    gen = torch.Generator()
    first, cache, recent = lm.decode_active(cache, toks, recent, sp, gen, active, 2)
    kept = first.clone()
    lm.decode_active(cache, first[:, -1], recent, sp, gen, active, 2)
    assert torch.equal(first, kept)
    program = next(iter(lm._programs.values()))
    assert first.data_ptr() != program.statics["out"].data_ptr()


def test_counts_after_replays_equal_the_eager_loop(stand_in):
    """Head dim 96, which the attention kernels do not take: every decode
    step routes attention to the plain version and counts it in
    attention_block.plain_routes. N program replays leave the same counts
    as N eager blocks; the capture adds none of its own."""
    lm = tiny_lm(head_dim=96)
    counts = {}
    for mode in ("graph", "eager"):
        cache, toks, recent, sp, active = state(lm)
        gen = torch.Generator()
        before = dict(attention_block.plain_routes)
        ctx = graphs.eager() if mode == "eager" else torch.no_grad()
        with ctx:
            for _ in range(3):
                out, cache, recent = lm.decode_active(cache, toks, recent, sp, gen, active, 2)
                if mode == "graph":
                    assert len(stand_in) == 1
        counts[mode] = {k: attention_block.plain_routes[k] - before[k] for k in before}
    assert counts["graph"] == counts["eager"]
    assert counts["graph"]["decode"] == 3 * 2 * lm.config.num_layers


def test_engine_captures_nothing_after_warmup(stand_in):
    """warmup captures every program serving reaches (blocks of 1 and
    decode_tokens_per_seq steps with the history rows, the speculative
    rounds, and the slot prefills of every bucket: fresh 64 and 128,
    continuing 64); a mix of speculative, plain and sampled serving then
    captures none, and its tokens equal the eager engine's."""
    lm = tiny_lm()
    kw = dict(max_slots=3, max_seq_len=128, decode_tokens_per_seq=4, speculative="ngram",
              spec_k=4, spec_rounds=2)
    sampled = SamplingOptions(do_sample=True, temperature=0.9, repetition_penalty=1.0)
    reqs = [("a", [5, 6, 7, 8] * 5, 12, GREEDY), ("b", [3, 1, 4, 1, 5, 9, 2, 6], 10, GREEDY),
            ("c", [2, 7, 1, 8], 6, sampled)]

    def serve(engine):
        engine.warmup()
        captured = graphs.captures
        qs = [engine.submit(EngineRequest(rid, p, n, s)) for rid, p, n, s in reqs[:2]]
        for _ in range(200):
            if not engine.step() and engine.request_q.empty():
                break
        qs.append(engine.submit(EngineRequest(*reqs[2])))
        for _ in range(200):
            if not engine.step() and engine.request_q.empty():
                break
        toks = []
        for q in qs:
            out = []
            while (r := q.get(timeout=10)) and not r.finished:
                out.append(r.token)
            toks.append(out)
        return toks, graphs.captures - captured

    engine = InferenceEngine(lm, **kw)
    start = graphs.captures
    got, after = serve(engine)
    assert engine.prefill_buckets() == ([64, 128], [64])
    assert after == 0 and len(stand_in) == 6 and graphs.captures - start == 6
    assert engine.stats.spec_steps > 0
    with graphs.eager():
        ref, _ = serve(InferenceEngine(lm, **kw))
    assert got == ref and [len(t) for t in got] == [12, 10, 6]


def test_generate_replays_its_programs(stand_in):
    """A second generate of the same shape captures nothing; the tokens
    (plain, speculative, sampled) equal the eager loop's."""
    lm = tiny_lm()
    cfgs = [GenerationConfig.greedy(12), GenerationConfig.greedy(12, speculative="ngram", spec_k=4),
            GenerationConfig(max_new_tokens=12, do_sample=True, temperature=0.8, seed=3)]
    prompt = [5, 6, 7, 8] * 4
    got = [lm.generate(prompt, c) for c in cfgs]
    captured = graphs.captures
    assert [lm.generate(prompt, c) for c in cfgs] == got
    assert graphs.captures == captured
    with graphs.eager():
        assert [lm.generate(prompt, c) for c in cfgs] == got


def test_greedy_decode_step_replays_one_program(stand_in, monkeypatch):
    """The embed-splicing models' greedy step (Gemma3-VL, PaddleOCR-VL):
    one program over a cache, captured at the first step and replayed after;
    its tokens, the cache's lengths (rolled in place) and the KV it writes
    equal the eager steps', and the capture leaves K2's count of launches
    given segments (a prefill's, read after the steps) as it was."""
    from crane_tpu_torch.models.modules.embeds_decode import greedy_decode_step
    from crane_tpu_torch.ops.cuda.flash_attention import flash_attention_causal

    lm = tiny_lm()
    monkeypatch.setattr(flash_attention_causal, "segment_launches", 7)
    padded = np.zeros((1, 64), np.int32)
    padded[0, :8] = np.arange(5, 13)
    programs, got = {}, {}
    for mode in ("graph", "eager"):
        logits, cache = lm.prefill(lm.init_cache(1, 64), padded, [8])
        cur = torch.argmax(logits, -1).to(torch.int32)
        toks = []
        with graphs.eager() if mode == "eager" else torch.no_grad():
            for _ in range(6):
                cur, cache = greedy_decode_step(programs, lm.config, lm.params, lm.rope, cache,
                                                cur)
                toks.append(int(cur[0]))
        got[mode] = toks, cache.lengths.clone(), snapshot(cache)
    assert len(stand_in) == 1 and len(programs) == 1
    assert flash_attention_causal.segment_launches == 7
    assert got["graph"][0] == got["eager"][0]
    assert got["graph"][1].tolist() == got["eager"][1].tolist() == [14]
    assert all(torch.equal(a, b) for a, b in zip(got["graph"][2], got["eager"][2]))
