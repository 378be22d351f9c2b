"""Speculative decoding in crane_tpu_torch against crane_tpu, on the CPU.

The port of prompt-lookup speculation (``ngram_propose``,
``device_ngram_propose``, ``verify_step`` / ``verify_active`` /
``verify_slot``, ``spec_rounds``, ``decode_active_hist`` and
``generate(speculative="ngram")``) runs on crane_tpu's weights from
crane_tpu's own prefilled caches (``utils/bridge.py``): drafts, the model's
tokens, the accepted counts, the rolled lengths and the history rows must be
identical, on fp, int8 and int4 caches. ``generate`` with speculation must
give plain greedy decoding's tokens and crane_tpu's; the configs crane_tpu's
gate keeps out of speculation (sampled, penalised) must quietly take plain
decoding. The per-row cache write a verify chunk makes is held at the
buffer's end and across a slab boundary. The K/V that speculation writes is
held slot by slot against the K/V plain decoding writes for the same
tokens, in bf16 and with int4 weights on an int4 cache.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models import causal_lm as jcl
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.init import QWEN3_TINY, init_params
from crane_tpu.ops.sampling import SamplingParams as JSamplingParams
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import causal_lm as tcl
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.kv_cache import LayerKVCache, QuantLayerKVCache
from crane_tpu_torch.ops.sampling import SamplingParams
from crane_tpu_torch.utils.bridge import cache_from_jax, params_from_jax

torch.set_num_threads(2)

KV_BITS = [None, 8, 4]
# three rows of different lengths; the middle one idles in the masked calls
PROMPTS = [[5, 6, 7, 8] * 5, [3, 14, 15, 92, 6, 53, 3, 14, 15], [9, 9, 9, 9, 9, 9, 9]]
ACTIVE = np.array([True, False, True])


@pytest.fixture(scope="module")
def lms():
    jl = JLM(QWEN3_TINY, init_params(QWEN3_TINY, seed=0, dtype=jnp.float32), dtype=jnp.float32)
    cfg = ttf.TransformerConfig(**dataclasses.asdict(QWEN3_TINY))
    return jl, TLM(cfg, params_from_jax(jl.params), dtype=torch.float32)


def prefilled(jl, kv_bits, max_seq=128):
    """crane_tpu's cache after a padded prefill of PROMPTS, with its copy in
    the port, and each row's first greedy token."""
    lens = [len(p) for p in PROMPTS]
    padded = np.zeros((len(PROMPTS), 64), np.int32)
    for i, p in enumerate(PROMPTS):
        padded[i, :len(p)] = p
    logits, jc = jl.prefill(jl.init_cache(len(PROMPTS), max_seq, quant_bits=kv_bits), padded,
                            np.asarray(lens, np.int32))
    first = np.asarray(logits).argmax(-1).astype(np.int32)
    return jc, cache_from_jax(jc), first


def history_rows(first, width):
    """Each row's prompt and first token, zero-padded to ``width``."""
    hist = np.zeros((len(PROMPTS), width), np.int32)
    for i, p in enumerate(PROMPTS):
        hist[i, :len(p)] = p
        hist[i, len(p)] = first[i]
    return hist


@pytest.mark.parametrize("history,n,k,expected", [
    ([1, 2, 3, 9, 8, 1, 2, 3], 3, 2, [9, 8]),
    ([1, 2, 5, 7, 1, 2, 6, 1, 2], 2, 1, [6]),
    ([1, 2, 3, 4], 2, 3, [0, 0, 0]),
    ([1], 3, 2, [0, 0]),
    ([1, 2, 3, 1, 2], 2, 4, [3, 1, 2, 0]),
    ([4, 4, 4, 4, 4], 1, 3, [4, 4, 4]),
])
def test_ngram_propose(history, n, k, expected):
    """tests/test_speculative.py's cases (continuation, most recent match,
    no match, short continuation) and a constant run, equal to crane_tpu's."""
    assert tcl.ngram_propose(history, n, k) == expected
    assert jcl.ngram_propose(history, n, k) == expected


@pytest.mark.parametrize("n,k", [(3, 6), (2, 8), (1, 4)])
def test_device_ngram_propose_matches_crane_tpu(n, k):
    """Seeded random histories (dense repeats, sparse matches, a cycle up to
    the buffer's end, rows shorter than the n-gram): the port's drafts equal
    crane_tpu's device proposer's and the host proposer's, token for token."""
    rng = np.random.default_rng(n * 10 + k)
    H = 64
    cases = []
    for L in [1, 2, 3, 4, 7, 20, 40, 64]:
        cases.append(rng.integers(1, 5, L).tolist())
        cases.append(rng.integers(1, 50, L).tolist())
    cases.append(([7, 8, 9] * 22)[:64])
    hist = np.zeros((len(cases), H), np.int32)
    lens = np.array([len(c) for c in cases], np.int32)
    for i, c in enumerate(cases):
        hist[i, :len(c)] = c
    got = tcl.device_ngram_propose(torch.from_numpy(hist), torch.from_numpy(lens), n, k)
    ref = np.asarray(jcl.device_ngram_propose(jnp.asarray(hist), jnp.asarray(lens), n, k))
    np.testing.assert_array_equal(got.numpy(), ref)
    for i, c in enumerate(cases):
        assert got[i].tolist() == tcl.ngram_propose(c, n, k), (i, c)


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_verify_step_and_active_match_crane_tpu(lms, kv_bits):
    """One verify of [cur, d1..d4] per row: model tokens, accepted counts
    and rolled lengths equal crane_tpu's, over every row (verify_step) and
    with the middle row masked out (verify_active: its length stays, its
    tokens are not compared). The drafts are each row's own greedy
    continuation with one token changed (at 3, never, 1), so every
    acceptance count from 0 to k shows up."""
    jl, tl = lms
    _, _, first = prefilled(jl, kv_bits)
    rows = []
    for p, wrong in zip(PROMPTS, (2, None, 0)):
        cont = jl.generate(p, JGenerationConfig.greedy(5, kv_quant_bits=kv_bits))
        drafts = cont[1:]
        if wrong is not None:
            drafts[wrong] = (drafts[wrong] + 1) % QWEN3_TINY.vocab_size
        rows.append(cont[:1] + drafts)
    toks = np.asarray(rows, np.int32)
    for masked in (False, True):
        jc, tc, _ = prefilled(jl, kv_bits)
        if masked:
            jt, jn, jc = jl.verify_active(jc, toks, ACTIVE)
            tt, tn, tc = tl.verify_active(tc, toks, torch.from_numpy(ACTIVE))
            live = ACTIVE
        else:
            jt, jn, jc = jl.verify_step(jc, toks)
            tt, tn, tc = tl.verify_step(tc, toks)
            live = np.ones(len(PROMPTS), bool)
            np.testing.assert_array_equal(np.asarray(jn), [2, 4, 0])
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
        np.testing.assert_array_equal(tn.numpy()[live], np.asarray(jn)[live])
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_verify_slot_matches_crane_tpu(lms, kv_bits):
    """verify_slot on row 2 of the three-row cache: crane_tpu's row-sliced
    verify and the port's one-row-active verify give the same tokens and
    counts, roll that row's length only, and leave the other rows' KV as
    it was."""
    jl, tl = lms
    jc, tc, first = prefilled(jl, kv_bits)
    before = [t.clone() for layer in tc.layers for t in layer.tensors()]
    toks = np.asarray([[int(first[2])] + [9] * 4], np.int32)
    jt, jn, jc = jl.verify_slot(jc, toks, 2)
    tt, tn, tc = tl.verify_slot(tc, toks, 2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    after = [t for layer in tc.layers for t in layer.tensors()]
    for b, a in zip(before, after):
        assert torch.equal(b[:2], a[:2])


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_spec_rounds_match_crane_tpu(lms, kv_bits):
    """Three chained rounds of four drafts from the device history, middle
    row idle: each round's model tokens and accepted counts on the live
    rows, the rolled lengths and every history row equal crane_tpu's."""
    jl, tl = lms
    R, k, n = 3, 4, 2
    jc, tc, first = prefilled(jl, kv_bits)
    hist = history_rows(first, 128 + k + 2)
    jt, jn, jc, jh = jl.spec_rounds(jc, jnp.asarray(hist), ACTIVE, R, k, n)
    th = torch.from_numpy(hist.copy())
    tt, tn, tc, th = tl.spec_rounds(tc, th, torch.from_numpy(ACTIVE), R, k, n)
    assert tt.shape == (R, 3, k + 1) and tn.shape == (R, 3)
    np.testing.assert_array_equal(tt.numpy()[:, ACTIVE], np.asarray(jt)[:, ACTIVE])
    np.testing.assert_array_equal(tn.numpy()[:, ACTIVE], np.asarray(jn)[:, ACTIVE])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert np.asarray(jn)[:, ACTIVE].sum() > 0  # drafts were accepted


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_decode_active_hist_matches_crane_tpu(lms, kv_bits):
    """Four greedy masked decode steps that also write the history rows:
    tokens on the live rows, lengths, recent rings and history equal
    crane_tpu's; the idle row's history, length and ring stay put."""
    jl, tl = lms
    jc, tc, first = prefilled(jl, kv_bits)
    hist = history_rows(first, 128 + 10)
    recent = np.full((3, 8), -1, np.int32)
    jsp = JSamplingParams.make(3, do_sample=False)
    tsp = SamplingParams.make(3, do_sample=False)
    import jax

    jo, jc, jr, jh = jl.decode_active_hist(jc, first, jnp.asarray(recent), jsp,
                                           jax.random.PRNGKey(0), ACTIVE, 4, jnp.asarray(hist))
    th = torch.from_numpy(hist.copy())
    tr = torch.from_numpy(recent.copy())
    to, tc, tr, th = tl.decode_active_hist(tc, first, tr, tsp, torch.Generator(),
                                           torch.from_numpy(ACTIVE), 4, th)
    np.testing.assert_array_equal(to.numpy()[ACTIVE], np.asarray(jo)[ACTIVE])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("prompt", [
    [3, 14, 15, 92, 6, 53],
    [7] * 8,
    list(range(40, 52)) * 3,
    [11],
])
def test_generate_speculative_matches_plain_and_crane_tpu(lms, prompt):
    """tests/test_speculative.py's prompts: speculative generate equals
    plain greedy generate and crane_tpu's speculative generate."""
    jl, tl = lms
    plain = tl.generate(prompt, GenerationConfig.greedy(24))
    spec = tl.generate(prompt, GenerationConfig.greedy(24, speculative="ngram"))
    assert spec == plain
    assert spec == jl.generate(prompt, JGenerationConfig.greedy(24, speculative="ngram"))


@pytest.mark.parametrize("kv_bits", KV_BITS)
@pytest.mark.parametrize("spec_k", [1, 4, 8])
def test_generate_spec_k_and_kv_bits(lms, spec_k, kv_bits):
    """spec_k 1, 4 and 8 on fp, int8 and int4 caches: the verify chunk writes
    k + 1 tokens per round into the cache (codes and scale planes), and the
    tokens equal plain greedy decoding on the same cache and crane_tpu."""
    jl, tl = lms
    prompt = [5, 6, 7, 8] * 4 + [3, 14, 15]
    plain = tl.generate(prompt, GenerationConfig.greedy(16, kv_quant_bits=kv_bits))
    spec = tl.generate(prompt, GenerationConfig.greedy(16, speculative="ngram", spec_k=spec_k,
                                                       kv_quant_bits=kv_bits))
    assert spec == plain
    assert spec == jl.generate(prompt, JGenerationConfig.greedy(
        16, speculative="ngram", spec_k=spec_k, kv_quant_bits=kv_bits))


# the largest per-slot relative distance between speculative and plain K/V:
# the two paths compute each position's K/V in different products (a verify
# chunk of k + 1 rows against one row a step), which may round apart in bf16
# (on the CPU they read 0), and an int4 code may land one step over; a slot
# written one position off reads about 1 or more (the control below)
SLOT_BOUND = {"bf16": 0.05, "w4 kv4": 0.2}


def spec_and_plain_caches(tl, prompt, n, kv_bits):
    """The K/V ``generate`` leaves in its kept cache after ``n`` greedy
    tokens, plainly and speculatively (spec_k 4), with both token lists.
    Returns (plain layers, speculative layers, live slots, plain tokens,
    speculative tokens)."""
    plain = tl.generate(prompt, GenerationConfig.greedy(n, kv_quant_bits=kv_bits))
    cache = tl._generate_caches[(256, kv_bits)][0]
    plain_layers = clone_layers(cache.layers)
    spec = tl.generate(prompt, GenerationConfig.greedy(n, speculative="ngram", spec_k=4,
                                                       kv_quant_bits=kv_bits))
    assert tl._generate_caches[(256, kv_bits)][0] is cache
    # the K/V of the prompt and of every token fed back (all but the last)
    return plain_layers, cache.layers, len(prompt) + n - 1, plain, spec


def clone_layers(layers):
    return [dataclasses.replace(layer, **{
        f.name: getattr(layer, f.name).clone() for f in dataclasses.fields(layer)
        if isinstance(getattr(layer, f.name), torch.Tensor)}) for layer in layers]


@pytest.mark.parametrize("mode", ["bf16", "w4 kv4"])
def test_speculative_kv_equals_plain_kv_slot_by_slot(lms, mode):
    """The same greedy tokens decoded speculatively and plainly write the
    same K/V into every slot (bf16, and int4 weights on an int4 cache):
    the tokens alone cannot show a verify that writes a slot off, since
    random weights accept few drafts and the tie rule is blunt. A control
    with the speculative rows shifted one slot fails the bound."""
    from crane_tpu_torch.models.auto import quantize_params
    from crane_tpu_torch.ops.kv_cache import slot_errors

    _, tl = lms
    params = _tree(tl.params, lambda t: t.to(torch.bfloat16))
    kv_bits = None
    if mode == "w4 kv4":
        params, kv_bits = quantize_params(params, bits=4), 4
    model = TLM(tl.config, params, dtype=torch.bfloat16)
    prompt = [5, 6, 7, 8] * 5 + [3, 14, 15]
    plain_layers, spec_layers, live, plain, spec = spec_and_plain_caches(model, prompt, 24,
                                                                         kv_bits)
    assert spec == plain
    errs = slot_errors(spec_layers, plain_layers, 0, live)
    assert errs.max().item() < SLOT_BOUND[mode], errs
    shifted = [dataclasses.replace(layer, **{
        f.name: torch.roll(getattr(layer, f.name), 1, dims=2 if f.name.endswith("scale") else 1)
        for f in dataclasses.fields(layer) if isinstance(getattr(layer, f.name), torch.Tensor)})
        for layer in spec_layers]
    assert slot_errors(shifted, plain_layers, 0, live).max().item() > SLOT_BOUND[mode]


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, fn) for v in tree)
    return fn(tree)


def test_generate_eos_inside_accepted_block(lms):
    """An EOS inside an accepted block stops generation there, as plain
    decoding does."""
    jl, tl = lms
    prompt = [3, 14, 15, 92, 6]
    full = tl.generate(prompt, GenerationConfig.greedy(16))
    eos = full[5]
    plain = tl.generate(prompt, GenerationConfig.greedy(16, eos_token_ids=(eos,)))
    spec = tl.generate(prompt, GenerationConfig.greedy(16, eos_token_ids=(eos,),
                                                       speculative="ngram"))
    assert spec == plain == full[:full.index(eos) + 1]
    assert spec == jl.generate(prompt, JGenerationConfig.greedy(
        16, eos_token_ids=(eos,), speculative="ngram"))


@pytest.mark.parametrize("cfg", [
    dict(do_sample=True, temperature=0.9, seed=5),
    dict(do_sample=False, repetition_penalty=1.3),
])
def test_gate_takes_plain_decoding(lms, cfg):
    """Sampled and penalised configs quietly take plain decoding, as
    crane_tpu's gate says: with the same seed the tokens equal the
    non-speculative run's, and no verify runs."""
    _, tl = lms
    prompt = [3, 14, 15, 3, 14, 15]
    plain = tl.generate(prompt, GenerationConfig(max_new_tokens=12, **cfg))
    calls = []
    verify = tl.verify_step
    tl.verify_step = lambda *a: calls.append(1) or verify(*a)
    try:
        spec = tl.generate(prompt, GenerationConfig(max_new_tokens=12, speculative="ngram", **cfg))
    finally:
        del tl.verify_step
    assert spec == plain and not calls


def test_generate_headroom_at_its_edge(lms):
    """prompt + max_new_tokens + spec_k + 1 == 256 exactly: the cache is the
    256-slot bucket and the last verify chunk ends inside it; the tokens
    equal plain greedy decoding's on the same cache and crane_tpu's."""
    jl, tl = lms
    k, n = 8, 40
    prompt = ([5, 6, 7, 8] * 60)[:256 - n - k - 1]
    spec = tl.generate(prompt, GenerationConfig.greedy(n, speculative="ngram", spec_k=k))
    assert (256, None) in tl._generate_caches
    assert spec == tl.generate(prompt, GenerationConfig.greedy(n))
    assert spec == jl.generate(prompt, JGenerationConfig.greedy(n, speculative="ngram", spec_k=k))


def test_generate_keeps_its_cache_per_shape(lms):
    """A second generate of the same shape reuses the first's cache (and on
    the card its captured blocks); another kv width gets its own."""
    _, tl = lms
    tl.release_graphs()
    a = tl.generate([1, 2, 3], GenerationConfig.greedy(5))
    cache = tl._generate_caches[(256, None)][0]
    assert tl.generate([1, 2, 3], GenerationConfig.greedy(5)) == a
    assert tl._generate_caches[(256, None)][0] is cache
    tl.generate([1, 2, 3], GenerationConfig.greedy(5, kv_quant_bits=8))
    assert set(tl._generate_caches) == {(256, None), (256, 8)}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("start", [-3, 0, 5, 9, 12])
def test_chunk_write_drops_outside_the_buffer(quant, start):
    """A per-row write of a 5-token chunk into a 12-slot buffer: the tokens
    inside [0, 12) land, the rest are dropped, whatever the order of the
    index_put (a dropped token lands on the row's nearest written slot with
    that slot's token; a row with none stores the old value back)."""
    B, T, H, D = 2, 12, 2, 8
    gen = torch.Generator().manual_seed(start + 10)
    if quant:
        cache = QuantLayerKVCache.empty(B, T, H, D, bits=8)
    else:
        cache = LayerKVCache.empty(B, T, H, D, torch.float32)
    cache.update(torch.randn(B, T, H, D, generator=gen), torch.randn(B, T, H, D, generator=gen), 0)
    old = [t.clone() for t in cache.tensors()]
    k_new, v_new = torch.randn(B, 5, H, D, generator=gen), torch.randn(B, 5, H, D, generator=gen)
    ref = LayerKVCache(*(t.clone() for t in old[:2])) if not quant else None
    pos = torch.tensor([start, T], dtype=torch.int32)  # row 1 writes nothing
    cache.update(k_new, v_new, pos)
    lo, hi = max(start, 0), min(start + 5, T)
    if quant:
        full = QuantLayerKVCache.empty(B, T, H, D, bits=8)
        for t, o in zip(full.tensors(), old):
            t.copy_(o)
        if hi > lo:
            full.row(0).update(k_new[:1, lo - start:hi - start], v_new[:1, lo - start:hi - start],
                               lo)
        expected = full.tensors()
    else:
        if hi > lo:
            ref.k[0, lo:hi] = k_new[0, lo - start:hi - start]
            ref.v[0, lo:hi] = v_new[0, lo - start:hi - start]
        expected = ref.tensors()
    for got, exp in zip(cache.tensors(), expected):
        assert torch.equal(got, exp)
