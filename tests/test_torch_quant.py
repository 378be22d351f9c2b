"""crane_tpu_torch's quantized serving path against crane_tpu's (CPU, fp32).

In-situ quantized weights (int8 / packed int4, per-channel or blockwise) and
int8 / int4 KV caches: stored codes and scales must be byte-identical to
crane_tpu's, products agree within rtol/atol 2e-4, and greedy tokens are
identical. Inputs are drawn with numpy from a seed and handed to both
packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models import auto as jauto
from crane_tpu.models import init as jinit
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.modules import transformer as jtf
from crane_tpu.ops import kv_cache as jkv
from crane_tpu.ops import linear as jlinear
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import auto as tauto
from crane_tpu_torch.models import init as tinit
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops import kv_cache as tkv
from crane_tpu_torch.ops import linear as tlinear
from crane_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = jinit.QWEN3_TINY
PAIRS = np.array([(a, b) for a in range(-7, 8) for b in range(-7, 8)], np.int8)  # 225


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def same_weight(t, j):
    assert isinstance(t, tlinear.QuantizedWeight)
    assert (t.block, t.bits) == (j.block, j.bits)
    assert t.codes.dtype == torch.int8 and t.scales.dtype == torch.float32
    same(t.codes, j.codes)
    same(t.scales, j.scales)


def test_int4_packing_all_code_pairs():
    """Every (lo, hi) pair of int4 codes packs to the reference's byte, along
    the last dim (KV cache) and along the rows (weights), and unpacks back."""
    lo_hi = PAIRS.T.copy()  # [2, 225]: row 0 low codes, row 1 high codes
    same(tkv.pack_int4(torch.tensor(PAIRS)), jkv.pack_int4(jnp.asarray(PAIRS)))
    same(tlinear.pack_int4_rows(torch.tensor(lo_hi)), jlinear.pack_int4_rows(jnp.asarray(lo_hi)))
    same(tkv.unpack_int4(tkv.pack_int4(torch.tensor(PAIRS))), PAIRS)
    same(tlinear.unpack_int4_rows(tlinear.pack_int4_rows(torch.tensor(lo_hi))), lo_hi)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("granularity", ["channel", "block"])
def test_quantize_weight_matches(bits, granularity):
    """Hidden 1536, whose int4 rows pack to 768; a zero column gets a zero
    scale."""
    w = rnd(1536, 40, seed=1)
    w[:, 3] = 0.0
    tq = tlinear.quantize_weight(torch.tensor(w), bits=bits, granularity=granularity)
    jq = jlinear.quantize_weight(jnp.asarray(w), bits=bits, granularity=granularity)
    same_weight(tq, jq)
    assert tq.shape == (1536, 40) and tq.packed == (bits == 4 and granularity == "channel")
    np.testing.assert_allclose(tq.dequant(torch.float32).numpy(),
                               np.asarray(jq.dequant(jnp.float32)), **TOL)


@pytest.mark.parametrize("route,bits,M", [
    ("quant_matmul", 8, 5), ("quant_matmul", 4, 256),  # K6's route (M <= 256)
    ("plain", 8, 300), ("plain", 4, 300),              # prefill-sized M
    ("block", 8, 7), ("block", 4, 7),                  # GGUF granularity
    ("w8a8", 8, 300),                                  # CRANE_W8A8=1 opt-in
])
def test_linear_quantized_routes(route, bits, M, monkeypatch):
    if route == "w8a8":
        monkeypatch.setenv("CRANE_W8A8", "1")
    x, w, b = rnd(M, 96, seed=2), rnd(96, 64, seed=3), rnd(64, seed=4)
    gran = "block" if route == "block" else "channel"
    jq = jlinear.quantize_weight(jnp.asarray(w), bits=bits, granularity=gran)
    got = tlinear.linear(torch.tensor(x), params_from_jax(jq), torch.tensor(b))
    ref = jlinear.linear(jnp.asarray(x), jq, jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


class TestQuantKVCache:
    B, T, H, D = 3, 16, 2, 8

    def _pair(self, bits):
        return (tkv.QuantLayerKVCache.empty(self.B, self.T, self.H, self.D, bits=bits),
                jkv.QuantLayerKVCache.empty(self.B, self.T, self.H, self.D, bits=bits))

    @staticmethod
    def _same(t, j):
        for name in ("k", "v", "k_scale", "v_scale"):
            same(getattr(t, name), getattr(j, name))

    @pytest.mark.parametrize("bits", [8, 4])
    def test_int_start_row_write_and_dequant(self, bits):
        t, j = self._pair(bits)
        kn, vn = rnd(1, 5, self.H, self.D, seed=5), rnd(1, 5, self.H, self.D, seed=6)
        kn[0, 2, 1] = 0.0  # an all-zero head vector: zero scale, zero codes
        t.update(torch.tensor(kn), torch.tensor(vn), 3, row=1)
        j = j.update(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(3, jnp.int32), row=1)
        self._same(t, j)
        assert t.k.shape == (self.B, self.T, self.H * self.D // (2 if bits == 4 else 1))
        assert t.head_dim == self.D
        for got, ref in zip(t.dequant(torch.float32), j.dequant(jnp.float32)):
            same(got, ref)

    @pytest.mark.parametrize("bits", [8, 4])
    def test_per_row_write_drops_out_of_range(self, bits):
        """Batched decode: per-row positions; a position >= max_seq
        (an inactive slot) drops its codes and its scales."""
        t, j = self._pair(bits)
        old = rnd(self.B, self.T, self.H, self.D, seed=7)  # stale data to keep
        t.update(torch.tensor(old), torch.tensor(old), 0)
        j = j.update(jnp.asarray(old), jnp.asarray(old), jnp.asarray(0, jnp.int32))
        kn, vn = rnd(self.B, 1, self.H, self.D, seed=8), rnd(self.B, 1, self.H, self.D, seed=9)
        pos = np.array([0, self.T, 9], np.int32)
        t.update(torch.tensor(kn), torch.tensor(vn), torch.tensor(pos))
        j = j.update(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
        self._same(t, j)

    def test_row_view_writes_through_and_sizes(self):
        c = tkv.KVCache.empty(2, 3, 16, 2, 8, torch.float32, quant_bits=4)
        r = c.row(2)
        r.layers[1].update(torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8), 5)
        assert c.layers[1].k_scale[2, :, 5:7].gt(0).all() and c.layers[1].k_scale[:2].eq(0).all()
        # per layer: int4 codes 3 x 16 x 2 x 4 bytes for k and v, float32
        # scales 3 x 2 x 16 for k and v; plus the int32 lengths
        assert c.nbytes() == 2 * (2 * 3 * 16 * 2 * 4 + 2 * 3 * 2 * 16 * 4) + 3 * 4
        meta = tkv.KVCache.empty(2, 3, 16, 2, 8, None, "meta", quant_bits=4)
        assert meta.nbytes() == c.nbytes()
        with pytest.raises(ValueError, match="8 or 4"):
            tkv.QuantLayerKVCache.empty(1, 4, 1, 8, bits=2)


def _tiny(vocab=None):
    cfg = TINY if vocab is None else dataclasses.replace(TINY, vocab_size=vocab)
    return cfg, jinit.init_params(cfg, seed=0, dtype=jnp.float32)


@pytest.mark.parametrize("bits,env,tied_head", [(8, None, False), (4, None, True),
                                                (8, "1", True), (4, "0", False)])
def test_quantize_params_matches(bits, env, tied_head, monkeypatch):
    """The tied head is quantized by default for int4, not for int8, and
    CRANE_QUANT_TIED_HEAD overrides; the head's vocab is padded with zero
    columns to a multiple of 512 (300 -> 512); the logits are sliced back."""
    if env is not None:
        monkeypatch.setenv("CRANE_QUANT_TIED_HEAD", env)
    cfg, jp = _tiny(vocab=300)
    jq = jauto.quantize_params(jp, bits=bits)
    tq = tauto.quantize_params(params_from_jax(jp), bits=bits)
    jflat = jax.tree_util.tree_leaves_with_path(jq)
    assert ("lm_head" in tq) == ("lm_head" in jq) == tied_head
    for name in ("wq", "wk", "wv", "wo"):
        same_weight(tq["layers"][1]["attn"][name], jq["layers"][1]["attn"][name])
    for name in ("gate", "up", "down"):
        same_weight(tq["layers"][0]["mlp"][name], jq["layers"][0]["mlp"][name])
    assert len(jflat) == sum(len(w.tensors()) if isinstance(w, tlinear.QuantizedWeight) else 1
                             for w in _leaves(tq))
    if tied_head:
        same_weight(tq["lm_head"], jq["lm_head"])
        assert tq["lm_head"].shape == (cfg.hidden_size, 512)
        assert not tq["lm_head"].codes[:, 300:].any()
    h = rnd(2, 3, cfg.hidden_size, seed=10)
    tcfg = ttf.TransformerConfig(**dataclasses.asdict(cfg))
    got = ttf.lm_logits(tcfg, tq, torch.tensor(h))
    assert got.shape == (2, 3, 300) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jtf.lm_logits(cfg, jq, jnp.asarray(h))),
                               **TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


QUANT = [(8, 8), (4, 4)]


@pytest.mark.parametrize("wbits,kvbits", QUANT)
def test_forward_hidden_prefill_continue_decode(wbits, kvbits):
    """A fresh prefill (K2), a continuation chunk over the quantized cache
    (K5) and a batched decode step with an inactive row (K4), with ISQ
    weights (K6), each against crane_tpu's forward_hidden; the caches' codes
    and scales stay byte-identical."""
    cfg, jp = _tiny()
    jq = jauto.quantize_params(jp, bits=wbits)
    tq = params_from_jax(jq)
    tcfg = tinit.QWEN3_TINY
    B, T = 2, 32
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (B, 20)).astype(np.int32)
    jrope, trope = jtf.make_rope_tables(cfg), ttf.make_rope_tables(tcfg)
    jc = jtf.make_cache(cfg, B, T, jnp.float32, quant_bits=kvbits)
    tc = ttf.make_cache(tcfg, B, T, torch.float32, quant_bits=kvbits)

    def both(tokens, jpos, tpos, **kw):
        nonlocal jc, tc
        jh, jc = jtf.forward_hidden(cfg, jq, jnp.asarray(tokens), jc, jpos, jrope, **kw)
        tkw = {k: (torch.tensor(np.asarray(v)) if k == "active" else v) for k, v in kw.items()}
        th, tc = ttf.forward_hidden(tcfg, tq, torch.tensor(tokens), tc, tpos, trope, **tkw)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(ttf.lm_logits(tcfg, tq, th).numpy(),
                                   np.asarray(jtf.lm_logits(cfg, jq, jh)), **TOL)
        same(tc.lengths, jc.lengths)

    both(toks[:, :12], jnp.asarray(0, jnp.int32), 0, read_cache=False)
    both(toks[:, 12:], jnp.asarray(12, jnp.int32), 12)
    active = np.array([True, False])
    pos = np.asarray(jc.lengths)
    both(toks[:, :1], jnp.asarray(pos), torch.tensor(pos), active=active)
    for jl, tl in zip(jc.layers, tc.layers):
        assert isinstance(tl, tkv.QuantLayerKVCache) and tl.bits == kvbits
        # the keys are float32 sums of another order, so a code may sit one
        # step over (int8) or one nibble over (int4, 16 in the packed byte)
        # where a key lies near a half-code boundary
        for name in ("k", "v"):
            got, ref = getattr(tl, name).numpy(), np.asarray(getattr(jl, name))
            assert np.mean(got == ref) > 0.99
            assert np.abs(got.astype(int) - ref).max() <= 17
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                       **TOL)


@pytest.fixture(scope="module", params=QUANT, ids=["w8kv8", "w4kv4"])
def quant_pair(request):
    wbits, kvbits = request.param
    _, jp = _tiny()
    jq = jauto.quantize_params(jp, bits=wbits)
    return (JLM(TINY, jq, dtype=jnp.float32), TLM(tinit.QWEN3_TINY, params_from_jax(jq),
                                                    dtype=torch.float32), kvbits)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_generate_greedy_tokens_identical(quant_pair, penalty):
    jl, tl, kvbits = quant_pair
    prompt = list(np.random.default_rng(7).integers(1, 500, 70))  # crosses a bucket
    kw = dict(repetition_penalty=penalty, kv_quant_bits=kvbits)
    assert tl.generate(prompt, GenerationConfig.greedy(24, **kw)) == \
        jl.generate(prompt, JGenerationConfig.greedy(24, **kw))


def test_slot_prefill_continue_and_decode(quant_pair):
    """The serving steps on a 3-slot quantized cache: a slot prefill, a
    continuation chunk into that row (K5), then decode steps (K4)."""
    jl, tl, kvbits = quant_pair
    rng = np.random.default_rng(6)
    first = np.zeros((1, 16), np.int32)
    first[0, :11] = rng.integers(1, 500, 11)
    cont = np.zeros((1, 16), np.int32)
    cont[0, :9] = rng.integers(1, 500, 9)
    jc, tc = jl.init_cache(3, 64, quant_bits=kvbits), tl.init_cache(3, 64, quant_bits=kvbits)
    jlog, jc = jl.prefill_slot(jc, first, 1, 11)
    tlog, tc = tl.prefill_slot(tc, first, 1, 11)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jlog, jc = jl.prefill_slot_continue(jc, cont, 1, 11, 9)
    tlog, tc = tl.prefill_slot_continue(tc, cont, 1, 11, 9)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert not tc.layers[0].k[[0, 2]].any()  # other rows untouched

    from crane_tpu.ops.sampling import SamplingParams as JSP
    from crane_tpu_torch.ops.sampling import SamplingParams as TSP

    cur = np.array([0, int(np.argmax(jlog)), 0], np.int32)
    active = np.array([False, True, False])
    jt, jc, _ = jl.decode_active(jc, cur, jnp.full((3, 4), -1, jnp.int32),
                                 JSP.make(3, do_sample=False), jax.random.PRNGKey(0), active, 3)
    tt, tc, _ = tl.decode_active(tc, cur, torch.full((3, 4), -1, dtype=torch.int32),
                                 TSP.make(3, do_sample=False), torch.Generator(), active, 3)
    same(tt, jt)
    same(tc.lengths, jc.lengths)


@pytest.mark.parametrize("bits", [8, 4])
def test_from_pretrained_quantized_matches_crane_tpu(tmp_path, bits):
    from tests.fixtures import make_tiny_qwen3_checkpoint

    d = make_tiny_qwen3_checkpoint(str(tmp_path / "ckpt"))
    jl = jauto.from_pretrained(d, dtype=jnp.float32, quant_bits=bits)
    tl = tauto.from_pretrained(d, dtype=torch.float32, device="cpu", quant_bits=bits)
    assert ("lm_head" in tl.params) == ("lm_head" in jl.params)
    for layer_t, layer_j in zip(tl.params["layers"], jl.params["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            same_weight(layer_t["attn"][name], layer_j["attn"][name])
        for name in ("gate", "up", "down"):
            same_weight(layer_t["mlp"][name], layer_j["mlp"][name])
    prompt = [3, 14, 15, 42, 6]  # the checkpoint's vocabulary has 67 ids
    assert tl.generate(prompt, GenerationConfig.greedy(10, kv_quant_bits=bits)) == \
        jl.generate(prompt, JGenerationConfig.greedy(10, kv_quant_bits=bits))
