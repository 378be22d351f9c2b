"""crane_tpu_torch.ops against crane_tpu.ops on the same inputs (CPU, fp32).

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance rtol/atol 2e-4, as tests/test_model_parity.py uses; the KV cache
writes and greedy sampling must be exact. Sampled paths are checked by
invariants, because jax.random and torch.Generator draw different numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crane_tpu.ops import attention as jattn
from crane_tpu.ops import kv_cache as jkv
from crane_tpu.ops import linear as jlinear
from crane_tpu.ops import norm as jnorm
from crane_tpu.ops import rope as jrope
from crane_tpu.ops import sampling as jsamp
from crane_tpu_torch.ops import attention as tattn
from crane_tpu_torch.ops import kv_cache as tkv
from crane_tpu_torch.ops import linear as tlinear
from crane_tpu_torch.ops import norm as tnorm
from crane_tpu_torch.ops import rope as trope
from crane_tpu_torch.ops import sampling as tsamp
from crane_tpu_torch.utils.bridge import params_from_jax, tensor_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    x, w = rnd(2, 5, 48, seed=1), rnd(48, seed=2)
    close(tnorm.rms_norm(torch.tensor(x), torch.tensor(w), eps=1e-6, weight_offset=offset),
          jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6, weight_offset=offset))


def test_rope_table():
    tc, ts = trope.rope_table(32, 300, theta=1e6)
    jc, js = jrope.rope_table(32, 300, theta=1e6)
    close(tc, jc, rtol=1e-5, atol=1e-5)
    close(ts, js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,rot", [("half", 32), ("interleaved", 32), ("half", 16)])
def test_apply_rope(mode, rot):
    """Full and partial rotary (the tail dims pass through), both layouts."""
    x = rnd(2, 7, 3, 32, seed=3)
    pos = np.random.default_rng(4).integers(0, 100, (2, 7)).astype(np.int32)
    jc, js = jrope.rope_table(rot, 128)
    tc, ts = trope.rope_table(rot, 128)
    close(trope.apply_rope(torch.tensor(x), tc, ts, torch.tensor(pos), mode=mode),
          jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos), mode=mode))


def test_attention_mask():
    pos = np.array([[3, 4, 5], [0, 1, 2]], np.int32)
    for window in (None, 2):
        t = tattn.attention_mask(torch.tensor(pos), 8, window=window)
        j = jattn.attention_mask(jnp.asarray(pos), 8, window=window)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("window,softcap,extra", [(None, None, False), (4, None, False),
                                                  (None, 20.0, False), (None, None, True)])
def test_gqa_attention(window, softcap, extra):
    B, S, T, Hq, Hkv, D = 2, 5, 12, 4, 2, 16
    q, k, v = rnd(B, S, Hq, D, seed=5), rnd(B, T, Hkv, D, seed=6), rnd(B, T, Hkv, D, seed=7)
    pos = (np.arange(S)[None] + np.array([[3], [6]])).astype(np.int32)
    em = np.random.default_rng(8).random((B, S, S)) > 0.5 if extra else None
    t = tattn.gqa_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(pos),
                            scale=0.25, window=window, logit_softcap=softcap,
                            extra_mask=None if em is None else torch.tensor(em))
    j = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            scale=0.25, window=window, logit_softcap=softcap,
                            extra_mask=None if em is None else jnp.asarray(em))
    close(t, j)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_dense(bias):
    x, w, b = rnd(2, 3, 24, seed=9), rnd(24, 40, seed=10), rnd(40, seed=11)
    close(tlinear.linear(torch.tensor(x), torch.tensor(w), torch.tensor(b) if bias else None),
          jlinear.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None))


def test_linear_quantized_weight_not_ported():
    """A crane_tpu QuantizedWeight crosses the bridge with its int8 codes and
    float32 scales untouched by ``dtype``, and runs through ``linear``."""
    qw = jlinear.quantize_weight(jnp.asarray(rnd(32, 16, seed=12)), bits=8)
    tw = params_from_jax({"w": qw}, dtype=torch.bfloat16)["w"]
    assert isinstance(tw, tlinear.QuantizedWeight) and (tw.block, tw.bits) == (32, 8)
    assert tw.codes.dtype == torch.int8 and tw.scales.dtype == torch.float32
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(qw.codes))
    x = rnd(1, 32, seed=13)
    close(tlinear.linear(torch.tensor(x), tw), jlinear.linear(jnp.asarray(x), qw))


def test_bridge_bf16_is_bit_exact():
    a = jnp.asarray(rnd(5, 7, seed=13), jnp.bfloat16)
    tree = params_from_jax({"layers": ({"w": a, "n": jnp.arange(4)},)})
    t = tree["layers"][0]["w"]
    assert t.dtype == torch.bfloat16 and tree["layers"][0]["n"].dtype == torch.int32
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
    assert params_from_jax({"w": a}, dtype=torch.float32)["w"].dtype == torch.float32
    assert tensor_from_numpy(np.ones(3, np.float32)).dtype == torch.float32


class TestKVCache:
    def _pair(self, B=3, T=16, H=2, D=4):
        return (tkv.LayerKVCache.empty(B, T, H, D, torch.float32),
                jkv.LayerKVCache.empty(B, T, H, D, jnp.float32))

    def test_scalar_start_row_write(self):
        t, j = self._pair()
        kn, vn = rnd(1, 5, 2, 4, seed=14), rnd(1, 5, 2, 4, seed=15)
        t.update(torch.tensor(kn), torch.tensor(vn), 3, row=1)
        j = j.update(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(3, jnp.int32), row=1)
        np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
        np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))

    def test_per_row_write_drops_out_of_range(self):
        """Batched decode: per-row positions, with positions >= max_seq
        (inactive slots) dropped, byte-identical to the reference."""
        t, j = self._pair()
        t.k += 1.5  # stale data that a dropped write must keep
        j = jkv.LayerKVCache(k=j.k + 1.5, v=j.v)
        kn, vn = rnd(3, 1, 2, 4, seed=16), rnd(3, 1, 2, 4, seed=17)
        pos = np.array([0, 16, 9], np.int32)
        t.update(torch.tensor(kn), torch.tensor(vn), torch.tensor(pos))
        j = j.update(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
        np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
        np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))

    def test_write_past_the_buffer_raises(self):
        t, _ = self._pair()
        with pytest.raises(ValueError, match="outside"):
            t.update(torch.zeros(1, 4, 2, 4), torch.zeros(1, 4, 2, 4), 14, row=0)

    def test_row_view_writes_through_and_sizes(self):
        c = tkv.KVCache.empty(2, 3, 16, 2, 4, torch.bfloat16)
        r = c.row(2)
        r.layers[1].update(torch.ones(1, 2, 2, 4), torch.ones(1, 2, 2, 4), 5)
        assert c.layers[1].k[2, 5:7].eq(1).all() and c.layers[1].k[:2].eq(0).all()
        assert c.nbytes() == 2 * 2 * 3 * 16 * 2 * 4 * 2 + 3 * 4
        assert tkv.KVCache.empty(2, 3, 16, 2, 4, torch.bfloat16, "meta").nbytes() == c.nbytes()


class TestSampling:
    V = 300

    def _logits(self, B, seed):
        return rnd(B, self.V, seed=seed, scale=3.0)

    @pytest.mark.parametrize("penalty", [1.0, 1.3])
    def test_greedy_token_exact(self, penalty):
        logits = self._logits(4, 20)
        recent = np.full((4, 8), -1, np.int32)
        recent[:, -3:] = np.argsort(-logits, axis=1)[:, :3]  # penalize the leaders
        tp = tsamp.SamplingParams.make(4, repetition_penalty=penalty, do_sample=False)
        jp = jsamp.SamplingParams.make(4, repetition_penalty=penalty, do_sample=False)
        t = tsamp.sample(torch.tensor(logits), tp, torch.tensor(recent), torch.Generator())
        j = jsamp.sample(jnp.asarray(logits), jp, jnp.asarray(recent), jax.random.PRNGKey(0))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    def test_repetition_penalty_and_recent_ring(self):
        logits = self._logits(2, 21)
        recent = np.array([[-1, 5, 5, 7], [0, 1, -1, 299]], np.int32)
        pen = np.array([1.5, 0.7], np.float32)
        close(tsamp.apply_repetition_penalty(torch.tensor(logits), torch.tensor(recent), torch.tensor(pen)),
              jsamp.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(recent), jnp.asarray(pen)))
        new = np.array([9, 8], np.int32)
        np.testing.assert_array_equal(
            tsamp.update_recent(torch.tensor(recent), torch.tensor(new)).numpy(),
            np.asarray(jsamp.update_recent(jnp.asarray(recent), jnp.asarray(new))))

    def _draws(self, logits, n=200, **kw):
        B = logits.shape[0]
        sp = tsamp.SamplingParams.make(B, **kw)
        g = torch.Generator().manual_seed(0)
        recent = torch.full((B, 4), -1, dtype=torch.int32)
        x = torch.tensor(logits)
        return np.stack([tsamp.sample(x, sp, recent, g).numpy() for _ in range(n)])

    def test_top_k_support(self):
        logits = self._logits(2, 22)
        draws = self._draws(logits, top_k=5, temperature=1.0)
        for b in range(2):
            allowed = set(np.argsort(-logits[b])[:5])
            assert set(draws[:, b]) <= allowed and len(set(draws[:, b])) > 1

    def test_top_p_support_fast_and_exact_paths(self):
        """A peaked row keeps its nucleus inside the top-64 candidates (fast
        path); a flat row's nucleus is wider than the cap (exact path). Both
        must only draw from the sorted top-p prefix."""
        peaked = self._logits(1, 23)[0] * 3
        flat = self._logits(1, 24)[0] * 0.01
        logits = np.stack([peaked, flat])
        draws = self._draws(logits, top_p=0.5, temperature=1.0)
        for b in range(2):
            order = np.argsort(-logits[b], kind="stable")
            p = np.exp(logits[b][order] - logits[b].max())
            p /= p.sum()
            n_keep = int(((np.cumsum(p) - p) < 0.5).sum())
            assert set(draws[:, b]) <= set(order[:n_keep])
        assert len(set(draws[:, 1])) > 20  # the flat row really samples widely

    def test_penalty_moves_mass_off_recent_tokens(self):
        logits = np.full((1, self.V), -10.0, np.float32)
        logits[0, :3] = 4.0
        sp = tsamp.SamplingParams.make(1, repetition_penalty=8.0, temperature=1.0)
        g = torch.Generator().manual_seed(1)
        recent = torch.tensor([[0, 1, -1, -1]], dtype=torch.int32)
        draws = [int(tsamp.sample(torch.tensor(logits), sp, recent, g)[0]) for _ in range(100)]
        assert draws.count(2) > 80  # 0 and 1 are penalized from e^4 to e^0.5

    def test_mixed_batch_greedy_rows_stay_greedy(self):
        logits = self._logits(3, 25)
        sp = tsamp.SamplingParams.make(3, temperature=2.0)
        sp.set_row(1, temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0, do_sample=False)
        g = torch.Generator().manual_seed(2)
        recent = torch.full((3, 4), -1, dtype=torch.int32)
        for _ in range(20):
            out = tsamp.sample(torch.tensor(logits), sp, recent, g)
            assert int(out[1]) == int(logits[1].argmax())
        assert sp.row(1).do_sample.tolist() == [False]
