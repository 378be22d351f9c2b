"""crane_tpu_torch's Gated-DeltaNet modules against crane_tpu's (CPU, f32).

The same numpy-seeded inputs go through both packages: the gated norm, the
GDN ops (l2norm, beta/g, the scan, the chunked form and the dispatcher, the
decode step, the two causal convs), K7's plain version against the Pallas
kernel in interpret mode, ``GdnLayerCache`` and ``gdn_block``. Outputs agree
within rtol/atol 2e-4, the bar of the other port tests; the Pallas kernel is
held to the 1e-4 / 1e-5 that tests/test_gdn.py holds it to.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.models.modules import gdn_layer as jgl
from crane_tpu.ops import gdn as jg
from crane_tpu.ops.kv_cache import GdnLayerCache as JCache
from crane_tpu.ops.norm import gated_rms_norm as j_gated_rms_norm
from crane_tpu.ops.pallas.gdn_scan import gdn_recurrence_pallas
from crane_tpu_torch.models.modules import gdn_layer as tgl
from crane_tpu_torch.ops import cuda as kernels
from crane_tpu_torch.ops import gdn as tg
from crane_tpu_torch.ops.cuda.gdn_scan import gdn_scan, gdn_scan_plain
from crane_tpu_torch.ops.kv_cache import GdnLayerCache as TCache
from crane_tpu_torch.ops.norm import gated_rms_norm

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
PALLAS_TOL = dict(rtol=1e-4, atol=1e-5)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref), **tol)


def inputs(B=2, S=7, H=3, K=8, V=10, seed=0):
    """q, k, v, g <= 0, beta in (0, 1): the recurrence's operands."""
    q, k, v = rnd(B, S, H, K, seed=seed), rnd(B, S, H, K, seed=seed + 1), rnd(B, S, H, V, seed=seed + 2)
    g = -np.abs(rnd(B, S, H, seed=seed + 3)) * 0.5
    beta = 1.0 / (1.0 + np.exp(-rnd(B, S, H, seed=seed + 4)))
    return q, k, v, g, beta.astype(np.float32)


def test_gated_rms_norm_and_beta_g():
    x, z, w = rnd(2, 5, 3, 8, seed=1), rnd(2, 5, 3, 8, seed=2), rnd(8, seed=3)
    close(gated_rms_norm(t(x), t(z), t(w), eps=1e-6),
          j_gated_rms_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), eps=1e-6))
    xb = torch.tensor(x).to(torch.bfloat16)
    assert gated_rms_norm(xb, t(z), t(w)).dtype == torch.bfloat16
    b, a, a_log, dt = rnd(2, 4, 3, seed=4), rnd(2, 4, 3, seed=5), rnd(3, seed=6), rnd(3, seed=7)
    for got, ref in zip(tg.compute_beta_g(t(b), t(a), t(a_log), t(dt)),
                        jg.compute_beta_g(*map(jnp.asarray, (b, a, a_log, dt)))):
        close(got, ref)
    close(tg.l2norm(t(x)), jg.l2norm(jnp.asarray(x)))


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("B,S,H,K,V", [(2, 7, 3, 8, 10), (1, 50, 2, 16, 8)])
def test_recurrences_match_crane_tpu(B, S, H, K, V, init):
    """The scan, the chunked form (S=50 crosses chunks of 16 with a ragged
    tail) and the dispatcher's three routes, against crane_tpu's."""
    q, k, v, g, beta = inputs(B, S, H, K, V, seed=S)
    s0 = rnd(B, H, K, V, seed=9, scale=0.3) if init else None
    jargs = [jnp.asarray(a) for a in (q, k, v, g, beta)] + [None if s0 is None else jnp.asarray(s0)]
    targs = [t(a) for a in (q, k, v, g, beta)] + [None if s0 is None else t(s0)]
    jy, js = jg.gdn_recurrence_ref(*jargs)
    for got in (tg.gdn_recurrence_ref(*targs),
                tg.gdn_recurrence_chunked(*targs, chunk_size=16),
                tg.gdn_recurrence_chunked(*targs),
                *(tg.gdn_recurrence(*targs, backend=b) for b in tg.BACKENDS)):
        close(got[0], jy)
        close(got[1], js)
    jy, js = jg.gdn_recurrence_chunked(*jargs, chunk_size=16)
    y, s = tg.gdn_recurrence_chunked(*targs, chunk_size=16)
    close(y, jy)
    close(s, js)


def test_dispatcher_defaults_and_switches(monkeypatch):
    """On a CPU tensor the default is the chunked form (crane_tpu's
    default); CRANE_GDN_BACKEND names a route, CRANE_GDN_PORTABLE=1 forces
    the scan, and an unknown name raises."""
    calls = []
    for name in ("gdn_recurrence_chunked", "gdn_recurrence_ref"):
        real = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    args = [t(a) for a in inputs(1, 3, 1, 4, 4)]
    monkeypatch.delenv("CRANE_GDN_BACKEND", raising=False)
    monkeypatch.delenv("CRANE_GDN_PORTABLE", raising=False)
    tg.gdn_recurrence(*args)
    monkeypatch.setenv("CRANE_GDN_BACKEND", "scan")
    tg.gdn_recurrence(*args)
    monkeypatch.setenv("CRANE_GDN_BACKEND", "chunked")
    monkeypatch.setenv("CRANE_GDN_PORTABLE", "1")
    tg.gdn_recurrence(*args)
    assert calls == ["gdn_recurrence_chunked", "gdn_recurrence_ref", "gdn_recurrence_ref"]
    with pytest.raises(ValueError, match="unknown GDN backend"):
        tg.gdn_recurrence(*args, backend="triton")


@pytest.mark.parametrize("B,S,H,K,V,chunk,init", [
    (2, 13, 4, 16, 16, 8, False),  # tests/test_gdn.py's case: S not a multiple of the chunk
    (1, 5, 2, 8, 8, 8, True),      # an initial state, the chunk padded past S
    (1, 21, 2, 32, 24, 8, True),   # V unlike K, several chunks
])
def test_k7_plain_matches_pallas(B, S, H, K, V, chunk, init):
    """K7's plain version (the step-by-step scan, what gdn_scan runs on a
    CPU tensor) against crane_tpu's Pallas kernel in interpret mode."""
    q, k, v, g, beta = inputs(B, S, H, K, V, seed=K + S)
    s0 = rnd(B, H, K, V, seed=11, scale=0.3) if init else None
    jy, js = gdn_recurrence_pallas(*map(jnp.asarray, (q, k, v, g, beta)),
                                   None if s0 is None else jnp.asarray(s0),
                                   chunk=chunk, interpret=True)
    targs = [t(a) for a in (q, k, v, g, beta)] + [None if s0 is None else t(s0)]
    kernels.reset_launch_counts()
    for y, s in (gdn_scan_plain(*targs), gdn_scan(*targs)):
        close(y, jy, PALLAS_TOL)
        close(s, js, PALLAS_TOL)
    # a CPU tensor launches neither route
    assert kernels.launch_counts()["gdn_scan[chunk]"] == kernels.launch_counts()["gdn_scan[scan]"] == 0


def test_k7_wrapper_raises_on_a_device_without_kernel():
    q = torch.empty(1, 4, 2, 64, device="meta")
    g = torch.empty(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gdn_scan(q, q, q, g, g)


def test_decode_step_matches_crane_tpu_and_the_scan():
    q, k, v, g, beta = inputs(2, 5, 3, 8, 10, seed=20)
    state = t(rnd(2, 3, 8, 10, seed=21, scale=0.3))
    jstate = jnp.asarray(state.numpy())
    ys = []
    for s in range(5):
        y, state = tg.gdn_decode_step(*(t(a[:, s]) for a in (q, k, v, g, beta)), state)
        jy, jstate = jg.gdn_decode_step(*(jnp.asarray(a[:, s]) for a in (q, k, v, g, beta)), jstate)
        close(y, jy)
        ys.append(y)
    close(state, jstate)
    yr, sr = tg.gdn_recurrence_ref(*map(t, (q, k, v, g, beta)), t(rnd(2, 3, 8, 10, seed=21, scale=0.3)))
    close(torch.stack(ys, 1), yr.numpy())
    close(state, sr.numpy())


@pytest.mark.parametrize("lengths,window", [(None, False), ([3, 9], False), ([2, 6], True),
                                            (None, True)])
def test_causal_conv1d_matches_crane_tpu(lengths, window):
    """The prefill conv with bucket-padded rows (``true_lengths``) and a
    continuation's left context (``init_window``), then decode updates."""
    x, w = rnd(2, 9, 6, seed=30), rnd(6, 4, seed=31)
    iw = rnd(2, 4, 6, seed=32) if window else None
    tl = None if lengths is None else np.asarray(lengths, np.int32)
    jy, js = jg.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              true_lengths=None if tl is None else jnp.asarray(tl),
                              init_window=None if iw is None else jnp.asarray(iw))
    y, s = tg.causal_conv1d(t(x), t(w), true_lengths=None if tl is None else t(tl),
                            init_window=None if iw is None else t(iw))
    close(y, jy)
    close(s, js)
    for step in range(3):
        xn = rnd(2, 6, seed=40 + step)
        jy, js = jg.causal_conv1d_update(jnp.asarray(xn), js, jnp.asarray(w))
        y, s = tg.causal_conv1d_update(t(xn), s, t(w))
        close(y, jy)
        close(s, js)
    short, _ = tg.causal_conv1d(t(x[:, :2]), t(w))
    _, state = tg.causal_conv1d(t(x[:, :2]), t(w))
    assert state.shape == (2, 4, 6) and torch.equal(state[:, :2], torch.zeros(2, 2, 6))
    assert short.shape == (2, 2, 6)


def test_gdn_layer_cache_rows_views_and_bytes():
    """replace_rows for the whole batch, one row and active rows, written
    in place as crane_tpu's returns them; writes through a row() view land
    in the cache; nbytes counts both states; a meta cache allocates
    nothing."""
    B, k, C, H, K, V = 3, 4, 10, 2, 8, 6
    cache = TCache.empty(B, k, C, H, K, V, torch.float32)
    jcache = JCache.empty(B, k, C, H, K, V, jnp.float32)
    conv_buf, rec_buf = cache.conv_state, cache.recurrent_state

    def check():
        close(cache.conv_state, jcache.conv_state)
        close(cache.recurrent_state, jcache.recurrent_state)
        assert cache.conv_state is conv_buf and cache.recurrent_state is rec_buf

    conv, rec = rnd(B, k, C, seed=50), rnd(B, H, K, V, seed=51)
    assert cache.replace_rows(t(conv), t(rec)) is cache
    jcache = jcache.replace_rows(jnp.asarray(conv), jnp.asarray(rec))
    check()
    conv1, rec1 = rnd(1, k, C, seed=52), rnd(1, H, K, V, seed=53)
    cache.replace_rows(t(conv1), t(rec1), row=2)
    jcache = jcache.replace_rows(jnp.asarray(conv1), jnp.asarray(rec1), row=2)
    check()
    conv2, rec2 = rnd(B, k, C, seed=54), rnd(B, H, K, V, seed=55)
    active = np.array([True, False, True])
    cache.replace_rows(t(conv2), t(rec2), active=t(active))
    jcache = jcache.replace_rows(jnp.asarray(conv2), jnp.asarray(rec2), active=jnp.asarray(active))
    check()

    view = cache.row(1)
    view.replace_rows(t(conv1), t(rec1))
    np.testing.assert_array_equal(cache.conv_state[1:2].numpy(), conv1)
    np.testing.assert_array_equal(cache.recurrent_state[1:2].numpy(), rec1)
    close(cache.conv_state[0], jcache.conv_state[0])  # the other rows stay

    assert cache.tensors() == (cache.conv_state, cache.recurrent_state)
    assert cache.nbytes() == 4 * (B * k * C + B * H * K * V)
    bf = TCache.empty(B, k, C, H, K, V, torch.bfloat16, device="meta")
    assert bf.conv_state.is_meta and bf.recurrent_state.dtype == torch.float32
    assert bf.nbytes() == 2 * B * k * C + 4 * B * H * K * V


GCFG = dict(num_v_heads=4, num_k_heads=2, head_k_dim=8, head_v_dim=8)


def _block_params(seed=60, E=32):
    """crane_tpu's layout, as tests/test_gdn.py builds it (v_per_group 2)."""
    g = jgl.GdnConfig(**GCFG)
    r = np.random.default_rng(seed)

    def mk(*s):
        return (r.standard_normal(s) * 0.2).astype(np.float32)

    p = {
        "in_proj_qkvz": mk(E, g.num_k_heads * (2 * g.head_k_dim + 2 * g.v_per_group * g.head_v_dim)),
        "in_proj_ba": mk(E, g.num_k_heads * 2 * g.v_per_group),
        "conv_w": mk(g.conv_dim, g.conv_kernel),
        "A_log": mk(g.num_v_heads),
        "dt_bias": mk(g.num_v_heads),
        "norm": 1.0 + mk(g.head_v_dim),
        "out_proj": mk(g.value_dim, E),
    }
    return g, tgl.GdnConfig(**GCFG), {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: t(v) for k, v in p.items()}


def test_gdn_block_fresh_continuation_decode_and_true_lengths():
    """gdn_block against crane_tpu's on the same weights and cache: a
    bucket-padded fresh prefill of two rows (true lengths 9 and 5 of 12),
    a continuation chunk, then masked decode steps; outputs and both states
    after each."""
    jcfg, tcfg, jp, tp = _block_params()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    B, E = 2, 32
    x = rnd(B, 20, E, seed=61)
    lens = np.array([9, 5], np.int32)
    jc = JCache.empty(B, jcfg.conv_kernel, jcfg.conv_dim, jcfg.num_v_heads, jcfg.head_k_dim,
                      jcfg.head_v_dim, jnp.float32)
    tc = TCache.empty(B, tcfg.conv_kernel, tcfg.conv_dim, tcfg.num_v_heads, tcfg.head_k_dim,
                      tcfg.head_v_dim, torch.float32)

    def both(xs, **kw):
        nonlocal jc
        jy, jc = jgl.gdn_block(jcfg, jp, jnp.asarray(xs), jc,
                               **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                  for k, v in kw.items()})
        ty, tc2 = tgl.gdn_block(tcfg, tp, t(xs), tc,
                                **{k: (t(v) if isinstance(v, np.ndarray) else v)
                                   for k, v in kw.items()})
        assert tc2 is tc
        close(ty, jy)
        close(tc.conv_state, jc.conv_state)
        close(tc.recurrent_state, jc.recurrent_state)
        return ty

    both(x[:, :12], true_lengths=lens)
    both(x[:, 12:16], continuation=True)
    for s in (16, 17):
        both(x[:, s:s + 1], decode=True, active=np.array([True, s == 16]))

    # the padded rows' states are those of the unpadded prompts
    for b, n in enumerate(lens):
        ref = TCache.empty(1, tcfg.conv_kernel, tcfg.conv_dim, tcfg.num_v_heads,
                           tcfg.head_k_dim, tcfg.head_v_dim, torch.float32)
        tgl.gdn_block(tcfg, tp, t(x[b:b + 1, :n]), ref)
        padded = TCache.empty(2, tcfg.conv_kernel, tcfg.conv_dim, tcfg.num_v_heads,
                              tcfg.head_k_dim, tcfg.head_v_dim, torch.float32)
        tgl.gdn_block(tcfg, tp, t(x[:, :12]), padded, true_lengths=t(lens))
        close(padded.recurrent_state[b:b + 1], ref.recurrent_state.numpy())
        close(padded.conv_state[b:b + 1], ref.conv_state.numpy())


def test_gdn_block_slot_prefill_and_contract_errors():
    """A fresh prefill into one row of a multi-row cache touches no other
    row; the continuation contract's ValueErrors are crane_tpu's."""
    _, tcfg, _, tp = _block_params()
    cache = TCache.empty(3, tcfg.conv_kernel, tcfg.conv_dim, tcfg.num_v_heads, tcfg.head_k_dim,
                         tcfg.head_v_dim, torch.float32)
    tgl.gdn_block(tcfg, tp, t(rnd(1, 6, 32, seed=70)), cache, cache_row=1)
    assert cache.recurrent_state[[0, 2]].abs().sum() == 0 and cache.recurrent_state[1].abs().sum() > 0
    with pytest.raises(ValueError):
        tgl.gdn_block(tcfg, tp, t(rnd(1, 1, 32, seed=71)), cache.row(0), decode=True,
                      continuation=True)
    with pytest.raises(ValueError):
        tgl.gdn_block(tcfg, tp, t(rnd(1, 4, 32, seed=72)), cache, cache_row=0, continuation=True)
    with pytest.raises(ValueError):
        tgl.gdn_block(tcfg, tp, t(rnd(1, 1, 32, seed=73)), cache, decode=True, cache_row=0)


def test_split_qkvz_ba_matches_crane_tpu():
    jcfg, tcfg, _, _ = _block_params()
    qkvz, ba = rnd(2, 3, 2 * (16 + 32), seed=80), rnd(2, 3, 8, seed=81)
    for got, ref in zip(tgl.split_qkvz_ba(tcfg, t(qkvz), t(ba)),
                        jgl.split_qkvz_ba(jcfg, jnp.asarray(qkvz), jnp.asarray(ba))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

