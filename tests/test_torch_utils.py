"""crane_tpu_torch's timing, tracing and activation modules against
crane_tpu's, on the CPU.

- ``utils/timing.py``: ``host_sync`` on torch tensors (any shape, bf16 too)
  and on what ``np.asarray`` takes gives crane_tpu's value; ``chain_time``
  runs a step n times and syncs once; ``marginal_rate`` takes the marginal
  time between two chain lengths (a fake clock makes both exact).
- ``utils/tracing.py``: ``span``/``traced`` count calls and host seconds as
  crane_tpu's do, ``enable(False)`` stops the accounting, ``reset`` clears
  it, ``report`` prints crane_tpu's table for the same stats, and the span's
  name appears in a ``torch.profiler`` trace.
- ``ops/activations.py``: ``snake`` (some ``alpha == 0``) and ``atan2`` (all
  four quadrants, the axes and (0, 0)) in float32 and bf16 equal crane_tpu's
  on numpy-seeded inputs: float32 to 1e-6, bf16 to one bf16 rounding
  (2^-8 relative), since both compute in float32 and cast back once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.ops import activations as jact
from crane_tpu.utils import timing as jtiming
from crane_tpu.utils import tracing as jtracing
from crane_tpu_torch.ops import activations as tact
from crane_tpu_torch.utils import timing as ttiming
from crane_tpu_torch.utils import tracing as ttracing
from crane_tpu_torch.utils.bridge import tensor_from_numpy

torch.set_num_threads(2)

# float32 sin/atan2 of two libraries; bf16: one rounding of the same float32
F32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("value", [
    torch.tensor([[2.5, 1.0], [3.0, 4.0]]),
    torch.tensor(7.0, dtype=torch.bfloat16),
    torch.arange(6, dtype=torch.int32).reshape(2, 3)[:, 1:],  # a strided view
    np.array([[1.5, 2.0]]),
    [4.0, 5.0],
    3,
], ids=["f32", "bf16-scalar", "int32-view", "numpy", "list", "int"])
def test_host_sync_matches_crane_tpu(value):
    ref = value.float().numpy() if isinstance(value, torch.Tensor) else value
    assert ttiming.host_sync(value) == jtiming.host_sync(ref)


def test_chain_time_runs_the_step_n_times_and_syncs_once(monkeypatch):
    synced = []
    monkeypatch.setattr(ttiming, "host_sync", lambda x: synced.append(x))
    state = {"n": 0}

    def step():
        state["n"] += 1
        return torch.tensor(state["n"])

    assert ttiming.chain_time(step, 5) >= 0.0
    assert state["n"] == 5 and len(synced) == 1 and int(synced[0]) == 5


@pytest.mark.parametrize("module", [ttiming, jtiming], ids=["port", "crane_tpu"])
def test_marginal_rate_takes_the_marginal_time(monkeypatch, module):
    """Each step advances a fake clock by 2 ms, and each chain's sync by a
    fixed 50 ms: both packages read 500 steps a second."""
    clock = {"t": 0.0}
    monkeypatch.setattr(module.time, "perf_counter", lambda: clock["t"])
    monkeypatch.setattr(module, "host_sync", lambda x: clock.update(t=clock["t"] + 0.05))

    def make_step():
        def step():
            clock["t"] += 0.002
            return np.zeros(1)
        return step

    assert module.marginal_rate(make_step, 4, 14) == pytest.approx(500.0)


@pytest.fixture()
def fresh_tracing():
    for m in (ttracing, jtracing):
        m.reset()
        m.enable(True)
    yield
    for m in (ttracing, jtracing):
        m.reset()
        m.enable(True)


def test_span_and_traced_count_like_crane_tpu(fresh_tracing):
    for m in (ttracing, jtracing):
        @m.traced()
        def work():
            return 1

        @m.traced("named")
        def other():
            return 2

        with m.span("outer"):
            assert work() == 1 and work() == 1
        assert other() == 2
        m.enable(False)
        with m.span("outer"):
            work()
        m.enable(True)
    t, j = ttracing.stats(), jtracing.stats()
    assert {k: v[0] for k, v in t.items()} == {k: v[0] for k, v in j.items()} \
        == {"outer": 1, "work": 2, "named": 1}
    assert all(secs >= 0.0 for _, secs in t.values())
    ttracing.reset()
    assert ttracing.stats() == {}


def test_report_prints_crane_tpus_table(fresh_tracing, monkeypatch):
    """The same stats give the same table (sorted by total time)."""
    fixed = {"decode_step": (8, 0.0123), "prefill": (1, 0.25), "idle": (0, 0.0)}
    for m in (ttracing, jtracing):
        monkeypatch.setattr(m, "stats", lambda: dict(fixed))
    assert ttracing.report() == jtracing.report()
    lines = ttracing.report().splitlines()
    assert lines[0].split() == ["span", "calls", "total", "ms", "mean", "ms"]
    assert [ln.split()[0] for ln in lines[1:]] == ["prefill", "decode_step", "idle"]


def test_span_names_a_range_in_the_profiler_trace(fresh_tracing):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttracing.span("fused_block"):
            torch.ones(4).sum()
    assert "fused_block" in {e.key for e in prof.key_averages()}
    assert ttracing.stats()["fused_block"][0] == 1


def snake_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 8, 40)) * 3).astype(np.float32)
    alpha = np.abs(rng.standard_normal((8, 1))).astype(np.float32) + 0.1
    alpha[[1, 5]] = 0.0  # the identity channels
    return x, alpha


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scalar", [False, True], ids=["per-channel", "scalar"])
def test_snake_matches_crane_tpu(dtype, scalar):
    x, alpha = snake_inputs(0)
    if scalar:
        alpha = np.float32(0.7)
    jx = jnp.asarray(x).astype(dtype)
    tx = tensor_from_numpy(np.asarray(jx))
    got = tact.snake(tx, torch.as_tensor(alpha) if not scalar else float(alpha))
    ref = np.asarray(jact.snake(jx, jnp.asarray(alpha)).astype(jnp.float32))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    if not scalar:  # alpha == 0 is the identity, exactly
        torch.testing.assert_close(got[:, [1, 5]], tx[:, [1, 5]], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_atan2_matches_crane_tpu_in_every_quadrant(dtype):
    rng = np.random.default_rng(1)
    y = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    # the four quadrants' signs, the axes and the origin
    y = np.concatenate([y, [1.0, 1.0, -1.0, -1.0, 0.0, 0.0, 2.0, -2.0, 0.0]]).astype(np.float32)
    x = np.concatenate([x, [1.0, -1.0, -1.0, 1.0, 3.0, -3.0, 0.0, 0.0, 0.0]]).astype(np.float32)
    jy, jx = jnp.asarray(y).astype(dtype), jnp.asarray(x).astype(dtype)
    ty, tx = tensor_from_numpy(np.asarray(jy)), tensor_from_numpy(np.asarray(jx))
    got = tact.atan2(ty, tx)
    ref = np.asarray(jact.atan2(jy, jx).astype(jnp.float32))
    assert got.dtype == ty.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    quadrant = np.sign(got.float().numpy()[-9:-5])
    assert quadrant.tolist() == [1.0, 1.0, -1.0, -1.0]
    assert got[-1].item() == 0.0 and ref[-1] == 0.0
