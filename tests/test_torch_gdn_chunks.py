"""A CPU rehearsal of K7's chunkwise route (``crane_tpu_torch/csrc/gdn_chunk.cu``).

The kernels cannot run here, so their arithmetic is emulated in a few lines
of PyTorch, in their order: per chunk of 64 timesteps the prefix sum gc of
g, ``A = strict_lower(-(beta k) k^T o Gamma)``, ``T = (I - A)^-1`` by 16 x 16
diagonal blocks (forward substitution) and block products, W, U, P, QG, KDT
and the decay; then the state pass in chunk order, ``Vn = U - W S``,
``y = QG S + P Vn``, ``S = decay S + KDT Vn``. Every matrix product is
rounded as the tensor cores' 3xTF32 form rounds it: each float32 operand
split into a TF32 hi part and a TF32 lo part (round to nearest, ties away,
as ``cvt.rna.tf32.f32``), ``lo.hi + hi.lo + hi.hi`` summed in float32.

The emulation is held to chip_smoke.py's tolerances (y to the kernel bound
``build.KERNEL_ATOL``/``KERNEL_RTOL`` in bf16 and to the card tests' float32
bound in float32; the state to ``STATE_ATOL + STATE_RTOL |ref|``) against the
plain scan and crane_tpu's ``gdn_recurrence_pallas`` in interpret mode: S
across chunk edges, K 64/128/256 and V 40, two rows with and without an
initial state, pad runs of g = 0, beta = 0 across a chunk boundary, g down
to -40, and beta = 1 with correlated keys, where T's entries grow and one
TF32 pass misses the state bound. The route choice (S0) is held over the
served shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_tpu.ops.pallas.gdn_scan import gdn_recurrence_pallas
from crane_tpu_torch.ops.cuda.build import KERNEL_ATOL, KERNEL_RTOL
from crane_tpu_torch.ops.cuda.gdn_scan import (
    CHUNK,
    CHUNK_MIN_S,
    chunk_scratch_floats,
    gdn_route,
    gdn_scan_plain,
)
from crane_tpu_torch.ops.gdn import l2norm
from crane_tpu_torch.utils.buckets import bucket_length

torch.set_num_threads(2)

# chip_smoke.py's state tolerance, and the card tests' float32 bound for y
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), round to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32 on the tensor cores: small products first."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def invert_unit_lower(A: torch.Tensor) -> torch.Tensor:
    """(I - A)^-1 for strictly lower A [..., 64, 64] as the kernel takes it:
    the 16 x 16 diagonal blocks by forward substitution, then block row by
    block row T_ij = T_ii sum_{l=j}^{i-1} A_il T_lj, float32."""
    T = torch.zeros_like(A)
    for d in range(4):
        s = slice(16 * d, 16 * d + 16)
        blk = torch.zeros_like(A[..., s, s])
        for i in range(16):
            row = torch.zeros_like(blk[..., i, :])
            row[..., i] = 1.0
            blk[..., i, :] = row + (A[..., s, s][..., i, :i, None] * blk[..., :i, :]).sum(-2)
        T[..., s, s] = blk
    for bi in range(1, 4):
        ri = slice(16 * bi, 16 * bi + 16)
        M = [sum(A[..., ri, 16 * bl:16 * bl + 16] @ T[..., 16 * bl:16 * bl + 16, 16 * bj:16 * bj + 16]
                 for bl in range(bj, bi)) for bj in range(bi)]
        for bj in range(bi):
            T[..., ri, 16 * bj:16 * bj + 16] = T[..., ri, ri] @ M[bj]
    return T


def emulate_chunks(q, k, v, g, beta, init_state=None, mm=mm3):
    """The chunk preparation and the state pass on the CPU, with the
    kernels' products rounded by ``mm``. Same contract as gdn_scan."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    n = -(-S // CHUNK)
    pad = n * CHUNK - S

    def chunks(x):  # [B, S, H, X] -> [B, H, n, C, X], zero rows past S
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.transpose(1, 2).reshape(B, H, n, CHUNK, x.shape[-1])

    qc, kc, vc = chunks(l2norm(q) * K ** -0.5), chunks(l2norm(k)), chunks(v)
    gc = chunks(g[..., None])[..., 0].cumsum(-1)
    bc = chunks(beta[..., None])[..., 0]
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    diff = torch.where(lower, gc[..., :, None] - gc[..., None, :], 0.0)
    gamma = torch.where(lower, torch.exp(diff), 0.0)
    kk = mm(kc, kc.transpose(-1, -2))
    A = torch.where(lower.tril(-1), -bc[..., :, None] * kk * gamma, 0.0)
    T = invert_unit_lower(A)
    W = mm(T, kc * (bc * torch.exp(gc))[..., None])
    U = mm(T, vc * bc[..., None])
    P = mm(qc, kc.transpose(-1, -2)) * gamma
    QG = qc * torch.exp(gc)[..., None]
    KDT = (kc * torch.exp(gc[..., -1:] - gc)[..., None]).transpose(-1, -2)
    decay = torch.exp(gc[..., -1])

    state = (torch.zeros(B, H, K, V) if init_state is None else init_state.float().clone())
    ys = []
    for c in range(n):
        vn = U[:, :, c] - mm(W[:, :, c], state)
        ys.append(mm(QG[:, :, c], state) + mm(P[:, :, c], vn))
        state = decay[:, :, c, None, None] * state + mm(KDT[:, :, c], vn)
    y = torch.stack(ys, 2).reshape(B, H, n * CHUNK, V)[:, :, :S].transpose(1, 2)
    return y.to(v.dtype), state


def make_inputs(B, S, H, K, V, seed, *, g_min=-0.5, beta_one=False, correlated=False,
                pad_run=None, dtype=torch.float32):
    """q, k, v, g in [g_min, 0], beta in (0, 1) from a numpy seed; beta = 1
    and keys that share most of one direction on request; ``pad_run``
    (lo, hi) sets g = 0 and beta = 0 on those timesteps."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, K)).astype(np.float32)
    k = rng.standard_normal((B, S, H, K)).astype(np.float32)
    if correlated:
        k = 4.0 * rng.standard_normal((1, 1, H, K)).astype(np.float32) + 0.3 * k
    v = rng.standard_normal((B, S, H, V)).astype(np.float32)
    g = (rng.random((B, S, H)) * g_min).astype(np.float32)
    beta = np.ones((B, S, H), np.float32) if beta_one else rng.random((B, S, H)).astype(np.float32)
    if pad_run is not None:
        g[:, pad_run[0]:pad_run[1]] = 0.0
        beta[:, pad_run[0]:pad_run[1]] = 0.0
    s0 = (0.3 * rng.standard_normal((B, H, K, V))).astype(np.float32)
    ts = [torch.tensor(x) for x in (q, k, v, g, beta)]
    ts[2] = ts[2].to(dtype)
    return ts, torch.tensor(s0), (q, k, v, g, beta, s0)


def check(got, ref, y_tol):
    (y, s), (yr, sr) = got, ref
    torch.testing.assert_close(y.float(), yr.float(), **y_tol)
    torch.testing.assert_close(s, sr, **STATE_TOL)


CASES = {
    # id: (B, S, H, K, V, options)
    "S1": (1, 1, 2, 128, 128, {}),
    "S63": (1, 63, 2, 128, 128, {}),
    "S64": (1, 64, 2, 128, 128, {}),
    "S65": (1, 65, 2, 128, 128, {}),
    "S130_K64_V40": (2, 130, 2, 64, 40, {}),
    "S130_K256": (1, 130, 1, 256, 64, {}),
    "S1000": (1, 1000, 2, 128, 128, {}),
    "pad_run_across_chunks": (2, 200, 2, 64, 40, {"pad_run": (50, 140)}),
    "g_down_to_-40": (1, 300, 2, 128, 128, {"g_min": -40.0}),
    "beta1_correlated_keys": (1, 300, 2, 128, 128, {"beta_one": True, "correlated": True}),
}


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_chunks_match_scan_and_pallas(case, init):
    """The emulated kernels against the plain scan and the Pallas kernel in
    interpret mode, in float32, at chip_smoke's tolerances."""
    B, S, H, K, V, opts = CASES[case]
    targs, s0, nargs = make_inputs(B, S, H, K, V, seed=S + K, **opts)
    init_state = s0 if init else None
    got = emulate_chunks(*targs, init_state)
    check(got, gdn_scan_plain(*targs, init_state), F32_TOL)
    jy, js = gdn_recurrence_pallas(*map(jnp.asarray, nargs[:5]),
                                   jnp.asarray(nargs[5]) if init else None,
                                   chunk=256, interpret=True)
    check(got, (torch.tensor(np.asarray(jy)), torch.tensor(np.asarray(js))), F32_TOL)


@pytest.mark.parametrize("case", ["S65", "S130_K64_V40", "beta1_correlated_keys"])
def test_emulated_chunks_bf16_v(case):
    """bf16 v (the served dtype): y rounds to bf16 once, within the kernel
    bound of the plain scan's bf16 y; the state stays float32."""
    B, S, H, K, V, opts = CASES[case]
    targs, s0, _ = make_inputs(B, S, H, K, V, seed=S, dtype=torch.bfloat16, **opts)
    got = emulate_chunks(*targs, s0)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    check(got, gdn_scan_plain(*targs, s0), BF16_TOL)


def test_one_tf32_pass_misses_the_state_bound():
    """Why 3xTF32: with beta = 1 and correlated keys, T's entries grow, and
    products taken in one TF32 pass leave the state outside chip_smoke's
    bound, where the 3xTF32 form sits well inside it."""
    B, S, H, K, V, opts = CASES["beta1_correlated_keys"]
    targs, s0, _ = make_inputs(B, S, H, K, V, seed=S + K, **opts)
    _, sr = gdn_scan_plain(*targs, s0)
    bound = STATE_TOL["atol"] + STATE_TOL["rtol"] * sr.abs()
    worst = {name: ((emulate_chunks(*targs, s0, mm=mm)[1] - sr).abs() / bound).max().item()
             for name, mm in (("3xtf32", mm3), ("1xtf32", mm1))}
    assert worst["3xtf32"] < 0.5 and worst["1xtf32"] > 1.0, worst


def test_block_inverse_is_the_inverse():
    """The kernel's blocked (I - A)^-1 against torch's triangular solve."""
    A = torch.randn(3, 64, 64).tril(-1) * 0.2
    eye = torch.eye(64).expand(3, 64, 64)
    ref = torch.linalg.solve_triangular(eye - A, eye, upper=False)
    torch.testing.assert_close(invert_unit_lower(A), ref, rtol=1e-5, atol=1e-5)


def test_route_choice_over_served_shapes():
    """S0: the prefill buckets of the served models (powers of two from 64)
    and the engine's 256-token chunks take the chunkwise route from 128 on
    (a 120-token prompt's 128, the 300-token prompt's 512, the 1000-token
    prompt's chunks); the 64-token bucket (a 17- or 64-token prompt) keeps
    the sequential scan, which the A/B found faster there."""
    assert CHUNK_MIN_S == 128 and CHUNK_MIN_S % CHUNK == 0
    for n, route in ((1, "scan"), (17, "scan"), (64, "scan"), (65, "chunk"), (120, "chunk"),
                     (129, "chunk"), (256, "chunk"), (300, "chunk"), (1000, "chunk"),
                     (2048, "chunk"), (5000, "chunk")):
        assert gdn_route(bucket_length(n, floor=64)) == route, n
    assert gdn_route(256) == "chunk"  # an engine chunk
    assert all(gdn_route(S) == "scan" for S in range(1, CHUNK_MIN_S))


def test_chunk_scratch_size():
    """The scratch the wrapper allocates: W, QG, KDT, P, U and a decay per
    chunk of every (b, h); about 36 MB at B=1, S=1000, H=16, K=V=128."""
    assert chunk_scratch_floats(1, 1, 1, 64, 40) == 3 * 64 * 64 + 64 * 64 + 64 * 64 + 1
    assert chunk_scratch_floats(2, 65, 3, 128, 128) == 2 * 3 * 2 * (3 * 64 * 128 + 64 * 64
                                                                    + 64 * 128 + 1)
    assert 35e6 < 4 * chunk_scratch_floats(1, 1000, 16, 128, 128) < 38e6
