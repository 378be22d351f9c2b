"""K7: the Gated-Delta-Net recurrence, routed by length between two
hand-written kernels.

Port of ``crane_tpu/ops/pallas/gdn_scan.py::gdn_recurrence_pallas``, the
``"pallas"`` route of :func:`crane_tpu_torch.ops.gdn.gdn_recurrence`. As the
JAX wrapper does before its kernel, both kernels L2-normalize q and k and
scale q by ``K^-1/2`` (in float32, from q and k in v's dtype); g and beta
go in as float32, and v stays in its dtype, which y takes. On a CUDA tensor it launches a kernel or
raises; on a CPU tensor it runs :func:`gdn_scan_plain`, the step-by-step
recurrence (``crane_tpu/ops/gdn.py::gdn_recurrence_ref``).

Two routes, chosen by the sequence length alone (:func:`gdn_route`):

- ``"chunk"`` (S >= :data:`CHUNK_MIN_S`): ``csrc/gdn_chunk.cu``, the
  chunkwise form on the tensor cores, a chunk preparation kernel and a
  state pass over float32 scratch this wrapper allocates (one call, two
  launches, one count);
- ``"scan"`` (shorter calls): ``csrc/gdn_scan.cu``, one sequential scan,
  which pays no chunk's padding or second launch.

Launches are counted per route: ``gdn_scan.launches["chunk"]``, ``["scan"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.gdn import gdn_recurrence_ref

KEY_DIMS = (64, 128, 256)
# timesteps a chunk of the chunkwise kernels (kC in csrc/gdn_chunk.cu)
CHUNK = 64
# the shortest sequence the chunkwise route takes (S0): in the same-call A/B
# of ``ab.py --only gdn`` (H=16, K=V=128, bf16) the sequential scan is
# faster up to S=65 at B=1 and the chunkwise route from S=128 at B=1 and 8
CHUNK_MIN_S = 128
ROUTES = ("chunk", "scan")
INFO_KEYS = ("registers", "local_bytes", "smem_bytes", "threads")

# the plain version: same contract, same inputs
gdn_scan_plain = gdn_recurrence_ref


def gdn_route(S: int) -> str:
    """The kernel a call of ``S`` timesteps launches."""
    return "chunk" if S >= CHUNK_MIN_S else "scan"


def chunk_scratch_floats(B: int, S: int, H: int, K: int, V: int) -> int:
    """Float32 scratch of the chunkwise route: per chunk of every (b, h),
    W and QG (CHUNK x K each), KDT (K x CHUNK), P (CHUNK x CHUNK), U (CHUNK
    x V rounded up to 64) and one decay (``crane_gdn_chunk`` refuses less)."""
    n_chunks = B * H * -(-S // CHUNK)
    return n_chunks * (3 * CHUNK * K + CHUNK * CHUNK + CHUNK * -(-V // 64) * 64 + 1)


def gdn_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    beta: torch.Tensor,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k ``[B, S, H, K]``; v ``[B, S, H, V]`` (float32 or bf16); g, beta
    ``[B, S, H]``; init_state ``[B, H, K, V]`` or None (zeros). Returns
    (y ``[B, S, H, V]`` in v's dtype, final state ``[B, H, K, V]``
    float32)."""
    build.refuse_grad("gdn_scan", q, k, v, g, beta, init_state)
    if q.device.type == "cpu":
        return gdn_scan_plain(q, k, v, g, beta, init_state)
    return gdn_scan_route(gdn_route(q.shape[1]), q, k, v, g, beta, init_state)


def gdn_scan_route(route, q, k, v, g, beta, init_state=None):
    """:func:`gdn_scan` on the card through the named route's kernel,
    whatever S is (the wrapper names :func:`gdn_route`'s; a comparison may
    name the other). Counts the launch."""
    build.refuse_grad("gdn_scan_route", q, k, v, g, beta, init_state)
    if route not in ROUTES:
        raise ValueError(f"gdn_scan: route must be one of {ROUTES}, got {route!r}")
    if q.device.type != "cuda":
        raise ValueError(f"gdn_scan: no kernel for {q.device}")
    B, S, H, K = q.shape
    V = v.shape[-1]
    if K not in KEY_DIMS:
        raise ValueError(f"gdn_scan: key head dim must be in {KEY_DIMS}, got {K}")
    if k.shape != q.shape or v.shape != (B, S, H, V):
        raise ValueError(f"gdn_scan: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if g.shape != (B, S, H) or beta.shape != (B, S, H):
        raise ValueError(f"gdn_scan: g/beta {tuple(g.shape)}/{tuple(beta.shape)}, want {(B, S, H)}")
    if S == 0:  # no chunk to take: the scan kernel copies the state
        route = "scan"
    vc = v.contiguous()
    qn, kn = (_aligned(x.to(vc.dtype)) for x in (q, k))  # the kernels normalize them
    gf, bf = g.float().contiguous(), beta.float().contiguous()
    tensors = [qn, kn, vc, gf, bf]
    if init_state is not None:
        if init_state.shape != (B, H, K, V):
            raise ValueError(f"gdn_scan: init_state {tuple(init_state.shape)}, want {(B, H, K, V)}")
        init_state = init_state.float().contiguous()
        tensors.append(init_state)
    build.require_cuda("gdn_scan", *tensors)
    y = torch.empty_like(vc)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    head = (build.dtype_code(vc), qn.data_ptr(), kn.data_ptr(), vc.data_ptr(), gf.data_ptr(),
            bf.data_ptr(), init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), state.data_ptr())
    if route == "chunk":
        n = chunk_scratch_floats(B, S, H, K, V)
        scratch = torch.empty(n, dtype=torch.float32, device=q.device)
        err = build.lib().crane_gdn_chunk(*head, scratch.data_ptr(), n, B, S, H, K, V,
                                          build.stream_ptr(q.device))
        build.check_launch("crane_gdn_chunk", err)
    else:
        err = build.lib().crane_gdn_scan(*head, B, S, H, K, V, build.stream_ptr(q.device))
        build.check_launch("crane_gdn_scan", err)
    gdn_scan.launches[route] += 1
    return y, state


gdn_scan.launches = {r: 0 for r in ROUTES}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernels read q and k rows 8 or
    16 bytes at a time)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.cache
def chunk_kernel_info(dtype: torch.dtype, K: int) -> dict[str, dict[str, int]]:
    """The compiled form of the chunkwise route at v's ``dtype`` and K:
    ``{"prep": {...}, "state16": {...}, "state32": {...}}`` with INFO_KEYS
    each, the state pass at 16 and 32 columns a block (no ``"state32"`` at
    K = 256)."""
    info = (ctypes.c_int * 12)(*([-1] * 12))
    build.check_launch("crane_gdn_chunk_info",
                       build.lib().crane_gdn_chunk_info(build.DTYPE_CODES[dtype], K, info))
    out = {"prep": dict(zip(INFO_KEYS, info[0:4])), "state16": dict(zip(INFO_KEYS, info[4:8]))}
    if info[8] >= 0:
        out["state32"] = dict(zip(INFO_KEYS, info[8:12]))
    return out
