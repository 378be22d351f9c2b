"""Gated Delta Net (GDN) linear-attention recurrence (port of
``crane_tpu/ops/gdn.py``).

Per timestep ``S = S*exp(g); kv = S^T k; delta = (v - kv)*beta;
S += k (x) delta; y = S^T q`` with a float32 state ``[B, H_v, K, V]``,
L2-normalized q/k, a ``1/sqrt(K)`` query scale, ``beta = sigmoid(b)`` and
``g = -exp(A_log)*softplus(a + dt_bias)``, plus a depthwise causal conv
(k=4, silu) over the ``[Q|K|V]`` channels with a rolling conv state for
decode. Numerics follow HF transformers' ``torch_recurrent_gated_delta_rule``,
as the reference's do.

:func:`gdn_recurrence` dispatches between three routes, as in the reference:

- ``"pallas"``: K7, the hand-written CUDA kernels
  (:func:`~crane_tpu_torch.ops.cuda.gdn_scan.gdn_scan`: the chunkwise
  kernels on the tensor cores from 128 steps, the sequential scan below),
  the default on a CUDA tensor;
- ``"chunked"``: :func:`gdn_recurrence_chunked`, plain matmuls, the default
  on a CPU tensor (the reference's default on every device);
- ``"scan"``: :func:`gdn_recurrence_ref`, the step-by-step reference.

``CRANE_GDN_BACKEND`` names a route; ``CRANE_GDN_PORTABLE=1`` forces the
scan. The decode step stays plain PyTorch, as in the reference.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FLA-style L2 normalization over the last axis, in float32."""
    xf = x.float()
    return xf * torch.rsqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + eps)


def compute_beta_g(b: torch.Tensor, a: torch.Tensor, a_log: torch.Tensor,
                   dt_bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``beta = sigmoid(b)``; ``g = -exp(A_log) * softplus(a + dt_bias)``,
    in float32."""
    beta = torch.sigmoid(b.float())
    g = -torch.exp(a_log.float()) * F.softplus(a.float() + dt_bias.float())
    return beta, g


def gdn_recurrence_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    beta: torch.Tensor,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step recurrence (the portable path, and K7's plain
    version).

    q, k ``[B, S, H, K]`` (already head-expanded); v ``[B, S, H, V]``;
    g, beta ``[B, S, H]``; init_state ``[B, H, K, V]`` float32 or None.
    L2-norm, the float32 cast and the ``1/sqrt(K)`` scale happen inside.
    Returns (y ``[B, S, H, V]`` in v's dtype, final state float32)."""
    out_dtype = v.dtype
    B, S, H, K = q.shape
    V = v.shape[-1]
    q = l2norm(q) * K ** -0.5
    k = l2norm(k)
    vf, gf, bf = v.float(), g.float(), beta.float()
    state = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        state = state * torch.exp(gf[:, t])[..., None, None]
        kv = torch.einsum("bhk,bhkv->bhv", k[:, t], state)
        delta = (vf[:, t] - kv) * bf[:, t, :, None]
        state = state + torch.einsum("bhk,bhv->bhkv", k[:, t], delta)
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros((B, 0, H, V))
    return y.to(out_dtype), state


def gdn_recurrence_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    beta: torch.Tensor,
    init_state: torch.Tensor | None = None,
    *,
    chunk_size: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked (parallel) gated delta rule, mathematically identical to
    the recurrence (HF ``torch_chunk_gated_delta_rule`` semantics): inside
    a chunk the sequential dependency is folded into the inverse of a
    unit-lower-triangular matrix, computed in log2(chunk) doubling steps
    ``(I-A)^-1 = prod_i (I + A^(2^i))``; only the state carry across chunks
    is sequential. Same contract as :func:`gdn_recurrence_ref`."""
    out_dtype = v.dtype
    B, S, H, K = q.shape
    V = v.shape[-1]
    n = min(chunk_size, max(S, 1))

    q = l2norm(q) * K ** -0.5
    k = l2norm(k)
    v, g, beta = v.float(), g.float(), beta.float()

    pad = (-S) % n
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        g, beta = (F.pad(x, (0, 0, 0, pad)) for x in (g, beta))
    C = (S + pad) // n

    def chunks(x):  # [B, S, H, X] -> [B, H, C, n, X]
        return x.transpose(1, 2).reshape(B, H, C, n, x.shape[-1])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    gc = g.transpose(1, 2).reshape(B, H, C, n)
    bc = beta.transpose(1, 2).reshape(B, H, C, n)

    v_beta = vc * bc[..., None]
    k_beta = kc * bc[..., None]

    gcum = torch.cumsum(gc, dim=-1)
    dd = gcum[..., :, None] - gcum[..., None, :]
    tril = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
    stril = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device), -1)
    decay_mask = torch.where(tril, torch.exp(torch.where(tril, dd, 0.0)), 0.0)

    A = -(k_beta @ kc.transpose(-1, -2)) * decay_mask
    A = torch.where(stril, A, 0.0)
    T = torch.eye(n, dtype=torch.float32, device=q.device) + A
    P = A
    steps = max(int(math.ceil(math.log2(n))), 1) if n > 1 else 0
    for _ in range(steps - 1):
        P = P @ P
        T = T + P @ T

    value_t = T @ v_beta
    k_cumdecay = T @ (k_beta * torch.exp(gcum)[..., None])

    state = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
             if init_state is None else init_state.float())
    outs = []
    for i in range(C):
        q_i, k_i, g_i = qc[:, :, i], kc[:, :, i], gcum[:, :, i]
        attn = torch.where(tril, (q_i @ k_i.transpose(-1, -2)) * decay_mask[:, :, i], 0.0)
        v_new = value_t[:, :, i] - k_cumdecay[:, :, i] @ state
        attn_inter = (q_i * torch.exp(g_i)[..., None]) @ state
        outs.append(attn_inter + attn @ v_new)
        g_last = g_i[..., -1]
        decay_k = torch.exp(g_last[..., None] - g_i)[..., None]
        state = (state * torch.exp(g_last)[..., None, None]
                 + (k_i * decay_k).transpose(-1, -2) @ v_new)
    y = torch.stack(outs, dim=2).reshape(B, H, C * n, V)[:, :, :S].transpose(1, 2)
    return y.to(out_dtype), state


BACKENDS = ("chunked", "pallas", "scan")


def gdn_recurrence(q, k, v, g, beta, init_state=None, *, backend: str | None = None):
    """Dispatch between K7 (``"pallas"``), the chunked matmul form and the
    step-by-step scan. ``backend=None`` reads ``CRANE_GDN_PORTABLE=1``
    (the scan), then ``CRANE_GDN_BACKEND``, then the device's default: K7
    on a CUDA tensor, the chunked form elsewhere."""
    if backend is None:
        if os.environ.get("CRANE_GDN_PORTABLE") == "1":
            backend = "scan"
        else:
            backend = os.environ.get(
                "CRANE_GDN_BACKEND", "pallas" if q.device.type == "cuda" else "chunked")
    if backend == "chunked":
        return gdn_recurrence_chunked(q, k, v, g, beta, init_state)
    if backend == "pallas":
        from crane_tpu_torch.ops.cuda.gdn_scan import gdn_scan

        return gdn_scan(q, k, v, g, beta, init_state)
    if backend == "scan":
        return gdn_recurrence_ref(q, k, v, g, beta, init_state)
    raise ValueError(f"unknown GDN backend {backend!r}, expected one of {BACKENDS}")


def gdn_decode_step(q, k, v, g, beta, state) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence (decode), plain PyTorch.

    q, k ``[B, H, K]``; v ``[B, H, V]``; g, beta ``[B, H]``; state
    ``[B, H, K, V]`` float32. Returns (y ``[B, H, V]`` in v's dtype, new
    state)."""
    out_dtype = v.dtype
    K = q.shape[-1]
    q = l2norm(q) * K ** -0.5
    k = l2norm(k)
    state = state * torch.exp(g.float())[..., None, None]
    kv = torch.einsum("bhk,bhkv->bhv", k, state)
    delta = (v.float() - kv) * beta.float()[..., None]
    state = state + torch.einsum("bhk,bhv->bhkv", k, delta)
    y = torch.einsum("bhk,bhkv->bhv", q, state)
    return y.to(out_dtype), state


def causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    activation: bool = True,
    true_lengths: torch.Tensor | None = None,
    init_window: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time: x ``[B, S, C]``, w ``[C, k]``
    (``w[:, 0]`` the oldest tap). Returns (y ``[B, S, C]``, conv_state
    ``[B, k, C]`` holding the last k pre-activation inputs).

    ``true_lengths [B]``: bucket-padded prefill; the saved state is the
    window ending at each row's true length, not at the padded tail.
    ``init_window [B, k, C]``: a saved conv_state whose last k-1 inputs form
    the left context (a continuation chunk re-enters it instead of padding
    with zeros, so chunked prefill matches whole prefill)."""
    B, S, C = x.shape
    ksz = w.shape[-1]
    if init_window is None:
        xp = F.pad(x, (0, 0, ksz - 1, 0))
    else:
        xp = torch.cat([init_window[:, 1:].to(x.dtype), x], dim=1)
    wf = w.float()
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for j in range(ksz):
        y = y + xp[:, j:j + S].float() * wf[:, j]
    if activation:
        y = F.silu(y)
    y = y.to(x.dtype)
    if true_lengths is None:
        state = xp[:, S - 1:S - 1 + ksz]  # the last k inputs, zero-padded when S < k
    else:
        idx = true_lengths.to(torch.long)[:, None] - 1 + torch.arange(ksz, device=x.device)
        state = torch.gather(xp, 1, idx[:, :, None].expand(B, ksz, C))
    return y, state


def causal_conv1d_update(x_new: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                         *, activation: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-step conv: x_new ``[B, C]``, conv_state ``[B, k, C]``. Rolls
    the state and applies the depthwise kernel at the newest position."""
    new_state = torch.cat([conv_state[:, 1:], x_new[:, None]], dim=1)
    y = torch.einsum("bkc,ck->bc", new_state.float(), w.float())
    if activation:
        y = F.silu(y)
    return y.to(x_new.dtype), new_state
