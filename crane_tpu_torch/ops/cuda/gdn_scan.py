"""K7: the Gated-Delta-Net recurrence as one sequential scan
(``csrc/gdn_scan.cu``).

Port of ``crane_tpu/ops/pallas/gdn_scan.py::gdn_recurrence_pallas``, the
``"pallas"`` route of :func:`crane_tpu_torch.ops.gdn.gdn_recurrence`. As the
JAX wrapper does, :func:`gdn_scan` L2-normalizes q and k, scales q by
``K^-1/2`` and casts q, k, g and beta to float32 before the kernel; v stays
in its dtype, which y takes. On a CUDA tensor it launches the hand-written
kernel or raises; on a CPU tensor it runs :func:`gdn_scan_plain`, the
step-by-step recurrence (``crane_tpu/ops/gdn.py::gdn_recurrence_ref``).
"""

from __future__ import annotations

import torch

from crane_tpu_torch.ops.cuda import build
from crane_tpu_torch.ops.gdn import gdn_recurrence_ref, l2norm

KEY_DIMS = (64, 128, 256)

# the plain version: same contract, same inputs
gdn_scan_plain = gdn_recurrence_ref


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
    if q.device.type == "cpu":
        return gdn_scan_plain(q, k, v, g, beta, init_state)
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
    qn = (l2norm(q) * K ** -0.5).contiguous()
    kn = l2norm(k).contiguous()
    vc = v.contiguous()
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
    err = build.lib().crane_gdn_scan(
        build.dtype_code(vc), qn.data_ptr(), kn.data_ptr(), vc.data_ptr(),
        gf.data_ptr(), bf.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), state.data_ptr(), B, S, H, K, V, build.stream_ptr(q.device),
    )
    build.check_launch("crane_gdn_scan", err)
    gdn_scan.launches += 1
    return y, state


gdn_scan.launches = 0
