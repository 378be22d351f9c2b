"""K2, K3 and K3-S: causal GQA flash attention for prefill
(``csrc/flash_attention.cu``).

Port of ``crane_tpu/ops/pallas/flash_attention.py``:

- :func:`flash_attention_causal` (K2): a fresh prompt, positions 0..S-1,
  with optional sliding ``window``, ``softcap`` and ``segments``.
- :func:`flash_attention_cached` (K3): a continuation chunk at absolute
  ``positions`` over the whole cache buffer ``[B, T, Hkv, D]`` read as
  stored, or with ``kv_rows`` over the rows it names of a buffer of any
  number of rows (a batch-1 chunk over a slot chosen on the device, as a
  CUDA graph replays it). It also stands for
  ``quant_cached_attention(bits=16)``, which computes the same function over
  the same layout.
- :func:`flash_attention_cached_with_stats` (K3-S, the same launch with
  stats pointers): K3 that also returns each query row's softmax max and sum,
  ``cached_attention_with_stats(bits=16)``, for the sequence-parallel merge
  of slabs; positions may be negative there (the row attends nothing).

On a CUDA tensor each wrapper launches the hand-written kernel or raises;
on a CPU tensor it runs its ``*_plain`` counterpart, the same function in
plain PyTorch. The kernel is chosen by dtype: bfloat16 runs the tensor-core
kernel (``csrc/flash_attention_mma.cu``), float32 the CUDA-core kernel
(``csrc/flash_attention.cu``), which keeps full float32 arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from crane_tpu_torch.ops.attention import masked_attention, masked_attention_with_stats
from crane_tpu_torch.ops.cuda import build

HEAD_DIMS = (64, 128, 256)


def flash_attention_causal_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor | None = None,
    *,
    scale: float,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]`` at positions 0..S-1.
    Key j attends query i iff ``j <= i`` (and ``j > i - window``), or,
    with ``segments [B, S]``, iff both carry the same positive id.
    Returns ``[B, S, Hq, D]`` in q's dtype."""
    B, S = q.shape[0], q.shape[1]
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask = mask & (i[None, :] > i[:, None] - window)
    mask = mask[None].expand(B, S, S)
    if segments is not None:
        seg = segments.to(torch.int64)
        mask = mask | ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))
    return masked_attention(q, k, v, mask, scale=scale, logit_softcap=softcap)


def flash_attention_cached_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
    softcap: float | None = None,
    kv_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """q ``[B, S, Hq, D]`` at absolute ``positions [B, S]``; k/v the whole
    cache buffers ``[B, T, Hkv, D]`` (the chunk already written), or with
    ``kv_rows [B]`` int32 buffers ``[R, T, Hkv, D]`` of which query row b
    reads row ``kv_rows[b]``. Positions past the buffer (bucket-padded tail
    rows) are clamped to ``T - 1``, as the TPU kernel clamps them. Returns
    ``[B, S, Hq, D]`` in q's dtype."""
    if kv_rows is not None:
        k_cache, v_cache = k_cache[kv_rows.long()], v_cache[kv_rows.long()]
    mask = _cached_mask(positions, k_cache.shape[1], window)
    return masked_attention(q, k_cache, v_cache, mask, scale=scale,
                            logit_softcap=softcap)


def flash_attention_cached_with_stats_plain(
    q, k_cache, v_cache, positions, *, scale: float, window: int | None = None,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_cached_plain` with each query row's softmax
    max ``m`` and sum ``l``, ``[B, Hq, S]`` float32: ``(out, m, l)``. A row
    with no visible slot (a negative position) gives 0, ``-inf`` and 0."""
    mask = _cached_mask(positions, k_cache.shape[1], window)
    return masked_attention_with_stats(q, k_cache, v_cache, mask, scale=scale,
                                       logit_softcap=softcap)


def _cached_mask(positions, T, window):
    """``[B, S, T]``: slot t is visible to the query at position p iff
    ``p - window < t <= min(p, T - 1)``."""
    pos = positions.to(torch.int64).clamp(max=T - 1)[:, :, None]
    t = torch.arange(T, device=positions.device)[None, None, :]
    mask = t <= pos
    if window is not None:
        mask = mask & (t > pos - window)
    return mask


def _check(name, q, k, v, B, S, Tk, Hkv):
    """``B`` is the K/V buffers' rows (q's batch but where ``kv_rows``
    names the rows)."""
    Hq, D = q.shape[2], q.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be in {HEAD_DIMS}, got {D}")
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if k.shape != (B, Tk, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: dtype mismatch {q.dtype} {k.dtype} {v.dtype}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        # the tensor-core kernel stages rows with 16-byte copies (a row is
        # H * D * 2 bytes, a multiple of 16 for every head dim it takes)
        raise ValueError(f"{name}: bf16 q/k/v must start on a 16-byte boundary")


def _launch(q, k, v, positions, segments, Tk, scale, window, softcap, stats=False,
            kv_rows=None):
    """Launch K2 (no positions) or K3 (positions, maybe ``kv_rows``);
    ``stats`` (K3-S) also writes ``m``, ``l`` ``[B, Hq, S]`` and returns
    ``(out, m, l)``."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    err = build.lib().crane_flash_attention_rows(
        build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), m.data_ptr() if stats else None, l.data_ptr() if stats else None,
        positions.data_ptr() if positions is not None else None,
        segments.data_ptr() if segments is not None else None,
        kv_rows.data_ptr() if kv_rows is not None else None,
        B, S, Tk, Hq, Hkv, D, float(scale), int(window or 0),
        float(softcap or 0.0), build.stream_ptr(q.device),
    )
    build.check_launch("crane_flash_attention", err)
    return (out, m, l) if stats else out


def flash_attention_causal(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor | None = None,
    *,
    scale: float,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Fresh-prefill flash attention (contract in
    :func:`flash_attention_causal_plain`)."""
    build.refuse_grad("flash_attention_causal", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_causal_plain(
            q, k, v, segments, scale=scale, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_causal: no kernel for {q.device}")
    B, S = q.shape[0], q.shape[1]
    _check("flash_attention_causal", q, k, v, B, S, S, k.shape[2])
    tensors = [q, k, v]
    if segments is not None:
        if segments.dtype != torch.int32 or segments.shape != (B, S):
            raise TypeError("segments must be int32 [B, S]")
        tensors.append(segments)
    build.require_cuda("flash_attention_causal", *tensors)
    out = _launch(q, k, v, None, segments, S, scale, window, softcap)
    flash_attention_causal.launches += 1
    if segments is not None:
        flash_attention_causal.segment_launches += 1
    return out


def flash_attention_cached(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
    softcap: float | None = None,
    kv_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cached-continuation flash attention (contract in
    :func:`flash_attention_cached_plain`). The rows ``kv_rows`` names are
    read on the card, where nothing checks them: the caller keeps them
    inside the buffers."""
    build.refuse_grad("flash_attention_cached", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_attention_cached_plain(
            q, k_cache, v_cache, positions, scale=scale, window=window,
            softcap=softcap, kv_rows=kv_rows)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cached: no kernel for {q.device}")
    out = _launch_cached("flash_attention_cached", q, k_cache, v_cache, positions,
                         scale, window, softcap, stats=False, kv_rows=kv_rows)
    flash_attention_cached.launches += 1
    return out


def flash_attention_cached_with_stats(
    q, k_cache, v_cache, positions, *, scale: float, window: int | None = None,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cached-continuation flash attention with its softmax statistics,
    K3-S (contract in :func:`flash_attention_cached_with_stats_plain`)."""
    build.refuse_grad("flash_attention_cached_with_stats", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_attention_cached_with_stats_plain(
            q, k_cache, v_cache, positions, scale=scale, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cached_with_stats: no kernel for {q.device}")
    res = _launch_cached("flash_attention_cached_with_stats", q, k_cache, v_cache,
                         positions, scale, window, softcap, stats=True)
    flash_attention_cached_with_stats.launches += 1
    return res


def _launch_cached(name, q, k_cache, v_cache, positions, scale, window, softcap, stats,
                   kv_rows=None):
    B, S = q.shape[0], q.shape[1]
    T = k_cache.shape[1]
    tensors = [q, k_cache, v_cache, positions]
    if kv_rows is not None:
        if kv_rows.dtype != torch.int32 or kv_rows.shape != (B,):
            raise TypeError("kv_rows must be int32 [B]")
        tensors.append(kv_rows)
    _check(name, q, k_cache, v_cache, B if kv_rows is None else k_cache.shape[0], S, T,
           k_cache.shape[2])
    if positions.dtype != torch.int32 or positions.shape != (B, S):
        raise TypeError("positions must be int32 [B, S]")
    build.require_cuda(name, *tensors)
    return _launch(q, k_cache, v_cache, positions, None, T, scale, window, softcap, stats,
                   kv_rows)


def mma_kernel_info(head_dim: int) -> dict[str, int]:
    """The compiled form of the bf16 tensor-core kernel at ``head_dim``
    (``cudaFuncGetAttributes``): registers and local (spill) bytes a
    thread, shared memory bytes and threads a block. Builds the kernels on
    first use; needs the card."""
    info = (ctypes.c_int * 4)()
    build.check_launch("crane_flash_attention_mma_info",
                       build.lib().crane_flash_attention_mma_info(head_dim, info))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "threads"), info))


flash_attention_causal.launches = 0
# of those, the launches given segments (Gemma3-VL's image blocks)
flash_attention_causal.segment_launches = 0
flash_attention_cached.launches = 0
flash_attention_cached_with_stats.launches = 0
