"""Linear layers, dense and quantized (port of ``crane_tpu/ops/linear.py``).

Weights are stored ``[in, out]`` as in the reference, so the forward is
``x @ w``. A plain matrix product is left to ``torch.matmul``, as the JAX
package leaves it to XLA.

Quantized weights (:class:`QuantizedWeight`, in-situ quantization by
:func:`quantize_weight`) take one of three routes in :func:`linear`:

- per-channel weights (one scale per output column) with at most
  ``QUANT_MATMUL_MAX_M`` rows of activations go to K6,
  :func:`~crane_tpu_torch.ops.cuda.quant_matmul.quant_matmul`, which reads
  the int8 or packed int4 codes as stored. On the TPU, int8 weights reach
  that kernel only behind ``CRANE_PALLAS_QUANT``, because XLA fuses the
  int8 -> bf16 convert into its dot; PyTorch has no such fusion (its plain
  route writes a dequantized copy of the weight first), so the port sends
  every per-channel weight at M <= 256 on the card through K6, as K1-K3 take
  every eligible call without a switch;
- the remaining per-channel cases (prefill-sized M) go to the plain
  ``x @ codes`` in the working dtype, with float32 accumulation, scaled
  after (``CRANE_W8A8=1`` opts int8 weights into a dynamic per-token int8
  activation quantization and an int8 x int8 -> int32 product instead);
- blockwise (GGUF-granularity) weights go to the plain per-block product.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from crane_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
from crane_tpu_torch.ops.kv_cache import pack_int4, quant_symmetric, unpack_int4

# the M (token) bound of K6's route, as the reference routes its kernel
QUANT_MATMUL_MAX_M = 256


def pack_int4_rows(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes ``[I, O]`` two per byte along the input dim:
    ``packed[i] = 16 * codes[I/2 + i] + codes[i]`` (the transpose of
    :func:`~crane_tpu_torch.ops.kv_cache.pack_int4`)."""
    return pack_int4(codes.T).T.contiguous()


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    return unpack_int4(packed.T).T.contiguous()


@dataclasses.dataclass
class QuantizedWeight:
    """Symmetric int8/int4 weight for ``y = x @ w``.

    ``codes``: ``[in, out]`` int8, except per-channel int4 (``bits=4``,
    ``block == in``), which is packed to ``[in/2, out]``; ``scales``:
    ``[in // block, out]`` float32; ``block`` and ``bits`` are static."""

    codes: torch.Tensor
    scales: torch.Tensor
    block: int = 32
    bits: int = 8

    @property
    def packed(self) -> bool:
        return self.bits == 4 and self.codes.shape[0] == self.block // 2

    @property
    def shape(self) -> tuple[int, int]:
        i, o = self.codes.shape
        return (2 * i if self.packed else i, o)

    def unpacked_codes(self) -> torch.Tensor:
        return unpack_int4_rows(self.codes) if self.packed else self.codes

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        codes = self.unpacked_codes()
        i, o = codes.shape
        w = codes.float().reshape(i // self.block, self.block, o)
        w = w * self.scales[:, None, :]
        return w.reshape(i, o).to(dtype)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.codes, self.scales)


def quantize_weight(w: torch.Tensor, *, bits: int = 8, block: int = 32,
                    granularity: str = "channel") -> QuantizedWeight:
    """In-situ symmetric quantization of a dense ``[in, out]`` weight, the
    reference's arithmetic (codes and scales byte-identical): the KV cache's
    :func:`~crane_tpu_torch.ops.kv_cache.quant_symmetric` over each column.

    ``"channel"`` keeps one scale per output column (``block == in``) and
    packs int4 rows when ``in`` is even; ``"block"`` keeps one scale per
    ``block`` input rows (q8_0/q4_0 granularity), or per column when
    ``block`` does not divide ``in``."""
    i, o = w.shape
    if granularity == "channel":
        codes, scale = quant_symmetric(w.T, bits)  # [out, in], [out, 1]
        codes = pack_int4_rows(codes.T) if bits == 4 and i % 2 == 0 else codes.T.contiguous()
        return QuantizedWeight(codes=codes, scales=scale.T.contiguous(), block=i, bits=bits)
    if i % block:
        block = i
    codes, scale = quant_symmetric(w.reshape(i // block, block, o).transpose(1, 2), bits)
    return QuantizedWeight(codes=codes.transpose(1, 2).reshape(i, o), scales=scale[..., 0],
                           block=block, bits=bits)


def _w8a8_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Dynamic per-token int8 quantization of ``x``, an int8 x int8 -> int32
    product (``torch._int_mm``, which takes more than 16 rows on a CUDA
    tensor), rescaled by the activation and weight scales."""
    o = codes.shape[1]
    xf = x.float().reshape(-1, x.shape[-1])
    sx = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    xq = torch.round(xf / torch.where(sx > 0, sx, 1.0)).clamp(-127, 127).to(torch.int8)
    acc = torch._int_mm(xq, codes)
    y = acc.float() * sx * scales.reshape(1, o)
    return y.reshape(*x.shape[:-1], o).to(x.dtype)


def _quant_linear(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    i, o = w.shape
    if w.block == i:
        x2 = x.reshape(-1, i)
        if x2.shape[0] > QUANT_MATMUL_MAX_M and os.environ.get("CRANE_W8A8") == "1" \
                and w.bits == 8:
            return _w8a8_matmul(x, w.codes, w.scales)
        # the codes' layout: packed int4, or one int8 code per element
        bits = 4 if w.packed else 8
        fn = quant_matmul if x2.shape[0] <= QUANT_MATMUL_MAX_M else quant_matmul_plain
        return fn(x2.contiguous(), w.codes, w.scales, bits=bits).reshape(*x.shape[:-1], o)
    nb = i // w.block
    xb = x.reshape(*x.shape[:-1], nb, w.block).float()
    y = torch.einsum("...nk,nko->...no", xb, w.codes.reshape(nb, w.block, o).float())
    # einsum hands back a permuted view; the attention kernels downstream
    # take contiguous rows, as every other route of this function gives them
    return torch.einsum("...no,no->...o", y, w.scales).to(x.dtype).contiguous()


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """``y = x @ w (+ b)`` for a dense ``[in, out]`` weight or a
    :class:`QuantizedWeight`."""
    if isinstance(w, QuantizedWeight):
        y = _quant_linear(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
