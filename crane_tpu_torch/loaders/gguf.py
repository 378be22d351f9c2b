"""GGUF checkpoint reader: header/metadata parsing + GGML block dequantization.

Reference behavior: crane-core reads GGUF content for quantized layers, arch
auto-detection from the ``general.architecture`` header, and the embedded
tokenizer (tokens/merges/chat template) — crane-core ``src/``
models/hunyuan_dense/modeling.rs:13-78, utils/tokenizer_utils.rs,
autotokenizer.rs:162-230, model_factory.rs:144-304.

This is a from-scratch parser of the public GGUF v2/v3 format. Tensors are
returned either dequantized to float (numpy) or as raw quantized blocks for
the blockwise quantized linear. GGML stores dims innermost-first, so a
GGML ``[ne0, ne1]`` matrix is row-major ``[ne1, ne0]`` — i.e. the HF
``[out, in]`` layout; we transpose to the port's ``[in, out]`` at mapping
time like the safetensors path.

A copy of ``crane_tpu/loaders/gguf.py`` (it is numpy only), with one
addition: :func:`dequantize` logs once per process which route, native or
NumPy, dequantized block data (:func:`dequant_route` names it).
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO

import numpy as np

log = logging.getLogger("crane_tpu_torch.gguf")

GGUF_MAGIC = 0x46554747

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = 8, 9, 10, 11, 12

# ggml tensor types
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = 10, 11, 12, 13, 14, 15
GGML_BF16 = 30

GGML_TYPE_NAMES = {
    GGML_F32: "f32", GGML_F16: "f16", GGML_BF16: "bf16",
    GGML_Q4_0: "q4_0", GGML_Q4_1: "q4_1", GGML_Q5_0: "q5_0", GGML_Q5_1: "q5_1",
    GGML_Q8_0: "q8_0", GGML_Q2_K: "q2_k", GGML_Q3_K: "q3_k", GGML_Q4_K: "q4_k",
    GGML_Q5_K: "q5_k", GGML_Q6_K: "q6_k",
}

# (block_elems, block_bytes)
_BLOCK_INFO = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # ggml order: innermost first
    ggml_type: int
    offset: int

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        be, bb = _BLOCK_INFO[self.ggml_type]
        return self.n_elements // be * bb


class GGUFReader:
    def __init__(self, path: str):
        self.path = path
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        with open(path, "rb") as f:
            self._parse_header(f)
        self._data = np.memmap(path, mode="r")

    # -- header --------------------------------------------------------------
    def _read(self, f: BinaryIO, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, f.read(size))[0]

    def _read_string(self, f: BinaryIO) -> str:
        n = self._read(f, "<Q")
        return f.read(n).decode("utf-8", errors="replace")

    def _read_value(self, f: BinaryIO, vtype: int):
        scalar = {
            _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
            _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
            _T_I64: "<q", _T_F64: "<d",
        }
        if vtype in scalar:
            return self._read(f, scalar[vtype])
        if vtype == _T_BOOL:
            return bool(self._read(f, "<B"))
        if vtype == _T_STR:
            return self._read_string(f)
        if vtype == _T_ARR:
            etype = self._read(f, "<I")
            n = self._read(f, "<Q")
            return [self._read_value(f, etype) for _ in range(n)]
        raise ValueError(f"unknown gguf metadata type {vtype}")

    def _parse_header(self, f: BinaryIO):
        magic = self._read(f, "<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = self._read(f, "<I")
        if version < 2:
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = self._read(f, "<Q")
        n_kv = self._read(f, "<Q")
        for _ in range(n_kv):
            key = self._read_string(f)
            vtype = self._read(f, "<I")
            self.metadata[key] = self._read_value(f, vtype)
        infos = []
        for _ in range(n_tensors):
            name = self._read_string(f)
            n_dims = self._read(f, "<I")
            shape = tuple(self._read(f, "<Q") for _ in range(n_dims))
            ggml_type = self._read(f, "<I")
            offset = self._read(f, "<Q")
            infos.append(GGUFTensorInfo(name, shape, ggml_type, offset))
        align = self.metadata.get("general.alignment", 32)
        pos = f.tell()
        self.data_start = (pos + align - 1) // align * align
        for ti in infos:
            self.tensors[ti.name] = ti

    # -- tensor access -------------------------------------------------------
    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "")

    def field(self, key: str, default=None):
        """Arch-scoped metadata lookup: field("block_count") ->
        metadata["<arch>.block_count"]."""
        return self.metadata.get(f"{self.architecture}.{key}", default)

    def raw_tensor(self, name: str) -> tuple[GGUFTensorInfo, np.ndarray]:
        ti = self.tensors[name]
        start = self.data_start + ti.offset
        return ti, np.asarray(self._data[start : start + ti.n_bytes])

    def tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantized tensor in logical row-major [..., outer..., ne0]."""
        ti, raw = self.raw_tensor(name)
        flat = dequantize(raw, ti.ggml_type, ti.n_elements).astype(dtype)
        return flat.reshape(tuple(reversed(ti.shape)))


# -- GGML block dequantization (public format) -------------------------------


def _f16(x: np.ndarray) -> np.ndarray:
    return x.view(np.float16).astype(np.float32)


def dequant_route() -> str:
    """The route :func:`dequantize` takes for block data: ``native`` (the
    OpenMP library built from ``native/gguf_dequant.cpp``) or ``numpy``
    (no compiler, or ``CRANE_NATIVE=0``)."""
    from crane_tpu_torch.native import gguf_dequant_native

    return "numpy" if gguf_dequant_native(np.zeros(34, np.uint8), GGML_Q8_0, 32) is None \
        else "native"


_routes_logged: set[str] = set()


def _log_route(route: str) -> None:
    if route not in _routes_logged:
        _routes_logged.add(route)
        log.info("GGUF block dequantization by the %s route", route)


def dequantize(raw: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    raw = raw.view(np.uint8)
    if ggml_type in _BLOCK_INFO and ggml_type not in (GGML_F32, GGML_F16, GGML_BF16):
        # native OpenMP dequant (crane_tpu_torch/native/gguf_dequant.cpp),
        # bit-exact with the NumPy path below; None -> compiler unavailable
        # or CRANE_NATIVE=0, fall through
        from crane_tpu_torch.native import gguf_dequant_native

        out = gguf_dequant_native(raw, ggml_type, n_elements)
        if out is not None:
            _log_route("native")
            return out
        _log_route("numpy")
    if ggml_type == GGML_F32:
        return raw.view(np.float32).copy()
    if ggml_type == GGML_F16:
        return raw.view(np.float16).astype(np.float32)
    if ggml_type == GGML_BF16:
        out = np.zeros(n_elements, np.uint32)
        out |= raw.view(np.uint16).astype(np.uint32) << 16
        return out.view(np.float32).copy()
    be, bb = _BLOCK_INFO[ggml_type]
    blocks = raw.reshape(n_elements // be, bb)
    if ggml_type == GGML_Q8_0:
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        q = blocks[:, 2:].view(np.int8).astype(np.float32)
        return (d * q).reshape(-1)
    if ggml_type == GGML_Q4_0:
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        qs = blocks[:, 2:]
        lo = (qs & 0x0F).astype(np.float32) - 8.0
        hi = (qs >> 4).astype(np.float32) - 8.0
        return (d * np.concatenate([lo, hi], axis=1)).reshape(-1)
    if ggml_type == GGML_Q4_1:
        d = _f16(blocks[:, 0:2].reshape(-1))[:, None]
        m = _f16(blocks[:, 2:4].reshape(-1))[:, None]
        qs = blocks[:, 4:]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        return (d * np.concatenate([lo, hi], axis=1) + m).reshape(-1)
    if ggml_type == GGML_Q5_0:
        d = _f16(blocks[:, :2].reshape(-1))[:, None]
        qh = blocks[:, 2:6].copy().view(np.uint32).reshape(-1)
        qs = blocks[:, 6:]
        bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
        lo = (qs & 0x0F).astype(np.float32) + 16.0 * bits[:, :16]
        hi = (qs >> 4).astype(np.float32) + 16.0 * bits[:, 16:]
        return (d * (np.concatenate([lo, hi], axis=1) - 16.0)).reshape(-1)
    if ggml_type == GGML_Q5_1:
        d = _f16(blocks[:, 0:2].reshape(-1))[:, None]
        m = _f16(blocks[:, 2:4].reshape(-1))[:, None]
        qh = blocks[:, 4:8].copy().view(np.uint32).reshape(-1)
        qs = blocks[:, 8:]
        bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
        lo = (qs & 0x0F).astype(np.float32) + 16.0 * bits[:, :16]
        hi = (qs >> 4).astype(np.float32) + 16.0 * bits[:, 16:]
        return (d * np.concatenate([lo, hi], axis=1) + m).reshape(-1)
    if ggml_type == GGML_Q4_K:
        return _dequant_q4_k(blocks)
    if ggml_type == GGML_Q5_K:
        return _dequant_q5_k(blocks)
    if ggml_type == GGML_Q6_K:
        return _dequant_q6_k(blocks)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def _unpack_k_scales(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """q4_k/q5_k 12-byte packed 6-bit scales+mins for 8 sub-blocks."""
    sc = sc.astype(np.uint8)
    scales = np.zeros((sc.shape[0], 8), np.float32)
    mins = np.zeros((sc.shape[0], 8), np.float32)
    for j in range(8):
        if j < 4:
            scales[:, j] = (sc[:, j] & 63).astype(np.float32)
            mins[:, j] = (sc[:, j + 4] & 63).astype(np.float32)
        else:
            scales[:, j] = ((sc[:, j + 4] & 0x0F) | ((sc[:, j - 4] >> 6) << 4)).astype(np.float32)
            mins[:, j] = ((sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)).astype(np.float32)
    return scales, mins


def _dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].reshape(-1))
    dmin = _f16(blocks[:, 2:4].reshape(-1))
    scales, mins = _unpack_k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:144]  # 128 bytes = 256 nibbles
    out = np.zeros((nb, 256), np.float32)
    # layout: 4 chunks of 32 bytes; chunk c holds sub-blocks 2c (low nibbles)
    # and 2c+1 (high nibbles)
    for c in range(4):
        chunk = qs[:, c * 32 : (c + 1) * 32]
        lo = (chunk & 0x0F).astype(np.float32)
        hi = (chunk >> 4).astype(np.float32)
        sb0, sb1 = 2 * c, 2 * c + 1
        out[:, sb0 * 32 : sb0 * 32 + 32] = (
            d[:, None] * scales[:, sb0 : sb0 + 1] * lo - dmin[:, None] * mins[:, sb0 : sb0 + 1]
        )
        out[:, sb1 * 32 : sb1 * 32 + 32] = (
            d[:, None] * scales[:, sb1 : sb1 + 1] * hi - dmin[:, None] * mins[:, sb1 : sb1 + 1]
        )
    return out.reshape(-1)


def _dequant_q5_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].reshape(-1))
    dmin = _f16(blocks[:, 2:4].reshape(-1))
    scales, mins = _unpack_k_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]  # 32 bytes: bit j of byte i -> element ...
    qs = blocks[:, 48:176]  # 128 bytes nibbles
    out = np.zeros((nb, 256), np.float32)
    u = np.ones((nb, 32), np.uint8)
    for c in range(4):
        chunk = qs[:, c * 32 : (c + 1) * 32]
        lo = (chunk & 0x0F).astype(np.float32)
        hi = (chunk >> 4).astype(np.float32)
        hbit_lo = ((qh & u) != 0).astype(np.float32) * 16.0
        u = u << 1
        hbit_hi = ((qh & u) != 0).astype(np.float32) * 16.0
        u = u << 1
        sb0, sb1 = 2 * c, 2 * c + 1
        out[:, sb0 * 32 : sb0 * 32 + 32] = (
            d[:, None] * scales[:, sb0 : sb0 + 1] * (lo + hbit_lo)
            - dmin[:, None] * mins[:, sb0 : sb0 + 1]
        )
        out[:, sb1 * 32 : sb1 * 32 + 32] = (
            d[:, None] * scales[:, sb1 : sb1 + 1] * (hi + hbit_hi)
            - dmin[:, None] * mins[:, sb1 : sb1 + 1]
        )
    return out.reshape(-1)


def _dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210].reshape(-1))
    out = np.zeros((nb, 256), np.float32)
    # two 128-element halves, each from 64 ql bytes + 32 qh bytes
    for half in range(2):
        qlh = ql[:, half * 64 : half * 64 + 64]
        qhh = qh[:, half * 32 : half * 32 + 32]
        base = half * 128
        q1 = ((qlh[:, :32] & 0x0F) | (((qhh >> 0) & 3) << 4)).astype(np.int8) - 32
        q2 = ((qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 3) << 4)).astype(np.int8) - 32
        q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int8) - 32
        q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int8) - 32
        for i, q in enumerate((q1, q2, q3, q4)):
            # scale index: each 16 elements share a scale; 8 scales per half
            seg = base + i * 32
            s_idx = half * 8 + i * 2
            out[:, seg : seg + 16] = d[:, None] * sc[:, s_idx : s_idx + 1] * q[:, :16]
            out[:, seg + 16 : seg + 32] = d[:, None] * sc[:, s_idx + 1 : s_idx + 2] * q[:, 16:]
    return out.reshape(-1)


# -- quantizers (for ISQ + test fixtures) ------------------------------------


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 32 elems) to q8_0 raw bytes."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    inv = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round(x * inv[:, None]), -127, 127).astype(np.int8)
    out = np.zeros((x.shape[0], 34), np.uint8)
    out[:, :2] = d[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, 32)
    imax = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), imax]
    d = (maxv / -8.0).astype(np.float16)
    inv = np.where(d != 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.zeros((x.shape[0], 18), np.uint8)
    out[:, :2] = d[:, None].view(np.uint8)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)
