"""Minimal protobuf wire-format reader for ONNX model files.

The reference vendors a full ONNX evaluator (crane-core/src/onnx/) because
its production Kokoro and PaddleOCR checkpoints ship as ``.onnx`` graphs.
This module reads the same files with no protobuf/onnx dependency: a generic
wire decoder plus typed views over the handful of messages a forward-only
evaluator needs (ModelProto / GraphProto / NodeProto / AttributeProto /
TensorProto — field numbers per the public ONNX schema, mirrored at
crane-core/src/onnx/onnx.proto3).

A copy of ``crane_tpu/onnx/wire.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    r, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << shift
        if not b & 0x80:
            return r, i
        shift += 7


def parse_fields(buf: bytes) -> dict:
    """Decode one message into {field_number: [raw values]}. Varints come
    back as ints, fixed32/64 as 4/8-byte bytes, length-delimited as bytes."""
    out: dict = {}
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == _VARINT:
            v, i = _read_varint(buf, i)
        elif wt == _I64:
            v, i = buf[i : i + 8], i + 8
        elif wt == _LEN:
            ln, i = _read_varint(buf, i)
            v, i = buf[i : i + ln], i + ln
        elif wt == _I32:
            v, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fnum})")
        out.setdefault(fnum, []).append(v)
    return out


def _signed(v: int) -> int:
    """protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(vals: list) -> list[int]:
    """A repeated numeric field: either packed bytes or one-per-entry."""
    out = []
    for v in vals:
        if isinstance(v, int):
            out.append(_signed(v))
        else:
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(_signed(x))
    return out


def _str(vals: list, idx: int = 0, default: str = "") -> str:
    return vals[idx].decode("utf-8") if vals else default


# TensorProto.data_type -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray). Handles raw_data and the typed
    repeated fields (float_data/int32_data/int64_data/double_data)."""
    f = parse_fields(buf)
    dims = _packed_varints(f.get(1, []))
    dt = f.get(2, [1])[0]
    name = _str(f.get(8, []))
    if dt == 8:  # string tensor
        vals = np.array([s.decode("utf-8") for s in f.get(6, [])], dtype=object)
        return name, vals.reshape(dims)
    np_dt = _DTYPES.get(dt)
    if np_dt is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dt}")
    if 9 in f:  # raw_data: little-endian C-order
        arr = np.frombuffer(f[9][0], dtype=np_dt)
    elif 4 in f and dt == 1:
        arr = np.asarray(
            struct.unpack(f"<{len(f[4][0]) // 4}f", f[4][0])
            if f[4] and isinstance(f[4][0], bytes) and len(f[4]) == 1
            else [struct.unpack("<f", v)[0] for v in f[4]],
            np.float32,
        )
    elif 10 in f and dt == 11:
        arr = np.frombuffer(b"".join(f[10]), dtype=np.float64)
    elif 7 in f:  # int64_data
        arr = np.asarray(_packed_varints(f[7]), np.int64)
    elif 5 in f:  # int32_data (also carries small int types + fp16)
        ints = np.asarray(_packed_varints(f[5]), np.int64)
        if dt == 10:  # float16 rides as raw uint16 bit patterns, not values
            arr = ints.astype(np.uint16).view(np.float16)
        else:
            arr = ints.astype(np_dt)
    else:
        arr = np.zeros(0, np_dt)
    n = int(np.prod(dims)) if dims else arr.size
    return name, arr[:n].reshape(dims).copy()


@dataclasses.dataclass
class Attribute:
    name: str
    value: object  # float | int | bytes | np.ndarray | list | Graph


def parse_attribute(buf: bytes) -> Attribute:
    f = parse_fields(buf)
    name = _str(f.get(1, []))
    atype = f.get(20, [0])[0]
    if atype == 1:  # FLOAT
        return Attribute(name, struct.unpack("<f", f[2][0])[0])
    if atype == 2:  # INT
        return Attribute(name, _signed(f[3][0]))
    if atype == 3:  # STRING
        return Attribute(name, f[4][0])
    if atype == 4:  # TENSOR
        return Attribute(name, parse_tensor(f[5][0])[1])
    if atype == 5:  # GRAPH (If/Loop bodies)
        return Attribute(name, parse_graph(f[6][0]))
    if atype == 6:  # FLOATS
        return Attribute(
            name, [struct.unpack("<f", v)[0] for v in f.get(7, [])]
            if f.get(7) and isinstance(f[7][0], bytes) and len(f[7][0]) == 4
            else list(np.frombuffer(b"".join(f.get(7, [])), np.float32)),
        )
    if atype == 7:  # INTS
        return Attribute(name, _packed_varints(f.get(8, [])))
    if atype == 8:  # STRINGS
        return Attribute(name, list(f.get(9, [])))
    # untyped fallback: infer from populated field (some exporters omit type)
    for fn, conv in ((3, lambda v: _signed(v[0])),
                     (2, lambda v: struct.unpack("<f", v[0])[0]),
                     (8, _packed_varints), (4, lambda v: v[0])):
        if fn in f:
            return Attribute(name, conv(f[fn]))
    return Attribute(name, None)


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: list
    outputs: list
    name: str
    attrs: dict


@dataclasses.dataclass
class Graph:
    nodes: list
    initializers: dict  # name -> np.ndarray
    inputs: list  # names (excluding initializers)
    outputs: list  # names
    name: str = ""
    # name -> (numpy dtype | None, shape tuple with -1 for symbolic dims)
    input_specs: dict = dataclasses.field(default_factory=dict)


def parse_node(buf: bytes) -> Node:
    f = parse_fields(buf)
    attrs = {}
    for a in f.get(5, []):
        at = parse_attribute(a)
        attrs[at.name] = at.value
    return Node(
        op_type=_str(f.get(4, [])),
        inputs=[v.decode() for v in f.get(1, [])],
        outputs=[v.decode() for v in f.get(2, [])],
        name=_str(f.get(3, [])),
        attrs=attrs,
    )


def _value_info_name(buf: bytes) -> str:
    return _str(parse_fields(buf).get(1, []))


# TensorProto elem_type -> numpy dtype (the subset production graphs use)
_ELEM_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
                10: np.float16, 11: np.float64}


def _value_info_spec(buf: bytes):
    """(name, dtype | None, shape | None) from a ValueInfoProto. Dims are
    ints; symbolic dims (dim_param) come back as -1."""
    f = parse_fields(buf)
    name = _str(f.get(1, []))
    dtype = shape = None
    for t in f.get(2, []):  # TypeProto
        tf = parse_fields(t)
        for tt in tf.get(1, []):  # tensor_type
            ttf = parse_fields(tt)
            if ttf.get(1):
                dtype = _ELEM_DTYPES.get(ttf[1][0])
            for sh in ttf.get(2, []):  # TensorShapeProto
                dims = []
                for d in parse_fields(sh).get(1, []):  # Dimension
                    df = parse_fields(d)
                    dims.append(_signed(df[1][0]) if df.get(1) else -1)
                shape = tuple(dims)
    return name, dtype, shape


def parse_graph(buf: bytes) -> Graph:
    f = parse_fields(buf)
    inits = dict(parse_tensor(t) for t in f.get(5, []))
    specs = [_value_info_spec(v) for v in f.get(11, [])]
    return Graph(
        nodes=[parse_node(n) for n in f.get(1, [])],
        initializers=inits,
        inputs=[n for n, _, _ in specs if n not in inits],
        outputs=[_value_info_name(v) for v in f.get(12, [])],
        name=_str(f.get(2, [])),
        input_specs={n: (dt, sh) for n, dt, sh in specs if n not in inits},
    )


@dataclasses.dataclass
class Model:
    graph: Graph
    opset: int = 17


def parse_model(buf: bytes) -> Model:
    f = parse_fields(buf)
    opset = 17
    for o in f.get(8, []):
        of = parse_fields(o)
        if not of.get(1) or of[1][0] == b"":  # default ONNX domain
            opset = of.get(2, [17])[0]
    return Model(graph=parse_graph(f[7][0]), opset=opset)


def read_file(path: str) -> Model:
    with open(path, "rb") as fh:
        return parse_model(fh.read())
