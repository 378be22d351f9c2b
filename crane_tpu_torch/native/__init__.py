"""Native (C++) runtime components, built on demand with the system g++.

A copy of ``crane_tpu/native/__init__.py`` (and ``gguf_dequant.cpp`` beside
it) with one change: the shared library is built from the source here into
``build/native/`` at the repository root (listed in ``.gitignore``), not
next to the source. It is keyed by a hash of the source text, so a source
edit triggers a rebuild and repeated imports are free. Everything here has a
pure-NumPy fallback — a missing compiler degrades performance, never
correctness (set ``CRANE_NATIVE=0`` to force the fallbacks).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_DIR = pathlib.Path(__file__).parent
BUILD_DIR = _DIR.resolve().parents[1] / "build" / "native"
_lib_cache: dict = {}


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``<name>.cpp`` is built, by its source's hash."""
    tag = hashlib.sha256((_DIR / f"{name}.cpp").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_{name}_{tag}.so"


def _build(name: str) -> pathlib.Path | None:
    """Compile ``<name>.cpp`` to a shared library; return its path or None."""
    out = library_path(name)
    if out.exists():
        return out
    flags = ["-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = pathlib.Path(td) / out.name
        try:
            subprocess.run(
                ["g++", *flags, str(_DIR / f"{name}.cpp"), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        try:
            os.replace(tmp, out)
        except OSError:
            return None
    return out


def _load(name: str):
    if os.environ.get("CRANE_NATIVE") == "0":
        return None
    if name in _lib_cache:
        return _lib_cache[name]
    lib = None
    path = _build(name)
    if path is not None:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            lib = None
    _lib_cache[name] = lib
    return lib


def gguf_dequant_native(raw: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray | None:
    """Dequantize GGML block data with the native kernel; None = unavailable
    (caller falls back to the NumPy path)."""
    lib = _load("gguf_dequant")
    if lib is None:
        return None
    fn = lib.gguf_dequant
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    raw = np.ascontiguousarray(raw.view(np.uint8))
    out = np.empty(n_elements, np.float32)
    rc = fn(
        ctypes.c_int(ggml_type),
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n_elements),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None
