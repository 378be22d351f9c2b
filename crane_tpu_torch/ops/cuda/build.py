"""Build the port's CUDA kernels and bind them with ctypes.

Every ``*.cu`` under ``crane_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started together
(the ``*.cuh`` headers they include count in the hash below),
and the objects are linked into ONE shared library with a plain C
interface, at first use. The library is named by a hash of the sources and
the flags and lives under ``build/kernels/`` at the repository root (listed
in ``.gitignore``), so an edited source rebuilds and an unchanged one loads
the existing file. Binding through ``ctypes`` keeps PyTorch's headers out of
the compile.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)
# storage type codes understood by csrc/common.cuh (crane::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bf16 tolerance of a kernel against its plain version on the same inputs:
# both round the output to bf16 (at most half an ulp each, 2**-9 relative)
# and sum in float32 in other orders, so |kernel - plain| <= ATOL + RTOL*|plain|
# with RTOL two bf16 ulps and ATOL for outputs near zero.
KERNEL_RTOL = 2.0 ** -6
KERNEL_ATOL = 1e-3

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points: name -> argtypes (restype is int, the
# CUDA error of the launch)
SIGNATURES = {
    "crane_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _F, _I, _F, _I, _P],
    "crane_decode_attention_info": [_I, _I, _I, _P],
    "crane_flash_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _F, _I, _F, _P],
    "crane_flash_attention_rows": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _F, _I, _F, _P],
    "crane_flash_attention_mma_info": [_I, _P],
    "crane_quant_matmul": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "crane_quant_matmul_mma_info": [_I, _I, _P],
    "crane_quant_decode_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _I, _P],
    "crane_quant_decode_attention_info": [_I, _I, _I, _I, _P],
    "crane_quant_cached_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _F, _I, _F, _P],
    "crane_quant_cached_attention_mma_info": [_I, _I, _P],
    "crane_gdn_scan": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "crane_gdn_chunk": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "crane_gdn_chunk_info": [_I, _I, _P],
    "crane_moe_group": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "crane_moe_gate_up": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "crane_moe_down": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _P],
    "crane_moe_experts_info": [_I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcrane_kernels_{_digest()}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]  # waits for every process
    for cmd, p, text in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{text}")


def build() -> Path:
    """Compile the kernels if no library for the current sources exists.
    Returns the library path. Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    nvcc = _nvcc()
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
          for src, o in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}"
        )
    return code


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (0 = success)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a kernel's backward: grad mode on and
    an input that requires grad. A kernel writes its output through raw
    pointers, so the output has no ``grad_fn`` and every gradient through it
    would be lost without a word. Every wrapper calls this first, on the card
    and on the CPU alike; a caller that trains routes the call to the plain
    version (``forward_hidden(..., plain_attention=True)``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward and an input requires grad; "
                           f"call its plain version to train through it")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The checks every wrapper makes before handing pointers to a kernel:
    one CUDA device, contiguous memory."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
