"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library lands in ``build/pda_torch/`` at the repository root,
named by a hash of the sources and flags, and is built at first use: nothing
here runs at import time, so the CPU-only test runs import this module
freely.

Every C entry takes device pointers and the CUDA stream as ``void*``, and
returns ``cudaGetLastError()`` after its launches; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pda_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpda_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is missing; return its path.

    The compiler writes to a file unique to this process, then renames it
    into place, so concurrent builds never load a half-written library."""
    out = _library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry of the library with its argument types declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def check_tensor(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_forward_only(what: str, *tensors) -> None:
    """The kernels have no backward yet: refuse to silently cut a graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is a forward-only kernel: call it under torch.no_grad() "
            "or torch.inference_mode()")
