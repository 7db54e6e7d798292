"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc``, all started together, and the
objects link into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library lands
in ``build/pda_torch/`` at the repository root, named by a hash of the
sources, headers and flags, and is built at first use: nothing here runs at
import time, so the CPU-only test runs import this module freely.

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
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pda_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_csrc = CSRC  # the sources whose kernels launch
_libs: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources(csrc: Path = CSRC) -> List[Path]:
    return sorted(csrc.glob("*.cu"))


def _library_path(csrc: Path = CSRC) -> Path:
    """Where the library for the sources in ``csrc`` lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpda_torch_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources in ``csrc`` if their library is missing; return
    its path.

    The compiler writes to a file unique to this process, then renames it
    into place, so concurrent builds never load a half-written library."""
    out = _library_path(csrc)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    nvcc = _nvcc()
    objs, compiles = [], []
    try:
        for src in _sources(csrc):
            obj = out.parent / f"{src.stem}.{os.getpid()}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cmd, proc in compiles:
            stdout, stderr = proc.communicate()
            _check_nvcc(cmd, proc.returncode, stdout, stderr)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout, proc.stderr)
        os.replace(tmp, out)
    finally:
        for _, proc in compiles:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def _check_nvcc(cmd, returncode: int, stdout: str, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _lock:
        if _csrc not in _libs:
            _libs[_csrc] = ctypes.CDLL(str(build(_csrc)))
        return _libs[_csrc]


def use_sources(csrc: Path = CSRC) -> ctypes.CDLL:
    """Launch the kernels built from the sources in ``csrc`` (by default the
    package's own) from now on; return their library. A variant of the
    sources (a copy of ``csrc/`` with one change) is timed this way against
    the package's own in one process (:mod:`pda_torch.tools.bench_variants`)."""
    global _csrc
    _csrc = Path(csrc).resolve()
    return library()


def entry(name: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """A C entry of the library with its argument types declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


#: the dtypes of an entry whose kernel has a bf16 instance (pda's bf16
#: configuration); every other entry takes float32 only
FLOAT32_BF16 = (torch.float32, torch.bfloat16)


def check_tensor(name: str, t: torch.Tensor, shape, device: torch.device,
                 dtypes=(torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``device``
    whose dtype is one of ``dtypes`` (float32 unless the entry has a bf16
    instance: :data:`FLOAT32_BF16`)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_forward_only(what: str, *tensors) -> None:
    """A kernel without a backward refuses to silently cut a graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is a forward-only kernel: call it under torch.no_grad() "
            "or torch.inference_mode()")
