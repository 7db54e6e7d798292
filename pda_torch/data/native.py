"""ctypes bindings to the native host library (port of ``pda/data/native.py``).

``csrc/pda_native.cpp`` is a copy of ``pda``'s C++ library, byte for byte:
standardize, crop, Gaussian blur, additive noise, contrast, the fused weak
augmentation, the elastic warp and the field upsample, each a plain C entry
that releases the GIL. It is built with ``pda``'s flags (``g++ -O3
-march=native -ffast-math -shared -fPIC``) into ``build/pda_torch/`` at the
repository root, named by a hash of the source, the flags and the host's CPU,
at first use: nothing here runs at import time. The compiler writes to a file
of its own process, then renames it into place, so concurrent builders never
load a half-written library. :class:`~pda_torch.data.loader.Loader` builds it
in the parent before its worker processes start; a worker then loads the
built file.

``PDA_NATIVE_AUGS`` (default ``"1"``; ``"0"`` selects the numpy path) is the
switch, read where ``pda`` reads it: :func:`pda_torch.data.transforms.standardize`
with default statistics, the joint augmentations' elastic field and warp,
and :func:`pda_torch.experiments.common.weak_augmentations`.

One deliberate difference from ``pda``: there is no silent fallback. ``pda``
takes its numpy path when ``g++`` fails; here a failed build or ``dlopen``
raises :class:`NativeBuildError` with the compiler's stderr while the switch
is on, since the two paths give different views (the weak augmentation draws
from its own splitmix64 stream). :func:`available` still reports whether the
library loads, without raising.

The library is linked with ``-ffast-math``, so loading it sets the
flush-to-zero and denormals-are-zero modes of the loading thread (and of the
threads it starts later): float32 and float64 subnormals then read and
compute as zero in that thread, for numpy and PyTorch's CPU kernels alike.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "pda_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pda_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None

_HINT = "PDA_NATIVE_AUGS=0 selects the numpy augmentation path, which needs no compiler"
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def enabled() -> bool:
    """Whether ``PDA_NATIVE_AUGS`` selects the native path (default: yes)."""
    return os.environ.get("PDA_NATIVE_AUGS", "1") != "0"


@contextlib.contextmanager
def augmentation_path(native: bool):
    """``PDA_NATIVE_AUGS`` set to the native ("1") or the numpy ("0") path
    while the block runs."""
    old = os.environ.get("PDA_NATIVE_AUGS")
    os.environ["PDA_NATIVE_AUGS"] = "1" if native else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PDA_NATIVE_AUGS"]
        else:
            os.environ["PDA_NATIVE_AUGS"] = old


def _host() -> bytes:
    """The host's CPU as ``-march=native`` sees it: its architecture and,
    where the kernel lists them, the CPU's model and instruction-set flags."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    lines.append(line.strip())
                if len(lines) == 3:
                    break
    except OSError:
        pass
    return "\n".join(lines).encode()


def library_path() -> Path:
    """Where the library for this source, these flags and this host lives
    (built or not)."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host())
    return BUILD_DIR / f"libpda_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; return its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}\n{_HINT}") from e
    try:
        if proc.returncode != 0:
            raise NativeBuildError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                                   f"{proc.stderr}\n{_HINT}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out



def _load() -> ctypes.CDLL:
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeBuildError(f"dlopen {path}: {e}\n{_HINT}") from e
        except NativeBuildError as e:
            _error = e
            raise
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    i64, f32 = ctypes.c_int64, ctypes.c_float
    for name in ("pda_standardize", "pda_crop", "pda_gaussian_blur", "pda_add_gaussian_noise",
                 "pda_random_contrast", "pda_weak_augment", "pda_elastic_warp",
                 "pda_field_upsample"):
        getattr(lib, name).restype = None
    lib.pda_standardize.argtypes = [_f32p, i64, f32]
    lib.pda_crop.argtypes = [_f32p, i64, i64, i64, i64, i64, i64, _f32p]
    lib.pda_gaussian_blur.argtypes = [_f32p, _f32p, i64, i64, f32, _f32p]
    lib.pda_add_gaussian_noise.argtypes = [_f32p, i64, f32, ctypes.c_uint64, ctypes.c_int]
    lib.pda_random_contrast.argtypes = [_f32p, i64, f32]
    lib.pda_weak_augment.argtypes = [_f32p, i64, i64, f32, f32, f32, f32, f32,
                                     ctypes.c_uint64, _f32p]
    lib.pda_elastic_warp.argtypes = [_f32p, _f32p, i64, i64, _f32p, _f32p, ctypes.c_int]
    lib.pda_field_upsample.argtypes = [_f32p, i64, i64, i64, i64, _f32p]


def available() -> bool:
    """Whether the library builds and loads (never raises)."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def _owned_f32(x: np.ndarray) -> np.ndarray:
    """A contiguous float32 copy that never aliases the caller's array: the
    in-place entries must not write through a view (a full-width crop is a
    contiguous view of the dataset's image)."""
    xc = np.ascontiguousarray(x, dtype=np.float32)
    return xc.copy() if xc is x else xc


def _plane_2d(x: np.ndarray, what: str) -> np.ndarray:
    """The (H, W) plane of an (H, W) or (H, W, 1) array; the C entries are
    plane operators, so anything else raises."""
    if x.ndim == 3 and x.shape[-1] == 1:
        return x[..., 0]
    if x.ndim == 2:
        return x
    raise ValueError(f"{what} handles (H, W) / (H, W, 1) images, got {x.shape}")


def standardize(x: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    lib = _load()
    x = _owned_f32(x)
    lib.pda_standardize(x.reshape(-1), x.size, eps)
    return x


def crop(src: np.ndarray, y0: int, x0: int, h: int, w: int) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    if src.ndim != 2 or min(y0, x0, h, w) < 0 or y0 + h > src.shape[0] or x0 + w > src.shape[1]:
        raise ValueError(f"crop: window ({y0}, {x0}, {h}, {w}) outside the {src.shape} image")
    out = np.empty((h, w), dtype=np.float32)
    lib.pda_crop(src, src.shape[0], src.shape[1], y0, x0, h, w, out)
    return out


def gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    plane = _plane_2d(x, "gaussian_blur")
    out = np.empty_like(x)
    scratch = np.empty_like(plane)
    lib.pda_gaussian_blur(plane, out.reshape(plane.shape), plane.shape[0], plane.shape[1],
                          sigma, scratch)
    return out


def add_gaussian_noise(x: np.ndarray, std: float, seed: int, clip: bool = False) -> np.ndarray:
    lib = _load()
    x = _owned_f32(x)
    lib.pda_add_gaussian_noise(x.reshape(-1), x.size, std, seed, int(clip))
    return x


def random_contrast(x: np.ndarray, alpha: float) -> np.ndarray:
    lib = _load()
    x = _owned_f32(x)
    lib.pda_random_contrast(x.reshape(-1), x.size, alpha)
    return x


def weak_augment(x: np.ndarray, *, p: float = 0.25, blur_sigma=(0.0, 3.0), noise=(0.0, 0.15),
                 seed: int = 0) -> np.ndarray:
    """Standardize, then blur and noise each with probability ``p``, in one
    call, drawing from the splitmix64 stream of ``seed``. (H, W) or
    (H, W, 1) only."""
    lib = _load()
    x = _owned_f32(x)
    if not (x.ndim == 2 or (x.ndim == 3 and x.shape[-1] == 1)):
        raise ValueError(f"weak_augment handles (H, W) / (H, W, 1) images, got {x.shape}; "
                         "use the numpy Compose recipe for multi-channel input")
    h, w = x.shape[:2]
    scratch = np.empty(2 * h * w, dtype=np.float32)
    lib.pda_weak_augment(x.reshape(-1), h, w, p, blur_sigma[0], blur_sigma[1], noise[0],
                         noise[1], seed, scratch)
    return x


def elastic_warp(x: np.ndarray, dy: np.ndarray, dx: np.ndarray, order: int = 1) -> np.ndarray:
    """``out(y, x) = in(y + dy, x + dx)``, scipy's ``reflect`` borders;
    order 1 bilinear, 0 nearest."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    plane = _plane_2d(x, "elastic_warp")
    dy = np.ascontiguousarray(dy, dtype=np.float32)
    dx = np.ascontiguousarray(dx, dtype=np.float32)
    if dy.shape != plane.shape or dx.shape != plane.shape:
        raise ValueError(f"elastic_warp: fields {dy.shape}, {dx.shape} for a {plane.shape} plane")
    out = np.empty_like(x)
    lib.pda_elastic_warp(plane, out.reshape(plane.shape), plane.shape[0], plane.shape[1], dy,
                         dx, order)
    return out


def field_upsample(coarse: np.ndarray, h: int, w: int) -> np.ndarray:
    """A coarse (gh, gw) grid bilinearly upsampled to (h, w)."""
    lib = _load()
    coarse = np.ascontiguousarray(coarse, dtype=np.float32)
    if coarse.ndim != 2 or min(coarse.shape) < 2:
        raise ValueError(f"field_upsample: a grid of at least 2 x 2, got {coarse.shape}")
    out = np.empty((h, w), dtype=np.float32)
    lib.pda_field_upsample(coarse, coarse.shape[0], coarse.shape[1], h, w, out)
    return out


class NativeWeakAugmentation:
    """The weak recipe (standardize, then blur and noise each with
    probability ``p``) as one C call a sample, seeded by one
    ``rng.integers(1, 2**63 - 1)``. Multi-channel samples take the numpy
    ``Compose`` of the same recipe."""

    def __init__(self, p: float = 0.25, blur_sigma=(0.0, 3.0), noise=(0.0, 0.15)):
        self.p = p
        self.blur_sigma = blur_sigma
        self.noise = noise
        self._numpy = None

    def _compose(self):
        if self._numpy is None:
            from . import transforms as t

            self._numpy = t.Compose(
                t.standardize,
                t.RandomApply([t.GaussianBlur(sigma=self.blur_sigma)], p=self.p),
                t.RandomApply([t.AdditiveGaussianNoise(scale=self.noise, clip_kwargs=False)],
                              p=self.p),
            )
        return self._numpy

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if not (x.ndim == 2 or (x.ndim == 3 and x.shape[-1] == 1)):
            return self._compose()(x, rng)
        seed = int(rng.integers(1, 2**63 - 1))
        return weak_augment(x, p=self.p, blur_sigma=self.blur_sigma, noise=self.noise, seed=seed)
