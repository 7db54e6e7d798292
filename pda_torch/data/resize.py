"""OpenCV's ``cv2.resize`` for ``INTER_AREA`` and ``INTER_NEAREST``, in numpy.

``pda`` prepares the Montgomery and NIH radiographs with ``cv2.resize``:
``INTER_AREA`` for the images, ``INTER_NEAREST`` for the masks. The port
computes the same bytes here, so that the card machine needs no OpenCV.
:func:`resize` takes a 2D uint8 or uint16 array and ``dsize = (width,
height)``, as cv2 does, and follows OpenCV's own (non-IPP) code paths, in
its arithmetic:

  INTER_NEAREST   source index ``floor(x * (1 / (dst / src)))`` in double,
                  clamped to the last row or column (not
                  ``INTER_NEAREST_EXACT``)
  INTER_AREA      - both factors integers ("fast area"): ``(sum + 2) >> 2``
                    of the block's integer sum for 2x2 blocks, else
                    ``rint(float32(sum) * float32(1 / area))``, the sum an
                    int for uint8 and, for uint16, a float32 that takes the
                    block in row-major order four pixels at a time;
                  - both factors >= 1 otherwise: per-pixel area weights
                    (``computeResizeAreaTab``) summed along each row in
                    float32, then the rows weighted and summed in float32,
                    rounded half to even and saturated;
                  - any factor < 1 (up-scaling on either axis): the bilinear
                    resampler with area coefficients on both axes, fixed
                    point (11 fractional bits) for uint8, float32 for uint16

The same size returns a copy. Any other dtype, dimensionality or
interpolation raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

INTER_NEAREST = 0
INTER_AREA = 3

_DBL_EPSILON = np.finfo(np.float64).eps
_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _saturate(x: np.ndarray, dtype) -> np.ndarray:
    """saturate_cast<dtype>(float): round half to even, then clamp."""
    info = np.iinfo(dtype)
    return np.clip(np.rint(x), info.min, info.max).astype(dtype)


def _nearest(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w = src.shape
    ifx, ify = 1.0 / (dw / w), 1.0 / (dh / h)
    xs = np.minimum(np.floor(np.arange(dw) * ifx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * ify).astype(np.int64), h - 1)
    return src[ys[:, None], xs[None, :]]


def _area_fast(src: np.ndarray, dw: int, dh: int, sx: int, sy: int) -> np.ndarray:
    """resizeAreaFast_ over whole sy x sx blocks (the source is then a
    multiple of the block in each axis)."""
    blocks = src.astype(np.int64).reshape(dh, sy, dw, sx)
    if sx == 2 and sy == 2:
        return ((blocks.sum(axis=(1, 3)) + 2) >> 2).astype(src.dtype)
    area = sx * sy
    scale = np.float32(1.0) / np.float32(area)
    if src.dtype == np.uint8:  # an int sum
        return _saturate(blocks.sum(axis=(1, 3)).astype(np.float32) * scale, src.dtype)
    # uint16 sums in float32 over the block in row-major order: four pixels'
    # int sum at a time, then the rest one by one
    taps = blocks.transpose(0, 2, 1, 3).reshape(dh, dw, area)
    total = np.zeros((dh, dw), np.float32)
    for k in range(0, area - area % 4, 4):
        total += taps[..., k:k + 4].sum(axis=-1).astype(np.float32)
    for k in range(area - area % 4, area):
        total += taps[..., k].astype(np.float32)
    return _saturate(total * scale, src.dtype)


def _area_tab(ssize: int, dsize: int, scale: float):
    """computeResizeAreaTab: per destination index, its source indices and
    float32 weights in OpenCV's order, padded (index 0, weight 0) to one
    width."""
    rows = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    width = max(len(t) for t in rows)
    idx = np.zeros((dsize, width), np.int64)
    wgt = np.zeros((dsize, width), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            idx[d, k], wgt[d, k] = s, np.float32(a)
    return idx, wgt


def _area(src: np.ndarray, dw: int, dh: int, scale_x: float, scale_y: float) -> np.ndarray:
    """ResizeArea_Invoker: each source row's taps summed in float32 in
    order, then each destination row's weighted source rows in order."""
    xi, xw = _area_tab(src.shape[1], dw, scale_x)
    yi, yw = _area_tab(src.shape[0], dh, scale_y)
    s = src.astype(np.float32)
    buf = np.zeros((src.shape[0], dw), np.float32)
    for k in range(xi.shape[1]):
        buf += s[:, xi[:, k]] * xw[:, k]
    acc = np.zeros((dh, dw), np.float32)
    for k in range(yi.shape[1]):
        acc += yw[:, k, None] * buf[yi[:, k]]
    return _saturate(acc, src.dtype)


def _linear_coefs(ssize: int, dsize: int, scale: float, inv_scale: float, clamp: bool):
    """The area-mode bilinear taps: (first index, weight of the second,
    whether the second tap is read) per destination index; OpenCV clamps
    the columns' taps at the last column, not the rows'."""
    d = np.arange(dsize)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    if not clamp:
        return s, f, None
    last = s >= ssize - 1
    f = np.where(last, np.float32(0), f).astype(np.float32)
    s = np.where(last, ssize - 1, s)
    # columns from the first whose second tap falls off the end read one tap
    off = np.nonzero(s + 1 >= ssize)[0]
    two = d < (off[0] if len(off) else dsize)
    return s, f, two


def _area_up(src: np.ndarray, dw: int, dh: int, scale_x: float, scale_y: float,
             inv_x: float, inv_y: float) -> np.ndarray:
    """resizeGeneric_ with HResizeLinear/VResizeLinear and area coefficients."""
    h, w = src.shape
    sx, fx, two = _linear_coefs(w, dw, scale_x, inv_x, True)
    sy, fy, _ = _linear_coefs(h, dh, scale_y, inv_y, False)
    sx1 = np.minimum(sx + 1, w - 1)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    if src.dtype == np.uint8:
        def fixed(c):  # saturate_cast<short>(c * INTER_RESIZE_COEF_SCALE)
            return _saturate(c * np.float32(_COEF_SCALE), np.int16).astype(np.int64)

        ax0, ax1 = fixed(np.float32(1) - fx), fixed(fx)
        by0, by1 = fixed(np.float32(1) - fy), fixed(fy)
        s = src.astype(np.int64)
        row = np.where(two, s[:, sx] * ax0 + s[:, sx1] * ax1, s[:, sx] * _COEF_SCALE)
        r0, r1 = row[y0] >> 4, row[y1] >> 4
        out = (((by0[:, None] * r0) >> 16) + ((by1[:, None] * r1) >> 16) + 2) >> 2
        return out.astype(np.uint8)
    ax0, ax1 = np.float32(1) - fx, fx
    by0, by1 = np.float32(1) - fy, fy
    s = src.astype(np.float32)
    row = np.where(two, s[:, sx] * ax0 + s[:, sx1] * ax1, s[:, sx])
    return _saturate(row[y0] * by0[:, None] + row[y1] * by1[:, None], src.dtype)


def resize(src, dsize: Tuple[int, int], interpolation: int = INTER_AREA) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=interpolation)`` for a 2D
    uint8 or uint16 ``src``, ``dsize = (width, height)`` and
    ``INTER_AREA`` or ``INTER_NEAREST``."""
    src = np.asarray(src)
    if src.ndim != 2 or src.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"resize takes a 2D uint8 or uint16 array, got {src.dtype} "
                         f"{src.shape}")
    if interpolation not in (INTER_AREA, INTER_NEAREST):
        raise ValueError(f"interpolation {interpolation} is not INTER_AREA ({INTER_AREA}) "
                         f"or INTER_NEAREST ({INTER_NEAREST})")
    dw, dh = (int(v) for v in dsize)
    h, w = src.shape
    if dw <= 0 or dh <= 0 or h == 0 or w == 0:
        raise ValueError(f"dsize {dsize} or the source shape {src.shape} is empty")
    if (dh, dw) == (h, w):
        return src.copy()
    if interpolation == INTER_NEAREST:
        return _nearest(src, dw, dh)
    inv_x, inv_y = dw / w, dh / h
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    ix, iy = round(scale_x), round(scale_y)
    if scale_x >= 1 and scale_y >= 1:
        if abs(scale_x - ix) < _DBL_EPSILON and abs(scale_y - iy) < _DBL_EPSILON:
            return _area_fast(src, dw, dh, ix, iy)
        return _area(src, dw, dh, scale_x, scale_y)
    return _area_up(src, dw, dh, scale_x, scale_y, inv_x, inv_y)
