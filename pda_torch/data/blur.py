"""OpenCV's ``cv2.GaussianBlur(src, (0, 0), sigma)`` for float32, in numpy.

``pda`` blurs its augmentation views with ``cv2.GaussianBlur``. The port
computes the same floats here, so that the card machine needs no OpenCV.
:func:`gaussian_blur` takes a float32 ``(H, W)`` or ``(H, W, C)`` array
(channels interleaved, as cv2 holds them) and follows OpenCV 5.0's float
path for the x86-64 build with AVX2/FMA dispatch, in its arithmetic:

  kernel      ``n = round(8 * sigma + 1) | 1`` taps (round half to even);
              ``getGaussianKernel``'s coefficients: ``exp(-x^2 / (2 sigma^2))``
              in double, normalised by the sum of the outer half twice plus
              one, each cast to float32
  borders     ``BORDER_REFLECT_101``, repeated for kernels longer than the axis
  order       rows, then columns (the row-filtered image is reflected again)
  one pixel   a 1-pixel axis is not filtered along (1 x 1 returns a copy);
              a 1-tap kernel (sigma < 1/16) returns a copy
  rows        n > 5: ``sum_t k[t] * x[j + t]`` in tap order, fused
              multiply-adds in float32 for the first ``4 * (len // 4)``
              elements of the interleaved row; the rest multiply and add
              apart, except the last ``(n - 1) % 4`` taps, which are fused.
              n = 3 or 5: pairs of elements as
              ``fma(x, k0, (l1 + r1) * k1)`` (then ``+ (l2 + r2) * k2``
              fused); an odd last element as ``fma(l1 + r1, k1, x * k0)``
              (n = 3) or unfused (n = 5)
  columns     symmetric: ``x * k0``, then ``(up_t + down_t) * k_t`` fused
              for the first ``8 * (len // 8)`` elements of the row (all of
              them for n = 3), unfused for the rest

A fused multiply-add is computed in float64 (the float32 product is exact
there) and rounded once to float32; where that sum falls exactly on a
float32 tie, its rounding error (TwoSum) decides the side. Bit for bit
``cv2.GaussianBlur`` of OpenCV 5.0.0 on an AVX-512 x86-64 host for sizes 1 to
300, sigma in (0, 4] and 1 or 3 channels (``tests/test_torch_blur.py``).
OpenCV built for another instruction set orders its sums otherwise and
differs by rounding (a few float32 ulps of the largest value).
``pda``'s native ``gaussian_blur`` is a second account of the same function.
"""

from __future__ import annotations

import numpy as np

_TIE = np.int64(1 << 28)  # float64 low mantissa bits of a float32 tie
_LOW = np.int64((1 << 29) - 1)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(round(8 * sigma + 1) | 1, sigma, CV_32F)``."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    half = (n - 1) // 2
    scale = -0.125 / (float(sigma) * float(sigma))
    # x runs over the half-integer grid doubled, as OpenCV's bit-exact kernel
    values = [float(np.exp(float(x * x) * scale)) for x in range(1 - n, 0, 2)]
    total = 0.0
    for v in values:
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    k = np.empty(n)
    k[half] = mul
    for i, v in enumerate(values):
        k[i] = k[n - 1 - i] = v * mul
    return k.astype(np.float32)


def _fma(a: np.ndarray, b: np.float32, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once."""
    p = a.astype(np.float64) * np.float64(b)
    s = p + c
    out = s.astype(np.float32)
    tie = (s.view(np.int64) & _LOW) == _TIE
    if tie.any():
        pt, st = p[tie], s[tie]
        ct = np.broadcast_to(np.asarray(c, np.float64), s.shape)[tie]
        back = st - pt
        err = (pt - (st - back)) + (ct - back)
        out[tie] = np.nextafter(st, st + err).astype(np.float32)
    return out


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i < n, i, period - i)


def _rows(x: np.ndarray, k: np.ndarray, cn: int) -> np.ndarray:
    """The row pass over ``(rows, W * cn)`` interleaved rows."""
    rows, wc = x.shape
    w, n = wc // cn, len(k)
    r = n // 2
    ext = x.reshape(rows, w, cn)[:, _reflect101(np.arange(-r, w + r), w)]
    ext = ext.reshape(rows, (w + 2 * r) * cn)

    def tap(t, lo=0, hi=wc):  # the source under tap t (t = 0: leftmost)
        return ext[:, t * cn + lo: t * cn + hi]

    if n <= 5:
        def pair(t, lo=0, hi=wc):
            return tap(r - t, lo, hi) + tap(r + t, lo, hi)

        even = wc // 2 * 2
        out = _fma(tap(r), k[r], pair(1) * k[r + 1])
        if n == 5:
            out = _fma(pair(2), k[r + 2], out)
        if even < wc and n == 3:
            out[:, even:] = _fma(pair(1, even), k[2], tap(1, even) * k[1])
        elif even < wc:
            out[:, even:] = (tap(2, even) * k[2] + pair(1, even) * k[3]) + pair(2, even) * k[4]
        return out

    out = np.empty((rows, wc), np.float32)
    cut = wc // 4 * 4
    if cut:
        acc = np.zeros((rows, cut), np.float32)
        for t in range(n):
            acc = _fma(tap(t, 0, cut), k[t], acc)
        out[:, :cut] = acc
    if cut < wc:
        fused_from = n - (n - 1) % 4
        acc = tap(0, cut) * k[0]
        for t in range(1, n):
            acc = (_fma(tap(t, cut), k[t], acc) if t >= fused_from
                   else acc + tap(t, cut) * k[t])
        out[:, cut:] = acc
    return out


def _columns(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The column pass over ``(H, W * cn)``."""
    h, wc = x.shape
    n = len(k)
    r = n // 2
    ext = x[_reflect101(np.arange(-r, h + r), h)]

    def pair(t, lo, hi):
        return ext[r - t: r - t + h, lo:hi] + ext[r + t: r + t + h, lo:hi]

    out = np.empty((h, wc), np.float32)
    cut = wc if n == 3 else wc // 8 * 8
    if cut:
        acc = ext[r: r + h, :cut] * k[r]
        for t in range(1, r + 1):
            acc = _fma(pair(t, 0, cut), k[r + t], acc)
        out[:, :cut] = acc
    if cut < wc:
        acc = ext[r: r + h, cut:] * k[r]
        for t in range(1, r + 1):
            acc = acc + pair(t, cut, wc) * k[r + t]
        out[:, cut:] = acc
    return out


def gaussian_blur(src: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(src, (0, 0), sigma)`` of a float32 ``(H, W)`` or
    ``(H, W, C)`` array, ``sigma > 0``; the result has ``src``'s shape."""
    if not sigma > 0:
        raise ValueError(f"gaussian_blur: sigma must be > 0, got {sigma}")
    src = np.ascontiguousarray(src, dtype=np.float32)
    if src.ndim not in (2, 3):
        raise ValueError(f"gaussian_blur: (H, W) or (H, W, C) input, got {src.shape}")
    h, w = src.shape[:2]
    cn = 1 if src.ndim == 2 else src.shape[2]
    k = gaussian_kernel(sigma)
    if len(k) == 1 or (h == 1 and w == 1):
        return src.copy()
    x = src.reshape(h, w * cn)
    if w > 1:
        x = _rows(x, k, cn)
    if h > 1:
        x = _columns(x, k)
    return x.reshape(src.shape)
