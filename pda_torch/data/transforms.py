"""Host-side numpy transforms and augmentations (port of
``pda/data/transforms.py``, its numpy path).

``standardize``, ``normalize``, ``Compose``, ``RandomApply``,
``GaussianBlur``, ``AdditiveGaussianNoise``, ``RandomContrast``,
``get_raw_transform``, the joint geometric augmentations
(``get_augmentations(ndim=2)``) and the label transforms. All are numpy
(OpenCV's blur where ``cv2`` imports, scipy's otherwise, as in ``pda``),
operate on float32 ``(H, W)`` or ``(H, W, C)`` arrays and take an explicit
``numpy.random.Generator``. ``pda`` runs some of them through its native C
library when that is built; the port has no such library, and these
functions compute what ``pda``'s numpy path computes.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
# imported here, not at first use as in ``pda``: a loader's worker process
# then pays for it when it starts, not at its first blur or warp in a timed loop
from scipy.ndimage import gaussian_filter, map_coordinates

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover - OpenCV is optional
    _HAS_CV2 = False

EPS = 1e-7


def standardize(x: np.ndarray, mean: Optional[float] = None, std: Optional[float] = None,
                eps: float = EPS) -> np.ndarray:
    """(x - mean) / (std + eps), the statistics of ``x`` where not given
    (torch_em ``standardize``)."""
    x = np.asarray(x, dtype=np.float32)
    mean = x.mean() if mean is None else mean
    x = x - mean
    std = x.std() if std is None else std
    return x / (std + eps)


def normalize(x: np.ndarray, eps: float = EPS) -> np.ndarray:
    """Min-max to [0, 1]."""
    x = np.asarray(x, dtype=np.float32)
    x = x - x.min()
    return x / (x.max() + eps)


class Compose:
    def __init__(self, *transforms: Callable):
        self.transforms = transforms

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        for t in self.transforms:
            x = _call(t, x, rng)
        return x


def _takes_rng(t: Callable) -> bool:
    """Whether the transform takes the rng: it has a parameter named ``rng``
    (every random transform here does)."""
    try:
        sig = inspect.signature(t)
    except (TypeError, ValueError):
        return True
    return "rng" in sig.parameters


def _call(t: Callable, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return t(x, rng) if _takes_rng(t) else t(x)


class RandomApply:
    """Apply the transforms, in order, with probability p."""

    def __init__(self, transforms: Sequence[Callable], p: float = 0.5):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.random() < self.p:
            for t in self.transforms:
                x = _call(t, x, rng)
        return x


class GaussianBlur:
    """Gaussian blur of the spatial axes with a uniformly drawn sigma."""

    def __init__(self, kernel_size=None, sigma: Tuple[float, float] = (0.0, 3.0)):
        self.sigma = sigma

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        sigma = rng.uniform(*self.sigma)
        if sigma <= 0:
            return x
        if _HAS_CV2:
            squeeze = x.ndim == 3 and x.shape[-1] == 1
            src = x[..., 0] if squeeze else x
            out = cv2.GaussianBlur(np.ascontiguousarray(src, dtype=np.float32), (0, 0), sigma)
            return out[..., None] if squeeze else out
        return gaussian_filter(x, (sigma, sigma) + (0,) * (x.ndim - 2))


class AdditiveGaussianNoise:
    """Additive noise with a uniformly drawn standard deviation."""

    def __init__(self, scale: Tuple[float, float] = (0.0, 0.3), clip_kwargs=False):
        self.scale = scale
        self.clip_kwargs = clip_kwargs

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        std = rng.uniform(*self.scale)
        out = x + rng.normal(0.0, std, size=x.shape).astype(np.float32)
        if self.clip_kwargs:
            out = np.clip(out, 0.0, 1.0)
        return out


class RandomContrast:
    """mean + alpha * (x - mean) with a uniformly drawn alpha."""

    def __init__(self, alpha: Tuple[float, float] = (0.8, 1.2), mean: Optional[float] = None,
                 clip_kwargs=False):
        self.alpha = alpha
        self.mean = mean
        self.clip_kwargs = clip_kwargs

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        alpha = rng.uniform(*self.alpha)
        mean = x.mean() if self.mean is None else self.mean
        out = mean + alpha * (x - mean)
        if self.clip_kwargs:
            out = np.clip(out, 0.0, 1.0)
        return out


def get_raw_transform(normalizer: Callable = standardize,
                      augmentation1: Optional[Callable] = None,
                      augmentation2: Optional[Callable] = None) -> Callable:
    """torch_em's ``get_raw_transform``: augmentation1 on the raw data, then
    the normalizer, then augmentation2."""

    def transform(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if augmentation1 is not None:
            x = _call(augmentation1, x, rng)
        x = normalizer(x)
        if augmentation2 is not None:
            x = _call(augmentation2, x, rng)
        return x

    return transform


class JointAugmentations:
    """The same random quarter turn, flips and (with probability
    ``p_elastic``) elastic warp for every array of a (raw, label[, mask])
    tuple. The raw warps bilinearly, every other array nearest-neighbour, so
    binary maps stay binary. The displacement field is coarse noise on a grid
    of spacing ``sigma``, bilinearly upsampled and scaled so that ``alpha``
    is its largest displacement in pixels."""

    def __init__(self, ndim: int = 2, p_flip: float = 0.5, p_elastic: float = 0.25,
                 alpha: float = 8.0, sigma: float = 16.0):
        assert ndim == 2, "only 2D supported"
        self.p_flip = p_flip
        self.p_elastic = p_elastic
        self.alpha = alpha
        self.sigma = sigma

    def _field(self, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
        step = max(int(self.sigma), 2)
        gh, gw = h // step + 3, w // step + 3
        coarse = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h, dtype=np.float32)
        xs = np.linspace(0, gw - 1.001, w, dtype=np.float32)
        y0, x0 = ys.astype(np.int32), xs.astype(np.int32)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        c00, c01 = coarse[y0][:, x0], coarse[y0][:, x0 + 1]
        c10, c11 = coarse[y0 + 1][:, x0], coarse[y0 + 1][:, x0 + 1]
        return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
                + c10 * fy * (1 - fx) + c11 * fy * fx)

    def _elastic(self, arrays, rng: np.random.Generator):
        h, w = arrays[0].shape[:2]
        dy, dx = self._field(h, w, rng), self._field(h, w, rng)
        norm = max(np.abs(dy).max(), np.abs(dx).max(), 1e-8)
        dy, dx = dy * (self.alpha / norm), dx * (self.alpha / norm)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        coords = np.stack([yy + dy, xx + dx])

        def warp2d(a, order):
            return map_coordinates(a, coords, order=order, mode="reflect")

        out = []
        for i, a in enumerate(arrays):
            order = 1 if i == 0 else 0
            if a.ndim == 2:
                warped = warp2d(a, order)
            else:
                warped = np.stack([warp2d(a[..., c], order) for c in range(a.shape[-1])],
                                  axis=-1)
            out.append(warped.astype(a.dtype, copy=False))
        return out

    def __call__(self, arrays: Sequence[np.ndarray], rng: np.random.Generator):
        h0, w0 = arrays[0].shape[:2]
        # odd quarter turns of a non-square patch would make samples unstackable
        k = int(rng.integers(0, 4)) if h0 == w0 else 2 * int(rng.integers(0, 2))
        flip_h = rng.random() < self.p_flip
        flip_v = rng.random() < self.p_flip
        do_elastic = self.p_elastic > 0 and rng.random() < self.p_elastic
        out = []
        for a in arrays:
            if k:
                a = np.rot90(a, k, axes=(0, 1))
            if flip_h:
                a = a[:, ::-1]
            if flip_v:
                a = a[::-1, :]
            out.append(np.ascontiguousarray(a))
        if do_elastic:
            out = self._elastic(out, rng)
        return tuple(out)


def get_augmentations(ndim: int = 2, p_flip: float = 0.5, p_elastic: float = 0.25) -> Callable:
    """torch_em's ``transform.get_augmentations(ndim=2)``: see
    :class:`JointAugmentations`."""
    return JointAugmentations(ndim=ndim, p_flip=p_flip, p_elastic=p_elastic)


def labels_to_binary(labels: np.ndarray) -> np.ndarray:
    """Instance labels -> binary foreground."""
    return (np.asarray(labels) > 0).astype(np.float32)


def boundary_transform(labels: np.ndarray) -> np.ndarray:
    """Instance labels -> boundary map: a pixel is boundary if a 4-neighbour
    carries another id."""
    lab = np.asarray(labels)
    b = np.zeros(lab.shape, dtype=bool)
    b[:-1, :] |= lab[:-1, :] != lab[1:, :]
    b[1:, :] |= lab[1:, :] != lab[:-1, :]
    b[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    b[:, 1:] |= lab[:, 1:] != lab[:, :-1]
    return b.astype(np.float32)


def affinity_transform(labels: np.ndarray, offsets=((0, 1), (1, 0))) -> np.ndarray:
    """Instance labels -> affinity channels, channel last: 1 where the two
    ends of an offset edge carry the same label (background pairs included),
    0 on edges that leave the image."""
    lab = np.asarray(labels)
    chans = []
    for dy, dx in offsets:
        aff = np.zeros(lab.shape, dtype=np.float32)
        h, w = lab.shape[:2]
        src = lab[max(0, -dy): h - max(0, dy), max(0, -dx): w - max(0, dx)]
        dst = lab[max(0, dy): h + min(0, dy) or h, max(0, dx): w + min(0, dx) or w]
        aff[max(0, -dy): h - max(0, dy), max(0, -dx): w - max(0, dx)] = src == dst
        chans.append(aff)
    return np.stack(chans, axis=-1)


def _affinity_mask(shape, offsets) -> np.ndarray:
    """1 where both ends of an offset edge lie in the image, per channel."""
    h, w = shape[:2]
    chans = []
    for dy, dx in offsets:
        m = np.zeros((h, w), dtype=np.float32)
        m[max(0, -dy): h - max(0, dy), max(0, -dx): w - max(0, dx)] = 1.0
        chans.append(m)
    return np.stack(chans, axis=-1)


class BoundaryTransform:
    """Instance labels -> boundary map, with the binary foreground as a first
    channel when ``add_binary_target``."""

    def __init__(self, add_binary_target: bool = False):
        self.add_binary_target = add_binary_target

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        b = boundary_transform(labels)[..., None]
        if not self.add_binary_target:
            return b
        return np.concatenate([labels_to_binary(labels)[..., None], b], axis=-1)


class AffinityTransform:
    """Instance labels -> [binary? | affinities | masks?], channel last; with
    ``add_mask`` the binary channel's mask (all ones) leads the mask block."""

    def __init__(self, offsets, add_binary_target: bool = False, add_mask: bool = False):
        self.offsets = tuple(tuple(o) for o in offsets)
        self.add_binary_target = add_binary_target
        self.add_mask = add_mask

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels)
        parts = [affinity_transform(labels, self.offsets)]
        if self.add_binary_target:
            parts.insert(0, labels_to_binary(labels)[..., None])
        if self.add_mask:
            mask = _affinity_mask(labels.shape, self.offsets)
            if self.add_binary_target:
                ones = np.ones(labels.shape[:2] + (1,), dtype=np.float32)
                mask = np.concatenate([ones, mask], axis=-1)
            parts.append(mask)
        return np.concatenate(parts, axis=-1)


def select_label_transform(offsets=None, boundaries: bool = False, binary: bool = False):
    """``(label_transform, label_transform2)`` for at most one of ``offsets``,
    ``boundaries`` or ``binary``: affinities run after the joint
    augmentation (``label_transform2``), so flips cannot mis-orient them;
    boundaries and the binary map before it."""
    assert sum((offsets is not None, bool(boundaries), bool(binary))) <= 1, (
        "pass at most one of offsets= / boundaries= / binary=")
    if offsets is not None:
        return None, AffinityTransform(offsets, add_binary_target=True, add_mask=True)
    if boundaries:
        return BoundaryTransform(add_binary_target=True), None
    if binary:
        return labels_to_binary, None
    return None, None
