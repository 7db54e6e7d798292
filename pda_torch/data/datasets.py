"""2D patch datasets held in memory or read from image files (port of
``pda/data/datasets.py``, its 2D part):

  ImageCollectionDataset        -> (x, y) or (x, y, consensus)
  DualImageCollectionDataset    -> (x, aug1(x), aug2(x), y)
  DualRawImageCollectionDataset -> (x, aug1(x), aug2(x), dummy_y)   (unlabeled)
  ConcatDataset                 -> the samples of several datasets in turn

Samples are channel-last ``(H, W, C)`` float32 numpy arrays, so a batch
stacks to NHWC; the trainer moves it to the card. Randomness is an explicit
``numpy.random.Generator`` handed in per sample (``sample(index, rng)``), so
a loader with workers stays deterministic. The rejection loop (at most 500
attempts) crops every array of a sample, the consensus mask included. Images
are numpy arrays or file paths (read with imageio, imported on first use).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from .transforms import get_augmentations, standardize

ArrayOrPath = Union[str, np.ndarray]

MAX_SAMPLING_ATTEMPTS = 500


def load_image(path_or_array: ArrayOrPath) -> np.ndarray:
    if isinstance(path_or_array, np.ndarray):
        return path_or_array
    import imageio.v3 as imageio

    return np.asarray(imageio.imread(path_or_array))


def _ensure_hwc(x: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(H, W) -> (H, W, 1); a channel-first 3D array (an axis below 16 first,
    one of 16 or more last) -> channel-last."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = x[..., None]
    elif x.ndim == 3 and x.shape[-1] >= 16 and x.shape[0] < 16:
        x = np.moveaxis(x, 0, -1)
    return np.ascontiguousarray(x, dtype=dtype)


class MinForegroundSampler:
    """Accept a patch whose label foreground share exceeds ``min_fraction``."""

    def __init__(self, min_fraction: float, background_id: int = 0):
        self.min_fraction = min_fraction
        self.background_id = background_id

    def __call__(self, raw: np.ndarray, labels: np.ndarray) -> bool:
        return np.mean(labels != self.background_id) > self.min_fraction


class _PatchDatasetBase:
    """Random crops shared by the patch datasets. ``label_transform2`` (or
    None) runs on the labels after the joint augmentation, so
    direction-sensitive targets see the augmented geometry."""

    label_transform2 = None

    def __init__(self, patch_shape: Tuple[int, int], *, n_samples: Optional[int] = None,
                 n_images: int = 0, sampler: Optional[Callable] = None, seed: int = 0):
        assert len(patch_shape) == 2
        self.patch_shape = tuple(patch_shape)
        self.sampler = sampler
        self.seed = seed
        self.sample_random_index = n_samples is not None
        self._len = n_samples if n_samples is not None else n_images
        self._cache: OrderedDict = OrderedDict()
        #: images kept decoded (LRU); PDA_IMAGE_CACHE sets it, 0 disables
        self._cache_max = int(os.environ.get("PDA_IMAGE_CACHE", "256"))

    def _apply_label_transform2(self, labels):
        if self.label_transform2 is None:
            return labels
        return np.asarray(self.label_transform2(np.squeeze(labels)), dtype=np.float32)

    def _load(self, item) -> np.ndarray:
        if isinstance(item, np.ndarray):
            return item
        cached = self._cache.get(item)
        if cached is not None:
            self._cache.move_to_end(item)
            return cached
        img = load_image(item)
        if self._cache_max > 0:
            self._cache[item] = img
            while len(self._cache) > self._cache_max:
                self._cache.popitem(last=False)
        return img

    def __len__(self) -> int:
        return self._len

    @property
    def ndim(self) -> int:
        return 2

    def _bounding_box(self, shape, rng: np.random.Generator):
        if any(sh < psh for sh, psh in zip(shape, self.patch_shape)):
            raise ValueError(f"Image shape {shape} smaller than patch shape {self.patch_shape}")
        # the largest start is drawable, so the last row and column can be cropped
        starts = [int(rng.integers(0, sh - psh, endpoint=True)) if sh - psh > 0 else 0
                  for sh, psh in zip(shape, self.patch_shape)]
        return tuple(slice(s, s + p) for s, p in zip(starts, self.patch_shape))

    def _crop_with_rejection(self, arrays: Sequence[np.ndarray], rng):
        """The same random window of every array, drawn again while the
        sampler rejects (raw, label)."""
        shape = arrays[0].shape[:2]
        if self.sampler is not None and len(arrays) < 2:
            raise ValueError("sampler-based patch rejection needs (raw, labels) pairs; "
                             "this dataset yields raw-only samples — drop the sampler")
        for _ in range(MAX_SAMPLING_ATTEMPTS):
            bb = self._bounding_box(shape, rng)
            patches = [np.array(a[bb]) for a in arrays]
            if self.sampler is None or self.sampler(patches[0], patches[1]):
                return patches
        raise RuntimeError(f"Could not sample a valid patch in {MAX_SAMPLING_ATTEMPTS} attempts")

    def _image_index(self, index: int, rng: np.random.Generator, n: int) -> int:
        if self.sample_random_index:
            index = int(rng.integers(0, n))
        return index % n

    def sample(self, index: int, rng: np.random.Generator):
        raise NotImplementedError

    def __getitem__(self, index: int):
        return self.sample(index, np.random.default_rng((self.seed, index)))


def _check_pairs(raw_images, label_images) -> None:
    if len(raw_images) != len(label_images):
        raise ValueError(f"Expect same number of raw and label images, got "
                         f"{len(raw_images)} and {len(label_images)}")


class ImageCollectionDataset(_PatchDatasetBase):
    """(raw, label[, consensus]) random crops."""

    def __init__(self, raw_images: Sequence[ArrayOrPath], label_images: Sequence[ArrayOrPath],
                 consensus_masks: Optional[Sequence[ArrayOrPath]] = None, *,
                 patch_shape: Tuple[int, int], raw_transform: Optional[Callable] = standardize,
                 label_transform: Optional[Callable] = None,
                 label_transform2: Optional[Callable] = None,
                 transform: Optional[Callable] = None, n_samples: Optional[int] = None,
                 sampler: Optional[Callable] = None, seed: int = 0):
        _check_pairs(raw_images, label_images)
        if consensus_masks is not None:
            assert len(consensus_masks) == len(raw_images)
        super().__init__(patch_shape, n_samples=n_samples, n_images=len(raw_images),
                         sampler=sampler, seed=seed)
        self.raw_images = list(raw_images)
        self.label_images = list(label_images)
        self.consensus_masks = list(consensus_masks) if consensus_masks else None
        self.raw_transform = raw_transform
        self.label_transform = label_transform
        self.label_transform2 = label_transform2
        self.transform = transform if transform is not None else get_augmentations(2)

    def sample(self, index: int, rng: np.random.Generator):
        index = self._image_index(index, rng, len(self.raw_images))
        arrays = [self._load(self.raw_images[index]), self._load(self.label_images[index])]
        if self.consensus_masks is not None:
            arrays.append(self._load(self.consensus_masks[index]))
        patches = self._crop_with_rejection(arrays, rng)
        raw, labels = patches[0].astype(np.float32), patches[1]
        consensus = patches[2] if len(patches) == 3 else None
        if self.label_transform is not None:
            labels = self.label_transform(labels)
        labels = np.asarray(labels, dtype=np.float32)
        if self.transform is not None:
            joined = [raw, labels] + ([consensus] if consensus is not None else [])
            out = self.transform(joined, rng)
            raw, labels = out[0], out[1]
            consensus = out[2] if consensus is not None else None
        labels = self._apply_label_transform2(labels)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        raw, labels = _ensure_hwc(raw), _ensure_hwc(labels)
        if consensus is None:
            return raw, labels
        return raw, labels, _ensure_hwc(consensus)


def _two_views(raw, aug1, aug2, rng):
    """Two augmented copies of the (not yet normalized) raw patch; the weak
    and strong recipes begin with their own normalizer."""
    raw1, raw2 = raw.copy(), raw.copy()
    if aug1 is not None:
        raw1 = aug1(raw1, rng)
    if aug2 is not None:
        raw2 = aug2(raw2, rng)
    return raw1, raw2


class DualImageCollectionDataset(_PatchDatasetBase):
    """Two-view (weak/strong) patches: (x, aug1(x), aug2(x), y), x the
    normalized raw patch; without augmentations a plain (x, y)."""

    def __init__(self, raw_images: Sequence[ArrayOrPath], label_images: Sequence[ArrayOrPath],
                 *, patch_shape: Tuple[int, int], raw_transform: Optional[Callable] = standardize,
                 label_transform: Optional[Callable] = None,
                 label_transform2: Optional[Callable] = None,
                 augmentation1: Optional[Callable] = None,
                 augmentation2: Optional[Callable] = None, transform: Optional[Callable] = None,
                 n_samples: Optional[int] = None, sampler: Optional[Callable] = None,
                 seed: int = 0):
        _check_pairs(raw_images, label_images)
        super().__init__(patch_shape, n_samples=n_samples, n_images=len(raw_images),
                         sampler=sampler, seed=seed)
        self.raw_images = list(raw_images)
        self.label_images = list(label_images)
        self.raw_transform = raw_transform
        self.label_transform = label_transform
        self.label_transform2 = label_transform2
        self.augmentation1 = augmentation1
        self.augmentation2 = augmentation2
        self.transform = transform if transform is not None else get_augmentations(2)

    def sample(self, index: int, rng: np.random.Generator):
        index = self._image_index(index, rng, len(self.raw_images))
        raw, labels = self._crop_with_rejection(
            [self._load(self.raw_images[index]), self._load(self.label_images[index])], rng)
        raw = raw.astype(np.float32)
        if self.label_transform is not None:
            labels = self.label_transform(labels)
        labels = np.asarray(labels, dtype=np.float32)
        if self.transform is not None:
            raw, labels = self.transform([raw, labels], rng)
        labels = self._apply_label_transform2(labels)
        if self.augmentation1 is None and self.augmentation2 is None:
            if self.raw_transform is not None:
                raw = self.raw_transform(raw)
            return _ensure_hwc(raw), _ensure_hwc(labels)
        raw1, raw2 = _two_views(raw, self.augmentation1, self.augmentation2, rng)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        return _ensure_hwc(raw), _ensure_hwc(raw1), _ensure_hwc(raw2), _ensure_hwc(labels)


class DualRawImageCollectionDataset(_PatchDatasetBase):
    """Unlabeled two-view patches with a dummy binary label ``x > 0`` of the
    normalized raw patch; ``sampler(raw_patch)`` rejects raw patches."""

    def __init__(self, raw_images: Sequence[ArrayOrPath], *, patch_shape: Tuple[int, int],
                 raw_transform: Optional[Callable] = standardize,
                 augmentation1: Optional[Callable] = None,
                 augmentation2: Optional[Callable] = None, n_samples: Optional[int] = None,
                 sampler: Optional[Callable] = None, seed: int = 0):
        super().__init__(patch_shape, n_samples=n_samples, n_images=len(raw_images),
                         sampler=None, seed=seed)
        self.raw_images = list(raw_images)
        self.raw_transform = raw_transform
        self.augmentation1 = augmentation1
        self.augmentation2 = augmentation2
        self.raw_sampler = sampler

    def sample(self, index: int, rng: np.random.Generator):
        index = self._image_index(index, rng, len(self.raw_images))
        raw_full = self._load(self.raw_images[index])
        for _ in range(MAX_SAMPLING_ATTEMPTS):
            bb = self._bounding_box(raw_full.shape[:2], rng)
            raw = np.array(raw_full[bb]).astype(np.float32)
            if self.raw_sampler is None or self.raw_sampler(raw):
                break
        else:
            raise RuntimeError(
                f"Could not sample a valid patch in {MAX_SAMPLING_ATTEMPTS} attempts")
        if self.augmentation1 is None and self.augmentation2 is None:
            if self.raw_transform is not None:
                raw = self.raw_transform(raw)
            return _ensure_hwc(raw), _ensure_hwc((raw > 0).astype(np.float32))
        raw1, raw2 = _two_views(raw, self.augmentation1, self.augmentation2, rng)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        dummy = (raw > 0).astype(np.float32)
        return _ensure_hwc(raw), _ensure_hwc(raw1), _ensure_hwc(raw2), _ensure_hwc(dummy)


class ConcatDataset(_PatchDatasetBase):
    """The datasets' samples one after the other."""

    def __init__(self, *datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        super().__init__(datasets[0].patch_shape, n_samples=None,
                         n_images=int(self._offsets[-1]))

    def sample(self, index: int, rng: np.random.Generator):
        ds_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[ds_idx].sample(index - int(self._offsets[ds_idx]), rng)
