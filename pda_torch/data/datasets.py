"""Patch datasets held in memory, read from image files or from HDF5
volumes (port of ``pda/data/datasets.py``):

  ImageCollectionDataset        -> (x, y) or (x, y, consensus)
  DualImageCollectionDataset    -> (x, aug1(x), aug2(x), y)
  DualRawImageCollectionDataset -> (x, aug1(x), aug2(x), dummy_y)   (unlabeled)
  SegmentationDataset (+Dual)   -> 2D crops of HDF5 volumes (slices of 3D)
  ConcatDataset                 -> the samples of several datasets in turn

Samples are channel-last ``(H, W, C)`` float32 numpy arrays, so a batch
stacks to NHWC; the trainer moves it to the card. Randomness is an explicit
``numpy.random.Generator`` handed in per sample (``sample(index, rng)``), so
a loader with workers stays deterministic. The rejection loop (at most 500
attempts) crops every array of a sample, the consensus mask included. Images
are numpy arrays or file paths (a TIFF, PNG or BMP read by the port's
codecs, :mod:`.tiff`, :mod:`.png` and :mod:`.bmp`; any other file by
imageio, imported on first use). Volumes are numpy arrays or HDF5 files read by :mod:`.h5`: one larger
than ``EAGER_LIMIT_BYTES`` is read a window at a time (:class:`LazyH5Volume`).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from . import h5
from .tiff import read_image
from .transforms import get_augmentations, standardize

ArrayOrPath = Union[str, np.ndarray]

MAX_SAMPLING_ATTEMPTS = 500


def load_image(path_or_array: ArrayOrPath) -> np.ndarray:
    if isinstance(path_or_array, np.ndarray):
        return path_or_array
    return read_image(path_or_array)


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


class LazyH5Volume:
    """A window-at-a-time view of one HDF5 dataset, ``roi`` selecting a
    range of its first axis: nothing is read until it is indexed, and then
    only the chunks the window needs. One file handle, opened on first use,
    serves every thread of a process (reads are positional); a pickled copy
    opens its own, so the view travels to loader worker processes."""

    def __init__(self, path: str, key: str, roi: Optional[slice] = None):
        self.path, self.key = path, key
        self._file, self._lock = None, threading.Lock()
        d = self._dataset()
        shape, self.dtype = d.shape, d.dtype.newbyteorder("=")
        self._start, self._stop, self._step = (
            roi.indices(shape[0]) if roi is not None else (0, shape[0], 1))
        if self._step <= 0:
            raise ValueError(f"roi step must be positive, got {roi}")
        n0 = max(0, -(-(self._stop - self._start) // self._step))
        self.shape = (n0, *shape[1:])
        self.ndim = len(self.shape)

    def _dataset(self):
        with self._lock:
            if self._file is None:
                self._file = h5.File(self.path)
            return self._file[self.key]

    def __getitem__(self, index):
        if not isinstance(index, tuple):
            index = (index,)
        first = index[0]
        if isinstance(first, (int, np.integer)):
            i = int(first) + self.shape[0] if first < 0 else int(first)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {int(first)} out of range for ROI axis of "
                                 f"length {self.shape[0]}")
            first = self._start + i * self._step
        elif isinstance(first, slice):
            if first.step is not None and first.step < 0:
                raise IndexError("negative-step slices are not supported on the lazy ROI "
                                 "axis; read the window and reverse on the host")
            lo, hi, st = first.indices(self.shape[0])
            first = slice(self._start + lo * self._step, self._start + hi * self._step,
                          st * self._step)
        return self._dataset()[(first,) + index[1:]]

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_file"] = state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


class SegmentationDataset(_PatchDatasetBase):
    """2D random crops of HDF5 volumes (a 3D volume's slices, or one 2D
    image); ``roi`` restricts the slices along axis 0."""

    #: volumes larger than this (bytes) are read a window at a time
    EAGER_LIMIT_BYTES = 512 * 1024 * 1024

    def __init__(self, raw_path: Union[str, np.ndarray], label_path: Union[str, np.ndarray, None],
                 *, raw_key: str = "raw", label_key: str = "labels",
                 patch_shape: Tuple[int, int], roi: Optional[slice] = None,
                 raw_transform: Optional[Callable] = standardize,
                 label_transform: Optional[Callable] = None,
                 label_transform2: Optional[Callable] = None,
                 transform: Optional[Callable] = None, n_samples: Optional[int] = None,
                 sampler: Optional[Callable] = None, seed: int = 0, lazy: Optional[bool] = None):
        self.raw = self._open(raw_path, raw_key, roi, lazy)
        self.labels = (self._open(label_path, label_key, roi, lazy)
                       if label_path is not None else None)
        n_slices = self.raw.shape[0] if self.raw.ndim == 3 else 1
        super().__init__(patch_shape, n_samples=n_samples, n_images=n_slices, sampler=sampler,
                         seed=seed)
        self.raw_transform = raw_transform
        self.label_transform = label_transform
        self.label_transform2 = label_transform2
        self.transform = transform if transform is not None else get_augmentations(2)

    @classmethod
    def _open(cls, path, key, roi=None, lazy=None):
        if isinstance(path, np.ndarray):
            return path if roi is None else path[roi]
        with h5.File(path) as f:
            dset = f[key]
            if lazy is None:
                lazy = dset.size * dset.dtype.itemsize > cls.EAGER_LIMIT_BYTES
            if not lazy:
                data = dset[...]
                return data if roi is None else data[roi]
        return LazyH5Volume(path, key, roi=roi)

    def _slice(self, index: int, rng):
        if self.raw.ndim != 3:
            return self.raw, self.labels
        if self.sample_random_index:
            index = int(rng.integers(0, self.raw.shape[0]))
        index %= self.raw.shape[0]
        return self.raw[index], None if self.labels is None else self.labels[index]

    def _crop(self, index, rng):
        """The cropped raw (float32) and labels, the joint augmentation and
        both label transforms applied."""
        raw_full, label_full = self._slice(index, rng)
        arrays = [raw_full] if label_full is None else [raw_full, label_full]
        patches = self._crop_with_rejection(arrays, rng)
        raw = patches[0].astype(np.float32)
        labels = patches[1] if len(patches) > 1 else np.zeros_like(raw)
        if self.label_transform is not None:
            labels = self.label_transform(labels)
        labels = np.asarray(labels, dtype=np.float32)
        if self.transform is not None:
            raw, labels = self.transform([raw, labels], rng)
        return raw, self._apply_label_transform2(labels)

    def sample(self, index: int, rng: np.random.Generator):
        raw, labels = self._crop(index, rng)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        return _ensure_hwc(raw), _ensure_hwc(labels)


class DualSegmentationDataset(SegmentationDataset):
    """Two-view crops of HDF5 volumes: (x, aug1(x), aug2(x), y); without
    augmentations a plain (x, y)."""

    def __init__(self, *args, augmentation1=None, augmentation2=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.augmentation1 = augmentation1
        self.augmentation2 = augmentation2

    def sample(self, index: int, rng: np.random.Generator):
        if self.augmentation1 is None and self.augmentation2 is None:
            return super().sample(index, rng)
        raw, labels = self._crop(index, rng)
        raw1, raw2 = _two_views(raw, self.augmentation1, self.augmentation2, rng)
        if self.raw_transform is not None:
            raw = self.raw_transform(raw)
        return _ensure_hwc(raw), _ensure_hwc(raw1), _ensure_hwc(raw2), _ensure_hwc(labels)


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
