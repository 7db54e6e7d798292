"""EM dataset builders: MitoEM, VNC, Lucchi++, UroCell (port of
``pda/data/builders/em.py``; reference prob_utils/my_datasets/{my_vnc.py,
my_lucchi.py, my_urocell.py} and torch_em's ``get_mitoem_loader``).

Every loader gives 2D patches of HDF5 volumes through
(Dual)SegmentationDataset. The volumes are built from the archives (fetched
where missing and ``download`` allows it) by the port's codecs: TIFF and PNG
slices in, HDF5 volumes out. ``pda``'s choices are kept: VNC's partitions
are reversed (only stack1 is labeled), Lucchi++'s Test pair trains and its
Train pair tests, the extracted trees stay (prediction and evaluation read
them), and a per-volume sample count is ``n_samples // len(volumes)``.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Sequence

import numpy as np

from .. import h5
from ..datasets import ConcatDataset, DualSegmentationDataset, SegmentationDataset
from ..loader import Loader
from ..tiff import read_image
from ..transforms import labels_to_binary, select_label_transform
from .prepare import MITOEM_URLS, get_uro_cell_paths, prepare_mitoem_sample
from .util import download_source, unzip

VNC_URL = "https://github.com/unidesigner/groundtruth-drosophila-vnc/archive/refs/heads/master.zip"
VNC_CHECKSUM = "f7bd0db03c86b64440a16b60360ad60c0a4411f89e2c021c7ee2c8d6af3d7e86"
LUCCHI_URL = "http://www.casser.io/files/lucchi_pp.zip"
LUCCHI_CHECKSUM = "770ce9e98fc6f29c1b1a250c637e6c5125f2b5f1260e5a7687b55a79e2e8844d"


def _connected_components(binary_stack: np.ndarray) -> np.ndarray:
    """Per-slice instance labels (skimage.measure.label, as the reference's
    VNC builder uses)."""
    from scipy import ndimage

    out = np.zeros(binary_stack.shape, dtype="uint16")
    for z in range(binary_stack.shape[0]):
        out[z], _ = ndimage.label(binary_stack[z] > 0)
    return out


def _stack_images(pattern: str) -> np.ndarray:
    files = sorted(glob(pattern))
    if not files:
        raise RuntimeError(f"no files match {pattern}")
    return np.concatenate([read_image(f)[None] for f in files], axis=0)


# ---------------------------------------------------------------------------
# VNC
# ---------------------------------------------------------------------------


def _get_vnc_data(path: str, download: bool):
    """vnc_{train,test}.h5 from the github zip (reference my_vnc.py:19-52)."""
    train_path = os.path.join(path, "vnc_train.h5")
    test_path = os.path.join(path, "vnc_test.h5")
    if os.path.exists(train_path) and os.path.exists(test_path):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "vnc.zip")
    download_source(zip_path, VNC_URL, download, VNC_CHECKSUM)
    unzip(zip_path, path, remove=True)
    root = os.path.join(path, "groundtruth-drosophila-vnc-master")
    if not os.path.exists(root):
        raise RuntimeError(f"the VNC archive has no {root}")

    with h5.Writer(train_path) as f:
        f.create_dataset("raw", data=_stack_images(os.path.join(root, "stack1", "raw", "*.tif")))
        mito = _stack_images(os.path.join(root, "stack1", "mitochondria", "*.png"))
        f.create_dataset("labels/mitochondria", data=_connected_components(mito))
    with h5.Writer(test_path) as f:
        f.create_dataset("raw", data=_stack_images(os.path.join(root, "stack2", "raw", "*.tif")))


def get_vnc_mito_loader(path: str, patch_shape, *, partition: str, binary: bool = False,
                        boundaries: bool = False, offsets=None, download: bool = False,
                        batch_size: int = 1, augmentation1=None, augmentation2=None,
                        sampler=None, n_samples: Optional[int] = None, num_workers: int = 8,
                        **loader_kwargs) -> Loader:
    """VNC with the reference's partition reversal (my_vnc.py:69-75): only
    stack1 has labels, so "tr" (self-training) reads the unlabeled stack2
    and "ts" (validation) the labeled stack1."""
    _get_vnc_data(path, download)
    if partition not in ("tr", "ts"):
        raise ValueError(f"partition {partition!r}: 'tr' or 'ts'")
    split = "test" if partition == "tr" else "train"
    data_path = os.path.join(path, f"vnc_{split}.h5")
    label_path = data_path if split == "train" else None
    _lt, _lt2 = select_label_transform(offsets, boundaries, binary)
    ds = DualSegmentationDataset(
        data_path, label_path, raw_key="raw", label_key="labels/mitochondria",
        patch_shape=tuple(patch_shape[-2:]), label_transform=_lt, label_transform2=_lt2,
        augmentation1=augmentation1, augmentation2=augmentation2,
        sampler=sampler if label_path is not None else None, n_samples=n_samples)
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


# ---------------------------------------------------------------------------
# Lucchi++
# ---------------------------------------------------------------------------


def _require_lucchi_data(path: str, download: bool):
    """lucchi_{train,test}.h5 from lucchi_pp.zip (my_lucchi.py:38-75): the
    Test pair becomes the train volume, the Train pair the test volume."""
    if (os.path.exists(os.path.join(path, "lucchi_train.h5"))
            and os.path.exists(os.path.join(path, "lucchi_test.h5"))):
        return
    os.makedirs(path, exist_ok=True)
    zip_path = os.path.join(path, "lucchi.zip")
    download_source(zip_path, LUCCHI_URL, download, LUCCHI_CHECKSUM)
    unzip(zip_path, path, remove=True)
    root = os.path.join(path, "Lucchi++")
    if not os.path.exists(root):
        raise RuntimeError(f"the Lucchi++ archive has no {root}")

    for inputs, out in ((("Test_In", "Test_Out"), "lucchi_train.h5"),
                        (("Train_In", "Train_Out"), "lucchi_test.h5")):
        raw = _stack_images(os.path.join(root, inputs[0], "*.png"))
        labels_raw = _stack_images(os.path.join(root, inputs[1], "*.png"))
        if labels_raw.ndim == 4:  # RGB masks
            labels = (labels_raw == 255).all(axis=-1).astype("uint8")
        else:
            labels = labels_raw.copy()
            labels[labels == 255] = 1
        if raw.shape != labels.shape[:3]:
            raise ValueError(f"Lucchi++ {inputs}: raw {raw.shape}, labels {labels.shape}")
        with h5.Writer(os.path.join(path, out)) as f:
            f.create_dataset("raw", data=raw)
            f.create_dataset("labels", data=labels.astype("uint8"))


def get_lucchi_loader(path: str, split: str, *, patch_shape, download: bool = False,
                      batch_size: int = 1, augmentation1=None, augmentation2=None,
                      sampler=None, n_samples: Optional[int] = None, num_workers: int = 8,
                      **loader_kwargs) -> Loader:
    """Lucchi++ (reference my_lucchi.py:78-86)."""
    if split not in ("train", "test"):
        raise ValueError(f"split {split!r}: 'train' or 'test'")
    _require_lucchi_data(path, download)
    data_path = os.path.join(path, f"lucchi_{split}.h5")
    ds = DualSegmentationDataset(
        data_path, data_path, raw_key="raw", label_key="labels",
        patch_shape=tuple(patch_shape[-2:]), label_transform=labels_to_binary,
        augmentation1=augmentation1, augmentation2=augmentation2, sampler=sampler,
        n_samples=n_samples)
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


# ---------------------------------------------------------------------------
# UroCell
# ---------------------------------------------------------------------------


def get_uro_cell_loader(path: str, split: str, *, patch_shape, download: bool = False,
                        batch_size: int = 1, augmentation1=None, augmentation2=None,
                        sampler=None, n_samples: Optional[int] = None, num_workers: int = 8,
                        volume_paths: Optional[Sequence[str]] = None,
                        **loader_kwargs) -> Loader:
    """UroCell (reference my_urocell.py:6-26): the volumes sorted, the last
    held out for testing, the second-last validates, the rest train.
    ``volume_paths`` may name the volumes (``raw`` and ``labels/mito``);
    else they are ``<path>/*.h5``, where :func:`.prepare.get_uro_cell_paths`
    writes them (``pda`` looks in ``<path>/urocell/``, where nothing writes
    them, and then fetches the archive again)."""
    if volume_paths is None:
        volume_paths = sorted(glob(os.path.join(path, "*.h5")))
        if not volume_paths and download:
            volume_paths = get_uro_cell_paths(path, download=True)
    if not volume_paths:
        raise RuntimeError(f"no UroCell volumes under {path}")
    paths = sorted(volume_paths)[:-1]
    if split == "train":
        paths = paths[:-1] if len(paths) > 1 else paths
    elif split == "val":
        paths = [paths[-1]]
    else:
        raise ValueError(split)
    datasets = [
        DualSegmentationDataset(
            p, p, raw_key="raw", label_key="labels/mito", patch_shape=tuple(patch_shape[-2:]),
            label_transform=labels_to_binary, augmentation1=augmentation1,
            augmentation2=augmentation2, sampler=sampler,
            n_samples=None if n_samples is None else n_samples // len(paths))
        for p in paths
    ]
    ds = datasets[0] if len(datasets) == 1 else ConcatDataset(*datasets)
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


# ---------------------------------------------------------------------------
# MitoEM
# ---------------------------------------------------------------------------


def get_mitoem_loader(path: str, splits, patch_shape, batch_size: int, *,
                      samples: Sequence[str] = ("human", "rat"), binary: bool = False,
                      boundaries: bool = False, offsets=None, download: bool = False,
                      sampler=None, n_samples: Optional[int] = None, num_workers: int = 8,
                      **loader_kwargs) -> Loader:
    """MitoEM source patches (torch_em's ``get_mitoem_loader``; reference
    MitoEM/common.py:19-46) from ``<path>/<sample>_<split>.h5`` (``raw`` and
    ``labels``); a list of splits concatenates every sample x split."""
    split_list = [splits] if isinstance(splits, str) else list(splits)
    if not all(s in ("train", "val") for s in split_list):
        raise ValueError(f"splits {split_list}: 'train' or 'val'")
    volume_paths = []
    for split in split_list:
        for sample in samples:
            p = os.path.join(path, f"{sample}_{split}.h5")
            if not os.path.exists(p):
                if not download:
                    raise RuntimeError(
                        f"MitoEM volume {p} missing. Pass download=True (fetches "
                        f"{MITOEM_URLS.get(sample)} and converts to h5, like torch_em's "
                        f"get_mitoem_loader) or place the h5 there with datasets 'raw' and "
                        f"'labels'.")
                prepare_mitoem_sample(path, sample, download=True)
            volume_paths.append(p)

    _lt, _lt2 = select_label_transform(offsets, boundaries, binary)
    datasets = [
        SegmentationDataset(
            p, p, raw_key="raw", label_key="labels", patch_shape=tuple(patch_shape[-2:]),
            label_transform=_lt, label_transform2=_lt2, sampler=sampler,
            n_samples=None if n_samples is None else n_samples // len(volume_paths))
        for p in volume_paths
    ]
    ds = datasets[0] if len(datasets) == 1 else ConcatDataset(*datasets)
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


# ---------------------------------------------------------------------------
# the reference's segmentation-dataset helpers
# ---------------------------------------------------------------------------


def default_dual_segmentation_dataset(raw_paths, raw_key, label_paths, label_key, patch_shape,
                                      *, binary: bool = False, boundaries: bool = False,
                                      offsets=None, augmentation1=None, augmentation2=None,
                                      sampler=None, n_samples=None, rois=None, **kwargs):
    """One DualSegmentationDataset per volume, concatenated (reference
    ``default_dual_segmentation_dataset``, my_segmentation_datasets.py:314-447)."""
    if isinstance(raw_paths, str) or hasattr(raw_paths, "shape"):
        raw_paths, label_paths = [raw_paths], [label_paths]
    rois = rois if rois is not None else [None] * len(raw_paths)
    _lt, _lt2 = select_label_transform(offsets, boundaries, binary)
    datasets = [
        DualSegmentationDataset(
            rp, lp, raw_key=raw_key, label_key=label_key, patch_shape=tuple(patch_shape[-2:]),
            roi=roi, label_transform=_lt, label_transform2=_lt2, augmentation1=augmentation1,
            augmentation2=augmentation2, sampler=sampler,
            n_samples=None if n_samples is None else n_samples // len(raw_paths))
        for rp, lp, roi in zip(raw_paths, label_paths, rois)
    ]
    return datasets[0] if len(datasets) == 1 else ConcatDataset(*datasets)


def default_dual_segmentation_loader(raw_paths, raw_key, label_paths, label_key, *,
                                     batch_size=1, patch_shape, num_workers: int = 8,
                                     shuffle: bool = True, ndim=None, **kwargs):
    """The dataset(s) of :func:`default_dual_segmentation_dataset` in a
    Loader (reference ``get_dual_data_loader``)."""
    ds = default_dual_segmentation_dataset(raw_paths, raw_key, label_paths, label_key,
                                           patch_shape, **kwargs)
    return Loader(ds, batch_size, num_workers=num_workers, shuffle=shuffle)
