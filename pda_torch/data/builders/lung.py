"""Lung X-Ray dataset loaders and the prepare step (port of
``pda/data/builders/lung.py``; reference prob_utils/my_datasets/
{my_jsrt1.py, my_jsrt2.py, my_nih.py, my_montgomery.py} and
Lung-XRay/prepare_data.py):

  * four loader factories, each the port's ``Loader`` over a
    :class:`DualImageCollectionDataset` of the domain's image and label
    files, labels ``x == 255``:
      get_jsrt_s1_loader     <split>/org/*.png + <split>/label/*.png
      get_jsrt_s2_loader     org_<split>/*.bmp + label_<split>/*.png
      get_nih_loader,
      get_montgomery_loader  images/<split>/*.png + labels/<split>/*.png
    ("val" reads the train folders); the train/val split is scikit-learn's
    ``train_test_split(random_state=42, test_size=val_fraction)``,
    reproduced in numpy (:func:`shuffle_split`)
  * :func:`prepare_montgomery` (left and right masks merged, 256^2, an
    80/20 train/test split) and :func:`prepare_nih` (256^2, the provided
    splits), on the port's PNG codec and its numpy ``cv2.resize``
    (:mod:`..resize`).

The BMP images are read by :mod:`..bmp`. No scikit-learn, OpenCV or imageio.
"""

from __future__ import annotations

import math
import os
from glob import glob
from typing import Sequence, Tuple

import numpy as np

from .. import png
from ..datasets import DualImageCollectionDataset
from ..loader import Loader
from ..resize import INTER_AREA, INTER_NEAREST, resize

LUNG_DOMAINS = ["jsrt1", "jsrt2", "nih", "montgomery"]


def my_label_transform(x: np.ndarray) -> np.ndarray:
    """(x == 255) -> float32 (reference my_jsrt1.py:10-11)."""
    return (np.asarray(x) == 255).astype("float32")


def shuffle_split(n: int, test_size: float, seed: int = 42):
    """scikit-learn's ``ShuffleSplit(test_size=test_size,
    random_state=seed)``'s one split of ``n`` samples: (train indices,
    test indices), each in the permutation's order. ``ceil(test_size * n)``
    are held out (a ceiling, not a rounding); it raises where either side
    is empty, as scikit-learn does."""
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_test == 0 or n_train <= 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} the resulting train set "
                         "or test set is empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def _train_val_split(raw_paths: Sequence[str], label_paths: Sequence[str], split: str,
                    val_fraction: float):
    """``train_test_split(raw, labels, random_state=42, test_size=val_fraction)``
    (reference my_jsrt1.py:28-33): the "train" or "val" side; the paths
    unchanged for the "test" split or a ``val_fraction`` of 0."""
    if val_fraction > 0 and split in ("train", "val"):
        if len(raw_paths) != len(label_paths):
            raise ValueError(f"{len(raw_paths)} images against {len(label_paths)} labels")
        train, val = shuffle_split(len(raw_paths), val_fraction)
        keep = val if split == "val" else train
        return [raw_paths[i] for i in keep], [label_paths[i] for i in keep]
    return raw_paths, label_paths


def _make_loader(raw_paths, label_paths, patch_shape, batch_size, augmentation1,
                 augmentation2, num_workers=8, **kwargs) -> Loader:
    assert len(raw_paths) > 0, "no lung images found"
    assert len(raw_paths) == len(label_paths)
    ds = DualImageCollectionDataset(
        raw_paths, label_paths, patch_shape=patch_shape, label_transform=my_label_transform,
        augmentation1=augmentation1, augmentation2=augmentation2)
    return Loader(ds, batch_size, num_workers=num_workers, **kwargs)


def _folders_loader(data_path, raw_dir, label_dir, raw_ext, split, batch_size, patch_shape,
                    val_fraction, augmentation1, augmentation2, **kwargs) -> Loader:
    src = "train" if split == "val" else split
    raw_paths = sorted(glob(os.path.join(data_path, raw_dir.format(src), "*" + raw_ext)))
    label_paths = sorted(glob(os.path.join(data_path, label_dir.format(src), "*.png")))
    raw_paths, label_paths = _train_val_split(raw_paths, label_paths, split, val_fraction)
    return _make_loader(raw_paths, label_paths, patch_shape, batch_size, augmentation1,
                        augmentation2, **kwargs)


def get_jsrt_s1_loader(data_path: str, split: str, batch_size: int = 1,
                       patch_shape: Tuple[int, int] = (256, 256), val_fraction: float = 0.1,
                       augmentation1=None, augmentation2=None, **kwargs) -> Loader:
    """JSRT segmentation01: <split>/org/*.png + <split>/label/*.png."""
    return _folders_loader(data_path, os.path.join("{}", "org"), os.path.join("{}", "label"),
                           ".png", split, batch_size, patch_shape, val_fraction,
                           augmentation1, augmentation2, **kwargs)


def get_jsrt_s2_loader(data_path: str, split: str, batch_size: int = 1,
                       patch_shape: Tuple[int, int] = (256, 256), val_fraction: float = 0.1,
                       augmentation1=None, augmentation2=None, **kwargs) -> Loader:
    """JSRT segmentation02: org_<split>/*.bmp + label_<split>/*.png."""
    return _folders_loader(data_path, "org_{}", "label_{}", ".bmp", split, batch_size,
                           patch_shape, val_fraction, augmentation1, augmentation2, **kwargs)


def get_nih_loader(data_path: str, split: str, batch_size: int = 1,
                   patch_shape: Tuple[int, int] = (256, 256), val_fraction: float = 0.1,
                   augmentation1=None, augmentation2=None, **kwargs) -> Loader:
    """NIH: images/<split>/*.png + labels/<split>/*.png (my_nih.py)."""
    return _folders_loader(data_path, os.path.join("images", "{}"), os.path.join("labels", "{}"),
                           ".png", split, batch_size, patch_shape, val_fraction,
                           augmentation1, augmentation2, **kwargs)


def get_montgomery_loader(data_path: str, split: str, batch_size: int = 1,
                          patch_shape: Tuple[int, int] = (256, 256), val_fraction: float = 0.1,
                          augmentation1=None, augmentation2=None, **kwargs) -> Loader:
    """Montgomery: images/<split>/*.png + labels/<split>/*.png
    (my_montgomery.py)."""
    return _folders_loader(data_path, os.path.join("images", "{}"), os.path.join("labels", "{}"),
                           ".png", split, batch_size, patch_shape, val_fraction,
                           augmentation1, augmentation2, **kwargs)


LOADERS = {"jsrt1": get_jsrt_s1_loader, "jsrt2": get_jsrt_s2_loader, "nih": get_nih_loader,
           "montgomery": get_montgomery_loader}


def get_lung_loader(domain: str, data_path: str, split: str, **kwargs) -> Loader:
    """The loader of one lung domain (reference Lung-XRay/lung_mt.py:98)."""
    return LOADERS[domain](data_path, split, **kwargs)


# ---------------------------------------------------------------------------
# the prepare step (Lung-XRay/prepare_data.py)
# ---------------------------------------------------------------------------


def _first_channel(img: np.ndarray) -> np.ndarray:
    return img[..., 0] if img.ndim == 3 else img


def prepare_montgomery(raw_root: str, out_root: str, size: Tuple[int, int] = (256, 256),
                       test_fraction: float = 0.2, seed: int = 42) -> None:
    """CXR_png/*.png and ManualMask/{leftMask,rightMask}/*.png -> the union
    of the two masks, images (INTER_AREA) and masks (INTER_NEAREST) resized
    to ``size`` (rows, cols), a seeded 80/20 train/test split, under
    ``out_root``/{images,labels}/{train,test} (reference
    Lung-XRay/prepare_data.py:36-61). As ``pda`` does, a 16-bit image's
    resized values are cast to uint8 modulo 256."""
    img_dir = os.path.join(raw_root, "CXR_png")
    left_dir = os.path.join(raw_root, "ManualMask", "leftMask")
    right_dir = os.path.join(raw_root, "ManualMask", "rightMask")
    images = sorted(glob(os.path.join(img_dir, "*.png")))
    assert images, f"no montgomery images under {img_dir}"

    order = np.random.default_rng(seed).permutation(len(images))
    test_idx = set(order[:int(round(test_fraction * len(images)))].tolist())
    for split in ("train", "test"):
        os.makedirs(os.path.join(out_root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(out_root, "labels", split), exist_ok=True)

    dsize = (size[1], size[0])  # cv2's (width, height)
    for i, img_path in enumerate(images):
        name = os.path.basename(img_path)
        split = "test" if i in test_idx else "train"
        img = _first_channel(png.imread(img_path))
        left = png.imread(os.path.join(left_dir, name))
        right = png.imread(os.path.join(right_dir, name))
        mask = ((left > 0) | (right > 0)).astype("uint8") * 255
        img = resize(img, dsize, INTER_AREA)
        mask = resize(mask, dsize, INTER_NEAREST)
        png.imwrite(os.path.join(out_root, "images", split, name), img.astype("uint8"))
        png.imwrite(os.path.join(out_root, "labels", split, name), mask)


def prepare_nih(raw_root: str, out_root: str, size: Tuple[int, int] = (256, 256)) -> None:
    """images/<split>/*.png and labels/<split>/*.png -> resized to ``size``
    (images INTER_AREA, labels INTER_NEAREST then ``> 0`` as 0/255), the
    provided splits kept (reference Lung-XRay/prepare_data.py:108-135)."""
    dsize = (size[1], size[0])
    for split in ("train", "test"):
        for img_path in sorted(glob(os.path.join(raw_root, "images", split, "*.png"))):
            name = os.path.basename(img_path)
            img = _first_channel(png.imread(img_path))
            lab = png.imread(os.path.join(raw_root, "labels", split, name))
            img = resize(img, dsize, INTER_AREA)
            lab = resize(lab, dsize, INTER_NEAREST)
            os.makedirs(os.path.join(out_root, "images", split), exist_ok=True)
            os.makedirs(os.path.join(out_root, "labels", split), exist_ok=True)
            png.imwrite(os.path.join(out_root, "images", split, name), img.astype("uint8"))
            png.imwrite(os.path.join(out_root, "labels", split, name),
                        ((lab > 0) * 255).astype("uint8"))
