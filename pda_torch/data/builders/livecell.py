"""LIVECell dataset builders and loader factories (port of
``pda/data/builders/livecell.py``; reference prob_utils/my_datasets/
{my_livecell.py, my_dual_inputs_livecell.py} and torch_em's
``get_livecell_loader``):
  * images.zip and the COCO annotation JSONs, fetched only where missing
    and ``download`` allows it
  * COCO instance annotations rasterized to uint16 label TIFFs (written by
    the port's codec, :mod:`pda_torch.data.tiff`)
  * three loader factories, each the port's ``Loader`` over its patch
    datasets:
      get_livecell_loader      — (x, y) supervised patches
      get_my_livecell_loader   — (x, pseudo_y, consensus) from a label_path
                                 tree written by punet_pseudo_prediction
      get_dual_livecell_loader — (x, weak, strong, y) two-view patches

Directory layout (identical to the reference's):
  <path>/images/livecell_{train_val,test}_images/<CELLTYPE>_.../*.tif
  <path>/{train,val,test}.json
  <label_path>/annotations/<split_name>/<celltype>/*.tif   (pseudo labels)
  <label_path>/consensus/<split_name>/<celltype>/*.tif     (consensus masks)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..datasets import DualImageCollectionDataset, ImageCollectionDataset
from ..loader import Loader
from ..tiff import imread, imwrite
from ..transforms import select_label_transform
from .coco import COCOIndex, rasterize_annotations
from .util import download_source, unzip

URLS = {
    "images": "http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/images.zip",
    "train": (
        "http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/annotations/"
        "LIVECell/livecell_coco_train.json"
    ),
    "val": (
        "http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/annotations/"
        "LIVECell/livecell_coco_val.json"
    ),
    "test": (
        "http://livecell-dataset.s3.eu-central-1.amazonaws.com/LIVECell_dataset_2021/annotations/"
        "LIVECell/livecell_coco_test.json"
    ),
}

CELL_TYPES = ["A172", "BT474", "BV2", "Huh7", "MCF7", "SHSY5Y", "SkBr3", "SKOV3"]


def _download_images(path: str, download: bool):
    os.makedirs(path, exist_ok=True)
    image_path = os.path.join(path, "images")
    if os.path.exists(image_path):
        return
    zip_path = os.path.join(path, "livecell.zip")
    download_source(zip_path, URLS["images"], download)
    unzip(zip_path, path, True)


def _annotation_file(path: str, split: str, download: bool) -> str:
    annotation_file = os.path.join(path, f"{split}.json")
    if not os.path.exists(annotation_file):
        download_source(annotation_file, URLS[split], download)
    return annotation_file


def _split_name(split: str) -> str:
    return "livecell_test_images" if split == "test" else "livecell_train_val_images"


def create_segmentations_from_annotations(
    annotation_file: str,
    image_folder: str,
    seg_folder: str,
    cell_types: Optional[Sequence[str]],
    rasterize_missing: bool = True,
) -> Tuple[List[str], List[str]]:
    """Rasterize COCO annotations to per-image uint16 instance TIFFs
    (reference my_livecell.py:57-107).

    With ``rasterize_missing=False`` (the pseudo-label tree: ``seg_folder``
    holds MODEL exports, not GT) a missing file raises instead. The reference
    silently rasterizes GT COCO labels into the pseudo tree here — which
    makes a partially-exported self-training run train on ground truth
    without any error; that behavior is deliberately not reproduced."""
    index = COCOIndex(annotation_file)
    image_paths, seg_paths = [], []
    for image_id in index.image_ids():
        meta = index.images[image_id]
        file_name = meta["file_name"]
        if cell_types is not None and not any(ct in file_name for ct in cell_types):
            continue

        sub_folder = file_name.split("_")[0]
        image_path = os.path.join(image_folder, sub_folder, file_name)
        if not os.path.exists(image_path):
            image_path = os.path.join(image_folder, file_name)
        assert os.path.exists(image_path), image_path
        image_paths.append(image_path)

        out_folder = os.path.join(seg_folder, sub_folder)
        os.makedirs(out_folder, exist_ok=True)
        seg_path = os.path.join(out_folder, file_name)
        seg_paths.append(seg_path)
        if os.path.exists(seg_path):
            continue
        if not rasterize_missing:
            raise FileNotFoundError(
                f"pseudo-label {seg_path} is missing — run the "
                "--get_pseudo_labels phase (punet_pseudo_prediction) for "
                "this source/target pair first; refusing to substitute "
                "ground-truth rasterizations into the pseudo-label tree"
            )
        imwrite(seg_path, rasterize_annotations(index, image_id))

    assert len(image_paths) == len(seg_paths)
    assert len(image_paths) > 0, (
        f"No matching image paths found. Invalid cell types ({cell_types})?"
    )
    return image_paths, seg_paths


def _image_and_label_paths(path, split, download, cell_types, label_path=None):
    annotation_file = _annotation_file(path, split, download)
    image_folder = os.path.join(path, "images", _split_name(split))
    seg_folder = (
        os.path.join(path, "annotations", _split_name(split))
        if label_path is None
        else os.path.join(label_path, "annotations", _split_name(split))
    )
    assert os.path.exists(image_folder), image_folder
    return create_segmentations_from_annotations(
        annotation_file, image_folder, seg_folder, cell_types,
        rasterize_missing=label_path is None,
    )


def get_livecell_loader(
    path: str,
    split: str,
    patch_shape: Tuple[int, int],
    batch_size: int,
    *,
    cell_types: Optional[Sequence[str]] = None,
    binary: bool = False,
    boundaries: bool = False,
    offsets=None,
    download: bool = False,
    n_samples: Optional[int] = None,
    sampler=None,
    num_workers: int = 8,
    **loader_kwargs,
) -> Loader:
    """Supervised (x, y) LIVECell patches — torch_em ``get_livecell_loader``
    equivalent (reference LIVECell/livecell_unet.py:19-37)."""
    assert split in ("train", "val", "test")
    _download_images(path, download)
    image_paths, seg_paths = _image_and_label_paths(path, split, download, cell_types)
    _lt, _lt2 = select_label_transform(offsets, boundaries, binary)
    ds = ImageCollectionDataset(
        image_paths,
        seg_paths,
        patch_shape=patch_shape,
        label_transform=_lt, label_transform2=_lt2,
        n_samples=n_samples,
        sampler=sampler,
    )
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


def get_my_livecell_loader(
    path: str,
    patch_shape: Tuple[int, int],
    split: str,
    *,
    label_path: str,
    cell_types: Optional[Sequence[str]] = None,
    binary: bool = False,
    boundaries: bool = False,
    offsets=None,
    download: bool = False,
    batch_size: int = 1,
    n_samples: Optional[int] = None,
    num_workers: int = 8,
    **loader_kwargs,
) -> Loader:
    """(x, pseudo_label, consensus) patches from a pseudo-label export tree
    (reference my_livecell.py:163-208): labels from
    ``<label_path>/annotations/<split_name>/...``, consensus from
    ``<label_path>/consensus/<split_name>/...``."""
    assert split in ("train", "val", "test")
    _download_images(path, download)
    image_paths, seg_paths = _image_and_label_paths(
        path, split, download, cell_types, label_path
    )
    consensus_folder = os.path.join(label_path, "consensus", _split_name(split))
    consensus_paths = [
        os.path.join(
            consensus_folder,
            os.path.basename(os.path.dirname(p)),
            os.path.basename(p),
        )
        for p in seg_paths
    ]
    _lt, _lt2 = select_label_transform(offsets, boundaries, binary)
    ds = ImageCollectionDataset(
        image_paths,
        seg_paths,
        consensus_paths,
        patch_shape=patch_shape,
        label_transform=_lt, label_transform2=_lt2,
        n_samples=n_samples,
    )
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


def get_dual_livecell_loader(
    path: str,
    patch_shape: Tuple[int, int],
    split: str,
    *,
    cell_types: Optional[Sequence[str]] = None,
    binary: bool = False,
    boundaries: bool = False,
    offsets=None,
    download: bool = False,
    batch_size: int = 1,
    augmentation1=None,
    augmentation2=None,
    n_samples: Optional[int] = None,
    num_workers: int = 8,
    **loader_kwargs,
) -> Loader:
    """(x, weak, strong, y) two-view LIVECell patches
    (reference my_dual_inputs_livecell.py:166-200)."""
    assert split in ("train", "val", "test")
    _download_images(path, download)
    image_paths, seg_paths = _image_and_label_paths(path, split, download, cell_types)
    _lt, _lt2 = select_label_transform(offsets, boundaries, binary)
    ds = DualImageCollectionDataset(
        image_paths,
        seg_paths,
        patch_shape=patch_shape,
        label_transform=_lt, label_transform2=_lt2,
        augmentation1=augmentation1,
        augmentation2=augmentation2,
        n_samples=n_samples,
    )
    return Loader(ds, batch_size, num_workers=num_workers, **loader_kwargs)


def compute_class_distribution(root_dir: str, threshold: float = 0.5):
    """Class frequencies of exported pseudo-labels, for FixMatch distribution
    alignment (reference LIVECell/livecell_fm.py:21-40)."""
    from glob import glob

    bg, fg = [], []
    files = glob(os.path.join(root_dir, "**", "*.tif"), recursive=True)
    assert files, f"no pseudo-label tifs under {root_dir}"
    for p in files:
        img = imread(p)
        binary = img >= threshold
        frac = float(binary.mean())
        fg.append(frac)
        bg.append(1.0 - frac)
    return [float(np.mean(bg)), float(np.mean(fg))]
