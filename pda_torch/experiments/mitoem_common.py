"""The MitoEM suite's loaders and recipes (port of
``experiments/MitoEM/common.py``): source loaders over the MitoEM volumes
with MinForegroundSampler(0.05) patch rejection, per-target two-view loaders
(vnc, lucchi, urocell) with their sample caps, the weak and strong recipes,
and the targets' prediction and ground-truth globs.
"""

from __future__ import annotations

import os

from ..data import MinForegroundSampler
from ..data.builders import (
    get_lucchi_loader,
    get_mitoem_loader,
    get_uro_cell_loader,
    get_vnc_mito_loader,
)
from .common import mitoem_strong_augmentations, weak_augmentations

EM_TYPES = ["vnc", "lucchi", "urocell"]

my_weak_augmentations = weak_augmentations
my_strong_augmentations = mitoem_strong_augmentations


def get_mitoem_loaders(data_path, patch_shape=(1, 512, 512), my_sampler=None):
    """Source loaders (reference MitoEM/common.py:14-46): train 512^2 batch
    4, validation batch 1, 100 samples."""
    sampler = my_sampler or MinForegroundSampler(min_fraction=0.05)
    train_loader = get_mitoem_loader(
        path=data_path, splits="train", patch_shape=patch_shape, batch_size=4,
        binary=True, sampler=sampler, download=True, num_workers=16, shuffle=True,
    )
    val_loader = get_mitoem_loader(
        path=data_path, splits="val", patch_shape=patch_shape, batch_size=1,
        binary=True, sampler=sampler, download=True, num_workers=16, shuffle=True,
        n_samples=100,
    )
    return train_loader, val_loader


def get_dual_loaders(em_data: str, root_input_dir: str, patch_shape=(1, 512, 512),
                     weak_augs=None, strong_augs=None, my_sampler=None):
    """A target's two-view train and validation loaders (reference
    MitoEM/common.py:70-170)."""
    weak_augs = weak_augs or my_weak_augmentations()
    strong_augs = strong_augs or my_strong_augmentations()
    sampler = my_sampler or MinForegroundSampler(min_fraction=0.05)
    path = os.path.join(root_input_dir, em_data)

    if em_data == "vnc":
        train_loader = get_vnc_mito_loader(
            path=path, partition="tr", batch_size=4, patch_shape=patch_shape,
            binary=True, sampler=sampler, augmentation1=weak_augs,
            augmentation2=strong_augs, download=True, num_workers=16,
            shuffle=True, n_samples=400,
        )
        val_loader = get_vnc_mito_loader(
            path=path, partition="ts", batch_size=1, patch_shape=patch_shape,
            binary=True, sampler=sampler, augmentation1=weak_augs,
            augmentation2=strong_augs, download=True, num_workers=16,
            shuffle=True, n_samples=400,
        )
    elif em_data == "lucchi":
        train_loader = get_lucchi_loader(
            path=path, split="train", batch_size=4, patch_shape=patch_shape,
            sampler=sampler, augmentation1=weak_augs, augmentation2=strong_augs,
            download=True, num_workers=16, shuffle=True,
        )
        val_loader = get_lucchi_loader(
            path=path, split="test", batch_size=1, patch_shape=patch_shape,
            sampler=sampler, augmentation1=weak_augs, augmentation2=strong_augs,
            download=True, num_workers=16, shuffle=True,
        )
    elif em_data == "urocell":
        uc_sampler = MinForegroundSampler(min_fraction=0.01)
        train_loader = get_uro_cell_loader(
            path=path, split="train", patch_shape=patch_shape, batch_size=4,
            sampler=uc_sampler, augmentation1=weak_augs, augmentation2=strong_augs,
            download=True, num_workers=16, shuffle=True, n_samples=400,
        )
        val_loader = get_uro_cell_loader(
            path=path, split="val", patch_shape=patch_shape, batch_size=1,
            sampler=uc_sampler, augmentation1=weak_augs, augmentation2=strong_augs,
            download=True, num_workers=16, shuffle=True, n_samples=400,
        )
    else:
        raise ValueError(em_data)
    return train_loader, val_loader


def em_input_glob(data_path: str, em_type: str) -> str:
    """A target's raw frames to predict (reference mitoem_punet.py:56-61)."""
    return {
        "lucchi": os.path.join(data_path, "lucchi", "Lucchi++", "Test_In", "*"),
        "vnc": os.path.join(data_path, "vnc", "groundtruth-drosophila-vnc-master", "stack1",
                            "raw", "*"),
        "urocell": os.path.join(data_path, "urocell", "preprocessed", "*_image.tif"),
    }[em_type]


def em_gt_glob(data_path: str, em_type: str) -> str:
    """A target's ground truth for evaluation (reference mitoem_punet.py:85-90)."""
    return {
        "lucchi": os.path.join(data_path, "lucchi", "Lucchi++", "Test_Out", "*"),
        "vnc": os.path.join(data_path, "vnc", "groundtruth-drosophila-vnc-master", "stack1",
                            "mitochondria", "*"),
        "urocell": os.path.join(data_path, "urocell", "preprocessed", "*_gt.tif"),
    }[em_type]
