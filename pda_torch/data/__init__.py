"""Data pipelines (port of ``pda.data``): numpy transforms, 2D patch
datasets, the loader and synthetic data. numpy only: the trainer moves
batches to the card. ``pda``'s HDF5 volume datasets, native augmentation
library and dataset builders are not ported yet (ROADMAP §1)."""

from .datasets import (
    ConcatDataset,
    DualImageCollectionDataset,
    DualRawImageCollectionDataset,
    ImageCollectionDataset,
    MinForegroundSampler,
    load_image,
)
from .loader import Loader, get_data_loader
from .transforms import (
    AdditiveGaussianNoise,
    AffinityTransform,
    BoundaryTransform,
    Compose,
    GaussianBlur,
    RandomApply,
    RandomContrast,
    affinity_transform,
    boundary_transform,
    get_augmentations,
    get_raw_transform,
    labels_to_binary,
    normalize,
    select_label_transform,
    standardize,
)

__all__ = [
    "ImageCollectionDataset",
    "DualImageCollectionDataset",
    "DualRawImageCollectionDataset",
    "ConcatDataset",
    "MinForegroundSampler",
    "load_image",
    "Loader",
    "get_data_loader",
    "standardize",
    "normalize",
    "Compose",
    "RandomApply",
    "GaussianBlur",
    "AdditiveGaussianNoise",
    "RandomContrast",
    "get_raw_transform",
    "get_augmentations",
    "labels_to_binary",
    "boundary_transform",
    "affinity_transform",
    "BoundaryTransform",
    "AffinityTransform",
    "select_label_transform",
]
