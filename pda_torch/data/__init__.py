"""Data pipelines (port of ``pda.data``): numpy transforms, the 2D patch
datasets and the HDF5 volume datasets, the loader, synthetic data, the
file codecs the card machine needs (:mod:`.tiff`, :mod:`.png`, :mod:`.h5`,
:mod:`.bmp`), OpenCV's area and nearest resize (:mod:`.resize`) and the
LIVECell, EM and Lung X-Ray builders (:mod:`.builders`), OpenCV's Gaussian
blur (:mod:`.blur`) and ``pda``'s native host library (:mod:`.native`,
switched by ``PDA_NATIVE_AUGS``). numpy on the host: the trainer moves
batches to the card."""

from .datasets import (
    ConcatDataset,
    DualImageCollectionDataset,
    DualRawImageCollectionDataset,
    DualSegmentationDataset,
    ImageCollectionDataset,
    LazyH5Volume,
    MinForegroundSampler,
    SegmentationDataset,
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
    "SegmentationDataset",
    "DualSegmentationDataset",
    "LazyH5Volume",
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
