"""Synthetic cell-like data for tests and benchmarks.

The reference has no test fixtures (SURVEY.md section 4); this module is the
framework's fake-data backend: blob images with matching binary masks whose
statistics loosely resemble microscopy patches, so every trainer / pipeline
can run end-to-end without any dataset download.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_blob_image(
    shape: Tuple[int, int] = (128, 128),
    n_blobs: int = 8,
    rng: Optional[np.random.Generator] = None,
    noise: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(raw, binary_mask) pair: gaussian blobs on a noisy background."""
    rng = np.random.default_rng(0) if rng is None else rng
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    raw = np.zeros(shape, dtype=np.float32)
    mask = np.zeros(shape, dtype=np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(h * 0.04, h * 0.12), rng.uniform(w * 0.04, w * 0.12)
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        raw += np.exp(-0.5 * d2).astype(np.float32)
        mask[d2 < 1.0] = 1.0
    raw = raw + noise * rng.standard_normal(shape).astype(np.float32)
    return raw, mask


def make_dataset_arrays(
    n_images: int = 4,
    shape: Tuple[int, int] = (128, 128),
    seed: int = 0,
    instance_labels: bool = False,
):
    """Lists of (raw, label) arrays for feeding the patch datasets."""
    rng = np.random.default_rng(seed)
    raws, labels = [], []
    for i in range(n_images):
        raw, mask = make_blob_image(shape, rng=rng)
        if instance_labels:
            # give each blob-ish connected region a distinct id (coarse)
            from scipy import ndimage

            lab, _ = ndimage.label(mask > 0)
            mask = lab.astype(np.float32)
        raws.append(raw)
        labels.append(mask)
    return raws, labels


def make_consensus_arrays(labels, seed: int = 0):
    """Fake consensus masks: mostly-ones with random uncertain holes."""
    rng = np.random.default_rng(seed)
    out = []
    for lab in labels:
        cons = np.ones_like(np.asarray(lab, dtype=np.float32))
        holes = rng.random(cons.shape) < 0.1
        cons[holes] = rng.uniform(0.2, 0.9, size=int(holes.sum())).astype(np.float32)
        out.append(cons)
    return out
