"""Synthetic cell-like data for tests and benchmarks.

The reference has no test fixtures (SURVEY.md section 4); this module is the
framework's fake-data backend: blob images with matching binary masks whose
statistics loosely resemble microscopy patches, so every trainer / pipeline
can run end-to-end without any dataset download.
"""

from __future__ import annotations

import json
import os
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


# LIVECell's layout (pda_torch/data/builders/livecell.py): images under
# images/livecell_{train_val,test}_images/<TYPE>/, COCO annotations in
# {train,val,test}.json
LIVECELL_SPLITS = {"train": "livecell_train_val_images", "val": "livecell_train_val_images",
                   "test": "livecell_test_images"}


def rle_counts(mask: np.ndarray) -> list:
    """COCO run lengths of a bool mask: column-major, a zero run first."""
    flat = np.asarray(mask, dtype=bool).T.ravel()
    edges = np.flatnonzero(np.diff(flat.astype(np.int8))) + 1
    bounds = np.concatenate([[0], edges, [flat.size]])
    counts = np.diff(bounds).tolist()
    return [0] + counts if flat.size and flat[0] else counts


def rle_string(counts: list) -> str:
    """COCO's compressed RLE string of run lengths (pycocotools
    ``rleToString``): from the third run on, the difference to the run two
    before, in 5-bit groups with a continuation bit, offset by 48."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def write_livecell_tree(path: str, cell_types=("A172", "BT474"), *,
                        counts=(("train", 4), ("val", 1), ("test", 1)),
                        shape: Tuple[int, int] = (520, 704), seed: int = 0) -> dict:
    """A synthetic LIVECell tree at ``path``: for each cell type and split,
    blob frames (uint8 TIFFs, written by the port's codec) and their
    instances (connected blobs) in ``<split>.json``, in compressed RLE and
    list RLE by turns. Returns {split: [image paths]}."""
    from scipy import ndimage

    from .tiff import imwrite

    rng = np.random.default_rng(seed)
    written = {}
    for split, n in counts:
        images, anns = [], []
        for ct in cell_types:
            folder = os.path.join(path, "images", LIVECELL_SPLITS[split], ct)
            os.makedirs(folder, exist_ok=True)
            for k in range(n):
                raw, mask = make_blob_image(shape, n_blobs=24, rng=rng)
                name = f"{ct}_Phase_{split}_{k}_00d00h00m_1.tif"
                imwrite(os.path.join(folder, name),
                        np.clip(raw * 96 + 48, 0, 255).astype(np.uint8))
                written.setdefault(split, []).append(os.path.join(folder, name))
                image_id = len(images) + 1
                images.append({"id": image_id, "file_name": name, "height": shape[0],
                               "width": shape[1]})
                labels, n_inst = ndimage.label(mask > 0)
                for inst in range(1, n_inst + 1):
                    runs = rle_counts(labels == inst)
                    counts_field = rle_string(runs) if len(anns) % 2 == 0 else runs
                    anns.append({"id": len(anns) + 1, "image_id": image_id, "category_id": 1,
                                 "iscrowd": 0, "segmentation": {"size": list(shape),
                                                                "counts": counts_field}})
        with open(os.path.join(path, f"{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1, "name": "cell"}]}, f)
    return written
