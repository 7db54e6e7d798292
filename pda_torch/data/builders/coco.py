"""COCO instance annotations to label maps, without pycocotools (port of
``pda/data/builders/coco.py``).

The reference rasterizes LIVECell's COCO instance annotations with
``pycocotools.coco.COCO`` and ``annToMask`` into uint16 label TIFFs
(reference prob_utils/my_datasets/my_livecell.py:57-107). This module holds
the subset it needs: the JSON index, compressed and list RLE decoding in
numpy, and the polygon fill through cv2 (imported on first use, as ``pda``
does; a host-side preparation step).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


class COCOIndex:
    """Tiny subset of the pycocotools COCO index."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            data = json.load(f)
        self.images: Dict[int, dict] = {im["id"]: im for im in data.get("images", [])}
        self.categories = {c["id"]: c for c in data.get("categories", [])}
        self.anns_by_image: Dict[int, List[dict]] = {}
        anns = data.get("annotations", [])
        if isinstance(anns, dict):  # some LIVECell exports key annotations by id
            anns = list(anns.values())
        for ann in anns:
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)

    def image_ids(self) -> List[int]:
        return list(self.images.keys())

    def annotations(self, image_id: int) -> List[dict]:
        return self.anns_by_image.get(image_id, [])


def _decode_compressed_rle(counts_str: str) -> List[int]:
    """COCO compressed-RLE string -> run-length counts (LEB128-style)."""
    counts: List[int] = []
    i = 0
    n = len(counts_str)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts_str[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: dict) -> np.ndarray:
    """COCO RLE (compressed string or plain counts list) -> bool mask (H, W)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _decode_compressed_rle(counts)
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for run in counts:
        if val:
            flat[pos : pos + run] = True
        pos += run
        val = not val
    # COCO RLE is column-major
    return flat.reshape((w, h)).T


def polygons_to_mask(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    import cv2

    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [
        np.round(np.asarray(p, dtype=np.float64).reshape(-1, 2)).astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


def annotation_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if isinstance(seg, dict):  # RLE
        return rle_to_mask(seg)
    return polygons_to_mask(seg, h, w)


def rasterize_annotations(index: COCOIndex, image_id: int) -> np.ndarray:
    """All instances of one image -> uint16 instance-label map
    (id 1..n in annotation order, later instances overwrite — matching the
    reference's paint order, my_livecell.py:96-101)."""
    meta = index.images[image_id]
    h, w = meta["height"], meta["width"]
    seg = np.zeros((h, w), dtype=np.uint16)
    anns = index.annotations(image_id)
    assert len(anns) <= np.iinfo("uint16").max
    for seg_id, ann in enumerate(anns, 1):
        mask = annotation_to_mask(ann, h, w)
        seg[mask] = seg_id
    return seg
