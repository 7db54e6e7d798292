"""COCO instance annotations to label maps, without pycocotools (port of
``pda/data/builders/coco.py``).

The reference rasterizes LIVECell's COCO instance annotations with
``pycocotools.coco.COCO`` and ``annToMask`` into uint16 label TIFFs
(reference prob_utils/my_datasets/my_livecell.py:57-107). This module holds
the subset it needs: the JSON index, compressed and list RLE decoding in
numpy, and the polygon fill (:func:`fill_poly`), which gives what
``cv2.fillPoly`` gives, bit for bit, in numpy.
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


# OpenCV's polygon fill (drawing.cpp, FillEdgeCollection): edges in 16.16 fixed point
_XY_SHIFT = 16
_MAX_COORD = 1 << 20  # |coordinate| bound that keeps the fixed-point sums inside int64


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to the frame [0, w-1] x [0, h-1], its rounding
    included: (inside, x1, y1, x2, y2), the points moved even when it
    rejects the line."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's 8-connected ``Line``: clipped to the frame, then Bresenham
    from the left end, a minor step wherever the error term is negative."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1)
    steps = (2 * minor * k + major - 1) // (2 * major) if major else k
    if dy > dx:
        mask[y1 + sy * k, x1 + steps] = 1
    else:
        mask[y1 + sy * steps, x1 + k] = 1


def fill_poly(mask: np.ndarray, polygons) -> None:
    """``cv2.fillPoly(mask, polygons, 1)`` (8-connected, no shift), in place:
    every edge drawn as a clipped 8-connected line, then even-odd spans
    between the fixed-point edges of all polygons together. An edge keeps
    its rows but takes its slope from its clipped line (a vertical one where
    that collapses to one row); a span's ends round inward, and a span that
    reaches into the frame is clipped to it."""
    h, w = mask.shape
    edges = []
    for poly in polygons:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if any(abs(v) >= _MAX_COORD for p in pts for v in p):
            raise ValueError(f"polygon coordinates beyond +-{_MAX_COORD}")
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            _draw_line(mask, x0, y0, x1, y1)
            if y0 != y1:
                _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
                num, den = (t1x - t0x) << _XY_SHIFT, t1y - t0y
                # C's integer division (toward zero); 0 where the clipped line is one row
                dx = 0 if den == 0 else abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
                if y0 < y1:
                    edges.append((y0, y1, (t0x << _XY_SHIFT) + (y0 - t0y) * dx, dx))
                else:
                    edges.append((y1, y0, (t1x << _XY_SHIFT) + (y1 - t1y) * dx, dx))
            x0, y0 = x1, y1
    if len(edges) < 2:
        return
    ya, yb, x, dx = (np.array(c, dtype=np.int64) for c in zip(*edges))
    rows = np.arange(max(0, int(ya.min())), min(h, int(yb.max())))
    active = (ya[None] <= rows[:, None]) & (rows[:, None] < yb[None])
    xs = np.where(active, x[None] + (rows[:, None] - ya[None]) * dx[None], np.iinfo(np.int64).max)
    xs.sort(axis=1)
    counts = active.sum(axis=1)
    r, k = np.nonzero(np.arange(0, len(edges), 2)[None] < counts[:, None])
    k = 2 * k
    lo = (xs[r, k] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    hi = xs[r, k + 1] >> _XY_SHIFT
    keep = (lo < w) & (hi >= 0)
    lo, hi = np.maximum(lo, 0), np.minimum(hi, w - 1)
    keep &= lo <= hi
    span = np.zeros((h, w + 1), np.int32)
    np.add.at(span, (rows[r[keep]], lo[keep]), 1)
    np.add.at(span, (rows[r[keep]], hi[keep] + 1), -1)
    mask[np.cumsum(span[:, :w], axis=1) > 0] = 1


def polygons_to_mask(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [
        np.round(np.asarray(p, dtype=np.float64).reshape(-1, 2)).astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        fill_poly(mask, pts)
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
