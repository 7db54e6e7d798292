"""Synthetic cell-like data for tests and benchmarks.

The reference has no test fixtures (SURVEY.md section 4); this module is the
framework's fake-data backend: blob images with matching binary masks whose
statistics loosely resemble microscopy patches, so every trainer / pipeline
can run end-to-end without any dataset download.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import tempfile
import zipfile
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


# The MitoEM suite's layout (pda_torch/data/builders/{em,prepare}.py): the
# source samples as extracted slice folders, the VNC and Lucchi++ archives as
# the zips their builders unzip (a zip in place is never fetched), UroCell as
# its extracted github tree of NIfTI volumes.
MITOEM_SHAPES = {"mitoem": (512, 512), "vnc": (512, 512), "lucchi": (512, 512),
                 "urocell": (512, 512)}


def _blob_stack(rng, n, shape, n_blobs):
    """``n`` uint8 frames and their instance labels (connected blobs)."""
    from scipy import ndimage

    raws, labels = [], []
    for _ in range(n):
        raw, mask = make_blob_image(shape, n_blobs=n_blobs, rng=rng)
        raws.append(np.clip(raw * 96 + 48, 0, 255).astype(np.uint8))
        labels.append(ndimage.label(mask > 0)[0].astype(np.uint16))
    return raws, labels


def write_nifti(path: str, volume: np.ndarray) -> None:
    """A gzipped NIfTI-1 file of a (z, y, x) uint8 volume (x fastest on disk)."""
    vol = np.ascontiguousarray(volume, dtype=np.uint8)
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, 3, vol.shape[2], vol.shape[1], vol.shape[0], 1, 1, 1, 1)
    struct.pack_into("<hh", header, 70, 2, 8)  # datatype uint8, 8 bits
    struct.pack_into("<f", header, 108, 352.0)
    header[344:348] = b"n+1\0"
    with gzip.open(path, "wb") as f:
        f.write(bytes(header) + vol.tobytes())


def _zip_tree(src: str, zip_path: str) -> None:
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as z:
        for d, _, files in os.walk(src):
            for name in sorted(files):
                full = os.path.join(d, name)
                z.write(full, os.path.relpath(full, os.path.dirname(src)))


def write_mitoem_tree(path: str, seed: int = 0, *, shapes: Optional[dict] = None,
                      mitoem_slices=(4, 2), vnc_slices=(3, 3), lucchi_slices=(4, 2),
                      urocell_volumes: int = 3, urocell_depth: int = 3,
                      n_blobs: int = 40) -> dict:
    """A synthetic MitoEM-suite data tree at ``path``, from ``seed``:

      mitoem/{human,rat}_raw/{im,mito-train-v2,mito-val-v2}/  raw PNG slices
          (``mitoem_slices`` train + val of them) and uint16 instance TIFFs
      vnc/vnc.zip         stack1/raw/*.tif, stack1/mitochondria/*.png
                          (0/255), stack2/raw/*.tif (``vnc_slices``)
      lucchi/lucchi.zip   Lucchi++/{Test,Train}_{In,Out}/*.png: gray raw
                          ``maskNNNN.png``, masks ``N.png`` (Test_Out RGB,
                          Train_Out gray, 0/255)
      urocell/UroCell-master/{data,mito}/fib1-*.nii.gz  uint8 volumes

    blob frames of ``shapes[name]`` (default 512x512, one 512^2 patch each),
    whose foreground is well above the samplers' 5% (1% for UroCell).
    Returns {dataset: its folder}."""
    from .png import imwrite as png_write
    from .tiff import imwrite as tif_write

    shapes = {**MITOEM_SHAPES, **(shapes or {})}
    rng = np.random.default_rng(seed)
    out = {}
    for sample in ("human", "rat"):
        root = os.path.join(path, "mitoem", f"{sample}_raw")
        raws, labels = _blob_stack(rng, sum(mitoem_slices), shapes["mitoem"], n_blobs)
        for k, (raw, lab) in enumerate(zip(raws, labels)):
            folder = "mito-train-v2" if k < mitoem_slices[0] else "mito-val-v2"
            for sub, name, write, a in (("im", f"im{k:04}.png", png_write, raw),
                                        (folder, f"seg{k:04}.tif", tif_write, lab)):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                write(os.path.join(root, sub, name), a)
    out["mitoem"] = os.path.join(path, "mitoem")

    with tempfile.TemporaryDirectory(dir=path) as tmp:
        vnc = os.path.join(tmp, "groundtruth-drosophila-vnc-master")
        for stack, n in (("stack1", vnc_slices[0]), ("stack2", vnc_slices[1])):
            raws, labels = _blob_stack(rng, n, shapes["vnc"], n_blobs)
            for k, (raw, lab) in enumerate(zip(raws, labels)):
                os.makedirs(os.path.join(vnc, stack, "raw"), exist_ok=True)
                tif_write(os.path.join(vnc, stack, "raw", f"{k:02}.tif"), raw)
                if stack == "stack1":
                    os.makedirs(os.path.join(vnc, stack, "mitochondria"), exist_ok=True)
                    png_write(os.path.join(vnc, stack, "mitochondria", f"{k:02}.png"),
                              np.where(lab > 0, 255, 0).astype(np.uint8))
        os.makedirs(os.path.join(path, "vnc"), exist_ok=True)
        _zip_tree(vnc, os.path.join(path, "vnc", "vnc.zip"))

        lucchi = os.path.join(tmp, "Lucchi++")
        for part, n in (("Test", lucchi_slices[0]), ("Train", lucchi_slices[1])):
            raws, labels = _blob_stack(rng, n, shapes["lucchi"], n_blobs)
            for d in ("In", "Out"):
                os.makedirs(os.path.join(lucchi, f"{part}_{d}"), exist_ok=True)
            for k, (raw, lab) in enumerate(zip(raws, labels)):
                png_write(os.path.join(lucchi, f"{part}_In", f"mask{k:04}.png"), raw)
                mask = np.where(lab > 0, 255, 0).astype(np.uint8)
                png_write(os.path.join(lucchi, f"{part}_Out", f"{k}.png"),
                          np.repeat(mask[..., None], 3, -1) if part == "Test" else mask)
        os.makedirs(os.path.join(path, "lucchi"), exist_ok=True)
        _zip_tree(lucchi, os.path.join(path, "lucchi", "lucchi.zip"))

    uro = os.path.join(path, "urocell", "UroCell-master")
    for sub in ("data", "mito"):
        os.makedirs(os.path.join(uro, sub), exist_ok=True)
    for v in range(urocell_volumes):
        raws, labels = _blob_stack(rng, urocell_depth, shapes["urocell"], n_blobs)
        write_nifti(os.path.join(uro, "data", f"fib1-{v}-0-0.nii.gz"), np.stack(raws))
        write_nifti(os.path.join(uro, "mito", f"fib1-{v}-0-0.nii.gz"),
                    (np.stack(labels) > 0).astype(np.uint8))
    for name in ("vnc", "lucchi", "urocell"):
        out[name] = os.path.join(path, name)
    return out
