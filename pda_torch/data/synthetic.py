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
    yy, xx = np.arange(h)[:, None], np.arange(w)[None, :]  # broadcast: mgrid's values
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


# The Lung X-Ray suite's raw layout (pda_torch/data/builders/lung.py and the
# lung_prepare_data command's --data ROOT form), at the sources' own frame
# sizes: JSRT scans 2048^2, ChestX-ray14 (NIH) 1024^2, Montgomery CXRs
# 4020x4892 and 4892x4020 (width x height) with 12-bit greys in 16-bit PNGs.
LUNG_SHAPES = {"jsrt1": [(2048, 2048)], "jsrt2": [(2048, 2048)], "nih": [(1024, 1024)],
               "montgomery": [(4892, 4020), (4020, 4892)]}
LUNG_COUNTS = {"jsrt1": (3, 1), "jsrt2": (3, 1), "nih": (3, 1), "montgomery": 5}
JSRT2_LABEL_SUFFIX = "_lungs"  # 6 characters, stripped by the jsrt2 dice remap


def make_lung_frame(shape: Tuple[int, int], rng: np.random.Generator):
    """(raw in [0, 1] float32, lung mask bool): two jittered ellipses,
    darker than a graded background, with noise."""
    h, w = shape
    yy = (np.arange(h, dtype=np.float32) / h)[:, None]
    xx = (np.arange(w, dtype=np.float32) / w)[None, :]
    mask = np.zeros(shape, bool)
    for cx in (0.3, 0.7):
        cy, rx, ry = rng.uniform(0.45, 0.55), rng.uniform(0.12, 0.18), rng.uniform(0.25, 0.35)
        cx = cx + rng.uniform(-0.03, 0.03)
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    raw = 0.55 + 0.25 * yy - 0.35 * mask + 0.05 * rng.standard_normal(shape, np.float32)
    return np.clip(raw, 0.0, 1.0).astype(np.float32), mask


def write_bmp(path: str, image: np.ndarray) -> None:
    """A 2D uint8 array as an 8-bit BMP with the grey ramp as its palette
    (BITMAPINFOHEADER, bottom-up), as JSRT segmentation02's raw images are
    read: ``imageio`` and :func:`pda_torch.data.bmp.imread` give the array
    back."""
    a = np.asarray(image)
    if a.ndim != 2 or a.dtype != np.uint8:
        raise ValueError(f"write_bmp takes a 2D uint8 array, got {a.dtype} {a.shape}")
    h, w = a.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = a[::-1]
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
    palette[:, 3] = 0
    offset = 14 + 40 + palette.nbytes
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", offset + rows.nbytes, 0, 0, offset)
                + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.nbytes, 2835, 2835, 256, 0)
                + palette.tobytes() + rows.tobytes())


def write_lung_tree(path: str, seed: int = 0, *, shapes: Optional[dict] = None,
                    counts: Optional[dict] = None) -> dict:
    """A synthetic Lung X-Ray tree at ``path`` (the ``--data`` root), from
    ``seed``, in the four raw layouts that the builders and
    ``lung_prepare_data`` read:

      jsrt1/{train,test}/{org,label}/*.png      8-bit raw, labels 0/255
      jsrt2/{org,label}_{train,test}/           raw 8-bit grey-palette
          ``*.bmp``, labels ``<name>_lungs.png`` (the 6-character suffix
          the jsrt2 dice remap strips)
      montgomery/CXR_png/*.png                  16-bit, 12-bit greys
      montgomery/ManualMask/{leftMask,rightMask}/*.png   0/255, one lung each
      nih/{images,labels}/{train,test}/*.png    8-bit, labels 0/255

    Frames are ``shapes[domain]`` (default :data:`LUNG_SHAPES`, Montgomery
    alternating between its two), ``counts[domain]`` of them ((train,
    test), or the Montgomery total; default :data:`LUNG_COUNTS`). The frames
    are drawn in turn and written by a pool of threads (zlib lets go of the
    GIL). Returns {domain: its folder}."""
    from concurrent.futures import ThreadPoolExecutor

    from .png import imwrite as png_write

    shapes = {**LUNG_SHAPES, **(shapes or {})}
    counts = {**LUNG_COUNTS, **(counts or {})}
    rng = np.random.default_rng(seed)

    def frames(domain, n):
        for k in range(n):
            raw, mask = make_lung_frame(shapes[domain][k % len(shapes[domain])], rng)
            yield k, raw, mask

    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
    writes = []

    def save(folder, name, write, a):
        os.makedirs(folder, exist_ok=True)
        writes.append(pool.submit(write, os.path.join(folder, name), a))

    out = {}
    for domain in ("jsrt1", "jsrt2", "nih"):
        root = out[domain] = os.path.join(path, domain)
        for split, n in zip(("train", "test"), counts[domain]):
            for k, raw, mask in frames(domain, n):
                img, lab = (raw * 255).astype(np.uint8), mask.astype(np.uint8) * 255
                name = f"{domain.upper()}{split}{k:03}"
                if domain == "jsrt1":
                    save(os.path.join(root, split, "org"), name + ".png", png_write, img)
                    save(os.path.join(root, split, "label"), name + ".png", png_write, lab)
                elif domain == "jsrt2":
                    save(os.path.join(root, f"org_{split}"), name + ".bmp", write_bmp, img)
                    save(os.path.join(root, f"label_{split}"),
                         name + JSRT2_LABEL_SUFFIX + ".png", png_write, lab)
                else:
                    save(os.path.join(root, "images", split), name + ".png", png_write, img)
                    save(os.path.join(root, "labels", split), name + ".png", png_write, lab)

    root = out["montgomery"] = os.path.join(path, "montgomery")
    for k, raw, mask in frames("montgomery", counts["montgomery"]):
        name = f"MCUCXR_{k:04}_{k % 2}.png"
        save(os.path.join(root, "CXR_png"), name, png_write, (raw * 4095).astype(np.uint16))
        half = mask.shape[1] // 2
        for side, cols in (("rightMask", slice(0, half)), ("leftMask", slice(half, None))):
            one = np.zeros_like(mask)
            one[:, cols] = mask[:, cols]
            save(os.path.join(root, "ManualMask", side), name, png_write,
                 one.astype(np.uint8) * 255)
    with pool:
        for w in writes:
            w.result()
    return out
