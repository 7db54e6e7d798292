"""MitoEM and UroCell acquisition (port of ``pda/data/builders/prepare.py``):
fetch the upstream archives where missing and ``download`` allows it, and
convert them to the HDF5 volumes the loaders read, with the port's codecs
(slices through :mod:`pda_torch.data.tiff` / :mod:`pda_torch.data.png`,
volumes through :mod:`pda_torch.data.h5`).

  * MitoEM: per sample (human, rat), a zip of raw slices (``im/``) and
    instance-label slices for the annotated range, train the first
    ``len(train labels)`` slices, val the next. The conversion streams one
    slice at a time into chunked datasets (chunks = one slice), so a
    multi-GB volume never sits whole in memory.
  * UroCell: the github archive's raw volumes ``data/*.nii.gz`` and labels
    ``<target>/*.nii.gz``; each labeled volume becomes ``<name>.h5`` with
    ``raw`` and ``labels/<target>``, read by a minimal NIfTI-1 reader.
"""

from __future__ import annotations

import gzip
import os
import struct
from glob import glob
from typing import Optional, Sequence

import numpy as np

from .. import h5
from ..tiff import imwrite, read_image
from .util import download_source, unzip

MITOEM_URLS = {
    "human": "https://huggingface.co/datasets/pytc/MitoEM/resolve/main/EM30-H-mito-train-val-v2.zip",
    "rat": "https://huggingface.co/datasets/pytc/MitoEM/resolve/main/EM30-R-mito-train-val-v2.zip",
}
UROCELL_URL = (
    "https://github.com/MancaZerovnikMekuc/UroCell/archive/refs/heads/master.zip"
)
SLICE_EXTS = (".png", ".tif", ".tiff")

# ---------------------------------------------------------------------------
# minimal NIfTI-1 reader
# ---------------------------------------------------------------------------

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}


def read_nifti(path: str) -> np.ndarray:
    """A (possibly gzipped) NIfTI-1 volume, transposed from the file's
    x-fastest order to (z, y, x)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.read(348)
        byte_order = "<"
        if struct.unpack("<i", header[:4])[0] != 348:
            if struct.unpack(">i", header[:4])[0] != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            byte_order = ">"
        dim = struct.unpack(byte_order + "8h", header[40:56])
        shape = tuple(dim[1: 1 + dim[0]])
        datatype = struct.unpack(byte_order + "h", header[70:72])[0]
        vox_offset = int(struct.unpack(byte_order + "f", header[108:112])[0])
        if datatype not in _NIFTI_DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(byte_order)
        f.read(max(vox_offset - 348, 0))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
    return np.ascontiguousarray(data.reshape(shape[::-1]))


# ---------------------------------------------------------------------------
# MitoEM
# ---------------------------------------------------------------------------


def _find_slice_dirs(root: str):
    """The raw-slice folder and the train and val label folders of an
    extracted MitoEM sample (``im/``, ``mito-train-v2/``, ``mito-val-v2/`` or
    names like them)."""
    im_dir, seg_train, seg_val = None, None, None
    for dirpath, _, filenames in os.walk(root):
        name = os.path.basename(dirpath).lower()
        if not any(f.endswith(SLICE_EXTS) for f in filenames):
            continue
        if name.startswith("im"):
            im_dir = dirpath
        elif "train" in name:
            seg_train = dirpath
        elif "val" in name:
            seg_val = dirpath
    return im_dir, seg_train, seg_val


def _files(directory: str):
    return sorted(f for f in glob(os.path.join(directory, "*")) if f.endswith(SLICE_EXTS))


def _stream_h5(out_path: str, raw_files: Sequence[str], seg_files: Sequence[str]):
    """``raw`` and ``labels`` volumes written one slice at a time."""
    if len(raw_files) != len(seg_files):
        raise ValueError(f"{len(raw_files)} raw slices for {len(seg_files)} label slices")
    first_raw, first_seg = read_image(raw_files[0]), read_image(seg_files[0])
    n = len(raw_files)
    with h5.Writer(out_path) as f:
        raw_ds = f.create_dataset("raw", shape=(n, *first_raw.shape), dtype=first_raw.dtype,
                                  chunks=(1, *first_raw.shape))
        lab_ds = f.create_dataset("labels", shape=(n, *first_seg.shape), dtype=first_seg.dtype,
                                  chunks=(1, *first_seg.shape))
        for i, (rf, sf) in enumerate(zip(raw_files, seg_files)):
            raw_ds[i] = read_image(rf)
            lab_ds[i] = read_image(sf)


def prepare_mitoem_sample(path: str, sample: str, download: bool = False,
                          url: Optional[str] = None):
    """``<path>/<sample>_{train,val}.h5`` from the sample's zip (fetched where
    missing and ``download`` allows it) or its extracted ``<sample>_raw``
    tree."""
    train_out = os.path.join(path, f"{sample}_train.h5")
    val_out = os.path.join(path, f"{sample}_val.h5")
    if os.path.exists(train_out) and os.path.exists(val_out):
        return train_out, val_out
    os.makedirs(path, exist_ok=True)

    extract_root = os.path.join(path, f"{sample}_raw")
    if not os.path.exists(extract_root):
        zip_path = os.path.join(path, f"{sample}.zip")
        download_source(zip_path, url or MITOEM_URLS[sample], download)
        os.makedirs(extract_root, exist_ok=True)
        unzip(zip_path, extract_root, remove=True)

    im_dir, seg_train_dir, seg_val_dir = _find_slice_dirs(extract_root)
    if not im_dir:
        raise RuntimeError(f"no raw image dir under {extract_root}")
    if not (seg_train_dir and seg_val_dir):
        raise RuntimeError(f"missing train/val segmentation dirs under {extract_root}")
    raw_files = _files(im_dir)
    seg_train, seg_val = _files(seg_train_dir), _files(seg_val_dir)
    _stream_h5(train_out, raw_files[: len(seg_train)], seg_train)
    _stream_h5(val_out, raw_files[len(seg_train): len(seg_train) + len(seg_val)], seg_val)
    return train_out, val_out


# ---------------------------------------------------------------------------
# UroCell
# ---------------------------------------------------------------------------


def get_uro_cell_paths(path: str, download: bool = False, target: str = "mito"):
    """The sorted ``<name>.h5`` volumes (``raw`` and ``labels/<target>``)
    under ``path``, converted from the UroCell archive first where there
    are none."""
    os.makedirs(path, exist_ok=True)
    existing = sorted(glob(os.path.join(path, "*.h5")))
    if existing:
        return existing

    extract_root = os.path.join(path, "UroCell-master")
    if not os.path.exists(extract_root):
        zip_path = os.path.join(path, "urocell.zip")
        download_source(zip_path, UROCELL_URL, download)
        unzip(zip_path, path, remove=True)
        candidates = glob(os.path.join(path, "UroCell-*"))
        if not candidates:
            raise RuntimeError(f"unzip produced no UroCell dir under {path}")
        extract_root = candidates[0]

    raw_files = sorted(glob(os.path.join(extract_root, "data", "*.nii.gz")))
    if not raw_files:
        raise RuntimeError(f"no raw volumes under {extract_root}/data")
    out_paths = []
    for raw_file in raw_files:
        name = os.path.basename(raw_file).replace(".nii.gz", "")
        label_file = os.path.join(extract_root, target, f"{name}.nii.gz")
        if not os.path.exists(label_file):
            continue  # only labeled volumes become datasets
        raw, labels = read_nifti(raw_file), read_nifti(label_file)
        if raw.shape != labels.shape:
            raise ValueError(f"{name}: raw {raw.shape} and labels {labels.shape} differ")
        out = os.path.join(path, f"{name}.h5")
        with h5.Writer(out) as f:
            f.create_dataset("raw", data=raw, chunks=(1, *raw.shape[1:]))
            f.create_dataset(f"labels/{target}", data=labels, chunks=(1, *labels.shape[1:]))
        out_paths.append(out)
    if not out_paths:
        raise RuntimeError(f"no labeled UroCell volumes found under {extract_root}")
    return sorted(out_paths)


def prepare_urocell_slices(path: str, download: bool = False):
    """The last UroCell volume's slices with foreground, as TIFF pairs
    ``preprocessed/{NNNNN}_image.tif`` and ``_gt.tif`` (binary) for
    prediction and evaluation."""
    paths = get_uro_cell_paths(os.path.join(path, "urocell"), download)
    base_dir = os.path.join(path, "urocell", "preprocessed")
    os.makedirs(base_dir, exist_ok=True)
    with h5.File(sorted(paths)[-1]) as f:
        raw, labels = f["raw"][...], f["labels/mito"][...]
    counter = 0
    for r, lab in zip(raw, labels):
        if len(np.unique(lab)) > 1:
            imwrite(os.path.join(base_dir, f"{counter:05}_image.tif"), r)
            imwrite(os.path.join(base_dir, f"{counter:05}_gt.tif"), (lab > 0).astype("uint8"))
            counter += 1
    return base_dir
