"""The port's EM builders (pda_torch/data/builders/{em,prepare}.py) and
volume datasets against ``pda``'s on the CPU, over a small synthetic MitoEM
suite tree (``write_mitoem_tree``): the HDF5 volumes each builder converts
(VNC, Lucchi++ with its RGB masks and its Test/Train swap, UroCell, MitoEM
streamed slice by slice) equal to the ones ``pda`` writes with h5py, and the
UroCell evaluation slices; ``read_nifti``; each loader's datasets and, with
the same seeds, its first batches (VNC's partition reversal, Lucchi++, the
UroCell split, MitoEM's per-volume sample counts, the reference's dual
segmentation helper with ROIs); MitoEM's refusal of a missing volume; the
UroCell volumes found where the prepare step writes them (``pda`` looks one
folder down and fetches again). ``urlretrieve`` is patched to raise. Exact
data paths: every comparison is bit-equal."""

import gzip
import os
import shutil
import struct
import urllib.request

import h5py
import numpy as np
import pytest

import pda.data.builders.em as jem
import pda.data.builders.prepare as jprep
import pda.experiments.common as jcommon
from pda.data import MinForegroundSampler as JSampler
from pda_torch.data import MinForegroundSampler, h5, tiff
from pda_torch.data.builders import em as tem
from pda_torch.data.builders import prepare as tprep
from pda_torch.data.synthetic import write_mitoem_tree, write_nifti
from pda_torch.experiments import common as tcommon
from torch_port_utils import numpy_augs

SHAPES = {"mitoem": (48, 64), "vnc": (40, 56), "lucchi": (44, 52), "urocell": (36, 40)}
PATCH = (1, 32, 32)


@pytest.fixture(autouse=True)
def _no_fetch(monkeypatch):
    def refuse(url, path):
        raise OSError(f"this test fetches nothing ({url})")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("em") / "data")
    write_mitoem_tree(root, seed=3, shapes=SHAPES, mitoem_slices=(5, 3), vnc_slices=(4, 4),
                      lucchi_slices=(4, 3), urocell_volumes=4, urocell_depth=3, n_blobs=6)
    return root


def _copy(tree, name):
    dst = os.path.join(os.path.dirname(tree), name)
    if not os.path.exists(dst):
        shutil.copytree(tree, dst)
    return dst


def _prepared(tree, side):
    """The tree converted by one side's builders (once per side)."""
    root = os.path.join(os.path.dirname(tree), f"prepared_{side}")
    if not os.path.exists(root):
        shutil.copytree(tree, root)
        em, prep = (tem, tprep) if side == "port" else (jem, jprep)
        em._get_vnc_data(os.path.join(root, "vnc"), download=False)
        em._require_lucchi_data(os.path.join(root, "lucchi"), download=False)
        prep.prepare_urocell_slices(root, download=False)
        for sample in ("human", "rat"):
            prep.prepare_mitoem_sample(os.path.join(root, "mitoem"), sample)
    return root


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[...])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


VOLUMES = ["vnc/vnc_train.h5", "vnc/vnc_test.h5", "lucchi/lucchi_train.h5",
           "lucchi/lucchi_test.h5", "mitoem/human_train.h5", "mitoem/human_val.h5",
           "mitoem/rat_train.h5", "mitoem/rat_val.h5"] + [
    f"urocell/fib1-{v}-0-0.h5" for v in range(4)]


@pytest.mark.parametrize("volume", VOLUMES)
def test_converted_volumes_match_pda(tree, volume):
    """Every dataset of every converted file: same names, shapes, dtypes
    and values, read by h5py and by the port's reader."""
    port = os.path.join(_prepared(tree, "port"), volume)
    ref = os.path.join(_prepared(tree, "pda"), volume)
    a, b = _h5_items(port), _h5_items(ref)
    assert sorted(a) == sorted(b) and a
    with h5.File(port) as f:
        for name in a:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
            assert np.array_equal(f[name][...], a[name])
    if "mitoem" in volume or "urocell" in volume:
        with h5py.File(port, "r") as f:
            assert f["raw"].chunks == (1, *f["raw"].shape[1:])


def test_extracted_trees_and_urocell_slices_match_pda(tree):
    """The kept extracted trees (prediction and evaluation read them) and
    the UroCell slices written for evaluation."""
    port, ref = _prepared(tree, "port"), _prepared(tree, "pda")
    files = {}
    for side, root in (("port", port), ("pda", ref)):
        files[side] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs
                             if not f.endswith((".h5", ".zip")))
    assert files["port"] == files["pda"]
    slices = [f for f in files["port"] if "preprocessed" in f]
    assert slices and len(slices) % 2 == 0
    for rel in slices:
        a, b = tiff.imread(os.path.join(port, rel)), tiff.imread(os.path.join(ref, rel))
        assert a.dtype == b.dtype and np.array_equal(a, b), rel
    assert os.path.isdir(os.path.join(port, "vnc", "groundtruth-drosophila-vnc-master"))
    assert os.path.isdir(os.path.join(port, "lucchi", "Lucchi++"))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("gz", [True, False])
def test_read_nifti_matches_pda(order, gz, tmp_path):
    vol = np.random.default_rng(1).integers(0, 255, (3, 5, 7), dtype=np.uint8)
    path = str(tmp_path / ("v.nii.gz" if gz else "v.nii"))
    if order == "<" and gz:
        write_nifti(path, vol)
    else:
        data = vol.astype(f"{order}i2")
        header = bytearray(352)
        struct.pack_into(f"{order}i", header, 0, 348)
        struct.pack_into(f"{order}8h", header, 40, 3, 7, 5, 3, 1, 1, 1, 1)
        struct.pack_into(f"{order}hh", header, 70, 4, 16)
        struct.pack_into(f"{order}f", header, 108, 352.0)
        with (gzip.open if gz else open)(path, "wb") as f:
            f.write(bytes(header) + data.tobytes())
    a, b = tprep.read_nifti(path), jprep.read_nifti(path)
    assert a.dtype == b.dtype and a.shape == b.shape == (3, 5, 7) and np.array_equal(a, b)
    assert np.array_equal(a, vol)


def _loader(kind, em, common, sampler_cls, root):
    weak, strong = common.weak_augmentations(), common.mitoem_strong_augmentations()
    sampler = sampler_cls(min_fraction=0.05)
    kw = dict(num_workers=0, seed=7)
    if kind.startswith("vnc"):
        return em.get_vnc_mito_loader(os.path.join(root, "vnc"), PATCH,
                                      partition=kind.split("_")[1], binary=True, batch_size=2,
                                      augmentation1=weak, augmentation2=strong, sampler=sampler,
                                      n_samples=6, **kw)
    if kind.startswith("lucchi"):
        return em.get_lucchi_loader(os.path.join(root, "lucchi"), kind.split("_")[1],
                                    patch_shape=PATCH, batch_size=2, augmentation1=weak,
                                    augmentation2=strong, sampler=sampler, **kw)
    if kind.startswith("urocell"):
        paths = sorted(h5py_glob(os.path.join(root, "urocell")))
        return em.get_uro_cell_loader(os.path.join(root, "urocell"), kind.split("_")[1],
                                      patch_shape=PATCH, batch_size=2, augmentation1=weak,
                                      augmentation2=weak, sampler=sampler_cls(0.01),
                                      n_samples=8, volume_paths=paths, **kw)
    if kind.startswith("mitoem"):
        split = kind.split("_")[1]
        return em.get_mitoem_loader(os.path.join(root, "mitoem"), split, PATCH, 2, binary=True,
                                    sampler=sampler, n_samples=None if split == "train" else 10,
                                    **kw)
    vol = os.path.join(root, "lucchi", "lucchi_train.h5")
    return em.default_dual_segmentation_loader(
        [vol, vol], "raw", [vol, vol], "labels", batch_size=2, patch_shape=PATCH, num_workers=0,
        binary=True, augmentation1=weak, augmentation2=strong, n_samples=6,
        rois=[slice(0, 2), slice(1, None, 2)])


def h5py_glob(folder):
    return [os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".h5")]


LOADERS = ["vnc_tr", "vnc_ts", "lucchi_train", "lucchi_test", "urocell_train", "urocell_val",
           "mitoem_train", "mitoem_val", "dual_helper"]


@pytest.mark.parametrize("kind", LOADERS)
def test_loaders_match_pda(tree, kind):
    """The same datasets (volume lengths, labels or none, sample counts) and,
    inline with the same seed, the same first two batches (pda's numpy
    augmentations)."""
    port_root, ref_root = _prepared(tree, "port"), _prepared(tree, "pda")
    with numpy_augs():
        port = _loader(kind, tem, tcommon, MinForegroundSampler, port_root)
        ref = _loader(kind, jem, jcommon, JSampler, ref_root)
        assert len(port) == len(ref) >= 1
        assert len(port.dataset) == len(ref.dataset)
        if kind == "vnc_tr":  # stack2: no labels, no sampler
            assert port.dataset.labels is None and port.dataset.sampler is None
        if kind == "vnc_ts":
            assert port.dataset.labels is not None
        pit, rit = iter(port), iter(ref)
        batches = [(next(pit), next(rit)) for _ in range(min(2, len(port)))]
    for pb, rb in batches:
        assert len(pb) == len(rb) == (2 if kind.startswith("mitoem") else 4)
        for a, b in zip(pb, rb):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_lazy_volumes_sample_the_same(tree, monkeypatch):
    """A volume read window by window (above EAGER_LIMIT_BYTES) gives the
    eager dataset's samples and pda's lazy ones."""
    import pda.data.datasets as jds
    from pda_torch.data import datasets as tds

    vol = os.path.join(_prepared(tree, "port"), "mitoem", "human_train.h5")
    with numpy_augs():
        eager = tds.SegmentationDataset(vol, vol, patch_shape=(32, 32), n_samples=4)
        lazy = tds.SegmentationDataset(vol, vol, patch_shape=(32, 32), n_samples=4, lazy=True,
                                       roi=slice(1, None))
        ref = jds.SegmentationDataset(vol, vol, patch_shape=(32, 32), n_samples=4, lazy=True,
                                      roi=slice(1, None))
        assert isinstance(lazy.raw, tds.LazyH5Volume) and lazy.raw.shape == ref.raw.shape
        assert isinstance(eager.raw, np.ndarray)
        for i in range(4):
            for a, b in zip(lazy[i], ref[i]):
                np.testing.assert_array_equal(a, b)
        monkeypatch.setattr(tds.SegmentationDataset, "EAGER_LIMIT_BYTES", 1)
        auto = tds.SegmentationDataset(vol, vol, patch_shape=(32, 32), n_samples=4)
        assert isinstance(auto.raw, tds.LazyH5Volume)
        for i in range(4):
            for a, b in zip(auto[i], eager[i]):
                np.testing.assert_array_equal(a, b)


def test_missing_mitoem_volume_raises_as_pda(tree):
    root = _copy(tree, "missing")
    errors = []
    for em in (tem, jem):
        with pytest.raises(RuntimeError, match="MitoEM volume") as e:
            em.get_mitoem_loader(os.path.join(root, "mitoem"), "train", PATCH, 2, num_workers=0)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_urocell_volumes_found_where_prepare_writes_them(tree):
    """The port's loader reads ``<path>/*.h5``, which the prepare step
    writes; pda's looks in ``<path>/urocell/`` and fetches the archive
    again (refused here)."""
    root = _prepared(tree, "port")
    path = os.path.join(root, "urocell")
    loader = tem.get_uro_cell_loader(path, "train", patch_shape=PATCH, download=True,
                                     num_workers=0)
    volumes = sorted(h5py_glob(path))
    assert len(volumes) == 4 and loader.dataset.datasets[0].raw.shape[0] == 3
    assert len(loader.dataset.datasets) == 2  # 4 volumes: 1 held out, 1 validates
    with pytest.raises(RuntimeError, match="Could not download"):
        jem.get_uro_cell_loader(path, "train", patch_shape=PATCH, download=True, num_workers=0)
