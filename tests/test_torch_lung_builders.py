"""The port's Lung X-Ray builders (pda_torch/data/builders/lung.py) against
``pda``'s on the CPU, over small synthetic Lung trees (``write_lung_tree``):
the train/val split against scikit-learn's ``train_test_split`` for every n
up to 300; each domain's loader paths and, with the same seeds, its first
batches (the BMP images of JSRT segmentation02 among them); the prepared
Montgomery and NIH files (``prepare_montgomery``/``prepare_nih``) decoded
and compared bit for bit with the ones ``pda`` writes through imageio and
OpenCV, the uint8 cast of 16-bit radiographs (modulo 256) pinned; the
synthetic tree's layout; and the builders in a subprocess with imageio,
cv2 and scikit-learn blocked."""

import json
import math
import os
import shutil
import subprocess
import sys

import imageio.v3 as iio
import numpy as np
import pytest
from sklearn.model_selection import train_test_split

import pda.data.builders.lung as jlung
import pda.experiments.common as jcommon
from pda_torch.data import png
from pda_torch.data.builders import lung as tlung
from pda_torch.data.resize import INTER_AREA, resize
from pda_torch.data.synthetic import JSRT2_LABEL_SUFFIX, write_lung_tree
from pda_torch.experiments import common as tcommon
from torch_port_utils import numpy_augs

REPO = os.path.join(os.path.dirname(__file__), "..")
SHAPES = {"jsrt1": [(48, 40)], "jsrt2": [(44, 52)], "nih": [(64, 64)],
          "montgomery": [(98, 80), (80, 98)]}
COUNTS = {"jsrt1": (5, 2), "jsrt2": (5, 2), "nih": (4, 2), "montgomery": 6}
PATCH = (32, 32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lung") / "data")
    write_lung_tree(root, seed=3, shapes=SHAPES, counts=COUNTS)
    return root


def _prepared(tree, side):
    """The tree with Montgomery and NIH prepared by one side (once a side)."""
    root = os.path.join(os.path.dirname(tree), f"prepared_{side}")
    if not os.path.exists(root):
        shutil.copytree(tree, root)
        lung = tlung if side == "port" else jlung
        lung.prepare_montgomery(os.path.join(root, "montgomery"),
                                os.path.join(root, "montgomery_processed"))
        lung.prepare_nih(os.path.join(root, "nih"), os.path.join(root, "nih_processed"))
    return root


@pytest.mark.parametrize("val_fraction", [0.1, 0.2, 0.25])
def test_split_matches_scikit_learn(val_fraction):
    """Every n from 1 to 300: the same train and validation paths in the
    same order, or both refusing (an empty side)."""
    for n in range(1, 301):
        raw = [f"r{i:03}.png" for i in range(n)]
        lab = [f"l{i:03}.png" for i in range(n)]
        try:
            xt, xv, lt, lv = train_test_split(raw, lab, random_state=42, test_size=val_fraction)
        except ValueError:
            with pytest.raises(ValueError, match="empty"):
                tlung._train_val_split(raw, lab, "train", val_fraction)
            continue
        assert tlung._train_val_split(raw, lab, "train", val_fraction) == (xt, lt), n
        assert tlung._train_val_split(raw, lab, "val", val_fraction) == (xv, lv), n
        assert len(xv) == math.ceil(val_fraction * n)
    assert [len(tlung.shuffle_split(n, 0.1)[1]) for n in (247, 138, 30)] == [25, 14, 3]


def test_split_passes_test_and_zero_fraction_through():
    raw, lab = ["b", "a", "c"], ["y", "x", "z"]
    assert tlung._train_val_split(raw, lab, "test", 0.1) == (raw, lab)
    assert tlung._train_val_split(raw, lab, "train", 0.0) == (raw, lab)
    assert jlung._train_val_split(raw, lab, "test", 0.1) == (raw, lab)


def test_constants_and_label_transform_match_pda():
    assert tlung.LUNG_DOMAINS == jlung.LUNG_DOMAINS
    x = np.array([[0, 1, 254, 255], [255, 128, 0, 255]], np.uint8)
    a, b = tlung.my_label_transform(x), jlung.my_label_transform(x)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    for d in tlung.LUNG_DOMAINS:
        assert tcommon.lung_data_path("./d", d) == jcommon.lung_data_path("./d", d)


def test_synthetic_tree_layout(tree):
    """The four raw layouts the builders and the prepare step read, at the
    shapes asked for; JSRT segmentation02's images are 8-bit BMPs, its
    labels carry the 6-character suffix, Montgomery's radiographs are
    16-bit with 12-bit greys and its masks split into left and right."""
    j2 = os.path.join(tree, "jsrt2")
    bmps = sorted(os.listdir(os.path.join(j2, "org_train")))
    labels = sorted(os.listdir(os.path.join(j2, "label_train")))
    assert len(bmps) == 5 and all(n.endswith(".bmp") for n in bmps)
    assert [n[:-10] for n in labels] == [n[:-4] for n in bmps]
    assert all(n[-10:-4] == JSRT2_LABEL_SUFFIX for n in labels)
    img = iio.imread(os.path.join(j2, "org_train", bmps[0]))
    assert img.dtype == np.uint8 and img.shape == SHAPES["jsrt2"][0]
    assert len(os.listdir(os.path.join(tree, "jsrt1", "test", "org"))) == 2
    mont = os.path.join(tree, "montgomery")
    names = sorted(os.listdir(os.path.join(mont, "CXR_png")))
    assert len(names) == 6
    for k, name in enumerate(names):
        cxr = png.imread(os.path.join(mont, "CXR_png", name))
        assert cxr.dtype == np.uint16 and cxr.shape == SHAPES["montgomery"][k % 2]
        assert 255 < cxr.max() <= 4095
        left, right = (png.imread(os.path.join(mont, "ManualMask", s, name)) > 0
                       for s in ("leftMask", "rightMask"))
        assert left.any() and right.any() and not (left & right).any()
    for split, n in zip(("train", "test"), COUNTS["nih"]):
        assert len(os.listdir(os.path.join(tree, "nih", "images", split))) == n


def _loader(side, domain, root, split, augs):
    """One side's loader of ``domain`` (batch 2 for train), inline, seed 7."""
    lung, common = (tlung, tcommon) if side == "port" else (jlung, jcommon)
    kw = dict(batch_size=2 if split == "train" else 1, patch_shape=PATCH, num_workers=0,
              seed=7)
    if augs:
        kw.update(augmentation1=common.weak_augmentations(),
                  augmentation2=common.weak_augmentations())
    return lung.get_lung_loader(domain, common.lung_data_path(root, domain), split, **kw)


@pytest.mark.parametrize("domain", tlung.LUNG_DOMAINS)
@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("augs", [False, True])
def test_loaders_match_pda(tree, domain, split, augs):
    """The same image and label paths (scikit-learn's split) and, sampled
    inline with the same seed, the same first two batches."""
    root = _prepared(tree, "port")
    with numpy_augs():
        port, ref = _loader("port", domain, root, split, augs), _loader("pda", domain, root,
                                                                        split, augs)
        assert port.dataset.raw_images == list(ref.dataset.raw_images)
        assert port.dataset.label_images == list(ref.dataset.label_images)
        assert port.batch_size == ref.batch_size and port.num_workers == ref.num_workers == 0
        pit, rit = iter(port), iter(ref)
        batches = [(next(pit), next(rit)) for _ in range(min(2, len(port)))]
    assert batches
    for pb, rb in batches:
        assert len(pb) == len(rb) == (4 if augs else 2)
        for a, b in zip(pb, rb):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_loader_factories_default_to_pdas_workers(tree):
    root = _prepared(tree, "port")
    for domain in tlung.LUNG_DOMAINS:
        port = tlung.get_lung_loader(domain, tcommon.lung_data_path(root, domain), "train")
        assert port.num_workers == 8 and port.batch_size == 1
        assert port.dataset.patch_shape == (256, 256)
        port.close()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


@pytest.mark.parametrize("dataset", ["montgomery_processed", "nih_processed"])
def test_prepared_files_match_pda(tree, dataset):
    """The same files (Montgomery's seeded 80/20 split), each decoded by
    imageio and by the port's codec equal to pda's, bit for bit."""
    port = os.path.join(_prepared(tree, "port"), dataset)
    ref = os.path.join(_prepared(tree, "pda"), dataset)
    assert _files(port) == _files(ref) and _files(port)
    for rel in _files(port):
        a, b = iio.imread(os.path.join(port, rel)), iio.imread(os.path.join(ref, rel))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (256, 256)
        assert np.array_equal(a, b), rel
        assert np.array_equal(png.imread(os.path.join(port, rel)), a)
        if rel.startswith("labels"):
            assert set(np.unique(a).tolist()) <= {0, 255}
    n_test = len(os.listdir(os.path.join(port, "images", "test")))
    n = len(os.listdir(os.path.join(port, "images", "train"))) + n_test
    assert n_test == (int(round(0.2 * n)) if dataset == "montgomery_processed"
                      else COUNTS["nih"][1])


def test_montgomery_cast_wraps_modulo_256(tree):
    """pda casts the INTER_AREA result of a 16-bit radiograph with
    ``.astype("uint8")``: its 12-bit greys wrap modulo 256, and the port
    keeps that."""
    root = _prepared(tree, "port")
    name = sorted(os.listdir(os.path.join(tree, "montgomery", "CXR_png")))[0]
    raw = png.imread(os.path.join(tree, "montgomery", "CXR_png", name))
    area = resize(raw, (256, 256), INTER_AREA)
    assert area.dtype == np.uint16 and area.max() > 255
    prepared = [os.path.join(root, "montgomery_processed", "images", s, name)
                for s in ("train", "test")]
    got = png.imread([p for p in prepared if os.path.exists(p)][0])
    assert np.array_equal(got, (area % 256).astype(np.uint8))
    assert not np.array_equal(got, np.clip(area, 0, 255).astype(np.uint8))


BLOCKED = r"""
import json, os, shutil, sys
for name in ("imageio", "imageio.v3", "cv2", "sklearn", "sklearn.model_selection"):
    sys.modules[name] = None
import numpy as np
from pda_torch.data import png
from pda_torch.data.builders import lung
from pda_torch.experiments.common import lung_data_path
root = sys.argv[1]
lung.prepare_montgomery(os.path.join(root, "montgomery"), os.path.join(root, "montgomery_processed"))
lung.prepare_nih(os.path.join(root, "nih"), os.path.join(root, "nih_processed"))
out = {}
for domain in lung.LUNG_DOMAINS:
    loader = lung.get_lung_loader(domain, lung_data_path(root, domain), "val", num_workers=0,
                                  patch_shape=(32, 32), seed=7)
    x, y = next(iter(loader))
    out[domain] = [list(map(os.path.basename, loader.dataset.raw_images)),
                   np.asarray(x).tobytes().hex(), np.asarray(y).tobytes().hex()]
loaded = [n for n in ("imageio", "cv2", "sklearn", "jax", "pda") if sys.modules.get(n) is not None]
print(json.dumps({"val": out, "loaded": loaded}))
"""


def test_builders_without_imageio_cv2_sklearn(tree, tmp_path):
    root = str(tmp_path / "data")
    shutil.copytree(tree, root)
    out = subprocess.run([sys.executable, "-c", BLOCKED, root], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    ref_root = _prepared(tree, "pda")
    for rel in _files(os.path.join(ref_root, "montgomery_processed")):
        a = iio.imread(os.path.join(root, "montgomery_processed", rel))
        assert np.array_equal(a, iio.imread(os.path.join(ref_root, "montgomery_processed", rel)))
    for domain in tlung.LUNG_DOMAINS:
        ref = jlung.get_lung_loader(domain, jcommon.lung_data_path(ref_root, domain), "val",
                                    num_workers=0, patch_shape=PATCH, seed=7)
        x, y = next(iter(ref))
        names, xs, ys = result["val"][domain]
        assert names == [os.path.basename(p) for p in ref.dataset.raw_images]
        # another process: the standardisation's float32 mean may round differently
        got = np.frombuffer(bytes.fromhex(xs), np.float32)
        np.testing.assert_allclose(got, np.asarray(x, np.float32).ravel(), rtol=1e-5, atol=1e-5)
        assert ys == np.asarray(y).tobytes().hex()
