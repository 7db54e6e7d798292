"""The port's LIVECell builder (pda_torch/data/builders/) against ``pda``'s on
the CPU: COCO masks (compressed and list RLE, polygons) and rasterized label
maps, the label TIFFs and paths written for a tiny LIVECell tree, the
pseudo-label tree's refusal, the class distribution, the three loader
factories' path lists and first batches, and the download gate (no fetch
for a complete tree; the same errors for a missing file)."""

import json
import os
import shutil
import urllib.request

import imageio.v3 as imageio
import numpy as np
import pytest

import pda.data.builders.coco as jcoco
import pda.data.builders.livecell as jlive
import pda.experiments.common as jcommon
import pda_torch.data.builders.coco as tcoco
import pda_torch.data.builders.livecell as tlive
import pda_torch.experiments.common as tcommon
from pda_torch.data import tiff
from pda_torch.data.synthetic import rle_counts, rle_string, write_livecell_tree
from torch_port_utils import numpy_augs

CELLS = ("A172", "BT474")
FRAME = (48, 64)


def _masks(seed, n=6, shape=(23, 31)):
    rng = np.random.default_rng(seed)
    return [rng.random(shape) < rng.uniform(0.1, 0.9) for _ in range(n)]


def _polygons(seed, n=4, shape=(40, 50)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 8))
        pts = rng.uniform(0, 1, size=(k, 2)) * [shape[1], shape[0]]
        out.append([pts.ravel().tolist()] + ([[1.0, 2.0]] if rng.random() < 0.5 else []))
    return out


@pytest.mark.parametrize("kind", ["compressed", "list"])
def test_rle_masks_match_pda(kind):
    for m in _masks(1 if kind == "list" else 2):
        counts = rle_counts(m)
        seg = {"size": list(m.shape), "counts": rle_string(counts) if kind == "compressed"
               else counts}
        ann = {"segmentation": seg}
        port = tcoco.annotation_to_mask(ann, *m.shape)
        assert np.array_equal(port, jcoco.annotation_to_mask(ann, *m.shape))
        assert np.array_equal(port, m)


def test_polygon_masks_match_pda():
    for polys in _polygons(3):
        port = tcoco.polygons_to_mask(polys, 40, 50)
        assert port.any() and np.array_equal(port, jcoco.polygons_to_mask(polys, 40, 50))


def test_rasterize_annotations_match_pda(tmp_path):
    """Overlapping instances of all three kinds: the later one paints over."""
    h, w = 40, 50
    anns = []
    for k, m in enumerate(_masks(4, n=4, shape=(h, w))):
        counts = rle_counts(m & (np.random.default_rng(k).random((h, w)) < 0.3))
        anns.append({"segmentation": {"size": [h, w],
                                      "counts": rle_string(counts) if k % 2 else counts}})
    anns += [{"segmentation": p} for p in _polygons(5, n=3)]
    data = {"images": [{"id": 7, "file_name": "A172_x.tif", "height": h, "width": w}],
            "annotations": {str(i): dict(a, id=i, image_id=7) for i, a in enumerate(anns)},
            "categories": [{"id": 1}]}
    path = str(tmp_path / "a.json")
    with open(path, "w") as f:
        json.dump(data, f)
    port = tcoco.rasterize_annotations(tcoco.COCOIndex(path), 7)
    ref = jcoco.rasterize_annotations(jcoco.COCOIndex(path), 7)
    assert port.dtype == ref.dtype == np.uint16 and np.array_equal(port, ref)
    assert len(np.unique(port)) > 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("livecell")
    write_livecell_tree(str(root / "src"), CELLS, shape=FRAME, seed=3)
    return root


def _copy(tree, name):
    """A fresh copy of the tree for one side: each writes its own labels."""
    dst = tree / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(tree / "src", dst)
    return str(dst)


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_create_segmentations_match_pda(tree, split):
    port_root, ref_root = _copy(tree, f"port_{split}"), _copy(tree, f"ref_{split}")
    out = {}
    for side, mod, root in (("port", tlive, port_root), ("ref", jlive, ref_root)):
        out[side] = mod._image_and_label_paths(root, split, False, list(CELLS))
        out[side] = tuple(_rel(p, root) for p in out[side])
    assert out["port"] == out["ref"] and len(out["port"][0]) == {"train": 8}.get(split, 2)
    for rel in out["port"][1]:
        port_file, ref_file = os.path.join(port_root, rel), os.path.join(ref_root, rel)
        port, ref = tiff.imread(port_file), imageio.imread(ref_file)
        assert port.dtype == ref.dtype == np.uint16 and np.array_equal(port, ref)
        assert np.array_equal(tiff.imread(ref_file), ref)  # pda's file, read by the codec
        assert port.max() > 1  # instances, not a binary mask


def test_pseudo_tree_refusal_matches_pda(tree):
    root = _copy(tree, "pseudo")
    label_path = os.path.join(root, "no_pseudo")
    errors = []
    for mod in (tlive, jlive):
        with pytest.raises(FileNotFoundError) as e:
            mod._image_and_label_paths(root, "train", False, ["A172"], label_path)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "--get_pseudo_labels" in errors[0]


def test_compute_class_distribution_matches_pda(tmp_path):
    rng = np.random.default_rng(5)
    for k in range(3):
        folder = tmp_path / f"d{k}"
        folder.mkdir()
        tiff.imwrite(str(folder / "a.tif"), rng.random((20, 30)).astype(np.float32) ** (k + 1))
    port = tlive.compute_class_distribution(str(tmp_path))
    ref = jlive.compute_class_distribution(str(tmp_path))
    assert port == ref and abs(sum(port) - 1.0) < 1e-12


def _pseudo_tree(root, label_path):
    """A pseudo-label export for the train/val frames: float labels and
    0/1 consensus, as punet_pseudo_prediction writes them."""
    rng = np.random.default_rng(6)
    split = "livecell_train_val_images"
    for ct in CELLS:
        for kind in ("annotations", "consensus"):
            os.makedirs(os.path.join(label_path, kind, split, ct), exist_ok=True)
        for name in sorted(os.listdir(os.path.join(root, "images", split, ct))):
            tiff.imwrite(os.path.join(label_path, "annotations", split, ct, name),
                         rng.random(FRAME).astype(np.float32))
            tiff.imwrite(os.path.join(label_path, "consensus", split, ct, name),
                         (rng.random(FRAME) < 0.8).astype(np.uint8))


def _factory(mod, common, kind, root):
    patch = (32, 32)
    if kind == "livecell":
        return mod.get_livecell_loader(root, "train", patch, 2, cell_types=["BT474"],
                                       binary=True, num_workers=0, seed=3)
    if kind == "my":
        label_path = os.path.join(root, "pseudo")
        _pseudo_tree(root, label_path)
        return mod.get_my_livecell_loader(root, patch, "val", label_path=label_path,
                                          cell_types=list(CELLS), batch_size=2,
                                          num_workers=0, seed=4)
    if kind == "mt":  # the Mean Teacher's two weak views
        return mod.get_dual_livecell_loader(root, patch, "train", cell_types=list(CELLS),
                                            binary=True, batch_size=2,
                                            augmentation1=common.weak_augmentations(),
                                            augmentation2=common.weak_augmentations(),
                                            num_workers=0, seed=6)
    return mod.get_dual_livecell_loader(root, patch, "train", cell_types=["A172"], binary=True,
                                        batch_size=2, augmentation1=common.weak_augmentations(),
                                        augmentation2=common.fm_strong_augmentations(),
                                        num_workers=0, seed=5)


@pytest.mark.parametrize("kind", ["livecell", "my", "dual"])
def test_loader_factories_match_pda(tree, kind):
    """The same image, label (and consensus) paths and, inline with the same
    seed, the same first batch (pda's numpy augmentations)."""
    port_root, ref_root = _copy(tree, f"port_{kind}"), _copy(tree, f"ref_{kind}")
    with numpy_augs():
        port = _factory(tlive, tcommon, kind, port_root)
        ref = _factory(jlive, jcommon, kind, ref_root)
        for attr in ("raw_images", "label_images", "consensus_masks"):
            p, r = getattr(port.dataset, attr, None), getattr(ref.dataset, attr, None)
            assert (p is None) == (r is None), attr
            if p is not None:
                assert _rel(p, port_root) == _rel(r, ref_root) and p, attr
        assert len(port) == len(ref) >= 1
        pb, rb = next(iter(port)), next(iter(ref))
    assert len(pb) == len(rb) == {"livecell": 2, "my": 3, "dual": 4}[kind]
    for a, b in zip(pb, rb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["livecell", "my", "dual", "mt"])
def test_loader_factories_match_pda_on_native_augs(tree, kind):
    """With both packages' native libraries (their default), the first two
    batches, inline with the same seed, bit for bit: the native standardize,
    elastic warps and (dual, mt) weak views."""
    port_root, ref_root = _copy(tree, f"port_native_{kind}"), _copy(tree, f"ref_native_{kind}")
    with numpy_augs(False):
        port = _factory(tlive, tcommon, kind, port_root)
        ref = _factory(jlive, jcommon, kind, ref_root)
        if kind in ("dual", "mt"):
            assert type(port.dataset.augmentation1).__name__ == "NativeWeakAugmentation"
            assert type(ref.dataset.augmentation1).__name__ == "NativeWeakAugmentation"
        pit, rit = iter(port), iter(ref)
        batches = [(next(pit), next(rit)) for _ in range(min(2, len(port)))]
    assert len(batches) == (1 if kind == "my" else 2)
    for pb, rb in batches:
        assert len(pb) == len(rb) == {"livecell": 2, "my": 3, "dual": 4, "mt": 4}[kind]
        for a, b in zip(pb, rb):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_no_fetch_for_a_complete_tree_and_pda_errors_for_a_missing_file(tree, monkeypatch):
    def refuse(url, path):
        raise OSError(f"no network here ({url})")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    root = _copy(tree, "fetch")
    # complete: download=True fetches nothing
    loader = tlive.get_livecell_loader(root, "test", (32, 32), 1, cell_types=["A172"],
                                       download=True, num_workers=0)
    assert len(loader.dataset.raw_images) == 1
    # the images arrive as livecell.zip: unzipped and removed, no fetch
    shutil.make_archive(os.path.join(root, "livecell"), "zip", root, "images")
    shutil.rmtree(os.path.join(root, "images"))
    tlive._download_images(root, download=False)
    assert os.path.isdir(os.path.join(root, "images")) and not os.path.exists(
        os.path.join(root, "livecell.zip"))
    # a missing annotation file: pda's errors, with download off and on
    os.remove(os.path.join(root, "val.json"))
    for download, match in ((False, "download=False"), (True, "Could not download")):
        errors = []
        for mod in (tlive, jlive):
            with pytest.raises(RuntimeError, match=match) as e:
                mod.get_livecell_loader(root, "val", (32, 32), 1, download=download,
                                        num_workers=0)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
