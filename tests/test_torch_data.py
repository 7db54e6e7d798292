"""The port's data path (``pda_torch.data``) against ``pda.data`` on the CPU:
synthetic images, the numpy transforms (both packages' numpy path: their
native libraries are switched off with ``PDA_NATIVE_AUGS=0``; the native
path is ``test_torch_native.py``'s), the 2D patch datasets and the ``Loader`` (inline, thread workers and one
shared-memory process case), array for array over two epochs."""

import numpy as np
import pytest

import pda.data as jdata
import pda.data.synthetic as jsyn
import pda_torch.data as tdata
import pda_torch.data.synthetic as tsyn
from torch_port_utils import numpy_augs


@pytest.fixture(autouse=True)
def _numpy_path():
    with numpy_augs():
        yield


def assert_same(a, b):
    """Tuples/lists of arrays (or one array), equal in shape, dtype and value."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_synthetic_matches_pda():
    for seed in (0, 7):
        assert_same(tsyn.make_blob_image((40, 56), rng=np.random.default_rng(seed)),
                    jsyn.make_blob_image((40, 56), rng=np.random.default_rng(seed)))
        for inst in (False, True):
            assert_same(tsyn.make_dataset_arrays(3, (48, 64), seed=seed, instance_labels=inst),
                        jsyn.make_dataset_arrays(3, (48, 64), seed=seed, instance_labels=inst))
    labels = jsyn.make_dataset_arrays(2, (32, 32))[1]
    assert_same(tsyn.make_consensus_arrays(labels, seed=3),
                jsyn.make_consensus_arrays(labels, seed=3))


def _recipes(d):
    """pda/experiments/common.py's weak, FixMatch-strong and AdaMatch-strong
    recipes, numpy path, built from ``d``."""
    return {
        "weak": d.Compose(d.standardize, d.RandomApply([d.GaussianBlur()], p=0.25),
                          d.RandomApply([d.AdditiveGaussianNoise(scale=(0, 0.15))], p=0.25)),
        "fm_strong": d.Compose(
            d.standardize, d.RandomApply([d.GaussianBlur(sigma=(1.0, 4.0))], p=0.9),
            d.RandomApply([d.AdditiveGaussianNoise(scale=(0.1, 0.35))], p=0.9),
            d.RandomApply([d.RandomContrast(alpha=(0.33, 3), mean=0.0)], p=0.9)),
        "adamatch_strong": d.Compose(
            d.standardize, d.RandomApply([d.GaussianBlur(sigma=(0.6, 3.0))], p=0.5),
            d.RandomApply([d.AdditiveGaussianNoise(scale=(0.05, 0.25))], p=0.25),
            d.RandomApply([d.RandomContrast(mean=0.0, alpha=(0.33, 3.0))], p=0.5)),
        "blur_2ch": d.GaussianBlur(sigma=(0.5, 2.0)),
        "contrast_clip": d.RandomContrast(clip_kwargs=True),
        "noise_clip": d.AdditiveGaussianNoise(clip_kwargs=True),
        "raw_transform": d.get_raw_transform(
            d.standardize, d.RandomApply([d.GaussianBlur()], p=1.0),
            d.RandomApply([d.AdditiveGaussianNoise()], p=1.0)),
    }


@pytest.mark.parametrize("recipe", ["weak", "fm_strong", "adamatch_strong", "blur_2ch",
                                    "contrast_clip", "noise_clip", "raw_transform"])
def test_raw_transforms_match_pda(recipe):
    x = jsyn.make_blob_image((48, 40), rng=np.random.default_rng(1))[0] * 50 + 20
    if recipe == "blur_2ch":
        x = np.stack([x, -x], axis=-1)
    port, ref = _recipes(tdata)[recipe], _recipes(jdata)[recipe]
    for seed in range(6):
        assert_same(port(x.copy(), np.random.default_rng(seed)),
                    ref(x.copy(), np.random.default_rng(seed)))
    assert_same(tdata.standardize(x), jdata.standardize(x))
    assert_same(tdata.standardize(x, mean=3.0, std=2.0), jdata.standardize(x, mean=3.0, std=2.0))
    assert_same(tdata.normalize(x), jdata.normalize(x))


@pytest.mark.parametrize("shape", [(32, 32), (32, 48)])
def test_joint_augmentations_match_pda(shape):
    """Quarter turns (halves on a non-square patch), flips and the elastic
    warp (forced on), raw bilinear and labels and masks nearest."""
    raw, lab = jsyn.make_blob_image(shape, rng=np.random.default_rng(2))
    cons = jsyn.make_consensus_arrays([lab], seed=5)[0]
    port, ref = (d.get_augmentations(2, p_elastic=1.0) for d in (tdata, jdata))
    for seed in range(8):
        assert_same(port([raw, lab, cons], np.random.default_rng(seed)),
                    ref([raw, lab, cons], np.random.default_rng(seed)))
    two = np.stack([raw, raw * 2], axis=-1)
    assert_same(port([two, lab], np.random.default_rng(9)),
                ref([two, lab], np.random.default_rng(9)))


def test_label_transforms_match_pda():
    lab = jsyn.make_dataset_arrays(1, (40, 40), seed=4, instance_labels=True)[1][0]
    for name in ("labels_to_binary", "boundary_transform", "affinity_transform"):
        assert_same(getattr(tdata, name)(lab), getattr(jdata, name)(lab))
    assert_same(tdata.affinity_transform(lab, ((0, -2), (3, 1))),
                jdata.affinity_transform(lab, ((0, -2), (3, 1))))
    for kw in ({"offsets": ((0, 1), (1, 0), (-2, 3))}, {"boundaries": True}, {"binary": True}, {}):
        port, ref = tdata.select_label_transform(**kw), jdata.select_label_transform(**kw)
        for p, r in zip(port, ref):
            assert (p is None) == (r is None)
            if p is not None:
                assert_same(p(lab), r(lab))


def _datasets(d, tmp_path=None):
    """One of each port-able dataset kind, built from ``d`` on seeded
    synthetic images (file paths for one of them, read through
    ``load_image``)."""
    raws, labels = jsyn.make_dataset_arrays(3, (48, 56), seed=11)
    cons = jsyn.make_consensus_arrays(labels, seed=12)
    weak = _recipes(d)["weak"]
    strong = _recipes(d)["fm_strong"]
    files = raws
    if tmp_path is not None:
        import imageio.v3 as imageio

        files = []
        for i, r in enumerate(raws):
            path = str(tmp_path / f"raw_{i}.tif")
            if not (tmp_path / f"raw_{i}.tif").exists():
                imageio.imwrite(path, r)
            files.append(path)
    sampler = d.MinForegroundSampler(0.05)
    return {
        "image": d.ImageCollectionDataset(raws, labels, patch_shape=(32, 32), n_samples=6,
                                          seed=1),
        "image_consensus_sampler": d.ImageCollectionDataset(
            files, labels, cons, patch_shape=(24, 32), sampler=sampler,
            label_transform=d.labels_to_binary, seed=2),
        "dual": d.DualImageCollectionDataset(raws, labels, patch_shape=(32, 32),
                                             augmentation1=weak, augmentation2=strong,
                                             n_samples=5, seed=3),
        "dual_plain": d.DualImageCollectionDataset(raws, labels, patch_shape=(32, 32), seed=4),
        "dual_raw": d.DualRawImageCollectionDataset(
            raws, patch_shape=(32, 32), augmentation1=weak, augmentation2=weak,
            sampler=lambda r: r.std() > 0.05, n_samples=4, seed=5),
        "dual_raw_plain": d.DualRawImageCollectionDataset(raws, patch_shape=(32, 32), seed=6),
        "concat": d.ConcatDataset(
            d.ImageCollectionDataset(raws[:2], labels[:2], patch_shape=(32, 32), seed=7),
            d.ImageCollectionDataset(raws, labels, patch_shape=(32, 32), n_samples=3, seed=8)),
    }


@pytest.mark.parametrize("kind", ["image", "image_consensus_sampler", "dual", "dual_plain",
                                  "dual_raw", "dual_raw_plain", "concat"])
def test_datasets_match_pda(kind, tmp_path):
    port, ref = _datasets(tdata, tmp_path)[kind], _datasets(jdata, tmp_path)[kind]
    assert len(port) == len(ref)
    for i in range(len(ref)):
        assert_same(port.sample(i, np.random.default_rng((4, i))),
                    ref.sample(i, np.random.default_rng((4, i))))
        assert_same(port[i], ref[i])


def test_load_image_reads_files_as_pda(tmp_path):
    import imageio.v3 as imageio

    img = (np.arange(30 * 20, dtype=np.uint16).reshape(30, 20) * 7)
    path = str(tmp_path / "a.tif")
    imageio.imwrite(path, img)
    assert_same(tdata.load_image(path), jdata.load_image(path))
    assert tdata.load_image(img) is img


LOADER_CASES = {
    "inline": {},
    "inline_ordered_partial": {"shuffle": False, "drop_last": False},
    "thread": {"num_workers": 2, "worker_mode": "thread", "force_workers": True},
    "process": {"num_workers": 2, "force_workers": True},
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_pda(case):
    """Two epochs of batches, each against pda's inline Loader: the worker
    modes keep the per-sample seeds (seed, epoch, index)."""
    kw = LOADER_CASES[case]
    port_ds = _datasets(tdata)["dual"]
    ref_ds = _datasets(jdata)["dual"]
    ref_kw = {k: v for k, v in kw.items() if k in ("shuffle", "drop_last")}
    port = tdata.get_data_loader(port_ds, 2, seed=9, **kw)
    ref = jdata.Loader(ref_ds, 2, seed=9, **ref_kw)
    assert len(port) == len(ref) == (3 if kw.get("drop_last") is False else 2)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for g, w in zip(got, want):
            assert_same(g, w)
            assert g[0].shape[1:] == (32, 32, 1)


def test_loader_close_stops_the_workers_and_a_later_epoch_restarts_them():
    """close() shuts the process pool and frees its shared memory; the next
    epoch starts a new pool and draws what it would have drawn anyway."""
    ds = _datasets(tdata)["dual"]
    loader = tdata.Loader(ds, 2, seed=9, num_workers=2, force_workers=True)
    inline = tdata.Loader(_datasets(tdata)["dual"], 2, seed=9)
    first = list(loader)
    pool, shm = loader._pool[1], loader._shm
    loader.close()
    assert loader._pool is None and loader._shm is None
    assert not pool._processes  # the executor drops its processes once they are joined
    with pytest.raises(FileNotFoundError):
        type(shm)(name=shm.name)  # unlinked
    second = list(loader)
    for got, want in zip(first + second, list(inline) + list(inline)):
        assert_same(got, want)
    loader.close()


def test_loader_refuses_a_dataset_smaller_than_its_batch():
    ds = _datasets(tdata)["dual_plain"]
    with pytest.raises(ValueError, match="smaller than"):
        next(iter(tdata.Loader(ds, 8)))
    assert list(tdata.Loader(ds, 8, drop_last=False))[0][0].shape[0] == 3
