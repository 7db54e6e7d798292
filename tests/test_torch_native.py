"""The port's native host library (pda_torch/data/native.py) against
``pda``'s (pda/data/native.py) on the CPU: the copied source byte for byte;
every entry point bit-equal on the same seeded inputs (both libraries built
with the same flags on this host); ``NativeWeakAugmentation`` and the joint
augmentations bit-equal, with the generator in the same state after; the
switch (``PDA_NATIVE_AUGS``) at "0" giving the numpy path; a failed build
raising, with no fallback; two processes building at once leaving one
library; and a loader's worker processes loading the parent's build."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import pda.data.native as jnative
import pda.data.transforms as jtransforms
import pda.experiments.common as jcommon
import pda_torch.data.native as tnative
import pda_torch.data.transforms as ttransforms
import pda_torch.experiments.common as tcommon
from torch_port_utils import numpy_augs

REPO = os.path.join(os.path.dirname(__file__), "..")

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="pda's native library could not be built here")


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def image(seed, shape=(96, 80), loc=3.0, scale=2.0):
    return np.random.default_rng(seed).normal(loc, scale, size=shape).astype(np.float32)


def test_source_is_pdas_byte_for_byte():
    with open(os.path.join(REPO, "native", "pda_native.cpp"), "rb") as f:
        pda_src = f.read()
    assert tnative.SOURCE.read_bytes() == pda_src
    assert tnative.CXX_FLAGS == ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")


@pytest.mark.parametrize("shape", [(96, 80), (57, 33, 1), (1, 64), (7, 1)])
def test_standardize_crop_contrast_match_pda(shape):
    x = image(1, shape)
    same(tnative.standardize(x), jnative.standardize(x))
    same(tnative.standardize(x, 1e-3), jnative.standardize(x, 1e-3))
    same(tnative.random_contrast(x, 2.7), jnative.random_contrast(x, 2.7))
    plane = x.reshape(shape[0], -1)
    h, w = plane.shape
    same(tnative.crop(plane, h // 3, w // 4, h - h // 3, w - w // 4),
         jnative.crop(plane, h // 3, w // 4, h - h // 3, w - w // 4))


@pytest.mark.parametrize("sigma", [0.3, 0.7, 1.9, 3.0, 4.0])
@pytest.mark.parametrize("shape", [(96, 80), (40, 52, 1), (5, 300), (1, 64)])
def test_gaussian_blur_matches_pda(shape, sigma):
    x = image(2, shape)
    same(tnative.gaussian_blur(x, sigma), jnative.gaussian_blur(x, sigma))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("n", [1, 2047, 2048, 4097, 512 * 512])
def test_noise_matches_pda(n, clip):
    x = image(3, (n,), 0.5, 0.2)
    for seed, std in ((1, 0.1), (2**63 - 2, 0.35), (12345, 0.0)):
        same(tnative.add_gaussian_noise(x, std, seed, clip),
             jnative.add_gaussian_noise(x, std, seed, clip))


@pytest.mark.parametrize("p", [0.0, 0.25, 1.0])
def test_weak_augment_matches_pda(p):
    for seed in (1, 7, 2**62):
        for shape in ((64, 48), (33, 70, 1)):
            x = image(seed % 97, shape)
            same(tnative.weak_augment(x, p=p, seed=seed), jnative.weak_augment(x, p=p, seed=seed))
            same(tnative.weak_augment(x, p=p, blur_sigma=(1.0, 4.0), noise=(0.1, 0.35), seed=seed),
                 jnative.weak_augment(x, p=p, blur_sigma=(1.0, 4.0), noise=(0.1, 0.35),
                                      seed=seed))


@pytest.mark.parametrize("order", [0, 1])
def test_elastic_warp_and_field_match_pda(order):
    rng = np.random.default_rng(4)
    x = image(5, (64, 48))
    dy = (rng.normal(size=(64, 48)) * 9).astype(np.float32)
    dx = (rng.normal(size=(64, 48)) * 9).astype(np.float32)
    same(tnative.elastic_warp(x, dy, dx, order), jnative.elastic_warp(x, dy, dx, order))
    same(tnative.elastic_warp(x[..., None], dy, dx, order),
         jnative.elastic_warp(x[..., None], dy, dx, order))
    coarse = rng.standard_normal((9, 7)).astype(np.float32)
    same(tnative.field_upsample(coarse, 96, 80), jnative.field_upsample(coarse, 96, 80))


def test_out_of_range_inputs_raise_before_the_library_reads_them():
    x = image(7, (16, 12))
    for fn in (lambda: tnative.crop(x, 10, 0, 8, 12), lambda: tnative.crop(x, 0, -1, 4, 4),
               lambda: tnative.elastic_warp(x, x[:8], x),
               lambda: tnative.field_upsample(np.zeros((1, 5), np.float32), 8, 8)):
        with pytest.raises(ValueError):
            fn()


def test_plane_operators_refuse_multichannel():
    x = np.zeros((8, 8, 3), np.float32)
    for fn in (lambda: tnative.gaussian_blur(x, 2.0), lambda: tnative.weak_augment(x),
               lambda: tnative.elastic_warp(x, x[..., 0], x[..., 0])):
        with pytest.raises(ValueError):
            fn()


def test_in_place_entries_never_write_through_a_view():
    src = image(6, (64, 32))
    view = src[10:42, :]  # a full-width crop: a contiguous view
    before = src.copy()
    tnative.standardize(view)
    tnative.weak_augment(view, p=1.0, seed=3)
    tnative.add_gaussian_noise(view, 0.1, 5)
    tnative.random_contrast(view, 1.3)
    same(src, before)


@pytest.mark.parametrize("shape", [(64, 48), (40, 40, 1), (32, 36, 3)])
def test_weak_augmentation_and_generator_match_pda(shape):
    """Eight samples through one generator each side: the same views and the
    generator in the same state after (one ``integers`` draw a plane sample;
    multi-channel samples take the numpy recipe, native standardize first)."""
    with numpy_augs(False):
        port, ref = tcommon.weak_augmentations(), jcommon.weak_augmentations()
        assert isinstance(port, tnative.NativeWeakAugmentation)
        a, b = np.random.default_rng(11), np.random.default_rng(11)
        for i in range(8):
            x = image(20 + i, shape)
            same(port(x, a), ref(x, b))
    assert a.bit_generator.state == b.bit_generator.state
    assert a.random() == b.random()


def test_joint_augmentations_match_pda():
    """Quarter turns, flips and the elastic field and warp (p_elastic 1):
    the same arrays and the generator's state after."""
    with numpy_augs(False):
        raw = image(30, (48, 48, 1))
        lab = (image(31, (48, 48, 1)) > 3).astype(np.float32)
        cons = (image(32, (48, 48, 2)) > 2).astype(np.float32)
        port, ref = ttransforms.JointAugmentations(p_elastic=1.0), \
            jtransforms.JointAugmentations(p_elastic=1.0)
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(6):
            for x, y in zip(port([raw, lab, cons], a), ref([raw, lab, cons], b)):
                same(x, y)
        assert a.bit_generator.state == b.bit_generator.state
        same(ttransforms.standardize(raw), jtransforms.standardize(raw))


def test_switch_off_gives_the_numpy_path(monkeypatch):
    monkeypatch.delenv("PDA_NATIVE_AUGS", raising=False)
    assert tnative.enabled() and isinstance(tcommon.weak_augmentations(),
                                            tnative.NativeWeakAugmentation)  # the default
    raw = image(40, (48, 40))
    with numpy_augs():
        assert not isinstance(tcommon.weak_augmentations(), tnative.NativeWeakAugmentation)
        x = np.asarray(raw, np.float32) - raw.mean()
        same(ttransforms.standardize(raw), x / (x.std() + ttransforms.EPS))
        j = ttransforms.JointAugmentations()
        f = j._field(96, 80, np.random.default_rng(3))
    with numpy_augs(False):
        g = j._field(96, 80, np.random.default_rng(3))
        assert not np.array_equal(ttransforms.standardize(raw), x / (x.std() + ttransforms.EPS))
    np.testing.assert_allclose(g, f, rtol=1e-5, atol=1e-5)  # the two paths, not bit-equal


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """The port's native module unloaded, building into ``tmp_path``."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    return monkeypatch


def test_missing_compiler_raises_without_fallback(fresh, tmp_path):
    fresh.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    with numpy_augs(False):
        with pytest.raises(tnative.NativeBuildError, match="PDA_NATIVE_AUGS=0"):
            ttransforms.standardize(image(41, (8, 8)))
        with pytest.raises(tnative.NativeBuildError):  # the error is kept, not retried
            tcommon.weak_augmentations()(image(42, (8, 8)), np.random.default_rng(0))
        assert not tnative.available()
    with numpy_augs():
        assert ttransforms.standardize(image(41, (8, 8))).shape == (8, 8)
    assert os.listdir(tmp_path) == []


def test_failed_compile_names_the_compilers_stderr(fresh, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" void pda_standardize( {\n")
    fresh.setattr(tnative, "SOURCE", bad)
    with numpy_augs(False), pytest.raises(tnative.NativeBuildError, match="error") as e:
        ttransforms.JointAugmentations()._field(16, 16, np.random.default_rng(0))
    assert "PDA_NATIVE_AUGS=0" in str(e.value)
    assert sorted(os.listdir(tmp_path)) == ["bad.cpp"]  # no library, no temporary file


BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from pda_torch.data import native
    native.BUILD_DIR = Path(sys.argv[1])
    path = native.build()
    native._load()
    print(path)
""")


def test_two_concurrent_builds_leave_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]


WORKERS = textwrap.dedent("""
    import os, stat, sys
    import numpy as np
    from pda_torch.data import DualImageCollectionDataset, Loader, native
    from pda_torch.data.synthetic import make_dataset_arrays

    if __name__ == "__main__":
        fake = sys.argv[1]
        native.build()  # as the parent would: the library exists from here on
        os.makedirs(fake)
        with open(os.path.join(fake, "g++"), "w") as f:  # a compiler that leaves a mark
            f.write("#!/bin/sh\\ntouch " + os.path.join(fake, "called") + "\\nexit 1\\n")
        os.chmod(os.path.join(fake, "g++"), stat.S_IRWXU)
        os.environ["PATH"] = fake + os.pathsep + os.environ["PATH"]
        raws, labels = make_dataset_arrays(3, (64, 64), seed=2)
        aug = native.NativeWeakAugmentation()
        ds = DualImageCollectionDataset(raws, labels, patch_shape=(32, 32), augmentation1=aug,
                                        augmentation2=aug, n_samples=8, seed=1)
        pooled = Loader(ds, 2, seed=3, num_workers=2, force_workers=True)
        inline = Loader(ds, 2, seed=3)
        for a, b in zip(pooled, inline):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
        pooled.close()
        print(os.path.exists(os.path.join(fake, "called")), pooled._pool is None)
""")


def test_loader_workers_load_the_parents_build(tmp_path):
    """The parent builds before the forkserver workers start; with a compiler
    that only leaves a mark on the PATH from then on, the workers sample the
    native views the parent samples inline and never call it."""
    script = tmp_path / "workers.py"
    script.write_text(WORKERS)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "fake")], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": os.path.abspath(REPO),
                               "PDA_NATIVE_AUGS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["False", "True"]
