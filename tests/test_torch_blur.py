"""The port's Gaussian blur (pda_torch/data/blur.py) against
``cv2.GaussianBlur(src, (0, 0), sigma)`` on the CPU, bit for bit: hypothesis
draws sizes from 1 to 300 pixels a side, sigma in (0, 4] (every kernel size
from 1 to 33 taps, the 3- and 5-tap paths, kernels longer than the axis) for
(H, W), (H, W, 1) and (H, W, 3) float32 arrays; hand-made cases name the
special ones; the transform ``GaussianBlur`` equals ``pda``'s (which calls
cv2) on the same generator; and one blur runs with cv2 blocked. The probe
that ``chip_smoke.py`` repeats on the card's host is pinned here."""

import hashlib
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pda_torch.data import blur

REPO = os.path.join(os.path.dirname(__file__), "..")

SETTINGS = settings(max_examples=300, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])

side = st.one_of(st.integers(1, 40), st.integers(1, 300))
sigma = st.one_of(st.floats(1e-3, 0.6), st.floats(1e-3, 4.0))


def cv2_blur(x, s):
    return cv2.GaussianBlur(x, (0, 0), s).reshape(x.shape)


def assert_bits(x, s):
    got, want = blur.gaussian_blur(x, s), cv2_blur(x, s)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        x.shape, s, float(np.abs(got - want).max()))


def frame(data, channels):
    h, w = data.draw(side), data.draw(side)
    seed = data.draw(st.integers(0, 2**32 - 1))
    shape = (h, w) if channels is None else (h, w, channels)
    scale = data.draw(st.sampled_from([1.0, 255.0, 1e-3]))
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("channels", [None, 1, 3], ids=["hw", "hw1", "hw3"])
@SETTINGS
@given(data=st.data())
def test_blur_matches_cv2_bit_for_bit(channels, data):
    assert_bits(frame(data, channels), data.draw(sigma))


HAND = {
    "one_pixel": ((1, 1), 2.0),
    "one_row": ((1, 57), 1.7),
    "one_column": ((57, 1), 1.7),
    "one_row_rgb": ((1, 20, 3), 0.9),
    "kernel_longer_than_both_axes": ((3, 5), 3.9),
    "thin_and_long": ((8, 512), 3.0),
    "long_and_thin": ((512, 8), 3.0),
    "one_tap": ((16, 16), 0.05),
    "three_taps": ((33, 17), 0.3),
    "five_taps": ((33, 17), 0.5),
    "largest": ((300, 300), 4.0),
    "frame_512": ((512, 512), 2.9),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_blur_hand_cases(case):
    shape, s = HAND[case]
    assert_bits(np.random.default_rng(5).standard_normal(shape).astype(np.float32), s)


def test_blur_of_a_constant_and_of_integers():
    for x in (np.full((20, 31), 7.0, np.float32),
              np.random.default_rng(2).integers(0, 256, (64, 48)).astype(np.float32)):
        for s in (0.4, 1.0, 2.5):
            assert_bits(x, s)


@pytest.mark.parametrize("s", [0.1, 0.3, 0.55, 1.0, 2.2, 3.99])
def test_kernel_is_opencvs(s):
    k = blur.gaussian_kernel(s)
    n = int(np.rint(8 * s + 1)) | 1
    assert np.array_equal(k, cv2.getGaussianKernel(n, s, cv2.CV_32F).ravel())


def test_transform_matches_pda():
    from pda.data.transforms import GaussianBlur as JBlur

    from pda_torch.data.transforms import GaussianBlur as TBlur

    rng = np.random.default_rng(0)
    for shape in ((40, 48), (40, 48, 1), (33, 20, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        for lo, hi in ((0.0, 3.0), (1.0, 4.0), (0.6, 3.0)):
            for seed in range(4):
                a = TBlur(sigma=(lo, hi))(x, np.random.default_rng(seed))
                b = JBlur(sigma=(lo, hi))(x, np.random.default_rng(seed))
                assert a.shape == b.shape and np.array_equal(a, b), (shape, lo, seed)


def test_bad_input_raises():
    with pytest.raises(ValueError):
        blur.gaussian_blur(np.zeros((4, 4), np.float32), 0.0)
    with pytest.raises(ValueError):
        blur.gaussian_blur(np.zeros((2, 4, 4, 1), np.float32), 1.0)


# chip_smoke.py's probe on the card's host, which has no cv2
def probe_input():
    return np.random.default_rng(11).standard_normal((96, 80, 3)).astype(np.float32)


PROBE_SIGMAS = (0.45, 1.3, 3.7)


def probe_digest(fn):
    x = probe_input()
    h = hashlib.sha256()
    for s in PROBE_SIGMAS:
        h.update(np.ascontiguousarray(fn(x, s)).tobytes())
        h.update(np.ascontiguousarray(fn(np.ascontiguousarray(x[..., 0]), s)).tobytes())
    return h.hexdigest()


def test_chip_smoke_blur_probe_is_cv2s():
    """chip_smoke.py holds the card host's blur of the probe to cv2's result
    here (its digest): the probe's recipe and digest there equal these."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    digest = re.search(r'BLUR_PROBE_SHA256 = "([0-9a-f]{64})"', src).group(1)
    assert "default_rng(11).standard_normal((96, 80, 3))" in src
    assert f"BLUR_PROBE_SIGMAS = {PROBE_SIGMAS}" in src
    assert probe_digest(cv2_blur) == digest
    assert probe_digest(blur.gaussian_blur) == digest


BLOCKED = r"""
import sys
sys.modules["cv2"] = None
import numpy as np
from pda_torch.data.transforms import GaussianBlur
x = np.load(sys.argv[1])
out = GaussianBlur(sigma=(2.5, 2.5))(x, np.random.default_rng(0))
np.save(sys.argv[2], out)
print("cv2" in sys.modules and sys.modules["cv2"] is None)
"""


def test_blur_with_cv2_blocked(tmp_path):
    x = np.random.default_rng(4).standard_normal((70, 90, 1)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path / "x.npy"),
                           str(tmp_path / "out.npy")], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"
    out = np.load(tmp_path / "out.npy")
    want = cv2.GaussianBlur(x, (0, 0), 2.5)[..., None]
    assert np.array_equal(out, want)
