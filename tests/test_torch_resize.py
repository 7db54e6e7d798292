"""The port's numpy ``cv2.resize`` (pda_torch/data/resize.py) against OpenCV,
which ``pda``'s Lung prepare step resizes with: INTER_AREA (fast area at
integer factors, area weights at fractional down-scale, the area-bilinear
path where either axis grows) and INTER_NEAREST, uint8 and uint16, bit for
bit, under hypothesis and at the Lung sources' real sizes; the refusals; and
the resize in a subprocess with imageio, cv2 and scikit-learn blocked."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pda_torch.data.resize import INTER_AREA, INTER_NEAREST, resize

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_constants_are_opencvs():
    assert (INTER_AREA, INTER_NEAREST) == (cv2.INTER_AREA, cv2.INTER_NEAREST)


def same_as_cv2(src, dsize, interpolation):
    ref = cv2.resize(src, dsize, interpolation=interpolation)
    out = resize(src, dsize, interpolation)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out, ref), int(np.abs(out.astype(int) - ref.astype(int)).max())


@st.composite
def cases(draw):
    dtype = draw(st.sampled_from([np.uint8, np.uint16]))
    kind = draw(st.sampled_from(["integer down", "fractional down", "up", "mixed"]))
    if kind == "integer down":
        dh, dw = draw(st.integers(1, 24)), draw(st.integers(1, 24))
        h, w = dh * draw(st.integers(1, 6)), dw * draw(st.integers(1, 6))
    elif kind == "fractional down":
        h, w = draw(st.integers(2, 90)), draw(st.integers(2, 90))
        dh, dw = draw(st.integers(1, h)), draw(st.integers(1, w))
    elif kind == "up":
        h, w = draw(st.integers(1, 30)), draw(st.integers(1, 30))
        dh, dw = draw(st.integers(h, 80)), draw(st.integers(w, 80))
    else:
        h, w = draw(st.integers(2, 60)), draw(st.integers(1, 30))
        dh, dw = draw(st.integers(1, h)), draw(st.integers(w, 80))
    seed = draw(st.integers(0, 2**32 - 1))
    binary = draw(st.booleans())
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    src = ((rng.integers(0, 2, (h, w)) * top) if binary
           else rng.integers(0, top + 1, (h, w))).astype(dtype)
    return src, (dw, dh)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(case=cases(), interpolation=st.sampled_from([INTER_AREA, INTER_NEAREST]))
def test_matches_opencv(case, interpolation):
    src, dsize = case
    same_as_cv2(src, dsize, interpolation)


@pytest.mark.parametrize("block", [(54, 57), (7, 9), (64, 64), (33, 1)])
@pytest.mark.parametrize("binary", [True, False])
def test_large_uint16_blocks(block, binary):
    """Fast area on uint16 blocks whose sum passes 2**24, where OpenCV's
    float32 running sum rounds."""
    rng = np.random.default_rng(block[0] * 100 + block[1])
    shape = (2 * block[0], 3 * block[1])
    src = ((rng.integers(0, 2, shape) * 65535) if binary
           else rng.integers(0, 65536, shape)).astype(np.uint16)
    same_as_cv2(src, (3, 2), INTER_AREA)


@pytest.mark.parametrize("shape", [(4892, 4020), (4020, 4892), (1024, 1024)])
def test_real_sizes(shape):
    """Montgomery's two frame sizes and ChestX-ray14's to 256^2: images
    (12-bit greys in uint16, and uint8) by area, masks by nearest."""
    rng = np.random.default_rng(shape[0])
    grey = rng.integers(0, 4096, shape, dtype=np.uint16)
    same_as_cv2(grey, (256, 256), INTER_AREA)
    same_as_cv2((grey >> 4).astype(np.uint8), (256, 256), INTER_AREA)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    mask = (((yy / shape[0] - 0.5) / 0.3) ** 2 + ((xx / shape[1] - 0.3) / 0.15) ** 2 < 1)
    same_as_cv2(mask.astype(np.uint8) * 255, (256, 256), INTER_NEAREST)


def test_same_size_is_a_copy():
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    for interpolation in (INTER_AREA, INTER_NEAREST):
        out = resize(a, (4, 3), interpolation)
        assert np.array_equal(out, a) and out is not a


@pytest.mark.parametrize("src,dsize,interpolation,what", [
    (np.zeros((4, 4), np.float32), (2, 2), INTER_AREA, "uint8 or uint16"),
    (np.zeros((4, 4, 3), np.uint8), (2, 2), INTER_AREA, "2D"),
    (np.zeros((4, 4), np.uint8), (2, 2), cv2.INTER_LINEAR, "interpolation 1"),
    (np.zeros((4, 4), np.uint8), (2, 2), cv2.INTER_NEAREST_EXACT, "interpolation 6"),
    (np.zeros((4, 4), np.uint8), (0, 2), INTER_AREA, "empty"),
])
def test_refusals(src, dsize, interpolation, what):
    with pytest.raises(ValueError, match=what):
        resize(src, dsize, interpolation)


BLOCKED = r"""
import json, sys
for name in ("imageio", "imageio.v3", "cv2", "sklearn"):
    sys.modules[name] = None
import numpy as np
from pda_torch.data.resize import resize
rng = np.random.default_rng(0)
out = []
for dtype, shape, dsize, interp in json.loads(sys.argv[1]):
    src = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    out.append(resize(src, dsize, interp).tolist())
loaded = [n for n in ("imageio", "cv2", "sklearn", "jax", "pda") if sys.modules.get(n) is not None]
print(json.dumps({"out": out, "loaded": loaded}))
"""


def test_resize_without_imageio_cv2_sklearn():
    cases = [("uint16", [40, 33], [8, 8], INTER_AREA), ("uint8", [40, 32], [8, 8], INTER_AREA),
             ("uint8", [5, 7], [12, 9], INTER_AREA), ("uint8", [40, 33], [9, 7], INTER_NEAREST)]
    out = subprocess.run([sys.executable, "-c", BLOCKED, json.dumps(cases)], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    rng = np.random.default_rng(0)
    for (dtype, shape, dsize, interp), got in zip(cases, result["out"]):
        src = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        assert got == cv2.resize(src, tuple(dsize), interpolation=interp).tolist()
