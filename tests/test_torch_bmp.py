"""The port's BMP reader (pda_torch/data/bmp.py) against imageio (Pillow's
plugin), which ``pda`` reads JSRT segmentation02's raw images with: files
written by Pillow, and by the encoder of ``bmp_encoder.py`` for what Pillow
does not write (the OS/2 and V4/V5 headers, 4- and 16-bit pixels,
BI_BITFIELDS, RLE8 and RLE4, top-down rows); every file must give
imageio's array, dtype and shape; the refusals; a ``.bmp`` through
``load_image``, ``read_image`` and the prediction entry points' glob; and
the reader in a subprocess with imageio, cv2 and scikit-learn blocked."""

import json
import os
import subprocess
import sys

import imageio.v3 as iio
import numpy as np
import pytest
import torch
from PIL import Image

from bmp_encoder import encode, rle_encode
from pda_torch.data import bmp, tiff
from pda_torch.data.datasets import load_image
from pda_torch.data.synthetic import write_bmp

REPO = os.path.join(os.path.dirname(__file__), "..")
MASKS32 = [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
           (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)]
MASKS16 = [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)]
# (header size, top-down rows): the OS/2 core header has no top-down form
LAYOUTS = [(12, False)] + [(h, t) for h in (40, 108, 124) for t in (False, True)]


def same_as_imageio(buf: bytes, tmp_path, name="x.bmp"):
    """The reader gives imageio's array, dtype and shape, or raises
    ValueError where imageio raises."""
    path = tmp_path / name
    path.write_bytes(buf)
    try:
        ref = iio.imread(path)
    except OSError:
        with pytest.raises(ValueError):
            bmp.imread(str(path))
        return None
    out = bmp.imread(str(path))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out, ref)
    return out


def palette(kind, bits, rng):
    n = 1 << bits
    if kind == "grey":
        return np.repeat(np.arange(n)[:, None], 3, 1)
    if kind == "bw":
        return np.array([[0, 0, 0], [255, 255, 255]])
    return rng.integers(0, 256, (n, 3))


@pytest.mark.parametrize("mode", ["L", "P", "1", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (17, 31), (64, 66)])
def test_pillow_written_files(mode, shape, tmp_path):
    rng = np.random.default_rng(sum(shape))
    if mode in ("L", "P"):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
    elif mode == "1":
        a = rng.integers(0, 2, shape).astype(bool)
    else:
        a = rng.integers(0, 256, shape + (len(mode),), dtype=np.uint8)
    img = Image.fromarray(a)
    if mode == "P":
        img = Image.fromarray(a, "L").convert("P")
        img.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    path = tmp_path / "p.bmp"
    img.save(path)
    out = same_as_imageio(path.read_bytes(), tmp_path)
    if mode == "L":
        assert np.array_equal(out, a)


@pytest.mark.parametrize("header,top_down", LAYOUTS)
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("kind", ["grey", "bw", "color"])
def test_palette_files(header, top_down, bits, kind, tmp_path):
    rng = np.random.default_rng(bits + header)
    pal = palette(kind, bits, rng)
    idx = rng.integers(0, len(pal), (7, 13))
    same_as_imageio(encode(idx, bits, header=header, palette=pal, top_down=top_down), tmp_path)


@pytest.mark.parametrize("header,top_down", LAYOUTS)
@pytest.mark.parametrize("bits", [16, 24, 32])
def test_direct_files(header, top_down, bits, tmp_path):
    rng = np.random.default_rng(bits)
    px = rng.integers(0, 256, (9, 11, bits // 8))
    same_as_imageio(encode(px, bits, header=header, top_down=top_down), tmp_path)


def test_every_16_bit_value(tmp_path):
    px = np.arange(65536, dtype="<u2").reshape(256, 256).view(np.uint8).reshape(256, 256, 2)
    same_as_imageio(encode(px, 16), tmp_path)
    for masks in MASKS16:
        same_as_imageio(encode(px, 16, compression=bmp.BI_BITFIELDS, masks=masks), tmp_path)


@pytest.mark.parametrize("header", [40, 108, 124])
@pytest.mark.parametrize("layout", range(len(MASKS32) + len(MASKS16)))
def test_bitfields(header, layout, tmp_path):
    rng = np.random.default_rng(layout)
    masks = (MASKS32 + MASKS16)[layout]
    bits = 32 if len(masks) == 4 else 16
    if header == 40 and bits == 32 and masks[3]:
        masks = masks[:3] + (0,)  # the 40-byte header carries no alpha mask
    px = rng.integers(0, 256, (6, 5, bits // 8))
    out = same_as_imageio(encode(px, bits, header=header, compression=bmp.BI_BITFIELDS,
                                 masks=masks), tmp_path)
    if out is None:  # (0xFF, 0xFF00, 0xFF0000) without alpha: no layout Pillow reads
        assert (header, masks) == (40, MASKS32[4][:3] + (0,))
    else:
        assert out.shape[-1] == (4 if bits == 32 and (masks[3] or not any(masks)) else 3)


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("kind", ["grey", "color"])
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("absolute", [False, True])
def test_rle(rle4, kind, top_down, absolute, tmp_path):
    rng = np.random.default_rng(int(rle4) * 8 + int(top_down) * 2 + int(absolute))
    bits = 4 if rle4 else 8
    pal = palette(kind, bits, rng)
    runs = np.repeat(rng.integers(0, len(pal), (9, 6)), rng.integers(1, 5, 6), axis=1)
    idx = np.concatenate([runs, rng.integers(0, len(pal), (9, 7))], axis=1)
    stream = rle_encode(idx if top_down else idx[::-1], rle4, absolute=absolute)
    same_as_imageio(encode(idx, bits, compression=bmp.BI_RLE4 if rle4 else bmp.BI_RLE8,
                           palette=pal, top_down=top_down, pixel_data=stream), tmp_path)


def test_pillow_quirks(tmp_path):
    """Kept as Pillow has them: an odd RLE4 absolute run adds one pixel
    fewer than it advances; a run past the row's end; a palette read from
    after the header when the offset says there is none; a grey ramp read
    at 8 bits a pixel and a black-and-white palette at 1 from 4-bit rows;
    a last row without its padding."""
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (16, 3))
    idx = np.arange(9)[None] % 16
    odd = bytes([0, 3, 0x12, 0x30, 0, 9, 0x45, 0x67, 0x89, 0xAB, 0xC0, 0, 0, 0, 0, 1])
    same_as_imageio(encode(idx, 4, compression=bmp.BI_RLE4, palette=pal, pixel_data=odd),
                    tmp_path)
    long_run = bytes([20, 7, 0, 0, 0, 1])
    same_as_imageio(encode(idx, 8, compression=bmp.BI_RLE8, palette=palette("color", 8, rng),
                           pixel_data=long_run), tmp_path)
    grid = rng.integers(0, 256, (4, 6))
    same_as_imageio(encode(grid, 8, palette=palette("color", 8, rng), data_offset=54), tmp_path)
    small = rng.integers(0, 16, (3, 4))
    same_as_imageio(encode(small, 4, palette=palette("grey", 4, rng)), tmp_path)
    same_as_imageio(encode(small % 2, 4, palette=palette("bw", 1, rng)), tmp_path)
    same_as_imageio(encode(small, 8, palette=palette("color", 8, rng))[:-2], tmp_path)


REFUSALS = {
    "not a BMP file": lambda r: b"PN" + encode(r.integers(0, 9, (2, 2)), 24)[2:],
    "header size 52": lambda r: encode(r.integers(0, 9, (2, 2, 3)), 24).replace(
        b"\x28\x00\x00\x00", b"\x34\x00\x00\x00", 1),
    "bits per pixel 2": lambda r: encode(r.integers(0, 4, (2, 2)), 2, palette=np.zeros((4, 3))),
    "compression 4": lambda r: encode(r.integers(0, 9, (2, 2, 3)), 24, compression=4),
    "BI_BITFIELDS at 8 bits": lambda r: encode(r.integers(0, 9, (2, 2)), 8, compression=3,
                                               palette=np.zeros((256, 3)), masks=(1, 2, 4)),
    "compression 1 at 4 bits": lambda r: encode(r.integers(0, 9, (2, 2)), 4, compression=1,
                                                palette=np.zeros((16, 3))),
    "bitfield masks": lambda r: encode(r.integers(0, 9, (2, 2, 4)), 32, compression=3,
                                       masks=(0xFF, 0xFF00, 0xFF0000)),
    "colors used 300": lambda r: encode(r.integers(0, 9, (2, 2)), 8,
                                        palette=r.integers(0, 256, (300, 3))),
    "RLE delta": lambda r: encode(r.integers(0, 9, (2, 3)), 8, compression=1,
                                  palette=np.zeros((256, 3)),
                                  pixel_data=bytes([0, 2, 1, 1, 3, 4, 0, 0, 0, 1])),
    "RLE data ends": lambda r: encode(r.integers(0, 9, (2, 3)), 8, compression=1,
                                      palette=np.zeros((256, 3)), pixel_data=bytes([2, 7, 0, 1])),
    "black-and-white palette under RLE": lambda r: encode(
        r.integers(0, 2, (2, 3)), 8, compression=1, palette=palette("bw", 1, r),
        pixel_data=bytes([3, 1, 0, 0, 3, 0, 0, 1])),
    "hold fewer than": lambda r: encode(r.integers(0, 16, (2, 40)), 4,
                                        palette=palette("grey", 4, r)),
    "truncated pixel data": lambda r: encode(r.integers(0, 9, (4, 4, 3)), 24)[:-20],
    "width 0": lambda r: encode(np.zeros((2, 0, 3), np.uint8), 24),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_refusals(what, tmp_path):
    path = tmp_path / "bad.bmp"
    path.write_bytes(REFUSALS[what](np.random.default_rng(1)))
    with pytest.raises(ValueError, match=what):
        bmp.imread(str(path))


def test_synthetic_writer_and_file_entry_points(tmp_path):
    """write_bmp's JSRT-style files read back through the reader, imageio,
    load_image and read_image; the prediction glob finds them and
    punet_prediction writes one map per BMP."""
    from pda_torch.infer import punet_prediction
    from pda_torch.infer.predict import _glob_images, _read_image
    from pda_torch.models import ProbabilisticUnet

    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (37, 45), dtype=np.uint8)
    path = str(tmp_path / "img" / "JPCLN001.bmp")
    os.makedirs(os.path.dirname(path))
    write_bmp(path, a)
    for read in (bmp.imread, iio.imread, load_image, tiff.read_image):
        out = np.asarray(read(path))
        assert out.dtype == np.uint8 and np.array_equal(out, a)
    assert _glob_images(os.path.dirname(path)) == [path]
    assert _glob_images(os.path.join(os.path.dirname(path), "*")) == [path]
    assert np.array_equal(_read_image(path), a.astype(np.float32))
    model = ProbabilisticUnet(num_filters=(4, 8, 12, 16), latent_dim=6, no_convs_fcomb=3,
                              rl_swap=False, generator=torch.Generator().manual_seed(0))
    punet_prediction(os.path.join(os.path.dirname(path), "*"), str(tmp_path / "pred"), model,
                     prior_samples=2, verbose=False)
    pred = tiff.imread(str(tmp_path / "pred" / "JPCLN001.tif"))
    assert pred.shape == a.shape and pred.dtype == np.float32 and np.isfinite(pred).all()


BLOCKED = r"""
import json, sys
for name in ("imageio", "imageio.v3", "cv2", "sklearn", "PIL", "PIL.Image"):
    sys.modules[name] = None
import numpy as np
from pda_torch.data import bmp, tiff
from pda_torch.data.datasets import load_image
out = {}
for path in sys.argv[1:]:
    a = load_image(path)
    b = tiff.read_image(path)
    out[path] = [str(a.dtype), list(a.shape), int(a.sum()), bool(np.array_equal(a, b))]
loaded = [n for n in ("imageio", "cv2", "sklearn", "PIL", "jax", "pda")
          if sys.modules.get(n) is not None]
print(json.dumps({"read": out, "loaded": loaded}))
"""


def test_reader_without_imageio_cv2_sklearn(tmp_path):
    rng = np.random.default_rng(5)
    files = {
        "grey.bmp": encode(rng.integers(0, 256, (6, 7)), 8, palette=palette("grey", 8, rng)),
        "rle4.bmp": encode(np.zeros((2, 4), int), 4, compression=bmp.BI_RLE4,
                           palette=palette("color", 4, rng),
                           pixel_data=rle_encode(np.zeros((2, 4), int), True)),
        "argb.bmp": encode(rng.integers(0, 256, (3, 5, 4)), 32, header=124,
                           compression=bmp.BI_BITFIELDS, masks=MASKS32[5]),
    }
    for name, buf in files.items():
        (tmp_path / name).write_bytes(buf)
    paths = [str(tmp_path / n) for n in files]
    out = subprocess.run([sys.executable, "-c", BLOCKED, *paths], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    for p in paths:
        ref = iio.imread(p)
        assert result["read"][p] == [str(ref.dtype), list(ref.shape), int(ref.sum()), True]
