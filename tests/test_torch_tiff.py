"""The port's TIFF codec (pda_torch/data/tiff.py) against imageio (Pillow's
plugin, what ``pda`` reads and writes TIFFs with), both ways: each dtype,
both byte orders, strips and tiles, LZW, Deflate and PackBits with and
without the horizontal predictor; the refusals; and the port's file-facing
entry points with imageio blocked."""

import os
import struct
import subprocess
import sys
import zlib

import imageio.v3 as imageio
import numpy as np
import pytest
from PIL import Image

from pda_torch.data import tiff

REPO = os.path.join(os.path.dirname(__file__), "..")
DTYPES = ("uint8", "uint16", "int32", "float32")


def _array(dtype, shape=(37, 53), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return (rng.normal(size=shape) * 100).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True).astype(dtype)


def _packbits(data: bytes) -> bytes:
    """PackBits of ``data``: literal runs of up to 128 bytes, and repeats of
    3 or more equal bytes as one replicate run."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = min(i + 128, len(data))
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def handmade_tiff(path, a, order="<", *, compression=1, predictor=1, tile=None,
                  rows_per_strip=None, extra=()):
    """A baseline TIFF of 2D ``a`` in byte order ``order``, in strips of
    ``rows_per_strip`` rows or in ``tile`` (h, w) tiles, uncompressed,
    Deflate (8) or PackBits (32773); ``extra`` adds (tag, value) SHORTs."""
    a = np.asarray(a)
    fmt = {"u": 1, "i": 2, "f": 3}[a.dtype.kind]
    bits = 8 * a.dtype.itemsize
    length, width = a.shape

    def encode(block):
        u = np.ascontiguousarray(block).view(f"u{a.dtype.itemsize}")
        if predictor == 2:
            u = u.copy()
            u[:, 1:] = u[:, 1:] - u[:, :-1]
        raw = u.astype(u.dtype.newbyteorder(order)).tobytes()
        if compression == 8:
            return zlib.compress(raw)
        if compression == 32773:
            return _packbits(raw)
        return raw

    if tile is None:
        rps = rows_per_strip or length
        blocks = [encode(a[y:y + rps]) for y in range(0, length, rps)]
        layout = [(278, 4, [rps])]
        offset_tag, count_tag = 273, 279
    else:
        th, tw = tile
        pad = np.zeros((-(-length // th) * th, -(-width // tw) * tw), a.dtype)
        pad[:length, :width] = a
        blocks = [encode(pad[y:y + th, x:x + tw]) for y in range(0, pad.shape[0], th)
                  for x in range(0, pad.shape[1], tw)]
        layout = [(322, 3, [tw]), (323, 3, [th])]
        offset_tag, count_tag = 324, 325
    entries = [(256, 4, [width]), (257, 4, [length]), (258, 3, [bits]),
               (259, 3, [compression]), (262, 3, [1]), (277, 3, [1]), (284, 3, [1]),
               (317, 3, [predictor]), (339, 3, [fmt])] + layout
    entries += [(tag, 3, [value]) for tag, value in extra]
    n = len(entries) + 2
    ifd_end = 8 + 2 + 12 * n + 4
    # the offset and count arrays, then the blocks
    arrays_at = ifd_end
    data_at = arrays_at + 8 * len(blocks)
    offsets, pos = [], data_at
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    entries += [(offset_tag, 4, offsets), (count_tag, 4, [len(b) for b in blocks])]
    entries.sort()
    ifd = bytearray(struct.pack(order + "H", n))
    extern = bytearray()
    for tag, typ, values in entries:
        size = {3: 2, 4: 4}[typ]
        code = {3: "H", 4: "I"}[typ]
        packed = struct.pack(f"{order}{len(values)}{code}", *values)
        if len(packed) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(values)) + packed.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(values), arrays_at + len(extern))
            extern += packed
        assert size * len(values) == len(packed)
    ifd += struct.pack(order + "I", 0)
    extern = extern.ljust(data_at - arrays_at, b"\0")
    head = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", 8)
    with open(path, "wb") as f:
        f.write(head + bytes(ifd) + bytes(extern) + b"".join(blocks))


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_writes_what_imageio_reads(dtype, tmp_path):
    a = _array(dtype)
    tiff.imwrite(str(tmp_path / "a.tif"), a)
    b = imageio.imread(str(tmp_path / "a.tif"))
    assert b.dtype == a.dtype and np.array_equal(a, b)
    assert tiff.imread(str(tmp_path / "a.tif")).tobytes() == a.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
                                         "packbits"])
def test_port_reads_what_pillow_writes(dtype, compression, tmp_path):
    """imageio's writer (uncompressed) and Pillow's compressors: LZW (5),
    Deflate (8 and 32946), PackBits (32773)."""
    a = _array(dtype, seed=1)
    path = str(tmp_path / "a.tif")
    if compression is None:
        imageio.imwrite(path, a)
    else:
        Image.fromarray(a).save(path, compression=compression)
    b = tiff.imread(path)
    assert b.dtype == a.dtype and np.array_equal(b, imageio.imread(path))
    assert np.array_equal(b, a)


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
def test_port_reads_pillow_predictor_files(dtype, compression, tmp_path):
    a = _array(dtype, shape=(40, 300), seed=2) // 3  # long rows: many LZW codes
    path = str(tmp_path / "a.tif")
    Image.fromarray(a).save(path, compression=compression, tiffinfo={317: 2})
    assert Image.open(path).tag_v2.get(317) == 2
    assert np.array_equal(tiff.imread(path), imageio.imread(path))


def test_port_reads_pillow_big_endian(tmp_path):
    a = _array("uint16", seed=3)
    path = str(tmp_path / "be.tif")
    Image.frombytes("I;16B", a.shape[::-1], a.astype(">u2").tobytes()).save(path)
    with open(path, "rb") as f:
        assert f.read(2) == b"MM"
    assert np.array_equal(tiff.imread(path), imageio.imread(path))
    assert np.array_equal(tiff.imread(path), a)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", [
    {"rows_per_strip": 7},
    {"rows_per_strip": 7, "compression": 8, "predictor": 2},
    {"rows_per_strip": 5, "compression": 32773},
    {"tile": (16, 32)},
    {"tile": (16, 16), "compression": 8, "predictor": 2},
    {"tile": (32, 16), "compression": 32773},
])
def test_port_reads_strips_and_tiles_of_both_byte_orders(order, dtype, layout, tmp_path):
    """Files of either byte order, in strips or (edge-padded) tiles, each
    compression with and without the predictor: the port reads the array
    back, as imageio does where Pillow reads the file."""
    a = _array(dtype, seed=4)
    path = str(tmp_path / "a.tif")
    handmade_tiff(path, a, order, **layout)
    if dtype == "float32" and layout.get("predictor") == 2:
        # defined for integer samples only (Pillow adds the differences as floats)
        with pytest.raises(ValueError, match=r"Predictor \(317\) = 2 with SampleFormat"):
            tiff.imread(path)
        return
    b = tiff.imread(path)
    assert b.dtype == a.dtype and b.dtype.isnative and b.tobytes() == a.tobytes()
    try:
        ref = imageio.imread(path)
    except Exception:  # a layout Pillow cannot read
        return
    assert np.array_equal(b, ref)


@pytest.mark.parametrize("name", ["p.tif", "p.tiff", "p.png"])
def test_prediction_writer_routes_by_extension(name, tmp_path):
    """A prediction's file goes through the port's codec for .tif and
    .tiff, and through imageio for any other extension."""
    from pda_torch.infer import predict

    a = (np.arange(12 * 20, dtype=np.float32).reshape(12, 20) % 7 == 0).astype(np.uint8)
    path = str(tmp_path / name)
    predict._write_tiff(path, a)
    with open(path, "rb") as f:
        magic = f.read(4)
    assert magic == (b"\x89PNG" if name.endswith(".png") else b"II*\x00")
    assert np.array_equal(imageio.imread(path), a)
    assert np.array_equal(tiff.read_image(path), a)


@pytest.mark.parametrize("case,message", [
    ({"compression": 7}, r"Compression \(259\) = 7"),
    ({"predictor": 3}, r"Predictor \(317\) = 3"),
    ({"extra": ((266, 2),)}, r"FillOrder \(266\) = 2"),
])
def test_unsupported_files_raise_naming_the_tag(case, message, tmp_path):
    path = str(tmp_path / "a.tif")
    handmade_tiff(path, _array("uint8"), **case)
    with pytest.raises(ValueError, match=message):
        tiff.imread(path)


def test_other_refusals(tmp_path):
    rgb = str(tmp_path / "rgb.tif")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(rgb)
    with pytest.raises(ValueError, match=r"SamplesPerPixel \(277\) = 3"):
        tiff.imread(rgb)
    with open(tmp_path / "big.tif", "wb") as f:
        f.write(b"II+\x00" + bytes(12))
    with pytest.raises(ValueError, match="BigTIFF"):
        tiff.imread(str(tmp_path / "big.tif"))
    with pytest.raises(ValueError):
        tiff.imwrite(str(tmp_path / "x.tif"), np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(ValueError):
        tiff.imwrite(str(tmp_path / "x.tif"), np.zeros((2, 2), np.float64))


_BLOCKED = r"""
import os, sys
sys.modules["imageio"] = None  # any import of imageio now raises
sys.modules["imageio.v3"] = None
import numpy as np
import torch
from pda_torch.data import load_image, tiff
from pda_torch.eval import run_dice_evaluation
from pda_torch.infer import punet_prediction, predict
from pda_torch.models import ProbabilisticUnet

root = sys.argv[1]
os.makedirs(os.path.join(root, "in"))
os.makedirs(os.path.join(root, "gt"))
rng = np.random.default_rng(0)
frame = (rng.random((48, 64)) * 255).astype(np.uint8)
tiff.imwrite(os.path.join(root, "in", "a.tif"), frame)
tiff.imwrite(os.path.join(root, "gt", "a.tif"), (frame > 128).astype(np.uint16))
assert np.array_equal(load_image(os.path.join(root, "in", "a.tif")), frame)
assert np.array_equal(predict._read_image(os.path.join(root, "in", "a.tif")), frame)
predict._write_tiff(os.path.join(root, "w.tif"), frame.astype(np.float32))
assert np.array_equal(tiff.imread(os.path.join(root, "w.tif")), frame)
model = ProbabilisticUnet(num_filters=(4, 8, 12, 16), latent_dim=6, no_convs_fcomb=3)
punet_prediction(os.path.join(root, "in", "*.tif"), os.path.join(root, "out"), model,
                 prior_samples=2, block_shape=(32, 32), halo=(8, 8), verbose=False)
out = tiff.imread(os.path.join(root, "out", "a.tif"))
assert out.shape == frame.shape and out.dtype == np.float32
d = run_dice_evaluation(os.path.join(root, "gt", "*"), os.path.join(root, "out"), verbose=False)
assert 0.0 <= d <= 1.0
try:
    import imageio
except ImportError:
    print("BLOCKED-OK")
"""


def test_file_entry_points_work_with_imageio_blocked(tmp_path):
    path = os.pathsep.join(p for p in (os.path.abspath(REPO), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path)
    r = subprocess.run([sys.executable, "-c", _BLOCKED, str(tmp_path)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0 and "BLOCKED-OK" in r.stdout, r.stderr
