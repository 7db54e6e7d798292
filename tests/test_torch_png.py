"""The port's PNG codec (pda_torch/data/png.py) against imageio (Pillow's
plugin) on the CPU: files of every color type at every bit depth the
standard allows, each row filter and mixed filters, Adam7 interlacing, odd
sizes down to 1x1, written here by a small encoder (numpy + zlib) and by
Pillow, read by the port exactly as ``imageio.v3.imread`` reads them
(shape, dtype, values); the port's writer read back by imageio; the routing
of ``.png`` through :func:`pda_torch.data.tiff.read_image`; the refusals.
Exact data paths: every comparison is bit-equal."""

import struct
import warnings
import zlib

import imageio.v3 as imageio
import numpy as np
import pytest
from PIL import Image

from pda_torch.data import png, tiff

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(c, d) for c, ds in png._DEPTHS.items() for d in ds]
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _rows(samples, depth, filt):
    """Filtered scanlines of (h, w, c) samples; ``filt`` 5 cycles 0-4."""
    h, w, c = samples.shape
    if h == 0 or w == 0:
        return b""
    bpp = max(1, c * depth // 8)
    prev = bytearray((w * c * depth + 7) // 8)
    out = bytearray()
    for y in range(h):
        vals = samples[y].reshape(-1).astype(np.uint64)
        if depth == 16:
            raw = bytearray(vals.astype(">u2").tobytes())
        elif depth == 8:
            raw = bytearray(vals.astype(np.uint8).tobytes())
        else:
            bits = np.zeros(len(vals) * depth, np.uint8)
            for k in range(depth):
                bits[k::depth] = (vals >> np.uint64(depth - 1 - k)) & np.uint64(1)
            raw = bytearray(np.packbits(bits).tobytes())
        f = filt if filt != 5 else y % 5
        enc = bytearray(len(raw))
        for i in range(len(raw)):
            a = raw[i - bpp] if i >= bpp else 0
            b = prev[i]
            cc = prev[i - bpp] if i >= bpp else 0
            p = (0, a, b, (a + b) // 2)[f] if f < 4 else (
                a if abs(b - cc) <= abs(a - cc) and abs(b - cc) <= abs(a + b - 2 * cc)
                else b if abs(a - cc) <= abs(a + b - 2 * cc) else cc)
            enc[i] = (raw[i] - p) & 0xFF
        out += bytes([f]) + enc
        prev = raw
    return bytes(out)


def encode(samples, ctype, depth, *, palette=None, trns=None, interlace=0, filt=0):
    h, w, _ = samples.shape
    if interlace:
        data = b"".join(_rows(samples[y::dy, x::dx], depth, filt) for y, x, dy, dx in ADAM7)
    else:
        data = _rows(samples, depth, filt)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                     interlace))
    if palette is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).reshape(-1)))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    idat = zlib.compress(data)
    half = len(idat) // 2  # two IDAT chunks
    return out + _chunk(b"IDAT", idat[:half]) + _chunk(b"IDAT", idat[half:]) + _chunk(b"IEND", b"")


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("ctype,depth", KINDS)
def test_reads_as_imageio_does(ctype, depth, filt, interlace, tmp_path):
    rng = np.random.default_rng(100 * ctype + 10 * depth + filt + 7 * interlace)
    for k, shape in enumerate([(1, 1), (3, 5), (13, 11), (9, 17)]):
        s = rng.integers(0, 2**depth, size=(*shape, CHANNELS[ctype]))
        pal = rng.integers(0, 256, size=(2**depth, 3)) if ctype == 3 else None
        path = str(tmp_path / f"{k}.png")
        with open(path, "wb") as f:
            f.write(encode(s, ctype, depth, palette=pal, interlace=interlace, filt=filt))
        assert same(png.imread(path), np.asarray(imageio.imread(path))), shape


@pytest.mark.parametrize("case", ["gray_trns", "rgb_trns", "palette_trns", "short_palette"])
def test_transparency_and_short_palettes(case, tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "t.png")
    if case == "gray_trns":
        data = encode(rng.integers(0, 256, (6, 7, 1)), 0, 8, trns=struct.pack(">H", 5))
    elif case == "rgb_trns":
        data = encode(rng.integers(0, 256, (6, 7, 3)), 2, 8, trns=struct.pack(">HHH", 1, 2, 3))
    elif case == "palette_trns":
        data = encode(rng.integers(0, 4, (6, 7, 1)), 3, 2, palette=rng.integers(0, 256, (4, 3)),
                      trns=bytes([0, 128]))
    else:
        data = encode(rng.integers(0, 3, (6, 7, 1)), 3, 8, palette=rng.integers(0, 256, (3, 3)))
    with open(path, "wb") as f:
        f.write(data)
    with warnings.catch_warnings():  # Pillow warns about a palette's transparency
        warnings.simplefilter("ignore")
        ref = np.asarray(imageio.imread(path))
    assert same(png.imread(path), ref)


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "RGBA", "LA", "P", "1"])
def test_reads_pillow_files(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    shape = (37, 53)
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 2**16, shape, dtype=np.uint16))
    elif mode == "1":
        img = Image.fromarray(rng.random(shape) < 0.5)
    elif mode == "P":
        img = Image.fromarray(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).quantize(40)
    else:
        c = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2}[mode]
        a = rng.integers(0, 256, (*shape, c), dtype=np.uint8)
        img = Image.fromarray(a[..., 0] if c == 1 else a, mode)
    for k, kw in enumerate(({}, {"optimize": True}, {"compress_level": 0})):
        path = str(tmp_path / f"{k}.png")
        img.save(path, **kw)
        assert same(png.imread(path), np.asarray(imageio.imread(path))), kw


@pytest.mark.parametrize("dtype,shape", [("uint8", (31, 45)), ("uint16", (31, 45)),
                                         ("uint8", (31, 45, 3)), ("uint8", (1, 1)),
                                         ("uint16", (300, 1))])
def test_written_files_read_by_imageio(dtype, shape, tmp_path):
    info = np.iinfo(dtype)
    a = np.random.default_rng(2).integers(0, info.max, shape, dtype=dtype, endpoint=True)
    path = str(tmp_path / "w.png")
    png.imwrite(path, a)
    assert same(np.asarray(imageio.imread(path)), a)
    assert same(png.imread(path), a)
    # routed through the image entry points by extension
    tiff.write_image(str(tmp_path / "r.png"), a)
    assert same(tiff.read_image(str(tmp_path / "r.png")), a)


def test_refusals(tmp_path):
    path = str(tmp_path / "x.png")
    good = encode(np.zeros((3, 3, 1), np.uint8), 0, 8)

    def check(data, match):
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=match):
            png.imread(path)

    check(b"GIF89a" + good[6:], "not a PNG file")
    check(good[:-30], "truncated or corrupt|ends before")
    bad = bytearray(good)
    bad[20] ^= 0xFF  # inside IHDR: its checksum no longer holds
    check(bytes(bad), "corrupt")
    ihdr = struct.pack(">IIBBBBB", 3, 3, 4, 2, 0, 0, 0)  # RGB at 4 bits
    check(png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IEND", b""),
          "color type 2 at bit depth 4")
    ihdr = struct.pack(">IIBBBBB", 3, 3, 8, 3, 0, 0, 0)
    check(png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(b"\0" * 12))
          + _chunk(b"IEND", b""), "without PLTE")
    rows = bytes([7, 0, 0, 0]) * 3  # filter type 7
    ihdr = struct.pack(">IIBBBBB", 3, 3, 8, 0, 0, 0, 0)
    check(png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows))
          + _chunk(b"IEND", b""), "row filter 7")
    check(png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(b"\0" * 5))
          + _chunk(b"IEND", b""), "too short")
    with pytest.raises(ValueError, match="PNG writer takes"):
        png.imwrite(path, np.zeros((3, 3), np.float32))
