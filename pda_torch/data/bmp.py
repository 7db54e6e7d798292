"""BMP reading in numpy.

``pda`` reads the raw JSRT segmentation02 radiographs (``org_<split>/*.bmp``)
through imageio, whose Pillow plugin decodes them; the port reads them
here, so that the card machine needs no imageio. :func:`imread` returns
what ``imageio.v3.imread`` returns:

  headers     BITMAPINFOHEADER (40), BITMAPV4HEADER (108), BITMAPV5HEADER
              (124) and the OS/2 core header (12, 3-byte palette entries,
              always bottom-up)
  rows        bottom-up, or top-down where the height is negative, each
              row padded to 4 bytes
  1, 4, 8     with a palette (``BI_RGB``), 8 with ``BI_RLE8``, 4 with
              ``BI_RLE4``: a palette that is the identity grey ramp (entry
              i is (i, i, i)) gives the indices as 2D uint8, and a
              black-then-white 2-entry palette gives 2D bool; any other
              palette gives RGB (H, W, 3) uint8, an index past the
              palette's end black. As Pillow's raw decoder does, the grey
              ramp's indices are read at 8 bits a pixel and the
              black-and-white one's at 1, whatever the file's depth
  16          ``BI_RGB`` (5-5-5) or ``BI_BITFIELDS`` (5-5-5 or 5-6-5): RGB,
              each field scaled as ``v * 255 // max``
  24          ``BI_RGB`` (or ``BI_BITFIELDS`` with the RGB masks): RGB
  32          ``BI_RGB``: RGB, the fourth byte dropped; ``BI_BITFIELDS``
              with one of Pillow's eight mask layouts: RGB, or RGBA where
              the layout has an alpha mask

Pillow's quirks are kept: under RLE4 an absolute run of odd length adds
one pixel fewer than it advances the row, and a run past the row's end is
cut (encoded) or not (absolute); the palette is taken from just after the
header when the pixel data's offset says there is none. Any other file
raises ``ValueError`` naming the header field at fault, among them the RLE
delta escape (Pillow misreads it), a palette of more than 2**bits colors,
a black-and-white palette under RLE, rows too short for a grey palette's
8-bit reading, and a truncated file.
"""

from __future__ import annotations

import struct

import numpy as np

BMP_EXTS = (".bmp",)

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3

# (bits, masks) -> (channel order of the decoded bytes, output channels);
# the masks are (R, G, B) for 16 and 24 bits, (R, G, B, A) for 32 bits
_BITFIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): ("BGRX", "RGB"),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): ("XBGR", "RGB"),
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): ("BGXR", "RGB"),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): ("ABGR", "RGBA"),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): ("RGBA", "RGBA"),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): ("BGRA", "RGBA"),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): ("BGAR", "RGBA"),
    (32, (0x0, 0x0, 0x0, 0x0)): ("BGRA", "RGBA"),
    (24, (0xFF0000, 0xFF00, 0xFF)): ("BGR", "RGB"),
    (16, (0xF800, 0x7E0, 0x1F)): ("BGR;16", "RGB"),
    (16, (0x7C00, 0x3E0, 0x1F)): ("BGR;15", "RGB"),
}


def is_bmp(path: str) -> bool:
    return str(path).lower().endswith(BMP_EXTS)


def imread(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), path)


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def _header(buf: bytes, path):
    """The fields of the file and info headers that decoding needs."""
    if len(buf) < 18 or buf[:2] != b"BM":
        _fail(path, f"not a BMP file (signature {buf[:2]!r})")
    offset, size = struct.unpack_from("<II", buf, 10)
    h = {"offset": offset, "header_size": size, "masks": None}
    if size == 12:
        if len(buf) < 26:
            _fail(path, "truncated header")
        h["width"], h["height"], _, h["bits"] = struct.unpack_from("<HHHH", buf, 18)
        h.update(compression=BI_RGB, colors=0, top_down=False, entry=3, pos=26)
    elif size in (40, 108, 124):
        if len(buf) < 14 + size:
            _fail(path, "truncated header")
        (h["width"], height, _, h["bits"], h["compression"], _, _, _,
         h["colors"]) = struct.unpack_from("<IIHHIIIII", buf, 18)
        # Pillow takes the height as negative (top-down) when its top byte is 0xFF
        h["top_down"] = buf[25] == 0xFF
        h["height"] = 2 ** 32 - height if h["top_down"] else height
        h.update(entry=4, pos=14 + size)
        if h["compression"] == BI_BITFIELDS:
            if size == 40:  # the three masks follow the header
                if len(buf) < 66:
                    _fail(path, "truncated bitfield masks")
                h["masks"] = struct.unpack_from("<III", buf, 54) + (0,)
                h["pos"] = 66
            else:
                h["masks"] = struct.unpack_from("<IIII", buf, 54)
    else:
        _fail(path, f"header size {size} is not 12, 40, 108 or 124")
    if h["width"] == 0 or h["height"] == 0:
        _fail(path, f"width {h['width']} or height {h['height']} is 0")
    if h["bits"] not in (1, 4, 8, 16, 24, 32):
        _fail(path, f"bits per pixel {h['bits']} is not 1, 4, 8, 16, 24 or 32")
    h["colors"] = h["colors"] or (1 << h["bits"])
    if h["offset"] == 14 + size and h["bits"] <= 8:
        h["offset"] += 4 * h["colors"]
    return h


def _palette(buf: bytes, h, path):
    """(palette as (n, 3) RGB uint8, the kind Pillow gives it: "1", "L" or "P")."""
    colors, entry, pos = h["colors"], h["entry"], h["pos"]
    if colors > 1 << h["bits"]:
        _fail(path, f"colors used {colors} exceeds 2**{h['bits']}")
    # Pillow reads what there is: a palette cut by the file's end is not grey
    raw = buf[pos:pos + entry * colors]
    bgr = np.frombuffer(raw[:len(raw) - len(raw) % entry], np.uint8).reshape(-1, entry)[:, :3]
    rgb = np.ascontiguousarray(bgr[:, ::-1])
    ramp = np.array([0, 255]) if colors == 2 else np.arange(colors)
    if len(bgr) == colors and (bgr == ramp[:, None] % 256).all():
        return rgb, "1" if colors == 2 else "L"
    return rgb, "P"


def _rows(buf: bytes, h, path, read_bits: int) -> np.ndarray:
    """The rows, top row first, as (height, stride) uint8. As Pillow's raw
    decoder does, each row is read at ``read_bits`` a pixel (a grey
    palette's indices at 8, a black-and-white one's at 1, whatever the
    file's depth), and the last row in the file needs no padding."""
    stride = ((h["width"] * h["bits"] + 31) >> 3) & ~3
    row_bytes = (read_bits * h["width"] + 7) // 8
    if stride < row_bytes:
        _fail(path, f"rows of {stride} bytes hold fewer than {h['width']} pixels of "
                    f"{read_bits} bits (a grey palette is read at 8 bits a pixel)")
    n = stride * h["height"]
    start = h["offset"] or h["pos"]
    data = buf[start:start + n]
    if len(data) < n - stride + row_bytes:
        _fail(path, f"truncated pixel data ({len(data)} of {n} bytes)")
    data += b"\x00" * (n - len(data))
    rows = np.frombuffer(data, np.uint8).reshape(h["height"], stride)
    return rows if h["top_down"] else rows[::-1]


def _unpack_indices(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    if bits == 8:
        return rows[:, :width]
    if bits == 4:
        return np.stack([rows >> 4, rows & 15], -1).reshape(len(rows), -1)[:, :width]
    return np.unpackbits(rows, axis=1)[:, :width]


def _rle(buf: bytes, h, path) -> np.ndarray:
    """Pillow's BmpRleDecoder: the indices, top row first, (height, width)."""
    width, height, rle4 = h["width"], h["height"], h["compression"] == BI_RLE4
    need = width * height
    data = bytearray()
    x = 0
    i = h["offset"] or h["pos"]
    while len(data) < need:
        if i + 2 > len(buf):
            break
        count, byte = buf[i], buf[i + 1]
        i += 2
        if count:  # encoded run, cut at the row's end
            count = max(0, width - x) if x + count > width else count
            if rle4:
                pair = (byte >> 4, byte & 15)
                data += bytes(pair[k % 2] for k in range(count))
            else:
                data += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            data += b"\x00" * (-len(data) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:
            _fail(path, "RLE delta escape (0, 2) is not supported")
        else:  # absolute run
            nbytes = byte // 2 if rle4 else byte
            run = buf[i:i + nbytes]
            i += len(run)
            data += bytes(v for b in run for v in (b >> 4, b & 15)) if rle4 else run
            if len(run) < nbytes:
                break
            x += byte
            i += i % 2  # runs end on a 16-bit boundary of the file
    if len(data) < need:
        _fail(path, f"RLE data ends after {len(data)} of {need} pixels")
    out = np.frombuffer(bytes(data[:need]), np.uint8).reshape(height, width)
    return out if h["top_down"] else out[::-1]


def _scale(v: np.ndarray, top: int) -> np.ndarray:
    return (v.astype(np.uint32) * 255 // top).astype(np.uint8)


def _direct(rows: np.ndarray, h, path) -> np.ndarray:
    """16-, 24- and 32-bit pixels -> RGB or RGBA uint8."""
    bits, width, masks = h["bits"], h["width"], h["masks"]
    if masks is None:
        order, out = {16: ("BGR;15", "RGB"), 24: ("BGR", "RGB"), 32: ("BGRX", "RGB")}[bits]
    else:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BITFIELDS:
            _fail(path, f"bitfield masks {tuple(hex(m) for m in key[1])} at {bits} bits "
                        "are not a layout Pillow reads")
        order, out = _BITFIELDS[key]
    if bits == 16:
        px = rows[:, :2 * width].view("<u2").astype(np.uint32)
        if order == "BGR;16":
            r, g, b = _scale(px >> 11 & 31, 31), _scale(px >> 5 & 63, 63), _scale(px & 31, 31)
        else:
            r, g, b = _scale(px >> 10 & 31, 31), _scale(px >> 5 & 31, 31), _scale(px & 31, 31)
        return np.stack([r, g, b], -1)
    n = len(order)
    px = rows[:, :n * width].reshape(len(rows), width, n)
    return np.ascontiguousarray(px[..., [order.index(c) for c in out]])


def decode(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """The image of a BMP file's bytes, as :func:`imread` returns it."""
    h = _header(buf, path)
    bits, comp = h["bits"], h["compression"]
    if comp not in (BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS):
        _fail(path, f"compression {comp} is not BI_RGB, BI_RLE8, BI_RLE4 or BI_BITFIELDS")
    if comp == BI_BITFIELDS and bits not in (16, 24, 32):
        _fail(path, f"compression BI_BITFIELDS at {bits} bits per pixel")
    if comp in (BI_RLE8, BI_RLE4) and bits != (8 if comp == BI_RLE8 else 4):
        _fail(path, f"compression {comp} at {bits} bits per pixel")
    if bits > 8:
        return _direct(_rows(buf, h, path, bits), h, path)

    palette, kind = _palette(buf, h, path)
    if comp == BI_RGB:
        read_bits = {"1": 1, "L": 8, "P": bits}[kind]
        idx = _unpack_indices(_rows(buf, h, path, read_bits), read_bits, h["width"])
    else:
        if kind == "1":
            _fail(path, f"a black-and-white palette under RLE (compression {comp})")
        idx = _rle(buf, h, path)
    if kind == "L":
        return np.ascontiguousarray(idx)
    if kind == "1":
        return idx.astype(bool)
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(palette)] = palette
    return lut[idx]
