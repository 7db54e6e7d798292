"""PNG reading and writing in numpy and zlib.

``pda`` reads the PNG frames of its EM datasets (Lucchi++, the VNC masks,
MitoEM's raw slices) through imageio (Pillow's plugin); the port reads them
here, so that the card machine needs no imageio.

  imread   (``decode`` for bytes) every PNG of the standard: color types
           0 (gray), 2 (RGB), 3 (palette), 4 (gray and alpha) and 6 (RGBA)
           at each bit depth the standard allows (1, 2, 4, 8, 16), all five
           row filters,
           Adam7 interlacing; checksums checked. It returns what
           ``imageio.v3.imread`` returns: a 1-bit gray image as bool, 2- and
           4-bit gray scaled to uint8 (x 85, x 17), 8- and 16-bit gray as
           uint8 and uint16 (H, W); 16-bit color reduced to its high byte;
           gray and alpha (H, W, 2) at 8 bits but RGBA (H, W, 4) at 16;
           palettes expanded to RGB (H, W, 3) (transparency dropped).
  imwrite  2D uint8 or uint16 (gray) and (H, W, 3) uint8 (RGB), no filter,
           not interlaced (``encode`` gives the file's bytes).

Any other file raises ``ValueError`` naming what it is.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_EXTS = (".png",)

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def is_png(path: str) -> bool:
    return str(path).lower().endswith(PNG_EXTS)


def _chunks(buf: bytes, path):
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        length, kind = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8: pos + 8 + length]
        crc, = struct.unpack_from(">I", buf, pos + 8 + length)
        if len(data) != length or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} at {pos} is truncated or corrupt")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG file ends before its IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, bpp: int, path) -> np.ndarray:
    """The reconstructed bytes (H, row bytes) of filtered rows (H, 1 + row bytes)."""
    kinds, raw = data[:, 0], data[:, 1:]
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"{path}: PNG row filter {int(kinds.max())}")
    h, n = raw.shape
    px = raw.reshape(h, n // bpp, bpp)
    if not np.isin(kinds, (3, 4)).any():  # None, Sub and Up: row by row, vectorized
        out = np.empty_like(px)
        prev = np.zeros_like(px[0])
        for y in range(h):
            row = px[y]
            if kinds[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif kinds[y] == 2:
                row = row + prev
            out[y] = prev = row
        return out.reshape(h, n)
    # Average and Paeth read the reconstructed left, upper and upper-left
    # pixels: the cells of one anti-diagonal are independent of each other
    w = n // bpp
    x = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    kinds = kinds.astype(np.int32)
    for t in range(h + w - 1):
        ys = np.arange(max(0, t - w + 1), min(h, t + 1))
        xs = t - ys
        a, b, c = x[ys + 1, xs], x[ys, xs + 1], x[ys, xs]
        f = kinds[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        x[ys + 1, xs + 1] = (px[ys, xs] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8).reshape(h, n)


def _samples(data: bytes, h: int, w: int, depth: int, channels: int, path) -> np.ndarray:
    """The (h, w, channels) sample values of one pass's filtered bytes."""
    row = (w * channels * depth + 7) // 8
    need = h * (row + 1)
    if len(data) < need:
        raise ValueError(f"{path}: PNG image data too short ({len(data)} of {need} bytes)")
    rows = np.frombuffer(data, np.uint8, need).reshape(h, row + 1)
    raw = _unfilter(rows, max(1, channels * depth // 8), path)
    if depth == 16:
        return raw.view(">u2").reshape(h, w, channels).astype(np.uint16)
    if depth == 8:
        return raw.reshape(h, w, channels)
    bits = np.unpackbits(raw, axis=1)[:, : w * channels * depth].reshape(h, w * channels, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8).reshape(h, w, channels)


def imread(path: str) -> np.ndarray:
    """The image of a PNG file, as ``imageio.v3.imread`` gives it."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def decode(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """The image of a PNG file's bytes (``path`` names it in errors)."""
    header, palette, idat = None, None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: PNG file without IHDR")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG color type {ctype} at bit depth {depth}")
    if compression or filtering or interlace > 1:
        raise ValueError(f"{path}: PNG compression {compression}, filter method {filtering}, "
                         f"interlace {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    data = zlib.decompress(b"".join(idat))
    if interlace:
        img = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = -(-(h - y0) // dy) if h > y0 else 0, -(-(w - x0) // dx) if w > x0 else 0
            if ph and pw:
                img[y0::dy, x0::dx] = _samples(data[pos:], ph, pw, depth, channels, path)
                pos += ph * ((pw * channels * depth + 7) // 8 + 1)
    else:
        img = _samples(data, h, w, depth, channels, path)
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette
        return full[img[..., 0]]
    if ctype == 0:
        gray = img[..., 0]
        if depth == 1:
            return gray.astype(bool)
        return gray * np.uint8(255 // (2**depth - 1)) if depth < 8 else gray
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        return img[..., [0, 0, 0, 1]] if ctype == 4 else img
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(array, level: int = 6) -> bytes:
    """A 2D uint8 or uint16 array as gray, an (H, W, 3) uint8 array as RGB,
    as the bytes of a PNG file (zlib compression ``level``)."""
    a = np.asarray(array)
    if a.ndim == 2 and a.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, 8 * a.dtype.itemsize
    elif a.ndim == 3 and a.shape[-1] == 3 and a.dtype == np.uint8:
        ctype, depth = 2, 8
    else:
        raise ValueError(f"PNG writer takes 2D uint8/uint16 or (H, W, 3) uint8, got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a, ">u2" if depth == 16 else np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def imwrite(path: str, array) -> None:
    """A 2D uint8 or uint16 array as gray, an (H, W, 3) uint8 array as RGB."""
    data = encode(array)
    with open(path, "wb") as f:
        f.write(data)
