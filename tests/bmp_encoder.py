"""A general BMP encoder for the port's BMP reader tests: every header
(12, 40, 108, 124), bit depth and compression that
:mod:`pda_torch.data.bmp` reads, and files it must refuse. Pillow writes
only a few of these (8-bit palettes, 24 and 32 bits, 40-byte headers), so
the tests make the rest here."""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np


def pack_rows(pixels: np.ndarray, bits: int) -> list:
    """Rows of indices (bits <= 8) or of raw pixel bytes (bits > 8, as
    (H, W, bytes) uint8) -> each row's bytes padded to 4."""
    rows = []
    for row in pixels:
        if bits == 1:
            raw = np.packbits(row.astype(np.uint8)).tobytes()
        elif bits == 4:
            r = row.astype(np.uint8)
            r = np.concatenate([r, np.zeros(len(r) % 2, np.uint8)])
            raw = ((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes()
        elif bits == 8:
            raw = row.astype(np.uint8).tobytes()
        else:
            raw = np.ascontiguousarray(row, np.uint8).tobytes()
        rows.append(raw + b"\x00" * (-len(raw) % 4))
    return rows


def rle_encode(idx: np.ndarray, rle4: bool, absolute: bool = True, eob: bool = True) -> bytes:
    """A valid RLE8/RLE4 stream of ``idx`` (rows in file order): encoded runs
    of equal values, absolute runs of 3 or more differing values (even in
    length under RLE4, padded to 16 bits), an end of line after each row."""
    out = bytearray()
    for row in idx:
        row = [int(v) for v in row]
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2 or not absolute:
                out += bytes((run, (row[x] << 4) | row[x] if rle4 else row[x]))
                x += run
                continue
            end = x
            while end < len(row) and end - x < 254 and (end + 1 >= len(row)
                                                          or row[end + 1] != row[end]):
                end += 1
            n = end - x
            if rle4:
                n -= n % 2
            if n < 3:
                out += bytes((1, (row[x] << 4) if rle4 else row[x]))
                x += 1
                continue
            vals = row[x:x + n]
            if rle4:
                body = bytes((vals[k] << 4) | vals[k + 1] for k in range(0, n, 2))
            else:
                body = bytes(vals)
            out += bytes((0, n)) + body + b"\x00" * (len(body) % 2)
            x += n
        out += b"\x00\x00"
    if eob:
        out += b"\x00\x01"
    return bytes(out)


def encode(pixels: np.ndarray, bits: int, *, header: int = 40, compression: int = 0,
           palette: Optional[np.ndarray] = None, top_down: bool = False,
           masks: Optional[Sequence[int]] = None, colors: Optional[int] = None,
           pixel_data: Optional[bytes] = None, data_offset: Optional[int] = None) -> bytes:
    """A BMP file of ``pixels`` (top row first). ``palette`` is (n, 3) RGB;
    ``masks`` the BI_BITFIELDS masks (R, G, B[, A]); ``pixel_data``
    replaces the packed rows (an RLE stream); ``data_offset`` overrides the
    file header's offset field."""
    h, w = pixels.shape[:2]
    if pixel_data is None:
        rows = pack_rows(pixels, bits)
        pixel_data = b"".join(rows if top_down else rows[::-1])
    entry = 3 if header == 12 else 4
    pal = b""
    if palette is not None and header == 12 and len(palette) < 1 << bits:
        # the core header has no colors field: its palette has 2**bits entries
        palette = np.concatenate([palette, np.zeros(((1 << bits) - len(palette), 3), int)])
    if palette is not None:
        bgr = np.asarray(palette, np.uint8)[:, ::-1]
        pal = b"".join(bytes(e) + b"\x00" * (entry - 3) for e in bgr)
    ncolors = len(palette) if palette is not None else 0
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        height = (2 ** 32 - h) if top_down else h
        info = struct.pack("<IIIHHIIIIII", header, w, height, 1, bits, compression,
                           len(pixel_data), 2835, 2835,
                           ncolors if colors is None else colors, 0)
        if header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            info += struct.pack("<IIII", *m[:4]) + b"\x00" * (header - 56)
        elif masks is not None:
            info += struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(pal) if data_offset is None else data_offset
    size = 14 + len(info) + len(pal) + len(pixel_data)
    return b"BM" + struct.pack("<IHHI", size, 0, 0, offset) + info + pal + pixel_data
