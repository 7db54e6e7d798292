"""Baseline TIFF reading and writing in numpy and the standard library.

``pda`` reads and writes its TIFFs through imageio (Pillow's plugin); the
port does it here, so that every file of the LIVECell pipeline (images,
label maps, probability maps, pseudo-labels, consensus masks) needs
nothing beyond numpy.

  imwrite  2D uint8, uint16, int32 or float32 array -> little-endian TIFF,
           uncompressed, one strip
  imread   the first page of a TIFF of either byte order, in strips or
           tiles, uncompressed (1), LZW (5), Deflate (8, 32946) or PackBits
           (32773), predictor 1, or 2 for integer samples, one sample a
           pixel; any other file raises ``ValueError`` naming the tag and
           its value

:func:`read_image` and :func:`write_image` route by extension: ``.tif`` and
``.tiff`` to this codec, ``.png`` to :mod:`.png`, ``.bmp`` (read only) to
:mod:`.bmp`, any other extension to imageio, imported on first use.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import bmp, png

TIFF_EXTS = (".tif", ".tiff")

# tags
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS = 266, 273, 277, 278, 279
_PLANAR, _PREDICTOR, _TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS = (
    284, 317, 322, 323, 324, 325)
_SAMPLE_FORMAT = 339

# integer field type -> (struct code, bytes); the tags read here hold integers
_INT_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
              9: ("i", 4), 13: ("I", 4)}
# (SampleFormat, BitsPerSample) -> numpy kind and size
_DTYPES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (1, 64): "u8",
           (2, 8): "i1", (2, 16): "i2", (2, 32): "i4", (2, 64): "i8",
           (3, 32): "f4", (3, 64): "f8"}
# what imwrite takes: dtype -> (BitsPerSample, SampleFormat)
_WRITABLE = {np.dtype("uint8"): (8, 1), np.dtype("uint16"): (16, 1),
             np.dtype("int32"): (32, 2), np.dtype("float32"): (32, 3)}


def is_tiff(path: str) -> bool:
    return str(path).lower().endswith(TIFF_EXTS)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_ifd(buf: bytes, order: str, offset: int) -> dict:
    """The first IFD's integer tags -> tuples of their values."""
    if offset + 2 > len(buf):
        raise ValueError(f"TIFF IFD offset {offset} lies past the end of the file")
    (n,) = struct.unpack_from(order + "H", buf, offset)
    tags = {}
    for k in range(n):
        pos = offset + 2 + 12 * k
        tag, typ, count = struct.unpack_from(order + "HHI", buf, pos)
        if typ not in _INT_TYPES:
            continue  # text, rationals, floats: nothing this reader needs
        code, size = _INT_TYPES[typ]
        where = pos + 8 if size * count <= 4 else struct.unpack_from(order + "I", buf, pos + 8)[0]
        tags[tag] = struct.unpack_from(f"{order}{count}{code}", buf, where)
    return tags


def _one(tags: dict, tag: int, name: str, default=None) -> int:
    if tag not in tags:
        if default is None:
            raise ValueError(f"TIFF tag {name} ({tag}) is missing")
        return default
    values = set(tags[tag])
    if len(values) != 1:
        raise ValueError(f"TIFF tag {name} ({tag}) = {tags[tag]}: expected one value")
    return values.pop()


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, Clear 256, EOI 257, the
    code width growing one code early."""
    if data[:2] == b"\x00\x01":
        raise ValueError("TIFF tag Compression (259) = 5 in the old-style LZW bit order: "
                         "not supported")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, acc, accbits, prev = 9, 0, 0, None
    for byte in data:
        acc = (acc << 8) | byte
        accbits += 8
        while accbits >= nbits:
            accbits -= nbits
            code = (acc >> accbits) & ((1 << nbits) - 1)
            acc &= (1 << accbits) - 1
            if code == 256:
                del table[258:]
                nbits, prev = 9, None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"corrupt LZW data: code {code} beyond the table ({len(table)})")
            out += entry
            prev = entry
            if len(table) >= (1 << nbits) - 1 and nbits < 12:
                nbits += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(chunk: bytes, compression: int) -> bytes:
    if compression == 1:
        return chunk
    if compression == 5:
        return _lzw_decode(chunk)
    if compression in (8, 32946):
        return zlib.decompress(chunk)
    if compression == 32773:
        return _packbits_decode(chunk)
    raise ValueError(f"TIFF tag Compression (259) = {compression}: not supported "
                     "(1, 5, 8, 32946 and 32773 are)")


def _block(buf, offset, count, compression, rows, cols, dtype, predictor) -> np.ndarray:
    """One strip or tile -> (rows, cols) array of ``dtype`` (file byte order)."""
    raw = _decompress(buf[offset:offset + count], compression)
    need = rows * cols * dtype.itemsize
    if len(raw) < need:
        raise ValueError(f"TIFF strip or tile at {offset} decodes to {len(raw)} bytes, "
                         f"expected {need}")
    a = np.frombuffer(raw, dtype=dtype, count=rows * cols).reshape(rows, cols)
    if predictor == 2:  # horizontal differencing, modulo 2^bits
        u = a.view(f"{dtype.str[0]}u{dtype.itemsize}").astype(f"=u{dtype.itemsize}")
        a = np.cumsum(u, axis=1, dtype=u.dtype).view(dtype.newbyteorder("="))
    return a


def imread(path: str) -> np.ndarray:
    """The first page of a TIFF as a 2D numpy array, native byte order."""
    with open(path, "rb") as f:
        buf = f.read()
    head = buf[:4]
    if head == b"II*\x00":
        order = "<"
    elif head == b"MM\x00*":
        order = ">"
    elif head[:2] in (b"II", b"MM") and len(buf) >= 4:
        version = struct.unpack_from("<H" if head[:2] == b"II" else ">H", buf, 2)[0]
        raise ValueError(f"TIFF version {version} (BigTIFF is 43): not supported, 42 is")
    else:
        raise ValueError(f"{path}: not a TIFF file (header {head!r})")
    (ifd,) = struct.unpack_from(order + "I", buf, 4)
    tags = _read_ifd(buf, order, ifd)

    width = _one(tags, _WIDTH, "ImageWidth")
    length = _one(tags, _LENGTH, "ImageLength")
    samples = _one(tags, _SAMPLES, "SamplesPerPixel", 1)
    if samples != 1:
        raise ValueError(f"TIFF tag SamplesPerPixel (277) = {samples}: only 1 is supported")
    bits = _one(tags, _BITS, "BitsPerSample", 1)
    fmt = _one(tags, _SAMPLE_FORMAT, "SampleFormat", 1)
    if (fmt, bits) not in _DTYPES:
        raise ValueError(f"TIFF tag BitsPerSample (258) = {bits} with SampleFormat (339) = "
                         f"{fmt}: not supported")
    photometric = _one(tags, _PHOTOMETRIC, "PhotometricInterpretation", 1)
    if photometric != 1:
        raise ValueError(f"TIFF tag PhotometricInterpretation (262) = {photometric}: only 1 "
                         "(BlackIsZero) is supported")
    fill = _one(tags, _FILL_ORDER, "FillOrder", 1)
    if fill != 1:
        raise ValueError(f"TIFF tag FillOrder (266) = {fill}: only 1 is supported")
    compression = _one(tags, _COMPRESSION, "Compression", 1)
    if compression not in (1, 5, 8, 32946, 32773):
        raise ValueError(f"TIFF tag Compression (259) = {compression}: not supported "
                         "(1, 5, 8, 32946 and 32773 are)")
    predictor = _one(tags, _PREDICTOR, "Predictor", 1)
    if predictor not in (1, 2):
        raise ValueError(f"TIFF tag Predictor (317) = {predictor}: only 1 and 2 are supported")
    if predictor == 2 and fmt == 3:
        raise ValueError("TIFF tag Predictor (317) = 2 with SampleFormat (339) = 3: horizontal "
                         "differencing is defined for integer samples only")
    dtype = np.dtype(order + _DTYPES[(fmt, bits)])

    out = np.empty((length, width), dtype=dtype.newbyteorder("="))
    if _TILE_OFFSETS in tags:
        tw = _one(tags, _TILE_WIDTH, "TileWidth")
        tl = _one(tags, _TILE_LENGTH, "TileLength")
        offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS)
        across = -(-width // tw)
        n_tiles = across * -(-length // tl)
        if counts is None or len(offsets) < n_tiles or len(counts) < n_tiles:
            raise ValueError(f"TIFF tag TileOffsets (324) holds {len(offsets)} tiles, "
                             f"expected {n_tiles}")
        for k in range(n_tiles):
            y, x = (k // across) * tl, (k % across) * tw
            tile = _block(buf, offsets[k], counts[k], compression, tl, tw, dtype, predictor)
            out[y:y + tl, x:x + tw] = tile[:length - y, :width - x]
    else:
        if _STRIP_OFFSETS not in tags:
            raise ValueError("TIFF tag StripOffsets (273) is missing")
        rps = min(_one(tags, _ROWS_PER_STRIP, "RowsPerStrip", length), length)
        offsets = tags[_STRIP_OFFSETS]
        counts = tags.get(_STRIP_COUNTS)
        n_strips = -(-length // rps)
        if counts is None or len(offsets) < n_strips or len(counts) < n_strips:
            raise ValueError(f"TIFF tag StripOffsets (273) holds {len(offsets)} strips, "
                             f"expected {n_strips}")
        for k in range(n_strips):
            y = k * rps
            rows = min(rps, length - y)
            out[y:y + rows] = _block(buf, offsets[k], counts[k], compression, rows, width,
                                     dtype, predictor)
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def imwrite(path: str, array) -> None:
    """A 2D uint8, uint16, int32 or float32 array -> a little-endian baseline
    TIFF, uncompressed, in one strip."""
    a = np.asarray(array)
    if a.ndim != 2:
        raise ValueError(f"imwrite takes a 2D array, got shape {a.shape}")
    if a.dtype.newbyteorder("=") not in _WRITABLE:
        raise ValueError(f"imwrite takes uint8, uint16, int32 or float32, got {a.dtype}")
    bits, fmt = _WRITABLE[a.dtype.newbyteorder("=")]
    data = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
    length, width = a.shape
    # (tag, type, value): SHORT 3, LONG 4; one value each, ascending tags
    entries = [(_WIDTH, 4, width), (_LENGTH, 4, length), (_BITS, 3, bits),
               (_COMPRESSION, 3, 1), (_PHOTOMETRIC, 3, 1), (_STRIP_OFFSETS, 4, None),
               (_SAMPLES, 3, 1), (_ROWS_PER_STRIP, 4, length), (_STRIP_COUNTS, 4, len(data)),
               (_PLANAR, 3, 1), (_SAMPLE_FORMAT, 3, fmt)]
    data_offset = 8 + 2 + 12 * len(entries) + 4
    ifd = bytearray(struct.pack("<H", len(entries)))
    for tag, typ, value in entries:
        value = data_offset if value is None else value
        ifd += struct.pack("<HHI", tag, typ, 1)
        ifd += struct.pack("<H2x", value) if typ == 3 else struct.pack("<I", value)
    ifd += struct.pack("<I", 0)  # no next IFD
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8) + bytes(ifd) + data)


# ---------------------------------------------------------------------------
# routing by extension
# ---------------------------------------------------------------------------


def read_image(path: str) -> np.ndarray:
    """A TIFF through :func:`imread`, a PNG through :func:`.png.imread`, a
    BMP through :func:`.bmp.imread`; any other file through imageio."""
    if is_tiff(path):
        return imread(path)
    if png.is_png(path):
        return png.imread(path)
    if bmp.is_bmp(path):
        return bmp.imread(path)
    import imageio.v3 as imageio

    return np.asarray(imageio.imread(path))


def write_image(path: str, array) -> None:
    """A TIFF through :func:`imwrite`, a PNG through :func:`.png.imwrite`;
    any other file through imageio."""
    if is_tiff(path):
        imwrite(path, array)
        return
    if png.is_png(path):
        png.imwrite(path, array)
        return
    import imageio.v3 as imageio

    imageio.imwrite(path, np.ascontiguousarray(array))


