"""TensorBoard event files, written without tensorboardX.

``pda`` logs through tensorboardX; the port writes the same records itself,
so that a training run on the card machine leaves its curves and panels:

  file      ``events.out.tfevents.<first 10 characters of time.time()>.<host>``
            in the log directory, as tensorboardX names it; written through
            a buffer, flushed at :meth:`EventWriter.flush` and ``close``
  framing   TFRecord: the data's length (uint64, little-endian), the masked
            CRC-32C of those 8 bytes, the data, the masked CRC-32C of the data
  records   ``Event`` protobufs, encoded here: first ``file_version =
            "brain.Event:2"``, then one ``Summary`` value per call, a
            ``simple_value`` scalar or an ``image`` (height, width,
            colorspace and the PNG bytes of :func:`pda_torch.data.png.encode`,
            zlib level 1)

Images are what tensorboardX's ``add_image`` makes of a (C, H, W) array: HWC,
one channel repeated to RGB, float values times 255 cast to uint8. The CRC is
computed in Python from a 256-entry table (Castagnoli polynomial, reflected),
a byte at a time (a few MB/s) or, for long records, in numpy over 4 KiB
lanes at once. :func:`read_records` and :func:`parse_event` read such a file
back, its CRCs checked.
"""

from __future__ import annotations

import functools
import os
import re
import socket
import struct
import time

import numpy as np

from ..data import png

FILE_VERSION = "brain.Event:2"
# zlib level of the panels' PNGs: level 1 compresses a panel several times
# faster than Pillow's default 6, into a larger file; a panel is written inside
# the training loop
PNG_LEVEL = 1
_MASK_DELTA = 0xA282EAD8
_INVALID_TAG = re.compile(r"[^-/\w\.]")


def _crc_table() -> tuple:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()
_CRC_NP = np.array(_CRC_TABLE, np.uint32)
_LANE = 4096  # bytes a lane of the vectorised CRC
_FAST = 16 * _LANE  # from this many bytes on, lanes in parallel


def _bytes_through(state: int, data: bytes) -> int:
    """The CRC register after ``data``, from ``state`` (no final xor)."""
    table = _CRC_TABLE
    for b in data:
        state = table[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


def _apply(columns: tuple, x: int) -> int:
    """A GF(2)-linear map on the 32-bit register, by its columns."""
    out, b = 0, 0
    while x:
        if x & 1:
            out ^= columns[b]
        x >>= 1
        b += 1
    return out


@functools.lru_cache(maxsize=None)
def _zeros(k: int) -> tuple:
    """The register's map through ``_LANE * 2**k`` zero bytes (columns)."""
    if k == 0:
        cols = []
        for b in range(32):
            c = _bytes_through(1 << b, bytes(_LANE))
            cols.append(c)
        return tuple(cols)
    half = _zeros(k - 1)
    return tuple(_apply(half, c) for c in half)


@functools.lru_cache(maxsize=None)
def _zeros_tables(k: int) -> np.ndarray:
    """``_zeros(k)`` as four 256-entry tables, one a byte of the register."""
    cols, v = _zeros(k), np.arange(256)
    tables = np.zeros((4, 256), np.uint32)
    for b in range(32):
        tables[b // 8, (v >> (b % 8)) & 1 == 1] ^= np.uint32(cols[b])
    return tables


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``. Long data runs as lanes of 4 KiB in
    parallel (numpy), whose registers the linearity of the CRC combines:
    a register shifted through n zero bytes is a linear map of it."""
    n = len(data)
    if n < _FAST:
        return _bytes_through(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    lanes = n // _LANE
    body = lanes * _LANE
    cols = np.frombuffer(data, np.uint8, count=body).reshape(lanes, _LANE).T.copy()
    reg = np.zeros(lanes, np.uint32)  # each lane from 0: the CRC's linear part
    for row in cols:
        reg = _CRC_NP[(reg ^ row) & 0xFF] ^ (reg >> 8)
    k = 0
    while len(reg) > 1:  # neighbours merge: the left one shifted through the right one
        if len(reg) % 2:
            reg = np.concatenate([np.zeros(1, np.uint32), reg])  # a zero lane adds nothing
        t, left = _zeros_tables(k), reg[0::2]
        reg = (t[0][left & 0xFF] ^ t[1][(left >> 8) & 0xFF] ^ t[2][(left >> 16) & 0xFF]
               ^ t[3][left >> 24] ^ reg[1::2])
        k += 1
    init, m, k = 0xFFFFFFFF, lanes, 0  # the initial register through the body
    while m:
        if m & 1:
            init = _apply(_zeros(k), init)
        m >>= 1
        k += 1
    return _bytes_through(int(reg[0]) ^ init, data[body:]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15 bits, plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# protobuf wire format: field keys are (number << 3) | wire type


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # int64: negatives as two's complement
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _int(field: int, n: int) -> bytes:
    return _varint(field << 3) + _varint(n)


def _bytes(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def event(wall_time: float, step: int = 0, *, file_version: str = "",
          summary: bytes = b"") -> bytes:
    """An ``Event``: wall_time 1 (double), step 2, file_version 3, summary 5;
    fields at their default left out, as protobuf writes them."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _int(2, step)
    if file_version:
        out += _bytes(3, file_version.encode())
    if summary:
        out += _bytes(5, summary)
    return out


def _value(tag: str, payload: bytes) -> bytes:
    """A ``Summary`` of one ``Summary.Value`` (tag 1)."""
    return _bytes(1, _bytes(1, tag.encode()) + payload)


def scalar_summary(tag: str, value: float) -> bytes:
    """simple_value 2 (float32)."""
    return _value(tag, _varint(2 << 3 | 5) + struct.pack("<f", value))


def image_summary(tag: str, hwc: np.ndarray) -> bytes:
    """image 4: ``Summary.Image`` height 1, width 2, colorspace 3,
    encoded_image_string 4, of an (H, W, 3) uint8 array."""
    h, w, c = hwc.shape
    image = _int(1, h) + _int(2, w) + _int(3, c) + _bytes(4, png.encode(hwc, PNG_LEVEL))
    return _value(tag, _bytes(4, image))


def _clean_tag(tag: str) -> str:
    """tensorboardX's tag cleaning: characters outside ``[-/\\w.]`` become
    ``_``, leading slashes go."""
    return _INVALID_TAG.sub("_", tag).lstrip("/")


def to_hwc_uint8(chw: np.ndarray) -> np.ndarray:
    """tensorboardX ``add_image``'s conversion of a (C, H, W) array."""
    hwc = np.asarray(chw).transpose(1, 2, 0)
    if hwc.shape[2] == 1:
        hwc = np.concatenate([hwc, hwc, hwc], 2)
    if hwc.dtype != np.uint8:
        hwc = (hwc * 255.0).astype(np.uint8)
    return hwc


def read_records(path: str) -> list:
    """The records of a TFRecord file, each length and masked CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    records, pos = [], 0
    while pos < len(data):
        header = data[pos: pos + 8]
        if len(data) < pos + 12:
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        (n,), (crc,) = struct.unpack("<Q", header), struct.unpack("<I", data[pos + 8: pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        body = data[pos + 12: pos + 12 + n]
        if len(data) < pos + 16 + n:
            raise ValueError(f"{path}: truncated record at byte {pos}")
        if struct.unpack("<I", data[pos + 12 + n: pos + 16 + n])[0] != masked_crc32c(body):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        records.append(body)
        pos += 16 + n
    return records


def _fields(buf: bytes):
    """(field number, value) of a protobuf message: ints for varints, bytes
    for length-delimited fields, raw little-endian bytes for fixed ones."""
    pos = 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return n

    while pos < len(buf):
        key = varint()
        wire = key & 7
        if wire == 0:
            value = varint()
        elif wire == 2:
            n = varint()
            value, pos = buf[pos: pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos: pos + n], pos + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not written here")
        yield key >> 3, value


def parse_event(data: bytes) -> dict:
    """The fields this module writes of an ``Event``: wall_time, step,
    file_version and the summary's values, each ``{"tag", "simple_value"}``
    or ``{"tag", "image": {"height", "width", "colorspace", "png"}}``."""
    out = {"wall_time": 0.0, "step": 0, "file_version": "", "values": []}
    for field, value in _fields(data):
        if field == 1:
            out["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2:
            out["step"] = value
        elif field == 3:
            out["file_version"] = value.decode()
        elif field == 5:
            for _, v in _fields(value):
                entry = {}
                for f, x in _fields(v):
                    if f == 1:
                        entry["tag"] = x.decode()
                    elif f == 2:
                        entry["simple_value"] = struct.unpack("<f", x)[0]
                    elif f == 4:
                        img = dict(_fields(x))
                        entry["image"] = {"height": img.get(1, 0), "width": img.get(2, 0),
                                          "colorspace": img.get(3, 0), "png": img.get(4, b"")}
                out["values"].append(entry)
    return out


class EventWriter:
    """One event file in ``log_dir``: ``add_scalar``, ``add_image``,
    ``flush`` and ``close`` as tensorboardX's ``SummaryWriter`` takes them."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{str(time.time())[:10]}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        self._write(event(time.time(), file_version=FILE_VERSION))

    def _write(self, data: bytes) -> None:
        self._file.write(tfrecord(data))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(event(time.time(), int(step),
                          summary=scalar_summary(_clean_tag(tag), float(value))))

    def add_image(self, tag: str, chw: np.ndarray, step: int) -> None:
        self._write(event(time.time(), int(step),
                          summary=image_summary(_clean_tag(tag), to_hwc_uint8(chw))))

    def flush(self) -> None:
        if not self._file.closed:
            self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
