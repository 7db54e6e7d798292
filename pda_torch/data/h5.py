"""HDF5 reading and writing in numpy and the standard library, for the
files h5py writes with its default settings.

``pda`` keeps its EM volumes (MitoEM, VNC, Lucchi++, UroCell) in HDF5 files
through h5py; the port reads and writes them here, so that the MitoEM
pipeline needs nothing beyond numpy and zlib.

  reading  superblock version 0; version-1 object headers (continuation
           blocks included); groups as symbol tables (a version-1 B-tree
           of type 0, a local heap, symbol-table nodes), nested paths such
           as ``labels/mito``; the dataspace, datatype, fill-value, layout
           (version 3: compact, contiguous or chunked) and filter-pipeline
           messages; integer and IEEE float types of either byte order;
           chunks indexed by a version-1 B-tree of type 1, each through
           deflate and shuffle as its filter mask says. Only the chunks
           that overlap the requested window are read, and decompressed
           chunks stay in a bounded cache (64 MiB). A chunk
           never written reads as the fill value.
  writing  a superblock-0 file of groups and chunked datasets, deflate at
           level 4 (h5py's ``compression="gzip"``), from a whole array
           (``data=``) or one leading-axis slice at a time (chunks
           ``(1, *shape[1:])``), so that a volume never has to sit whole
           in memory.

Any other file raises ``ValueError`` naming the feature: superblock 2/3,
version-2 object headers, link messages (compact or dense groups), layout
versions other than 3 (the version-4 chunk indices), filters other than
deflate and shuffle, and datatypes other than integers and IEEE floats.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
DEFLATE_LEVEL = 4  # h5py's compression="gzip"
CACHE_BYTES = 64 * 1024 * 1024  # pda's rdcc_nbytes

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = (
    0x6, 0x8, 0xA, 0xB, 0x10, 0x11)
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf"}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
# (size, sign bit, exponent location, exponent size, mantissa size, bias) of IEEE floats
_IEEE = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}

# the writer's geometry: 8-byte addresses and lengths, h5py's B-tree widths
_GROUP_LEAF_K, _GROUP_NODE_K, _CHUNK_K = 4, 16, 32


def _refuse(path, what):
    raise ValueError(f"{path}: unsupported HDF5 feature: {what}")


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    """The file's bytes by address, through ``os.pread`` (thread-safe)."""

    def __init__(self, path):
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)
        self.base = 0

    def read(self, addr, n):
        b = os.pread(self.fd, n, self.base + addr)
        if len(b) != n:
            raise ValueError(f"{self.path}: truncated HDF5 file (read {n} bytes at {addr})")
        return b

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


def _messages(r, addr):
    """(type, flags, body) of every message of the version-1 object header
    at ``addr``, continuation blocks followed."""
    head = r.read(addr, 16)
    version = head[0]
    if head[:4] == b"OHDR":
        _refuse(r.path, "version-2 object header")
    if version != 1:
        _refuse(r.path, f"object header version {version}")
    n_msgs, _, size = struct.unpack_from("<HII", head, 2)
    blocks = [(addr + 16, size)]
    out = []
    while blocks and len(out) < n_msgs:
        start, length = blocks.pop(0)
        buf = r.read(start, length)
        pos = 0
        while pos + 8 <= length and len(out) < n_msgs:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
            body = buf[pos + 8: pos + 8 + msize]
            pos += 8 + msize
            pos += -pos % 8
            if mtype == _CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", body))
            out.append((mtype, flags, body))
    return out


def _parse_dtype(path, body):
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = body[1] | body[2] << 8 | body[3] << 16
    size = struct.unpack_from("<I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            _refuse(path, f"integer type of {size} bytes, precision {precision}, offset {offset}")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:
        offset, precision, exp_loc, exp_size, mant_loc, mant_size, bias = struct.unpack_from(
            "<HHBBBBI", body, 8)
        sign = (bits >> 8) & 0xFF
        if (size not in _IEEE or bits & 0x40 or offset != 0 or precision != 8 * size
                or mant_loc != 0
                or (sign, exp_loc, exp_size, mant_size, bias) != _IEEE[size]):
            _refuse(path, f"non-IEEE floating-point type of {size} bytes")
        return np.dtype(f"{order}f{size}")
    _refuse(path, f"datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')}), "
                  f"version {version}")


def _parse_dataspace(path, body):
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:  # null dataspace
            _refuse(path, "null dataspace")
        pos = 4
    else:
        _refuse(path, f"dataspace message version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", body, pos))


def _parse_filters(path, body):
    version, n = body[0], body[1]
    pos = 8 if version == 1 else 2
    if version not in (1, 2):
        _refuse(path, f"filter pipeline message version {version}")
    filters = []
    for _ in range(n):
        fid, = struct.unpack_from("<H", body, pos)
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len, = struct.unpack_from("<H", body, pos)
            pos += 2
        flags, n_vals = struct.unpack_from("<HH", body, pos)
        pos += 4
        pos += name_len + (-name_len % 8 if version == 1 else 0)
        values = struct.unpack_from(f"<{n_vals}I", body, pos)
        pos += 4 * n_vals + (4 * (n_vals % 2) if version == 1 else 0)
        if fid not in (1, 2):
            _refuse(path, f"filter {fid} ({_FILTER_NAMES.get(fid, 'unknown')})")
        filters.append((fid, values))
    return filters


def _unshuffle(raw: bytes, size: int) -> bytes:
    n = len(raw) // size
    if size == 1 or n == 0:
        return raw
    a = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T
    return a.tobytes() + raw[n * size:]


class Dataset:
    """One dataset of a file open for reading: ``shape``, ``dtype``,
    ``chunks`` and windowed reads through indexing with integers and
    slices of positive step."""

    def __init__(self, file, name, msgs):
        self.file, self.name = file, name
        path = file.path
        self.shape = self.dtype = layout = None
        self.filters, fill = [], None
        for mtype, _, body in msgs:
            if mtype == _DATASPACE:
                self.shape = _parse_dataspace(path, body)
            elif mtype == _DATATYPE:
                self.dtype = _parse_dtype(path, body)
            elif mtype == _LAYOUT:
                layout = body
            elif mtype == _FILTERS:
                self.filters = _parse_filters(path, body)
            elif mtype == _FILL and body[0] in (1, 2) and body[3]:
                size, = struct.unpack_from("<I", body, 4)
                fill = body[8:8 + size] if size else None
            elif mtype == _FILL and body[0] == 3 and body[1] & 0x20:
                size, = struct.unpack_from("<I", body, 2)
                fill = body[6:6 + size]
            elif mtype == _FILL_OLD and fill is None:
                size, = struct.unpack_from("<I", body, 0)
                fill = body[4:4 + size] if size else None
        if self.shape is None or self.dtype is None or layout is None:
            raise ValueError(f"{path}: {name} is not a dataset of the supported kind")
        self.fill = np.frombuffer(fill, self.dtype)[0] if fill else self.dtype.type(0)
        version, kind = layout[0], layout[1]
        if version != 3:
            _refuse(path, f"data layout message version {version}"
                          + (" (version-4 chunk indices)" if version == 4 else ""))
        self.chunks = None
        if kind == 0:
            size, = struct.unpack_from("<H", layout, 2)
            self._compact = layout[4:4 + size]
        elif kind == 1:
            self._addr, self._size = struct.unpack_from("<QQ", layout, 2)
        elif kind == 2:
            ndims = layout[2]
            self._btree, = struct.unpack_from("<Q", layout, 3)
            dims = struct.unpack_from(f"<{ndims}I", layout, 11)
            self.chunks = tuple(dims[:-1])
            self._index = None
        else:
            _refuse(path, f"data layout class {kind}")
        self.kind = kind
        self.ndim = len(self.shape)
        self.size = int(np.prod(self.shape))

    # chunk index: {chunk coordinates: (address, size, filter mask)}
    def _chunk_index(self):
        if self._index is None:
            index = {}
            if self._btree != UNDEFINED:
                self._walk(self._btree, index)
            self._index = index
        return self._index

    def _walk(self, addr, index):
        r, rank = self.file._r, len(self.chunks)
        head = r.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"{r.path}: corrupt chunk B-tree at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        key = 8 + 8 * (rank + 1)
        body = r.read(addr + 24, used * (key + 8) + key)
        for i in range(used):
            pos = i * (key + 8)
            size, mask = struct.unpack_from("<II", body, pos)
            offsets = struct.unpack_from(f"<{rank}Q", body, pos + 8)
            child, = struct.unpack_from("<Q", body, pos + key)
            if level:
                self._walk(child, index)
            else:
                index[tuple(o // c for o, c in zip(offsets, self.chunks))] = (child, size, mask)

    def _chunk(self, coords):
        cache = self.file._cache
        key = (self.name, coords)
        with self.file._lock:
            hit = cache.get(key)
            if hit is not None:
                cache.move_to_end(key)
                return hit
        where = self._chunk_index().get(coords)
        if where is None:
            return np.full(self.chunks, self.fill, self.dtype)
        addr, size, mask = where
        raw = self.file._r.read(addr, size)
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:
                continue
            fid, values = self.filters[i]
            raw = zlib.decompress(raw) if fid == 1 else _unshuffle(raw, values[0])
        n = int(np.prod(self.chunks))
        arr = np.frombuffer(raw, self.dtype, n).reshape(self.chunks)
        self.file._keep(key, arr)
        return arr

    def _selection(self, index):
        if not isinstance(index, tuple):
            index = (index,)
        if any(i is Ellipsis for i in index):
            k = index.index(Ellipsis)
            index = index[:k] + (slice(None),) * (self.ndim - len(index) + 1) + index[k + 1:]
        if len(index) > self.ndim:
            raise IndexError(f"{len(index)} indices for a {self.ndim}-d dataset")
        index = index + (slice(None),) * (self.ndim - len(index))
        sel, squeeze = [], []
        for axis, (i, n) in enumerate(zip(index, self.shape)):
            if isinstance(i, (int, np.integer)):
                j = int(i) + n if i < 0 else int(i)
                if not 0 <= j < n:
                    raise IndexError(f"index {int(i)} out of range for axis {axis} of size {n}")
                sel.append(np.array([j]))
                squeeze.append(axis)
            elif isinstance(i, slice):
                if i.step is not None and i.step <= 0:
                    raise IndexError("only slices of positive step are supported")
                sel.append(np.arange(*i.indices(n)))
            else:
                raise TypeError(f"unsupported index {i!r}")
        return sel, tuple(squeeze)

    def __getitem__(self, index):
        sel, squeeze = self._selection(index)
        out_shape = tuple(len(s) for s in sel)
        if self.kind == 0:
            out = np.frombuffer(self._compact, self.dtype, self.size).reshape(self.shape)[
                np.ix_(*sel)] if all(out_shape) else np.empty(out_shape, self.dtype)
        elif self.kind == 1:
            out = np.empty(out_shape, self.dtype)
            if all(out_shape):
                if self._addr == UNDEFINED:
                    out[...] = self.fill
                else:
                    mm = np.memmap(self.file.path, self.dtype, "r",
                                   self.file._r.base + self._addr, self.shape)
                    out[...] = mm[np.ix_(*sel)]
                    del mm
        else:
            out = np.empty(out_shape, self.dtype)
            if all(out_shape):
                self._gather(sel, out)
        out = out.reshape([n for a, n in enumerate(out_shape) if a not in squeeze])
        return out.astype(self.dtype.newbyteorder("="), copy=False)

    def _gather(self, sel, out):
        per_axis = []
        for s, c in zip(sel, self.chunks):
            cid = s // c
            groups = []
            for k in np.unique(cid):
                where = np.flatnonzero(cid == k)
                groups.append((int(k), where, s[where] - int(k) * c))
            per_axis.append(groups)
        for combo in np.ndindex(*[len(g) for g in per_axis]):
            parts = [per_axis[a][j] for a, j in enumerate(combo)]
            chunk = self._chunk(tuple(p[0] for p in parts))
            out[np.ix_(*[p[1] for p in parts])] = chunk[np.ix_(*[p[2] for p in parts])]


class Group:
    """A group of a file open for reading: its members by name or path."""

    def __init__(self, file, name, btree, heap):
        self.file, self.name = file, name
        self._btree, self._heap = btree, heap
        self._links = None

    def _members(self):
        if self._links is None:
            r = self.file._r
            head = r.read(self._heap, 32)
            if head[:4] != b"HEAP":
                raise ValueError(f"{r.path}: corrupt local heap at {self._heap}")
            size, _, data = struct.unpack_from("<QQQ", head, 8)
            names = r.read(data, size)
            links = {}
            self._walk(self._btree, names, links)
            self._links = links
        return self._links

    def _walk(self, addr, names, links):
        r = self.file._r
        head = r.read(addr, 24)
        if head[:4] == b"SNOD":
            n, = struct.unpack_from("<H", head, 6)
            body = r.read(addr + 8, 40 * n)
            for i in range(n):
                name_off, obj = struct.unpack_from("<QQ", body, 40 * i)
                name = names[name_off:names.index(b"\0", name_off)].decode()
                links[name] = obj
            return
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{r.path}: corrupt group B-tree at {addr}")
        used, = struct.unpack_from("<H", head, 6)
        body = r.read(addr + 24, used * 16 + 8)
        for i in range(used):
            self._walk(struct.unpack_from("<Q", body, 16 * i + 8)[0], names, links)

    def keys(self):
        return sorted(self._members())

    def __getitem__(self, path):
        head, _, rest = str(path).strip("/").partition("/")
        links = self._members()
        if head not in links:
            raise KeyError(f"{self.file.path}: no member {head!r} in group {self.name!r}")
        obj = self.file._object(f"{self.name.rstrip('/')}/{head}", links[head])
        return obj[rest] if rest else obj


class File(Group):
    """An HDF5 file open for reading (:class:`Writer` writes one); at most
    ``CACHE_BYTES`` of decompressed chunks are kept."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        self._cache: OrderedDict = OrderedDict()
        self._cached = 0
        self._r = _Reader(self.path)
        try:
            btree, heap = self._superblock()
        except Exception:
            self.close()
            raise
        super().__init__(self, "/", btree, heap)

    def _superblock(self):
        r = self._r
        for base in (0, 512, 1024, 2048, 4096):
            if r.read(base, 8) == SIGNATURE:
                break
        else:
            raise ValueError(f"{self.path}: not an HDF5 file")
        head = r.read(base, 24)
        version = head[8]
        if version != 0:
            _refuse(self.path, f"superblock version {version}")
        if head[13] != 8 or head[14] != 8:
            _refuse(self.path, f"{head[13]}-byte addresses / {head[14]}-byte lengths")
        sb = r.read(base + 24, 72)
        r.base = struct.unpack_from("<Q", sb, 0)[0]
        root = struct.unpack_from("<Q", sb, 32 + 8)[0]
        return self._group_tables(root, "/")

    def _group_tables(self, addr, name):
        msgs = _messages(self._r, addr)
        for mtype, _, body in msgs:
            if mtype == _SYMBOL_TABLE:
                return struct.unpack_from("<QQ", body)
        if any(m[0] in (_LINK, _LINK_INFO, _GROUP_INFO) for m in msgs):
            _refuse(self.path, f"group {name!r} stored as link messages (a new-style group)")
        raise KeyError(name)

    def _object(self, name, addr):
        msgs = _messages(self._r, addr)
        types = {m[0] for m in msgs}
        if _SYMBOL_TABLE in types or types & {_LINK, _LINK_INFO, _GROUP_INFO}:
            return Group(self, name, *self._group_tables(addr, name))
        return Dataset(self, name, msgs)

    def _keep(self, key, arr):
        with self._lock:
            if key in self._cache or arr.nbytes > CACHE_BYTES:
                return
            self._cache[key] = arr
            self._cached += arr.nbytes
            while self._cached > CACHE_BYTES:
                _, old = self._cache.popitem(last=False)
                self._cached -= old.nbytes

    def close(self):
        self._r.close()
        self._cache.clear()
        self._cached = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _dtype_message(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind in "ui":
        bits = 0x08 if dt.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    sign, exp_loc, exp_size, mant_size, bias = _IEEE[size]
    return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size, exp_loc,
                       exp_size, 0, mant_size, bias)


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


class _WritableDataset:
    """A chunked dataset being written: ``ds[i] = a`` for chunks
    ``(1, *shape[1:])``."""

    def __init__(self, writer, shape, dtype, chunks):
        self.writer, self.shape, self.dtype, self.chunks = writer, shape, dtype, chunks
        self.ndim = len(shape)
        self.written = {}  # chunk coordinates -> (address, size)

    def _put(self, coords, block):
        raw = zlib.compress(np.ascontiguousarray(block, self.dtype).tobytes(), DEFLATE_LEVEL)
        if len(raw) >= 2**32:
            raise ValueError(f"a compressed chunk of {len(raw)} bytes exceeds HDF5's 4 GiB")
        self.written[coords] = (self.writer._append(raw), len(raw))

    def __setitem__(self, index, value):
        if (self.ndim < 1 or self.chunks != (1, *self.shape[1:])
                or not isinstance(index, (int, np.integer))):
            raise ValueError("write one leading-axis slice at a time, with chunks "
                             "(1, *shape[1:])")
        i = int(index) + self.shape[0] if index < 0 else int(index)
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"index {int(index)} out of range for axis 0 of size {self.shape[0]}")
        value = np.asarray(value)
        if value.shape != self.shape[1:]:
            raise ValueError(f"slice of shape {value.shape}, dataset slices are {self.shape[1:]}")
        self._put((i,) + (0,) * (self.ndim - 1), value[None])

    def _write_all(self, data):
        grid = [-(-n // c) for n, c in zip(self.shape, self.chunks)]
        for coords in np.ndindex(*grid):
            lo = [k * c for k, c in zip(coords, self.chunks)]
            part = data[tuple(slice(a, a + c) for a, c in zip(lo, self.chunks))]
            block = np.zeros(self.chunks, self.dtype)  # edge chunks at full size
            block[tuple(slice(0, n) for n in part.shape)] = part
            self._put(tuple(coords), block)


class Writer:
    """An HDF5 file being written (superblock 0, h5py's defaults): groups
    made as their paths need them, chunked deflate datasets. Nothing is
    valid until :meth:`close` writes the metadata."""

    def __init__(self, path):
        self.path = str(path)
        self._f = open(self.path, "wb")
        self._f.write(b"\0" * 96)  # the superblock, written at close
        self._tree = {}  # nested dicts of groups; leaves are datasets

    def _append(self, data: bytes) -> int:
        self._f.seek(0, os.SEEK_END)
        addr = self._f.tell()
        self._f.write(data)
        return addr

    def create_dataset(self, name, shape=None, dtype=None, data=None, chunks=None):
        """A chunked, deflated dataset at ``name`` (its groups made as
        needed): from ``data``, or of ``shape`` and ``dtype`` to be written
        a slice at a time; ``chunks`` default to one leading-axis slice
        (the whole array below three dimensions)."""
        if data is not None:
            data = np.asarray(data)
            shape = data.shape if shape is None else tuple(shape)
            dtype = data.dtype if dtype is None else dtype
            if data.shape != tuple(shape):
                raise ValueError(f"data of shape {data.shape} for a dataset of shape {shape}")
        shape, dtype = tuple(int(n) for n in shape), np.dtype(dtype).newbyteorder("<")
        if dtype.kind not in "uif" or (dtype.kind == "f" and dtype.itemsize not in _IEEE):
            raise ValueError(f"dtype {dtype}: the writer takes integers and IEEE floats")
        if not shape or 0 in shape:
            raise ValueError(f"shape {shape}: the writer takes non-empty arrays of rank >= 1")
        if chunks is None:
            chunks = (1, *shape[1:]) if len(shape) >= 3 else shape
        chunks = tuple(int(c) for c in chunks)
        if len(chunks) != len(shape) or not all(0 < c <= n for c, n in zip(chunks, shape)):
            raise ValueError(f"chunks {chunks} for shape {shape}")
        *parents, leaf = [p for p in str(name).split("/") if p]
        node = self._tree
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name}: {p} is a dataset")
        if leaf in node:
            raise ValueError(f"{name} exists")
        ds = node[leaf] = _WritableDataset(self, shape, dtype, chunks)
        if data is not None:
            ds._write_all(data)
        return ds

    # metadata, written at close

    def _object_header(self, messages) -> int:
        body = b"".join(struct.pack("<HHB3x", t, len(_pad8(m)), 0) + _pad8(m)
                        for t, m in messages)
        head = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        return self._append(head + body)

    def _chunk_btree(self, ds) -> int:
        """A version-1 B-tree of type 1 over the written chunks, as many
        levels as 64 children a node need."""
        rank = ds.ndim
        key_fmt = f"<II{rank + 1}Q"

        def key(coords, size=0):
            return struct.pack(key_fmt, size, 0, *[k * c for k, c in zip(coords, ds.chunks)], 0)

        def right(coords):
            return struct.pack(key_fmt, 0, 0, *[(k + 1) * c for k, c in zip(coords, ds.chunks)],
                               ds.dtype.itemsize)

        key_size = struct.calcsize(key_fmt)
        node_size = 24 + 2 * _CHUNK_K * 8 + (2 * _CHUNK_K + 1) * key_size
        entries = [(key(c, s), addr) for c, (addr, s) in sorted(ds.written.items())]
        if not entries:
            return UNDEFINED
        end = right(max(ds.written))
        level = 0
        while True:
            groups = [entries[i:i + 2 * _CHUNK_K] for i in range(0, len(entries), 2 * _CHUNK_K)]
            addrs = [self._append(b"\0" * node_size) for _ in groups]
            parents = []
            for j, (g, addr) in enumerate(zip(groups, addrs)):
                left = addrs[j - 1] if j else UNDEFINED
                rgt = addrs[j + 1] if j + 1 < len(addrs) else UNDEFINED
                body = b"".join(k + struct.pack("<Q", child) for k, child in g)
                last = groups[j + 1][0][0] if j + 1 < len(groups) else end
                node = b"TREE" + struct.pack("<BBHQQ", 1, level, len(g), left, rgt) + body + last
                self._f.seek(addr)
                self._f.write(node)
                parents.append((g[0][0], addr))
            if len(parents) == 1:
                return parents[0][1]
            entries, level = parents, level + 1

    def _dataset(self, ds) -> int:
        space = struct.pack(f"<BBBx4x{ds.ndim}Q{ds.ndim}Q", 1, ds.ndim, 1, *ds.shape, *ds.shape)
        fill = struct.pack("<BBBBI", 2, 3, 2, 1, 0)  # incremental allocation, as h5py
        layout = struct.pack(f"<BBBQ{ds.ndim + 1}I", 3, 2, ds.ndim + 1, self._chunk_btree(ds),
                             *ds.chunks, ds.dtype.itemsize)
        filters = struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1) + b"deflate\0" + struct.pack(
            "<I4x", DEFLATE_LEVEL)
        return self._object_header([(_DATASPACE, space), (_DATATYPE, _dtype_message(ds.dtype)),
                                    (_FILL, fill), (_LAYOUT, layout), (_FILTERS, filters)])

    def _group(self, members: dict):
        """(object header address, B-tree address, heap address) of a group
        whose members are written first."""
        names = sorted(members)
        if len(names) > 2 * _GROUP_LEAF_K * 2 * _GROUP_NODE_K:
            raise ValueError(f"a group of {len(names)} members; the writer takes at most 256")
        objs = [self._group(members[n])[0] if isinstance(members[n], dict)
                else self._dataset(members[n]) for n in names]
        heap, offsets = bytearray(8), []  # offset 0: the empty name
        for n in names:
            offsets.append(len(heap))
            heap += _pad8(n.encode() + b"\0")
        heap_data = self._append(bytes(heap))
        heap_addr = self._append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        snod_size = 8 + 2 * _GROUP_LEAF_K * 40
        leaves = []
        for i in range(0, max(len(names), 1), 2 * _GROUP_LEAF_K):
            part = list(range(i, min(i + 2 * _GROUP_LEAF_K, len(names))))
            body = b"".join(struct.pack("<QQI4x16x", offsets[k], objs[k], 0) for k in part)
            node = b"SNOD" + struct.pack("<BxH", 1, len(part)) + body
            leaves.append((self._append(node + b"\0" * (snod_size - len(node))),
                           offsets[part[-1]] if part else 0))
        node_size = 24 + 2 * _GROUP_NODE_K * 8 + (2 * _GROUP_NODE_K + 1) * 8
        used = leaves if names else []
        body = struct.pack("<Q", 0) + b"".join(struct.pack("<QQ", a, last) for a, last in used)
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(used), UNDEFINED, UNDEFINED) + body
        btree = self._append(node + b"\0" * (node_size - len(node)))
        header = self._object_header([(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))])
        return header, btree, heap_addr

    def close(self):
        if self._f.closed:
            return
        root, btree, heap = self._group(self._tree)
        self._f.seek(0, os.SEEK_END)
        eof = self._f.tell()
        sb = (SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
              + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
              + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
              + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
        self._f.seek(0)
        self._f.write(sb)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._f.close()
