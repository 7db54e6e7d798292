"""The port's HDF5 codec (pda_torch/data/h5.py) against h5py on the CPU:
files h5py writes with its default settings (chunked with deflate or
shuffle + deflate, contiguous, compact, nested groups, every integer and
float width of either byte order, more chunks than one B-tree node holds,
partial edge chunks, chunks never written, chunks stored with a filter
skipped, headers continued) read by the port bit for bit, whole and by
windows; files the port writes (whole arrays and one slice at a time) read
by h5py and by ``pda``'s LazyH5Volume bit for bit; the refusals, each naming
its feature. Exact data paths: every comparison is bit-equal."""

import pickle

import h5py
import numpy as np
import pytest

from pda.data.datasets import LazyH5Volume as PdaLazy
from pda_torch.data import h5
from pda_torch.data.datasets import LazyH5Volume

DTYPES = ["u1", "u2", "u4", "u8", "i1", "i2", "i4", "i8", "f2", "f4", "f8",
          ">u2", ">u4", ">i2", ">i4", ">f4", ">f8"]
WINDOWS = [np.s_[...], np.s_[0], np.s_[-1], np.s_[1:3], np.s_[::2, 1:], np.s_[1, 2:7:3, ::4],
           np.s_[:, 3], np.s_[2:2]]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt.newbyteorder("="), endpoint=True
                        ).astype(dt)


def same(a, b):
    """Bit-equal values of one shape and (native-order) dtype."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype.newbyteorder("=") == b.dtype.newbyteorder("=")
            and np.array_equal(a.astype(a.dtype.newbyteorder("=")).view(np.uint8),
                               b.astype(b.dtype.newbyteorder("=")).view(np.uint8)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("storage", ["gzip", "shuffle", "contiguous", "compact"])
def test_reads_h5py_files(dtype, storage, tmp_path):
    a = _array(dtype, (5, 12, 17), seed=len(dtype))
    path = str(tmp_path / "a.h5")
    with h5py.File(path, "w") as f:
        if storage == "compact":
            space = h5py.h5s.create_simple(a.shape)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            dsid = h5py.h5d.create(f.create_group("g").id, b"x", h5py.h5t.py_create(a.dtype),
                                   space, dcpl=dcpl)
            dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(a))
        else:
            kw = {"contiguous": {}, "gzip": {"compression": "gzip"},
                  "shuffle": {"compression": "gzip", "shuffle": True, "chunks": (2, 5, 7)}}
            f.create_dataset("g/x", data=a, **kw[storage])
    with h5.File(path) as f:
        d = f["g/x"]
        assert d.shape == a.shape and d.dtype == a.dtype
        assert d.chunks == h5py.File(path)["g/x"].chunks
        for w in WINDOWS:
            assert same(d[w], a[w]), w


def test_groups_and_keys(tmp_path):
    """Nested paths, several symbol-table nodes (more members than one
    holds), ``keys``, a missing member."""
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w") as f:
        for k in range(20):
            f.create_dataset(f"many/m{k:02}", data=np.full((2, 3), k, "u1"))
        f.create_dataset("labels/mito", data=np.arange(6, dtype="u2").reshape(2, 3))
        f.create_dataset("labels/mitochondria", data=np.ones((4, 4), "u2"))
        f.create_dataset("raw", data=np.zeros((3, 3), "u1"))
        f.create_group("empty")
    with h5.File(path) as f:
        assert f.keys() == ["empty", "labels", "many", "raw"]
        assert f["labels"].keys() == ["mito", "mitochondria"]
        assert f["empty"].keys() == []
        assert same(f["/labels/mito"][...], np.arange(6, dtype="u2").reshape(2, 3))
        assert same(f["labels"]["mitochondria"][...], np.ones((4, 4), "u2"))
        assert all(same(f[f"many/m{k:02}"][...], np.full((2, 3), k, "u1")) for k in range(20))
        for missing in ("labels/nope", "nope"):
            with pytest.raises(KeyError):
                f[missing]


@pytest.mark.parametrize("shape,chunks", [((150, 9, 7), (1, 9, 7)), ((60, 70), (3, 4)),
                                          ((10, 11), (4, 3)), ((7, 5, 9), (3, 2, 4))])
def test_many_and_partial_chunks(shape, chunks, tmp_path):
    """More chunks than one B-tree node holds (64: the tree has levels),
    partial edge chunks, windows across chunk borders."""
    a = _array("u2", shape, seed=3)
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=a, chunks=chunks, compression="gzip")
    with h5.File(path) as f:
        d = f["x"]
        assert same(d[...], a)
        rng = np.random.default_rng(0)
        for _ in range(20):
            lo = [int(rng.integers(0, n)) for n in shape]
            hi = [int(rng.integers(l + 1, n + 1)) for l, n in zip(lo, shape)]
            st = [int(rng.integers(1, 4)) for _ in shape]
            w = tuple(slice(l, h, s) for l, h, s in zip(lo, hi, st))
            assert same(d[w], a[w]), w


@pytest.mark.parametrize("fill", [None, 7])
def test_unwritten_chunks_read_as_fill(fill, tmp_path):
    path = str(tmp_path / "u.h5")
    kw = {} if fill is None else {"fillvalue": fill}
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", shape=(9, 10), dtype="i4", chunks=(4, 3), compression="gzip",
                             **kw)
        d[0:4, 3:6] = 5
        d[8, 9] = -2
        ref = d[...]
    with h5.File(path) as f:
        assert same(f["x"][...], ref)
        assert same(f["x"][5:, :3], np.full((4, 3), fill or 0, "i4"))


def test_filter_mask_is_honoured(tmp_path):
    """Chunks of a shuffle + deflate dataset stored with shuffle, deflate or
    both skipped (their filter mask bits set) beside a filtered one."""
    import zlib

    a = _array("u2", (8, 6), seed=5)
    path = str(tmp_path / "m.h5")
    rows = [np.ascontiguousarray(a[i:i + 2]).tobytes() for i in range(0, 8, 2)]
    shuffled = [np.frombuffer(r, np.uint8).reshape(-1, 2).T.tobytes() for r in rows]
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", shape=a.shape, dtype=a.dtype, chunks=(2, 6),
                             compression="gzip", shuffle=True)
        d[0:2] = a[0:2]
        for i, (mask, raw) in enumerate(((3, rows[1]), (1, zlib.compress(rows[2])),
                                         (2, shuffled[3])), 1):
            d.id.write_direct_chunk((2 * i, 0), raw, filter_mask=mask)
    with h5py.File(path, "r") as f:
        assert same(f["x"][...], a)
    with h5.File(path) as f:
        assert same(f["x"][...], a)


def test_continued_object_header(tmp_path):
    """Attributes added after the data push the header into a continuation
    block, which the reader follows."""
    a = _array("f4", (3, 4), seed=6)
    path = str(tmp_path / "h.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=a, compression="gzip")
        for k in range(40):
            d.attrs[f"attribute_{k:02}"] = np.arange(k + 1)
        f.attrs["note"] = "x" * 200
    with h5.File(path) as f:
        assert same(f["x"][...], a)
        r = f._r
        addr = f._members()["x"]
        msgs = h5._messages(r, addr)
        assert any(m[0] == h5._CONTINUATION for m in msgs)
        head = r.read(addr, 16)
        assert len(msgs) == int.from_bytes(head[2:4], "little")


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["u1", "u2", "u4", "i4", "f4", "f8", ">u2", ">f4"])
def test_written_files_read_by_h5py(dtype, tmp_path):
    a = _array(dtype, (6, 13, 11), seed=7)
    b = _array(dtype, (19, 23), seed=8)
    path = str(tmp_path / "w.h5")
    with h5.Writer(path) as f:
        f.create_dataset("raw", data=a)
        f.create_dataset("labels/mito", data=b, chunks=(4, 5))
        d = f.create_dataset("labels/mitochondria/streamed", shape=a.shape, dtype=a.dtype,
                             chunks=(1, 13, 11))
        for i in range(len(a)):
            d[i] = a[i]
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["labels", "raw"]
        for name, want in (("raw", a), ("labels/mito", b), ("labels/mitochondria/streamed", a)):
            assert same(f[name][...], want), name
            assert f[name].compression == "gzip" and f[name].compression_opts == 4
        assert f["raw"].chunks == (1, 13, 11) and f["labels/mito"].chunks == (4, 5)
    with h5.File(path) as f:
        assert same(f["labels/mitochondria/streamed"][2:5, ::3], a[2:5, ::3])


def test_written_btree_levels_and_groups(tmp_path):
    """5,000 chunks (a three-level chunk B-tree), a group of 100 members
    (a group B-tree over several symbol-table nodes), slices written out of
    order and one never written (the fill value)."""
    a = _array("u1", (5000, 2, 3), seed=9)
    path = str(tmp_path / "big.h5")
    with h5.Writer(path) as f:
        d = f.create_dataset("raw", shape=a.shape, dtype=a.dtype, chunks=(1, 2, 3))
        for i in np.random.default_rng(0).permutation(len(a))[:-1]:
            d[int(i)] = a[i]
        missing = int(np.random.default_rng(0).permutation(len(a))[-1])
        for k in range(100):
            f.create_dataset(f"g/d{k:03}", data=np.full((1, 2), k, "u2"))
    a[missing] = 0
    with h5py.File(path, "r") as f:
        assert same(f["raw"][...], a)
        assert same(f["raw"][missing], np.zeros((2, 3), "u1"))
        assert len(f["g"]) == 100 and all(f[f"g/d{k:03}"][0, 1] == k for k in range(100))
    with h5.File(path) as f:
        assert same(f["raw"][4990:], a[4990:])


def test_written_volume_through_pda_lazy_view(tmp_path):
    """pda's LazyH5Volume (h5py) and the port's read the port's file the
    same, window by window, through a ROI; the port's view pickles."""
    a = _array("u2", (12, 40, 30), seed=10)
    path = str(tmp_path / "v.h5")
    with h5.Writer(path) as f:
        d = f.create_dataset("labels/mito", shape=a.shape, dtype=a.dtype, chunks=(1, 40, 30))
        for i in range(len(a)):
            d[i] = a[i]
    for roi in (None, slice(2, 11, 3), slice(1, None)):
        ref = PdaLazy(path, "labels/mito", roi=roi)
        port = LazyH5Volume(path, "labels/mito", roi=roi)
        assert port.shape == ref.shape and port.dtype == ref.dtype
        for w in (0, -1, slice(None), (1, slice(3, 30), slice(None, None, 2)), slice(0, 2)):
            assert same(port[w], ref[w]), (roi, w)
        copy = pickle.loads(pickle.dumps(port))
        assert same(copy[0], ref[0])
        with pytest.raises(IndexError):
            port[::-1]


def test_writer_refuses(tmp_path):
    with h5.Writer(str(tmp_path / "r.h5")) as f:
        with pytest.raises(ValueError, match="integers and IEEE floats"):
            f.create_dataset("s", data=np.array(["a"]))
        with pytest.raises(ValueError, match="integers and IEEE floats"):
            f.create_dataset("c", data=np.zeros(3, np.complex64))
        with pytest.raises(ValueError, match="chunks"):
            f.create_dataset("c", data=np.zeros((3, 3)), chunks=(4, 1))
        d = f.create_dataset("x", shape=(2, 3), dtype="u1", chunks=(2, 3))
        with pytest.raises(ValueError, match="one leading-axis slice"):
            d[0] = np.zeros(3, "u1")
        f.create_dataset("y", data=np.zeros(2))
        with pytest.raises(ValueError, match="exists"):
            f.create_dataset("y", data=np.zeros(2))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _patched(path, old: bytes, new: bytes):
    buf = open(path, "rb").read()
    assert buf.count(old) == 1
    open(path, "wb").write(buf.replace(old, new))


def test_refusals_name_their_feature(tmp_path):
    p = str(tmp_path / "latest.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros((2, 2)), chunks=(1, 2))
    with pytest.raises(ValueError, match="superblock version 3"):
        h5.File(p)

    p = str(tmp_path / "types.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("compound", data=np.zeros(3, dtype=[("a", "i4"), ("b", "f4")]))
        f.create_dataset("vlen", data=["a", "bc"], dtype=h5py.string_dtype())
        f.create_dataset("string", data=np.array([b"ab", b"cd"]))
        f.create_dataset("lzf", data=np.zeros((4, 4)), compression="lzf")
        f.create_dataset("fletcher", data=np.zeros((4, 4)), chunks=(2, 2), fletcher32=True)
        f.create_dataset("bool", data=np.zeros(3, bool))
    with h5.File(p) as f:
        for name, feature in (("compound", "class 6 (compound)"),
                              ("vlen", "class 9 (variable-length)"),
                              ("string", "class 3 (string)"), ("lzf", "filter 32000 (lzf)"),
                              ("fletcher", "filter 3 (fletcher32)"), ("bool", "class 8 (enum)")):
            with pytest.raises(ValueError, match=feature.replace("(", r"\(").replace(")", r"\)")):
                f[name]

    p = str(tmp_path / "v4.h5")
    with h5.Writer(p) as f:
        f.create_dataset("x", data=np.arange(6, dtype="u1").reshape(2, 3))
    buf = open(p, "rb").read()
    i = buf.index(bytes([3, 2, 3]))  # layout message version 3, chunked, rank + 1
    open(p, "wb").write(buf[:i] + bytes([4]) + buf[i + 1:])
    with h5.File(p) as f:
        with pytest.raises(ValueError, match="layout message version 4"):
            f["x"]

    p = str(tmp_path / "new_group.h5")
    with h5py.File(p, "w") as f:
        f.create_group("g", track_order=True).create_dataset("x", data=np.zeros(2))
    with h5.File(p) as f:
        with pytest.raises(ValueError, match="version-2 object header"):
            f["g/x"]

    # a version-1 header whose group is held in link messages: the
    # subgroup's symbol-table message (written before the root's) turned
    # into a link-info message
    p = str(tmp_path / "link_info.h5")
    with h5.Writer(p) as f:
        f.create_dataset("g/x", data=np.zeros(2))
    buf = open(p, "rb").read()
    stab = b"\x11\x00\x10\x00\x00\x00\x00\x00"
    i = buf.index(stab)
    open(p, "wb").write(buf[:i] + b"\x02" + buf[i + 1:])
    with h5.File(p) as f:
        with pytest.raises(ValueError, match="link messages"):
            f["g/x"]

    p = str(tmp_path / "not.h5")
    open(p, "wb").write(b"\0" * 5000)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5.File(p)
