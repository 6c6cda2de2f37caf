"""The port's own HDF5 reader/writer (``novel_vqa_torch.core.h5``) against
h5py: files h5py writes read back exactly, and files the port writes read
back exactly through h5py, for the element types and group layouts the
data and checkpoint files use.  The streaming writer writes the bytes the
writer that laid the whole file out in memory wrote (SHA-256 digests of
its files, recorded before the change), and ``update_h5`` copies the
datasets it keeps in chunks."""

import hashlib
import tracemalloc

import h5py
import numpy as np
import pytest

from novel_vqa_torch.core.h5 import H5Reader, update_h5, write_h5


def _arrays(n_extra=0):
    rs = np.random.RandomState(0)
    arrays = {
        "images_test": rs.randn(7, 5).astype(np.float32),
        "ques_test": rs.randint(0, 100, (4, 16)).astype(np.uint32),
        "i64": np.arange(-3, 3, dtype=np.int64),
        "f64": rs.randn(2, 3, 4),
        "i32": np.array([-1, 2], np.int32),
        "f16": np.ones(3, np.float16),
        "empty": np.zeros((0, 4), np.float32),
    }
    for i in range(n_extra):  # more links than one default symbol table node
        arrays[f"z{i:02d}"] = np.full(i + 1, i, np.float32)
    return arrays


def _assert_same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_extra", [0, 20])
def test_port_writes_what_h5py_reads(tmp_path, n_extra):
    arrays = _arrays(n_extra)
    path = str(tmp_path / "port.h5")
    write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for k, v in arrays.items():
            _assert_same(f[k][()], v)
    with H5Reader(path) as r:
        for k, v in arrays.items():
            _assert_same(r[k], v)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_port_reads_what_h5py_writes(tmp_path, libver):
    # "latest": superblock 3, v2 object headers, compact link messages (at
    # most 8 links; more go to dense storage, which the port rejects)
    arrays = _arrays(20)
    if libver == "latest":
        arrays = {k: arrays[k] for k in ("images_test", "ques_test", "i64", "f16", "empty")}
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w", libver=libver) as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f.create_dataset("scalar", data=np.float32(3.5))
        f.create_dataset("big_endian", data=np.arange(5, dtype=">u4"))
    with H5Reader(path) as r:
        assert sorted(r.keys()) == sorted(list(arrays) + ["scalar", "big_endian"])
        for k, v in arrays.items():
            _assert_same(r[k], v)
        _assert_same(r["scalar"], np.array(3.5, np.float32))
        _assert_same(r["big_endian"], np.arange(5, dtype=np.uint32))
        assert "images_test" in r and "nope" not in r
        with pytest.raises(KeyError):
            r["nope"]


def test_unsupported_storage_raises(tmp_path):
    path = str(tmp_path / "chunked.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100.0), chunks=(10,))
    with H5Reader(path) as r, pytest.raises(ValueError, match="chunked"):
        r["x"]
    bad = tmp_path / "not.h5"
    bad.write_bytes(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        H5Reader(str(bad))


DTYPES = ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8")


def _digest_sets():
    """Every element type the writer takes, a scalar, an empty dataset,
    big-endian and non-contiguous inputs, nested groups, and a group of 20
    members (more than 8 raise the superblock's leaf K)."""
    rs = np.random.RandomState(5)
    dtypes = {f"x_{d}": (rs.randn(3, 5) * 10).astype(d) if d[0] == "f"
              else rs.randint(0 if d[0] == "u" else -100, 100, (3, 5)).astype(d) for d in DTYPES}
    dtypes.update({
        "scalar": np.float32(2.5),
        "empty": np.zeros((0, 4), np.float32),
        "big_endian": np.arange(6, dtype=">u4").reshape(2, 3),
        "transposed": rs.randn(4, 3).astype(np.float32).T,
    })
    groups = {
        "labels/train": rs.randint(0, 90, (7, 6)).astype(np.uint32),
        "labels/val": rs.randint(0, 90, (2, 6)).astype(np.uint32),
        "label_length/train": rs.randint(1, 7, 7).astype(np.uint32),
        "label_length/val": rs.randint(1, 7, 2).astype(np.uint32),
        "a/b/c": rs.randn(2, 2),
        "root": np.arange(4, dtype=np.int64),
    }
    wide = {f"g/m{i:02d}": np.full(i + 1, i, np.float32) for i in range(20)}
    wide["top"] = rs.randn(5).astype(np.float32)
    return {"dtypes": dtypes, "groups": groups, "wide": wide}


# the files the in-memory writer wrote for these sets
DIGESTS = {
    "dtypes": "f111e75f21c9afb9875eaa7a17298c6bbaa453353c4445a428f722947bd06240",
    "groups": "2a34417424886ff4279c4a6da9888d14b7edb707798dcabb0c710639438b8cdf",
    "wide": "fdb2e3d052b0f98bad203d7027e12da54cae74889bc435ee2e73fab470bcf2a7",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_streaming_writer_writes_the_recorded_bytes(tmp_path, name):
    arrays = _digest_sets()[name]
    path = tmp_path / f"{name}.h5"
    write_h5(str(path), arrays)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == DIGESTS[name]
    # update_h5 on the same file, replacing nothing, rewrites the same bytes
    update_h5(str(path), {})
    assert hashlib.sha256(path.read_bytes()).hexdigest() == DIGESTS[name]
    with h5py.File(path, "r") as f:
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k][()], np.atleast_1d(v))


def test_update_h5_streams_what_it_keeps(tmp_path):
    """Appending a small dataset to a 256 MB file: the traced peak (numpy
    traces its buffers) stays under 16 MB, the kept dataset reads back
    exactly and the replaced one is replaced."""
    path = str(tmp_path / "big.h5")
    rows, cols = 65536, 1024  # uint32: 256 MiB
    big = np.arange(rows * cols, dtype=np.uint32).reshape(rows, cols)
    write_h5(path, {"big": big, "small": np.zeros(3, np.float32)})
    del big
    tracemalloc.start()
    try:
        update_h5(path, {"small": np.ones(5, np.int64), "new/x": np.arange(4, dtype=np.uint8)})
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 16 << 20, f"update_h5 peaked at {peak} traced bytes"
    with H5Reader(path) as r:
        assert sorted(r.datasets()) == ["big", "new/x", "small"]
        _assert_same(r["small"], np.ones(5, np.int64))
        _assert_same(r["new/x"], np.arange(4, dtype=np.uint8))
        ds = r.dataset("big")
        assert ds.shape == (rows, cols)
        for start in range(0, rows, 8192):
            want = np.arange(start * cols, (start + 8192) * cols, dtype=np.uint32).reshape(-1, cols)
            np.testing.assert_array_equal(ds[start : start + 8192], want)


def test_update_h5_keeps_what_h5py_wrote(tmp_path):
    """A file h5py wrote and then changed in mode "a" (a dataset deleted
    and written again leaves freed space behind): update_h5 keeps its
    big-endian, scalar and grouped datasets, and h5py reads the result."""
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("big_endian", data=np.arange(5, dtype=">u4"))
        f.create_dataset("scalar", data=np.float32(3.5))
        f.create_dataset("labels/train", data=np.arange(12, dtype=np.uint32).reshape(3, 4))
        f.create_dataset("VGGOutTest", data=np.zeros((4, 3), np.float32))
    with h5py.File(path, "a") as f:
        del f["VGGOutTest"]
        f.create_dataset("VGGOutTest", data=np.ones((4, 3), np.float32))
    update_h5(path, {"InceptionOutTest": np.full((4, 3), 2, np.float32)})
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["big_endian"][()], np.arange(5))
        assert f["scalar"][()] == np.float32(3.5)
        np.testing.assert_array_equal(f["labels/train"][()], np.arange(12).reshape(3, 4))
        np.testing.assert_array_equal(f["VGGOutTest"][()], np.ones((4, 3)))
        np.testing.assert_array_equal(f["InceptionOutTest"][()], np.full((4, 3), 2))
