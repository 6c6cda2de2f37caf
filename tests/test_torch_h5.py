"""The port's own HDF5 reader/writer (``novel_vqa_torch.core.h5``) against
h5py: files h5py writes read back exactly, and files the port writes read
back exactly through h5py, for the element types and group layouts the
data and checkpoint files use."""

import h5py
import numpy as np
import pytest

from novel_vqa_torch.core.h5 import H5Reader, write_h5


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
