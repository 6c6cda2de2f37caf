"""A small HDF5 reader and writer for files of plain arrays, numpy only.

The port's data files (``data_prepro.h5``, ``data_img.h5``, the corpus
``data.h5`` with its ``labels/{train,val,test}`` groups) and flat
checkpoints (``lstm.h5``) are HDF5 files holding numeric datasets in the
root group or in groups below it.  The machine with the card has no h5py
and no libhdf5, so the port reads and writes that subset of the format
itself:

* reading: superblock versions 0-3; object headers versions 1 and 2 with
  continuation blocks; groups as a symbol table (B-tree v1, local heap) or
  as compact link messages, at any depth (``reader["labels/train"]``);
  datasets of fixed-point or floating-point elements in contiguous or
  compact layout, whole or as a window of rows (``reader.dataset(name)[a:b]``
  copies only those rows).  Anything else (chunked or compressed storage,
  dense link storage, other element types) raises ``ValueError``.
* writing: superblock version 0, symbol-table groups and one contiguous
  dataset per array, the layout h5py itself writes by default, so h5py and
  the JAX package read these files too; a key ``"a/b"`` is dataset ``b`` of
  group ``a``.  The metadata is laid out first from each dataset's shape
  and type, then each dataset's bytes are written at their offset in
  chunks, so no copy of the file is held in memory.  :func:`update_h5` adds
  or replaces datasets of an existing file (h5py's mode ``"a"``) by writing
  the file anew, copying the datasets it keeps from the old file in chunks.

Spec: the HDF5 File Format Specification, version 3.0.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

_MSG_DATASPACE, _MSG_LINK, _MSG_DATATYPE, _MSG_LAYOUT = 0x01, 0x06, 0x03, 0x08
_MSG_FILL, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x05, 0x10, 0x11
_MSG_LINK_INFO = 0x02


def _u(buf: bytes, off: int, size: int) -> int:
    return int.from_bytes(buf[off : off + size], "little")


class H5Reader:
    """Read-only view of a file's datasets: the metadata memory-mapped, the
    data read with ``os.preadv`` straight into the arrays it returns (so
    reading a window of rows maps no page of the rest into the process).

    ``keys()`` (the root group's members), ``name in reader`` and
    ``reader[name]`` (a numpy array, copied out on demand; ``name`` may be
    a path ``"group/dataset"``) mirror the slice of h5py's ``File`` API the
    port uses; ``dataset(name)`` is a view whose row slices copy only those
    rows, and ``datasets()`` lists every dataset's path.  Use it in a
    ``with`` block, which closes the mapping."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._buf = mmap.mmap(self._fd, 0, access=mmap.ACCESS_READ)
        except BaseException:
            os.close(self._fd)
            raise
        try:
            self._open()
        except BaseException:
            self.close()
            raise

    def _open(self) -> None:
        buf, path = self._buf, self.path
        if buf[:8] != SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file")
        version = buf[8]
        if version in (0, 1):
            self._so, self._sl = buf[13], buf[14]
            off = 24 + (4 if version == 1 else 0)
            self._base = _u(buf, off, self._so)
            entry = off + 4 * self._so
            root = _u(buf, entry + self._so, self._so)
        elif version in (2, 3):
            self._so, self._sl = buf[9], buf[10]
            self._base = _u(buf, 12, self._so)
            root = _u(buf, 12 + 3 * self._so, self._so)
        else:
            raise ValueError(f"{path}: unsupported superblock version {version}")
        if self._so != 8 or self._sl != 8:
            raise ValueError(f"{path}: only 8-byte offsets and lengths are supported")
        self._groups: Dict[int, Dict[str, int]] = {}
        self._links = self._group(root)

    # -- low level ---------------------------------------------------------

    def _addr(self, a: int) -> int:
        return self._base + a

    def _messages(self, addr: int) -> Iterator[Tuple[int, bytes]]:
        """(type, body) of every message of the object header at ``addr``."""
        buf = self._buf
        a = self._addr(addr)
        blocks: List[Tuple[int, int, int]] = []  # (start, end, header version)
        if buf[a : a + 4] == b"OHDR":
            flags = buf[a + 5]
            p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x03)
            size = _u(buf, p, width)
            p += width
            blocks.append((p, p + size, 2))
            creation_order = bool(flags & 0x04)
        elif buf[a] == 1:
            size = _u(buf, a + 8, 4)
            blocks.append((a + 16, a + 16 + size, 1))
            creation_order = False
        else:
            raise ValueError(f"{self.path}: unknown object header at {addr}")
        while blocks:
            p, end, hv = blocks.pop(0)
            while p < end:
                if hv == 1:
                    if p + 8 > end:
                        break
                    mtype, msize = _u(buf, p, 2), _u(buf, p + 2, 2)
                    p += 8
                else:
                    if p + 4 > end:
                        break  # gap at the end of a v2 chunk
                    mtype, msize = buf[p], _u(buf, p + 1, 2)
                    p += 4 + (2 if creation_order else 0)
                body = buf[p : p + msize]
                p += msize
                if mtype == _MSG_CONTINUATION:
                    c_addr, c_len = _u(body, 0, 8), _u(body, 8, 8)
                    c = self._addr(c_addr)
                    if hv == 2:  # "OCHK" signature ... checksum
                        blocks.append((c + 4, c + c_len - 4, 2))
                    else:
                        blocks.append((c, c + c_len, 1))
                else:
                    yield mtype, body

    def _group_links(self, addr: int) -> Iterator[Tuple[str, int]]:
        for mtype, body in self._messages(addr):
            if mtype == _MSG_SYMBOL_TABLE:
                yield from self._symbol_table(_u(body, 0, 8), _u(body, 8, 8))
            elif mtype == _MSG_LINK:
                link = self._link(body)
                if link is not None:
                    yield link
            elif mtype == _MSG_LINK_INFO and _u(body, 2 + (8 if body[1] & 1 else 0), 8) != UNDEF:
                raise ValueError(f"{self.path}: dense link storage is not supported")

    def _link(self, body: bytes):
        flags = body[1]
        p = 2
        link_type = 0
        if flags & 0x08:
            link_type = body[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 0x03)
        n = _u(body, p, width)
        p += width
        name = body[p : p + n].decode()
        p += n
        return (name, _u(body, p, 8)) if link_type == 0 else None

    def _symbol_table(self, btree: int, heap: int) -> Iterator[Tuple[str, int]]:
        buf = self._buf
        h = self._addr(heap)
        if buf[h : h + 4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap")
        data = self._addr(_u(buf, h + 24, 8))

        def name_at(off: int) -> str:
            s = data + off
            return buf[s : buf.find(b"\0", s)].decode()

        def walk(node: int) -> Iterator[Tuple[str, int]]:
            a = self._addr(node)
            if buf[a : a + 4] == b"TREE":
                for i in range(_u(buf, a + 6, 2)):  # children sit between keys
                    yield from walk(_u(buf, a + 32 + 16 * i, 8))
            elif buf[a : a + 4] == b"SNOD":
                for i in range(_u(buf, a + 6, 2)):
                    e = a + 8 + 40 * i
                    yield name_at(_u(buf, e, 8)), _u(buf, e + 8, 8)
            else:
                raise ValueError(f"{self.path}: bad group B-tree node")

        yield from walk(btree)

    def _group(self, addr: int) -> Dict[str, int]:
        if addr not in self._groups:
            self._groups[addr] = dict(self._group_links(addr))
        return self._groups[addr]

    def _find(self, name: str) -> int:
        """The object header address of the path ``name``."""
        links, addr = self._links, None
        for part in name.strip("/").split("/"):
            if links is None or part not in links:
                raise KeyError(f"{self.path}: no dataset {name!r}")
            addr = links[part]
            links = None if self._has_layout(addr) else self._group(addr)
        return addr

    def _has_layout(self, addr: int) -> bool:
        return any(mtype == _MSG_LAYOUT for mtype, _ in self._messages(addr))

    # -- datasets ----------------------------------------------------------

    def keys(self) -> List[str]:
        return list(self._links)

    def __contains__(self, name: str) -> bool:
        try:
            self._find(name)
        except KeyError:
            return False
        return True

    def datasets(self) -> List[str]:
        """The path of every dataset in the file, groups walked depth first."""
        out: List[str] = []

        def walk(links: Dict[str, int], prefix: str) -> None:
            for name, addr in links.items():
                if self._has_layout(addr):
                    out.append(prefix + name)
                else:
                    walk(self._group(addr), prefix + name + "/")

        walk(self._links, "")
        return out

    def dataset(self, name: str) -> "H5Dataset":
        shape = dtype = layout = None
        for mtype, body in self._messages(self._find(name)):
            if mtype == _MSG_DATASPACE:
                shape = _dataspace(body)
            elif mtype == _MSG_DATATYPE:
                dtype = _datatype(body)
            elif mtype == _MSG_LAYOUT:
                layout = body
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        if layout[0] not in (3, 4):
            raise ValueError(f"{self.path}: {name!r}: layout version {layout[0]} unsupported")
        if layout[1] == 0:  # compact
            source = layout[4 : 4 + _u(layout, 2, 2)]
            offset = 0
        elif layout[1] == 1:  # contiguous
            addr = _u(layout, 2, 8)
            # never written: the fill value, zero
            source, offset = (None, 0) if addr == UNDEF else (self._fd, self._addr(addr))
        else:
            raise ValueError(f"{self.path}: {name!r}: chunked storage is not supported")
        return H5Dataset(shape, dtype, source, offset)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.dataset(name).read()

    def close(self) -> None:
        if self._fd >= 0:
            self._buf.close()
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class H5Dataset:
    """One dataset of an open :class:`H5Reader`: ``shape``, ``dtype``,
    ``read()`` for the whole array and ``view[start:stop]`` for a window of
    rows along the first axis, each an array in native byte order that owns
    its memory past the reader's close."""

    def __init__(self, shape, dtype: np.dtype, source, offset: int):
        # source: the file descriptor of contiguous data, the bytes of a
        # compact dataset, or None for data never written (zeros)
        self.shape, self.dtype = tuple(shape), dtype
        self._source, self._offset = source, offset
        self._row = int(np.prod(self.shape[1:], dtype=np.int64))

    def _rows(self, start: int, stop: int) -> np.ndarray:
        shape = (stop - start,) + self.shape[1:]
        native = self.dtype.newbyteorder("=")
        if self._source is None:
            return np.zeros(shape, native)
        offset = self._offset + start * self._row * self.dtype.itemsize
        if not isinstance(self._source, int):
            arr = np.frombuffer(self._source, self.dtype, (stop - start) * self._row, offset)
            return arr.reshape(shape).astype(native)
        arr = np.empty(shape, self.dtype)
        view = memoryview(arr.reshape(-1).view(np.uint8))
        done = 0
        while done < len(view):
            n = os.preadv(self._source, [view[done:]], offset + done)
            if n <= 0:
                raise ValueError(f"dataset data past the end of the file (offset {offset + done})")
            done += n
        return arr.astype(native, copy=False)  # a copy only to swap bytes

    def read(self) -> np.ndarray:
        if not self.shape:
            return self._rows(0, 1).reshape(())
        return self._rows(0, self.shape[0])

    def __getitem__(self, key: slice) -> np.ndarray:
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("an H5Dataset takes a slice of rows, step 1")
        start, stop, _ = key.indices(self.shape[0])
        return self._rows(start, max(start, stop))


def _dataspace(body: bytes) -> Tuple[int, ...]:
    version, ndims = body[0], body[1]
    if version == 1:
        p = 8
    elif version == 2:
        if body[3] == 2:  # null dataspace
            return (0,)
        p = 4
    else:
        raise ValueError(f"dataspace version {version} unsupported")
    return tuple(_u(body, p + 8 * i, 8) for i in range(ndims))


def _datatype(body: bytes) -> np.dtype:
    cls = body[0] & 0x0F
    bits = body[1]
    size = _u(body, 4, 4)
    order = ">" if bits & 0x01 else "<"
    if cls == 0:  # fixed-point
        kind = "i" if bits & 0x08 else "u"
    elif cls == 1:  # floating-point
        kind = "f"
    else:
        raise ValueError(f"datatype class {cls} unsupported")
    return np.dtype(f"{order}{kind}{size}")


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message_v1(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = 0x08 if dtype.kind == "i" else 0x00  # bit 3: signed
        return struct.pack("<B3BI", 0x10, bits, 0, 0, size) + struct.pack("<HH", 0, 8 * size)
    if dtype.kind == "f":
        exp, man, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[size]
        # 0x20: the mantissa's leading 1 is implied; then the sign bit's place
        return struct.pack("<B3BI", 0x11, 0x20, 8 * size - 1, 0, size) + struct.pack(
            "<HHBBBBI", 0, 8 * size, man, exp, 0, man, bias
        )
    raise ValueError(f"dtype {dtype} cannot be written")


def _dataset_messages(shape: Tuple[int, ...], dtype: np.dtype, nbytes: int, data_addr: int) -> bytes:
    return (
        _message_v1(_MSG_DATASPACE, struct.pack("<BBBx4x", 1, len(shape), 0)
                    + b"".join(struct.pack("<Q", d) for d in shape))
        + _message_v1(_MSG_DATATYPE, _datatype_message(dtype))
        # fill value v2 as h5py writes it: late allocation, written if set
        + _message_v1(_MSG_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0))
        + _message_v1(_MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, nbytes))
    )


_CHUNK = 4 << 20  # bytes of a dataset's data written at a time


def _tree(arrays: Dict[str, np.ndarray]) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``: each array contiguous and
    little-endian (copied only where it is not), each :class:`H5Dataset`
    of at least one axis left in its file, to be copied in chunks."""
    root: dict = {}
    for key, value in arrays.items():
        parts = key.strip("/").split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"{key}: {part!r} is a dataset, not a group")
        if parts[-1] in node:
            raise ValueError(f"{key}: written twice, or a group of that name exists")
        if isinstance(value, H5Dataset) and value.shape:
            node[parts[-1]] = value
            continue
        a = np.ascontiguousarray(value.read() if isinstance(value, H5Dataset) else value)
        if a.dtype.kind not in "iuf":
            raise ValueError(f"{key}: dtype {a.dtype} cannot be written")
        node[parts[-1]] = a.astype(a.dtype.newbyteorder("<"), copy=False)
    return root


def _layout(x) -> Tuple[Tuple[int, ...], np.dtype, int]:
    """Shape, little-endian element type and size in bytes of an array or
    an :class:`H5Dataset`."""
    if isinstance(x, H5Dataset):
        dtype = x.dtype.newbyteorder("<")
        return x.shape, dtype, x.shape[0] * x._row * dtype.itemsize
    return x.shape, x.dtype, x.nbytes


def _write_data(f, x) -> None:
    """Write the data of ``x`` at the file's position, ``_CHUNK`` bytes at
    a time (an array's own memory; a dataset's rows read a window at a
    time)."""
    if isinstance(x, H5Dataset):
        step = max(1, _CHUNK // max(1, x._row * x.dtype.itemsize))
        for start in range(0, x.shape[0], step):
            rows = x[start : start + step]
            f.write(memoryview(rows.astype(rows.dtype.newbyteorder("<"), copy=False).reshape(-1).view(np.uint8)))
        return
    view = memoryview(x.reshape(-1).view(np.uint8))
    for start in range(0, len(view), _CHUNK):
        f.write(view[start : start + _CHUNK])


def _max_members(node: dict) -> int:
    return max([len(node)] + [_max_members(v) for v in node.values() if isinstance(v, dict)])


def write_h5(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``arrays`` as contiguous datasets of a new HDF5 file at
    ``path`` (superblock 0, symbol-table groups); a key ``"a/b"`` is
    dataset ``b`` of group ``a``.  A value may also be an
    :class:`H5Dataset` of another open file, whose rows are copied in
    chunks.  The metadata is laid out first; then every piece is written
    at its offset in address order, each dataset in chunks, so the file
    is never held in memory."""
    root = _tree(arrays)
    # one symbol table node per group, holding up to 2K links (K is a
    # file-wide value of the superblock)
    leaf_k = max(4, -(-_max_members(root) // 2))
    internal_k = 16
    end = 96  # the superblock, written last
    pieces: List[Tuple[int, object]] = []  # (address, metadata bytes or a dataset's data)

    def alloc(n: int) -> int:
        nonlocal end
        addr = end
        end += n + (-n % 8)
        return addr

    def put(addr: int, b) -> None:
        pieces.append((addr, b))

    def group(node: dict) -> Tuple[int, int, int]:
        """Lay out one group and, below it, its members: returns the
        addresses of its object header, B-tree and local heap."""
        names = sorted(node, key=str.encode)  # a symbol table node is sorted
        # local heap: offset 0 holds the empty name, the B-tree's first key
        heap_data = b"\0" * 8
        name_off = []
        for n in names:
            name_off.append(len(heap_data))
            heap_data += _pad8(n.encode() + b"\0")
        ohdr = alloc(40)
        heap = alloc(32)
        heap_seg = alloc(len(heap_data))
        btree = alloc(24 + (4 * internal_k + 1) * 8)
        snod = alloc(8 + 2 * leaf_k * 40)
        entries = []
        for n in names:
            member = node[n]
            if isinstance(member, dict):
                m_ohdr, m_btree, m_heap = group(member)
                # cache type 1: the member group's B-tree and heap
                entries.append(struct.pack("<QI4xQQ", m_ohdr, 1, m_btree, m_heap))
            else:
                shape, dtype, nbytes = _layout(member)
                m_ohdr = alloc(16 + len(_dataset_messages(shape, dtype, nbytes, 0)))
                data = alloc(nbytes) if nbytes else UNDEF  # empty: no storage
                msgs = _dataset_messages(shape, dtype, nbytes, data)
                put(m_ohdr, struct.pack("<BBHII4x", 1, 0, 4, 1, len(msgs)) + msgs)
                if nbytes:
                    put(data, member)
                entries.append(struct.pack("<QI4x16x", m_ohdr, 0))
        put(ohdr, struct.pack("<BBHII4x", 1, 0, 1, 1, 24)
            + _message_v1(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap)))
        # free-list head 1 = no free block (H5HL_FREE_NULL)
        put(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_seg))
        put(heap_seg, heap_data)
        tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0, UNDEF, UNDEF)
        if names:  # one leaf: key "" | the symbol table node | key = last name
            tree += struct.pack("<QQQ", 0, snod, name_off[-1])
        put(btree, tree)
        node_b = b"SNOD" + struct.pack("<BxH", 1, len(names))
        for off, entry in zip(name_off, entries):
            node_b += struct.pack("<Q", off) + entry
        put(snod, node_b)
        return ohdr, btree, heap

    root_ohdr, root_btree, root_heap = group(root)  # right after the superblock
    put(0, SIGNATURE
        + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
        + struct.pack("<HHI", leaf_k, internal_k, 0)
        + struct.pack("<QQQQ", 0, UNDEF, end, UNDEF)
        # root symbol table entry, cache type 1: the B-tree and heap
        + struct.pack("<QQI4xQQ", 0, root_ohdr, 1, root_btree, root_heap))
    with open(path, "wb") as f:
        for addr, piece in sorted(pieces, key=lambda p: p[0]):
            f.seek(addr)
            if isinstance(piece, bytes):
                f.write(piece)
            else:
                _write_data(f, piece)
        f.truncate(end)  # the padding after the last piece reads as zeros


def update_h5(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Add ``arrays`` to the HDF5 file at ``path``, replacing datasets of
    the same name and keeping every other one (h5py's mode ``"a"``): the
    file is written anew under a temporary name, the kept datasets copied
    from the old file in chunks, and renamed over the old one.  A missing
    file is created; one this module cannot read raises ``ValueError``."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        if os.path.exists(path):
            with H5Reader(path) as f:
                merged = {name: f.dataset(name) for name in f.datasets() if name not in arrays}
                merged.update(arrays)
                write_h5(tmp, merged)
        else:
            write_h5(tmp, arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
