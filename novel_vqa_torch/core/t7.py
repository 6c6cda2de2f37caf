"""Torch7 ``.t7`` binary serialization: reader and writer (the port's own
copy of ``novel_vqa_tpu.core.t7``, numpy only).

The reference persists every checkpoint with ``torch.save`` (binary mode):
flat-parameter dumps ``{encoder_w_q, embedding_w_q, multimodal_w}``
(002_train_vqa_arch1/002_train_baseline.lua:419-420), converted AE transfer
dumps (001_train_autoencoder/002_convert_text_model_arch1.lua:34-39), rich
``{protos, vocab, opt}`` checkpoints, and the Inception t7 net.  This module
implements the Torch7 binary wire format so those artifacts convert to/from
the port's formats without a Torch7 installation:

  object   := int32 typecode, payload
  NUMBER(1)   double
  STRING(2)   int32 len, bytes
  TABLE(3)    int32 memo-index, int32 count, count * (key obj, value obj)
  TORCH(4)    int32 memo-index, STRING version ("V <n>") , STRING classname,
              class payload
  BOOLEAN(5)  int32
  tensors:    int32 ndim, int64 sizes[ndim], int64 strides[ndim],
              int64 storageOffset (1-indexed), TORCH storage
  storages:   int64 size, raw elements

nn.* / custom classes deserialize to :class:`TorchObject` (classname + the
attribute table), which the import tools traverse (train/import_t7.py).
Memoized objects (shared storages / repeated tables) are resolved through the
index map exactly as Torch does.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_TENSOR_DTYPES = {
    "torch.FloatTensor": np.float32,
    "torch.DoubleTensor": np.float64,
    "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16,
    "torch.CharTensor": np.int8,
    "torch.ByteTensor": np.uint8,
    "torch.CudaTensor": np.float32,
}
_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.LongStorage": np.int64,
    "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16,
    "torch.CharStorage": np.int8,
    "torch.ByteStorage": np.uint8,
    "torch.CudaStorage": np.float32,
}
_TENSOR_TO_STORAGE = {
    k: k.replace("Tensor", "Storage") for k in _TENSOR_DTYPES
}


@dataclass
class TorchObject:
    torch_typename: str
    attrs: Dict[Any, Any] = field(default_factory=dict)

    def __getitem__(self, key):
        return self.attrs[key]

    def get(self, key, default=None):
        return self.attrs.get(key, default)

    def __contains__(self, key):
        return key in self.attrs


class T7Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        data = self.f.read(size)
        if len(data) != size:
            raise EOFError("truncated t7 file")
        return struct.unpack(fmt, data)[0]

    def _read_int(self) -> int:
        return self._read("<i")

    def _read_long(self) -> int:
        return self._read("<q")

    def _read_string(self) -> str:
        n = self._read_int()
        return self.f.read(n).decode("utf-8", errors="replace")

    def read_object(self) -> Any:
        typecode = self._read_int()
        if typecode == TYPE_NIL:
            return None
        if typecode == TYPE_NUMBER:
            v = self._read("<d")
            return int(v) if float(v).is_integer() and abs(v) < 2**53 else v
        if typecode == TYPE_STRING:
            return self._read_string()
        if typecode == TYPE_BOOLEAN:
            return bool(self._read_int())
        if typecode in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
            index = self._read_int()
            if index in self.memo:
                return self.memo[index]
            size = self._read_int()
            self.f.read(size)  # dumped bytecode, discarded
            upvalues = self.read_object()
            fn = ("<function>", upvalues)
            self.memo[index] = fn
            return fn
        if typecode == TYPE_TABLE:
            index = self._read_int()
            if index in self.memo:
                return self.memo[index]
            count = self._read_int()
            table: Dict[Any, Any] = {}
            self.memo[index] = table
            for _ in range(count):
                k = self.read_object()
                v = self.read_object()
                table[k] = v
            return self._maybe_listify(table)
        if typecode == TYPE_TORCH:
            index = self._read_int()
            if index in self.memo:
                return self.memo[index]
            version = self._read_string()
            if version.startswith("V "):
                class_name = self._read_string()
            else:
                class_name = version  # pre-versioning files
            obj = self._read_torch_class(class_name, index)
            return obj
        raise ValueError(f"unknown t7 typecode {typecode}")

    def _maybe_listify(self, table: Dict[Any, Any]):
        """Torch tables with contiguous 1..n int keys are Lua arrays."""
        n = len(table)
        if n > 0 and all(isinstance(k, int) for k in table) and set(table) == set(
            range(1, n + 1)
        ):
            return [table[i] for i in range(1, n + 1)]
        return table

    def _read_torch_class(self, class_name: str, index: int):
        if class_name in _TENSOR_DTYPES:
            ndim = self._read_int()
            sizes = [self._read_long() for _ in range(ndim)]
            strides = [self._read_long() for _ in range(ndim)]
            offset = self._read_long() - 1  # 1-indexed
            storage = self.read_object()
            if storage is None:
                arr = np.empty(sizes, _TENSOR_DTYPES[class_name])
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=sizes,
                    strides=[s * storage.itemsize for s in strides],
                ).copy()
            self.memo[index] = arr
            return arr
        if class_name in _STORAGE_DTYPES:
            size = self._read_long()
            dtype = np.dtype(_STORAGE_DTYPES[class_name])
            data = np.frombuffer(
                self.f.read(size * dtype.itemsize), dtype=dtype
            ).copy()
            self.memo[index] = data
            return data
        # generic torch class (nn modules, nngraph nodes, ...)
        obj = TorchObject(class_name)
        self.memo[index] = obj
        attrs = self.read_object()
        if isinstance(attrs, dict):
            obj.attrs = attrs
        elif isinstance(attrs, list):
            obj.attrs = {i + 1: v for i, v in enumerate(attrs)}
        return obj


class T7Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_index = 1
        self.memo: Dict[int, int] = {}  # id(obj) -> index

    def _write(self, fmt: str, v):
        self.f.write(struct.pack(fmt, v))

    def _write_string(self, s: str):
        data = s.encode()
        self._write("<i", len(data))
        self.f.write(data)

    def write_object(self, obj: Any):
        if obj is None:
            self._write("<i", TYPE_NIL)
        elif isinstance(obj, bool):
            self._write("<i", TYPE_BOOLEAN)
            self._write("<i", int(obj))
        elif isinstance(obj, (int, float)):
            self._write("<i", TYPE_NUMBER)
            self._write("<d", float(obj))
        elif isinstance(obj, str):
            self._write("<i", TYPE_STRING)
            self._write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, (dict, list, tuple)):
            self._write("<i", TYPE_TABLE)
            key = id(obj)
            if key in self.memo:
                self._write("<i", self.memo[key])
                return
            index = self.next_index
            self.next_index += 1
            self.memo[key] = index
            self._write("<i", index)
            if isinstance(obj, dict):
                items = list(obj.items())
            else:
                items = [(i + 1, v) for i, v in enumerate(obj)]
            self._write("<i", len(items))
            for k, v in items:
                self.write_object(k)
                self.write_object(v)
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    _NP_TO_TENSOR = {
        np.dtype(np.float32): "torch.FloatTensor",
        np.dtype(np.float64): "torch.DoubleTensor",
        np.dtype(np.int64): "torch.LongTensor",
        np.dtype(np.int32): "torch.IntTensor",
        np.dtype(np.uint8): "torch.ByteTensor",
    }

    def _write_torch_header(self, class_name: str) -> int:
        self._write("<i", TYPE_TORCH)
        index = self.next_index
        self.next_index += 1
        self._write("<i", index)
        self._write_string("V 1")
        self._write_string(class_name)
        return index

    def _write_tensor(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        tname = self._NP_TO_TENSOR[arr.dtype]
        self._write_torch_header(tname)
        self._write("<i", arr.ndim)
        for s in arr.shape:
            self._write("<q", s)
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self._write("<q", s)
        self._write("<q", 1)  # storageOffset (1-indexed)
        self._write_torch_header(_TENSOR_TO_STORAGE[tname])
        self._write("<q", arr.size)
        self.f.write(arr.tobytes())


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return T7Reader(f).read_object()


def save(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        T7Writer(f).write_object(obj)
