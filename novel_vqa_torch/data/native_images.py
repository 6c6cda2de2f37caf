"""The port's ctypes binding to the native image decoder
(``native/imagepipe.cpp``: libjpeg/libpng decode, optional centre crop,
bilinear resize to uint8 RGB, a pthread pool for batches).

The library is built here, not by ``make``: g++ with ``native/Makefile``'s
flags into ``build/`` at the repository root, named by a hash of the source
and the flags, written under a temporary name and renamed into place, so
processes that build at once never load a half-written file and an edited
source is rebuilt.  The build happens at the first decode (or the first
``available()``), never at import, and at most once per process.  Where it
cannot build (no g++, no ``jpeglib.h`` or ``png.h``), ``available()`` is
False and ``unavailable_reason()`` says why; ``DecodePool`` then decodes
with PIL.

Decode errors count as missing files (the reference substitutes its
mean image for unreadable inputs, 001_prepro_img_vgg.lua:47-57).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "imagepipe.cpp"
BUILD_DIR = ROOT / "build"
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-Wall", "-std=c++17")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

_P, _I = ctypes.c_char_p, ctypes.c_int
_U8P, _IP = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
# the entry points of the C ABI (imagepipe.cpp:323-354) that the port
# calls; each returns an int
ENTRY_POINTS = {
    "imagepipe_decode_resize": [_P, _I, _I, _U8P],
    "imagepipe_decode_batch2": [ctypes.POINTER(_P), _I, _I, _I, _I, _I, _U8P, _IP],
}

_lock = threading.Lock()
_state: dict = {}  # "lib" and "reason" once the first load has run


class NativeDecoderUnavailable(RuntimeError):
    pass


def build(build_dir: Path | None = None) -> Path:
    """Compile ``native/imagepipe.cpp`` unless an up-to-date library is in
    ``build_dir`` (default ``build/``); returns its path.  Raises
    ``NativeDecoderUnavailable`` naming what is missing."""
    build_dir = Path(build_dir or BUILD_DIR)
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeDecoderUnavailable("no C++ compiler: g++ is not on PATH")
    flags = (*CXXFLAGS, "-shared", *LDLIBS)
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = build_dir / f"libimagepipe-{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXXFLAGS, "-shared", "-o", tmp, str(SOURCE), *LDLIBS],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            missing = [h for h in ("jpeglib.h", "png.h") if h in proc.stderr]
            what = (f"{' and '.join(missing)} not found (libjpeg/libpng headers)" if missing
                    else proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else "")
            raise NativeDecoderUnavailable(f"g++ failed on {SOURCE.name} (rc {proc.returncode}): {what}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    return lib


def library() -> ctypes.CDLL:
    """The loaded decoder, built on the first call of the process; raises
    ``NativeDecoderUnavailable`` (every call) when it cannot be had."""
    with _lock:
        if not _state:
            try:
                _state["lib"] = _load(build())
            except (NativeDecoderUnavailable, OSError) as err:
                _state["reason"] = str(err)
        if "lib" not in _state:
            raise NativeDecoderUnavailable(_state["reason"])
        return _state["lib"]


def available() -> bool:
    try:
        library()
    except NativeDecoderUnavailable:
        return False
    return True


def unavailable_reason() -> str:
    """Why the decoder could not be had ('' when it was, or when no build
    has been tried yet)."""
    return _state.get("reason", "")


def decode_resize_native(
    path: str, size: int, center_crop_square: bool = False
) -> Tuple[np.ndarray, bool]:
    """One image -> ((size, size, 3) uint8 RGB, missing), as
    ``data.images.decode_resize``."""
    out = np.empty((size, size, 3), np.uint8)
    rc = library().imagepipe_decode_resize(
        path.encode(), size, int(center_crop_square), out.ctypes.data_as(_U8P)
    )
    if rc != 0:
        return np.zeros((size, size, 3), np.uint8), True
    return out, False


def decode_batch_native(
    paths: List[str], size: int, center_crop_square: bool = False, n_threads: int = 8,
    fast_scale: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode -> (uint8 (N, size, size, 3), missing mask).
    ``fast_scale`` decodes JPEGs DCT-downscaled (pixels off by a few
    intensity levels)."""
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.empty((n,), np.int32)
    names = (_P * n)(*[p.encode() for p in paths])
    library().imagepipe_decode_batch2(
        names, n, size, int(center_crop_square), int(fast_scale), n_threads,
        out.ctypes.data_as(_U8P), status.ctypes.data_as(_IP),
    )
    missing = status != 0
    out[missing] = 0
    return out, missing
