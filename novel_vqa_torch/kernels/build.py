"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source compiles to a shared library with a plain C interface (no
PyTorch headers, so the build takes seconds).  The library lands in
``build/`` at the repository root, named by a hash of the source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a stale one never loaded.  The build happens at the first
launch, never at import: importing the package needs neither nvcc nor a
card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
P, I = ctypes.c_void_p, ctypes.c_int
# The C entry points and their argument types; each returns a cudaError_t
# as an int, which nvqa_cuda_error_string (csrc/cell.cuh) names.
ENTRY_POINTS = {
    "nvqa_lstm_seq_forward": [P] * 8 + [I] * 4 + [P],
    "nvqa_lstm_seq_launch_info": [I] * 3 + [P],
    "nvqa_lstm_seq_backward": [P] * 7 + [I] * 3 + [P],
    "nvqa_lstm_seq_backward_launch_info": [I] * 3 + [P],
    "nvqa_lstm_step_forward": [P] * 8 + [I] * 3 + [P],
    "nvqa_lstm_step_launch_info": [I] * 3 + [P],
    "nvqa_lstm_seq2_forward": [P] * 12 + [I] * 4 + [P],
    "nvqa_lstm_seq2_launch_info": [I] * 3 + [P],
    "nvqa_lstm_seq2_dims": [I] * 2 + [P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless an up-to-date library exists.

    Returns (library path, the compiler's output, '' when nothing was
    built).  The library is written under a temporary name and renamed, so
    processes building at once never load a half-written file."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


def load(path) -> ctypes.CDLL:
    """Load a built library and declare the entry points it exports."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, I
    lib.nvqa_cuda_error_string.argtypes = [I]
    lib.nvqa_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    path, _ = build(source)
    return load(path)
