"""The ctypes declarations of the port's C entry points against their sources.

ctypes passes an argument without a declared type as a C int, which cuts a
64-bit device pointer to 32 bits; no CPU test would see that.  So each
``extern "C"`` function in ``novel_vqa_torch/csrc`` is parsed here, and its
parameters are held to ``kernels/build.ENTRY_POINTS``: ``c_void_p`` for a
pointer or a stream, ``c_int`` for an int.
"""

import ctypes
import re

import pytest

from novel_vqa_torch.kernels import build

# declared by build.load itself, with its own return type
ERROR_STRING = "nvqa_cuda_error_string"
C_TYPES = {"pointer": ctypes.c_void_p, "int": ctypes.c_int}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _extern_c_regions(text: str):
    """The text of each ``extern "C" { ... }`` block and each single
    ``extern "C"`` definition."""
    for m in re.finditer(r'extern\s+"C"\s*', text):
        start = m.end()
        if text[start] != "{":
            yield text[start:text.index("{", start) + 1]
            continue
        depth = 0
        for i in range(start, len(text)):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                yield text[start + 1:i]
                break


def _param_kind(param: str) -> str:
    param = param.strip()
    if "*" in param:
        return "pointer"
    if re.fullmatch(r"(const\s+)?int\s+\w+", param):
        return "int"
    raise AssertionError(f"parameter {param!r}: neither a pointer nor an int")


def exported_functions():
    """{name: [parameter kind, ...]} of every extern "C" function defined in
    csrc/*.cu and csrc/*.cuh (definitions start at column 0)."""
    found = {}
    for path in sorted(build.CSRC.glob("*.cu")) + sorted(build.CSRC.glob("*.cuh")):
        for region in _extern_c_regions(_strip_comments(path.read_text())):
            for m in re.finditer(r"^[A-Za-z_][^;{}()]*?\b(\w+)\s*\(([^()]*)\)\s*\{", region, re.M):
                name, params = m.group(1), m.group(2).strip()
                kinds = [] if params in ("", "void") else [_param_kind(p) for p in params.split(",")]
                assert found.setdefault(name, kinds) == kinds, f"{name} defined twice, differently"
    return found


EXPORTED = exported_functions()


def test_sources_export_every_declared_entry_point():
    assert ERROR_STRING in EXPORTED
    assert set(EXPORTED) - {ERROR_STRING} == set(build.ENTRY_POINTS)
    assert all(name.startswith("nvqa_") for name in EXPORTED)


@pytest.mark.parametrize("name", sorted(build.ENTRY_POINTS))
def test_entry_point_argtypes_match_the_source(name):
    declared = build.ENTRY_POINTS[name]
    wanted = [C_TYPES[k] for k in EXPORTED[name]]
    assert len(declared) == len(wanted), f"{name}: {len(declared)} argtypes for {len(wanted)} parameters"
    assert declared == wanted


def test_load_declares_every_entry_point(monkeypatch):
    """``build.load`` sets each function's argtypes from the table and its
    return type to int; the error string takes an int and returns bytes."""

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self, path):
            for name in EXPORTED:
                setattr(self, name, Fn())

    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    lib = build.load("libfake.so")
    for name, kinds in EXPORTED.items():
        fn = getattr(lib, name)
        if name == ERROR_STRING:
            assert (fn.argtypes, fn.restype) == ([ctypes.c_int], ctypes.c_char_p)
        else:
            assert fn.argtypes == [C_TYPES[k] for k in kinds]
            assert fn.restype is ctypes.c_int
