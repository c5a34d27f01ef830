"""ctypes bindings for the native loader library (with a Python fallback).

Counterpart of `linevis_tpu/native.py`. The reference's loaders are C++
(`src/Loaders/*`); the hot parsing paths (.obj tokenization, whitespace
float streams) are in `native/loaders.cpp`. This module builds that source
with its own g++ call into `linevis_tpu_torch/kernels/build/` at first use
(the file name carries a digest of the source and the flags; the library is
written to a temporary name and renamed into place, so processes building it
at once never load a partial file) and loads it with ctypes. Without a compiler the
callers fall back to pure Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["available", "parse_floats", "parse_obj", "library_path"]

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SOURCE = _REPO_ROOT / "native" / "loaders.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "kernels" / "build"
# No -march=native (the JAX package's build.sh has it): a library built on
# one machine may be loaded on another that shares the checkout; the parsers
# are strtod/strtof calls either way.
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_failed = False


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("attributes", ctypes.POINTER(ctypes.c_float)),
        ("line_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("num_lines", ctypes.c_int64),
        ("total_points", ctypes.c_int64),
        ("num_attrs", ctypes.c_int64),
        ("attr_names", ctypes.c_char_p),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"liblinevis_loaders-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, str(_SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        _failed = True
        return None
    lib.lv_parse_floats.restype = ctypes.POINTER(ctypes.c_double)
    lib.lv_parse_floats.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.lv_parse_obj.restype = ctypes.POINTER(_ObjResult)
    lib.lv_parse_obj.argtypes = [ctypes.c_char_p]
    lib.lv_free.argtypes = [ctypes.c_void_p]
    lib.lv_free_obj.argtypes = [ctypes.POINTER(_ObjResult)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_floats(path: str) -> Optional[np.ndarray]:
    """All whitespace-separated numbers in a file -> float64 array
    (non-numeric tokens skipped). None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    count = ctypes.c_int64()
    ptr = lib.lv_parse_floats(path.encode(), ctypes.byref(count))
    if not ptr:
        return None
    out = np.ctypeslib.as_array(ptr, shape=(count.value,)).copy()
    lib.lv_free(ptr)
    return out


def parse_obj(path: str) -> Optional[Tuple[List[np.ndarray], List[np.ndarray], List[str]]]:
    """Native .obj line-set parse -> (positions, attributes, names) in the
    RaggedTrajectories layout. None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    r = lib.lv_parse_obj(path.encode())
    if not r:
        return None
    res = r.contents
    tp = res.total_points
    na = res.num_attrs
    pos = np.ctypeslib.as_array(res.positions, shape=(tp * 3,)).copy().reshape(tp, 3)
    att = (
        np.ctypeslib.as_array(res.attributes, shape=(tp * na,)).copy().reshape(tp, na)
        if na
        else np.zeros((tp, 0), np.float32)
    )
    offs = np.ctypeslib.as_array(res.line_offsets, shape=(res.num_lines + 1,)).copy()
    names = res.attr_names.decode().split("\n") if res.attr_names else []
    names = [n for n in names if n]
    lib.lv_free_obj(r)
    positions = [pos[offs[i]: offs[i + 1]].astype(np.float32) for i in range(len(offs) - 1)]
    attributes = [
        att[offs[i]: offs[i + 1]].T.astype(np.float32) for i in range(len(offs) - 1)
    ]
    return positions, attributes, names
