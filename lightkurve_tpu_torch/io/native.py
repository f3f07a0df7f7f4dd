"""ctypes bindings for the C++ bulk FITS column reader.

Counterpart of ``lightkurve_tpu/io/native.py``.  The repository's
``csrc/fits_reader.cpp`` is compiled with ``g++`` into the port's build
directory on first use (:mod:`lightkurve_tpu_torch.ops._build`).  There is
no pure-Python fallback: a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import build_library

__all__ = ["library", "read_column", "read_batch", "table_rows"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "fits_reader.cpp")

_ERRORS = {
    -1: "cannot open file", -2: "out of memory", -3: "short read",
    -4: "truncated header", -5: "unsupported TFORM", -6: "row overflow",
    -7: "no matching BINTABLE", -8: "data out of bounds",
    -9: "unsupported column type", -10: "not a FITS file",
    -11: "column not found",
}

_LOCK = threading.Lock()
_LIB = []


def library():
    """The FITS reader library, built from ``csrc/fits_reader.cpp`` on
    first call."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        path = build_library(
            "lk_fits_reader",
            ["g++", "-O3", "-fPIC", "-std=c++17", "-pthread"],
            ["g++", "-shared", "-pthread"], [_SRC])
        lib = ctypes.CDLL(path)
        lib.lk_read_column_f64.restype = ctypes.c_int
        lib.lk_read_column_f64.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_long]
        lib.lk_read_batch_f64.restype = None
        lib.lk_read_batch_f64.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int]
        lib.lk_table_rows.restype = ctypes.c_long
        lib.lk_table_rows.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        _LIB.append(lib)
        return lib


def table_rows(path, extname=""):
    """Row count of the first binary table (negative error code on
    failure)."""
    return int(library().lk_table_rows(os.fspath(path).encode(),
                                       extname.encode()))


def read_column(path, column, extname="", max_rows=None):
    """Read one numeric column as float64."""
    lib = library()
    if max_rows is None:
        max_rows = table_rows(path, extname)
        if max_rows < 0:
            raise IOError(f"{path}: {_ERRORS.get(max_rows, max_rows)}")
    out = np.empty(max_rows, dtype=np.float64)
    n = lib.lk_read_column_f64(
        os.fspath(path).encode(), extname.encode(), column.encode(),
        out.ctypes.data, max_rows)
    if n < 0:
        raise IOError(f"{path}:{column}: {_ERRORS.get(n, n)}")
    return out[:n]


def read_batch(paths, column, stride=None, nthreads=None):
    """Load one column from many files on native threads → (nfiles,
    stride) float64 (NaN-padded) plus per-file row counts (negative codes
    for files that failed)."""
    lib = library()
    paths = [os.fspath(p) for p in paths]
    if stride is None:
        stride = max(table_rows(p) for p in paths)
    if nthreads is None:
        nthreads = min(os.cpu_count() or 4, 16)
    n = len(paths)
    out = np.empty((n, stride), dtype=np.float64)
    nrows = np.empty(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.lk_read_batch_f64(c_paths, n, column.encode(), out.ctypes.data,
                          stride, nrows.ctypes.data, nthreads)
    return out, nrows
