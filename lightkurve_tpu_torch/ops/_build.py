"""Build and load the port's native libraries at first use.

The CUDA kernels under ``lightkurve_tpu_torch/csrc/*.cu`` are compiled by
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
loaded with :mod:`ctypes`.  The FITS column reader (the repository's
``csrc/fits_reader.cpp``) is compiled by ``g++``.  Both land in
``lightkurve_tpu_torch/_build/`` (git-ignored) and are rebuilt when a
source is newer than the library.  A failed build raises; nothing falls
back.  Importing this module compiles nothing.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "CSRC_DIR", "cuda_library", "build_library",
           "check_status", "build_log"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED = {}


def _stale(target, sources):
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in sources)


def build_log(name):
    """Compiler output of the last build of library ``name`` ('' if none)."""
    path = os.path.join(BUILD_DIR, name + ".log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build_library(name, cmd_prefix, sources, deps=()):
    """Compile ``sources`` with ``cmd_prefix`` into ``_build/<name>.so``
    unless it is newer than every source and dependency; return its path.

    The library is written under a process-unique name and moved into
    place, so concurrent builds (test workers) never load a half-written
    file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = os.path.join(BUILD_DIR, name + ".so")
    if not _stale(target, list(sources) + list(deps)):
        return target
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = list(cmd_prefix) + ["-o", tmp] + list(sources)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {name} failed (exit {proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, target)
    return target


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _declare_cuda(lib):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lk_bls_window_weighted_f32.argtypes = (
        [P, P, P, P, I, I, I, P, P, I, D, I] + [P] * 5 + [P])
    lib.lk_bls_window_weighted_f64.argtypes = \
        lib.lk_bls_window_weighted_f32.argtypes
    lib.lk_bls_fused_uniform_f32.argtypes = (
        [P, P, P, P, P, I, I, I, I, I, I, P, P, I, D, D, I, I] + [P] * 5
        + [P])
    lib.lk_bls_fused_uniform_f64.argtypes = \
        lib.lk_bls_fused_uniform_f32.argtypes
    for fn in (lib.lk_bls_window_weighted_f32, lib.lk_bls_window_weighted_f64,
               lib.lk_bls_fused_uniform_f32, lib.lk_bls_fused_uniform_f64):
        fn.restype = ctypes.c_int
    lib.lk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lk_cuda_error_string.restype = ctypes.c_char_p


def cuda_library():
    """The BLS kernel library, built from ``csrc/*.cu`` on first call."""
    with _LOCK:
        lib = _LOADED.get("cuda")
        if lib is None:
            sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
            deps = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
            path = build_library("lk_bls_kernels", [_nvcc()] + NVCC_FLAGS,
                                 sources, deps)
            lib = ctypes.CDLL(path)
            _declare_cuda(lib)
            _LOADED["cuda"] = lib
        return lib


def check_status(lib, code, what):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if code != 0:
        msg = lib.lk_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
