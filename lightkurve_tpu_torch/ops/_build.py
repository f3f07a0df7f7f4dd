"""Build and load the port's native libraries at first use.

The CUDA kernels under ``lightkurve_tpu_torch/csrc/*.cu`` are compiled by
``nvcc`` for ``sm_90a``, one process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
:mod:`ctypes`.  The FITS column reader (the repository's
``csrc/fits_reader.cpp``) is compiled and linked by ``g++`` the same way.
Both land in ``lightkurve_tpu_torch/_build/`` (git-ignored) and are rebuilt
when a source is newer than the library.  A failed build raises; nothing
falls back.  Importing this module compiles nothing.
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

#: compile flags of one CUDA source (an object with a plain C interface)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: link flags of the kernel library
NVCC_LINK_FLAGS = ["-shared", "-gencode", "arch=compute_90a,code=sm_90a"]

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


def _run_all(cmds):
    """Run the commands concurrently; returns (returncode, output) each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build_library(name, compile_prefix, link_prefix, sources, deps=()):
    """Build ``sources`` into ``_build/<name>.so`` unless it is newer than
    every source and dependency; return its path.

    Each source is compiled to an object by its own ``compile_prefix -c``
    process, all started together, and ``link_prefix`` links the objects.
    The library is written under a process-unique name and moved into
    place, so concurrent builds (test workers) never load a half-written
    file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = os.path.join(BUILD_DIR, name + ".so")
    if not _stale(target, list(sources) + list(deps)):
        return target
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = f"{target}.{tag}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{name}.{os.path.basename(s)}.{tag}.o")
            for s in sources]
    steps = [[list(compile_prefix) + ["-c", "-o", o, s]
              for o, s in zip(objs, sources)],
             [list(link_prefix) + ["-o", tmp] + objs]]
    log, failed = [], None
    for cmds in steps:
        for cmd, (code, out) in zip(cmds, _run_all(cmds)):
            log.append(" ".join(cmd) + "\n" + out)
            if code != 0 and failed is None:
                failed = (code, cmd, out)
        if failed:
            break
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write("\n".join(log))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        if os.path.exists(tmp):
            os.remove(tmp)
        code, cmd, out = failed
        raise RuntimeError(f"building {name} failed (exit {code}):"
                           f"\n{' '.join(cmd)}\n{out[-4000:]}")
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
        + [P, P])
    lib.lk_bls_fused_uniform_f64.argtypes = \
        lib.lk_bls_fused_uniform_f32.argtypes
    lib.lk_bls_fused_weighted_f32.argtypes = (
        [P] * 7 + [I] * 6 + [P, P, I, D, D, I, I] + [P] * 5 + [P, P])
    lib.lk_bls_fused_weighted_f64.argtypes = \
        lib.lk_bls_fused_weighted_f32.argtypes
    lib.lk_bls_window_uniform_f32.argtypes = (
        [P, P, P, P, P, I, I, I, P, P, I, D, D, I] + [P] * 5 + [P])
    lib.lk_bls_window_uniform_f64.argtypes = \
        lib.lk_bls_window_uniform_f32.argtypes
    lib.lk_bls_staged_fold_f32.argtypes = [P, P, P, I, I, I, I, I, P, P, P]
    lib.lk_bls_staged_fold_f64.argtypes = \
        lib.lk_bls_staged_fold_f32.argtypes
    lib.lk_bls_curve_fused_f32.argtypes = (
        [P] * 5 + [I] * 9 + [D, D] + [I] * 3 + [P, I, I] + [P] * 6 + [P])
    lib.lk_bls_curve_fused_f64.argtypes = \
        lib.lk_bls_curve_fused_f32.argtypes
    IP = ctypes.POINTER(ctypes.c_int)
    lib.lk_bls_fused_uniform_block.argtypes = [I, I, IP, IP]
    lib.lk_bls_fused_weighted_block.argtypes = [I, I, IP, IP]
    lib.lk_bls_curve_block.argtypes = [I, I, IP, IP, IP]
    for fn in (lib.lk_bls_window_weighted_f32, lib.lk_bls_window_weighted_f64,
               lib.lk_bls_fused_uniform_f32, lib.lk_bls_fused_uniform_f64,
               lib.lk_bls_fused_weighted_f32, lib.lk_bls_fused_weighted_f64,
               lib.lk_bls_window_uniform_f32, lib.lk_bls_window_uniform_f64,
               lib.lk_bls_staged_fold_f32, lib.lk_bls_staged_fold_f64,
               lib.lk_bls_curve_fused_f32, lib.lk_bls_curve_fused_f64,
               lib.lk_bls_fused_uniform_block,
               lib.lk_bls_fused_weighted_block, lib.lk_bls_curve_block):
        fn.restype = ctypes.c_int
    lib.lk_max_shared_optin.argtypes = [I]
    lib.lk_max_shared_optin.restype = ctypes.c_int
    lib.lk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lk_cuda_error_string.restype = ctypes.c_char_p


def cuda_library():
    """The BLS kernel library, built from ``csrc/*.cu`` on first call."""
    with _LOCK:
        lib = _LOADED.get("cuda")
        if lib is None:
            sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
            deps = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
            nvcc = _nvcc()
            path = build_library("lk_bls_kernels", [nvcc] + NVCC_FLAGS,
                                 [nvcc] + NVCC_LINK_FLAGS, sources, deps)
            lib = ctypes.CDLL(path)
            _declare_cuda(lib)
            _LOADED["cuda"] = lib
        return lib


def check_status(lib, code, what):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if code != 0:
        msg = lib.lk_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
