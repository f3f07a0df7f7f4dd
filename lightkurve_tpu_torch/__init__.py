"""lightkurve_tpu_torch — the batched transit search in PyTorch and CUDA.

A port of ``lightkurve_tpu``'s main path to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a): FITS files are read by the C++ column
reader (:mod:`.io.native`), streamed into device stacks
(:mod:`.io.pipeline`), and searched with shared-time-grid BLS
(:mod:`.ops.bls`) in checkpointed chunks (:mod:`.parallel.checkpoint`).

Modules mirror ``lightkurve_tpu``'s names.  Importing the package builds
nothing and needs neither a GPU nor ``nvcc``: kernels compile on first use
with a CUDA tensor.  The package never imports ``jax``.
"""
import importlib

__version__ = "0.1.0"

_LAZY = {
    "LightCurveStack": ".batch",
    "SweepRunner": ".parallel.checkpoint",
    "StreamingStackLoader": ".io.pipeline",
    "bls_power_shared_batch": ".ops.bls",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
