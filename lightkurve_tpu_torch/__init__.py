"""lightkurve_tpu_torch — the batched transit search in PyTorch and CUDA.

A port of ``lightkurve_tpu``'s transit search to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a): FITS files are read by the C++
column reader (:mod:`.io.native`), streamed into device stacks
(:mod:`.io.pipeline`), detrended by the batched Savitzky-Golay flatten
(:mod:`.ops.detrend`), and searched with box least squares (:mod:`.ops.bls`:
shared-time-grid kernels, mixed grids by group, per-curve methods) in
checkpointed chunks (:mod:`.parallel.checkpoint`).

Modules mirror ``lightkurve_tpu``'s names.  Importing the package builds
nothing and needs neither a GPU nor ``nvcc``: kernels compile on first use
with a CUDA tensor.  Entry points put their tensors on the card unless the
caller passes ``device="cpu"``.  The package never imports ``jax``.
"""
import importlib

__version__ = "0.1.0"

_LAZY = {
    "LightCurveStack": ".batch",
    "SweepRunner": ".parallel.checkpoint",
    "StreamingStackLoader": ".io.pipeline",
    "bls_power_shared_batch": ".ops.bls",
    "bls_power": ".ops.bls",
    "bls_power_binned": ".ops.bls",
    "prewarm_shared_sweep": ".parallel.checkpoint",
    "flatten_batch": ".ops.detrend",
    "savgol_design_matrix": ".ops.savgol",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
