"""Fused uniform-weight BLS scan (kernel K-F) and its plain version.

Counterpart of ``lightkurve_tpu/ops/bls_fused_pallas.py``
(``bls_fused_scan_uniform``).  For curves whose weights are constant in
time the box depth depends only on counts::

    depth = tot_y / n_out - y_in * (1/n_in + 1/n_out)

so one shared count column replaces per-curve weights.  For each trial
period the scan folds the shared time grid into bins
``ids = clip(trunc(fmod(ts, P) * (1/d_phase)), 0, nbins - 1)``, builds the
inclusive prefix sums of the mean-shifted flux with the circular wrap
extension (every sample deposited at ``ids`` and, in wrap mode, again at
``ids + nbins_p``), then runs the duration-window scan.  The result holds
COUNT-based winner statistics; ``ops.bls._uniform_stats_rescale`` turns
them into weighted statistics.

:func:`fused_scan_uniform` launches the CUDA kernel (``csrc/bls_fused.cu``)
for CUDA tensors and runs :func:`fused_scan_uniform_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import diagnostics
from ..config import full_f32_matmul, numpy_dtype
from .bls_window import (_check_cuda, _undersized, durations_args,
                         uniform_scan_staged)

__all__ = ["fused_scan_uniform", "fused_scan_uniform_plain", "fold_ids",
           "nbins_per_period", "max_nbins_bound", "inv_d_phase",
           "uniform_fold", "fold_rows",
           "fused_smem_bytes", "fused_fits", "fused_block",
           "check_fused_rows", "shared_memory_optin", "FUSED_TILE",
           "DEPOSIT_RUNS", "deposit_run_counts"]

#: curves (warps) per fused block at most (``kLkMaxWarps`` in
#: csrc/bls_fold_warp.cuh)
FUSED_TILE = 32
_ID_TILE = 512          # samples a fused block stages ids for (``kLkIdTile``)

_FIELDS = ("power", "depth", "n_in", "transit_time", "duration")

#: the fused kernels' counters of staged runs of 32 samples, per block: runs
#: whose segmented scan takes 0-5 rounds, runs whose groups are scattered
DEPOSIT_RUNS = tuple(f"bls.deposit_runs.r{r}" for r in range(6)) + (
    "bls.deposit_runs.scattered",)


def inv_d_phase(d_phase, dtype):
    """1/d_phase rounded in ``dtype``.  Bin positions are ``x * (1/d_phase)``,
    not ``x / d_phase``: the reference's compiler folds its division by the
    constant bin width into this product, and the two differ by one ulp,
    enough to move a sample that sits on a bin edge."""
    np_dtype = numpy_dtype(dtype)
    return float(np_dtype.type(1) / np_dtype.type(d_phase))


def fold_ids(ts, pc, d_phase, nbins):
    """Fold bins (C, n): exact fmod (never t - floor(t/P)·P, which is off
    by one ulp on bin edges), times the dtype-rounded 1/d_phase, truncating
    int cast, clip to ``nbins - 1``.  The reciprocal goes in as a Python
    number, exact in the dtype: a device tensor made from it would be a
    blocking host-to-device copy, which waits for the queued work."""
    phase = torch.fmod(ts[None, :], pc[:, None])
    inv = inv_d_phase(d_phase, ts.dtype)
    return torch.clamp((phase * inv).to(torch.int32), 0, nbins - 1)


def nbins_per_period(pc, d_phase):
    """ceil(pc · (1/d_phase)) in the dtype of ``pc``, as int32 (the
    reciprocal as in :func:`fold_ids`)."""
    return torch.ceil(pc * inv_d_phase(d_phase, pc.dtype)).to(torch.int32)


def max_nbins_bound(p_host, d_phase, dtype):
    """The largest :func:`nbins_per_period` of the host periods ``p_host``,
    computed on the host by the device's rule (periods and 1/d_phase
    rounded in ``dtype``), so it bounds the kernel's rows without a device
    read.  It can exceed ``ceil(max(p_host) / d_phase)`` by one."""
    np_dtype = numpy_dtype(dtype)
    inv = np_dtype.type(inv_d_phase(d_phase, dtype))
    return int(np.ceil(np.max(np.asarray(p_host, dtype=np_dtype)) * inv))


def fold_rows(nbins, max_nbins_p, k_max):
    """Rows of a fold held in device memory: every period's bins plus the
    ``k_max - 1`` wrap rows, rounded up to a multiple of 128."""
    return -(-(max(nbins, max_nbins_p) + k_max - 1) // 128) * 128


def fused_smem_bytes(rows_cap, dtype, tile=FUSED_TILE, weighted=False):
    """Shared memory of one fused block of ``tile`` warps
    (``lk_fold_smem_bytes`` in csrc/bls_fold_warp.cuh): each warp's prefix
    columns of ``rows_cap`` rows (one for K-F, two for K-WF), K-F's count
    column shared by the block, the staged fold ids and lane masks (8
    bytes per staged sample) and 4 bytes per run of 32 staged samples (a
    word per run, then the block's run counters)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_row = tile * itemsize * (2 if weighted else 1) + (0 if weighted
                                                          else 4)
    return rows_cap * per_row + _ID_TILE * 8 + _ID_TILE // 32 * 4


def fused_fits(rows_cap, dtype, device, weighted=False):
    """True when a fused block of one warp (one curve) with ``rows_cap``
    rows fits the shared memory a block may opt in to on ``device``
    (always on the CPU, which has no limit); ``weighted`` for K-WF's two
    columns per curve.  The kernels then pick their own width among the
    widths that fit (:func:`fused_block`)."""
    optin = shared_memory_optin(device)
    return optin is None or fused_smem_bytes(rows_cap, dtype, 1,
                                             weighted) <= optin


def fused_block(rows_cap, dtype, device, weighted=False):
    """The block K-F (or K-WF, ``weighted``) launches with at ``rows_cap``
    rows on ``device``: (warps per block, resident blocks per SM by the
    occupancy calculator).  The kernel picks, among the widths that fit
    the opt-in shared memory, the one with the most resident warps, the
    widest on ties."""
    from ._build import check_status, cuda_library
    lib = cuda_library()
    fn = (lib.lk_bls_fused_weighted_block if weighted
          else lib.lk_bls_fused_uniform_block)
    warps, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = fn(int(dtype == torch.float64), int(rows_cap),
                  ctypes.byref(warps), ctypes.byref(blocks))
    check_status(lib, code, "fused block")
    return warps.value, blocks.value


def check_fused_rows(rows_cap, dtype, device, weighted=False):
    """Raise unless :func:`fused_fits` (the launch would be refused)."""
    if not fused_fits(rows_cap, dtype, device, weighted):
        raise ValueError(
            f"a fused block of one curve with {rows_cap} rows needs "
            f"{fused_smem_bytes(rows_cap, dtype, 1, weighted)} bytes of "
            f"shared memory, more than {device} allows: use "
            f"fold_impl='staged'")


def deposit_run_counts(device):
    """The pointer a fused kernel adds its staged runs to: while
    :func:`.diagnostics.recording`, the data pointer of the pending device
    counter :data:`DEPOSIT_RUNS` on ``device``
    (:func:`.diagnostics.pending_counts`, read by
    :func:`.diagnostics.counters` after the recording, so no launch waits
    for a read); else ``None``, and the kernel counts nothing."""
    counts = diagnostics.pending_counts(DEPOSIT_RUNS, device)
    return None if counts is None else counts.data_ptr()


def shared_memory_optin(device):
    """Shared memory (bytes) a block may opt in to on ``device``, as the
    fused kernels read it when they size their blocks; ``None`` for the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from ._build import cuda_library
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    value = int(cuda_library().lk_max_shared_optin(index))
    if value <= 0:
        raise RuntimeError(f"could not read the shared memory limit of "
                           f"{device}")
    return value


def uniform_fold(ts, Y0, pc, d_phase, nbins, max_nbins_p, k_max, wrap=True):
    """The one-hot fold of the uniform regime, the reference's XLA fold
    written in torch: inclusive bin prefix sums of the mean-shifted flux
    ``Y0`` (n, B) at periods ``pc`` (C,).  The staged fold
    (:mod:`.bls_staged_fold`) computes the same function without the
    one-hot; this form stays as its yardstick and test reference.

    Every sample lands at its fold bin and, in wrap mode, again
    ``nbins_p`` rows later (the circular extension rows).  The flux sums
    are one one-hot product (full float32) and a cumulative sum; the count
    prefix shared by every curve is ``sum_i [ids_i <= r]`` (plus the wrap
    copy's), exact.  Rows are sized from ``max_nbins_p``
    (:func:`max_nbins_bound`).  Returns cs_y (C, npad, B), cs_n (C, npad)
    and the per-period bin counts (C,)."""
    dtype = Y0.dtype
    npad = fold_rows(nbins, max_nbins_p, k_max)
    rows = torch.arange(npad, device=Y0.device, dtype=torch.int32)
    nbp = nbins_per_period(pc, d_phase)                        # (C,)
    ids = fold_ids(ts, pc, d_phase, nbins)                     # (C, n)
    ids2 = ids + nbp[:, None]                                  # wrap copy
    onehot = ids[:, None, :] == rows[None, :, None]            # (C, npad, n)
    if wrap:
        onehot = onehot | (ids2[:, None, :] == rows[None, :, None])
    with full_f32_matmul(Y0.device):
        hist = torch.matmul(onehot.to(dtype), Y0)              # (C, npad, B)
    del onehot
    cs_y = torch.cumsum(hist, dim=1)
    del hist
    cs_n = (ids[:, None, :] <= rows[None, :, None]).sum(-1, dtype=dtype)
    if wrap:
        cs_n = cs_n + (ids2[:, None, :] <= rows[None, :, None]).sum(
            -1, dtype=dtype)
    return cs_y, cs_n, nbp


def _chunk_uniform(ts, Y0, tot_y, pc, k_durs, dur_values, d_phase, nbins,
                   max_nbins_p, use_likelihood, wrap):
    from .bls_staged_fold import staged_fold_plain
    cs_y, cs_n, nbp = staged_fold_plain(ts, Y0, pc, d_phase, nbins,
                                        max_nbins_p, max(k_durs), wrap)
    best = uniform_scan_staged(cs_y, cs_n, nbp, pc, tot_y, float(Y0.shape[0]),
                               k_durs, dur_values, d_phase, use_likelihood)
    return _undersized(best, nbp > max_nbins_p)


def fused_scan_uniform_plain(ts, Y0, periods, k_durs, dur_values, d_phase,
                             nbins, max_nbins_p, use_likelihood=True,
                             wrap=True, chunk=16):
    """Plain torch uniform scan: the staged form of
    ``_bls_shared_scan_uniform`` (the staged fold's plain version,
    :func:`.bls_staged_fold.staged_fold_plain`, then shifted windows),
    ``chunk`` periods at a time; the staged route folds the same way, so
    on the CPU both routes give the same bits.

    ts (n,), Y0 (n, B) mean-shifted flux, periods (P,).  ``max_nbins_p``
    bounds ``nbins_per_period(periods)`` (:func:`max_nbins_bound`); a
    period above it gets NaN statistics, as the kernel gives.  Returns a
    dict of (P, B) tensors: power, depth, n_in, transit_time, duration
    (count-based statistics)."""
    fused_scan_uniform_plain.calls += 1
    tot_y = Y0.sum(0)
    parts = [_chunk_uniform(ts, Y0, tot_y, periods[i:i + chunk], k_durs,
                            dur_values, d_phase, nbins, int(max_nbins_p),
                            use_likelihood, wrap)
             for i in range(0, periods.shape[0], chunk)]
    return {f: torch.cat([p[f] for p in parts]) for f in _FIELDS}


fused_scan_uniform_plain.calls = 0


def fused_scan_uniform(ts, Y0, periods, k_durs, dur_values, d_phase, nbins,
                       max_nbins_p, use_likelihood=True, wrap=True, chunk=16):
    """Fused uniform scan: kernel K-F on CUDA tensors (all periods in one
    launch; ``chunk`` is not used there), the plain version on CPU
    tensors.  Same arguments and result as
    :func:`fused_scan_uniform_plain`; ``max_nbins_p`` sizes the kernel's
    shared memory.  The kernel reads the flux as (B, n), one curve per
    row: ``Y0`` is best the transposed view of a (B, n) tensor, as
    ``bls_power_shared_batch`` passes it; any other layout is copied once
    per call."""
    if Y0.device.type == "cpu":
        return fused_scan_uniform_plain(ts, Y0, periods, k_durs, dur_values,
                                        d_phase, nbins, max_nbins_p,
                                        use_likelihood, wrap, chunk)
    from ._build import check_status, cuda_library
    dtype = Y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Y0 must be float32 or float64 (got {dtype})")
    n, B = Y0.shape
    P = periods.shape[0]
    Yt = Y0.T.contiguous()                     # (B, n): coalesced per warp
    _check_cuda("Y0", Yt, dtype)
    _check_cuda("ts", ts, dtype, (n,))
    _check_cuda("periods", periods, dtype, (P,))
    k_arr, v_arr = durations_args(k_durs, dur_values)
    k_max = int(k_arr.max())
    # shared-memory rows per block: a period reads nbins_p + k_max - 1 rows
    rows_cap = int(max_nbins_p) + k_max - 1
    check_fused_rows(rows_cap, dtype, Y0.device)
    tot_y = Yt.sum(1)
    nbp = nbins_per_period(periods, d_phase)
    outs = [torch.empty((P, B), dtype=dtype, device=Y0.device)
            for _ in _FIELDS]
    lib = cuda_library()
    fn = (lib.lk_bls_fused_uniform_f32 if dtype == torch.float32
          else lib.lk_bls_fused_uniform_f64)
    with torch.cuda.device(Y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(ts.data_ptr(), Yt.data_ptr(), tot_y.data_ptr(),
                  periods.data_ptr(), nbp.data_ptr(), n, B, P, int(nbins),
                  k_max, rows_cap, k_arr.ctypes.data_as(ctypes.c_void_p),
                  v_arr.ctypes.data_as(ctypes.c_void_p), len(k_arr),
                  float(d_phase), inv_d_phase(d_phase, dtype),
                  int(bool(use_likelihood)), int(bool(wrap)),
                  *[o.data_ptr() for o in outs],
                  deposit_run_counts(Y0.device), stream)
    check_status(lib, code, "bls_fused_uniform")
    fused_scan_uniform.launches += 1
    return dict(zip(_FIELDS, outs))


fused_scan_uniform.launches = 0
