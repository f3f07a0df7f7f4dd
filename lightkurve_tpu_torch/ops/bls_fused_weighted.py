"""Fused weighted BLS scan (kernel K-WF) and its plain version.

The weighted regime (per-sample ``dy``, masked cadences at weight 0) folds
``[w | w*y]`` into phase bins with the circular double deposit, takes the
inclusive bin prefix sums and scans the duration windows::

    w_in  = cw[r + k - 1] - cw[r - 1]          (w_out = tot_w - w_in)
    depth = wy_out / w_out - wy_in / w_in

Counterpart of the reference's ``_bls_shared_scan``
(``lightkurve_tpu/ops/bls.py``: its XLA fold, then ``window_scan_pallas``).
The staged form is the staged fold (K-SF, :mod:`.bls_staged_fold`)
followed by the window scan (K-W, :mod:`.bls_window`);
:func:`fused_scan_weighted` does both in one CUDA kernel
(``csrc/bls_weighted_fused.cu``) for CUDA tensors, and runs
:func:`fused_scan_weighted_plain`, the staged form in plain torch, for CPU
tensors.  :func:`weighted_fold` is the reference's one-hot fold in torch,
kept as the staged fold's yardstick.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import full_f32_matmul
from .bls_fused import (check_fused_rows, deposit_run_counts, fold_ids,
                        fold_rows, inv_d_phase, nbins_per_period)
from .bls_staged_fold import staged_fold_plain
from .bls_window import (_check_cuda, _undersized, durations_args,
                         weighted_scan_staged)

__all__ = ["weighted_fold", "fused_scan_weighted",
           "fused_scan_weighted_plain"]

_FIELDS = ("power", "depth", "w_in", "transit_time", "duration")


def weighted_fold(ts, WWY, pc, d_phase, nbins, max_nbins_p, k_max,
                  wrap=True):
    """Inclusive bin prefix sums (C, npad, 2B) of the circular
    double-deposit fold of ``WWY`` (n, 2B) at periods ``pc`` (C,), and the
    per-period bin counts (C,).  Every sample lands at its fold bin and,
    in wrap mode, again ``nbins_p`` rows later, so windows that cross the
    period edge read their wrapped head from the extension rows.  The rows
    are sized from ``max_nbins_p`` (:func:`.bls_fused.max_nbins_bound`),
    which can exceed ``nbins`` by one."""
    npad = fold_rows(nbins, max_nbins_p, k_max)
    rows = torch.arange(npad, device=WWY.device, dtype=torch.int32)
    nbp = nbins_per_period(pc, d_phase)
    ids = fold_ids(ts, pc, d_phase, nbins)                     # (C, n)
    onehot = ids[:, None, :] == rows[None, :, None]            # (C, npad, n)
    if wrap:
        # the astropy edge mode leaves the extension rows empty, so edge
        # windows truncate against zeros
        onehot = onehot | ((ids + nbp[:, None])[:, None, :]
                           == rows[None, :, None])
    with full_f32_matmul(WWY.device):
        hist = torch.matmul(onehot.to(WWY.dtype), WWY)         # (C, npad, 2B)
    return torch.cumsum(hist, dim=1), nbp


def fused_scan_weighted_plain(ts, W, WY, periods, k_durs, dur_values,
                              d_phase, nbins, max_nbins_p, use_likelihood=True,
                              wrap=True, chunk=16):
    """Plain torch weighted scan: the staged fold's plain version
    (:func:`.bls_staged_fold.staged_fold_plain`) then the staged window
    scan, ``chunk`` periods at a time; the staged route folds the same
    way, so on the CPU both routes give the same bits.

    ts (n,), W and WY (n, B) weights and weighted mean-shifted flux,
    periods (P,).  ``max_nbins_p`` bounds ``nbins_per_period(periods)``; a
    period above it gets NaN statistics, as the kernel gives.  Returns a
    dict of (P, B) tensors: power, depth, w_in (raw, at each duration's
    first argmax), transit_time, duration."""
    fused_scan_weighted_plain.calls += 1
    WWY = torch.cat([W, WY], dim=1)                            # (n, 2B)
    total = WWY.sum(0)
    parts = []
    for i in range(0, periods.shape[0], chunk):
        pc = periods[i:i + chunk]
        csum, _, nbp = staged_fold_plain(ts, WWY, pc, d_phase, nbins,
                                         max_nbins_p, max(k_durs), wrap)
        best = weighted_scan_staged(csum, nbp, pc, total, k_durs, dur_values,
                                    d_phase, use_likelihood)
        parts.append(_undersized(best, nbp > int(max_nbins_p)))
    return {f: torch.cat([p[f] for p in parts]) for f in _FIELDS}


fused_scan_weighted_plain.calls = 0


def fused_scan_weighted(ts, W, WY, periods, k_durs, dur_values, d_phase,
                        nbins, max_nbins_p, use_likelihood=True, wrap=True,
                        chunk=16):
    """Fused weighted scan: kernel K-WF on CUDA tensors (all periods in one
    launch; ``chunk`` is not used there), the plain version on CPU
    tensors.  Same arguments and result as
    :func:`fused_scan_weighted_plain`; ``max_nbins_p`` sizes the kernel's
    shared memory.  The kernel reads W and WY as (B, n), one curve per
    row: they are best transposed views of (B, n) tensors, as
    ``bls_power_shared_batch`` passes them; any other layout is copied
    once per call."""
    if W.device.type == "cpu":
        return fused_scan_weighted_plain(ts, W, WY, periods, k_durs,
                                         dur_values, d_phase, nbins,
                                         max_nbins_p, use_likelihood, wrap,
                                         chunk)
    from ._build import check_status, cuda_library
    dtype = W.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"W must be float32 or float64 (got {dtype})")
    n, B = W.shape
    P = periods.shape[0]
    Wt, WYt = W.T.contiguous(), WY.T.contiguous()             # (B, n)
    _check_cuda("W", Wt, dtype)
    _check_cuda("WY", WYt, dtype, (B, n))
    _check_cuda("ts", ts, dtype, (n,))
    _check_cuda("periods", periods, dtype, (P,))
    k_arr, v_arr = durations_args(k_durs, dur_values)
    k_max = int(k_arr.max())
    rows_cap = int(max_nbins_p) + k_max - 1
    check_fused_rows(rows_cap, dtype, W.device, weighted=True)
    tot_w, tot_wy = Wt.sum(1), WYt.sum(1)
    nbp = nbins_per_period(periods, d_phase)
    outs = [torch.empty((P, B), dtype=dtype, device=W.device)
            for _ in _FIELDS]
    lib = cuda_library()
    fn = (lib.lk_bls_fused_weighted_f32 if dtype == torch.float32
          else lib.lk_bls_fused_weighted_f64)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(ts.data_ptr(), Wt.data_ptr(), WYt.data_ptr(),
                  tot_w.data_ptr(), tot_wy.data_ptr(), periods.data_ptr(),
                  nbp.data_ptr(), n, B, P, int(nbins), k_max, rows_cap,
                  k_arr.ctypes.data_as(ctypes.c_void_p),
                  v_arr.ctypes.data_as(ctypes.c_void_p), len(k_arr),
                  float(d_phase), inv_d_phase(d_phase, dtype),
                  int(bool(use_likelihood)), int(bool(wrap)),
                  *[o.data_ptr() for o in outs],
                  deposit_run_counts(W.device), stream)
    check_status(lib, code, "bls_fused_weighted")
    fused_scan_weighted.launches += 1
    return dict(zip(_FIELDS, outs))


fused_scan_weighted.launches = 0
