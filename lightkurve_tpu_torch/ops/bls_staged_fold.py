"""Bin-ordered staged fold (kernel K-SF) and its plain version.

Counterpart of the reference's XLA fold before its window scans
(``lightkurve_tpu/ops/bls.py:340-373``: a one-hot product per 128-row
tile, then a cumulative sum over the rows).  On a shared time grid every
curve puts a cadence in the same bin, so at one trial period the fold is a
permutation of the cadences, the same for every column, followed by a
running sum down each column:

* **index preparation** (torch, once per period for all columns): the
  fold bins (:func:`.bls_fused.fold_ids`), the deposit rows (each sample
  at its bin and, in wrap mode, again ``nbins_p`` rows later where that
  row lies below ``npad``), stably sorted so that a row's deposits keep
  their order.  ``src`` (C, M) holds the sorted deposit sources, and
  ``row_start`` (C, npad + 1) where each row's deposits begin;
* **the fold**: per column, the running sum over the sorted deposits,
  taken at each row's end.  An empty row repeats the row before it bit
  for bit, and a row before any deposit is 0.

The result is the inclusive prefix rows (C, npad, cols) that the one-hot
folds (:func:`.bls_fused.uniform_fold`,
:func:`.bls_fused_weighted.weighted_fold`) compute with
``npad * n * cols`` multiply-adds per period, in ``m * cols`` adds (``m``
deposits, about ``n``), and no intermediate that scales with
``npad * n``.  The uniform regime's count prefix is ``row_start[r + 1]``,
exact.

:func:`staged_fold` launches the CUDA kernel (``csrc/bls_staged_fold.cu``)
for CUDA tensors and runs :func:`staged_fold_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from .bls_fused import fold_ids, fold_rows, nbins_per_period
from .bls_window import _check_cuda

__all__ = ["fold_deposits", "fold_segments", "staged_fold",
           "staged_fold_plain"]

#: resident warps per SM a launch of K-SF aims to fill (the most an H100
#: SM holds)
_WARPS_PER_SM = 64
#: rows a segment of one period's fold keeps at least
_MIN_SEGMENT_ROWS = 64


def fold_deposits(ts, pc, d_phase, nbins, npad, wrap=True):
    """The fold's deposits at periods ``pc`` (C,), for ``npad`` rows:
    ``src`` (C, M) int32, the sample of each deposit in row order (stable:
    a row's direct deposits in time order, then its wrap deposits in time
    order; entries past ``row_start[:, npad]`` are padding), ``row_start``
    (C, npad + 1) int32, the first deposit of each row, and the bins per
    period (C,).  ``M`` is ``2n`` in wrap mode, ``n`` otherwise."""
    nbp = nbins_per_period(pc, d_phase)                        # (C,)
    ids = fold_ids(ts, pc, d_phase, nbins)                     # (C, n)
    n = ids.shape[1]
    rows = ids
    if wrap:
        # the circular extension: a second deposit nbins_p rows later;
        # those at or past npad are never read, and sort last as padding
        wrapped = ids + nbp[:, None]
        rows = torch.cat([ids, torch.clamp(wrapped, max=npad)], dim=1)
    keys, order = torch.sort(rows, dim=1, stable=True)
    src = (order % n).to(torch.int32)
    edges = torch.arange(npad + 1, dtype=keys.dtype, device=keys.device)
    row_start = torch.searchsorted(
        keys, edges.expand(keys.shape[0], -1).contiguous()).to(torch.int32)
    return src, row_start, nbp


def fold_segments(C, cols, npad, device):
    """The segments K-SF cuts each period's rows into, so that ``C``
    periods of ``cols`` columns (one chain of sums per column, segment and
    period) fill every SM of ``device``: 1 where the periods alone do, at
    most one per :data:`_MIN_SEGMENT_ROWS` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chains = C * -(-cols // 32)
    want = -(-sms * _WARPS_PER_SM // chains)
    return max(1, min(want, npad // _MIN_SEGMENT_ROWS))


def _prefix_rows(X, src, row_start):
    """The plain fold: gather the deposits' rows of ``X`` (n, cols), a
    running sum along the deposits, its value at each row's end."""
    m = int(row_start[:, -1].max())
    run = torch.cumsum(X[src[:, :m].long()], dim=1)            # (C, m, cols)
    end = row_start[:, 1:].long()                              # (C, npad)
    last = torch.clamp(end - 1, min=0)[..., None].expand(-1, -1, X.shape[1])
    return torch.where((end > 0)[..., None], torch.gather(run, 1, last), 0.0)


def staged_fold_plain(ts, X, pc, d_phase, nbins, max_nbins_p, k_max,
                      wrap=True):
    """Plain torch staged fold of ``X`` (n, cols) at periods ``pc`` (C,).

    Returns the inclusive prefix rows (C, npad, cols) of the circular
    double-deposit fold (``npad`` from :func:`.bls_fused.fold_rows`, sized
    from ``max_nbins_p``), the count prefix (C, npad) in the dtype of
    ``X`` (the deposits up to each row, shared by every column) and the
    bins per period (C,) int32."""
    staged_fold_plain.calls += 1
    npad = fold_rows(nbins, max_nbins_p, k_max)
    src, row_start, nbp = fold_deposits(ts, pc, d_phase, nbins, npad, wrap)
    return (_prefix_rows(X, src, row_start), row_start[:, 1:].to(X.dtype),
            nbp)


staged_fold_plain.calls = 0


def staged_fold(ts, X, pc, d_phase, nbins, max_nbins_p, k_max, wrap=True):
    """Staged fold: kernel K-SF on CUDA tensors (one launch for the
    periods ``pc``, each period's rows in :func:`fold_segments` segments),
    the plain version on CPU tensors.  Same arguments and result as
    :func:`staged_fold_plain`.  ``X`` must be contiguous (n, cols) on the
    card: a warp reads 32 adjacent columns of one sample's row."""
    if X.device.type == "cpu":
        return staged_fold_plain(ts, X, pc, d_phase, nbins, max_nbins_p,
                                 k_max, wrap)
    from ._build import check_status, cuda_library
    dtype = X.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"X must be float32 or float64 (got {dtype})")
    n, cols = X.shape
    C = pc.shape[0]
    _check_cuda("X", X, dtype)
    _check_cuda("ts", ts, dtype, (n,))
    _check_cuda("pc", pc, dtype, (C,))
    npad = fold_rows(nbins, max_nbins_p, k_max)
    src, row_start, nbp = fold_deposits(ts, pc, d_phase, nbins, npad, wrap)
    out = torch.empty((C, npad, cols), dtype=dtype, device=X.device)
    G = fold_segments(C, cols, npad, X.device)
    totals = (torch.empty((C, G, cols), dtype=dtype, device=X.device)
              if G > 1 else None)
    lib = cuda_library()
    fn = (lib.lk_bls_staged_fold_f32 if dtype == torch.float32
          else lib.lk_bls_staged_fold_f64)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(X.data_ptr(), src.data_ptr(), row_start.data_ptr(), C,
                  src.shape[1], npad, cols, G,
                  None if totals is None else totals.data_ptr(),
                  out.data_ptr(), stream)
    check_status(lib, code, "bls_staged_fold")
    staged_fold.launches += 1
    return out, row_start[:, 1:].to(dtype), nbp


staged_fold.launches = 0
