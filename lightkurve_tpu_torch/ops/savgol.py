"""Savitzky-Golay smoothing with 'interp' edges, segment-aware.

Counterpart of ``lightkurve_tpu/ops/savgol.py``.  The reference's
``flatten`` wraps ``scipy.signal.savgol_filter`` in its default
``mode='interp'``: each output sample is the value at position ``k`` of
the least-squares degree-``polyorder`` polynomial fitted to a length-``w``
window anchored inside the array.  Interior samples use the centred window
(``k = w // 2``); the first and last ``w // 2`` samples re-use the first or
last full window with ``k`` shifted.  With gap segments the windows anchor
inside each segment instead of the whole array.

Here the centred value of every sample is one convolution (an FFT
product) with row ``w // 2`` of the projection matrix ``H``; then each
segment end's anchored window is gathered once and multiplied by ``H``,
which gives the shifted values of the ``w // 2`` samples that share it.
Memory stays O(B·n): no tensor holds every sample's window.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import full_f32_matmul
from ..diagnostics import count, span

__all__ = ["savgol_design_matrix", "savgol_filter_interp"]


def savgol_design_matrix(window_length: int, polyorder: int) -> np.ndarray:
    """Host-side (w, w) projection matrix of the degree-``polyorder``
    least-squares fit: row ``k`` gives the weights of the fitted value at
    window position ``k``; row ``w // 2`` is scipy's convolution
    coefficients (up to reflection)."""
    w = int(window_length)
    if w % 2 != 1 or w < 1:
        raise ValueError("window_length must be a positive odd integer")
    if polyorder >= w:
        raise ValueError("polyorder must be less than window_length")
    with span("flatten.design", window_length=w, polyorder=int(polyorder)):
        return _design_matrix(w, int(polyorder)).copy()


@functools.lru_cache(maxsize=8)
def _design_matrix(w, polyorder):
    """:func:`savgol_design_matrix`, built once per shape: its product runs
    on the BLAS thread pool, whose spinning threads slow the host's
    launches after it (a single-curve flatten calls it each time)."""
    # centred positions for numerical conditioning
    pos = np.arange(w, dtype=np.float64) - (w - 1) / 2.0
    V = np.vander(pos, N=polyorder + 1, increasing=True)
    H = V @ np.linalg.pinv(V)
    H.flags.writeable = False
    return H


def _centred(xc, h):
    """``out[i] = sum_j h[j] * xc[i - w//2 + j]`` over the last axis, 0 past
    the ends, by one real FFT product per row (no TF32 on the card, and no
    buffer of a window per sample, which a direct float64 convolution on
    the CPU builds)."""
    n, w = xc.shape[-1], h.shape[0]
    nfft = 1 << (n + w - 2).bit_length()            # >= n + w - 1: linear
    spec = torch.fft.rfft(xc, n=nfft) * torch.fft.rfft(h.flip(0), n=nfft)
    return torch.fft.irfft(spec, n=nfft)[..., w // 2:w // 2 + n]


def savgol_filter_interp(x, H, seg_lo=None, seg_hi=None, static=False):
    """SG smoothing with 'interp' edges over the last axis of ``x``.

    x : (..., n) samples; H : (w, w) projection matrix
    (:func:`savgol_design_matrix`, array or tensor); seg_lo, seg_hi :
    optional integer tensors broadcastable to ``x.shape``, each sample's
    [lo, hi) segment bounds (default: the whole axis).

    Samples of segments shorter than ``w`` get no defined value: callers
    overwrite them (the reference uses the segment median).  Non-finite
    and out-of-segment samples enter the sums as 0, as the reference's
    do; a valid output's anchored window never reaches them.  The samples
    are shifted by their in-segment mean before the sums (SG reproduces
    constants exactly), which keeps float32 rounding relative to the
    signal, and the shift is added back.

    ``static`` finds the segment ends' windows with no read on the host
    (:func:`_end_windows_static`), so that the call can be captured in a
    CUDA graph; the default reads their positions (``torch.nonzero``) and
    multiplies only the windows there are.
    """
    dev = x.device
    H = torch.as_tensor(H, dtype=x.dtype, device=dev)
    w = H.shape[0]
    hw = w // 2
    n = x.shape[-1]
    lead = x.shape[:-1]
    idx = torch.arange(n, device=dev)
    seg_lo = (torch.zeros((), dtype=torch.int64, device=dev)
              if seg_lo is None else seg_lo)
    seg_hi = (torch.full((), n, dtype=torch.int64, device=dev)
              if seg_hi is None else seg_hi)
    seg_lo = torch.broadcast_to(torch.as_tensor(seg_lo, device=dev),
                                x.shape).to(torch.int64)
    seg_hi = torch.broadcast_to(torch.as_tensor(seg_hi, device=dev),
                                x.shape).to(torch.int64)
    in_seg = (idx >= seg_lo) & (idx < seg_hi) & torch.isfinite(x)
    x0 = torch.where(in_seg, x, 0.0)
    mu = x0.sum(-1, keepdim=True) / torch.clamp(
        in_seg.sum(-1, keepdim=True), min=1).to(x.dtype)
    xc = (x0 - mu).reshape(-1, n)
    lo, hi = seg_lo.reshape(-1, n), seg_hi.reshape(-1, n)
    rows = xc.shape[0]
    # the centred window of every sample
    trend = _centred(xc, H[hw])
    # anchored starts; a sample whose start is not i - hw shares its window
    # with its segment end: start lo (left) or hi - w (right)
    start = torch.clamp(idx - hw, min=lo)
    start = torch.minimum(start, torch.maximum(lo, hi - w))
    shifted = ((hi - lo) >= w) & (start != idx - hw)
    if static:
        trend = _end_windows_static(xc, H, trend, start, shifted)
        return trend.reshape(lead + (n,)) + mu
    rr, ii = torch.nonzero(shifted, as_tuple=True)
    count("host_sync")                  # nonzero waits for the device
    if rr.numel():
        st = start[rr, ii]
        # one window per segment end, numbered in row-major order
        ends = torch.zeros((rows, n), dtype=torch.bool, device=dev)
        ends[rr, st] = True
        r, s = torch.nonzero(ends, as_tuple=True)
        count("host_sync")
        win_id = torch.zeros((rows, n), dtype=torch.int64, device=dev)
        win_id[r, s] = torch.arange(r.numel(), device=dev)
        win = xc[r[:, None], s[:, None] + torch.arange(w, device=dev)]
        # every window position's fitted value on each end's window
        with full_f32_matmul(dev):
            vals = win @ H.T                            # (windows, w)
        trend[rr, ii] = vals[win_id[rr, st], ii - st]
    return (trend.reshape(lead + (n,)) + mu)


def _end_windows_static(xc, H, trend, start, shifted):
    """``trend`` with each shifted sample's value taken on its segment
    end's window, from tensors whose shapes depend on no value.

    A segment of at least ``w`` samples has two end windows at most, and
    segments do not overlap, so a row has at most ``2 * (n // w)``; each
    row's window starts fill a table of that width in their order (unused
    entries window 0), and a shifted sample's window is the rank of its
    start.  The same windows and products as the reading path, on a table
    that is mostly padding: for one curve, not for a batch.
    """
    rows, n = xc.shape
    w = H.shape[0]
    k = 2 * (n // w)
    if k == 0:                          # no segment as long as a window
        return trend
    dev = xc.device
    idx = torch.arange(n, device=dev).expand(rows, n)
    # each window start marked once; the other samples in column n
    ends = torch.zeros((rows, n + 1), dtype=torch.bool, device=dev)
    ends.scatter_(-1, torch.where(shifted, start, n), True)
    ends = ends[:, :n]
    rank = torch.cumsum(ends, -1) - 1
    table = torch.zeros((rows, k + 1), dtype=torch.int64, device=dev)
    table.scatter_(-1, torch.where(ends, rank, k), idx)
    pos = table[:, :k, None] + torch.arange(w, device=dev)
    win = torch.gather(xc, -1, torch.clamp(pos, max=n - 1).reshape(rows, -1))
    with full_f32_matmul(dev):
        vals = win.reshape(rows, k, w) @ H.T           # (rows, k, w)
    wid = torch.clamp(torch.gather(rank, -1, start), 0, k - 1)
    at = wid * w + torch.clamp(idx - start, 0, w - 1)
    got = torch.gather(vals.reshape(rows, k * w), -1, at)
    return torch.where(shifted, got, trend)
