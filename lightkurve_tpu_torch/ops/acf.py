"""Batched FFT autocorrelation of power-spectrum windows.

Counterpart of ``lightkurve_tpu/ops/acf.py``.  The numax and Δν
estimators autocorrelate a window of the power spectrum at every trial
numax (the reference's loop of ``np.correlate(s, s, 'full')``); here the
whole "2D ACF" is one gather of the (centres, window) slices, one
``torch.fft.rfft``, |F|² and one ``irfft``.  The FFT is at least
2·window long, so the circular autocorrelation is the linear one at
every lag the window holds.
"""
from __future__ import annotations

import torch

__all__ = ["autocorrelate_windows", "acf2d"]


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def autocorrelate_windows(power, starts, window):
    """Zero-mean autocorrelation of the ``window``-long slices of
    ``power`` (m,) that begin at ``starts`` (c,).

    A slice is clipped at the array's ends as Python slicing clips it:
    lanes outside contribute nothing, and the mean is over the lanes
    inside.  Returns ``acf`` (c, window), lags 0 .. window-1 (zero past a
    clipped slice's length), and ``n_valid`` (c,), each slice's length."""
    m = power.shape[-1]
    starts = torch.as_tensor(starts, device=power.device)
    idx = starts[:, None] + torch.arange(window, device=power.device)
    valid = (idx >= 0) & (idx < m)
    vals = power[torch.clamp(idx, 0, m - 1)]
    n_valid = valid.sum(-1)
    mean = torch.where(valid, vals, 0.0).sum(-1) / torch.clamp(n_valid,
                                                               min=1)
    s = torch.where(valid, vals - mean[:, None], 0.0)
    nfft = _next_pow2(2 * window)
    spec = torch.fft.rfft(s, n=nfft)
    acf = torch.fft.irfft(spec.real ** 2 + spec.imag ** 2, n=nfft)
    return acf[:, :window], n_valid


def acf2d(power, starts, window):
    """:func:`autocorrelate_windows` under the reference's "2D ACF"
    name."""
    return autocorrelate_windows(power, starts, window)
