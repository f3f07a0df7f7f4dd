"""numax estimation via the 2D ACF method.

Counterpart of ``lightkurve_tpu/seismology/numax_estimators.py``
(reference ``seismology/numax_estimators.py:15-213``, Viani et al. /
Huber et al. sliding-window autocorrelation): windows of width 250 µHz
(SC) / 25 µHz (LC) slide over the SNR spectrum at 10/1 µHz spacing; each
window's zero-mean ACF is collapsed into the Mean Collapsed Correlation
metric (Σ|ACF|−1)/nlags, smoothed with a Gaussian kernel of σ=√N, and the
argmax gives numax.  The windows' ACFs are one batched FFT on the device
(:func:`.utils.autocorrelate_all`); the metric, its smoothing and the
argmax are host numpy.  The diagnostic plot draws with matplotlib,
imported inside the call.
"""
from __future__ import annotations

import numpy as np

from ..units import Quantity, uHz
from ..utils import _strip_quantity
from .utils import SeismologyQuantity, autocorrelate_all

__all__ = ["estimate_numax_acf2d", "diagnose_numax_acf2d"]


def _gaussian_smooth_extend(y, stddev):
    """astropy ``convolve(y, Gaussian1DKernel(stddev), boundary='extend')``:
    odd kernel of size 8·σ (rounded up to odd), edge-value padding."""
    size = int(8 * stddev + 0.5)
    size += 1 - size % 2
    x = np.arange(size) - size // 2
    k = np.exp(-0.5 * (x / stddev) ** 2)
    k /= k.sum()
    half = size // 2
    ypad = np.concatenate([np.full(half, y[0]), y, np.full(half, y[-1])])
    return np.convolve(ypad, k, mode="valid")


def estimate_numax_acf2d(periodogram, numaxs=None, window_width=None,
                         spacing=None):
    """Estimate numax from an SNR periodogram (reference ``:15-213``)."""
    if not periodogram._is_evenly_spaced():
        raise ValueError("the ACF 2D method requires that the periodogram "
                         "has a grid of uniformly spaced frequencies.")
    freq = periodogram.frequency
    funit = freq.unit
    to_native = uHz.to(funit)
    last_uhz = Quantity(freq.value[-1], funit).to(uHz).value
    if window_width is None:
        window_width = (250.0 if last_uhz > 500.0 else 25.0) * to_native
    if spacing is None:
        spacing = (10.0 if last_uhz > 500.0 else 1.0) * to_native
    window_width = float(Quantity(window_width, funit).value)
    spacing = float(Quantity(spacing, funit).value)

    if numaxs is None:
        numaxs = np.arange(
            np.ceil(np.nanmin(freq.value)) + window_width / 2,
            np.floor(np.nanmax(freq.value)) - window_width / 2,
            spacing)
    numaxs = np.atleast_1d(Quantity(numaxs, funit).value)

    fs = np.median(np.diff(freq.value))
    for var, label in zip([np.asarray(window_width), np.asarray(spacing)],
                          ["window_width", "spacing"]):
        if (var < fs).any():
            raise ValueError(f"You can't have {label} smaller than the "
                             "frequency separation!")
        if (var > (freq.value[-1] - freq.value[0])).any():
            raise ValueError(f"You can't have {label} wider than the entire "
                             "power spectrum!")
        if (var < 0).any():
            raise ValueError(f"Please pass an entirely positive {label}.")
    if any(numaxs < fs):
        raise ValueError("A custom range of numaxs can not extend below "
                         "a single frequency bin.")
    if any(numaxs > np.nanmax(freq.value)):
        raise ValueError("A custom range of numaxs can not extend above "
                         "the highest frequency value in the periodogram.")

    # one batched device call replaces the reference's per-center loop
    acf2d_rows, n_valid = autocorrelate_all(periodogram, numaxs,
                                            window_width=window_width,
                                            frequency_spacing=fs)
    metric = (np.sum(np.abs(acf2d_rows), axis=1) - 1) / n_valid
    acf2d = acf2d_rows.T     # (window, n_centers), reference layout

    if len(numaxs) > 10:
        metric_smooth = _gaussian_smooth_extend(metric,
                                                np.sqrt(len(numaxs)))
    else:
        metric_smooth = metric
    best_numax = Quantity(numaxs[np.argmax(metric_smooth)], funit)

    diagnostics = {"numaxs": numaxs, "acf2d": acf2d,
                   "window_width": window_width, "metric": metric,
                   "metric_smooth": metric_smooth}
    return SeismologyQuantity(best_numax, name="numax", method="ACF2D",
                              diagnostics=diagnostics,
                              diagnostics_plot_method=diagnose_numax_acf2d)


def diagnose_numax_acf2d(numax, periodogram=None, ax=None):
    """Diagnostic plot of the numax estimate (reference ``:216-324``)."""
    import matplotlib.pyplot as plt
    d = numax.diagnostics
    fig, axs = plt.subplots(3, sharex=True, figsize=(8.485, 10))
    if periodogram is not None:
        periodogram.plot(ax=axs[0], label="")
    numaxs = _strip_quantity(d["numaxs"])
    axs[1].imshow(_strip_quantity(d["acf2d"]), aspect="auto", origin="lower",
                  extent=[numaxs[0], numaxs[-1], 0, d["window_width"]])
    axs[1].set_ylabel("Frequency lag")
    axs[2].plot(numaxs, _strip_quantity(d["metric"]), label="MCC metric")
    axs[2].plot(numaxs, _strip_quantity(d["metric_smooth"]),
                label="smoothed")
    axs[2].axvline(float(numax.value), c="r", ls="--",
                   label=f"numax={float(numax.value):.1f}")
    axs[2].set_xlabel("Frequency")
    axs[2].legend()
    return axs
