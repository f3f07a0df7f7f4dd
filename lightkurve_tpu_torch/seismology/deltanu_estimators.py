"""Δν estimation via the ACF method.

Counterpart of ``lightkurve_tpu/seismology/deltanu_estimators.py``
(reference ``seismology/deltanu_estimators.py:18-144``): the ACF of a
2×FWHM window around numax (:func:`.utils.autocorrelate`, on the device)
is rescaled on the host, and of its peaks
(:func:`~lightkurve_tpu_torch.ops.peaks.find_peaks_mask` on
:func:`config.resolve_device`) the one nearest the empirical Stello et
al. (2009) relation Δν = 0.294·numax^0.772 is selected.  The diagnostic
plot draws with matplotlib, imported inside the call.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.peaks import find_peaks_mask
from ..units import Quantity, uHz
from ..utils import _strip_quantity
from .utils import SeismologyQuantity, autocorrelate, get_fwhm

__all__ = ["estimate_deltanu_acf2d", "diagnose_deltanu_acf2d"]


def estimate_deltanu_acf2d(periodogram, numax):
    """Estimate Δν given numax (reference ``:18-144``)."""
    if not periodogram._is_evenly_spaced():
        raise ValueError("the ACF 2D method requires that the periodogram "
                         "has a grid of uniformly spaced frequencies.")
    funit = periodogram.frequency.unit
    # collapse length-1 arrays to scalars so later float() casts are exact
    numax = Quantity(np.ravel(Quantity(numax, funit))[0], funit)
    freq_vals = periodogram.frequency.value
    fs = np.median(np.diff(freq_vals))
    if float(numax.value) < fs:
        raise ValueError("The input numax can not be lower than a single "
                         "frequency bin.")
    if float(numax.value) > np.nanmax(freq_vals):
        raise ValueError("The input numax can not be higher than the "
                         "highest frequency value in the periodogram.")

    # empirical deltanu (Stello et al. 2009), evaluated in microhertz space
    numax_uhz = Quantity(numax, funit).to(uHz).value
    deltanu_emp = Quantity(0.294 * float(numax_uhz) ** 0.772,
                           uHz).to(funit).value

    window_width = 2 * int(np.floor(get_fwhm(periodogram,
                                             float(numax.value))))
    aacf = autocorrelate(periodogram, numax=float(numax.value),
                         window_width=window_width)
    acf = (np.abs(aacf ** 2) / np.abs(aacf[0] ** 2)) / (3 / (2 * len(aacf)))
    lags = np.linspace(0.0, len(acf) * fs, len(acf))

    sel = (lags > deltanu_emp - 0.25 * deltanu_emp) & \
          (lags < deltanu_emp + 0.25 * deltanu_emp)
    # device local-max reduce + distance pruning (scipy.signal.find_peaks
    # semantics; reference deltanu_estimators.py:122)
    peak_mask = find_peaks_mask(
        torch.as_tensor(acf[sel], device=config.resolve_device()),
        np.floor(deltanu_emp / 2.0 / fs)).cpu().numpy()
    peaks = np.flatnonzero(peak_mask)
    if len(peaks) == 0:
        raise ValueError(
            "No Delta Nu peaks were detected near the empirical value "
            f"{deltanu_emp:.2f}; the spectrum may lack resolved modes.")
    best = lags[sel][peaks][np.argmin(np.abs(lags[sel][peaks]
                                             - deltanu_emp))]
    diagnostics = {"lags": lags, "acf": acf, "peaks": peaks, "sel": sel,
                   "numax": numax, "deltanu_emp": deltanu_emp}
    return SeismologyQuantity(Quantity(best, funit), name="deltanu",
                              method="ACF2D", diagnostics=diagnostics,
                              diagnostics_plot_method=diagnose_deltanu_acf2d)


def diagnose_deltanu_acf2d(deltanu, periodogram=None, ax=None):
    """Diagnostic plot (reference ``deltanu_estimators.py:147-312``)."""
    import matplotlib.pyplot as plt
    d = deltanu.diagnostics
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(_strip_quantity(d["lags"]), _strip_quantity(d["acf"]))
    ax.axvline(d["deltanu_emp"], c="grey", ls=":", label="empirical")
    ax.axvline(float(deltanu.value), c="r", ls="--",
               label=f"deltanu={float(deltanu.value):.2f}")
    ax.set_xlabel("Frequency lag")
    ax.set_ylabel("Scaled ACF")
    ax.legend()
    return ax
