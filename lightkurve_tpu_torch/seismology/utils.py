"""Seismology helpers: SeismologyQuantity, FWHM rule, windowed ACF.

Counterpart of ``lightkurve_tpu/seismology/utils.py`` (reference
``seismology/utils.py``): the ``SeismologyQuantity`` result container
(``:10-59``), the mode-envelope FWHM rule (``:96-103``) and the windowed
autocorrelation (``:106-154``), whose windows at every centre go through
one batched FFT (:func:`~lightkurve_tpu_torch.ops.acf.
autocorrelate_windows`) in :data:`config.default_dtype` on
:func:`config.resolve_device`.  The window arithmetic (``spread``,
``starts``) is the reference's, on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..units import Quantity, uHz

__all__ = ["SeismologyQuantity", "get_fwhm", "autocorrelate",
           "autocorrelate_all"]


class SeismologyQuantity(Quantity):
    """A Quantity with seismology metadata: name, error, method,
    diagnostics dict and a plot hook (reference ``utils.py:10-59``)."""

    def __new__(cls, quantity, name=None, error=None, method=None,
                diagnostics=None, diagnostics_plot_method=None):
        if isinstance(quantity, Quantity):
            obj = np.asarray(quantity.value, dtype=float).view(cls)
            obj._unit = quantity.unit
        else:
            obj = np.asarray(quantity, dtype=float).view(cls)
            from ..units import dimensionless
            obj._unit = dimensionless
        obj.name = name
        obj.error = error
        obj.method = method
        obj.diagnostics = diagnostics
        obj.diagnostics_plot_method = diagnostics_plot_method
        return obj

    def __repr__(self):
        try:
            return f"{self.name}: {float(self.value):.2f} {self.unit} " \
                f"(method: {self.method})"
        except Exception:
            return super().__repr__()

    def plot_diagnostics(self, **kwargs):
        if self.diagnostics_plot_method is None:
            raise ValueError("No diagnostics plot method is available.")
        return self.diagnostics_plot_method(self, **kwargs)


def get_fwhm(periodogram, numax):
    """FWHM of the seismic mode envelope at ``numax``
    (reference ``utils.py:82-103``): 0.25·numax for high-Nyquist (SC) data,
    0.66·numax^0.88 otherwise (Mosser et al. 2010)."""
    freqs = periodogram.frequency
    last_uhz = Quantity(np.atleast_1d(freqs.value)[-1],
                        freqs.unit).to(uHz).value
    if last_uhz > 500.0:
        return 0.25 * numax
    return 0.66 * numax ** 0.88


def autocorrelate(periodogram, numax, window_width=25.0,
                  frequency_spacing=None):
    """Zero-mean ACF of a window of the power spectrum centred at ``numax``
    (reference ``utils.py:106-154``).  Single-center convenience around the
    batched kernel."""
    acf, n_valid = autocorrelate_all(periodogram, np.atleast_1d(numax),
                                     window_width, frequency_spacing)
    return acf[0][: int(n_valid[0])]


def autocorrelate_all(periodogram, numaxs, window_width=25.0,
                      frequency_spacing=None):
    """Batched windowed ACF over many candidate numax centers — the "2D ACF"
    as one device call.  Returns host arrays (acf (c, W), n_valid (c,))."""
    from ..ops.acf import autocorrelate_windows

    freq = periodogram.frequency.value
    power = periodogram.power.value
    if frequency_spacing is None:
        frequency_spacing = np.median(np.diff(freq))
    spread = int(window_width / 2 / frequency_spacing)
    x0 = int(freq[0] / frequency_spacing)
    starts = (np.asarray(numaxs, dtype=float)
              / frequency_spacing).astype(int) - x0 - spread
    window = 2 * spread
    device = config.resolve_device()
    acf, n_valid = autocorrelate_windows(
        torch.as_tensor(np.asarray(power), dtype=config.default_dtype,
                        device=device),
        torch.as_tensor(starts, device=device), window)
    return acf.cpu().numpy().astype(float), n_valid.cpu().numpy()
