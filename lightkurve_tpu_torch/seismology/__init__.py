"""Asteroseismology (reference ``src/lightkurve/seismology/``).

Counterpart of ``lightkurve_tpu/seismology``: numax and Δν by the 2D ACF
(the windows' autocorrelations as one batched FFT on the device), the
scaling-relation estimators and the :class:`Seismology` dispatcher.
"""
from .utils import SeismologyQuantity, get_fwhm, autocorrelate
from .core import Seismology
from .numax_estimators import estimate_numax_acf2d
from .deltanu_estimators import estimate_deltanu_acf2d
from .stellar_estimators import (estimate_radius, estimate_mass,
                                 estimate_logg, NUMAX_SOL, DELTANU_SOL,
                                 TEFF_SOL)

__all__ = ["Seismology", "SeismologyQuantity", "get_fwhm", "autocorrelate",
           "estimate_numax_acf2d", "estimate_deltanu_acf2d",
           "estimate_radius", "estimate_mass", "estimate_logg"]
