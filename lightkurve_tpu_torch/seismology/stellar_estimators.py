"""Stellar parameter estimation via asteroseismic scaling relations.

A copy of ``lightkurve_tpu/seismology/stellar_estimators.py`` (reference
``seismology/stellar_estimators.py``), host numpy.
Solar reference values: NUMAX_SOL = 3090±30 µHz, DELTANU_SOL = 135.1±0.1
µHz (Huber et al. 2011), TEFF_SOL = 5772.0±0.8 K (Prša et al. 2016).
Error propagation uses first-order linearization (replacing the optional
``uncertainties`` package with explicit partial derivatives — the scaling
relations are pure power laws, so this is exact in log space).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from ..units import Quantity, uHz, K, solRad, solMass, dex, cm_per_s2
from .utils import SeismologyQuantity

__all__ = ["estimate_radius", "estimate_mass", "estimate_logg",
           "NUMAX_SOL", "DELTANU_SOL", "TEFF_SOL", "G_SOL"]

# (value, 1σ) pairs with ufloat-style .n/.s access (the reference stores
# these as `uncertainties.ufloat`; a namedtuple keeps tuple unpacking AND
# the .n/.s attribute API its tests rely on)
UFloat = namedtuple("UFloat", "n s")
NUMAX_SOL = UFloat(3090.0, 30.0)     # microhertz | Huber et al. 2011
DELTANU_SOL = UFloat(135.1, 0.1)     # microhertz | Huber et al. 2011
TEFF_SOL = UFloat(5772.0, 0.8)       # Kelvin     | Prsa et al. 2016
# G·Msun/Rsun² (solar surface gravity)
G_SOL = Quantity(27420.011165737313, cm_per_s2)


def _uval(x, unit):
    return float(np.atleast_1d(Quantity(x, unit).value)[0])


def _power_law(terms):
    """Evaluate prod((x_i/ref_i)^p_i) with linear error propagation.

    ``terms`` is a list of (value, err, ref_value, ref_err, power).
    Returns (value, err).
    """
    val = 1.0
    rel_var = 0.0
    for x, xe, r, re, p in terms:
        val *= (x / r) ** p
        rel_var += (p * xe / x) ** 2 + (p * re / r) ** 2
    return val, abs(val) * np.sqrt(rel_var)


def _prepare(numax, deltanu, teff, numax_err, deltanu_err, teff_err):
    """Reference semantics (``stellar_estimators.py:77-91``): input errors
    are used only when ALL are provided, otherwise treated as zero — but
    the solar reference uncertainties always propagate, so the returned
    error is never None."""
    numax = _uval(numax, uHz)
    deltanu = _uval(deltanu, uHz)
    teff = _uval(teff, K)
    if all(e is not None for e in (numax_err, deltanu_err, teff_err)):
        numax_err = _uval(numax_err, uHz)
        deltanu_err = _uval(deltanu_err, uHz)
        teff_err = _uval(teff_err, K)
    else:
        numax_err = deltanu_err = teff_err = 0.0
    return numax, deltanu, teff, numax_err, deltanu_err, teff_err


def estimate_radius(numax, deltanu, teff, numax_err=None, deltanu_err=None,
                    teff_err=None):
    """R/R☉ = (ν/ν☉)(Δν/Δν☉)⁻²(T/T☉)^0.5 (reference ``:21-104``)."""
    nu, dn, t, nue, dne, te = _prepare(
        numax, deltanu, teff, numax_err, deltanu_err, teff_err)
    val, err = _power_law([
        (nu, nue, *NUMAX_SOL, 1.0),
        (dn, dne, *DELTANU_SOL, -2.0),
        (t, te, *TEFF_SOL, 0.5)])
    return SeismologyQuantity(Quantity(val, solRad), name="radius",
                              error=Quantity(err, solRad),
                              method="Uncorrected Scaling Relations")


def estimate_mass(numax, deltanu, teff, numax_err=None, deltanu_err=None,
                  teff_err=None):
    """M/M☉ = (ν/ν☉)³(Δν/Δν☉)⁻⁴(T/T☉)^1.5 (reference ``:107-190``)."""
    nu, dn, t, nue, dne, te = _prepare(
        numax, deltanu, teff, numax_err, deltanu_err, teff_err)
    val, err = _power_law([
        (nu, nue, *NUMAX_SOL, 3.0),
        (dn, dne, *DELTANU_SOL, -4.0),
        (t, te, *TEFF_SOL, 1.5)])
    return SeismologyQuantity(Quantity(val, solMass), name="mass",
                              error=Quantity(err, solMass),
                              method="Uncorrected Scaling Relations")


def estimate_logg(numax, teff, numax_err=None, teff_err=None):
    """log₁₀ g with g/g☉ = (ν/ν☉)(T/T☉)^0.5 (reference ``:193-265``)."""
    numax = _uval(numax, uHz)
    teff = _uval(teff, K)
    have_err = numax_err is not None and teff_err is not None
    nue = _uval(numax_err, uHz) if have_err else 0.0
    te = _uval(teff_err, K) if have_err else 0.0
    g, g_err = _power_law([
        (numax, nue, *NUMAX_SOL, 1.0),
        (teff, te, *TEFF_SOL, 0.5)])
    g_sol = float(G_SOL.value)
    g = g * g_sol
    g_err = g_err * g_sol
    val = np.log10(g)
    err = g_err / (g * np.log(10))
    return SeismologyQuantity(Quantity(val, dex), name="logg",
                              error=Quantity(err, dex),
                              method="Uncorrected Scaling Relations")
