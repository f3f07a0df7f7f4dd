"""Goodness metrics for corrector validation.

Counterpart of ``lightkurve_tpu/correctors/metrics.py``:

- :func:`overfit_metric_lombscargle`, the inverse sigmoid of the mean
  positive Lomb-Scargle power increase normalised by the white-noise
  power level (reference ``metrics.py:23-123``), on the port's
  Lomb-Scargle periodograms;
- :func:`underfit_metric_neighbors`, the inverse sigmoid of the scaled
  mean |correlation|³ between the corrected target and its neighbours'
  fluxes, calibrated against white-noise correlations (reference
  ``metrics.py:126-255``), given the neighbours' fluxes
  (``neighbor_flux``) or, without them, fetching the neighbours' SAP
  light curves through the archive search (a given or the ambient
  transport, e.g. :class:`~lightkurve_tpu_torch.mast_http.HTTPMASTTransport`,
  else the local archive scan) and aligning them by cadence number
  (:func:`_download_and_preprocess_neighbors`, host code).  The
  correlation matrix is one float64 product on
  :func:`config.resolve_device`: neighbour correlations of 1e-2 set the
  metric, which TF32 would move.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import config

log = logging.getLogger(__name__)

__all__ = ["overfit_metric_lombscargle", "underfit_metric_neighbors",
           "MinTargetsError"]


class MinTargetsError(Exception):
    """Raised when too few neighboring targets are found."""


def _sigmoid_inv(x):
    return 2.0 / (1 + np.exp(x))


def overfit_metric_lombscargle(original_lc, corrected_lc, n_samples=10,
                               seed=None):
    """Over-fitting metric in [0, 1]; 0.5 ⇔ introduced noise at the level of
    the flux uncertainties (reference ``metrics.py:23-123``)."""
    orig_lc = original_lc.copy().remove_nans().normalize() - 1.0
    corrected_lc = corrected_lc.copy().remove_nans().normalize() - 1.0
    if len(corrected_lc) == 0:
        return 1.0
    rng = np.random.default_rng(seed)

    metric_per_iter = []
    pg_orig = orig_lc.to_periodogram()
    pg_corr = corrected_lc.to_periodogram(frequency=pg_orig.frequency)
    pg_change_base = np.asarray(pg_corr.power.value) - np.asarray(
        pg_orig.power.value)
    n = len(orig_lc)
    mean_unc = np.nanmean(corrected_lc.flux_err.value)
    from ..lightcurve import LightCurve
    for _ in range(n_samples):
        wgn = rng.standard_normal(n) * mean_unc
        noise_lc = LightCurve(time=orig_lc.time, flux=wgn,
                              flux_err=np.zeros(n))
        pg_noise = noise_lc.to_periodogram()
        mean_noise_power = np.nanmean(np.asarray(pg_noise.power.value))

        pg_change = pg_change_base[~np.isnan(pg_change_base)]
        pos = pg_change > 0.0
        if pos.sum() == 0:
            metric_per_iter.append(0.0)
            continue
        denominator = pos.sum() * mean_noise_power
        if denominator == 0:
            metric_per_iter.append(np.inf)
        else:
            metric_per_iter.append(np.sum(pg_change[pos]) / denominator)
    metric = np.mean(metric_per_iter)
    return _sigmoid_inv(max(metric, 0.0))


def _compute_correlation(flux_matrix):
    """Target-to-target correlation matrix of the columns (reference
    ``metrics.py:451-476``): each column is scaled by its RMS (not
    mean-subtracted), then correlated by a normalised dot product, in
    float64 on :func:`config.resolve_device`."""
    X = torch.as_tensor(np.asarray(flux_matrix, dtype=float),
                        device=config.resolve_device())
    n_cadences = X.shape[0]
    rms = torch.sqrt(torch.sum(X ** 2.0, 0) / n_cadences)
    rms = torch.where(rms == 0.0, torch.inf, rms)
    unit_norm = X / rms
    return ((unit_norm.T @ unit_norm) / n_cadences).cpu().numpy()


def _align_to_lc(lc, ref_lc):
    """Align ``lc`` to ``ref_lc`` by cadence number (reference
    ``metrics.py:378-448``): cadences of ``ref_lc`` missing from ``lc``
    appear as NaN-flux rows, cadences not in ``ref_lc`` are dropped, and
    the result is sorted by ``cadenceno``."""
    from ..lightcurve import LightCurve
    from ..units import Quantity
    if not isinstance(lc, LightCurve):
        raise Exception("<lc> must be a LightCurve class")
    if not isinstance(ref_lc, LightCurve):
        raise Exception("<ref_lc> must be a LightCurve class")
    if "cadenceno" not in lc._cols or "cadenceno" not in ref_lc._cols:
        raise Exception("align requires cadence numbers for the "
                        "light curve. NO ALIGNMENT OCCURRED")
    cad = np.asarray(lc["cadenceno"])
    ref_cad = np.asarray(ref_lc["cadenceno"])
    aligned = lc[np.isin(cad, ref_cad)]
    missing = ~np.isin(ref_cad, cad)
    if missing.any():
        add = aligned[:0].copy()
        n = int(missing.sum())
        cols = {}
        for name, col in aligned._cols.items():
            if name == "time":
                cols[name] = ref_lc.time[missing]
            elif name == "cadenceno":
                cols[name] = ref_cad[missing]
            else:
                filler = np.full(n, np.nan)
                unit = getattr(col, "unit", None)
                cols[name] = (Quantity(filler, unit)
                              if unit is not None else filler)
        add._cols.update(cols)
        aligned = aligned.append(add)
    order = np.argsort(np.asarray(aligned["cadenceno"]))
    return aligned[order]


def underfit_metric_neighbors(corrected_lc, radius=6000, min_targets=30,
                              max_targets=50, interpolate=False,
                              extrapolate=False, quality_bitmask="default",
                              neighbor_flux=None, transport=None):
    """Under-fitting metric in [0, 1] (reference ``metrics.py:126-255``).

    ``neighbor_flux`` : optional list of flux arrays (already aligned to the
    corrected light curve's cadences).  When omitted, neighbors come from
    the archive search (:func:`_download_and_preprocess_neighbors`) —
    through ``transport`` (a
    :class:`~lightkurve_tpu_torch.mast.MASTTransport`) when given, else
    the ambient one (:func:`..mast.default_transport`), else the local
    archive scan.
    """
    corrected_lc = corrected_lc.copy().remove_nans().normalize() - 1.0
    flux = corrected_lc.flux.value

    if neighbor_flux is None:
        neighbor_flux = _download_and_preprocess_neighbors(
            corrected_lc, radius=radius, min_targets=min_targets,
            max_targets=max_targets, interpolate=interpolate,
            extrapolate=extrapolate, quality_bitmask=quality_bitmask,
            transport=transport)
    if len(neighbor_flux) < 1:
        raise MinTargetsError("No neighboring targets available")
    if not np.all([len(neighbor_flux[0]) == len(f) for f in neighbor_flux]):
        raise ValueError("Neighboring targets do not all have the same "
                         "shape")

    flux_matrix = np.zeros((len(neighbor_flux[0]), len(neighbor_flux) + 1))
    for i, f in enumerate(neighbor_flux):
        flux_matrix[:, i] = np.asarray(f)
    flux_matrix[:, -1] = flux

    mask = np.zeros(flux_matrix.shape[0], dtype=bool)
    for i in range(flux_matrix.shape[1]):
        mask |= np.isnan(flux_matrix[:, i])
    flux_matrix = flux_matrix[~mask, :]

    corr = _compute_correlation(flux_matrix)
    n_cad = flux_matrix.shape[0]
    beta = [0.0007, 0.8083, -0.5023]
    wgn_corr = beta[0] + beta[1] * n_cad ** beta[2]
    bad_limit = 0.95
    correlation_scale = 1 / wgn_corr * np.log((2.0 / bad_limit) - 1.0)
    corr = np.tril(corr, k=-1) + np.triu(corr, k=+1)
    correlation = correlation_scale * np.nanmean(np.abs(corr) ** 3, axis=0)
    return _sigmoid_inv(correlation[-1])


def _download_and_preprocess_neighbors(corrected_lc, radius=6000,
                                       min_targets=30, max_targets=50,
                                       interpolate=False, extrapolate=False,
                                       flux_column="sap_flux",
                                       quality_bitmask="default",
                                       transport=None):
    """Download neighboring SAP light curves and align them to
    ``corrected_lc`` (reference ``metrics.py:280-450``): the cone search
    around the target (nearest first, at most ``max_targets`` besides the
    target), each neighbour normalised less one and placed on the
    target's cadences by cadence number (NaN where it has none), or
    linearly interpolated in time with ``interpolate=True``."""
    from ..search import search_lightcurve
    target = corrected_lc.meta.get("TARGETID") or corrected_lc.meta.get(
        "LABEL")
    if target is None:
        raise MinTargetsError(
            "corrected_lc has no TARGETID; pass `neighbor_flux` explicitly")
    search = search_lightcurve(
        str(target), radius=radius,
        mission=corrected_lc.meta.get("MISSION"), limit=max_targets + 1,
        author=("Kepler", "K2", "SPOC"), transport=transport)
    if len(search) - 1 < min_targets:
        raise MinTargetsError(
            f"Only {max(len(search) - 1, 0)} neighbors found; "
            f"{min_targets} required")
    lcs = search.download_all(flux_column=flux_column,
                              quality_bitmask=quality_bitmask)
    out = []
    cadenceno = np.asarray(corrected_lc._cols.get(
        "cadenceno", np.arange(len(corrected_lc))))
    for lc in lcs:
        if str(lc.meta.get("TARGETID")) == str(target):
            continue
        lc = lc.remove_nans().normalize() - 1.0
        if interpolate:
            f = np.interp(corrected_lc.time.value, lc.time.value,
                          lc.flux.value,
                          left=np.nan if not extrapolate else None,
                          right=np.nan if not extrapolate else None)
        else:
            their = np.asarray(lc._cols.get("cadenceno",
                                            np.arange(len(lc))))
            f = np.full(len(cadenceno), np.nan)
            common, ia, ib = np.intersect1d(cadenceno, their,
                                            return_indices=True)
            f[ia] = lc.flux.value[ib]
        out.append(f)
    return out
