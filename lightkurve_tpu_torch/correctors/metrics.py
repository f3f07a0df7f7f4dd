"""Goodness metrics for corrector validation.

The over-fitting half of ``lightkurve_tpu/correctors/metrics.py``:
:func:`overfit_metric_lombscargle`, the inverse sigmoid of the mean
positive Lomb-Scargle power increase normalised by the white-noise power
level (reference ``metrics.py:23-123``), on the port's Lomb-Scargle
periodograms.  The under-fitting metric downloads neighbouring targets
and is not ported.
"""
from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["overfit_metric_lombscargle"]


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
