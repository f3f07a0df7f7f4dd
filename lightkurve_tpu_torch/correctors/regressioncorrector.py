"""RegressionCorrector: Bayesian ridge regression against design matrices.

Counterpart of ``lightkurve_tpu/correctors/regressioncorrector.py`` (the
reference's ``correctors/regressioncorrector.py``).  The fit loop,
``niters`` weighted ridge solves each followed by a sigma clip of the
residuals (reference ``:243-273``), is
:func:`lightkurve_tpu_torch.ops.solve.iterative_clipped_regression`: fixed
iterations, masks in place of row deletion, on :func:`config.resolve_device`
(the card unless the configuration says ``"cpu"``).  The solves run in
float64 whatever :data:`config.default_dtype` says (ROADMAP C4: in float32
the normal equations of a sector's design matrix move the corrected flux
by a fair part of a 400-ppm transit).  The diagnostic plots draw with
matplotlib, imported inside the call.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ..lightcurve import LightCurve, _tensor
from ..units import Quantity
from .corrector import Corrector
from .designmatrix import (DesignMatrix, DesignMatrixCollection,
                           SparseDesignMatrix, SparseDesignMatrixCollection)

log = logging.getLogger(__name__)

__all__ = ["RegressionCorrector"]


def _f64(x):
    """A host array as a float64 tensor on the configured device: the
    solves' dtype whatever the configuration's (ROADMAP C4)."""
    return _tensor(x, torch.float64)


def _host(x):
    """A tensor back as a float64 host array."""
    return x.cpu().numpy().astype(np.float64)


class RegressionCorrector(Corrector):
    """Remove noise via linear regression against a design matrix.

    Given flux errors σ and priors N(μ, σ_w), solves
    ``w = (XᵀΣ⁻¹X + diag(1/σ_w²))⁻¹ (XᵀΣ⁻¹y + μ/σ_w²)`` with iterative
    outlier rejection (reference ``regressioncorrector.py:31-309``).
    """

    def __init__(self, lc):
        if np.any(~np.isfinite(lc.time.value)) or \
                np.any(~np.isfinite(lc.flux.value)):
            raise ValueError(
                "Input light curve has NaNs in time or flux. Please remove "
                "NaNs before correction (e.g. using `lc = lc.remove_nans()`).")
        fe = lc.flux_err.value
        if np.any(~np.isfinite(fe)) and not np.all(~np.isfinite(fe)):
            raise ValueError(
                "Input light curve has NaNs in `flux_err`. Please remove "
                "NaNs before correction (e.g. using `lc = lc.remove_nans()`).")
        if np.any(fe[np.isfinite(fe)] <= 0):
            raise ValueError(
                "Input light curve contains flux uncertainties smaller than "
                "or equal to zero. Please remove these (e.g. using "
                "`lc = lc[lc.flux_err > 0]`).")
        self.lc = lc
        self.original_lc = lc
        self.design_matrix_collection = None
        self.coefficients = None
        self.coefficients_err = None
        self.corrected_lc = None
        self.model_lc = None
        self.diagnostic_lightcurves = None
        self.cadence_mask = None
        self.outlier_mask = None

    def __repr__(self):
        return f"RegressionCorrector (ID: {self.lc.meta.get('TARGETID')})"

    @property
    def dmc(self):
        return self.design_matrix_collection

    def _numpy_inputs(self, cadence_mask):
        X = self.dmc.X.astype(np.float64)
        y = self.lc.flux.value.astype(np.float64)
        fe = self.lc.flux_err.value.astype(np.float64)
        if np.all(~np.isfinite(fe)):
            fe = np.ones_like(y)
        return X, y, fe

    def _fit_coefficients(self, cadence_mask=None, prior_mu=None,
                          prior_sigma=None, propagate_errors=False):
        """One weighted ridge solve (reference ``:127-189``)."""
        from ..ops.solve import solve_regression
        if (prior_mu is None) != (prior_sigma is None):
            raise ValueError("Please specify both `prior_mu` and "
                             "`prior_sigma`")
        if cadence_mask is None:
            cadence_mask = np.ones(len(self.lc), bool)
        X, y, fe = self._numpy_inputs(cadence_mask)
        w, sigma_w_inv = solve_regression(
            _f64(X), _f64(y), _f64(fe),
            _tensor(np.asarray(cadence_mask), torch.bool),
            None if prior_mu is None else _f64(prior_mu),
            None if prior_sigma is None else _f64(prior_sigma))
        w = _host(w)
        if propagate_errors:
            w_err = np.linalg.inv(_host(sigma_w_inv))
        else:
            w_err = np.full(len(w), np.nan)
        return w, w_err

    def correct(self, design_matrix_collection, cadence_mask=None, sigma=5,
                niters=5, propagate_errors=False, seed=None):
        """Find and subtract the best-fit noise model
        (reference ``:191-309``).

        ``seed`` (extension, SURVEY §7f RNG policy): seeds the
        coefficient-posterior sampling used when ``propagate_errors=True``
        (100 multivariate-normal draws, as in the reference); no global
        ``np.random`` state is touched.
        """
        from ..ops.solve import iterative_clipped_regression

        if not isinstance(design_matrix_collection, DesignMatrixCollection):
            if isinstance(design_matrix_collection, SparseDesignMatrix):
                design_matrix_collection = SparseDesignMatrixCollection(
                    [design_matrix_collection])
            elif isinstance(design_matrix_collection, DesignMatrix):
                design_matrix_collection = DesignMatrixCollection(
                    [design_matrix_collection])
        design_matrix_collection.validate()
        self.design_matrix_collection = design_matrix_collection

        if cadence_mask is None:
            self.cadence_mask = np.ones(len(self.lc), bool)
        else:
            self.cadence_mask = np.asarray(cadence_mask, bool)

        X, y, fe = self._numpy_inputs(self.cadence_mask)
        prior_mu = self.dmc.prior_mu.astype(np.float64)
        prior_sigma = self.dmc.prior_sigma.astype(np.float64)

        w, final_mask, sigma_w_inv = iterative_clipped_regression(
            _f64(X), _f64(y), _f64(fe),
            _tensor(self.cadence_mask, torch.bool), _f64(prior_mu),
            _f64(prior_sigma), sigma=float(sigma), niters=int(niters))
        coefficients = _host(w)
        self.outlier_mask = self.cadence_mask & ~final_mask.cpu().numpy()
        self.coefficients = coefficients
        if propagate_errors:
            self.coefficients_err = np.linalg.inv(_host(sigma_w_inv))
        else:
            self.coefficients_err = np.full(len(coefficients), np.nan)

        model_flux = X @ coefficients
        model_flux -= np.median(model_flux)
        if propagate_errors:
            rng = np.random.default_rng(seed)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                samples = np.asarray([
                    X @ rng.multivariate_normal(coefficients,
                                                self.coefficients_err)
                    for _ in range(100)]).T
            model_err = np.abs(
                np.percentile(samples, [16, 84], axis=1)
                - np.median(samples, axis=1)[:, None].T).mean(axis=0)
        else:
            model_err = np.zeros(len(model_flux))
        self.model_lc = LightCurve(
            time=self.lc.time.copy(),
            flux=Quantity(model_flux, self.lc.flux.unit),
            flux_err=Quantity(model_err, self.lc.flux.unit))
        self.corrected_lc = self.lc.copy()
        self.corrected_lc.flux = self.lc.flux - self.model_lc.flux
        self.corrected_lc.flux_err = Quantity(
            np.sqrt(self.lc.flux_err.value ** 2 + model_err ** 2),
            self.lc.flux.unit)
        self.diagnostic_lightcurves = self._create_diagnostic_lightcurves()
        return self.corrected_lc

    def _create_diagnostic_lightcurves(self):
        """Per-submatrix model light curves (reference ``:311-342``)."""
        if self.coefficients is None:
            raise ValueError("you need to call `correct()` first")
        lcs = {}
        first = 0
        for submatrix in self.dmc.matrices:
            k = submatrix.shape[1]
            sub_w = self.coefficients[first:first + k]
            first += k
            model_flux = submatrix.X @ sub_w
            lcs[submatrix.name] = LightCurve(
                time=self.lc.time.copy(),
                flux=Quantity(model_flux, self.lc.flux.unit),
                flux_err=Quantity(np.zeros(len(model_flux)),
                                  self.lc.flux.unit),
                meta={"LABEL": submatrix.name})
        return lcs

    def diagnose_priors(self):
        """Plot each design matrix's coefficient priors with the fitted
        coefficients overlaid (reference ``regressioncorrector.py:393-427``).
        Requires a prior call to :meth:`correct`."""
        import matplotlib.pyplot as plt
        if self.coefficients is None:
            raise ValueError("Please call the `correct()` method before "
                             "trying to diagnose.")
        matrices = list(self.dmc.matrices)
        _, axs = plt.subplots(1, len(matrices),
                              figsize=(len(matrices) * 4, 4), sharey=True)
        if not hasattr(axs, "__iter__"):
            axs = [axs]
        first = 0
        for ax, X in zip(axs, matrices):
            X.plot_priors(ax=ax)
            for c in self.coefficients[first:first + X.shape[1]]:
                ax.axvline(c, color="red", zorder=-1)
            first += X.shape[1]
        return axs

    def diagnose(self):
        """Diagnostic plot of the fit (reference ``:344-425``)."""
        import matplotlib.pyplot as plt
        if self.coefficients is None:
            raise ValueError("You need to call the `correct()` method first.")
        _, axs = plt.subplots(2, figsize=(10, 6), sharex=True)
        ax = axs[0]
        self.lc.plot(ax=ax, normalize=False, label="original", alpha=0.4)
        med = Quantity(np.median(self.lc.flux.value), self.lc.flux.unit)
        for key, lc in self.diagnostic_lightcurves.items():
            (lc + med).plot(ax=ax)
        ax = axs[1]
        self.corrected_lc.plot(ax=ax, normalize=False, label="corrected",
                               alpha=0.4)
        self.corrected_lc[self.outlier_mask].scatter(
            ax=ax, label="outlier_mask", marker="x", s=10, c="r")
        self.corrected_lc[~self.cadence_mask].scatter(
            ax=ax, label="~cadence_mask", marker="x", s=10, c="grey")
        return axs
