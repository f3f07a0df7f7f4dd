"""Pixel Level Decorrelation corrector.

A copy of ``lightkurve_tpu/correctors/pldcorrector.py`` (the reference's
``correctors/pldcorrector.py``; Deming et al. 2015, Luger et al.
2016/2018): design matrix = [PLD pixel series (flux-normalised pixels,
multichoose products to ``pld_order``, PCA-reduced), PCA'd background
pixels, time spline + constant], solved by :class:`RegressionCorrector`.
The PCA (``ops.solve.randomized_pca``) and the solves run on the
configured device.  ``diagnose`` and ``diagnose_masks`` draw with
matplotlib, imported inside the call.
"""
from __future__ import annotations

import logging
from itertools import combinations_with_replacement

import numpy as np

from .designmatrix import (DesignMatrix, DesignMatrixCollection,
                           SparseDesignMatrixCollection, create_spline_matrix,
                           create_sparse_spline_matrix)
from .regressioncorrector import RegressionCorrector

log = logging.getLogger(__name__)

__all__ = ["PLDCorrector"]


class PLDCorrector(RegressionCorrector):
    """Implements PLD systematics removal for a TargetPixelFile
    (reference ``pldcorrector.py:37-570``)."""

    def __init__(self, tpf, aperture_mask=None):
        if aperture_mask is None:
            aperture_mask = tpf.create_threshold_mask(3)
        self.aperture_mask = aperture_mask
        lc = tpf.to_lightcurve(aperture_mask=aperture_mask)
        nan_mask = np.isnan(lc.flux.value) | np.isnan(lc.flux_err.value)
        lc = lc[~nan_mask]
        self.tpf = tpf[~nan_mask]
        super().__init__(lc=lc)

    def __repr__(self):
        return f"PLDCorrector (ID: {self.lc.meta.get('LABEL')})"

    def create_design_matrix(self, pld_order=3, pca_components=16,
                             pld_aperture_mask=None,
                             background_aperture_mask="background",
                             spline_n_knots=None, spline_degree=3,
                             normalize_background_pixels=None, sparse=False):
        """Build the PLD DesignMatrixCollection
        (reference ``pldcorrector.py:125-287``)."""
        pld_aperture_mask = self.tpf._parse_aperture_mask(pld_aperture_mask)
        self.pld_aperture_mask = pld_aperture_mask
        background_aperture_mask = self.tpf._parse_aperture_mask(
            background_aperture_mask)
        self.background_aperture_mask = background_aperture_mask

        if spline_n_knots is None:
            spline_n_knots = max(int(len(self.lc) / 50), spline_degree + 1)
        DMC = SparseDesignMatrixCollection if sparse \
            else DesignMatrixCollection
        spline = create_sparse_spline_matrix if sparse \
            else create_spline_matrix

        prior_sigma = np.nanstd(self.lc.flux.value) * 10

        flux_cube = np.asarray(self.tpf.flux.value
                               if hasattr(self.tpf.flux, "value")
                               else self.tpf.flux, float)
        nt = flux_cube.shape[0]
        dm_bkg = None
        if np.sum(background_aperture_mask) > 0:
            bkg_pixels = flux_cube[:, background_aperture_mask].reshape(
                nt, -1)
            if normalize_background_pixels:
                bkg_flux = np.nansum(bkg_pixels, -1)
                bkg_pixels = bkg_pixels / bkg_flux[:, None]
            # drop pixels with NaNs (reference keeps only finite entries per
            # row; with NaN-free cadences this equals dropping all-NaN pixel
            # columns)
            good = np.isfinite(bkg_pixels).all(axis=0)
            bkg_pixels = bkg_pixels[:, good]
            if bkg_pixels.shape[1] > 0:
                dm_bkg = DesignMatrix(bkg_pixels, name="background")
                dm_bkg = dm_bkg.pca(pca_components)
                dm_bkg.prior_sigma = np.ones(dm_bkg.shape[1]) * prior_sigma

        dm_spline = spline(self.lc.time.value, n_knots=spline_n_knots,
                           degree=spline_degree).append_constant()
        dm_spline.prior_sigma = np.ones(dm_spline.shape[1]) * prior_sigma

        if np.sum(pld_aperture_mask) != 0:
            pld_pixels = flux_cube[:, pld_aperture_mask].reshape(nt, -1)
            pld_pixels = pld_pixels / self.lc.flux.value[:, None]
            good = np.isfinite(pld_pixels).all(axis=0)
            pld_pixels = pld_pixels[:, good]

            regressors_dm = DesignMatrix(pld_pixels)
            if pca_components > 0:
                regressors_dm = regressors_dm.pca(pca_components)
            regressors_pld = regressors_dm.values

            all_pld = []
            for order in range(1, pld_order + 1):
                # multichoose: products of column combinations w/ replacement
                reg_n = np.stack(
                    [np.prod(np.stack(c, axis=1), axis=1)
                     for c in combinations_with_replacement(
                         regressors_pld.T, order)], axis=1)
                pld_n = DesignMatrix(
                    reg_n,
                    prior_sigma=np.ones(reg_n.shape[1]) * prior_sigma
                    / reg_n.shape[1],
                    name=f"pld_order_{order}")
                if pca_components > 0:
                    pld_n = pld_n.pca(pca_components)
                    pld_n.prior_sigma = (np.ones(pld_n.shape[1])
                                         * prior_sigma / pca_components)
                all_pld.append(pld_n)

            dm_pixels = DesignMatrixCollection(all_pld).to_designmatrix(
                name="pixel_series")
            dms = [dm_pixels, dm_bkg, dm_spline]
        else:
            dms = [dm_bkg, dm_spline]
        return DMC([d for d in dms if d is not None])

    def correct(self, pld_order=None, pca_components=None,
                pld_aperture_mask=None,
                background_aperture_mask="background", spline_n_knots=None,
                spline_degree=5, normalize_background_pixels=None,
                restore_trend=True, sparse=False, cadence_mask=None,
                sigma=5, niters=5, propagate_errors=False):
        """Correct with mission-specific defaults
        (reference ``pldcorrector.py:304-427``): K2 → order 3 / 16 PCA terms
        / threshold mask; TESS & others → order 1 / 3 / empty mask."""
        self.restore_trend = restore_trend
        is_k2 = self.tpf.meta.get("MISSION") == "K2"
        if pld_order is None:
            pld_order = 3 if is_k2 else 1
        if pca_components is None:
            pca_components = 16 if is_k2 else 3
        if pld_aperture_mask is None:
            pld_aperture_mask = "threshold" if is_k2 else "empty"
        if normalize_background_pixels is None:
            normalize_background_pixels = is_k2

        dm = self.create_design_matrix(
            pld_aperture_mask=pld_aperture_mask,
            background_aperture_mask=background_aperture_mask,
            pld_order=pld_order, pca_components=pca_components,
            spline_n_knots=spline_n_knots, spline_degree=spline_degree,
            normalize_background_pixels=normalize_background_pixels,
            sparse=sparse)
        clc = super().correct(dm, cadence_mask=cadence_mask, sigma=sigma,
                              niters=niters,
                              propagate_errors=propagate_errors)
        if restore_trend:
            from ..units import Quantity
            spline_lc = self.diagnostic_lightcurves["spline"]
            med = Quantity(np.median(spline_lc.flux.value),
                           spline_lc.flux.unit)
            clc = clc + (spline_lc - med)
        return clc

    def diagnose(self):
        """Diagnostic plot (reference ``pldcorrector.py:429-470``)."""
        if self.corrected_lc is None:
            raise ValueError("You need to call the `correct()` method first.")
        return super().diagnose()

    def diagnose_masks(self):
        """Plot the pld/background aperture masks
        (reference ``pldcorrector.py:472-509``)."""
        import matplotlib.pyplot as plt
        from ..utils import _strip_quantity
        if getattr(self, "pld_aperture_mask", None) is None:
            raise ValueError("You need to call the `correct()` method first.")
        _, axs = plt.subplots(1, 3, figsize=(12, 3))
        img = np.nanmedian(_strip_quantity(self.tpf.flux), axis=0)
        for ax, mask, title in zip(
                axs, [self.aperture_mask, self.pld_aperture_mask,
                      self.background_aperture_mask],
                ["aperture", "pld_aperture", "background_aperture"]):
            ax.imshow(img, origin="lower")
            ax.imshow(np.ma.masked_where(~mask, mask), origin="lower",
                      alpha=0.5, cmap="Reds")
            ax.set_title(title)
        return axs
