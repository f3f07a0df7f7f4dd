"""Self-Flat-Fielding corrector for K2 roll systematics.

A copy of ``lightkurve_tpu/correctors/sffcorrector.py`` (the reference's
``correctors/sffcorrector.py``; Vanderburg & Johnson 2014): arclength
estimation, thruster-firing detection by a Gaussian fit to the histogram
of the arclength's acceleration (:func:`~lightkurve_tpu_torch.ops.peaks.
fit_gaussian_lm` on the configured device, in float64 as every solve of
the correctors), windows split at the firings,
and per-window arclength splines plus a long-term time spline solved by
:class:`RegressionCorrector`.  The diagnostic plots draw with matplotlib,
imported inside the call.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np

from ..units import Quantity
from ..utils import LightkurveWarning
from .designmatrix import (DesignMatrix, DesignMatrixCollection,
                           SparseDesignMatrixCollection, create_spline_matrix,
                           create_sparse_spline_matrix)
from .regressioncorrector import RegressionCorrector

log = logging.getLogger(__name__)

__all__ = ["SFFCorrector"]


class SFFCorrector(RegressionCorrector):
    """RegressionCorrector whose design matrix encodes centroid arclength
    (reference ``sffcorrector.py:28-298``)."""

    def __init__(self, lc):
        if lc.meta.get("MISSION", "") == "TESS":
            warnings.warn(
                "The SFF correction method is not suitable for use with TESS"
                " data, because the spacecraft motion does not proceed along"
                " a consistent arc.", LightkurveWarning)
        self.raw_lc = lc
        if str(lc.flux.unit) == "":
            lc = lc.copy()
        else:
            lc = lc.copy().normalize()
        self.window_points = None
        self.windows = None
        self.bins = None
        self.timescale = None
        self.breakindex = None
        self.arclength = None
        super().__init__(lc=lc)

    def __repr__(self):
        return f"SFFCorrector (LC: {self.lc.meta.get('TARGETID')})"

    def correct(self, centroid_col=None, centroid_row=None, windows=20,
                bins=5, timescale=1.5, breakindex=None, degree=3,
                restore_trend=False, additional_design_matrix=None,
                sparse=False, **kwargs):
        """Build the SFF design matrices and regress (reference ``:70-227``)."""
        DMC = SparseDesignMatrixCollection if sparse \
            else DesignMatrixCollection
        spline = create_sparse_spline_matrix if sparse \
            else create_spline_matrix

        # Drop NaN centroid cadences first, THEN read the columns, so both
        # arrays come from the same (final) light curve even when the NaNs
        # do not co-occur (reference #827, ``sffcorrector.py:144-149``).
        if centroid_col is None:
            self.lc = self.lc.remove_nans(column="centroid_col")
        if centroid_row is None:
            self.lc = self.lc.remove_nans(column="centroid_row")
        if centroid_col is None:
            centroid_col = self.lc["centroid_col"]
        if centroid_row is None:
            centroid_row = self.lc["centroid_row"]
        centroid_col = np.asarray(Quantity(centroid_col).value, float)
        centroid_row = np.asarray(Quantity(centroid_row).value, float)
        if np.any(~np.isfinite(centroid_col)) or \
                np.any(~np.isfinite(centroid_row)):
            raise ValueError("Centroids contain NaN values.")

        self.window_points = _get_window_points(centroid_col, centroid_row,
                                                windows,
                                                breakindex=breakindex)
        self.windows = windows
        self.bins = bins
        self.timescale = timescale
        self.breakindex = breakindex
        self.arclength = _estimate_arclength(centroid_col, centroid_row)

        lower_idx = np.asarray(np.append(0, self.window_points), int)
        upper_idx = np.asarray(np.append(self.window_points, len(self.lc)),
                               int)
        flux_val = self.lc.flux.value

        dms = []
        for idx, a, b in zip(range(len(lower_idx)), lower_idx, upper_idx):
            ar = np.copy(self.arclength)
            knots = list(np.percentile(ar[a:b],
                                       np.linspace(0, 100, bins + 1)[1:-1]))
            ar[~np.isin(ar, ar[a:b])] = 0
            dm = spline(ar, knots=knots, degree=degree).copy()
            dm.columns = [f"window{idx + 1}_bin{j + 1}"
                          for j in range(dm.shape[1])]
            # VERY weak priors on the motion vectors (reference :200-204)
            dm.prior_sigma = (np.ones(dm.shape[1]) * 10000
                              * np.std(flux_val[a:b]) + 1e-6)
            dms.append(dm)
        sff_dm = DMC(dms).to_designmatrix(name="sff")

        # long-term time spline with per-chunk mean priors (reference :206-216)
        tv = self.lc.time.value
        n_knots = max(int((tv[-1] - tv[0]) / timescale), degree + 1)
        s_dm = spline(tv, n_knots=n_knots, name="spline")
        means = [np.average(chunk)
                 for chunk in np.array_split(flux_val, n_knots)]
        s_dm.prior_mu = np.asarray(means)
        s_dm.prior_sigma = (np.ones(len(s_dm.prior_mu)) * 1000
                            * np.std(flux_val) + 1e-6)

        if additional_design_matrix is not None:
            if not isinstance(additional_design_matrix, DesignMatrix):
                raise ValueError("`additional_design_matrix` must be a "
                                 "DesignMatrix object.")
            self.additional_design_matrix = additional_design_matrix
            dm = DMC([s_dm, sff_dm, additional_design_matrix])
        else:
            dm = DMC([s_dm, sff_dm])

        clc = super().correct(dm, **kwargs)
        if restore_trend:
            trend = self.diagnostic_lightcurves["spline"].flux
            med = Quantity(np.nanmedian(trend.value), trend.unit)
            clc = clc + (trend - med)
        clc = clc * np.mean(self.raw_lc.flux.value)
        return clc

    def diagnose(self):
        """Diagnostic plots (reference ``sffcorrector.py:229-298``): the
        regression's, with the windows' edges marked."""
        axs = super().diagnose()
        windows = np.append(np.append(0, self.window_points), len(self.lc))
        tv = self.lc.time.value
        for ax in axs:
            for w in windows:
                ax.axvline(tv[min(int(w), len(self.lc) - 1)],
                           color="grey", ls="--", alpha=0.3)
        return axs

    def diagnose_arclength(self):
        """Flux against arclength (reference ``sffcorrector.py:300-348``)."""
        import matplotlib.pyplot as plt
        _, ax = plt.subplots()
        ax.scatter(self.arclength, self.lc.flux.value, s=1)
        ax.set_xlabel("Arclength")
        ax.set_ylabel("Flux")
        return ax


def _estimate_arclength(centroid_col, centroid_row):
    """arclength = sqrt(col² + row²) after min-subtraction, with the column
    axis flipped if col/row are anticorrelated (reference ``:494-513``)."""
    col = centroid_col - np.nanmin(centroid_col)
    row = centroid_row - np.nanmin(centroid_row)
    if np.all((col == 0) & (row == 0)):
        raise RuntimeError(
            "Arclength cannot be computed because there is no centroid "
            "motion. Make sure that the aperture of the TPF contains at "
            "least two pixels.")
    if np.polyfit(col, row, 1)[0] < 0:
        col = np.nanmax(col) - col
    return np.sqrt(col ** 2 + row ** 2)


def _get_thruster_firings(arclength):
    """Detect K2 thruster firings as outliers of d²(arclength)/dt²
    (reference ``sffcorrector.py:352-418``): fit a Gaussian to the histogram
    of accelerations, flag |a| > 5σ, and keep one cadence per cluster."""
    arc = np.copy(np.asarray(arclength, float))
    d2adt2 = np.gradient(np.gradient(arc))
    finite = np.isfinite(d2adt2)

    edges = np.arange(-0.5, 0.5, 0.0001)
    hist, bin_edges = np.histogram(d2adt2[finite], edges, density=True)
    xbins = bin_edges[1:] - np.median(np.diff(bin_edges))

    # Levenberg-Marquardt in place of scipy's curve_fit (the weights
    # mirror curve_fit's sigma=1/sqrt(hist): w = 1/sigma = sqrt(hist))
    try:
        from ..ops.peaks import fit_gaussian_lm
        from .regressioncorrector import _f64
        popt = fit_gaussian_lm(
            _f64(xbins), _f64(hist), _f64(np.sqrt(np.maximum(hist, 1e-12))),
            [100.0, 0.0, 0.01]).cpu().numpy()
        stddev = abs(float(popt[2]))
        if not np.isfinite(stddev) or stddev == 0.0:
            raise FloatingPointError("degenerate gaussian fit")
    except Exception:
        stddev = np.nanstd(d2adt2[finite])

    grad_arc = np.gradient(arc)

    def _start_and_end(which):
        if which == "start":
            thr = (d2adt2 < -5 * stddev) & finite
        else:
            thr = (d2adt2 > 5 * stddev) & finite
        # keep only the strongest |d(arc)| cadence within each cluster
        splits = np.where(np.gradient(thr.astype(int)) == 0)[0]
        idx_chunks = np.array_split(np.arange(len(thr)), splits)
        m_chunks = np.array_split(thr, splits)
        out = []
        for ids, m in zip(idx_chunks, m_chunks):
            if m.sum() == 0:
                out.append(m)
            else:
                out.append((np.abs(grad_arc[ids])
                            == np.abs(grad_arc[ids][m]).max()) & m)
        return np.hstack(out)

    thrusters = _start_and_end("start") | _start_and_end("end")
    # take just the first point of each firing
    thrusters = (np.gradient(thrusters.astype(int)) >= 0) & thrusters
    return thrusters


def _get_window_points(centroid_col, centroid_row, windows, arclength=None,
                       breakindex=None):
    """Window break indices snapped to thruster firings
    (reference ``sffcorrector.py:421-491``)."""
    if arclength is None:
        arclength = _estimate_arclength(centroid_col, centroid_row)
    if isinstance(breakindex, int):
        breakindexes = [breakindex]
    elif breakindex is None:
        breakindexes = []
    elif len(breakindex) == 1 and breakindex[0] == 0:
        breakindexes = []
    else:
        breakindexes = list(breakindex)
    if not isinstance(breakindexes, list):
        raise ValueError("`breakindex` must be an int or a list")
    if windows == 1:
        return breakindexes

    n = len(centroid_col)
    dt = n / windows
    lower = np.append(0, breakindexes)
    upper = np.append(breakindexes, n)
    window_points = np.hstack(
        [np.asarray(np.arange(a, b, dt), int)
         for a, b in zip(lower, upper)])

    thrusters = _get_thruster_firings(arclength)
    for b in breakindexes:
        thrusters[b] = True
    thrusters = np.where(thrusters)[0]

    if len(thrusters) > 0:
        window_points = [
            thrusters[np.argmin(np.abs(thrusters - wp))] + 1
            for wp in window_points if wp not in breakindexes]
    window_points = np.unique(np.hstack([window_points, breakindexes]))
    window_points = window_points[(window_points > 0)
                                  & (window_points < n)]
    if len(window_points) == 0:
        return np.asarray([], dtype=int)

    median_length = np.median(np.diff(window_points)) if \
        len(window_points) > 1 else n
    if window_points[0] < 0.4 * median_length:
        window_points = window_points[1:]
    if len(window_points) and window_points[-1] > (n - 0.4 * median_length):
        window_points = window_points[:-1]
    return np.asarray(window_points, dtype=int)
