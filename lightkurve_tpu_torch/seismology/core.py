"""Seismology butler: estimate numax, Δν, radius, mass, logg.

Counterpart of ``lightkurve_tpu/seismology/core.py`` (reference
``seismology/core.py``): the method dispatch, the result tray and the
echelle diagram's data (the spectrum folded at Δν, host numpy), its
plots (``plot_echelle``, ``diagnose_*``, ``interact_echelle``'s static
panels; matplotlib imported inside the call) and
``interact_echelle(html=…)``'s standalone page.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np

from ..periodogram import SNRPeriodogram
from ..units import Quantity
from ..utils import LightkurveWarning, validate_method
from .utils import SeismologyQuantity, get_fwhm
from .numax_estimators import estimate_numax_acf2d
from .deltanu_estimators import estimate_deltanu_acf2d
from .stellar_estimators import estimate_radius, estimate_mass, estimate_logg

log = logging.getLogger(__name__)

__all__ = ["Seismology"]


class Seismology:
    """Enables asteroseismic quantities to be estimated from periodograms
    (reference ``seismology/core.py:37-920``)."""

    def __init__(self, periodogram):
        if not isinstance(periodogram, SNRPeriodogram):
            warnings.warn(
                "Seismology received a periodogram which does not appear to "
                "have been background-corrected. Please consider calling "
                "`periodogram.flatten()` prior to extracting seismological "
                "parameters.", LightkurveWarning)
        self.periodogram = periodogram

    def __repr__(self):
        attrs = ["numax", "deltanu", "mass", "radius", "logg"]
        have = [a for a in attrs if hasattr(self, a)]
        if not have:
            tray = " - no values have been computed so far."
        else:
            tray = " - computed values:\n * " + "\n * ".join(
                repr(getattr(self, a)) for a in have)
        return f"Seismology(ID: {self.periodogram.label}){tray}"

    @staticmethod
    def from_lightcurve(lc, **kwargs):
        log.info("Building a Seismology object directly from a light curve "
                 "uses default periodogram parameters. For further "
                 "tuneability, create a periodogram object first, using "
                 "`to_periodogram`.")
        return Seismology(periodogram=lc.normalize().remove_nans()
                          .fill_gaps().to_periodogram(**kwargs).flatten())

    def _validate_numax(self, numax):
        if numax is None:
            try:
                return self.numax
            except AttributeError:
                raise AttributeError("You need to call "
                                     "`Seismology.estimate_numax()` first.")
        return numax

    def _validate_deltanu(self, deltanu):
        if deltanu is None:
            try:
                return self.deltanu
            except AttributeError:
                raise AttributeError("You need to call "
                                     "`Seismology.estimate_deltanu()` first.")
        return deltanu

    # -- estimators -----------------------------------------------------------
    def estimate_numax(self, method="acf2d", **kwargs):
        """Estimate the frequency of maximum power (reference ``:597-650``)."""
        method = validate_method(method, supported_methods=["acf2d"])
        self.numax = estimate_numax_acf2d(self.periodogram, **kwargs)
        return self.numax

    def estimate_deltanu(self, method="acf2d", numax=None):
        """Estimate the large frequency spacing (reference ``:676-736``)."""
        method = validate_method(method, supported_methods=["acf2d"])
        numax = self._validate_numax(numax)
        self.deltanu = estimate_deltanu_acf2d(self.periodogram, numax=numax)
        return self.deltanu

    def diagnose_numax(self, numax=None):
        """Diagnostic plot of the numax estimate (reference ``:652-674``).
        Requires ``estimate_numax()`` to have been called first (or an
        explicit ``numax`` estimate to be passed in)."""
        numax = self._validate_numax(numax)
        return numax.diagnostics_plot_method(numax, self.periodogram)

    def diagnose_deltanu(self, deltanu=None):
        """Diagnostic plot of the deltanu estimate (reference ``:738-758``).
        Requires ``estimate_deltanu()`` to have been called first (or an
        explicit ``deltanu`` estimate to be passed in)."""
        deltanu = self._validate_deltanu(deltanu)
        return deltanu.diagnostics_plot_method(deltanu, self.periodogram)

    def estimate_radius(self, teff=None, numax=None, deltanu=None,
                        teff_err=None, numax_err=None, deltanu_err=None):
        """Stellar radius from scaling relations (reference ``:760-812``)."""
        numax = self._validate_numax(numax)
        deltanu = self._validate_deltanu(deltanu)
        teff = self._teff(teff)
        if numax_err is None:
            numax_err = getattr(numax, "error", None)
        if deltanu_err is None:
            deltanu_err = getattr(deltanu, "error", None)
        self.radius = estimate_radius(numax, deltanu, teff,
                                      numax_err=numax_err,
                                      deltanu_err=deltanu_err,
                                      teff_err=teff_err)
        return self.radius

    def estimate_mass(self, teff=None, numax=None, deltanu=None,
                      teff_err=None, numax_err=None, deltanu_err=None):
        """Stellar mass from scaling relations (reference ``:814-866``)."""
        numax = self._validate_numax(numax)
        deltanu = self._validate_deltanu(deltanu)
        teff = self._teff(teff)
        if numax_err is None:
            numax_err = getattr(numax, "error", None)
        if deltanu_err is None:
            deltanu_err = getattr(deltanu, "error", None)
        self.mass = estimate_mass(numax, deltanu, teff, numax_err=numax_err,
                                  deltanu_err=deltanu_err, teff_err=teff_err)
        return self.mass

    def estimate_logg(self, teff=None, numax=None, teff_err=None,
                      numax_err=None):
        """Surface gravity from scaling relations (reference ``:868-918``)."""
        numax = self._validate_numax(numax)
        teff = self._teff(teff)
        if numax_err is None:
            numax_err = getattr(numax, "error", None)
        self.logg = estimate_logg(numax, teff, numax_err=numax_err,
                                  teff_err=teff_err)
        return self.logg

    def _teff(self, teff):
        if teff is None:
            teff = self.periodogram.meta.get("TEFF")
            if teff is None:
                raise ValueError(
                    "You must provide an effective temperature `teff`, "
                    "because the metadata does not contain one.")
        return teff

    # -- echelle ---------------------------------------------------------------
    def _clean_echelle(self, deltanu=None, numax=None,
                       minimum_frequency=None, maximum_frequency=None,
                       smooth_filter_width=0.1, scale="linear"):
        """Build the folded power image (reference ``core.py:134-320``)."""
        if minimum_frequency is None and maximum_frequency is None:
            numax = self._validate_numax(numax)
        deltanu = self._validate_deltanu(deltanu)
        deltanu_v = float(Quantity(deltanu,
                                   self.periodogram.frequency.unit).value)
        if smooth_filter_width:
            pg = self.periodogram.smooth(filter_width=smooth_filter_width)
        else:
            pg = self.periodogram
        freq = pg.frequency.value
        power = pg.power.value
        fmin, fmax = freq[0], freq[-1]
        if numax is not None and (minimum_frequency is not None
                                  or maximum_frequency is not None):
            warnings.warn("You have passed both a numax and a frequency "
                          "limit. The frequency limit will override the "
                          "numax input.", LightkurveWarning)
        if numax is not None and minimum_frequency is None and \
                maximum_frequency is None:
            numax_v = float(Quantity(numax,
                                     self.periodogram.frequency.unit).value)
            fwhm = get_fwhm(self.periodogram, numax_v)
            fmin = max(numax_v - 2 * fwhm, fmin)
            fmax = min(numax_v + 2 * fwhm, fmax)
        if minimum_frequency is not None:
            fmin = float(Quantity(minimum_frequency,
                                  self.periodogram.frequency.unit).value)
        if maximum_frequency is not None:
            fmax = float(Quantity(maximum_frequency,
                                  self.periodogram.frequency.unit).value)
        if fmin > freq[-1] or fmax > freq[-1] + deltanu_v:
            raise ValueError("You can't pass a frequency limit above the "
                             "periodogram's maximum frequency.")

        fs = np.median(np.diff(freq))
        # fold: rows of length deltanu
        n_rows = int((fmax - fmin) / deltanu_v)
        n_cols = int(deltanu_v / fs)
        if n_rows < 1 or n_cols < 1:
            raise ValueError("deltanu is too small to produce an echelle "
                             "diagram on this grid.")
        start = np.argmin(np.abs(freq - fmin))
        ep = np.zeros((n_rows, n_cols))
        for r in range(n_rows):
            lo = start + r * n_cols
            seg = power[lo: lo + n_cols]
            ep[r, :len(seg)] = seg
        x_f = (np.arange(n_cols) * fs) % deltanu_v
        y_f = freq[start] + deltanu_v * np.arange(n_rows)
        if scale == "log":
            ep = np.log10(np.maximum(ep, 1e-30))
        return ep, x_f, y_f

    def plot_echelle(self, deltanu=None, numax=None, minimum_frequency=None,
                     maximum_frequency=None, smooth_filter_width=0.1,
                     scale="linear", ax=None, cmap="Blues", **kwargs):
        """Plot the echelle diagram (reference ``core.py:322-501``)."""
        import matplotlib.pyplot as plt
        ep, x_f, y_f = self._clean_echelle(
            deltanu=deltanu, numax=numax,
            minimum_frequency=minimum_frequency,
            maximum_frequency=maximum_frequency,
            smooth_filter_width=smooth_filter_width, scale=scale)
        if ax is None:
            _, ax = plt.subplots()
        deltanu_v = float(Quantity(self._validate_deltanu(deltanu),
                                   self.periodogram.frequency.unit).value)
        im = ax.imshow(ep, aspect="auto", origin="lower", cmap=cmap,
                       extent=[0, deltanu_v, y_f[0], y_f[-1] + deltanu_v],
                       **kwargs)
        plt.colorbar(im, ax=ax, label="Power")
        ax.set_xlabel(f"Frequency mod. {deltanu_v:.2f} "
                      f"[{self.periodogram.frequency.unit}]")
        ax.set_ylabel(f"Frequency [{self.periodogram.frequency.unit}]")
        return ax

    def interact_echelle(self, notebook_url=None, n_panels=5, **kwargs):
        """The echelle explorer (reference ``core.py:502-640``).

        With ``html="path.html"``, a standalone page with a live Δν
        slider (:func:`..interact_html.export_interact_echelle_html`),
        defaulting to the estimated Δν, else ``max_frequency/30``, as the
        reference widget does.  Without it, the slider's state space as a
        static figure: the echelle at the default Δν over the whole
        frequency range, and ``n_panels`` small echelles across ±25% of
        that Δν (clipped to the reference's slider range, 0.01 to
        ``max_frequency/5``).  Returns the figure.
        """
        if kwargs.get("html") is not None:
            from ..interact_html import export_interact_echelle_html
            html = kwargs.pop("html")
            dnu_default = getattr(self, "deltanu",
                                  self.periodogram.frequency.max() / 30)
            return export_interact_echelle_html(
                self, html,
                deltanu=kwargs.pop("deltanu", dnu_default),
                numax=kwargs.pop("numax", None),
                minimum_frequency=kwargs.pop("minimum_frequency", None),
                maximum_frequency=kwargs.pop("maximum_frequency", None),
                smooth_filter_width=kwargs.pop("smooth_filter_width", 0.1))
        kwargs.pop("html", None)
        import matplotlib.pyplot as plt
        max_f = float(self.periodogram.frequency.max().value)
        min_f_kw = kwargs.pop("minimum_frequency",
                              float(self.periodogram.frequency.min().value))
        max_f_kw = kwargs.pop("maximum_frequency", max_f)
        if hasattr(self, "deltanu"):
            dnu = self.deltanu
        else:
            dnu = SeismologyQuantity(
                quantity=self.periodogram.frequency.max() / 30,
                name="deltanu", method="echelle")
        dnu_v = float(Quantity(dnu,
                               self.periodogram.frequency.unit).value)
        maxdnu = max_f / 5
        fig = plt.figure(figsize=(8, 7))
        gs = fig.add_gridspec(2, max(n_panels, 1), height_ratios=[3, 1])
        ax_main = fig.add_subplot(gs[0, :])
        self.plot_echelle(deltanu=dnu, ax=ax_main,
                          minimum_frequency=min_f_kw,
                          maximum_frequency=max_f_kw, **kwargs)
        ax_main.set_title(
            f"Echelle at Δν = {dnu_v:.3f} "
            f"{self.periodogram.frequency.unit} "
            f"(slider range 0.01–{maxdnu:.2f})")
        span = np.clip(np.linspace(0.75, 1.25, max(n_panels, 1)) * dnu_v,
                       0.01, maxdnu)
        # only the data preparation's keywords go to _clean_echelle (style
        # keywords such as cmap belong to imshow)
        clean_kwargs = {k: v for k, v in kwargs.items()
                        if k in ("smooth_filter_width", "scale")}
        for i, d in enumerate(span):
            ax = fig.add_subplot(gs[1, i])
            try:
                ep, _, _ = self._clean_echelle(
                    deltanu=d, minimum_frequency=min_f_kw,
                    maximum_frequency=max_f_kw, **clean_kwargs)
                ax.imshow(ep, aspect="auto", origin="lower",
                          cmap=kwargs.get("cmap", "Blues"))
            except ValueError:
                pass
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_xlabel(f"{d:.3f}", fontsize=8)
        fig.tight_layout()
        return fig
