"""Frequency-domain classes: Periodogram, Lomb-Scargle, BLS.

Counterpart of ``lightkurve_tpu/periodogram.py`` (the reference's
``src/lightkurve/periodogram.py``): grid construction, unit bookkeeping,
normalization rescaling and the vetting statistics are host numpy,
copied; the power comes from the port's torch functions --
Lomb-Scargle from :mod:`lightkurve_tpu_torch.ops.lombscargle`, BLS from
:func:`~lightkurve_tpu_torch.ops.bls.bls_power_binned` (``method="fast"``)
or :func:`~lightkurve_tpu_torch.ops.bls.bls_power`, and the transit model
from :func:`~lightkurve_tpu_torch.ops.bls.bls_objective_single` -- in
:data:`config.default_dtype` on :func:`config.resolve_device` (the card
unless the configuration says ``"cpu"``).  ``to_seismology`` gives the
asteroseismology dispatcher (:mod:`.seismology`); ``plot`` draws with
matplotlib, imported inside the call.
"""
from __future__ import annotations

import logging
import math
import warnings
from copy import deepcopy

import numpy as np
import torch

from . import config
from .diagnostics import count, set_attrs, span
from .lightcurve import LightCurve
from .time import Time
from .units import Quantity, Unit, day, dimensionless, one_per_day, uHz
from .utils import LightkurveWarning, _strip_quantity, validate_method

log = logging.getLogger(__name__)

__all__ = ["Periodogram", "SNRPeriodogram", "LombScarglePeriodogram",
           "BoxLeastSquaresPeriodogram"]


class Periodogram:
    """Frequency/power container (reference ``periodogram.py:33-620``).

    Parameters
    ----------
    frequency, power : `Quantity` arrays of equal length.
    nyquist : `Quantity`, optional
    """

    def __init__(self, frequency, power, nyquist=None, targetid=None,
                 label=None, default_view="frequency", meta=None):
        # constructor validation mirrors reference periodogram.py:58-86
        if not isinstance(frequency, Quantity):
            raise ValueError(
                "frequency must be an `astropy.units.Quantity` object.")
        if not isinstance(power, Quantity):
            raise ValueError(
                "power must be an `astropy.units.Quantity` object.")
        if frequency.shape != power.shape:
            raise ValueError(
                "frequency and power must have the same length.")
        if np.size(frequency) <= 1:
            raise ValueError(
                "frequency and power must have a length greater than 1.")
        if frequency.unit.bases != {"time": -1}:
            raise ValueError("Frequency must be in units of 1/time.")
        self.frequency = frequency
        self.power = power
        self.nyquist = nyquist
        self.targetid = targetid
        self.label = label
        self.default_view = self._validate_view(default_view)
        self.meta = meta or {}

    def _validate_view(self, view):
        if view is None and hasattr(self, "default_view"):
            view = self.default_view
        return validate_method(view, ["frequency", "period"])

    def _is_evenly_spaced(self):
        d = np.diff(self.frequency.value)
        return bool(np.allclose(d[0], d))

    # -- derived properties -------------------------------------------------
    @property
    def period(self):
        return 1.0 / self.frequency

    @property
    def max_power(self):
        return np.nanmax(self.power)

    @property
    def frequency_at_max_power(self):
        return self.frequency[np.nanargmax(self.power.value)]

    @property
    def period_at_max_power(self):
        return 1.0 / self.frequency_at_max_power

    def bin(self, binsize=10, method="mean"):
        """Bin the spectrum by an integer factor (reference ``:142-180``)."""
        if binsize < 1:
            raise ValueError("binsize must be larger than or equal to 1")
        method = validate_method(method, ["mean", "median"])
        m = int(len(self.power) / binsize)
        fv = self.frequency.value[: m * binsize].reshape((m, binsize))
        pv = self.power.value[: m * binsize].reshape((m, binsize))
        if method == "mean":
            bf, bp = fv.mean(1), pv.mean(1)
        else:
            bf, bp = np.nanmedian(fv, axis=1), np.nanmedian(pv, axis=1)
        binned = self.copy()
        binned.frequency = Quantity(bf, self.frequency.unit)
        binned.power = Quantity(bp, self.power.unit)
        return binned

    def smooth(self, method="boxkernel", filter_width=0.1):
        """Box-kernel or log-median smoothing (reference ``:182-284``)."""
        method = validate_method(method, ["boxkernel", "logmedian"])
        if method == "boxkernel":
            if isinstance(filter_width, Quantity):
                try:
                    filter_width = float(
                        filter_width.to(self.frequency.unit).value)
                except ValueError:
                    raise ValueError("the `filter_width` parameter must "
                                     "have frequency units.")
            if filter_width <= 0.0:
                raise ValueError("the `filter_width` parameter must be "
                                 "larger than 0 for the 'boxkernel' method.")
            if not self._is_evenly_spaced():
                raise ValueError(
                    "the 'boxkernel' method requires the periodogram to "
                    "have a grid of evenly spaced frequencies.")
            fs = np.mean(np.diff(self.frequency.value))
            width = math.ceil(filter_width / fs)
            # astropy Box1DKernel: odd-length kernel; even widths get
            # half-weight endpoints so the effective width is exact
            if width % 2 == 1:
                kernel = np.full(width, 1.0 / width)
            else:
                kernel = np.full(width + 1, 1.0 / width)
                kernel[0] = kernel[-1] = 0.5 / width
            smooth_power = np.convolve(self.power.value, kernel, mode="same")
            out = self.copy()
            out.power = Quantity(smooth_power, self.power.unit)
            return out
        # logmedian: filter_width is a plain number of dex — ANY Quantity
        # is rejected like the reference (a 'dimensionless' ppm/percent
        # Quantity would have its scale silently dropped)
        if isinstance(filter_width, Quantity):
            raise ValueError("the 'logmedian' method requires a "
                             "dimensionless value for `filter_width` in "
                             "log10(frequency) space.")
        filter_width = float(filter_width)
        if filter_width <= 0.0:
            raise ValueError("the `filter_width` parameter must be "
                             "larger than 0 for the 'logmedian' method.")
        fv = self.frequency.value
        pv = self.power.value
        count = np.zeros(len(fv), dtype=int)
        bkg = np.zeros_like(fv)
        x0 = np.log10(fv[0])
        corr_factor = (8.0 / 9.0) ** 3
        logf = np.log10(fv)
        while x0 < np.log10(fv[-1]):
            m = np.abs(logf - x0) < filter_width
            if m.any():
                bkg[m] += np.nanmedian(pv[m]) / corr_factor
                count[m] += 1
            x0 += 0.5 * filter_width
        bkg /= np.maximum(count, 1)
        out = self.copy()
        out.power = Quantity(bkg, self.power.unit)
        return out

    def flatten(self, method="logmedian", filter_width=0.01,
                return_trend=False):
        """Divide out the noise background → SNR spectrum (ref ``:381-429``)."""
        bkg = self.smooth(method=method, filter_width=filter_width)
        snr_power = self.power.value / bkg.power.value
        snr = SNRPeriodogram(
            self.frequency, Quantity(snr_power, dimensionless),
            nyquist=self.nyquist, targetid=self.targetid, label=self.label,
            meta=self.meta)
        if return_trend:
            return snr, bkg
        return snr

    def to_table(self):
        return {"frequency": self.frequency, "period": self.period,
                "power": self.power}

    def to_seismology(self, **kwargs):
        """A :class:`~lightkurve_tpu_torch.seismology.Seismology` of this
        periodogram (reference ``periodogram.py:187``)."""
        from .seismology import Seismology
        return Seismology(self, **kwargs)

    def copy(self):
        return deepcopy(self)

    def __repr__(self):
        return f"{type(self).__name__}(ID: {self.label})"

    def __getitem__(self, key):
        out = self.copy()
        out.frequency = self.frequency[key]
        out.power = self.power[key]
        # per-period companion arrays (BLS duration/depth/transit_time/…)
        # must slice alongside power, or *_at_max_power on a sliced
        # periodogram would index the wrong rows
        for name in ("duration", "depth", "depth_err", "snr",
                     "transit_time", "log_likelihood"):
            val = getattr(out, name, None)
            if val is not None and np.ndim(val) == 1 and \
                    len(val) == len(self.power):
                setattr(out, name, val[key])
        return out

    def __len__(self):
        return len(self.frequency)

    def __add__(self, other):
        out = self.copy()
        out.power = Quantity(out.power.value + np.asarray(other),
                             self.power.unit)
        return out

    __radd__ = __add__

    def __sub__(self, other):
        return self.__add__(-np.asarray(other))

    def __rsub__(self, other):
        out = self.copy()
        out.power = Quantity(np.asarray(other) - out.power.value,
                             self.power.unit)
        return out

    def __mul__(self, other):
        out = self.copy()
        out.power = out.power * other
        return out

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.__mul__(1.0 / np.asarray(other))

    def __rtruediv__(self, other):
        out = self.copy()
        out.power = other / out.power
        return out

    def show_properties(self):
        for attr in sorted(dir(self)):
            if attr.startswith("_"):
                continue
            try:
                res = getattr(self, attr)
            except Exception:
                continue
            if callable(res):
                continue
            print(f"{attr:>25}: {res}")


    def plot(self, scale="linear", ax=None, xlabel=None, ylabel=None,
             title="", style=None, view=None, unit=None, **kwargs):
        """Power against frequency or period (reference
        ``periodogram.py:484-583``)."""
        import matplotlib.pyplot as plt
        view = self._validate_view(view)
        if ax is None:
            _, ax = plt.subplots()
        if ylabel is None:
            ylabel = "Power"
            if str(self.power.unit):
                ylabel += f" [{self.power.unit}]"
        kwargs.setdefault("label", self.label)
        if view == "frequency":
            x = _strip_quantity(self.frequency)
            if xlabel is None:
                xlabel = f"Frequency [{self.frequency.unit}]"
        else:
            x = _strip_quantity(self.period)
            if xlabel is None:
                xlabel = f"Period [{self.period.unit}]"
        ax.plot(x, _strip_quantity(self.power), **kwargs)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_yscale(scale)
        ax.set_xscale(scale)
        ax.set_title(title)
        if kwargs.get("label"):  # empty labels draw no legend entry
            ax.legend(loc="best")
        return ax


class SNRPeriodogram(Periodogram):
    """Signal-to-noise spectrum (reference ``periodogram.py:606-620``)."""

    def __repr__(self):
        return f"SNRPeriodogram(ID: {self.label})"


class LombScarglePeriodogram(Periodogram):
    """Lomb-Scargle periodogram (reference ``periodogram.py:622-1018``)."""

    def __init__(self, *args, **kwargs):
        self.nterms = kwargs.pop("nterms", 1)
        self.ls_method = kwargs.pop("ls_method", "fast")
        self._ls_data = kwargs.pop("ls_data", None)
        kwargs.pop("ls_obj", None)
        super().__init__(*args, **kwargs)

    def __repr__(self):
        return f"LombScarglePeriodogram(ID: {self.label})"

    @staticmethod
    def from_lightcurve(lc, minimum_frequency=None, maximum_frequency=None,
                        minimum_period=None, maximum_period=None,
                        frequency=None, period=None, nterms=1,
                        nyquist_factor=1, oversample_factor=None,
                        freq_unit=None, normalization="amplitude",
                        ls_method="fast", dtype=None, **kwargs):
        """Compute the LS periodogram of ``lc``.

        Grid defaults and normalization rescaling replicate the reference
        exactly (``periodogram.py:793-989``): frequency resolution
        fs = 1/baseline/oversample_factor, maximum = nyquist_factor × the
        approximate Nyquist 0.5/median(Δt); 'psd' rescales astropy's psd
        power by 2/(N·osf·fs), 'amplitude' takes sqrt(power)·sqrt(4/N).
        """
        from .ops.lombscargle import (lombscargle_direct, lombscargle_fast,
                                      lombscargle_chi2)

        normalization = validate_method(normalization, ["psd", "amplitude"])
        if np.isnan(lc.flux.value).any():
            lc = lc.remove_nans()
            log.debug("Lightcurve contains NaN values. These are removed "
                      "before creating the periodogram.")

        if freq_unit is None:
            freq_unit = one_per_day if normalization == "amplitude" else uHz
        else:
            freq_unit = Unit.parse(freq_unit) if not isinstance(
                freq_unit, Unit) else freq_unit
        if oversample_factor is None:
            oversample_factor = 5.0 if normalization == "amplitude" else 1.0

        # deprecated aliases (reference :806-837)
        for old, new in [("min_period", "minimum_period"),
                         ("max_period", "maximum_period"),
                         ("min_frequency", "minimum_frequency"),
                         ("max_frequency", "maximum_frequency")]:
            if old in kwargs:
                warnings.warn(f"`{old}` keyword is deprecated, please use "
                              f"`{new}` instead.", LightkurveWarning)
                val = kwargs.pop(old)
                if new == "minimum_period":
                    minimum_period = val
                elif new == "maximum_period":
                    maximum_period = val
                elif new == "minimum_frequency":
                    minimum_frequency = val
                else:
                    maximum_frequency = val

        if kwargs:
            raise TypeError(
                "to_periodogram() got unexpected keyword argument(s): "
                f"{sorted(kwargs)}")
        ls_method = validate_method(
            ls_method, ["fast", "slow", "chi2", "fastchi2", "fastnifty",
                        "fastnifty_chi2", "auto"])
        if ls_method == "auto":
            ls_method = "fast"

        period_args = [period, minimum_period, maximum_period]
        freq_args = [frequency, minimum_frequency, maximum_frequency]
        default_view = "period" if not all(
            b is None for b in period_args) else "frequency"
        if (not all(b is None for b in period_args)) and \
                (not all(b is None for b in freq_args)):
            raise ValueError(
                "You have input keyword arguments for both frequency and "
                "period. Please only use one.")

        tv = lc.time.value.astype(np.float64)
        fluxv = lc.flux.value.astype(np.float64)

        # Nyquist & resolution in 1/day, then convert (reference :849-856)
        nyquist_d = 0.5 / np.median(np.diff(tv))
        fs_d = (1.0 / (tv[-1] - tv[0])) / oversample_factor
        to_unit = one_per_day.to(freq_unit)     # scale 1/day → freq_unit
        nyquist = Quantity(nyquist_d * to_unit, freq_unit)
        fs = Quantity(fs_d * to_unit, freq_unit)

        # period inputs are in DAYS (raw) or explicit units; their
        # reciprocals are 1/day and must be converted into freq_unit
        # before mixing with frequency bounds (the psd default is uHz —
        # leaving them in 1/day built grids off by the unit scale)
        if maximum_period is not None:
            minimum_frequency = (1.0 / _qval(maximum_period, "d")) * to_unit
        if minimum_period is not None:
            maximum_frequency = (1.0 / _qval(minimum_period, "d")) * to_unit
        if period is not None:
            frequency = (1.0 / np.asarray(_qval(period, "d"))) * to_unit

        if frequency is None:
            min_f = fs.value if minimum_frequency is None else \
                _qval(minimum_frequency, freq_unit)
            max_f = nyquist.value * nyquist_factor if maximum_frequency \
                is None else _qval(maximum_frequency, freq_unit)
            if minimum_frequency is not None and maximum_frequency is not \
                    None and min_f > max_f:
                if default_view == "frequency":
                    raise ValueError("minimum_frequency cannot be larger "
                                     "than maximum_frequency")
                raise ValueError("minimum_period cannot be larger than "
                                 "maximum_period")
            frequency = np.arange(min_f, max_f, fs.value)
        else:
            frequency = np.asarray(_qval(frequency, freq_unit))

        # frequencies in 1/day for the kernel
        freq_d = frequency / to_unit

        regular = len(frequency) > 1 and np.allclose(
            np.diff(frequency), frequency[1] - frequency[0])
        if not regular and ls_method in ("fastchi2", "fast", "fastnifty",
                                         "fastnifty_chi2"):
            old = ls_method
            ls_method = {"fastchi2": "chi2", "fast": "slow",
                         "fastnifty_chi2": "chi2", "fastnifty": "slow"}[
                ls_method]
            log.warning(
                "The requested periodogram is not evenly sampled in "
                f"frequency.\nMethod has been changed from '{old}' to "
                f"'{ls_method}' to allow for this.")
        if ls_method.startswith("fastnifty"):
            ls_method = {"fastnifty": "fast",
                         "fastnifty_chi2": "fastchi2"}[ls_method]
        if (nterms > 1) and (ls_method not in ("fastchi2", "chi2")):
            warnings.warn(
                "`nterms` has been set to >1, however this is not supported "
                f"under the `{ls_method}` method; nterms reset to 1.",
                LightkurveWarning)
            nterms = 1

        dtype = config.resolve_dtype(dtype)
        device = config.resolve_device(None)
        y = torch.as_tensor(fluxv, dtype=dtype, device=device)

        # shift the time origin in float64 BEFORE the device cast: JD-
        # scale timestamps (~2.45e6) round to ~0.25 d in f32, corrupting
        # the trig phases by O(10) rad (GLS power is shift-invariant)
        tvs = tv - tv.min()
        if ls_method == "fastchi2" and regular:
            # FFT-accelerated multi-term fit (astropy's 'fastchi2',
            # Palmer 2009) — O((N + Nf·log Nf)·k) vs the direct chi2
            # method's O(N·Nf·k²); reference dispatch at
            # periodogram.py:930-958
            from .ops.lombscargle import lombscargle_fastchi2
            f0, df, Nf = freq_d[0], freq_d[1] - freq_d[0], len(freq_d)
            power = lombscargle_fastchi2(tv, y, f0, df, Nf,
                                         nterms=nterms,
                                         normalization="psd")
        elif nterms > 1 or ls_method == "chi2":
            power = lombscargle_chi2(
                torch.as_tensor(tvs, dtype=dtype, device=device), y,
                torch.as_tensor(freq_d, dtype=dtype, device=device),
                nterms=nterms, normalization="psd")
        elif ls_method == "fast" and regular:
            f0, df, Nf = freq_d[0], freq_d[1] - freq_d[0], len(freq_d)
            power = lombscargle_fast(tv, y, f0, df, Nf, normalization="psd")
        else:
            power = lombscargle_direct(
                torch.as_tensor(tvs, dtype=dtype, device=device), y,
                torch.as_tensor(freq_d, dtype=dtype, device=device),
                normalization="psd")
        power = power.cpu().numpy().astype(np.float64)

        if normalization == "psd":
            # flux-variance / freq_unit (reference :969-972)
            power = power * 2.0 / (len(tv) * oversample_factor * fs.value)
            power_q = Quantity(power, (lc.flux.unit ** 2) / freq_unit)
        else:
            power = np.sqrt(power) * np.sqrt(4.0 / len(tv))
            power_q = Quantity(power, lc.flux.unit)

        return LombScarglePeriodogram(
            frequency=Quantity(frequency, freq_unit),
            power=power_q,
            nyquist=nyquist,
            targetid=lc.meta.get("TARGETID"),
            label=lc.meta.get("LABEL"),
            default_view=default_view,
            nterms=nterms,
            ls_method=ls_method,
            ls_data=(tv, fluxv),
            meta=lc.meta)

    def model(self, time=None, frequency=None):
        """Best-fit sinusoid at ``frequency`` as a normalized LightCurve
        (reference ``:991-1018``)."""
        if self._ls_data is None:
            raise ValueError("No Lomb Scargle data exists.")
        tv, fluxv = self._ls_data
        if frequency is None:
            frequency = self.frequency_at_max_power
        # convert Quantities to this periodogram's frequency unit first
        # (raw floats are interpreted in that unit), THEN rescale to 1/day
        f_d = _qval(frequency, self.frequency.unit) \
            / one_per_day.to(self.frequency.unit)
        if time is None:
            time = tv
        t_eval = time.value if isinstance(time, Time) else np.asarray(time)
        # weighted LSQ fit of a + b cos + c sin at f (uniform weights)
        X = np.stack([np.ones_like(tv), np.cos(2 * np.pi * f_d * tv),
                      np.sin(2 * np.pi * f_d * tv)], axis=1)
        beta, *_ = np.linalg.lstsq(X, fluxv, rcond=None)
        model_flux = beta[0] + beta[1] * np.cos(2 * np.pi * f_d * t_eval) + \
            beta[2] * np.sin(2 * np.pi * f_d * t_eval)
        lc = LightCurve(time=time, flux=model_flux,
                        meta={"FREQUENCY": frequency, "LABEL": "LS Model",
                              "TARGETID": f"{self.targetid} LS Model"})
        return lc.normalize()


class BoxLeastSquaresPeriodogram(Periodogram):
    """BLS periodogram (reference ``periodogram.py:1021-1340``)."""

    def __init__(self, *args, **kwargs):
        self.duration = kwargs.pop("duration", None)
        self.depth = kwargs.pop("depth", None)
        self.snr = kwargs.pop("snr", None)
        self.transit_time = kwargs.pop("transit_time", None)
        self.log_likelihood = kwargs.pop("log_likelihood", None)
        self.depth_err = kwargs.pop("depth_err", None)
        self.time = kwargs.pop("time", None)
        self.flux = kwargs.pop("flux", None)
        self.flux_err = kwargs.pop("flux_err", None)
        self.time_unit = kwargs.pop("time_unit", "day")
        kwargs.pop("bls_result", None)
        kwargs.pop("bls_obj", None)
        super().__init__(*args, **kwargs)

    def __repr__(self):
        return f"BoxLeastSquaresPeriodogram(ID: {self.label})"

    @staticmethod
    def from_lightcurve(lc, **kwargs):
        """Run the BLS search (reference ``periodogram.py:1042-1192``).

        Grid defaults replicate the reference: durations
        [0.05..0.33] d; minimum_period = max(4·median Δt, max duration +
        median Δt); maximum_period = baseline/3; period grid evenly spaced
        in frequency with df = frequency_factor·min(duration)/baseline²,
        hard error above 1e7 grid points and a warning above 1e5.
        """
        from .ops.bls import bls_power, bls_power_binned

        with span("periodogram.bls"):
            with span("periodogram.grid"):
                lc = lc.remove_nans()
                if np.isfinite(lc.flux_err.value).all():
                    dy = lc.flux_err.value.astype(np.float64)
                else:
                    dy = None

                duration = kwargs.pop("duration", [0.05, 0.10, 0.15, 0.20,
                                                   0.25, 0.33])
                duration = np.atleast_1d(_qval(duration)).astype(np.float64)
                if not np.all(np.isfinite(duration)):
                    raise ValueError("`duration` parameter contains illegal "
                                     "nan or inf value(s)")

                period = kwargs.pop("period", None)
                minimum_period = kwargs.pop("minimum_period", None)
                maximum_period = kwargs.pop("maximum_period", None)
                if period is not None:
                    period = np.atleast_1d(_qval(period)).astype(np.float64)
                    if not np.all(np.isfinite(period)):
                        raise ValueError("`period` parameter contains "
                                         "illegal nan or inf value(s)")
                tv = lc.time.value.astype(np.float64)
                if minimum_period is None:
                    if period is None:
                        cadence = np.median(np.diff(tv))
                        minimum_period = max(cadence * 4,
                                             np.max(duration) + cadence)
                    else:
                        minimum_period = np.min(period)
                else:
                    minimum_period = _qval(minimum_period)
                if maximum_period is None:
                    if period is None:
                        maximum_period = (np.max(tv) - np.min(tv)) / 3.0
                    else:
                        maximum_period = np.max(period)
                else:
                    maximum_period = _qval(maximum_period)

                time_unit = kwargs.pop("time_unit", "day")
                frequency_factor = kwargs.pop("frequency_factor", 10)
                baseline = np.max(tv) - np.min(tv)
                df = frequency_factor * np.min(duration) / baseline ** 2
                # same expression autoperiod uses, so the guard counts the
                # grid that will actually be built
                npoints = 1 + int(np.round(
                    ((1 / minimum_period) - (1 / maximum_period)) / df))
                if npoints > 1e7:
                    raise ValueError(
                        f"`period` contains {np.round(npoints, 4)} points."
                        "Periodogram is too large to evaluate. "
                        "Consider setting `frequency_factor` to a higher "
                        "value.")
                elif npoints > 1e5:
                    log.warning(
                        f"`period` contains {np.round(npoints, 4)} points."
                        "Periodogram is likely to be large, and slow to "
                        "evaluate. Consider setting `frequency_factor` to a "
                        "higher value.")

                if period is None:
                    period = autoperiod(duration, baseline,
                                        minimum_period=minimum_period,
                                        maximum_period=maximum_period,
                                        frequency_factor=frequency_factor)

                objective = kwargs.pop("objective", "likelihood")
                oversample = kwargs.pop("oversample", 10)
                # 'fast' = binned fold (astropy's default Cython algorithm
                # family); 'exact'/'slow' = the exact sorted-phase kernel
                method = kwargs.pop("method", "fast")
                if kwargs:
                    raise TypeError(
                        "to_periodogram(method='bls') got unexpected keyword "
                        f"argument(s): {sorted(kwargs)}")
            set_attrs(cadences=len(lc), periods=len(period),
                      durations=len(duration), method=method)
            kernel = bls_power_binned if method == "fast" else bls_power
            # the fluxes in the configured dtype on the configured device;
            # the times and the grid stay float64, the fold's geometry in
            # every dtype (ops.bls._curve_inputs)
            out = kernel(tv, _host(lc.flux.value),
                         None if dy is None else _host(dy), period, duration,
                         oversample=oversample, objective=objective,
                         device=config.resolve_device(None))
            with span("periodogram.result"):
                result = {}
                for k, v in out.items():
                    result[k] = v.cpu().numpy().astype(np.float64)
                    count("host_sync")
                return BoxLeastSquaresPeriodogram(
                    frequency=Quantity(1.0 / period, one_per_day),
                    power=Quantity(result["power"], dimensionless),
                    default_view="period",
                    label=lc.meta.get("LABEL"),
                    targetid=lc.meta.get("TARGETID"),
                    transit_time=Time(result["transit_time"],
                                      format=lc.time.format,
                                      scale=lc.time.scale),
                    duration=Quantity(result["duration"], day),
                    depth=Quantity(result["depth"], dimensionless),
                    depth_err=Quantity(result["depth_err"], dimensionless),
                    snr=Quantity(result["depth_snr"], dimensionless),
                    log_likelihood=Quantity(result["log_likelihood"],
                                            dimensionless),
                    time=lc.time,
                    flux=lc.flux,
                    flux_err=lc.flux_err,
                    time_unit=time_unit,
                    meta=lc.meta)

    def _best(self, period, duration, transit_time):
        if period is None:
            period = self.period_at_max_power
            log.warning("No period specified. Using period at max power")
        if duration is None:
            duration = self.duration_at_max_power
            log.warning("No duration specified. Using duration at max power")
        if transit_time is None:
            transit_time = self.transit_time_at_max_power
            log.warning("No transit time specified. Using transit time at "
                        "max power")
        if isinstance(transit_time, Time):
            transit_time = transit_time.to_value(self.time.format)
        # periods/durations are handled in days: convert explicit-unit
        # Quantities (raw floats are interpreted as days)
        return (_qval(period, "d"), _qval(duration, "d"),
                float(np.atleast_1d(
                    np.asarray(transit_time, dtype=float))[0]))

    def compute_stats(self, period=None, duration=None, transit_time=None):
        """Vetting statistics for a transit model.

        Full astropy ``BoxLeastSquares.compute_stats`` semantics (the
        reference delegates to it at ``periodogram.py:1194-1230``):
        fiducial/odd/even/phased/half-period depths against the fiducial
        out-of-transit level, per-transit point counts and
        log-likelihood contributions, and the best-fit sinusoid
        comparison (``harmonic_amplitude`` /
        ``harmonic_delta_log_likelihood``).  Host-side numpy — this is a
        one-shot vetting call, not a hot loop.
        """
        p, d, t0 = self._best(period, duration, transit_time)
        tv = self.time.value.astype(np.float64)
        y = np.asarray(self.flux.value, dtype=np.float64)
        dyv = np.asarray(self.flux_err.value, dtype=np.float64)
        if np.isfinite(dyv).all():
            ivar = 1.0 / dyv ** 2
        else:
            ivar = np.ones_like(y)
        hp = 0.5 * p

        def _depth(m, y_out=None, var_out=None):
            """(weighted mean, variance) of points in ``m``; with a
            reference level, (depth, err) against it."""
            if np.any(m) and (y_out is None or np.isfinite(y_out)):
                var_m = 1.0 / np.sum(ivar[m])
                y_m = np.sum(y[m] * ivar[m]) * var_m
                if y_out is None:
                    return y_m, var_m
                return y_out - y_m, np.sqrt(var_m + var_out)
            return 0.0, np.inf

        # fiducial model + the two models at twice the period (odd/even)
        m_in = np.abs((tv - t0 + hp) % p - hp) < 0.5 * d
        m_out = ~m_in
        m_odd = np.abs((tv - t0) % (2 * p) - p) < 0.5 * d
        m_even = np.abs((tv - t0 + p) % (2 * p) - p) < 0.5 * d
        y_out, var_out = _depth(m_out)
        depth = _depth(m_in, y_out, var_out)
        depth_odd = _depth(m_odd, y_out, var_out)
        depth_even = _depth(m_even, y_out, var_out)
        y_in = y_out - depth[0]

        # depth of a putative secondary eclipse at phase 0.5
        m_phase = np.abs((tv - t0) % p - hp) < 0.5 * d
        depth_phased = _depth(m_phase, *_depth(~(m_phase | m_in)))

        # depth of a model with half the period (quarter-phase offset)
        m_half = (np.abs((tv - t0 + 0.25 * p) % (0.5 * p) - 0.25 * p)
                  < 0.5 * d)
        depth_half = _depth(m_half, *_depth(~m_half))

        # per-transit counts + log-likelihood contributions
        if m_in.any():
            transit_id = np.round((tv[m_in] - t0) / p).astype(int)
            transit_times = (p * np.arange(transit_id.min(),
                                           transit_id.max() + 1) + t0)
            unique_ids, unique_counts = np.unique(transit_id,
                                                  return_counts=True)
            unique_ids = unique_ids - transit_id.min()
            transit_id = transit_id - transit_id.min()
            counts = np.zeros(len(transit_times), dtype=int)
            counts[unique_ids] = unique_counts
            ll = -0.5 * ivar[m_in] * ((y[m_in] - y_in) ** 2
                                      - (y[m_in] - y_out) ** 2)
            lls = np.zeros(len(transit_times))
            for i in unique_ids:
                lls[i] = np.sum(ll[transit_id == i])
        else:
            transit_times = np.empty(0)
            counts = np.empty(0, dtype=int)
            lls = np.empty(0)
        full_ll = -0.5 * np.sum(ivar[m_in] * (y[m_in] - y_in) ** 2)
        full_ll -= 0.5 * np.sum(ivar[m_out] * (y[m_out] - y_out) ** 2)

        # best-fit sinusoid at the period: amplitude + delta log-like
        A = np.vstack((np.sin(2 * np.pi * tv / p),
                       np.cos(2 * np.pi * tv / p),
                       np.ones_like(tv))).T
        w_sin = np.linalg.solve(np.dot(A.T, A * ivar[:, None]),
                                np.dot(A.T, y * ivar))
        sin_ll = -0.5 * np.sum((y - np.dot(A, w_sin)) ** 2 * ivar)

        depth_err = depth[1]
        return {
            "transit_times": transit_times,
            "per_transit_count": counts,
            "per_transit_log_likelihood": lls,
            "depth": (float(depth[0]), float(depth[1])),
            "depth_phased": (float(depth_phased[0]),
                             float(depth_phased[1])),
            "depth_half": (float(depth_half[0]), float(depth_half[1])),
            "depth_odd": (float(depth_odd[0]), float(depth_odd[1])),
            "depth_even": (float(depth_even[0]), float(depth_even[1])),
            "harmonic_amplitude": float(np.sqrt(np.sum(w_sin[:2] ** 2))),
            "harmonic_delta_log_likelihood": float(sin_ll - full_ll),
            # extras kept from the r1 API (not in astropy's dict)
            "log_likelihood": float(full_ll),
            "snr": float(depth[0] / depth_err)
            if np.isfinite(depth_err) and depth_err > 0 else np.nan,
        }

    def get_transit_model(self, period=None, duration=None,
                          transit_time=None):
        """Box transit model as a LightCurve (reference ``:1231-1273``)."""
        from .ops.bls import bls_objective_single
        p, d, t0 = self._best(period, duration, transit_time)
        tv = self.time.value.astype(np.float64)
        fv = np.asarray(self.flux.value, dtype=np.float64)
        dyv = np.asarray(self.flux_err.value, dtype=np.float64)
        dy = dyv if np.isfinite(dyv).all() else None
        out = bls_objective_single(_host(tv), _host(fv),
                                   None if dy is None else _host(dy),
                                   p, d, t0,
                                   device=config.resolve_device(None))
        in_t = out["in_transit"].cpu().numpy()
        model_flux = np.where(in_t, float(out["y_in"]), float(out["y_out"]))
        return LightCurve(time=self.time.copy(), flux=model_flux,
                          meta={"LABEL": "Transit Model Flux"})

    def get_transit_mask(self, period=None, duration=None, transit_time=None):
        model = self.get_transit_model(period=period, duration=duration,
                                       transit_time=transit_time)
        return np.asarray(model.flux.value !=
                          np.median(model.flux.value))

    @property
    def transit_time_at_max_power(self):
        return self.transit_time[np.nanargmax(self.power.value)]

    @property
    def duration_at_max_power(self):
        return self.duration[np.nanargmax(self.power.value)]

    @property
    def depth_at_max_power(self):
        return self.depth[np.nanargmax(self.power.value)]

    def plot(self, **kwargs):
        ax = super().plot(**kwargs)
        if "ylabel" not in kwargs:
            ax.set_ylabel("BLS Power")
        return ax

    def flatten(self, **kwargs):
        raise NotImplementedError(
            "`flatten` is not implemented for `BoxLeastSquaresPeriodogram`.")

    def smooth(self, **kwargs):
        raise NotImplementedError(
            "`smooth` is not implemented for `BoxLeastSquaresPeriodogram`. ")


def autoperiod(duration, baseline, minimum_period, maximum_period,
               frequency_factor=10.0):
    """Period grid evenly spaced in frequency (astropy ``autoperiod``
    semantics, called at reference ``periodogram.py:1163``)."""
    df = frequency_factor * np.min(duration) / baseline ** 2
    max_frequency = 1.0 / minimum_period
    min_frequency = 1.0 / maximum_period
    # astropy: 1 + round(Δf/df) points, so the grid INCLUDES
    # maximum_period when Δf is an exact multiple of df
    nf = 1 + int(np.round((max_frequency - min_frequency) / df))
    return 1.0 / (max_frequency - df * np.arange(nf))


def _host(x):
    """A host array in the numpy dtype of :data:`config.default_dtype`."""
    return np.asarray(x, dtype=np.float64).astype(
        config.numpy_dtype(config.resolve_dtype(None)))


def _qval(x, unit=None):
    """Strip a Quantity to its float value (optionally converting)."""
    if isinstance(x, Quantity):
        if unit is not None:
            return np.asarray(x.to(unit).value)[()] if x.ndim else float(
                x.to(unit).value)
        v = np.asarray(x.value)
        return v if v.ndim else float(v)
    arr = np.asarray(x, dtype=float)
    return arr if arr.ndim else float(arr)
