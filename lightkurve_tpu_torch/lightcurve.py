"""LightCurve containers: the host data model.

Counterpart of ``lightkurve_tpu/lightcurve.py`` (the reference's
``LightCurve`` family, ``src/lightkurve/lightcurve.py:254-3890``): a lean
column store (numpy arrays, :class:`~lightkurve_tpu_torch.time.Time` and a
metadata dict), copied, whose cadence-axis reductions run as torch
functions: ``remove_outliers`` through
:func:`~lightkurve_tpu_torch.ops.stats.sigma_clip_mask` and ``flatten``
(with ``estimate_cdpp`` and ``fill_gaps``, which call it) through
:func:`~lightkurve_tpu_torch.ops.detrend.flatten`.  Their tensors are
built inside those calls, in :data:`config.default_dtype` on
:func:`config.resolve_device` (the card unless the configuration says
``"cpu"``); the container itself stays numpy.  ``fold`` and ``bin`` are
host numpy, as in ``lightkurve_tpu``.

``to_corrector`` gives the SFF or CBV corrector (:mod:`.correctors`) and
``to_seismology`` the asteroseismology dispatcher (:mod:`.seismology`).
The plots (``plot``, ``scatter``, ``errorbar``, ``plot_river``) import
matplotlib and the exports (``to_pandas``, ``to_csv``, ``to_excel``,
ASCII tables through ``read``/``write``) pandas inside the call, as
``lightkurve_tpu`` does: without them they raise ``ImportError``.
``query_solar_system_objects`` runs the SkyBot query through a pluggable
``fetch``.  The batched counterpart is
:class:`lightkurve_tpu_torch.batch.LightCurveStack`.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from copy import deepcopy

import numpy as np
import torch

from . import config
from .diagnostics import count, span
from .time import Time, TimeDelta
from .units import Quantity, Unit, dimensionless, percent, ppm, ppt
from .utils import (
    LightkurveWarning,
    LightkurveDeprecationWarning,
    running_mean,
    _strip_quantity,
    validate_method,
)

__all__ = ["LightCurve", "FoldedLightCurve", "KeplerLightCurve",
           "TessLightCurve"]


def _to_unitful(values, default_unit=dimensionless):
    if isinstance(values, Quantity):
        return values
    return Quantity(np.asarray(values, dtype=float), default_unit)


def _finite_values(x):
    """Flatten masked arrays/Quantities to a float array with masked and
    non-finite entries as NaN."""
    if np.ma.isMaskedArray(x):
        x = np.ma.filled(x.astype(float), np.nan)
    else:
        x = np.asarray(x, dtype=float)
    return x


def rmse(x):
    """Root-mean-square of the finite (unmasked) values; NaN when none
    remain.  The per-bin flux_err aggregator of ``bin()``
    (reference ``lightcurve.py:167-172``)."""
    x = _finite_values(x)
    if np.any(np.isfinite(x)):
        return np.sqrt(np.nansum(x ** 2) / np.sum(np.isfinite(x)))
    return np.nan


def nanstd(x):
    """Standard deviation of the finite (unmasked) values; NaN when none
    remain (reference ``lightcurve.py:202-211``)."""
    x = _finite_values(x)
    if np.any(np.isfinite(x)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.nanstd(x)
    return np.nan


def _make_reduceat(fn):
    def reduceat(values, indices):
        values = _finite_values(values)
        idx = list(indices) + [len(values)]
        return np.array([fn(values[a:b])
                         for a, b in zip(idx[:-1], idx[1:])])
    return reduceat


rmse.reduceat = _make_reduceat(rmse)
nanstd.reduceat = _make_reduceat(nanstd)


#: ASCII unified-I/O formats supported by LightCurve.read/write
_ASCII_FORMAT_SEPARATORS = {
    "ascii.csv": ",",
    "csv": ",",
    "ascii.tab": "\t",
    "ascii.basic": " ",
}


def _format_to_filetype(format):
    """Map a ``.read(format=...)`` name to a reader-registry filetype
    (reference unified-I/O format names); None auto-detects, unknown
    names raise ValueError."""
    if format is None:
        return None
    mapping = {"kepler": "KeplerLightCurve", "tess": "TessLightCurve",
               "qlp": "QLP", "k2sff": "K2SFF", "everest": "EVEREST",
               "k2sc": "K2SC", "cdips": "CDIPS", "pathos": "PATHOS",
               "tasoc": "TASOC", "kepseismic": "KEPSEISMIC",
               "tglc": "TGLC", "eleanor": "ELEANOR",
               "gsfc-eleanor-lite": "ELEANOR", "folded": "Folded",
               "generic": "generic"}
    key = str(format).lower()
    if key not in mapping:
        raise ValueError(
            f"unknown format {format!r}; supported formats: "
            f"{sorted(mapping)}")
    return mapping[key]


class LightCurve:
    """A time series of flux measurements with guaranteed columns.

    Guarantees the presence of ``time``, ``flux`` and ``flux_err`` columns
    (reference ``lightcurve.py:355-488``) and provides attribute access to
    all columns and (upper-case) metadata keys.

    Parameters
    ----------
    data : dict or LightCurve, optional
        Column name → array mapping.
    time, flux, flux_err : array-like, optional
        Override/provide the required columns.
    meta : dict, optional
    """

    _required_columns = ["time", "flux", "flux_err"]
    _default_time_format = "jd"

    def __init__(self, data=None, *, time=None, flux=None, flux_err=None,
                 meta=None, flux_unit=None, names=None, time_format=None,
                 time_scale=None, **extra_columns):
        cols = OrderedDict()
        _meta = {}
        # ``flux_unit=`` attaches a unit to unitless flux/flux_err inputs
        # (reference tests construct e.g.
        # LightCurve(..., flux_unit="electron/second"))
        if flux_unit is not None:
            from .units import Unit
            funit = Unit.parse(flux_unit)
            if flux is not None and not isinstance(flux, Quantity):
                flux = Quantity(np.asarray(flux, dtype=float), funit)
            if flux_err is not None and not isinstance(flux_err, Quantity):
                flux_err = Quantity(np.asarray(flux_err, dtype=float), funit)
        # v1.x-style scalar keywords route to meta, as in the reference's
        # deprecated-keyword handling (reference lightcurve.py:326-333);
        # applied AFTER data/meta merging so an explicit keyword wins over
        # a TARGETID carried in ``data.meta``
        _kw_targetid = extra_columns.pop("targetid", None)
        _kw_label = extra_columns.pop("label", None)
        if isinstance(data, LightCurve):
            cols.update({k: _copy_col(v) for k, v in data._cols.items()})
            _meta.update(deepcopy(data.meta))
        elif data is not None:
            if isinstance(data, np.ndarray) and data.dtype.names:
                # structured array: one column per field
                # (reference test_initialization_with_ndarray)
                for k in data.dtype.names:
                    cols[k] = np.asarray(data[k])
            elif isinstance(data, (list, tuple)):
                # list of column arrays + names
                # (reference test_initialization_with_data)
                if names is None:
                    raise ValueError(
                        "`names` must be provided when `data` is a "
                        "list of columns")
                for k, v in zip(names, data):
                    cols[k] = v
            else:
                for k, v in dict(data).items():
                    cols[k] = v
        if meta:
            _meta.update(meta)
        if _kw_targetid is not None:
            _meta["TARGETID"] = _kw_targetid
        if _kw_label is not None:
            _meta["LABEL"] = _kw_label

        if time is not None:
            cols["time"] = time
        if flux is not None:
            cols["flux"] = flux
        if flux_err is not None:
            cols["flux_err"] = flux_err
        cols.update(extra_columns)

        # --- time column -------------------------------------------------
        if "time" not in cols:
            if "flux" in cols:
                cols["time"] = np.arange(len(np.atleast_1d(cols["flux"])),
                                         dtype=float)
            else:
                cols["time"] = np.array([], dtype=float)
        t = cols["time"]
        if not isinstance(t, Time):
            t = np.atleast_1d(np.asarray(t, dtype=float))
            # the reference rejects NaN times at construction (astropy
            # Time does; reference tests/test_lightcurve.py:73-77)
            if not np.all(np.isfinite(t)):
                raise ValueError("Time values cannot be NaN or inf")
            # v1.x-style ``time_format=``/``time_scale=`` keywords
            # (reference test_astropy_time_initialization)
            t = Time(t, format=time_format or self._default_time_format,
                     scale=time_scale or "tdb")
        cols["time"] = t
        n = len(t)

        # --- required flux columns ----------------------------------------
        if "flux" not in cols:
            cols["flux"] = np.full(n, np.nan)
        if "flux_err" not in cols:
            cols["flux_err"] = np.full(n, np.nan)

        object.__setattr__(self, "_cols", OrderedDict())
        object.__setattr__(self, "meta", _meta)
        for k, v in cols.items():
            self._set_column(k, v)

        # required columns first, in order
        ordered = OrderedDict()
        for k in self._required_columns:
            ordered[k] = self._cols[k]
        for k, v in self._cols.items():
            if k not in ordered:
                ordered[k] = v
        object.__setattr__(self, "_cols", ordered)

    # ------------------------------------------------------------------
    # column store
    # ------------------------------------------------------------------
    def _set_column(self, name, values):
        n = len(self._cols["time"]) if "time" in self._cols else None
        if name == "time":
            if not isinstance(values, Time):
                arr = np.atleast_1d(np.asarray(values, dtype=float))
                if arr.size == 1 and n is not None and n > 1:
                    # scalar assignment broadcasts to the existing length
                    # (reference test_assignment_time: ``lc.time = 21``)
                    arr = np.broadcast_to(arr, (n,)).copy()
                values = Time(arr,
                              format=self.time.format if "time" in self._cols
                              else self._default_time_format,
                              scale="tdb")
            self._cols["time"] = values
            return
        if isinstance(values, Quantity):
            arr = values
        elif (isinstance(values, np.ndarray) and values.dtype.kind in "iub"
              and name not in ("flux", "flux_err")):
            # int/bool auxiliary columns (quality, cadenceno, masks) keep
            # their dtype; flux/flux_err always become unitful floats
            arr = np.atleast_1d(values)
        else:
            v = np.atleast_1d(np.asarray(values))
            if v.dtype.kind in "iuf":
                arr = Quantity(v.astype(float), dimensionless) \
                    if name in ("flux", "flux_err") else v
            else:
                arr = v
        if n is not None and len(np.atleast_1d(arr)) != n and n > 0:
            if np.ndim(arr) == 0:
                arr = np.broadcast_to(arr, (n,)).copy()
            else:
                raise ValueError(
                    f"Column '{name}' has length {len(arr)} != {n}")
        self._cols[name] = arr

    @property
    def columns(self):
        return list(self._cols.keys())

    @property
    def colnames(self):
        return list(self._cols.keys())

    # -- required-column properties ------------------------------------
    @property
    def time(self) -> Time:
        return self._cols["time"]

    @time.setter
    def time(self, v):
        self._set_column("time", v)

    @property
    def flux(self) -> Quantity:
        return self._cols["flux"]

    @flux.setter
    def flux(self, v):
        self._set_column("flux", _to_unitful(v))

    @property
    def flux_err(self) -> Quantity:
        return self._cols["flux_err"]

    @flux_err.setter
    def flux_err(self, v):
        self._set_column("flux_err", _to_unitful(v))

    @property
    def targetid(self):
        return self.meta.get("TARGETID")

    @targetid.setter
    def targetid(self, value):
        self.meta["TARGETID"] = value

    @property
    def label(self):
        return self.meta.get("LABEL")

    @label.setter
    def label(self, value):
        self.meta["LABEL"] = value

    @property
    def astropy_time(self):
        """Deprecated v1.x accessor for the time column
        (reference test_astropy_time_initialization)."""
        warnings.warn("`astropy_time` is deprecated, use `time` instead.",
                      LightkurveDeprecationWarning)
        return self.time

    @property
    def flux_quantity(self):
        """Deprecated v1.x accessor for the flux column as a Quantity
        (reference test_flux_unit)."""
        warnings.warn("`flux_quantity` is deprecated, use `flux` instead.",
                      LightkurveDeprecationWarning)
        return self.flux

    @property
    def time_format(self):
        """Deprecated v1.x accessor (reference ``lightcurve.py:702-707``):
        warns and returns ``time.format``."""
        warnings.warn("`time_format` is deprecated, use `time.format` "
                      "instead.", LightkurveDeprecationWarning)
        return self.time.format

    @property
    def time_scale(self):
        """Deprecated v1.x accessor (reference ``lightcurve.py:709-714``):
        warns and returns ``time.scale``."""
        warnings.warn("`time_scale` is deprecated, use `time.scale` "
                      "instead.", LightkurveDeprecationWarning)
        return self.time.scale

    @property
    def flux_unit(self):
        """Deprecated v1.x accessor (reference ``lightcurve.py:721-726``):
        warns and returns ``flux.unit``."""
        warnings.warn("`flux_unit` is deprecated, use `flux.unit` instead.",
                      LightkurveDeprecationWarning)
        return self.flux.unit

    @property
    def hdu(self):
        """Deprecated v1.x accessor (reference ``lightcurve.py:733-740``):
        warns and re-opens the file the curve was read from."""
        warnings.warn("`hdu` is deprecated, use "
                      "`fits.open(lc.filename)` instead.",
                      LightkurveDeprecationWarning)
        from .io.fits import open_fits
        return open_fits(self.meta.get("FILENAME"))

    @property
    def header(self):
        """Deprecated v1.x accessor: warns and returns the primary-header
        meta mapping (the reference's ``hdu[0].header``)."""
        warnings.warn("`header` is deprecated, use `meta` instead.",
                      LightkurveDeprecationWarning)
        return self.meta

    @property
    def SAP_FLUX(self):
        """Deprecated v1.x alias: a copy with ``flux = sap_flux``
        (reference ``lightcurve.py:742-752``)."""
        warnings.warn("`SAP_FLUX` is deprecated, use "
                      "`select_flux('sap_flux')` instead.",
                      LightkurveDeprecationWarning)
        return self.select_flux("sap_flux")

    @property
    def PDCSAP_FLUX(self):
        """Deprecated v1.x alias: a copy with ``flux = pdcsap_flux``
        (reference ``lightcurve.py:754-763``)."""
        warnings.warn("`PDCSAP_FLUX` is deprecated, use "
                      "`select_flux('pdcsap_flux')` instead.",
                      LightkurveDeprecationWarning)
        return self.select_flux("pdcsap_flux")

    @staticmethod
    def from_timeseries(ts):
        """Create a LightCurve from a time-series table object holding
        'time', 'flux' and 'flux_err' columns (reference
        ``lightcurve.py:2367-2379``; accepts astropy TimeSeries when
        astropy is installed, or any mapping of columns)."""
        time = ts["time"]
        time = getattr(time, "value", time)
        return LightCurve(time=np.asarray(time), flux=ts["flux"],
                          flux_err=ts["flux_err"])

    def show_properties(self):
        """Print a description of the meta keywords
        (reference ``lightcurve.py`` show_properties)."""
        rows = [("Attribute", "Value")]
        for k, v in self.meta.items():
            rows.append((str(k).lower(), str(v)))
        rows.extend([("length", str(len(self))),
                     ("time format", str(self.time.format)),
                     ("flux unit", str(self.flux.unit))])
        width = max(len(r[0]) for r in rows) + 2
        print("\n".join(f"{k:<{width}}{v}" for k, v in rows))

    # -- attribute protocol ----------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        cols = object.__getattribute__(self, "_cols")
        if name in cols:
            return cols[name]
        meta = object.__getattribute__(self, "meta")
        if name in meta:
            return meta[name]
        if name.upper() in meta:
            return meta[name.upper()]
        raise AttributeError(f"object has no attribute {name!r}")

    def __setattr__(self, name, value):
        """Attribute assignment dispatches, in priority order, to: an
        existing instance attribute, a class property, an existing column,
        an existing meta key (exact case, then uppercase), and finally a
        plain new attribute — with a warning, since new attributes are not
        carried over by ``copy()`` (reference ``lightcurve.py:505-539``)."""
        if name == "meta" or name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if name in self.__dict__:
            object.__setattr__(self, name, value)
            return
        cls_attr = getattr(type(self), name, None)
        if isinstance(cls_attr, property):
            if cls_attr.fset is None:
                raise AttributeError(
                    f"can't set attribute {name!r} (read-only property)")
            cls_attr.fset(self, value)
            return
        if name in self.__dict__.get("_cols", ()):
            self._set_column(name, value)
            return
        meta = self.__dict__.get("meta", None)
        if meta is None:
            object.__setattr__(self, name, value)
            return
        if name in meta:
            meta[name] = value
            return
        if name.upper() in meta:
            meta[name.upper()] = value
            return
        warnings.warn(
            "Lightkurve doesn't allow columns or meta values to be created "
            "via a new attribute name. A new attribute is created. It will "
            "not be carried over when the object is copied.",
            UserWarning, stacklevel=2)
        object.__setattr__(self, name, value)

    # -- item protocol ------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, (list, tuple)) and key and \
                all(isinstance(k, str) for k in key):
            # column subset: required columns are always present, but the
            # ones NOT requested come back NaN-filled rather than copied
            # (reference test_select_columns_as_lightcurve, #1194)
            out = self.copy()
            cols = OrderedDict()
            for k in dict.fromkeys(list(self._required_columns) + list(key)):
                if k in key or k == "time":
                    cols[k] = self._cols[k]
                else:
                    src = self._cols[k]
                    unit = src.unit if isinstance(src, Quantity) \
                        else dimensionless
                    cols[k] = Quantity(np.full(len(self), np.nan), unit)
            out._cols = cols
            return out
        # row selection returns a sliced copy
        out = self.__class__.__new__(self.__class__)
        object.__setattr__(out, "meta", deepcopy(self.meta))
        cols = OrderedDict()
        if isinstance(key, (int, np.integer)):
            key = slice(key, key + 1) if key != -1 else slice(-1, None)
        for k, v in self._cols.items():
            cols[k] = v[key]
        object.__setattr__(out, "_cols", cols)
        return out

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self._set_column(key, value)
            return
        # Row assignment with a scalar, astropy-Table style: broadcast the
        # value into the selected rows of EVERY column (the reference's
        # ``lc[400:500] = np.nan``, tests/test_periodogram.py
        # test_periodogram_basics). Non-float columns raise, as astropy's
        # column casting does.
        if isinstance(key, (int, np.integer, slice, list, np.ndarray)):
            if not np.isscalar(value) and not (
                    isinstance(value, float) and np.isnan(value)):
                raise TypeError(
                    "Row assignment only supports scalar values.")
            from .time import TIME_FORMAT_OFFSETS
            for name, col in list(self._cols.items()):
                if isinstance(col, Time):
                    jd2 = np.array(col._jd2, dtype=np.float64, copy=True)
                    off = TIME_FORMAT_OFFSETS[col.format]
                    jd2[key] = float(value) + off - col._jd1
                    self._cols[name] = Time._from_jd12(
                        col._jd1, jd2, col.format, col.scale)
                elif isinstance(col, TimeDelta):
                    arr = np.array(col.to_value("d"), copy=True)
                    arr[key] = value
                    self._cols[name] = TimeDelta(arr)
                else:
                    arr = np.array(getattr(col, "value", col), copy=True)
                    arr[key] = value
                    unit = col.unit if isinstance(col, Quantity) else None
                    self._cols[name] = (Quantity(arr, unit)
                                        if unit is not None else arr)
            return
        raise TypeError("Row assignment requires an int, slice, or index "
                        "array; columns are assigned by name.")

    def __contains__(self, name):
        return name in self._cols

    # Opt out of numpy's ufunc protocol: a LightCurve is a column container,
    # not an array.  Without this, ``np.float64(3) * lc`` tries to iterate
    # the (sized, indexable) LightCurve into a nested object array and never
    # terminates; with it numpy returns NotImplemented and Python falls back
    # to our ``__rmul__`` (reference regression #925 semantics).
    __array_ufunc__ = None

    def __len__(self):
        return len(self.time)

    def __eq__(self, other):
        """Elementwise row equality over shared columns, like astropy
        ``Table.__eq__`` (used by reference test_collection_getitem:
        ``(lcc[0] == lc).all()``).  Returns a boolean array of length n.

        Length-mismatched comparisons raise ValueError, as astropy's
        table comparison does; note this makes ``lc in some_list`` (which
        boolean-coerces the elementwise result) unusable for LightCurves
        of any length > 1 — the same limitation astropy tables have."""
        if not isinstance(other, LightCurve):
            return NotImplemented
        if len(self) != len(other):
            raise ValueError(
                f"cannot compare LightCurves of different lengths "
                f"({len(self)} vs {len(other)})")
        out = np.ones(len(self), dtype=bool)
        for name in set(self.columns) | set(other.columns):
            if name not in self._cols or name not in other._cols:
                out[:] = False
                break
            a, b = self._cols[name], other._cols[name]
            av = a.value if isinstance(a, (Quantity, Time)) else np.asarray(a)
            bv = b.value if isinstance(b, (Quantity, Time)) else np.asarray(b)
            try:
                out &= np.asarray(av == bv).reshape(len(self))
            except (TypeError, ValueError):
                out[:] = False
                break
        return out

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else ~eq

    # identity hash (like ``id``-based default): rows are mutable, so
    # value-hashing is impossible, but collections/dedup still work
    __hash__ = object.__hash__

    def __repr__(self):
        cols = ", ".join(self.columns)
        return (f"<{type(self).__name__} length={len(self)} "
                f"columns=[{cols}]>")

    def _repr_html_(self):
        """Notebook HTML repr; must work for any length incl. single rows
        (reference regression #830)."""
        head = "".join(f"<th>{c}</th>" for c in self.columns)
        rows = []
        for i in range(min(len(self), 10)):
            cells = []
            for c in self.columns:
                v = self._cols[c]
                vv = v.value if isinstance(v, (Quantity, Time)) \
                    else np.asarray(v)
                cells.append(f"<td>{vv[i]}</td>")
            rows.append("<tr>" + "".join(cells) + "</tr>")
        more = (f"<tr><td colspan={len(self.columns)}>… "
                f"({len(self)} rows total)</td></tr>"
                if len(self) > 10 else "")
        return (f"<table><thead><tr>{head}</tr></thead>"
                f"<tbody>{''.join(rows)}{more}</tbody></table>")

    def copy(self):
        out = self.__class__.__new__(self.__class__)
        object.__setattr__(out, "meta", deepcopy(self.meta))
        object.__setattr__(
            out, "_cols",
            OrderedDict((k, _copy_col(v)) for k, v in self._cols.items()))
        return out

    def remove_column(self, name):
        if name in self._required_columns:
            raise ValueError(f"Cannot remove required column '{name}'")
        del self._cols[name]

    def add_column(self, values, name=None, index=None):
        self._set_column(name, values)
        if index is not None:
            keys = [k for k in self._cols if k != name]
            keys.insert(index, name)
            object.__setattr__(self, "_cols",
                               OrderedDict((k, self._cols[k]) for k in keys))

    def keys(self):
        return self.columns

    # ------------------------------------------------------------------
    # arithmetic with error propagation (reference lightcurve.py:764-859)
    # ------------------------------------------------------------------
    def _check_compat(self, other, verb):
        if len(self) != len(other):
            raise ValueError(
                f"Cannot {verb} LightCurve objects because they do not have "
                f"equal length ({len(self)} vs {len(other)}).")
        if np.any(self.time.value != other.time.value):
            warnings.warn(
                f"Two LightCurve objects with inconsistent time values are "
                f"being {verb}ed.", LightkurveWarning)

    def __add__(self, other):
        newlc = self.copy()
        if isinstance(other, LightCurve):
            self._check_compat(other, "add")
            newlc.flux = self.flux + other.flux
            newlc.flux_err = Quantity(
                np.hypot(self.flux_err.value, other.flux_err.to(
                    self.flux_err.unit).value), self.flux_err.unit)
        else:
            newlc.flux = self.flux + other
        return newlc

    __radd__ = __add__

    def __sub__(self, other):
        return self.__add__(-1 * other)

    def __rsub__(self, other):
        return (-1 * self).__add__(other)

    def __mul__(self, other):
        newlc = self.copy()
        if isinstance(other, LightCurve):
            self._check_compat(other, "multiply")
            newlc.flux = self.flux * other.flux
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.hypot(self.flux_err.value / self.flux.value,
                               other.flux_err.value / other.flux.value)
            newlc.flux_err = Quantity(np.abs(newlc.flux.value) * rel,
                                      newlc.flux.unit)
        elif isinstance(other, Unit):
            newlc.flux = self.flux * other
            newlc.flux_err = self.flux_err * other
        else:
            newlc.flux = self.flux * other
            newlc.flux_err = self.flux_err * np.abs(other)
        return newlc

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, LightCurve):
            newlc = self.copy()
            self._check_compat(other, "divide")
            newlc.flux = self.flux / other.flux
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.hypot(self.flux_err.value / self.flux.value,
                               other.flux_err.value / other.flux.value)
            newlc.flux_err = Quantity(np.abs(newlc.flux.value) * rel,
                                      newlc.flux.unit)
            return newlc
        return self.__mul__(1.0 / other if not isinstance(other, Unit)
                            else other ** -1)

    def __rtruediv__(self, other):
        newlc = self.copy()
        if isinstance(other, LightCurve):
            return other.__truediv__(self)
        newlc.flux = other / self.flux
        with np.errstate(divide="ignore", invalid="ignore"):
            newlc.flux_err = Quantity(
                np.abs(newlc.flux.value)
                * np.abs(self.flux_err.value / self.flux.value),
                newlc.flux.unit)
        return newlc

    # ------------------------------------------------------------------
    # core operations
    # ------------------------------------------------------------------
    def select_flux(self, flux_column, flux_err_column=None):
        """Use a different column as ``flux`` (reference ``:612-698``)."""
        if flux_column not in self.columns:
            raise ValueError(f"'{flux_column}' is not a column")
        if flux_err_column and flux_err_column not in self.columns:
            raise ValueError(f"'{flux_err_column}' is not a column")
        lc = self.copy()
        new_flux = _to_unitful(lc[flux_column])
        lc["flux"] = new_flux
        if not flux_err_column:
            flux_err_column = f"{flux_column}_err"
        if flux_err_column in lc.columns:
            new_err = _to_unitful(lc[flux_err_column])
        else:
            new_err = Quantity(np.full(len(lc), np.nan), new_flux.unit)
        if new_flux.unit.bases != new_err.unit.bases:
            raise ValueError(
                f"Columns '{flux_column}' and '{flux_err_column}' have "
                f"different units")
        lc["flux_err"] = new_err
        lc.meta["FLUX_ORIGIN"] = flux_column
        if not new_flux.unit.bases:
            lc.meta["NORMALIZED"] = True
        else:
            lc.meta.pop("NORMALIZED", None)
        return lc

    def normalize(self, unit="unscaled"):
        """Divide flux and flux_err by the median (reference ``:1216-1298``).

        Examples
        --------
        >>> import lightkurve_tpu_torch as lk
        >>> lc = lk.LightCurve(time=[1, 2, 3],
        ...                    flux=[25945.7, 25901.5, 25931.2],
        ...                    flux_err=[6.8, 4.6, 6.2])
        >>> normalized_lc = lc.normalize()
        >>> print(normalized_lc.flux.value.round(8).tolist())
        [1.00055917, 0.99885466, 1.0]
        """
        validate_method(unit, ["unscaled", "percent", "ppt", "ppm"])
        median_flux = np.nanmedian(self.flux.value)
        std_flux = np.nanstd(self.flux.value)
        if (median_flux == 0) or (np.isfinite(std_flux)
                                  and abs(median_flux) < 0.5 * std_flux):
            warnings.warn(
                "The light curve appears to be zero-centered "
                f"(median={median_flux:.2e} +/- {std_flux:.2e}); `normalize()`"
                " will divide the light curve by a value close to zero, which"
                " is probably not what you want.", LightkurveWarning)
        if median_flux < 0:
            warnings.warn(
                f"The light curve has a negative median flux "
                f"({median_flux:.2e}); `normalize()` will therefore divide by"
                f" a negative number and invert the light curve, which is "
                f"probablynot what you want", LightkurveWarning)
        lc = self.copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            lc.flux = Quantity(self.flux.value / median_flux, dimensionless)
            lc.flux_err = Quantity(self.flux_err.value / median_flux,
                                   dimensionless)
        if unit == "percent":
            lc.flux = lc.flux.to(percent)
            lc.flux_err = lc.flux_err.to(percent)
        elif unit == "ppt":
            lc.flux = lc.flux.to(ppt)
            lc.flux_err = lc.flux_err.to(ppt)
        elif unit == "ppm":
            lc.flux = lc.flux.to(ppm)
            lc.flux_err = lc.flux_err.to(ppm)
        lc.meta["NORMALIZED"] = True
        return lc

    def remove_nans(self, column="flux"):
        """Drop cadences where ``column`` is NaN (reference ``:1300-1327``).

        Examples
        --------
        >>> import numpy as np
        >>> import lightkurve_tpu_torch as lk
        >>> lc = lk.LightCurve({'time': [1, 2, 3], 'flux': [1., np.nan, 1.]})
        >>> len(lc.remove_nans())
        2
        """
        col = self._cols[column]
        vals = col.value if isinstance(col, Quantity) else np.asarray(col)
        return self[~np.isnan(vals)]

    def remove_outliers(self, sigma=5.0, sigma_lower=None, sigma_upper=None,
                        return_mask=False, column="flux", **kwargs):
        """Sigma-clip ``column`` and drop outlier rows (ref ``:1429-1549``;
        :func:`~lightkurve_tpu_torch.ops.stats.sigma_clip_mask` on the
        configured device and dtype)."""
        from .ops.stats import sigma_clip_mask
        col = self._cols[column]
        vals = col.value if isinstance(col, Quantity) else np.asarray(col)
        outlier = sigma_clip_mask(
            _tensor(vals), sigma=sigma, sigma_lower=sigma_lower,
            sigma_upper=sigma_upper, **kwargs).cpu().numpy()
        if return_mask:
            return self[~outlier], outlier
        return self[~outlier]

    def flatten(self, window_length=101, polyorder=2, return_trend=False,
                break_tolerance=5, niters=3, sigma=3, mask=None, **kwargs):
        """Remove low-frequency trends with an SG filter (ref ``:943-1078``).

        The pipeline (compaction, gap segmentation, SG smoothing,
        iterative clipping, trend interpolation) runs as torch functions
        on the configured device and dtype
        (:func:`lightkurve_tpu_torch.ops.detrend.flatten`), with every
        segment's own median in the short-segment fallback.  The times stay
        float64 whatever the dtype: gaps are found where the reference
        finds them (a BTJD time in float32 is 1.2e-4 d coarse, against a
        TESS cadence of 1.4e-3 d).  On a CUDA device the flatten is a CUDA
        graph captured on the first curve of a length and settings, and
        replayed for the next (:class:`~.ops.detrend.FlattenGraph`).
        """
        from .ops.detrend import FlattenGraph
        from .ops.detrend import flatten as flatten_op
        from .ops.savgol import savgol_design_matrix

        window_length = int(window_length)
        if polyorder >= window_length:
            polyorder = window_length - 1
        if window_length % 2 == 0:
            window_length += 1

        n = len(self)
        with span("lc.flatten", cadences=n):
            with span("lc.flatten.host"):
                tv = self.time.value.astype(float)
                fv = self.flux.value.astype(float)
                if mask is None:
                    keep = np.ones(n, dtype=bool)
                else:
                    keep = ~np.asarray(mask, dtype=bool)
                # NaN & global outlier pre-mask (reference :1003-1010)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    extra = np.isfinite(fv)
                    extra &= np.nan_to_num(np.abs(fv - np.nanmedian(fv))) \
                        <= (np.nanstd(fv) * sigma)
                keep &= extra
                bt = np.nan if break_tolerance is None else \
                    float(break_tolerance)
                key = (n, str(config.resolve_device(None)),
                       config.resolve_dtype(None), window_length, polyorder,
                       None if np.isnan(bt) else bt, float(sigma),
                       int(niters))
                graph = _FLATTEN_GRAPHS.get(key)
                H = None if graph is not None else savgol_design_matrix(
                    window_length, polyorder)
            args = (_tensor(tv, torch.float64), _tensor(fv),
                    _tensor(keep, torch.bool))
            if graph is None and args[1].is_cuda:
                while len(_FLATTEN_GRAPHS) >= _FLATTEN_GRAPHS_KEPT:
                    _FLATTEN_GRAPHS.pop(next(iter(_FLATTEN_GRAPHS)))
                graph = _FLATTEN_GRAPHS[key] = FlattenGraph(
                    *args, _tensor(H, torch.float64).to(args[1].dtype), bt,
                    sigma, niters)
            if graph is not None:
                trend, _ = graph(*args)
            else:
                trend, _ = flatten_op(*args, H, bt, float(sigma),
                                      niters=int(niters), max_segments=None)
            with span("lc.flatten.out"):
                # the copy while the card still runs the flatten
                flatten_lc = self.copy()
                trend = trend.cpu().numpy().astype(float)
                count("host_sync")
                with np.errstate(divide="ignore", invalid="ignore"):
                    flatten_lc.flux = Quantity(fv / trend, dimensionless)
                    flatten_lc.flux_err = Quantity(
                        self.flux_err.value / trend, dimensionless)
                flatten_lc.meta["NORMALIZED"] = True
                if return_trend:
                    trend_lc = self.copy()
                    trend_lc.flux = Quantity(trend, self.flux.unit)
                    return flatten_lc, trend_lc
                return flatten_lc

    def fold(self, period=None, epoch_time=None, epoch_phase=0,
             wrap_phase=None, normalize_phase=False):
        """Phase-fold into a :class:`FoldedLightCurve` (ref ``:1089-1214``)."""
        if period is None:
            raise ValueError("fold() requires a `period`")
        period_d = _as_days(period)
        if epoch_time is not None and not isinstance(epoch_time, Time):
            epoch_time = Time(epoch_time, format=self.time.format,
                              scale=self.time.scale)
        if epoch_time is not None and epoch_time.value > 2450000 and \
                self.time.format in ("bkjd", "btjd"):
            warnings.warn(
                f"`epoch_time` appears to be given in JD, however the light "
                f"curve time uses {self.time.format.upper()}.",
                LightkurveWarning)

        t = self.time.value.astype(np.float64)
        t0 = t[0] if epoch_time is None else epoch_time.to_value(
            self.time.format)
        if normalize_phase:
            eph = float(epoch_phase) * period_d
            wrap = period_d * (0.5 if wrap_phase is None else float(wrap_phase))
        else:
            eph = _as_days(epoch_phase) if epoch_phase is not None else 0.0
            wrap = period_d * 0.5 if wrap_phase is None else _as_days(wrap_phase)
        phase = np.mod(t - t0 + eph, period_d)
        phase = np.where(phase >= wrap, phase - period_d, phase)

        lc = FoldedLightCurve.__new__(FoldedLightCurve)
        object.__setattr__(lc, "meta", deepcopy(self.meta))
        cols = OrderedDict()
        if normalize_phase:
            cols["time"] = Time(phase / period_d, format="jd",
                                scale=self.time.scale)
        else:
            cols["time"] = Time(phase, format="jd", scale=self.time.scale)
        for k, v in self._cols.items():
            if k != "time":
                cols[k] = _copy_col(v)
        cols["time_original"] = self.time.copy()
        object.__setattr__(lc, "_cols", cols)
        lc.meta["PERIOD"] = Quantity(period_d, "d")
        lc.meta["EPOCH_TIME"] = Time(t0, format=self.time.format,
                                     scale=self.time.scale)
        lc.meta["EPOCH_PHASE"] = epoch_phase
        lc.meta["WRAP_PHASE"] = wrap
        lc.meta["NORMALIZE_PHASE"] = bool(normalize_phase)
        order = np.argsort(phase, kind="stable")
        return lc[order]

    def bin(self, time_bin_size=None, time_bin_start=None,
            time_bin_end=None, n_bins=None, aggregate_func=None, bins=None,
            binsize=None):
        """Bin into time intervals (reference ``:1558-1762``).

        ``aggregate_func`` (default nanmean) combines flux and the other
        numeric data columns within each bin; a callable (e.g.
        ``np.nanmedian``) is applied per bin.  ``flux_err`` is always
        aggregated as root-mean-square if present, else as the per-bin
        standard deviation of the flux (reference ``:1727-1750``).

        ``time_bin_start`` may be an array of per-bin start times (with
        bins then ending at the next start, or at ``time_bin_end`` —
        scalar for the final edge, array for non-contiguous bins), as in
        astropy's ``aggregate_downsample``.
        """
        if binsize is not None and bins is not None:
            raise ValueError("Only one of ``bins`` and ``binsize`` can be "
                             "specified.")
        if (binsize is not None or bins is not None) and \
                (time_bin_size is not None or n_bins is not None):
            raise ValueError("``bins`` or ``binsize`` conflicts with "
                             "``n_bins`` or ``time_bin_size``.")
        if time_bin_size is not None and time_bin_end is not None:
            raise ValueError("``time_bin_end`` cannot be given together "
                             "with ``time_bin_size``.")
        tv = self.time.value.astype(np.float64)

        def _times_value(x):
            if isinstance(x, Time):
                return np.asarray(x.to_value(self.time.format),
                                  dtype=np.float64)
            return np.asarray(x, dtype=np.float64)

        # array-valued time_bin_start: variable-width bins
        if time_bin_start is not None and np.ndim(time_bin_start) > 0:
            starts = _times_value(time_bin_start)
            if time_bin_size is not None:
                sizes = np.broadcast_to(
                    np.atleast_1d(_as_days(time_bin_size)), starts.shape)
                ends = starts + sizes
            elif time_bin_end is None:
                raise ValueError("array-valued ``time_bin_start`` requires "
                                 "``time_bin_end`` or ``time_bin_size``.")
            elif np.ndim(time_bin_end) > 0:
                ends = _times_value(time_bin_end)
                if len(ends) != len(starts):
                    raise ValueError("``time_bin_end`` must match "
                                     "``time_bin_start`` in length.")
            else:
                ends = np.append(starts[1:],
                                 _times_value(time_bin_end))
            return self._bin_by_times(starts, ends, aggregate_func)

        if time_bin_start is None:
            start = tv[0]
        else:
            start = float(_times_value(time_bin_start))

        if time_bin_size is not None:
            size = _as_days(time_bin_size)
        elif bins is not None:
            if isinstance(bins, str):
                if bins in ("blocks", "knuth", "scott", "freedman"):
                    # automatic bin-edge rule over the time values
                    # (reference lightcurve.py:1670-1677 via astropy's
                    # calculate_bin_edges; the rules are shift-invariant,
                    # so native time values ≡ the reference's mjd)
                    from .utils import calculate_bin_edges
                    edges = calculate_bin_edges(tv, bins)
                    return self._bin_by_times(edges[:-1], edges[1:],
                                              aggregate_func,
                                              close_last=True)
                raise TypeError("``bins`` must have integer type.")
            if np.size(bins) == 1:
                if not isinstance(bins, (int, np.integer)):
                    raise TypeError("``bins`` must have integer type.")
                span = tv[-1] - start
                size = span / int(bins) * (1 + 1e-10)
            else:
                # a sequence gives explicit time bin EDGES: N fenceposts
                # make N-1 bins (reference test_bins_kwarg)
                edges = np.asarray(bins, dtype=np.float64)
                return self._bin_by_times(edges[:-1], edges[1:],
                                          aggregate_func, close_last=True)
        elif binsize is not None:
            idx = np.arange(0, len(tv), int(binsize))
            return self._bin_by_edges(np.append(idx, len(tv) - 1),
                                      aggregate_func)
        elif time_bin_end is not None:
            # scalar end with contiguous bins: size from the full span
            end = float(_times_value(time_bin_end))
            nb0 = max(int(n_bins) if n_bins is not None else 1, 1)
            size = (end - start) / nb0
        else:
            size = 0.5  # days (reference default)

        if n_bins is None:
            nb = max(int(np.ceil((tv[-1] - start) / size + 1e-10)), 1)
        else:
            nb = int(n_bins)
        ids = np.floor((tv - start) / size).astype(int)
        return self._bin_core(ids, nb, start + (np.arange(nb) + 0.5) * size,
                              aggregate_func)

    def _bin_by_times(self, starts, ends, aggregate_func=None,
                      close_last=False):
        """Bin into explicit, possibly non-contiguous [start, end) bins.
        ``close_last=True`` makes the FINAL bin right-inclusive (the
        np.histogram convention used for explicit ``bins=`` edges, so a
        cadence exactly at the last fencepost is kept)."""
        tv = self.time.value.astype(np.float64)
        nb = len(starts)
        ids = np.searchsorted(starts, tv, side="right") - 1
        idc = np.clip(ids, 0, nb - 1)
        # points past their bin's end fall in no bin
        in_bin = (ids >= 0) & (tv < ends[idc])
        if close_last:
            in_bin |= (ids == nb - 1) & (tv == ends[-1])
        ids = np.where(in_bin, ids, -1)
        return self._bin_core(ids, nb, 0.5 * (starts + ends),
                              aggregate_func)

    def _bin_by_edges(self, edge_indices, aggregate_func=None):
        tv = self.time.value.astype(np.float64)
        starts = tv[edge_indices[:-1]]
        ends = tv[edge_indices[1:]]
        nb = len(starts)
        ids = np.searchsorted(starts, tv, side="right") - 1
        ids[tv >= ends[-1]] = nb - 1
        return self._bin_core(ids, nb, 0.5 * (starts + ends),
                              aggregate_func)

    def _bin_core(self, ids, nb, mid_times, aggregate_func):
        tv = self.time.value
        in_range = (ids >= 0) & (ids < nb)
        idc = np.clip(ids, 0, nb - 1)

        def agg(values, how):
            out = np.full(nb, np.nan)
            if callable(how):
                # arbitrary per-bin aggregation (e.g. np.nanmedian), as
                # astropy aggregate_downsample applies a callable
                sel = in_range
                order = np.argsort(idc[sel], kind="stable")
                vals_s = values[sel][order]
                ids_s = idc[sel][order]
                bounds = np.searchsorted(ids_s, np.arange(nb + 1))
                for i in range(nb):
                    lo, hi = bounds[i], bounds[i + 1]
                    if hi > lo:
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore", RuntimeWarning)
                            out[i] = how(vals_s[lo:hi])
                return out
            valid = in_range & np.isfinite(values)
            if not valid.any():
                return out
            cnt = np.bincount(idc[valid], minlength=nb).astype(float)
            nz = cnt > 0
            if how == "mean":
                s = np.bincount(idc[valid], weights=values[valid],
                                minlength=nb)
                out[nz] = s[nz] / cnt[nz]
            elif how == "rmse":
                s = np.bincount(idc[valid], weights=values[valid] ** 2,
                                minlength=nb)
                out[nz] = np.sqrt(s[nz] / cnt[nz])
            elif how == "std":
                s = np.bincount(idc[valid], weights=values[valid],
                                minlength=nb)
                mean = np.zeros(nb)
                mean[nz] = s[nz] / cnt[nz]
                d2 = (values - mean[idc]) ** 2
                s2 = np.bincount(idc[valid], weights=d2[valid], minlength=nb)
                out[nz] = np.sqrt(s2[nz] / cnt[nz])
            return out

        if aggregate_func is None:
            flux_how = "mean"
        elif isinstance(aggregate_func, str) or callable(aggregate_func):
            flux_how = aggregate_func
        else:
            raise TypeError("aggregate_func must be a callable or one of "
                            "'mean', 'rmse', 'std'")

        new_cols = OrderedDict()
        new_cols["time"] = Time(mid_times, format=self.time.format,
                                scale=self.time.scale)
        fv = self.flux.value
        new_cols["flux"] = Quantity(agg(fv, flux_how), self.flux.unit)
        if np.any(np.isfinite(self.flux_err.value)):
            new_cols["flux_err"] = Quantity(agg(self.flux_err.value, "rmse"),
                                            self.flux_err.unit)
        else:
            new_cols["flux_err"] = Quantity(agg(fv, "std"), self.flux.unit)
        for k, v in self._cols.items():
            if k in ("time", "flux", "flux_err"):
                continue
            vals = v.value if isinstance(v, Quantity) else np.asarray(v)
            if k == "quality" and vals.dtype.kind in "iu":
                # quality bitmasks combine by bitwise OR (reference
                # test_binned_quality)
                q = np.zeros(nb, dtype=vals.dtype)
                np.bitwise_or.at(q, idc[in_range], vals[in_range])
                new_cols[k] = q
            elif vals.dtype.kind in "iuf" and vals.ndim == 1:
                # aggregate_func applies to every data column, as in
                # astropy's aggregate_downsample (reference :1714-1725)
                binned = agg(vals.astype(float), flux_how)
                new_cols[k] = Quantity(binned, v.unit) \
                    if isinstance(v, Quantity) else binned
        out = self.__class__.__new__(self.__class__)
        object.__setattr__(out, "meta", deepcopy(self.meta))
        object.__setattr__(out, "_cols", new_cols)
        return out

    @classmethod
    def read(cls, path, format=None, **kwargs):
        """Read a light-curve file, auto-detecting the product type
        (reference astropy unified-I/O ``LightCurve.read``).  ASCII
        table formats (``ascii.csv``, ``ascii.tab``, ``ascii.basic``,
        ``csv``) are read with pandas, as astropy Table's unified I/O
        reads them (reference io test_basic_ascii_io)."""
        sep = _ASCII_FORMAT_SEPARATORS.get(format)
        if sep is not None:
            import pandas as pd
            df = pd.read_csv(path, sep=sep)
            cols = {c: df[c].to_numpy() for c in df.columns}
            time = cols.pop("time", None)
            flux = cols.pop("flux", None)
            flux_err = cols.pop("flux_err", None)
            lc = cls(time=time, flux=flux, flux_err=flux_err)
            for name, values in cols.items():
                lc[name] = values
            return lc
        from .io.read import read as _read
        return _read(path, filetype=_format_to_filetype(format),
                     **kwargs)

    def write(self, path, format="ascii.csv", overwrite=False, **kwargs):
        """Write to an ASCII table (pandas) or a FITS file (subset of
        astropy Table's unified-I/O formats used by the reference
        tests)."""
        import os as _os
        if _os.path.exists(_os.fspath(path)) and not overwrite:
            raise OSError(
                f"File {path} already exists. "
                "If you mean to replace it then use the argument "
                "\"overwrite=True\".")
        if format == "fits":
            return self.to_fits(path=path, overwrite=True, **kwargs)
        sep = _ASCII_FORMAT_SEPARATORS.get(format)
        if sep is None:
            raise ValueError(
                f"Unsupported write format {format!r}; supported: "
                f"{sorted(_ASCII_FORMAT_SEPARATORS)} and 'fits'.")
        import pandas as pd
        data = {}
        for name, col in self._cols.items():
            if isinstance(col, Time):
                data[name] = _strip_quantity(col.value)
            elif isinstance(col, TimeDelta):
                data[name] = _strip_quantity(col.to_value("d"))
            else:
                data[name] = _strip_quantity(col)
        pd.DataFrame(data).to_csv(path, sep=sep, index=False)

    def fill_gaps(self, method="gaussian_noise", seed=None):
        """Fill gaps in time with Gaussian noise (reference ``:1329-1427``).

        ``seed`` (extension over the reference, SURVEY §7f RNG policy):
        seeds the noise generator for reproducible fills; the default
        ``None`` draws fresh entropy.  No global ``np.random`` state is
        touched either way.
        """
        rng = np.random.default_rng(seed)
        lc = self.remove_nans()
        tv = lc.time.value
        newdata = {}
        if "cadenceno" in lc._cols:
            cad = np.asarray(lc._cols["cadenceno"]).astype(int)
            med_dt = np.median(np.diff(tv))
            dt = tv - med_dt * cad
            ncad = np.arange(cad[0], cad[-1] + 1)
            missing = ncad[~np.isin(ncad, cad)]
            ndt = np.interp(missing, cad, dt)
            allcad = np.concatenate([missing, cad])
            alldt = np.concatenate([ndt, dt])
            order = np.argsort(allcad)
            allcad, alldt = allcad[order], alldt[order]
            ntime = alldt + med_dt * allcad
            in_original = np.isin(allcad, cad)
            newdata["cadenceno"] = allcad
        else:
            dt = np.nanmedian(np.diff(tv))
            ntime = [tv[0]]
            for t in tv[1:]:
                prev = ntime[-1]
                while (t - prev) > 1.2 * dt:
                    ntime.append(prev + dt)
                    prev = ntime[-1]
                ntime.append(t)
            ntime = np.asarray(ntime, dtype=float)
            in_original = np.isin(ntime, tv)

        n_new = len(ntime)
        f = np.zeros(n_new)
        f[in_original] = lc.flux.value
        fe = np.zeros(n_new)
        fe[in_original] = lc.flux_err.value
        fe[~in_original] = np.interp(ntime[~in_original], tv,
                                     lc.flux_err.value)
        if method == "gaussian_noise":
            try:
                std = lc.estimate_cdpp().to(dimensionless).value \
                    * np.nanmedian(lc.flux.value)
            except Exception:
                std = np.nanstd(lc.flux.value)
            if not np.isfinite(std):
                std = np.nanstd(lc.flux.value)
            f[~in_original] = rng.normal(np.nanmean(lc.flux.value),
                                         std, (~in_original).sum())
        else:
            raise NotImplementedError(f"No such method as {method}")
        newdata["time"] = Time(ntime, format=lc.time.format,
                               scale=lc.time.scale)
        newdata["flux"] = Quantity(f, lc.flux.unit)
        newdata["flux_err"] = Quantity(fe, lc.flux_err.unit)
        if "quality" in lc._cols:
            q = np.zeros(n_new, dtype=np.asarray(lc._cols["quality"]).dtype)
            q[in_original] = np.asarray(lc._cols["quality"])
            q[~in_original] += 65536
            newdata["quality"] = q
        return LightCurve(data=newdata, meta=deepcopy(self.meta))

    def estimate_cdpp(self, transit_duration=13, savgol_window=101,
                      savgol_polyorder=2, sigma=5.0):
        """sgCDPP proxy noise metric in ppm (reference ``:1764-1833``)."""
        if not isinstance(transit_duration, int):
            raise ValueError("transit_duration must be an integer in units "
                             f"number of cadences, got {transit_duration}.")
        detrended = self.flatten(window_length=savgol_window,
                                 polyorder=savgol_polyorder)
        cleaned = detrended.remove_outliers(sigma=sigma)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*already.*")
            warnings.simplefilter("ignore", LightkurveWarning)
            normalized = cleaned.normalize("ppm")
        mean = running_mean(normalized.flux.value, transit_duration)
        return Quantity(np.std(mean), ppm)

    def create_transit_mask(self, period, transit_time, duration):
        """Boolean in-transit mask for one or more planets (ref ``:2967``)."""
        def listify(x):
            if isinstance(x, Quantity) and x.ndim == 0:
                return [x]
            return np.atleast_1d(x)

        period = [_as_days(p) for p in listify(period)]
        duration = [_as_days(d) for d in listify(duration)]
        transit_time = [
            tt.to_value(self.time.format) if isinstance(tt, Time)
            else float(tt) for tt in listify(transit_time)]
        if not (len(period) == len(duration) == len(transit_time)):
            raise ValueError("period, transit_time, and duration must have "
                             "the same number of values.")
        t = self.time.value
        mask = np.zeros(len(t), dtype=bool)
        for p, t0, d in zip(period, transit_time, duration):
            hp = 0.5 * p
            mask |= np.abs(np.mod(t - t0 + hp, p) - hp) < 0.5 * d
        return mask

    def append(self, others, inplace=False):
        """Concatenate one or more light curves after this one
        (reference ``lightcurve.py:900-941``)."""
        if inplace:
            raise ValueError("the `inplace` parameter is no longer "
                             "supported; `append()` returns a new object")
        if not hasattr(others, "__iter__"):
            others = [others]
        from .collections import LightCurveCollection
        return LightCurveCollection([self] + list(others)).stitch(
            corrector_func=None)

    def truncate(self, before=None, after=None, column="time"):
        """Truncate to rows where before <= column <= after.

        ``column`` may also name a plain attribute, like the reference's
        ``getattr``-based lookup (``lightcurve.py:3155-3163``)."""
        vals = self._cols.get(column)
        if vals is None:
            vals = getattr(self, column)
        vals = vals.value if isinstance(vals, (Quantity, Time)) \
            else np.asarray(vals)
        mask = np.ones(len(self), dtype=bool)
        if before is not None:
            mask &= vals >= before
        if after is not None:
            mask &= vals <= after
        return self[mask]

    def head(self, n=5):
        return self[:n]

    def tail(self, n=5):
        return self[-n:] if n < len(self) else self.copy()

    # ------------------------------------------------------------------
    # dispatchers
    # ------------------------------------------------------------------
    def to_periodogram(self, method="lombscargle", **kwargs):
        """Compute a periodogram; 'lombscargle'/'ls' or 'boxleastsquares'/'bls'
        (reference ``:2490-2535``)."""
        supported = ("ls", "bls", "lombscargle", "boxleastsquares")
        method = validate_method(method, supported)
        if method in ("bls", "boxleastsquares"):
            from .periodogram import BoxLeastSquaresPeriodogram
            return BoxLeastSquaresPeriodogram.from_lightcurve(lc=self,
                                                              **kwargs)
        from .periodogram import LombScarglePeriodogram
        return LombScarglePeriodogram.from_lightcurve(lc=self, **kwargs)

    def search_neighbors(self, limit=10, radius=3600.0, **search_criteria):
        """Search for light curves around this target (reference
        ``lightcurve.py:843-848``): :func:`.search.search_lightcurve` of
        its TARGETID (else LABEL) within ``radius`` arcsec."""
        from .search import search_lightcurve
        target = self.meta.get("TARGETID", self.meta.get("LABEL"))
        return search_lightcurve(f"{target}", radius=radius, limit=limit + 1,
                                 **search_criteria)

    def interact_bls(self, notebook_url=None, minimum_period=None,
                     maximum_period=None, resolution=2000, html=None):
        """The BLS explorer: with ``html="path.html"`` a standalone page
        whose period grid (at least 20,000 periods) is precomputed on
        :data:`config.default_device`
        (:func:`.interact.show_interact_widget_bls`); without it, not
        ported."""
        from .interact import show_interact_widget_bls
        return show_interact_widget_bls(
            self, notebook_url=notebook_url, minimum_period=minimum_period,
            maximum_period=maximum_period, resolution=resolution, html=html)

    def to_seismology(self, **kwargs):
        """A :class:`~lightkurve_tpu_torch.seismology.Seismology` of this
        curve's flattened periodogram (reference ``:1358``)."""
        from .seismology import Seismology
        return Seismology.from_lightcurve(self, **kwargs)

    def to_corrector(self, method="sff", **kwargs):
        """Return a corrector: 'sff' or 'cbv' (reference ``:2732-2764``)."""
        if method == "pld":
            raise ValueError(
                "The 'pld' method can only be used on "
                "`TargetPixelFile` objects, not `LightCurve` objects.")
        method = validate_method(method, supported_methods=["sff", "cbv"])
        if method == "sff":
            from .correctors import SFFCorrector
            return SFFCorrector(self, **kwargs)
        from .correctors import CBVCorrector
        return CBVCorrector(self, **kwargs)

    # ------------------------------------------------------------------
    # exports
    # ------------------------------------------------------------------
    def to_pandas(self):
        """The columns as a `pandas.DataFrame` indexed by time."""
        import pandas as pd
        data = {}
        for k, v in self._cols.items():
            data[k] = _strip_quantity(v.value if isinstance(v, Time) else v)
        df = pd.DataFrame(data)
        df.index = df["time"]
        df.index.name = "time"
        return df.drop(columns=["time"])

    def to_csv(self, path_or_buf=None, **kwargs):
        """:meth:`to_pandas` written by ``DataFrame.to_csv``."""
        # pandas 2.x renamed ``line_terminator`` to ``lineterminator``;
        # accept the old spelling used by the reference's test suite.
        if "line_terminator" in kwargs:
            kwargs["lineterminator"] = kwargs.pop("line_terminator")
        df = self.to_pandas()
        return df.to_csv(path_or_buf=path_or_buf, **kwargs)

    def to_excel(self, path_or_buf, **kwargs):
        """:meth:`to_pandas` written by ``DataFrame.to_excel``."""
        self.to_pandas().to_excel(path_or_buf, **kwargs)

    def to_table(self):
        return dict(self._cols)

    def to_timeseries(self):
        return self

    def to_stingray(self):
        """The `stingray` package is not a dependency: raises."""
        raise ImportError("the `stingray` package is not available in this "
                          "environment")

    @staticmethod
    def from_stingray(lc):
        """The `stingray` package is not a dependency: raises."""
        raise ImportError("the `stingray` package is not available in this "
                          "environment")

    def to_fits(self, path=None, overwrite=False, flux_column_name="FLUX",
                **extra_data):
        """Write a Kepler-style FITS light-curve file (ref ``:2552-2730``)."""
        from .io.writers import lightcurve_to_fits
        return lightcurve_to_fits(self, path=path, overwrite=overwrite,
                                  flux_column_name=flux_column_name,
                                  **extra_data)

    # ------------------------------------------------------------------
    # plotting
    # ------------------------------------------------------------------
    def _create_plot(self, method="plot", column="flux", ax=None,
                     normalize=False, xlabel=None, ylabel=None, title="",
                     style="lightkurve", show_colorbar=True,
                     colorbar_label="", offset=None, clip_outliers=False,
                     **kwargs):
        import matplotlib.pyplot as plt
        flux = self._cols[column]
        if not isinstance(flux, Quantity):
            flux = Quantity(_strip_quantity(flux).astype(float),
                            dimensionless)
        lc = self
        if normalize:
            lc = self.normalize()
            flux = lc.flux if column == "flux" else lc._cols[column]
        if ax is None:
            _, ax = plt.subplots(1)
        if ylabel is None:
            ylabel = "Normalized Flux" if (normalize or self.meta.get(
                "NORMALIZED")) else "Flux"
            if str(flux.unit):
                ylabel += f" [{flux.unit}]"
        if xlabel is None:
            if isinstance(self, FoldedLightCurve):
                xlabel = "Phase [JD]" if not self.meta.get(
                    "NORMALIZE_PHASE") else "Phase"
            else:
                xlabel = f"Time [{self.time.format.upper()}]"
        x = _strip_quantity(self.time.value)
        y = _strip_quantity(flux).astype(float)
        if offset is not None:
            y = y + offset
        label = kwargs.pop("label", self.meta.get("LABEL"))
        if method == "plot":
            ax.plot(x, y, label=label, **kwargs)
        elif method == "scatter":
            sc = ax.scatter(x, y, label=label, **kwargs)
            if show_colorbar and "c" in kwargs and not isinstance(
                    kwargs["c"], str):
                cbar = plt.colorbar(sc, ax=ax)
                cbar.set_label(colorbar_label)
        else:
            yerr = _strip_quantity(kwargs.pop("yerr", self.flux_err))
            ax.errorbar(x, y, yerr=yerr, label=label, **kwargs)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        if label is not None:
            ax.legend(loc="best")
        return ax

    def plot(self, **kwargs):
        """Line plot of the flux (reference ``:2336-2394``)."""
        return self._create_plot(method="plot", **kwargs)

    def scatter(self, colorbar_label="", show_colorbar=True, **kwargs):
        """Scatter plot of the flux (reference ``:2396-2448``)."""
        return self._create_plot(method="scatter",
                                 colorbar_label=colorbar_label,
                                 show_colorbar=show_colorbar, **kwargs)

    def errorbar(self, linestyle="", **kwargs):
        """Error-bar plot of the flux (reference ``:2450-2488``)."""
        if "ls" not in kwargs:
            kwargs["linestyle"] = linestyle
        kwargs["fmt"] = kwargs.get("fmt", ".")
        return self._create_plot(method="errorbar", **kwargs)

    def plot_river(self, period, epoch_time=None, ax=None, bin_points=1,
                   minimum_phase=-0.5, maximum_phase=0.5, method="mean",
                   **kwargs):
        """Phase × cycle river diagram (reference ``:2769-2965``)."""
        import matplotlib.pyplot as plt
        method = validate_method(method, ["mean", "median", "sigma"])
        period = _as_days(period)
        t = _strip_quantity(self.time.value).astype(np.float64)
        if epoch_time is None:
            t0 = t[0]
        elif isinstance(epoch_time, Time):
            t0 = epoch_time.to_value(self.time.format)
        else:
            t0 = float(epoch_time)
        f = _strip_quantity(self.flux)
        # cycle index and phase
        rel = (t - t0) / period + 0.5
        cycle = np.floor(rel).astype(int)
        phase = rel - np.floor(rel) - 0.5
        cycle -= cycle.min()
        n_cycles = cycle.max() + 1
        dt_med = np.median(np.diff(t))
        if not np.isfinite(dt_med) or dt_med <= 0:
            nb = 100
        else:
            nb = int((maximum_phase - minimum_phase)
                     / (bin_points * dt_med / period))
            if nb <= 1:
                # bin_points exceeds the points available per phase bin
                # (reference lightcurve.py:2867-2877)
                pts_per_period = max(int(period / dt_med), 1)
                bin_points = int(maximum_phase - minimum_phase) / (
                    2 / pts_per_period)
                warnings.warn(
                    "`bin_points` is too high to plot a phase curve, "
                    f"resetting to {bin_points}", LightkurveWarning)
                nb = 2
            nb = max(nb, 2)
        pb = np.floor((phase - minimum_phase) /
                      (maximum_phase - minimum_phase) * nb).astype(int)
        ok = (pb >= 0) & (pb < nb) & np.isfinite(f)
        img = np.full((n_cycles, nb), np.nan)
        cnt = np.zeros((n_cycles, nb))
        np.add.at(cnt, (cycle[ok], pb[ok]), 1)
        nz = cnt > 0
        if method == "mean":
            tot = np.zeros((n_cycles, nb))
            np.add.at(tot, (cycle[ok], pb[ok]), f[ok])
            img[nz] = tot[nz] / cnt[nz]
        else:
            # 'median' and 'sigma' need per-cell collections
            from collections import defaultdict
            cells = defaultdict(list)
            for cy, pbin, val in zip(cycle[ok], pb[ok], f[ok]):
                cells[(cy, pbin)].append(val)
            med_all = np.nanmedian(f[ok]) if ok.any() else np.nan
            std_all = np.nanstd(f[ok]) if ok.any() else np.nan
            for (cy, pbin), vals in cells.items():
                med = np.median(vals)
                if method == "median":
                    img[cy, pbin] = med
                else:  # 'sigma': deviation from the global median in σ
                    img[cy, pbin] = ((med - med_all)
                                     / (std_all / np.sqrt(len(vals))))
        if ax is None:
            _, ax = plt.subplots(1)
        pc = ax.pcolormesh(
            np.linspace(minimum_phase, maximum_phase, nb) * period,
            np.arange(n_cycles), img, **kwargs)
        plt.colorbar(pc, ax=ax, label="Flux")
        ax.set_xlabel("Phase [days]")
        ax.set_ylabel("Cycle")
        return ax

    def query_solar_system_objects(self, cadence_mask="outliers",
                                   radius=None, sigma=3, location=None,
                                   cache=True, return_mask=False,
                                   show_progress=True, fetch=None):
        """Query SkyBot for solar-system objects crossing the aperture
        (reference ``lightcurve.py:1860-1976``).

        Argument validation (RA/Dec presence, the ``cadence_mask``
        forms, location resolution from the mission, per-mission default
        cone radii) follows the reference; the HTTP call is a pluggable
        ``fetch(url) -> text`` hook (see
        :func:`lightkurve_tpu_torch.utils._query_solar_system_objects`).
        ``cadence_mask="outliers"`` runs :meth:`remove_outliers` on the
        configured device."""
        import collections.abc
        from .utils import _query_solar_system_objects
        for attr in ("ra", "dec"):
            if getattr(self, attr, None) is None:
                raise ValueError(
                    f"Input does not have a `{attr}` attribute.")
        if isinstance(cadence_mask, str):
            if cadence_mask == "outliers":
                cadence_mask = self.remove_outliers(
                    sigma=sigma, return_mask=True)[1]
            elif cadence_mask == "all":
                cadence_mask = np.ones(len(self.time), dtype=bool)
            else:
                raise ValueError("invalid `cadence_mask` string argument")
        elif isinstance(cadence_mask, collections.abc.Sequence):
            cadence_mask = np.array(cadence_mask)
        elif isinstance(cadence_mask, (bool, np.bool_)):
            cadence_mask = np.array([cadence_mask])
        elif not isinstance(cadence_mask, np.ndarray):
            raise ValueError(
                "the `cadence_mask` argument is missing or invalid")
        # avoid searching times with NaN flux (remove_outliers includes
        # NaNs in its mask — reference lightcurve.py:1936-1943)
        cadence_mask = cadence_mask & ~np.isnan(
            _strip_quantity(self.flux).astype(float))
        if location is None:
            mission = self.meta.get("MISSION")
            if not mission:
                raise ValueError("you must pass a value for `location`.")
            location = str(mission).lower()
        location = str(location).lower()
        if radius is None:
            # 15-pixel default cone (comet tails trip up narrower ones,
            # reference lightcurve.py:1952-1960)
            if location in ("kepler", "k2"):
                radius = 4 * 15 / 3600.0
            elif location == "tess":
                radius = 21 * 15 / 3600.0
            else:
                radius = 15 / 3600.0
        times_jd = _strip_quantity(self.time.jd)
        res = _query_solar_system_objects(
            ra=self.ra, dec=self.dec, times=times_jd[cadence_mask],
            location=location, radius=radius, cache=cache,
            show_progress=show_progress, fetch=fetch)
        if return_mask:
            epochs = [] if res is None else np.asarray(res.epoch)
            return res, np.isin(times_jd, epochs)
        return res


def _copy_col(v):
    if isinstance(v, (Time, TimeDelta)):
        return v.copy()
    return np.array(v, copy=True, subok=True)


def _as_days(x):
    """Convert a float / Quantity / TimeDelta to float days."""
    if isinstance(x, TimeDelta):
        return float(np.asarray(x.value))
    if isinstance(x, Quantity):
        from .units import day
        if x.unit.bases == {"time": 1}:
            return float(np.asarray(x.to(day).value))
        return float(np.asarray(x.value))
    return float(x)


#: :meth:`LightCurve.flatten`'s CUDA graphs, by curve length, device,
#: dtype and settings, the oldest dropped past ``_FLATTEN_GRAPHS_KEPT``
_FLATTEN_GRAPHS = {}
_FLATTEN_GRAPHS_KEPT = 4


def _tensor(x, dtype=None):
    """A host array as a tensor in ``dtype`` (default
    :data:`config.default_dtype`) on :func:`config.resolve_device`: the
    card unless the configuration says ``"cpu"``; without CUDA that
    raises."""
    dtype = config.resolve_dtype(None) if dtype is None else dtype
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=config.resolve_device(None))


class FoldedLightCurve(LightCurve):
    """A LightCurve whose time column holds phase values
    (reference ``lightcurve.py:3166-3585``)."""

    @property
    def phase(self):
        """Phase values: a `TimeDelta` in days, or a dimensionless
        `Quantity` when the fold used ``normalize_phase=True``
        (reference test_fold_v2 type contract)."""
        if self.meta.get("NORMALIZE_PHASE"):
            return Quantity(self.time.value, dimensionless)
        return TimeDelta(self.time.value)

    @property
    def cycle(self):
        """Integer cycle number of each sample (reference ``:3213-3229``)."""
        period = _as_days(self.meta["PERIOD"])
        t0 = self.meta["EPOCH_TIME"].value
        t = self._cols["time_original"].value
        cyc = np.floor((t - t0 + 0.5 * period) / period)
        return (cyc - cyc.min()).astype(int)

    @property
    def odd_mask(self):
        return self.cycle % 2 == 1

    @property
    def even_mask(self):
        return ~self.odd_mask

    def bin(self, *args, **kwargs):
        binned = super().bin(*args, **kwargs)
        binned.meta = deepcopy(self.meta)
        return binned

    def to_fits(self, path=None, overwrite=False, **extra_data):
        """Write the folded curve with its ephemeris in the primary
        header — PERIOD/PHNORM/EPOCH/PHEPOCH plus a CREATOR tag the
        filetype detector recognizes — so ``read()`` round-trips it back
        to a FoldedLightCurve (reference ``lightcurve.py:3397-3460``,
        ``io/folded.py:8-43``)."""
        def _val(v):
            return getattr(v, "value", v)

        epoch_time = self.meta.get("EPOCH_TIME")
        folded_specific = {
            "OBJECT": "{}".format(self.meta.get("TARGETID")),
            "MISSION": self.meta.get("MISSION"),
            "RA_OBJ": self.meta.get("RA"),
            "TARGETID": self.meta.get("TARGETID"),
            "DEC_OBJ": self.meta.get("DEC"),
            "PERIOD": float(_as_days(self.meta["PERIOD"])),
            "CREATOR": "lightkurve_tpu.FoldedLightCurve.to_fits()",
            "PHNORM": bool(self.meta.get("NORMALIZE_PHASE", False)),
            "EPOCH": _val(epoch_time) if epoch_time is not None else "",
            "PHEPOCH": float(_val(self.meta.get("EPOCH_PHASE", 0.0))),
        }
        if "centroid_col" in self._cols:
            folded_specific["MOM_CENTR1"] = np.asarray(
                _val(self._cols["centroid_col"]))
            folded_specific["MOM_CENTR2"] = np.asarray(
                _val(self._cols["centroid_row"]))
        for kw, v in folded_specific.items():
            extra_data.setdefault(kw, v)
        lc = self
        if folded_specific["PHNORM"]:
            # store phase in days so the column is homogeneous with the
            # un-normalized case; the reader divides it back out
            lc = self.copy()
            lc["time"] = Time(
                self.time.value * folded_specific["PERIOD"],
                format="jd", scale=self.time.scale)
        from .io.writers import lightcurve_to_fits
        return lightcurve_to_fits(lc, path=path, overwrite=overwrite,
                                  **extra_data)

    def plot_river(self, period=None, epoch_time=None, **kwargs):
        """River diagram defaulting to the fold ephemeris
        (reference ``lightcurve.py:3404-3457``)."""
        lc = LightCurve(time=self._cols["time_original"].copy(),
                        flux=self.flux, flux_err=self.flux_err,
                        meta=deepcopy(self.meta)) \
            if "time_original" in self._cols else self
        if period is None:
            period = self.meta.get("PERIOD")
        if epoch_time is None:
            epoch_time = self.meta.get("EPOCH_TIME")
        if period is None:
            raise ValueError("`period` must be provided")
        return LightCurve.plot_river(lc, period=period,
                                     epoch_time=epoch_time, **kwargs)

    def plot(self, **kwargs):
        return super().plot(**kwargs)

    def scatter(self, **kwargs):
        return super().scatter(**kwargs)

    def errorbar(self, **kwargs):
        return super().errorbar(**kwargs)


class KeplerLightCurve(LightCurve):
    """LightCurve with Kepler defaults: BKJD times
    (reference ``lightcurve.py:3588-3712``)."""

    _default_time_format = "bkjd"

    @classmethod
    def read(cls, path, format="kepler", **kwargs):
        from .io.read import read as _read
        return _read(path, filetype=_format_to_filetype(format),
                     **kwargs)

    def to_fits(self, path=None, overwrite=False, flux_column_name="FLUX",
                aperture_mask=None, **extra_data):
        from .io.writers import lightcurve_to_fits
        return lightcurve_to_fits(self, path=path, overwrite=overwrite,
                                  flux_column_name=flux_column_name,
                                  aperture_mask=aperture_mask, **extra_data)


class TessLightCurve(LightCurve):
    """LightCurve with TESS defaults: BTJD times
    (reference ``lightcurve.py:3715-3834``)."""

    _default_time_format = "btjd"

    @classmethod
    def read(cls, path, format="tess", **kwargs):
        from .io.read import read as _read
        return _read(path, filetype=_format_to_filetype(format),
                     **kwargs)

    def to_fits(self, path=None, overwrite=False, flux_column_name="FLUX",
                aperture_mask=None, **extra_data):
        from .io.writers import lightcurve_to_fits
        return lightcurve_to_fits(self, path=path, overwrite=overwrite,
                                  flux_column_name=flux_column_name,
                                  aperture_mask=aperture_mask, **extra_data)
