"""Astropy-free time handling with Kepler/TESS epoch formats.

The reference registers two custom astropy time formats
(``src/lightkurve/time.py:13-46``): ``bkjd`` (Barycentric Kepler Julian Date,
BJD - 2454833) and ``btjd`` (Barycentric TESS Julian Date, BJD - 2457000).
Both are pure offsets from JD — this module implements them from scratch on a
compact ``Time`` class that stores a two-float (epoch + offset) representation
for precision, plus a ``TimeDelta``.

A copy of ``lightkurve_tpu/time.py`` (the port never imports the JAX
package).  Torch functions never see ``Time`` objects: the host converts to
float64 days (relative values are safe in float32 after subtracting the
epoch).
"""
from __future__ import annotations

import numpy as np

from .units import Quantity, day as _day_unit, Unit

__all__ = ["Time", "TimeDelta", "TIME_FORMAT_OFFSETS"]

# JD offset for each supported format: jd = value + offset
TIME_FORMAT_OFFSETS = {
    "jd": 0.0,
    "mjd": 2400000.5,
    "bkjd": 2454833.0,   # reference time.py:25
    "btjd": 2457000.0,   # reference time.py:43
}

_FORMAT_DOC = {
    "bkjd": "Barycentric Kepler Julian Date",
    "btjd": "Barycentric TESS Julian Date",
}


class TimeDelta:
    """A duration stored in float64 days."""

    __slots__ = ("_days",)

    def __init__(self, value, format="jd", scale=None):
        if isinstance(value, TimeDelta):
            self._days = value._days
            return
        if isinstance(value, Quantity):
            value = value.to(_day_unit).value
        arr = np.asarray(value, dtype=np.float64)
        if format in ("sec", "s"):
            arr = arr / 86400.0
        self._days = arr

    @property
    def value(self):
        return self._days

    @property
    def jd(self):
        return self._days

    @property
    def sec(self):
        return self._days * 86400.0

    def to(self, unit):
        return Quantity(self._days, _day_unit).to(unit)

    def to_value(self, unit="d"):
        return self.to(unit).value

    def __len__(self):
        return len(self._days)

    @property
    def shape(self):
        return self._days.shape

    def __getitem__(self, key):
        return TimeDelta(self._days[key])

    def __add__(self, other):
        if isinstance(other, Time):
            return other + self
        return TimeDelta(self._days + TimeDelta(other)._days)

    __radd__ = __add__

    def __sub__(self, other):
        return TimeDelta(self._days - TimeDelta(other)._days)

    def __mul__(self, k):
        return TimeDelta(self._days * k)

    __rmul__ = __mul__

    def __truediv__(self, k):
        if isinstance(k, TimeDelta):
            return self._days / k._days
        return TimeDelta(self._days / k)

    def __neg__(self):
        return TimeDelta(-self._days)

    def __lt__(self, other):
        return self._days < TimeDelta(other)._days

    def __le__(self, other):
        return self._days <= TimeDelta(other)._days

    def __gt__(self, other):
        return self._days > TimeDelta(other)._days

    def __ge__(self, other):
        return self._days >= TimeDelta(other)._days

    def __eq__(self, other):
        try:
            return self._days == TimeDelta(other)._days
        except Exception:
            return NotImplemented

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._days, dtype=dtype)

    def __repr__(self):
        return f"<TimeDelta {self._days!r} d>"

    def copy(self):
        return TimeDelta(self._days.copy())

    def reshape(self, *s):
        return TimeDelta(self._days.reshape(*s))

    def min(self):
        return TimeDelta(self._days.min())

    def max(self):
        return TimeDelta(self._days.max())


class Time:
    """Array of instants, stored as (jd1, jd2) float64 pairs.

    ``jd1`` holds the format epoch (a large integer-valued float) and ``jd2``
    the small offset, so that mission-era times keep sub-millisecond
    precision without astropy's full machinery.
    """

    __slots__ = ("_jd1", "_jd2", "format", "scale")

    def __init__(self, value, format=None, scale="tdb"):
        if isinstance(value, Time):
            self._jd1 = value._jd1
            self._jd2 = value._jd2
            self.format = format or value.format
            self.scale = scale or value.scale
            return
        if format is None:
            format = "jd"
        if format not in TIME_FORMAT_OFFSETS:
            raise ValueError(
                f"Unknown time format {format!r}; supported: "
                f"{sorted(TIME_FORMAT_OFFSETS)}")
        arr = np.asarray(value, dtype=np.float64)
        self._jd1 = np.float64(TIME_FORMAT_OFFSETS[format])
        self._jd2 = arr
        self.format = format
        self.scale = scale

    @classmethod
    def _from_jd12(cls, jd1, jd2, format, scale):
        t = cls.__new__(cls)
        t._jd1 = jd1
        t._jd2 = jd2
        t.format = format
        t.scale = scale
        return t

    # -- format views -----------------------------------------------------
    def _to_format(self, fmt):
        off = TIME_FORMAT_OFFSETS[fmt]
        return (self._jd1 - off) + self._jd2

    @property
    def jd(self):
        return self._to_format("jd")

    @property
    def mjd(self):
        return self._to_format("mjd")

    @property
    def bkjd(self):
        return self._to_format("bkjd")

    @property
    def btjd(self):
        return self._to_format("btjd")

    @property
    def value(self):
        return self._to_format(self.format)

    def to_value(self, fmt=None):
        return self._to_format(fmt or self.format)

    def copy(self, format=None):
        return Time._from_jd12(self._jd1, np.array(self._jd2, copy=True),
                               format or self.format, self.scale)

    # -- container protocol ----------------------------------------------
    def __len__(self):
        return len(np.atleast_1d(self._jd2))

    @property
    def shape(self):
        return np.shape(self._jd2)

    @property
    def isscalar(self):
        return np.ndim(self._jd2) == 0

    def __getitem__(self, key):
        return Time._from_jd12(self._jd1, self._jd2[key], self.format, self.scale)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.value, dtype=dtype)

    def reshape(self, *s):
        return Time._from_jd12(self._jd1, np.reshape(self._jd2, *s),
                               self.format, self.scale)

    # -- arithmetic --------------------------------------------------------
    def __sub__(self, other):
        if isinstance(other, Time):
            return TimeDelta((self._jd1 - other._jd1) + (self._jd2 - other._jd2))
        other = TimeDelta(other)
        return Time._from_jd12(self._jd1, self._jd2 - other.value,
                               self.format, self.scale)

    def __add__(self, other):
        other = TimeDelta(other)
        return Time._from_jd12(self._jd1, self._jd2 + other.value,
                               self.format, self.scale)

    __radd__ = __add__

    def _cmp_jd(self, other):
        if isinstance(other, Time):
            return (other._jd1 - self._jd1) + other._jd2
        return np.asarray(other) - (self._jd1 - TIME_FORMAT_OFFSETS[self.format])

    def __lt__(self, other):
        return self._jd2 < self._cmp_jd(other)

    def __le__(self, other):
        return self._jd2 <= self._cmp_jd(other)

    def __gt__(self, other):
        return self._jd2 > self._cmp_jd(other)

    def __ge__(self, other):
        return self._jd2 >= self._cmp_jd(other)

    def __eq__(self, other):
        try:
            return self._jd2 == self._cmp_jd(other)
        except Exception:
            return NotImplemented

    def min(self):
        return Time._from_jd12(self._jd1, np.min(self._jd2), self.format, self.scale)

    def max(self):
        return Time._from_jd12(self._jd1, np.max(self._jd2), self.format, self.scale)

    def argsort(self):
        return np.argsort(self._jd2, kind="stable")

    def isfinite(self):
        return np.isfinite(self._jd2)

    def sort(self):
        return self[self.argsort()]

    def __repr__(self):
        return f"<Time {self.format}={self.value!r} scale={self.scale}>"


def infer_time_format(meta):
    """Infer jd/mjd/bkjd/btjd from FITS-style reference keywords.

    Mirrors the inference logic of the reference's generic reader
    (``io/generic.py:106-153``): BJDREF[IF] == 2454833 → bkjd, 2457000 →
    btjd, 0 → jd; MJDREF → mjd-like.
    """
    bjdrefi = meta.get("BJDREFI")
    if bjdrefi is not None:
        if int(bjdrefi) == 2454833:
            return "bkjd"
        if int(bjdrefi) == 2457000:
            return "btjd"
        if int(bjdrefi) == 0:
            return "jd"
    if meta.get("MJDREF") is not None or meta.get("MJDREFI") is not None:
        return "mjd"
    if meta.get("JDREF") is not None:
        return "jd"
    return None
