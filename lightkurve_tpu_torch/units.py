"""Lightweight, astropy-free units for lightkurve_tpu_torch.

A copy of ``lightkurve_tpu/units.py`` (the port never imports the JAX
package): the unit algebra of the light-curve domain -- relative-flux
units (dimensionless / percent / ppt / ppm), time, frequency, flux
(electron/s) and pixel units -- and a minimal ``Quantity`` ndarray
wrapper.  Units live on the host at the API boundary: a ``Quantity``'s
payload is a plain numpy array, and the torch functions of
:mod:`lightkurve_tpu_torch.ops` take raw tensors.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Unit",
    "Quantity",
    "UnitConversionError",
    "dimensionless",
    "percent",
    "ppt",
    "ppm",
    "day",
    "hour",
    "minute",
    "second",
    "year",
    "Hz",
    "uHz",
    "mHz",
    "electron",
    "electron_per_second",
    "pixel",
    "cds_ppm",
]


class UnitConversionError(ValueError):
    """Raised when converting between incompatible units."""


# A unit is represented by a physical-type tag plus a scale factor relative to
# the canonical unit of that type.  This covers everything the light-curve
# domain needs (no compound dimensional analysis required, but we support
# products/quotients of the core types via exponent dicts).
class Unit:
    """A unit = scale * product(base_type**power).

    ``bases`` maps base-type names (e.g. ``"time"``, ``"flux"``,
    ``"relative"``) to integer powers.  ``scale`` converts a value in this
    unit to the canonical unit of the same dimensions.
    """

    __slots__ = ("scale", "bases", "name")

    def __init__(self, scale=1.0, bases=None, name=""):
        self.scale = float(scale)
        self.bases = dict(bases or {})
        # Drop zero powers
        self.bases = {k: v for k, v in self.bases.items() if v != 0}
        self.name = name

    # -- algebra ---------------------------------------------------------
    @staticmethod
    def _canonical_name(scale, bases, fallback):
        """Prefer a registered unit's name when the algebra lands exactly
        on one (e.g. (1/d)**-1 displays as 'd', not '1 / d-1')."""
        bases = {k: v for k, v in bases.items() if v != 0}
        for u in Unit._registry.values():
            # np.isclose's test, on two floats without its array overhead
            if u.bases == bases and \
                    abs(u.scale - scale) <= 1e-8 + 1e-5 * abs(scale):
                return u.name
        return fallback

    def _combine(self, other, sign):
        bases = dict(self.bases)
        for k, v in other.bases.items():
            bases[k] = bases.get(k, 0) + sign * v
        scale = self.scale * (other.scale ** sign)
        if sign > 0:
            name = f"{self.name} {other.name}".strip()
        else:
            name = f"{self.name} / {other.name}".strip(" /")
        return Unit(scale, bases, self._canonical_name(scale, bases, name))

    def __mul__(self, other):
        if isinstance(other, Unit):
            return self._combine(other, +1)
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return self._combine(other, -1)
        return Quantity(1.0 / np.asarray(other), self)

    def __rtruediv__(self, other):
        return Quantity(np.asarray(other), self ** -1)

    def __pow__(self, p):
        scale = self.scale ** p
        bases = {k: v * p for k, v in self.bases.items()}
        return Unit(scale, bases, self._canonical_name(
            scale, bases, f"{self.name}{p}" if self.name else ""))

    # -- comparison / conversion ----------------------------------------
    def is_equivalent(self, other):
        other = Unit.parse(other)
        return self.bases == other.bases

    def to(self, other):
        """Scale factor converting THIS unit into ``other``."""
        other = Unit.parse(other)
        if self.bases != other.bases:
            raise UnitConversionError(
                f"'{self}' and '{other}' are not convertible")
        return self.scale / other.scale

    def __eq__(self, other):
        try:
            other = Unit.parse(other)
        except Exception:
            return NotImplemented
        return self.bases == other.bases and np.isclose(self.scale, other.scale)

    def __hash__(self):
        return hash((round(np.log10(self.scale), 12) if self.scale > 0 else self.scale,
                     tuple(sorted(self.bases.items()))))

    def __repr__(self):
        return f"Unit('{self.name or 'dimensionless'}')"

    def __str__(self):
        return self.name or ""

    def to_string(self):
        return str(self)

    @property
    def physical_type(self):
        if not self.bases:
            return "dimensionless"
        return " ".join(f"{k}{'' if v == 1 else v}" for k, v in sorted(self.bases.items()))

    # -- registry --------------------------------------------------------
    _registry = {}

    @classmethod
    def register(cls, unit, *aliases):
        for a in (unit.name, *aliases):
            if a:
                cls._registry[a] = unit
        return unit

    @classmethod
    def parse(cls, s):
        if isinstance(s, Unit):
            return s
        if s is None or s == "":
            return dimensionless
        s = str(s).strip()
        if s in cls._registry:
            return cls._registry[s]
        # simple "a / b" or "a/b" forms
        for sep in ("/",):
            if sep in s:
                num, _, den = s.partition(sep)
                try:
                    return cls.parse(num.strip()) / cls.parse(den.strip())
                except Exception:
                    pass
        raise UnitConversionError(
            f"{s!r} is not a valid unit (unknown unit string)")


# ---------------------------------------------------------------------------
# Canonical units
# ---------------------------------------------------------------------------
dimensionless = Unit.register(Unit(1.0, {}, ""), "dimensionless")
percent = Unit.register(Unit(1e-2, {}, "percent"), "%", "pct")
# Reference defines these via u.def_unit (units.py:6-8)
ppt = Unit.register(Unit(1e-3, {}, "ppt"), "ppt")
ppm = Unit.register(Unit(1e-6, {}, "ppm"), "ppm", "Part per Million", "PPM")
cds_ppm = ppm

second = Unit.register(Unit(1.0, {"time": 1}, "s"), "s", "second", "sec")
minute = Unit.register(Unit(60.0, {"time": 1}, "min"), "min", "minute")
hour = Unit.register(Unit(3600.0, {"time": 1}, "h"), "h", "hour", "hr")
day = Unit.register(Unit(86400.0, {"time": 1}, "d"), "d", "day", "BJD - 2454833",
                    "BJD - 2457000")
year = Unit.register(Unit(365.25 * 86400.0, {"time": 1}, "yr"), "yr", "year")

Hz = Unit.register(Unit(1.0, {"time": -1}, "Hz"), "Hz", "1 / s")
mHz = Unit.register(Unit(1e-3, {"time": -1}, "mHz"), "mHz")
uHz = Unit.register(Unit(1e-6, {"time": -1}, "uHz"), "uHz", "microhertz", "muHz")
one_per_day = Unit.register(Unit(1.0 / 86400.0, {"time": -1}, "1 / d"), "1 / d", "1/d")

electron = Unit.register(Unit(1.0, {"charge": 1}, "electron"), "electron", "e-")
electron_per_second = Unit.register(
    Unit(1.0, {"charge": 1, "time": -1}, "electron / s"),
    "electron / s", "e-/s", "electrons/s", "e-/sec", "electron/s")
pixel = Unit.register(Unit(1.0, {"pixel": 1}, "pix"), "pix", "pixel", "pixels")
# solar units for seismology outputs
solRad = Unit.register(Unit(1.0, {"solrad": 1}, "solRad"), "solRad", "Rsun")
solMass = Unit.register(Unit(1.0, {"solmass": 1}, "solMass"), "solMass", "Msun")
dex = Unit.register(Unit(1.0, {"dex": 1}, "dex"), "dex")
K = Unit.register(Unit(1.0, {"temperature": 1}, "K"), "K", "Kelvin")
cm_per_s2 = Unit.register(Unit(1.0, {"length": 1, "time": -2}, "cm / s2"),
                          "cm / s2", "cm/s2", "cm / s**2")
deg = Unit.register(Unit(np.pi / 180.0, {"angle": 1}, "deg"), "deg", "degree")
arcsec = Unit.register(Unit(np.pi / 180.0 / 3600.0, {"angle": 1}, "arcsec"), "arcsec")


class Quantity(np.ndarray):
    """A numpy array with a :class:`Unit` attached.

    Examples
    --------
    >>> from lightkurve_tpu_torch.units import Quantity, ppm, ppt
    >>> q = Quantity([1000.0, 2000.0], ppm)
    >>> q.to(ppt).value.tolist()
    [1.0, 2.0]


    Mirrors the small subset of ``astropy.units.Quantity`` behaviour the
    reference API exposes to users (``.value``, ``.unit``, ``.to()``,
    arithmetic with unit propagation for * and /, add/sub requiring
    convertible units).
    """

    def __new__(cls, value, unit=None):
        if isinstance(value, Quantity) and unit is None:
            return value
        if isinstance(value, Quantity):
            value = value.to(unit)
            return value
        arr = np.asarray(value)
        if arr.dtype.kind != "f":
            # ints/bools/objects become float64; float32 mission data
            # keeps its dtype like astropy Quantity does
            arr = np.asarray(arr, dtype=float)
        obj = arr.view(cls)
        obj._unit = Unit.parse(unit)
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self._unit = getattr(obj, "_unit", dimensionless)

    @property
    def unit(self):
        return self._unit

    @property
    def value(self):
        return np.asarray(self)

    def to(self, unit):
        unit = Unit.parse(unit)
        factor = self._unit.to(unit)
        return Quantity(np.asarray(self) * factor, unit)

    def to_value(self, unit=None):
        if unit is None:
            return self.value
        return self.to(unit).value

    def decompose(self):
        return Quantity(self.value * self._unit.scale,
                        Unit(1.0, self._unit.bases))

    # -- arithmetic with unit propagation --------------------------------
    @staticmethod
    def _defers(other):
        """True when ``other`` opts out of the array protocol (e.g. a
        LightCurve container sets ``__array_ufunc__ = None``); binary ops
        must then return NotImplemented so Python dispatches to ``other``'s
        reflected operator instead of ``np.asarray``-ing it (which would
        recurse forever on a sized, indexable container)."""
        return (getattr(other, "__array_ufunc__", True) is None
                and not isinstance(other, (Unit, Quantity)))

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self._unit * other)
        if isinstance(other, Quantity):
            return Quantity(self.value * other.value, self._unit * other._unit)
        if self._defers(other):
            return NotImplemented
        return Quantity(self.value * np.asarray(other), self._unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self._unit / other)
        if isinstance(other, Quantity):
            return Quantity(self.value / other.value, self._unit / other._unit)
        if self._defers(other):
            return NotImplemented
        return Quantity(self.value / np.asarray(other), self._unit)

    def __rtruediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(np.asarray(other.value) / self.value,
                            other._unit / self._unit)
        if self._defers(other):
            return NotImplemented
        return Quantity(np.asarray(other) / self.value, self._unit ** -1)

    def __pow__(self, p):
        return Quantity(self.value ** p, self._unit ** p)

    def _coerce(self, other):
        if isinstance(other, Quantity):
            return other.to(self._unit).value
        other = np.asarray(other)
        if self._unit.bases:  # adding a bare number to a dimensional qty
            raise UnitConversionError(
                f"Cannot add dimensionless values to '{self._unit}'")
        return other / self._unit.scale if self._unit.scale != 1 else other

    def __add__(self, other):
        if self._defers(other):
            return NotImplemented
        return Quantity(self.value + self._coerce(other), self._unit)

    __radd__ = __add__

    def __sub__(self, other):
        if self._defers(other):
            return NotImplemented
        return Quantity(self.value - self._coerce(other), self._unit)

    def __rsub__(self, other):
        if self._defers(other):
            return NotImplemented
        return Quantity(self._coerce(other) - self.value, self._unit)

    def __getitem__(self, key):
        out = super().__getitem__(key)
        if not isinstance(out, Quantity):     # scalar indexing unwraps
            return Quantity(out, self._unit)
        return out

    def __repr__(self):
        return f"<Quantity {np.asarray(self)!r} {self._unit}>"

    def __reduce__(self):
        # keep pickling simple: drop to plain ndarray + unit name
        return (_rebuild_quantity, (np.asarray(self), str(self._unit)))


def _rebuild_quantity(value, unit):
    return Quantity(value, unit)
