"""Generic FITS-table → LightCurve conversion.

A copy of ``lightkurve_tpu/io/generic.py`` (reference
``io/generic.py:20-196``) on the port's FITS reader: unit-string fixups
(e-/s, pixels, ppm, ADU), lowercase column renaming, NaN-time row
removal, BJDREFI/MJDREF/JDREF/TIMESYS time-format inference,
standard-column aliasing (flux/flux_err/quality/cadenceno/centroids), and
metadata propagation.
"""
from __future__ import annotations

import logging

import numpy as np

from ..lightcurve import LightCurve
from ..time import Time
from ..units import Quantity, Unit, UnitConversionError, dimensionless
from .fits import HDUList, open_fits

log = logging.getLogger(__name__)

__all__ = ["read_generic_lightcurve"]

_UNIT_FIXES = {
    "e-/s": "electron / s",
    "electron / s": "electron / s",
    "electrons/s": "electron / s",
    "e-": "electron",
    "pixels": "pix",
    "pixel": "pix",
    "pix": "pix",
    "ppm": "ppm",
    # 'adu' stays a named unit (astropy parses u.adu; reference
    # io/test_cdips.py asserts str(lc['bge'].unit) == 'adu')
    "unitless": "",
    "": "",
    "days": "d",
    "day": "d",
    "d": "d",
    "bjd - 2454833": "d",
    "bjd - 2457000": "d",
}


def _parse_unit(unitstr):
    if unitstr is None:
        return None
    s = str(unitstr).strip()
    fixed = _UNIT_FIXES.get(s.lower(), s)
    try:
        return Unit.parse(fixed)
    except UnitConversionError:
        # FITS files from other missions carry units our algebra does not
        # know (e.g. 'erg/s/cm^2/A'); keep them as opaque named units so
        # the label survives, as astropy does (reference io/generic.py
        # keeps the raw TUNIT string)
        return Unit(1.0, {f"custom:{fixed}": 1}, fixed)


def read_generic_lightcurve(filename, time_column="time", flux_column="flux",
                            flux_err_column="flux_err",
                            quality_column="quality",
                            cadenceno_column="cadenceno",
                            centroid_col_column="mom_centr1",
                            centroid_row_column="mom_centr2",
                            time_format=None, ext=1):
    """Convert extension ``ext`` of a mission FITS file into a LightCurve."""
    if isinstance(filename, HDUList):
        hdulist = filename
    else:
        hdulist = open_fits(filename)

    if isinstance(ext, str):
        ext_names = [str(h.header.get("EXTNAME", "")).lower() for h in
                     hdulist]
        if ext.lower() not in ext_names:
            raise ValueError(f"extension {ext!r} not found; available: "
                             f"{ext_names}")
        hdu = hdulist[ext]
        ext_header = hdu.header
    else:
        hdu = hdulist[ext]
        ext_header = hdu.header

    # columns → lowercase, with unit fixups via TUNITn
    columns = {}
    units = {}
    names = hdu.data.names
    for i, name in enumerate(names, start=1):
        lname = name.lower()
        columns[lname] = np.asarray(hdu.data[name])
        units[lname] = _parse_unit(ext_header.get(f"TUNIT{i}"))

    # Kepler legacy 'T' column
    if time_column == "time" and "time" not in columns and "t" in columns:
        columns["time"] = columns.pop("t")
    if time_column != "time":
        columns["time"] = columns.pop(time_column.lower())

    # Drop NaN times (reference :96-102)
    time_vals = np.asarray(columns["time"], dtype=np.float64)
    good = ~np.isnan(time_vals)
    if not good.all():
        log.debug(f"Ignoring {np.sum(~good)} rows with NaN times")
        columns = {k: v[good] for k, v in columns.items()}
        time_vals = time_vals[good]

    # Time format inference (reference :104-140)
    reference_time_value = 0.0
    if not time_format:
        if ext_header.get("BJDREFI") == 2454833:
            time_format = "bkjd"
        elif ext_header.get("BJDREFI") == 2457000:
            time_format = "btjd"
        elif "MJDREFI" in ext_header and "MJDREFF" in ext_header:
            time_format = "mjd"
            reference_time_value = (ext_header.get("MJDREFI")
                                    + ext_header.get("MJDREFF"))
        elif "MJDREF" in ext_header:
            time_format = "mjd"
            reference_time_value = ext_header.get("MJDREF")
        elif "JDREFI" in ext_header and "JDREFF" in ext_header:
            time_format = "jd"
            reference_time_value = (ext_header.get("JDREFI")
                                    + ext_header.get("JDREFF"))
        elif "JDREF" in ext_header:
            time_format = "jd"
            reference_time_value = ext_header.get("JDREF")
        elif ext_header.get("TIMESYS") in ("mjd", "jd"):
            time_format = ext_header.get("TIMESYS")
        elif ext_header.get("TIMESYS") == "local":
            time_format = "jd"
        else:
            raise ValueError(
                f"No reference time found in {filename}. Pass in a common "
                "time_format manually, or edit the FITS header.")
    time = Time(time_vals + reference_time_value,
                format=time_format,
                scale=str(ext_header.get("TIMESYS", "tdb")).lower())
    del columns["time"]

    # standard column aliases (reference :144-172)
    def alias(target, source):
        if target not in columns and source in columns:
            columns[target] = columns[source]
            units[target] = units.get(source)

    flux_column = flux_column.lower()
    if "flux" not in columns:
        if flux_column not in columns:
            raise KeyError(f"column {flux_column!r} not found in file")
        alias("flux", flux_column)
    if "flux_err" not in columns:
        fec = flux_err_column.lower()
        if fec not in columns:
            fec = flux_column + "_err"
        alias("flux_err", fec)
    alias("quality", quality_column.lower())
    alias("cadenceno", cadenceno_column.lower())
    alias("centroid_col", centroid_col_column.lower())
    alias("centroid_row", centroid_row_column.lower())

    meta = {k: v for k, v in hdulist[0].header.items()
            if k not in ("SIMPLE", "BITPIX", "NAXIS", "EXTEND", "COMMENT",
                         "HISTORY")}
    meta["LABEL"] = hdulist[0].header.get("OBJECT")
    meta["MISSION"] = hdulist[0].header.get(
        "MISSION", hdulist[0].header.get("TELESCOP"))
    meta["RA"] = hdulist[0].header.get("RA_OBJ")
    meta["DEC"] = hdulist[0].header.get("DEC_OBJ")
    meta["FILENAME"] = filename if isinstance(filename, str) else None
    if hdulist[0].header.get("CREATOR") in (
            "lightkurve.LightCurve.to_fits()",
            "lightkurve_tpu.LightCurve.to_fits()"):
        meta["FLUX_ORIGIN"] = "lightkurve.LightCurve.to_fits()"
    else:
        meta["FLUX_ORIGIN"] = flux_column

    # order columns: required first
    lc_data = {"time": time}
    for name in ("flux", "flux_err", "quality", "cadenceno", "centroid_col",
                 "centroid_row"):
        if name in columns:
            lc_data[name] = _with_unit(columns[name], units.get(name))
    for name, vals in columns.items():
        if name not in lc_data:
            lc_data[name] = _with_unit(vals, units.get(name))
    return LightCurve(data=lc_data, meta=meta)


def _with_unit(vals, unit):
    if vals.dtype.kind in "iub" or unit is None:
        if vals.dtype.kind == "f":
            return Quantity(vals, dimensionless)
        return vals
    return Quantity(vals.astype(float), unit)
