"""FITS export for light curves (reference ``lightcurve.py:2552-2730``).

A copy of ``lightkurve_tpu/io/writers.py``.  Writes Kepler-style
light-curve FITS files: primary header with mission metadata, a
LIGHTCURVE binary-table extension (TIME/FLUX/FLUX_ERR/CADENCENO/
SAP_QUALITY + any extra columns), and an optional APERTURE image
extension (reference ``lightcurve.py:3882-3890``).
"""
from __future__ import annotations

import numpy as np

from .. import __version__
from ..time import TIME_FORMAT_OFFSETS
from ..units import Quantity
from .fits import BinTableHDU, Header, HDUList, ImageHDU, PrimaryHDU, \
    write_fits

__all__ = ["lightcurve_to_fits"]


# MAST archive-style primary-header scaffold (keyword, default, comment)
# — the mission product layout the reference fills from its
# data/lc-ext0-header.txt template (reference lightcurve.py:2604-2643).
# These are public archive format constants, written out here so exported
# files carry the full mission keyword set with archival comments.
_PRIMARY_TEMPLATE = (
    ("NEXTEND", 2, "number of standard extensions"),
    ("EXTNAME", "PRIMARY", "name of extension"),
    ("EXTVER", 1, "extension version number (not format version)"),
    ("ORIGIN", "Unofficial data product",
     "institution responsible for file"),
    ("DATE", None, "file creation date."),
    # the reference's tag, so each package's reader knows the other's files
    ("CREATOR", "lightkurve_tpu.LightCurve.to_fits()",
     "pipeline job and program used to produce this file"),
    ("TELESCOP", None, "telescope"),
    ("INSTRUME", None, "detector type"),
    ("OBJECT", None, "string version of target id"),
    ("RADESYS", "ICRS", "reference frame of celestial coordinates"),
    ("RA_OBJ", None, "[deg] right ascension"),
    ("DEC_OBJ", None, "[deg] declination"),
    ("EQUINOX", 2000.0, "equinox of celestial coordinate system"),
    ("PROCVER", None, "SW version"),
    ("MISSION", None, "mission name"),
)


def _primary_header(lc, **extra):
    import datetime
    meta = lc.meta
    h = Header()
    for kw, default, comment in _PRIMARY_TEMPLATE:
        h[kw] = (default, comment)
    h["DATE"] = datetime.datetime.now().strftime("%Y-%m-%d")
    h["PROCVER"] = str(__version__)
    h["TELESCOP"] = meta.get("TELESCOP", meta.get("MISSION"))
    h["INSTRUME"] = meta.get("INSTRUME")
    h["MISSION"] = meta.get("MISSION")
    h["OBJECT"] = meta.get("LABEL") or meta.get("OBJECT")
    for key in ("TARGETID", "KEPLERID", "TICID", "RA", "DEC", "QUARTER",
                "CAMPAIGN", "SECTOR", "CAMERA", "CCD", "CHANNEL", "TEFF"):
        if meta.get(key) is not None and not isinstance(
                meta.get(key), (dict, list, np.ndarray)):
            try:
                h[key[:8]] = meta[key]
            except Exception:
                pass
    if meta.get("RA") is not None:
        h["RA_OBJ"] = meta["RA"]
    if meta.get("DEC") is not None:
        h["DEC_OBJ"] = meta["DEC"]
    for k, v in extra.items():
        if np.isscalar(v) or isinstance(v, str):
            h[k[:8].upper()] = v
    return h


def lightcurve_to_fits(lc, path=None, overwrite=False,
                       flux_column_name="FLUX", aperture_mask=None,
                       **extra_data):
    """Serialize ``lc`` to a Kepler-style FITS file; returns the HDUList."""
    n = len(lc)
    time_format = lc.time.format
    cols = {"TIME": lc.time.value.astype(">f8")}
    flux = lc.flux.value.astype(">f4")
    cols[flux_column_name.upper()] = flux
    if np.any(np.isfinite(lc.flux_err.value)):
        cols[f"{flux_column_name.upper()}_ERR"] = \
            lc.flux_err.value.astype(">f4")
    if "cadenceno" in lc._cols:
        cols["CADENCENO"] = np.asarray(lc["cadenceno"]).astype(">i4")
    if "quality" in lc._cols:
        cols["SAP_QUALITY"] = np.asarray(lc["quality"]).astype(">i4")
    for name, vals in lc._cols.items():
        uname = name.upper()
        if uname in cols or name in ("time", "flux", "flux_err", "quality",
                                     "cadenceno"):
            continue
        v = vals.value if isinstance(vals, Quantity) else np.asarray(vals)
        if hasattr(v, "dtype") and v.dtype.kind in "iuf b":
            cols[uname] = v
    for name, vals in extra_data.items():
        if isinstance(vals, (list, np.ndarray)) and len(vals) == n:
            cols[name.upper()] = np.asarray(vals)

    table_header = Header()
    table_header["EXTNAME"] = "LIGHTCURVE"
    offset = TIME_FORMAT_OFFSETS.get(time_format, 0.0)
    if time_format in ("bkjd", "btjd"):
        table_header["BJDREFI"] = int(offset)
        table_header["BJDREFF"] = 0.0
    elif time_format == "mjd":
        table_header["MJDREF"] = 0.0
    else:
        table_header["JDREF"] = 0.0
    table_header["TIMESYS"] = getattr(lc.time, "scale", "tdb")
    # TUNITs: set after knowing column order
    hdu_table = BinTableHDU(data=cols, header=table_header,
                            name="LIGHTCURVE")
    # annotate column names/units (TTYPEn visible in the in-memory header,
    # as astropy's BinTableHDU does; reference test_to_fits checks them)
    names = list(cols.keys())
    for i, cname in enumerate(names, start=1):
        hdu_table.header[f"TTYPE{i}"] = cname
        if cname == "TIME":
            hdu_table.header[f"TUNIT{i}"] = {
                "bkjd": "BJD - 2454833", "btjd": "BJD - 2457000",
            }.get(time_format, "d")
        elif cname.startswith(flux_column_name.upper()):
            unit = str(lc.flux.unit)
            if unit:
                hdu_table.header[f"TUNIT{i}"] = unit

    hdus = HDUList([PrimaryHDU(header=_primary_header(lc, **{
        k: v for k, v in extra_data.items()
        if np.isscalar(v) or isinstance(v, str)})), hdu_table])
    if aperture_mask is not None:
        ap_hdr = Header({
            "EXTNAME": "APERTURE",
            "EXTVER": (1, "extension version number"),
            "INHERIT": (True, "inherit the primary header"),
        })
        if lc.meta.get("LABEL") or lc.meta.get("OBJECT"):
            ap_hdr["OBJECT"] = (lc.meta.get("LABEL")
                                or lc.meta.get("OBJECT"),
                                "string version of target id")
        hdus.append(ImageHDU(data=np.asarray(aperture_mask).astype(int),
                             header=ap_hdr))
    if path is not None:
        write_fits(hdus, path, overwrite=overwrite)
    return hdus
