"""Per-product light-curve readers: Kepler, TESS and folded curves.

The mission readers of ``lightkurve_tpu/io/readers.py``
(``read_kepler_lightcurve``, ``read_tess_lightcurve``,
``read_folded_lightcurve`` and ``_apply_quality``), copied: each applies
its product's default flux column, time format and quality-bitmask
filtering on top of :func:`read_generic_lightcurve`.  The readers of the
high-level science products (K2SFF, EVEREST, QLP, TASOC, PATHOS, CDIPS,
TGLC, ELEANOR, KEPSEISMIC, K2SC) are not ported yet; their files are
detected all the same (:mod:`.detect`).
"""
from __future__ import annotations

import numpy as np

from ..lightcurve import KeplerLightCurve, TessLightCurve, FoldedLightCurve
from ..time import Time
from ..utils import KeplerQualityFlags, TessQualityFlags
from .generic import read_generic_lightcurve

__all__ = ["read_kepler_lightcurve", "read_tess_lightcurve",
           "read_folded_lightcurve"]


def _apply_quality(lc, flags_cls, quality_bitmask, column="quality"):
    if column not in lc._cols:
        lc[column] = np.zeros(len(lc), dtype=int)
    mask = flags_cls.create_quality_mask(
        quality_array=np.asarray(lc[column]), bitmask=quality_bitmask)
    lc = lc[mask]
    lc.meta["QUALITY_BITMASK"] = quality_bitmask
    lc.meta["QUALITY_MASK"] = mask
    return lc


def read_kepler_lightcurve(filename, flux_column="pdcsap_flux",
                           quality_bitmask="default"):
    """Official Kepler/K2 light curve (reference ``io/kepler.py:10-61``)."""
    lc = read_generic_lightcurve(filename, flux_column=flux_column,
                                 quality_column="sap_quality",
                                 time_format="bkjd")
    if "sap_quality" not in lc._cols and "quality" not in lc._cols:
        lc["quality"] = np.zeros(len(lc), dtype=int)
    lc = _apply_quality(lc, KeplerQualityFlags, quality_bitmask)
    lc.meta["AUTHOR"] = "Kepler"
    lc.meta["TARGETID"] = lc.meta.get("KEPLERID")
    return KeplerLightCurve(data=lc, meta=lc.meta)


def read_tess_lightcurve(filename, flux_column="pdcsap_flux",
                         quality_bitmask="default", time_format="btjd"):
    """Official TESS/SPOC light curve (reference ``io/tess.py:10-75``)."""
    lc = read_generic_lightcurve(filename, flux_column=flux_column,
                                 time_format=time_format)
    lc = _apply_quality(lc, TessQualityFlags, quality_bitmask)
    if isinstance(filename, str) and "tess-spoc" in filename:
        lc.meta["AUTHOR"] = "TESS-SPOC"
    else:
        lc.meta["AUTHOR"] = "SPOC"
    lc.meta["TARGETID"] = lc.meta.get("TICID")
    return TessLightCurve(data=lc, meta=lc.meta)


def read_folded_lightcurve(filename, time_format="jd", **kwargs):
    """Folded light curve saved by ``FoldedLightCurve.to_fits()``
    (reference ``io/folded.py:8-43``): the fold ephemeris
    (PERIOD/PHNORM/EPOCH/PHEPOCH) is restored from the primary header,
    and a normalized-phase fold gets its dimensionless phase back."""
    from ..units import Quantity
    from .fits import open_fits
    lc = read_generic_lightcurve(filename, flux_column="flux",
                                 time_format=time_format)
    h0 = open_fits(filename)[0].header
    meta = dict(lc.meta)
    if "PERIOD" in h0:
        meta["PERIOD"] = Quantity(float(h0["PERIOD"]), "d")
    meta["NORMALIZE_PHASE"] = bool(h0.get("PHNORM", False))
    if h0.get("EPOCH", "") != "":
        meta["EPOCH_TIME"] = Time(float(h0["EPOCH"]), format="jd")
    meta["EPOCH_PHASE"] = float(h0.get("PHEPOCH", 0.0))
    cols = dict(lc._cols)
    if meta["NORMALIZE_PHASE"] and "PERIOD" in meta:
        cols["time"] = Time(
            np.asarray(cols["time"].value, dtype=np.float64)
            / meta["PERIOD"].value, format="jd")
    out = FoldedLightCurve(data=cols, meta=meta)
    return out
