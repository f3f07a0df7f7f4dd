"""Per-product light-curve readers.

A copy of ``lightkurve_tpu/io/readers.py``: the Kepler, TESS and folded
readers and those of the high-level science products (QLP, K2SFF,
EVEREST, CDIPS, PATHOS, TASOC, KEPSEISMIC, TGLC, ELEANOR, K2SC).  Each
applies its product's default flux column, time format and
quality-bitmask filtering on top of :func:`read_generic_lightcurve`, on
the host.
"""
from __future__ import annotations

import numpy as np

from ..lightcurve import KeplerLightCurve, TessLightCurve, FoldedLightCurve
from ..time import Time
from ..utils import KeplerQualityFlags, TessQualityFlags
from .generic import read_generic_lightcurve

__all__ = [
    "read_kepler_lightcurve", "read_tess_lightcurve", "read_qlp_lightcurve",
    "read_k2sff_lightcurve", "read_everest_lightcurve",
    "read_cdips_lightcurve", "read_pathos_lightcurve",
    "read_tasoc_lightcurve", "read_kepseismic_lightcurve",
    "read_tglc_lightcurve", "read_eleanor_lightcurve",
    "read_k2sc_lightcurve", "read_folded_lightcurve",
]


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


def read_qlp_lightcurve(filename, flux_column="sap_flux",
                        flux_err_column=None, quality_bitmask="default"):
    """MIT QLP light curve (reference ``io/qlp.py:12-84``).

    flux_err defaults to the sector-dependent detrended-flux error column
    (``kspsap_flux_err`` for sectors 1-55, ``det_flux_err`` for 56+), and
    the QLP-specific "low precision points" bit (13 for sectors 1-55, 31
    for 56+) is added to the "hard"/"hardest" bitmasks."""
    kwargs = ({} if flux_err_column is None
              else {"flux_err_column": flux_err_column})
    lc = read_generic_lightcurve(filename, flux_column=flux_column,
                                 time_format="btjd", **kwargs)
    if flux_err_column is None:
        err_col = ("det_flux_err" if lc.meta.get("SECTOR", 0) >= 56
                   else "kspsap_flux_err")
        if err_col in lc._cols:
            lc["flux_err"] = lc[err_col]
    mask = TessQualityFlags.create_quality_mask(
        quality_array=np.asarray(lc["quality"]), bitmask=quality_bitmask)
    if quality_bitmask in ("hardest", "hard"):
        qlp_low_precision_bitmask = (
            2 ** 30 if lc.meta.get("SECTOR", 0) >= 56 else 2 ** 12)
        mask &= TessQualityFlags.create_quality_mask(
            quality_array=np.asarray(lc["quality"]),
            bitmask=qlp_low_precision_bitmask)
    lc = lc[mask]
    lc.meta["QUALITY_BITMASK"] = quality_bitmask
    lc.meta["QUALITY_MASK"] = mask
    lc.meta["AUTHOR"] = "QLP"
    lc.meta["TARGETID"] = lc.meta.get("TICID")
    # QLP light curves are normalized by default (reference io/qlp.py:82)
    lc.meta["NORMALIZED"] = True
    return TessLightCurve(data=lc, meta=lc.meta)


def read_k2sff_lightcurve(filename, ext="BESTAPER", **kwargs):
    """K2SFF (Vanderburg & Johnson) light curve
    (reference ``io/k2sff.py:8-42``)."""
    lc = read_generic_lightcurve(filename, flux_column="fcor",
                                 time_format="bkjd", ext=ext)
    lc.meta["AUTHOR"] = "K2SFF"
    lc.meta["TARGETID"] = lc.meta.get("KEPLERID")
    return KeplerLightCurve(data=lc, meta=lc.meta)


def read_everest_lightcurve(filename, flux_column="flux",
                            quality_bitmask="default", **kwargs):
    """EVEREST K2 light curve (reference ``io/everest.py:8-66``)."""
    lc = read_generic_lightcurve(filename, flux_column=flux_column,
                                 quality_column="quality",
                                 cadenceno_column="cadn",
                                 time_format="bkjd")
    lc = _apply_quality(lc, KeplerQualityFlags, quality_bitmask)
    lc.meta["AUTHOR"] = "EVEREST"
    lc.meta["TARGETID"] = lc.meta.get("KEPLERID")
    return KeplerLightCurve(data=lc, meta=lc.meta)


def read_cdips_lightcurve(filename, flux_column="IRM1",
                          include_inst_errs=False, quality_bitmask=None):
    """CDIPS TESS light curve (reference ``io/cdips.py:16-84``).

    The flux column's trailing digit selects the aperture: the error
    column is ``ife#``/``ire#`` (flux vs magnitude, only when
    ``include_inst_errs``) and the quality column is ``irq#``.  CDIPS
    ships pre-filtered data with string quality flags; only cadences
    flagged ``"G"``/``"0"`` are kept and ``quality_bitmask`` is ignored
    (accepted for cross-reader compatibility)."""
    ap = flux_column[-1]
    if include_inst_errs:
        flux_err_column = (f"ife{ap}" if flux_column[:-1].lower() == "ifl"
                           else f"ire{ap}")
    else:
        flux_err_column = ""
    lc = read_generic_lightcurve(filename, time_column="tmid_bjd",
                                 flux_column=flux_column.lower(),
                                 flux_err_column=flux_err_column,
                                 quality_column=f"irq{ap}",
                                 time_format="btjd")
    # CDIPS uses string quality keywords; Bouma+2019 filter out coarse
    # point (4) and desat (32) — everything not marked good
    quality = np.asarray(lc["quality"])
    quality_mask = (quality == "G") | (quality == "0")
    lc = lc[quality_mask]
    lc.meta["AUTHOR"] = "CDIPS"
    lc.meta["TARGETID"] = lc.meta.get("TICID")
    lc.meta["QUALITY_BITMASK"] = 36
    lc.meta["QUALITY_MASK"] = quality_mask
    return TessLightCurve(data=lc, meta=lc.meta)


def read_pathos_lightcurve(filename, flux_column="PSF_FLUX_COR",
                           quality_bitmask="default"):
    """PATHOS TESS light curve (reference ``io/pathos.py:12-60``)."""
    lc = read_generic_lightcurve(filename, flux_column=flux_column.lower(),
                                 time_format="btjd",
                                 quality_column="dquality")
    lc = _apply_quality(lc, TessQualityFlags, quality_bitmask)
    lc.meta["AUTHOR"] = "PATHOS"
    lc.meta["TARGETID"] = lc.meta.get("TICID")
    # PATHOS light curves are normalized by default (reference
    # io/pathos.py:70)
    lc.meta["NORMALIZED"] = True
    return TessLightCurve(data=lc, meta=lc.meta)


def read_tasoc_lightcurve(filename, flux_column="FLUX_CORR",
                          quality_bitmask=None):
    """TASOC TESS light curve (reference ``io/tasoc.py:12-40``)."""
    lc = read_generic_lightcurve(filename, flux_column=flux_column.lower(),
                                 time_format="btjd")
    lc.meta["AUTHOR"] = "TASOC"
    lc.meta["TARGETID"] = lc.meta.get("TICID")
    # TASOC light curves are normalized by default (reference
    # io/tasoc.py:33)
    lc.meta["NORMALIZED"] = True
    return TessLightCurve(data=lc, meta=lc.meta)


def read_kepseismic_lightcurve(filename, **kwargs):
    """KEPSEISMIC light curve (reference ``io/kepseismic.py:6-35``)."""
    lc = read_generic_lightcurve(filename, time_format="mjd")
    lc.meta["AUTHOR"] = "KEPSEISMIC"
    lc.meta["TARGETID"] = lc.meta.get("KEPLERID")
    # KEPSEISMIC light curves are normalized by default (reference
    # io/kepseismic.py:30)
    lc.meta["NORMALIZED"] = True
    return KeplerLightCurve(data=lc, meta=lc.meta)


def read_tglc_lightcurve(filename, flux_column="cal_psf_flux",
                         quality_bitmask="default"):
    """TGLC TESS light curve (reference ``io/tglc.py:13-96``).

    Raw ``psf_flux``/``aperture_flux``/``background`` columns get the
    conventional electron/s unit re-added (TGLC files carry no TUNITs);
    the ``cal_*`` columns are normalized and stay dimensionless."""
    from ..units import Quantity, electron_per_second, dimensionless
    lc = read_generic_lightcurve(filename, flux_column=flux_column.lower(),
                                 quality_column="tess_flags",
                                 cadenceno_column="cadence_num",
                                 time_format="btjd")
    for colname in ["psf_flux", "aperture_flux", "background"]:
        if colname in lc.columns:
            lc[colname] = Quantity(
                np.asarray(lc[colname], dtype=np.float32),
                electron_per_second)
    for colname in ["cal_psf_flux", "cal_aper_flux"]:
        if colname in lc.columns:
            lc[colname] = Quantity(
                np.asarray(lc[colname], dtype=np.float32), dimensionless)
    lc = _apply_quality(lc, TessQualityFlags, quality_bitmask)
    lc.meta["AUTHOR"] = "TGLC"
    lc.meta["TARGETID"] = lc.meta.get("OBJECT")
    # TGLC cal_* fluxes are normalized by default (reference io/tglc.py:88)
    lc.meta["NORMALIZED"] = True
    tic = lc.meta.get("TICID")
    if tic is not None:
        tic = int(tic)
        # SPOC/QLP-compatible target identification
        lc.meta["TARGETID"] = tic
        lc.meta["TICID"] = tic
        lc.meta["OBJECT"] = f"TIC {tic}"
        lc.meta["LABEL"] = f"TIC {tic}"
    return TessLightCurve(data=lc, meta=lc.meta)


def read_eleanor_lightcurve(filename, flux_column="CORR_FLUX",
                            quality_bitmask="default", **kwargs):
    """eleanor / GSFC-ELEANOR-LITE light curve
    (reference ``io/eleanor.py:12-135``).

    eleanor files break two conventions the reader repairs: the
    ``FLUX_ERR`` column is the *raw* flux error (the corrected-flux error
    is rescaled as corr_flux·raw_err/raw_flux), and the ``FFIINDEX``
    cadence numbers are stored as floats."""
    from ..units import Quantity, electron_per_second, percent, pixel, day
    lc = read_generic_lightcurve(filename, flux_column=flux_column.lower(),
                                 time_format="btjd",
                                 quality_column="quality",
                                 centroid_col_column="x_centroid",
                                 centroid_row_column="y_centroid",
                                 cadenceno_column="ffiindex")
    if quality_bitmask == "hardest":
        # eleanor adds 2 quality bits on top of the 16 TESS SPOC bits
        quality_bitmask = (TessQualityFlags.HARDEST_BITMASK
                           | 2 ** 17 | 2 ** 18)
    lc = _apply_quality(lc, TessQualityFlags, quality_bitmask)

    # eleanor FITS files carry no units; re-add the conventional ones
    for colname in ["flux", "flux_err", "raw_flux", "corr_flux",
                    "pca_flux", "psf_flux"]:
        if colname in lc.columns:
            lc[colname] = Quantity(np.asarray(lc[colname], dtype=float),
                                   electron_per_second)
    if "flux_bkg" in lc.columns:
        lc["flux_bkg"] = Quantity(np.asarray(lc["flux_bkg"], dtype=float),
                                  percent)
    for colname in ["centroid_col", "centroid_row", "x_centroid",
                    "y_centroid", "x_com", "y_com"]:
        if colname in lc.columns:
            lc[colname] = Quantity(np.asarray(lc[colname], dtype=float),
                                   pixel)
    if "barycorr" in lc.columns:
        lc["barycorr"] = Quantity(np.asarray(lc["barycorr"], dtype=float),
                                  day)

    # FLUX_ERR belongs to RAW_FLUX; rescale for the selected flux column
    if "flux_err" in lc.columns and "raw_flux" in lc.columns:
        lc["raw_flux_err"] = lc["flux_err"]
        if flux_column.lower() != "raw_flux":
            with np.errstate(divide="ignore", invalid="ignore"):
                lc["flux_err"] = Quantity(
                    lc.flux.value * lc["raw_flux_err"].value
                    / lc["raw_flux"].value, electron_per_second)

    # float FFIINDEX → int cadence numbers
    for colname in ["ffiindex", "cadenceno"]:
        if colname in lc.columns:
            vals = np.asarray(lc[colname])
            if not np.issubdtype(vals.dtype, np.integer):
                lc[colname] = np.asarray(vals, dtype=int)

    if (lc.meta.get("TVERSION") is not None
            and lc.meta.get("GITHUB")
            == "https://github.com/afeinstein20/eleanor"):
        lc.meta["AUTHOR"] = "GSFC-ELEANOR-LITE"
    else:
        lc.meta["AUTHOR"] = "ELEANOR"
    lc.meta["NORMALIZED"] = False
    tic = lc.meta.get("TIC_ID", lc.meta.get("TICID"))
    if tic is not None:
        lc.meta["TARGETID"] = tic
        lc.meta["TICID"] = tic
        lc.meta["OBJECT"] = f"TIC {tic}"
        lc.meta["LABEL"] = f"TIC {tic}"
    return TessLightCurve(data=lc, meta=lc.meta)


def read_k2sc_lightcurve(filename, **kwargs):
    """K2SC light curve (reference ``io/k2sc.py``)."""
    lc = read_generic_lightcurve(filename, flux_column="flux",
                                 time_format="bkjd")
    lc.meta["AUTHOR"] = "K2SC"
    lc.meta["TARGETID"] = lc.meta.get("KEPLERID")
    return KeplerLightCurve(data=lc, meta=lc.meta)


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
