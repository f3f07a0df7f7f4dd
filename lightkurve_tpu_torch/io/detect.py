"""Data-product detection (reference ``io/detect.py:8-169``).

A copy of ``lightkurve_tpu/io/detect.py``: sniffs ORIGIN/CREATOR/TELESCOP
keywords and column structure to identify the 15 Kepler/K2/TESS product
flavours, each of which :func:`lightkurve_tpu_torch.io.read.read` hands
to its reader.
"""
from __future__ import annotations

from .fits import HDUList

__all__ = ["detect_filetype"]


def detect_filetype(hdulist: HDUList):
    """Return a product-type string for a FITS HDUList, or None."""
    h0 = hdulist[0].header

    if "mit/qlp" in str(h0.get("ORIGIN", "")).lower():
        return "QLP"
    if h0.get("LITE") is not None and h0.get("PCORIGIN") is not None:
        return "ELEANOR"
    try:
        names = [n.upper() for n in hdulist[1].columns]
        if all(x in names for x in ["PSF_FLUX_RAW", "PSF_FLUX_COR",
                                    "AP4_FLUX_RAW", "AP4_FLUX_COR",
                                    "SKY_LOCAL"]):
            return "PATHOS"
    except Exception:
        pass
    if h0.get("ORIGIN") == "TASOC/Aarhus":
        return "TASOC"
    if "cdips" in str(h0.get("ORIGIN", "")).lower():
        return "CDIPS"
    if "k2sc" in str(h0.get("CREATOR", "")).lower():
        return "K2SC"
    try:
        h1 = hdulist[1].header
        if h1.get("EXTNAME") == "BESTAPER" and \
                h1.get("TTYPE4") == "ARCLENGTH":
            return "K2SFF"
    except Exception:
        pass
    try:
        comments = " ".join(str(c.comment) for c in h0.cards
                            if c.keyword == "COMMENT")
        if "EVEREST" in comments or "EVEREST" in str(h0.get("COMMENT", "")):
            return "EVEREST"
    except Exception:
        pass
    if h0.get("ORIGIN") == "CEA & SSI":
        return "KEPSEISMIC"
    if h0.get("ORIGIN") == "UCSB/TGLC":
        return "TGLC"

    try:
        creator = str(h0["CREATOR"]).lower()
        origin = str(h0.get("ORIGIN", "")).lower()
        if "folded" in creator:
            return "Folded"
        # a blank/undefined TELESCOP card falls back to MISSION, as in the
        # reference (old custom TESS exports leave TELESCOP undefined;
        # reference detect.py:137-142)
        telescop_val = h0.get("TELESCOP")
        if telescop_val is None:
            telescop_val = h0["MISSION"]      # KeyError → generic
        if telescop_val is None:
            # blank cards for both TELESCOP and MISSION: treat like the
            # reference's AttributeError path (Undefined.lower()) → generic
            return "generic"
        telescop = str(telescop_val).lower()
        if telescop == "kepler":
            if "targetpixel" in creator:
                return "KeplerTargetPixelFile"
            if "fluxexporter" in creator or "lightcurve" in creator:
                return "KeplerLightCurve"
        elif telescop == "tess":
            if "targetpixel" in creator:
                return "TessTargetPixelFile"
            if "lightcurve" in creator:
                return "TessLightCurve"
            if "stsci" in origin:
                return "TessTargetPixelFile"
    except KeyError:
        return "generic"
    return None
