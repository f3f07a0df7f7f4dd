"""Top-level ``read()`` dispatch (reference ``io/read.py:19-250``).

A copy of ``lightkurve_tpu/io/read.py``'s ``read``, ``open``,
``read_lc_collection`` and ``read_tpf_collection``: the product type is
detected from the headers (:func:`.detect.detect_filetype`) and the file
goes to its reader: the Kepler, TESS, folded and generic light curves,
the ten high-level science products (:mod:`.readers`) and the Kepler and
TESS target pixel files.
"""
from __future__ import annotations

import logging

from ..utils import LightkurveError
from .detect import detect_filetype
from .fits import open_fits

log = logging.getLogger(__name__)

__all__ = ["read", "open", "read_lc_collection", "read_tpf_collection",
           "READERS"]


def _tpf_reader(mission):
    def _read(path_or_hdul, **kwargs):
        from ..targetpixelfile import (KeplerTargetPixelFile,
                                       TessTargetPixelFile)
        cls = KeplerTargetPixelFile if mission == "Kepler" \
            else TessTargetPixelFile
        return cls(path_or_hdul, **kwargs)
    return _read


def _read_generic(path_or_hdul, quality_bitmask=None, **kwargs):
    """Generic (non-mission) products have no quality-flag vocabulary,
    so the ``quality_bitmask`` kwarg is accepted for interface
    uniformity but ignored with a debug note — the reference reads
    generic files unfiltered (reference io/read.py:139-140)."""
    from .generic import read_generic_lightcurve
    if quality_bitmask is not None:
        log.debug("quality_bitmask is ignored for generic data products")
    return read_generic_lightcurve(path_or_hdul, **kwargs)


def _get_readers():
    from . import readers as r
    return {
        "KeplerLightCurve": r.read_kepler_lightcurve,
        "TessLightCurve": r.read_tess_lightcurve,
        "Folded": r.read_folded_lightcurve,
        "QLP": r.read_qlp_lightcurve,
        "K2SFF": r.read_k2sff_lightcurve,
        "EVEREST": r.read_everest_lightcurve,
        "K2SC": r.read_k2sc_lightcurve,
        "CDIPS": r.read_cdips_lightcurve,
        "PATHOS": r.read_pathos_lightcurve,
        "TASOC": r.read_tasoc_lightcurve,
        "KEPSEISMIC": r.read_kepseismic_lightcurve,
        "TGLC": r.read_tglc_lightcurve,
        "ELEANOR": r.read_eleanor_lightcurve,
        "KeplerTargetPixelFile": _tpf_reader("Kepler"),
        "TessTargetPixelFile": _tpf_reader("TESS"),
        # unrecognized-but-valid time-series products fall back to the
        # generic reader, which infers the time format from
        # BJDREFI/MJDREF/JDREF headers (reference io/read.py:141-147)
        "generic": _read_generic,
    }


READERS = None


def read(path_or_url, filetype=None, **kwargs):
    """Read any supported Kepler/K2/TESS data product
    (reference ``io/read.py:32-147``).

    Detects the product type from the FITS headers and dispatches to the
    appropriate reader, returning a LightCurve or TargetPixelFile
    subclass.
    """
    global READERS
    if READERS is None:
        READERS = _get_readers()
    log.debug(f"Opening {path_or_url}.")
    try:
        hdulist = open_fits(path_or_url)
    except FileNotFoundError:
        # a missing file is not a corrupt file (reference #540): surface
        # the FileNotFoundError as-is, with the path in the message
        raise
    except Exception as e:
        raise LightkurveError(
            f"The file {path_or_url} could not be read. It may be corrupt "
            f"or not a FITS file; consider removing it and downloading "
            f"again. ({e})")
    if filetype is None:
        filetype = detect_filetype(hdulist)
        log.debug(f"Detected filetype: {filetype!r}.")
    if filetype is None:
        raise LightkurveError(
            f"Not recognized as a supported data product: {path_or_url}. "
            "This file may be corrupt due to an interrupted download. "
            "Please remove it from your disk and try again.")
    if filetype.endswith("TargetPixelFile"):
        return READERS[filetype](path_or_url, **kwargs)
    reader = READERS.get(filetype)
    if reader is None:
        raise LightkurveError(f"No reader registered for {filetype!r}")
    try:
        lc = reader(hdulist if not isinstance(path_or_url, str)
                    else path_or_url, **kwargs)
    except Exception as exc:
        # wrap reader failures with the path in the message
        # (reference io/read.py:141-148)
        raise LightkurveError(
            f"Error in reading Data product {path_or_url} of type "
            f"{filetype} .\nThis file may be corrupt due to an interrupted "
            "download. Please remove it from your disk and try again."
        ) from exc
    return lc


# Backwards-compatible alias: the reference keeps `lightkurve.open` as a
# deprecated alias of `read`.
def open(path_or_url, **kwargs):  # noqa: A001
    import warnings
    from ..utils import LightkurveDeprecationWarning
    warnings.warn("`open()` is deprecated, please use `read()` instead.",
                  LightkurveDeprecationWarning)
    return read(path_or_url, **kwargs)


def read_lc_collection(paths, **kwargs):
    """Read many light-curve files into a LightCurveCollection
    (reference ``io/read.py:176-212``).

    Unreadable paths and non-LightCurve products (e.g. TPFs) are skipped
    with a warning.  With ``stitch=True`` the collection is stitched into a
    single LightCurve before returning."""
    from ..collections import LightCurveCollection
    from ..lightcurve import LightCurve
    stitch = kwargs.pop("stitch", False)
    lcs = []
    for p in paths:
        try:
            obj = read(p, **kwargs)
        except Exception as e:
            # the reference skips ANY unreadable path with a warning
            # (reference io/read.py:188-191)
            log.warning(f"Skipping {p}: {e}")
            continue
        if isinstance(obj, LightCurve):
            lcs.append(obj)
        else:
            log.warning(f"Skipping {p}: not a light curve product "
                        f"({type(obj).__name__})")
    collection = LightCurveCollection(lcs)
    if stitch:
        return collection.stitch()
    return collection


def read_tpf_collection(paths, **kwargs):
    """Read many TPF files into a TargetPixelFileCollection
    (reference ``io/read.py:214-250``)."""
    from ..collections import TargetPixelFileCollection
    tpfs = []
    for p in paths:
        try:
            tpfs.append(read(p, **kwargs))
        except Exception as e:
            # skip ANY unreadable path (reference io/read.py:188-191)
            log.warning(f"Skipping {p}: {e}")
    return TargetPixelFileCollection(tpfs)
