"""Target pixel file containers.

Counterpart of ``lightkurve_tpu/targetpixelfile.py`` (the reference's
``TargetPixelFile`` family, ``src/lightkurve/targetpixelfile.py``): the
cube and the per-cadence columns are numpy arrays, read once from the
file by :mod:`.io.fits`.  The cube reductions (aperture photometry, moment
centroids, the background estimate) run as torch functions
(:mod:`.ops.photometry`) in :data:`config.default_dtype` on
:func:`config.resolve_device` (the card unless the configuration says
``"cpu"``); the masks, the quadratic centroid and the WCS are host numpy.
A stack of targets is :class:`lightkurve_tpu_torch.batch.TPFStack`.

PRF photometry runs through :mod:`.prf` (one batched fit of every
cadence on the device).  ``plot``, ``plot_pixels`` and ``animate`` draw
with matplotlib, imported inside the call; ``interact`` and
``interact_sky`` write standalone pages with ``html=``, and ``interact``
without it draws its static matplotlib panel.  The solar-system query of
a TPF raises, as ``lightkurve_tpu``'s does (a light curve's runs).
"""
from __future__ import annotations

import logging
import os
import warnings
from copy import deepcopy

import numpy as np
import torch

from .lightcurve import KeplerLightCurve, LightCurve, TessLightCurve, _tensor
from .time import Time
from .units import Quantity, electron_per_second, pixel
from .utils import (KeplerQualityFlags, LightkurveDeprecationWarning,
                    LightkurveError, LightkurveWarning, TessQualityFlags,
                    _strip_quantity, centroid_quadratic, validate_method)
from .wcs import TanWCS

log = logging.getLogger(__name__)

__all__ = ["TargetPixelFile", "KeplerTargetPixelFile",
           "TessTargetPixelFile", "TargetPixelFileFactory"]


def _host(x):
    """A tensor back as a float64 host array."""
    return x.cpu().numpy().astype(float)


class TargetPixelFile:
    """Abstract (time, row, column) flux cube
    (reference ``targetpixelfile.py:94-2068``)."""

    _quality_flags_cls = KeplerQualityFlags
    _drops_nan_time_cadences = False

    def __init__(self, path_or_hdulist=None, quality_bitmask="default",
                 **kwargs):
        from .io.fits import HDUList, open_fits
        self.quality_bitmask = quality_bitmask
        if path_or_hdulist is None:
            # subclasses / factory fill the fields directly
            self.path = None
            return
        if isinstance(path_or_hdulist, HDUList):
            hdulist = path_or_hdulist
            self.path = None
        else:
            self.path = os.fspath(path_or_hdulist) if not hasattr(
                path_or_hdulist, "read") else None
            hdulist = open_fits(path_or_hdulist)
        self._load_hdulist(hdulist, quality_bitmask)

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------
    def _load_hdulist(self, hdulist, quality_bitmask):
        self.meta = {k: v for k, v in hdulist[0].header.items()
                     if k not in ("COMMENT", "HISTORY")}
        table = hdulist[1]
        self._ext_header = table.header
        if getattr(table.data, "names", None) is None:
            # e.g. single-cadence exports whose extension 1 is an IMAGE
            # (reference test data ktwo*-first-cadence.fits.gz); astropy's
            # TPF constructor cannot load these either
            raise LightkurveError(
                "Extension 1 of this file is not a binary table of "
                "cadences; it cannot be opened as a TargetPixelFile.")
        cols = {name.upper(): np.asarray(table.data[name])
                for name in table.data.names}
        # Verify the file format: a TPF must carry FLUX and QUALITY columns
        # (reference ``targetpixelfile.py:216-233`` raises the same message
        # when a light-curve file is opened as a TPF)
        for key in ("FLUX", "QUALITY"):
            if key not in cols:
                raise ValueError(
                    "File {} does not have a {} column, "
                    "is this a target pixel file?".format(self.path, key))
        # raw, unmasked columns back the `hdu` property, which must expose
        # the file as stored (reference hdu semantics: properties index
        # hdu[1].data with quality_mask, reference targetpixelfile.py:330)
        self._columns_raw = cols
        qual = cols.get("QUALITY", np.zeros(len(cols["TIME"]), dtype=int))
        self.quality_mask = self._quality_flags_cls.create_quality_mask(
            qual, bitmask=quality_bitmask)
        if self._drops_nan_time_cadences and \
                quality_bitmask not in (0, "none", None):
            # Early TESS releases had time=NaN cadences with no QUALITY flag
            # set; the reference drops them for any non-'none' bitmask
            # (reference targetpixelfile.py:2796-2801, TESS class only).
            self.quality_mask &= np.isfinite(
                np.asarray(cols["TIME"], dtype=np.float64))
        m = self.quality_mask
        self._columns = {k: v[m] for k, v in cols.items()}
        # missing time values become 0, as in the reference (liberal
        # quality masks may retain cadences with NaN TIME; reference
        # targetpixelfile.py:333-335)
        tv = np.asarray(self._columns["TIME"], dtype=np.float64).copy()
        tv[~np.isfinite(tv)] = 0.0
        self._columns["TIME"] = tv
        # aperture extension
        self._aperture = None
        try:
            ap_hdu = hdulist["APERTURE"]
            self._aperture = np.asarray(ap_hdu.data)
        except Exception:
            for hdu in hdulist[2:]:
                if hdu.data is not None and np.ndim(hdu.data) == 2:
                    self._aperture = np.asarray(hdu.data)
                    break
        self._wcs = None

    @classmethod
    def _from_arrays(cls, columns, meta, ext_header=None, aperture=None,
                     quality_bitmask="default"):
        tpf = cls(None, quality_bitmask=quality_bitmask)
        tpf._columns = dict(columns)
        tpf._columns_raw = tpf._columns
        tpf.meta = dict(meta)
        tpf._ext_header = ext_header or {}
        tpf._aperture = aperture
        tpf.quality_mask = np.ones(len(columns["TIME"]), dtype=bool)
        tpf._wcs = None
        return tpf

    def _ext_get(self, key, default=None):
        try:
            return self._ext_header.get(key, default)
        except AttributeError:
            return default

    # ------------------------------------------------------------------
    # core properties (reference :307-550)
    # ------------------------------------------------------------------
    @property
    def time(self):
        return Time(np.asarray(self._columns["TIME"], dtype=np.float64),
                    format=self._time_format, scale="tdb")

    @property
    def flux(self):
        return Quantity(np.asarray(self._columns["FLUX"], dtype=float),
                        electron_per_second)

    @flux.setter
    def flux(self, v):
        self._columns["FLUX"] = np.asarray(
            v.value if isinstance(v, Quantity) else v, dtype=float)

    @property
    def flux_err(self):
        arr = self._columns.get("FLUX_ERR")
        if arr is None:
            arr = np.full_like(self._columns["FLUX"], np.nan)
        return Quantity(np.asarray(arr, dtype=float), electron_per_second)

    @flux_err.setter
    def flux_err(self, v):
        self._columns["FLUX_ERR"] = np.asarray(
            v.value if isinstance(v, Quantity) else v, dtype=float)

    @property
    def flux_bkg(self):
        arr = self._columns.get("FLUX_BKG")
        if arr is None:
            arr = np.full_like(self._columns["FLUX"], np.nan)
        return Quantity(np.asarray(arr, dtype=float), electron_per_second)

    @property
    def flux_bkg_err(self):
        arr = self._columns.get("FLUX_BKG_ERR")
        if arr is None:
            arr = np.full_like(self._columns["FLUX"], np.nan)
        return Quantity(np.asarray(arr, dtype=float), electron_per_second)

    @property
    def raw_cnts(self):
        arr = self._columns.get("RAW_CNTS")
        return None if arr is None else np.asarray(arr)

    @property
    def quality(self):
        return np.asarray(self._columns.get(
            "QUALITY", np.zeros(len(self), dtype=int)))

    @property
    def cadenceno(self):
        return np.asarray(self._columns.get(
            "CADENCENO", np.arange(len(self))))

    @property
    def pos_corr1(self):
        return np.asarray(self._columns.get(
            "POS_CORR1", np.zeros(len(self))))

    @property
    def pos_corr2(self):
        return np.asarray(self._columns.get(
            "POS_CORR2", np.zeros(len(self))))

    @property
    def pipeline_mask(self):
        """Aperture-extension bit 2 flags pipeline-selected pixels."""
        if self._aperture is None:
            return np.zeros(self.shape[1:], dtype=bool)
        ap = np.asarray(self._aperture)
        if ap.dtype.kind in "iu":
            return (ap & 2) == 2
        return ap.astype(bool)

    @property
    def hdu(self):
        """HDUList view of the file AS STORED: extension-1 rows are the
        raw cadences, so ``tpf.flux == hdu[1].data['FLUX'][quality_mask]``
        (reference hdu semantics)."""
        return self.to_fits(raw=True)

    def show_properties(self):
        """Print a description of the meta keywords (reference
        ``targetpixelfile.py`` show_properties)."""
        rows = [("Attribute", "Value")]
        for k, v in self.meta.items():
            if np.isscalar(v) or isinstance(v, str):
                rows.append((str(k).lower(), str(v)))
        rows.extend([("shape", str(self.shape)),
                     ("quality_bitmask", str(self.quality_bitmask))])
        width = max(len(r[0]) for r in rows) + 2
        print("\n".join(f"{k:<{width}}{v}" for k, v in rows))

    @property
    def column(self):
        return int(self._ext_get("1CRV5P", self.meta.get("COLUMN", 0)) or 0)

    @property
    def row(self):
        return int(self._ext_get("2CRV5P", self.meta.get("ROW", 0)) or 0)

    @property
    def shape(self):
        return self._columns["FLUX"].shape

    @property
    def n_cadences(self):
        return self.shape[0]

    @property
    def ra(self):
        return self.meta.get("RA_OBJ")

    @property
    def dec(self):
        return self.meta.get("DEC_OBJ")

    @property
    def mission(self):
        return self.meta.get("MISSION", self.meta.get("TELESCOP"))

    @property
    def targetid(self):
        return self.meta.get("TARGETID", self.meta.get(
            "KEPLERID", self.meta.get("TICID")))

    @property
    def wcs(self):
        """TAN WCS reconstructed from tabular keywords
        (reference ``:401-441``)."""
        if self._wcs is None:
            self._wcs = TanWCS.from_tpf_header(self._ext_header, colnum=5) \
                if self._ext_header else TanWCS([1, 1], [0, 0], np.eye(2))
        return self._wcs

    @property
    def has_wcs(self):
        """True when the cadence table carries real tabular WCS keywords
        (``1CRVL5``-style); :attr:`wcs` silently falls back to an
        identity transform otherwise, which sky overlays must not trust
        (reference interact.py raises 'no valid coordinate' there)."""
        h = self._ext_header
        return bool(h) and any(
            k in h for k in ("1CRVL5", "1CTYP5", "2CRVL5"))

    @property
    def nan_time_mask(self):
        return ~np.isfinite(self.time.value)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return (f"{type(self).__name__} (ID: {self.targetid}) "
                f"shape={self.shape}")

    def get_header(self, ext=0):
        """Header of extension ``ext`` (reference
        ``targetpixelfile.py:300-312``): 0 = primary (meta), 1 = cadence
        table, 2+ = further extensions (e.g. APERTURE)."""
        if ext == 0:
            return self.meta
        if ext == 1:
            return self._ext_header
        return self.hdu[ext].header

    def get_keyword(self, keyword, hdu=0, default=None):
        return self.get_header(hdu).get(keyword, default)

    # ------------------------------------------------------------------
    # slicing & arithmetic (reference :123-203)
    # ------------------------------------------------------------------
    def __getitem__(self, key):
        """Cadence selection returns a sliced copy."""
        if isinstance(key, (int, np.integer)):
            key = slice(key, key + 1) if key != -1 else slice(-1, None)
        out = type(self)(None, quality_bitmask=self.quality_bitmask)
        out._columns = {k: v[key] for k, v in self._columns.items()}
        # derived objects expose exactly their (sliced) columns as raw:
        # aliasing the dict keeps `hdu` in sync with later mutations
        out._columns_raw = out._columns
        out.meta = deepcopy(self.meta)
        out._ext_header = self._ext_header
        out._aperture = self._aperture
        out.quality_mask = np.ones(len(out._columns["TIME"]), dtype=bool)
        out._wcs = self._wcs
        out.path = self.path
        return out

    def _math(self, other, op):
        out = self[slice(None)]
        val = other.value if isinstance(other, Quantity) else other
        flux = out._columns["FLUX"]
        out._columns["FLUX"] = op(flux, val)
        if op in (np.multiply, np.divide) and "FLUX_ERR" in out._columns:
            out._columns["FLUX_ERR"] = op(out._columns["FLUX_ERR"], val)
        return out

    def __add__(self, other):
        return self._math(other, np.add)

    def __sub__(self, other):
        return self._math(other, np.subtract)

    def __mul__(self, other):
        return self._math(other, np.multiply)

    def __truediv__(self, other):
        return self._math(other, np.divide)

    __radd__ = __add__
    __rmul__ = __mul__

    # ------------------------------------------------------------------
    # aperture machinery (reference :593-782)
    # ------------------------------------------------------------------
    def _resolve_default_aperture_mask(self, aperture_mask):
        if isinstance(aperture_mask, str) and aperture_mask == "default":
            return "pipeline" if np.any(self.pipeline_mask) else "threshold"
        return aperture_mask

    def _parse_aperture_mask(self, aperture_mask):
        """Normalize user input to a 2D boolean mask (reference
        ``:603-678``)."""
        aperture_mask = self._resolve_default_aperture_mask(aperture_mask)
        if isinstance(aperture_mask, str) and aperture_mask == "pipeline" \
                and not np.any(self.pipeline_mask):
            raise ValueError("_parse_aperture_mask: 'pipeline' is requested,"
                             " but it is missing or empty.")
        if hasattr(aperture_mask, "shape") and \
                aperture_mask.shape != self.shape[1:]:
            raise ValueError(
                f"`aperture_mask` has shape {aperture_mask.shape}, but the "
                f"flux data has shape {self.shape[1:]}")
        if aperture_mask is None:
            mask = np.ones(self.shape[1:], dtype=bool)
        elif isinstance(aperture_mask, str):
            am = aperture_mask.lower()
            if am == "all":
                mask = np.ones(self.shape[1:], dtype=bool)
            elif am == "pipeline":
                mask = self.pipeline_mask
            elif am == "threshold":
                mask = self.create_threshold_mask()
            elif am == "background":
                mask = ~self.create_threshold_mask(threshold=0,
                                                   reference_pixel=None)
            elif am == "empty":
                mask = np.zeros(self.shape[1:], dtype=bool)
            else:
                raise ValueError(f"Unknown aperture mask {aperture_mask!r}")
        else:
            arr = np.asarray(aperture_mask)
            if arr.dtype.kind in "iu":
                if ((arr & 2) == 2).any():
                    mask = (arr & 2) == 2
                else:
                    mask = arr.astype(bool)
            else:
                mask = arr.astype(bool)
        self._last_aperture_mask = mask
        return mask

    def create_threshold_mask(self, threshold=3, reference_pixel="center"):
        """MAD-threshold mask keeping the contiguous region nearest the
        reference pixel (reference ``:680-742``)."""
        from scipy.ndimage import label as nd_label
        if reference_pixel == "center":
            reference_pixel = (self.shape[2] / 2, self.shape[1] / 2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            median_image = np.nanmedian(self.flux.value, axis=0)
        vals = median_image[np.isfinite(median_image)].ravel()
        mad = np.median(np.abs(vals - np.median(vals))) if len(vals) else 0.0
        mad_cut = 1.4826 * mad * threshold + np.nanmedian(median_image)
        threshold_mask = np.nan_to_num(median_image) >= mad_cut
        if reference_pixel is None or not threshold_mask.any():
            return threshold_mask
        labels = nd_label(threshold_mask)[0]
        label_args = np.argwhere(labels > 0)
        ref = np.array([reference_pixel[1], reference_pixel[0]])
        distances = [np.hypot(*(crd - ref)) for crd in label_args]
        closest = label_args[np.argmin(distances)]
        return labels == labels[closest[0], closest[1]]

    # ------------------------------------------------------------------
    # photometry (device kernels; reference :783-932)
    # ------------------------------------------------------------------
    def estimate_centroids(self, aperture_mask="default", method="moments"):
        """Per-cadence centroids via 'moments' or 'quadratic'
        (reference ``:783-866``).  The moments are taken within the cutout
        on the configured device and the cutout's corner added on the host
        in float64 (ROADMAP C5): in float32 an absolute column near 1000 is
        quantised at 6e-5 px."""
        method = validate_method(method, ["moments", "quadratic"])
        mask = self._parse_aperture_mask(aperture_mask)
        if method == "moments":
            from .ops.photometry import centroid_moments_cube
            col, row = centroid_moments_cube(_tensor(self.flux.value),
                                             _tensor(mask, torch.bool))
            return (Quantity(_host(col) + self.column, pixel),
                    Quantity(_host(row) + self.row, pixel))
        cols, rows = [], []
        flux = self.flux.value
        for i in range(len(self)):
            c, r = centroid_quadratic(flux[i], mask=mask)
            cols.append(c)
            rows.append(r)
        return (Quantity(np.asarray(cols) + self.column, pixel),
                Quantity(np.asarray(rows) + self.row, pixel))

    def _aperture_photometry(self, aperture_mask, flux_method="sum",
                             centroid_method="moments"):
        """Masked-reduction photometry on the configured device (reference
        ``:868-932``)."""
        from .ops.photometry import aperture_photometry_cube
        apmask = self._parse_aperture_mask(aperture_mask)
        if apmask.sum() == 0:
            log.warning("Warning: aperture mask contains zero pixels.")
        centroid_col, centroid_row = self.estimate_centroids(
            apmask, method=centroid_method)
        flux, flux_err = aperture_photometry_cube(
            _tensor(self.flux.value), _tensor(self.flux_err.value),
            _tensor(apmask, torch.bool), flux_method=flux_method)
        return (Quantity(_host(flux), electron_per_second),
                Quantity(_host(flux_err), electron_per_second),
                centroid_col, centroid_row)

    def extract_aperture_photometry(self, aperture_mask="default",
                                    flux_method="sum",
                                    centroid_method="moments"):
        """Aperture photometry → LightCurve (reference Kepler ``:2198-2254``,
        TESS ``:2861-2917``)."""
        # resolve 'default' here so meta records the resolved NAME (e.g.
        # 'threshold' for TESSCut-like products), as the reference does at
        # targetpixelfile.py:2230+2251 — not the parsed boolean array
        aperture_mask = self._resolve_default_aperture_mask(aperture_mask)
        flux, flux_err, centroid_col, centroid_row = \
            self._aperture_photometry(aperture_mask=aperture_mask,
                                      flux_method=flux_method,
                                      centroid_method=centroid_method)
        keys = dict(
            centroid_col=centroid_col, centroid_row=centroid_row,
            quality=self.quality, cadenceno=self.cadenceno)
        meta = dict(self.meta)
        meta.update({
            "APERTURE_MASK": aperture_mask,
            "LABEL": self.meta.get("OBJECT"),
            "MISSION": self.mission,
            "RA": self.ra, "DEC": self.dec,
            "TARGETID": self.targetid,
        })
        lc_cls = self._lightcurve_cls
        return lc_cls(time=self.time, flux=flux, flux_err=flux_err,
                      meta=meta, **keys)

    def to_lightcurve(self, method="aperture", **kwargs):
        """Dispatch to aperture/sap, prf, sff, cbv, or pld extraction
        (reference ``:552-591``)."""
        method = validate_method(
            method, supported_methods=["aperture", "prf", "sap", "sff",
                                       "cbv", "pld"])
        if method in ("aperture", "sap"):
            return self.extract_aperture_photometry(**kwargs)
        if method == "prf":
            return self.extract_prf_photometry(**kwargs).to_lightcurve()
        corrector = self.to_corrector(method)
        return corrector.correct(**kwargs)

    def estimate_background(self, aperture_mask="background"):
        """Median per-pixel background flux (reference ``:744-781``)."""
        from .ops.photometry import background_estimate_cube
        mask = self._parse_aperture_mask(aperture_mask)
        bkg = background_estimate_cube(_tensor(self.flux.value),
                                       _tensor(mask, torch.bool))
        return LightCurve(time=self.time,
                          flux=Quantity(_host(bkg),
                                        electron_per_second / pixel))

    def get_bkg_lightcurve(self, aperture_mask=None):
        """Summed FLUX_BKG over the aperture (reference ``:2300-2325``)."""
        aperture_mask = self._parse_aperture_mask(aperture_mask)
        flux_bkg = self.flux_bkg.value
        fb = np.nansum(flux_bkg[:, aperture_mask], axis=1)
        fbe = np.sqrt(np.nansum(self.flux_bkg_err.value[:, aperture_mask]
                                ** 2, axis=1))
        return LightCurve(time=self.time,
                          flux=Quantity(fb, electron_per_second),
                          flux_err=Quantity(fbe, electron_per_second))

    def to_corrector(self, method="pld", **kwargs):
        """Return a corrector object (reference ``:534-551``)."""
        method = validate_method(method, ["pld"])
        from .correctors import PLDCorrector
        return PLDCorrector(self, **kwargs)

    def get_coordinates(self, cadence="all"):
        """Per-pixel, per-cadence RA/Dec including POS_CORR shifts
        (reference ``:443-533``)."""
        w = self.wcs
        n, h, wid = self.shape
        yy, xx = np.mgrid[:h, :wid]
        pos1 = np.nan_to_num(self.pos_corr1)
        pos2 = np.nan_to_num(self.pos_corr2)
        # outliers in pos_corr → 0 (reference zeroes >50-pixel shifts)
        pos1[np.abs(pos1) > 50] = 0
        pos2[np.abs(pos2) > 50] = 0
        X = xx[None, :, :] + pos1[:, None, None]
        Y = yy[None, :, :] + pos2[:, None, None]
        ra, dec = w.pixel_to_world(X, Y, origin=0)
        if cadence != "all":
            return ra[cadence], dec[cadence]
        return ra, dec

    def query_solar_system_objects(self, *args, **kwargs):
        """Not available on a TPF, as in ``lightkurve_tpu``: query its
        light curve (``to_lightcurve().query_solar_system_objects``)."""
        raise NotImplementedError(
            "Solar-system object queries require network access to the "
            "SkyBot service, which is unavailable in this environment.")

    # ------------------------------------------------------------------
    # cutout (reference :1467-1616)
    # ------------------------------------------------------------------
    def cutout(self, center=None, size=5):
        """Rectangular pixel cutout returning a new TPF
        (reference ``:1467-1616``).  ``center`` is (col, row) 0-based within
        the cube, or None for the cube center."""
        h, w = self.shape[1:]
        if isinstance(size, int):
            size = (size, size)
        if center is None:
            ccol, crow = w // 2, h // 2
        else:
            ccol, crow = int(round(center[0])), int(round(center[1]))
        c0 = max(ccol - size[0] // 2, 0)
        r0 = max(crow - size[1] // 2, 0)
        c1 = min(c0 + size[0], w)
        r1 = min(r0 + size[1], h)
        out = self[slice(None)]
        for key in ("FLUX", "FLUX_ERR", "FLUX_BKG", "FLUX_BKG_ERR",
                    "RAW_CNTS", "COSMIC_RAYS"):
            if key in out._columns and np.ndim(out._columns[key]) == 3:
                out._columns[key] = out._columns[key][:, r0:r1, c0:c1]
        if out._aperture is not None:
            out._aperture = out._aperture[r0:r1, c0:c1]
        # shift WCS reference pixel and column/row bookkeeping
        hdr = dict(out._ext_header.items()) if hasattr(
            out._ext_header, "items") else dict(out._ext_header)
        hdr["1CRV5P"] = self.column + c0
        hdr["2CRV5P"] = self.row + r0
        if "1CRPX5" in hdr:
            hdr["1CRPX5"] = hdr["1CRPX5"] - c0
        if "2CRPX5" in hdr:
            hdr["2CRPX5"] = hdr["2CRPX5"] - r0
        out._ext_header = hdr
        out._wcs = None
        return out

    # ------------------------------------------------------------------
    # plotting (reference :1062-2068)
    # ------------------------------------------------------------------
    def plot(self, ax=None, frame=0, cadenceno=None, bkg=False, column=None,
             aperture_mask=None, show_colorbar=True, mask_color="pink",
             title=None, style=None, **kwargs):
        """Plot one cadence image with optional aperture overlay
        (reference ``:1062-1259``)."""
        import matplotlib.pyplot as plt
        cadencenos = _strip_quantity(self.cadenceno)
        if cadenceno is not None:
            frame = int(np.argwhere(cadencenos == cadenceno)[0, 0])
        img = _strip_quantity(self.flux)[frame]
        if bkg and "FLUX_BKG" in self._columns:
            img = img + np.nan_to_num(_strip_quantity(self.flux_bkg)[frame])
        if column is not None:
            img = _strip_quantity(self._columns[column.upper()])[frame]
        if ax is None:
            _, ax = plt.subplots()
        extent = [self.column - 0.5, self.column + img.shape[1] - 0.5,
                  self.row - 0.5, self.row + img.shape[0] - 0.5]
        im = ax.imshow(img, origin="lower", extent=extent, **kwargs)
        if show_colorbar:
            plt.colorbar(im, ax=ax, label=f"Flux ({electron_per_second})")
        if aperture_mask is not None:
            mask = self._parse_aperture_mask(aperture_mask)
            for r in range(mask.shape[0]):
                for c in range(mask.shape[1]):
                    if mask[r, c]:
                        ax.add_patch(plt.Rectangle(
                            (self.column + c - 0.5, self.row + r - 0.5),
                            1, 1, color=mask_color, fill=True, alpha=0.6))
        if title is None:
            title = f"Target ID: {self.targetid}, Cadence: " \
                f"{cadencenos[frame]}"
        ax.set_title(title)
        ax.set_xlabel("Pixel Column Number")
        ax.set_ylabel("Pixel Row Number")
        return ax

    def plot_pixels(self, ax=None, periodogram=False, aperture_mask=None,
                    show_flux=False, corrector_func=None, style=None,
                    normalize=False, title=None, markersize=0.5, **kwargs):
        """Grid of per-pixel light curves (reference ``:1869-2068``).
        ``normalize=True`` divides each pixel's series by its median
        before plotting (reference ``:1928-1934``); ``periodogram=True``
        draws each pixel's Lomb-Scargle periodogram, computed on the
        configured device."""
        import matplotlib.pyplot as plt
        mask = self._parse_aperture_mask(aperture_mask) \
            if aperture_mask is not None else None
        n, h, w = self.shape
        fig, axs = plt.subplots(h, w, figsize=(w * 1.2, h * 1.2),
                                sharex=True, sharey=False, squeeze=False)
        tv = _strip_quantity(self.time.value)
        flux = _strip_quantity(self.flux)
        for r in range(h):
            for c in range(w):
                ax = axs[h - 1 - r][c]
                y = flux[:, r, c]
                if normalize:
                    med = np.nanmedian(y)
                    if med != 0 and np.isfinite(med):
                        y = y / med
                if periodogram:
                    lc = LightCurve(time=tv, flux=np.nan_to_num(y))
                    try:
                        pg = lc.to_periodogram()
                        ax.plot(_strip_quantity(pg.frequency),
                                _strip_quantity(pg.power), lw=0.4, **kwargs)
                    except Exception:
                        pass
                else:
                    ax.plot(tv, y, ".", markersize=markersize, **kwargs)
                ax.set_xticks([])
                ax.set_yticks([])
                if mask is not None and mask[r, c]:
                    for spine in ax.spines.values():
                        spine.set_color("red")
                        spine.set_linewidth(2)
        if title:
            fig.suptitle(title)
        return axs

    def animate(self, step=None, interval=200, **plot_args):
        """matplotlib animation over cadences (reference ``:1261-1330``)."""
        import matplotlib.pyplot as plt
        from matplotlib import animation
        if step is None:
            step = max(len(self) // 50, 1)
        fig, ax = plt.subplots()
        frames = list(range(0, len(self), step))
        img = _strip_quantity(self.flux)
        cadencenos = _strip_quantity(self.cadenceno)
        vmin, vmax = np.nanpercentile(img, [1, 99])
        im = ax.imshow(img[0], origin="lower", vmin=vmin, vmax=vmax,
                       **plot_args)

        def update(i):
            im.set_data(img[frames[i]])
            ax.set_title(f"Cadence {cadencenos[frames[i]]}")
            return [im]

        return animation.FuncAnimation(fig, update, frames=len(frames),
                                       interval=interval, blit=True)

    def interact(self, *args, **kwargs):
        """The pixel-selector widget (reference ``interact.py:999-1318``):
        with ``html="path.html"`` a standalone page, without it a static
        matplotlib panel (:func:`.interact.show_interact_widget`)."""
        from .interact import show_interact_widget
        return show_interact_widget(self, *args, **kwargs)

    def interact_sky(self, *args, **kwargs):
        """The sky-view widget (reference ``interact.py:1319``): with
        ``html="path.html"`` and an offline ``catalog`` a standalone page
        (:func:`.interact.show_skyview_widget`).  The live bokeh and Gaia
        widget needs the network: raises."""
        if kwargs.get("html") is not None:
            from .interact import show_skyview_widget
            return show_skyview_widget(self, *args, **kwargs)
        raise NotImplementedError(
            "interact_sky() requires `bokeh` and network access to Gaia, "
            "which are unavailable in this environment. Pass "
            "html='path.html' and an offline `catalog` to write a "
            "standalone sky widget instead.")

    # ------------------------------------------------------------------
    # PRF photometry (reference :2347-2403)
    # ------------------------------------------------------------------
    def extract_prf_photometry(self, cadences=None, parallel=True, **kwargs):
        """Fit the TPF cube with a PRF scene model (reference
        ``targetpixelfile.py:2347-2403``): every cadence, or those in
        ``cadences``, in one batched fit on :data:`config.default_device`
        (``parallel`` is accepted and ignored)."""
        from .prf import PRFPhotometry, TPFModel
        model = kwargs.pop("model", None)
        if model is None:
            model = TPFModel.from_tpf(self, **kwargs)
        phot = PRFPhotometry(model)
        phot.run(self.flux.value, cadences=cadences)
        return phot

    def get_model(self, star_priors=None, **kwargs):
        """The PRF scene model of this TPF (:meth:`TPFModel.from_tpf`)."""
        from .prf import TPFModel
        return TPFModel.from_tpf(self, star_priors=star_priors, **kwargs)

    @property
    def astropy_time(self):
        """Deprecated v1.x accessor (reference keeps it warn-and-work):
        warns and returns ``time``."""
        warnings.warn("`astropy_time` is deprecated, use `time` instead.",
                      LightkurveDeprecationWarning)
        return self.time

    @property
    def header(self):
        """Deprecated v1.x accessor: warns and returns the primary-header
        meta mapping (the reference's ``get_header(0)``)."""
        warnings.warn("`header` is deprecated, use `meta` or "
                      "`get_header()` instead.",
                      LightkurveDeprecationWarning)
        return self.meta

    @classmethod
    def from_fits_images(cls, images, position=None, size=(11, 11),
                         extension=1, target_id="unnamed-target",
                         hdu0_keywords=None, **kwargs):
        """Build a TPF by cutting out FFI image stacks (reference
        ``targetpixelfile.py:1619-1867``); dispatches through
        :class:`TargetPixelFileFactory` with this class as the product
        type."""
        return TargetPixelFileFactory.from_fits_images(
            images, position=position, size=size, extension=extension,
            target_id=target_id, hdu0_keywords=hdu0_keywords,
            tpf_cls=cls, **kwargs)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_fits(self, output_fn=None, overwrite=False, raw=False):
        """Serialize back to a mission-style FITS TPF.  ``raw=True``
        serializes the unmasked cadences (the file as stored)."""
        from .io.fits import (BinTableHDU, Header, HDUList, ImageHDU,
                              PrimaryHDU, write_fits)
        ph = Header({k: v for k, v in self.meta.items()
                     if np.isscalar(v) or isinstance(v, str)})
        src = getattr(self, "_columns_raw", self._columns) if raw \
            else self._columns
        cols = {k: v for k, v in src.items()}
        table_hdr = Header({k: v for k, v in (
            self._ext_header.items() if hasattr(self._ext_header, "items")
            else [])
            if isinstance(k, str)})
        table_hdr["EXTNAME"] = "TARGETTABLES"
        hdus = HDUList([PrimaryHDU(header=ph),
                        BinTableHDU(data=cols, header=table_hdr)])
        if self._aperture is not None:
            hdus.append(ImageHDU(data=self._aperture.astype(np.int32),
                                 header=Header({"EXTNAME": "APERTURE"})))
        if output_fn is not None:
            write_fits(hdus, output_fn, overwrite=overwrite)
        return hdus

    @property
    def _time_format(self):
        bjdrefi = self._ext_get("BJDREFI")
        if bjdrefi == 2454833:
            return "bkjd"
        if bjdrefi == 2457000:
            return "btjd"
        return "jd"

    @property
    def _lightcurve_cls(self):
        return LightCurve


class KeplerTargetPixelFile(TargetPixelFile):
    """Kepler/K2 TPF (reference ``targetpixelfile.py:2069-2404``)."""

    _quality_flags_cls = KeplerQualityFlags

    @property
    def _time_format(self):
        return "bkjd"

    @property
    def _lightcurve_cls(self):
        return KeplerLightCurve

    @property
    def quarter(self):
        return self.meta.get("QUARTER")

    @property
    def campaign(self):
        return self.meta.get("CAMPAIGN")

    @property
    def channel(self):
        return self.meta.get("CHANNEL")

    @property
    def module(self):
        return self.meta.get("MODULE")

    @property
    def output(self):
        return self.meta.get("OUTPUT")

    @property
    def obsmode(self):
        return self.meta.get("OBSMODE")

    def extract_aperture_photometry(self, aperture_mask="default",
                                    flux_method="sum",
                                    centroid_method="moments"):
        lc = super().extract_aperture_photometry(
            aperture_mask=aperture_mask, flux_method=flux_method,
            centroid_method=centroid_method)
        lc.meta.update({"QUARTER": self.quarter, "CAMPAIGN": self.campaign,
                        "CHANNEL": self.channel, "MISSION": self.mission})
        return lc

    def get_prf_model(self, prf_dir=None):
        """A PRF model of this TPF's channel, column and row: the
        calibration-file :class:`~.prf.KeplerPRF` when a local calibration
        directory is given, else the analytic
        :class:`~.prf.SimpleKeplerPRF` (nothing is downloaded)."""
        from .prf import KeplerPRF, SimpleKeplerPRF
        shape = self.shape[1:]
        if prf_dir is not None:
            return KeplerPRF(channel=self.channel, shape=shape,
                             column=self.column, row=self.row,
                             prf_dir=prf_dir)
        return SimpleKeplerPRF(channel=self.channel, shape=shape,
                               column=self.column, row=self.row)

    def prf_lightcurve(self, **kwargs):
        """PRF-photometry light curve on the TPF's time axis with mission
        meta attached (reference ``targetpixelfile.py:2383-2403``)."""
        lc = self.extract_prf_photometry(**kwargs).to_lightcurve(
            time=self.time.value)
        lc.meta.update({
            "QUALITY": None, "CHANNEL": self.channel,
            "CAMPAIGN": self.campaign, "QUARTER": self.quarter,
            "MISSION": self.mission, "RA_OBJ": self.ra,
            "DEC_OBJ": self.dec, "TARGETID": self.targetid,
        })
        return KeplerLightCurve(time=lc.time.value, flux=lc.flux,
                                meta=lc.meta)


class TessTargetPixelFile(TargetPixelFile):
    """TESS TPF (reference ``targetpixelfile.py:2760-2941``)."""

    _quality_flags_cls = TessQualityFlags
    _drops_nan_time_cadences = True

    @property
    def background_mask(self):
        """Pixels the TESS pipeline used for its background aperture:
        bit 4 of the aperture extension (reference
        ``targetpixelfile.py:2830-2841``; falls back to an all-False
        mask when the extension is missing or non-integer, as early
        TESScut products were)."""
        try:
            aperture = np.asarray(self._aperture)
            # the reference applies `&` directly, which raises TypeError
            # for the float (sometimes NaN) apertures early TESScut
            # products carry — mirror that by refusing non-integer kinds
            # rather than casting (NaN→int is undefined)
            if aperture.dtype.kind not in "iub":
                raise TypeError(f"non-integer aperture {aperture.dtype}")
            return aperture.astype(np.int64) & 4 > 0
        except (TypeError, ValueError, AttributeError):
            return np.zeros(self.shape[1:], dtype=bool)

    @property
    def _time_format(self):
        return "btjd"

    @property
    def _lightcurve_cls(self):
        return TessLightCurve

    @property
    def sector(self):
        return self.meta.get("SECTOR")

    @property
    def camera(self):
        return self.meta.get("CAMERA")

    @property
    def ccd(self):
        return self.meta.get("CCD")

    def extract_aperture_photometry(self, aperture_mask="default",
                                    flux_method="sum",
                                    centroid_method="moments"):
        lc = super().extract_aperture_photometry(
            aperture_mask=aperture_mask, flux_method=flux_method,
            centroid_method=centroid_method)
        lc.meta.update({"SECTOR": self.sector, "CAMERA": self.camera,
                        "CCD": self.ccd, "MISSION": self.mission})
        return lc


class FactoryError(ValueError):
    """Raised when the TargetPixelFileFactory is misused
    (reference ``targetpixelfile.py:2400-2403``)."""


class TargetPixelFileFactory:
    """Assemble a TPF from per-cadence images
    (reference ``targetpixelfile.py:2405-2757``)."""

    def __init__(self, n_cadences, n_rows, n_cols,
                 target_id="unnamed-target", keywords=None):
        self.n_cadences = n_cadences
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.target_id = target_id
        self.keywords = dict(keywords or {})
        shape = (n_cadences, n_rows, n_cols)
        self.raw_cnts = np.full(shape, -1, dtype=np.int32)
        self.flux = np.full(shape, np.nan, dtype=np.float32)
        self.flux_err = np.full(shape, np.nan, dtype=np.float32)
        self.flux_bkg = np.full(shape, np.nan, dtype=np.float32)
        self.flux_bkg_err = np.full(shape, np.nan, dtype=np.float32)
        self.cosmic_rays = np.full(shape, np.nan, dtype=np.float32)
        self.time = np.zeros(n_cadences, dtype=np.float64)
        self.timecorr = np.zeros(n_cadences, dtype=np.float32)
        self.cadenceno = np.arange(n_cadences, dtype=np.int32)
        self.quality = np.zeros(n_cadences, dtype=np.int32)
        self.pos_corr1 = np.zeros(n_cadences, dtype=np.float32)
        self.pos_corr2 = np.zeros(n_cadences, dtype=np.float32)
        self.column = 0
        self.row = 0
        self.pos_corr1_set = False

    def add_cadence(self, frameno, flux=None, flux_err=None, flux_bkg=None,
                    flux_bkg_err=None, raw_cnts=None, cosmic_rays=None,
                    header=None):
        """Populate one cadence (reference ``:2466-2520``)."""
        if frameno >= self.n_cadences:
            raise FactoryError("frameno exceeds n_cadences")
        for name, arr in [("flux", flux), ("flux_err", flux_err),
                          ("flux_bkg", flux_bkg),
                          ("flux_bkg_err", flux_bkg_err),
                          ("raw_cnts", raw_cnts),
                          ("cosmic_rays", cosmic_rays)]:
            if arr is not None:
                arr = np.asarray(arr)
                if arr.shape != (self.n_rows, self.n_cols):
                    raise FactoryError(
                        f"{name} has shape {arr.shape}, expected "
                        f"({self.n_rows}, {self.n_cols})")
                getattr(self, name)[frameno] = arr
        header = header or {}
        if "TSTART" in header and "TSTOP" in header:
            self.time[frameno] = 0.5 * (header["TSTART"] + header["TSTOP"])
        elif "TIME" in header:
            self.time[frameno] = header["TIME"]
        if "CADENCENO" in header:
            self.cadenceno[frameno] = header["CADENCENO"]
        if "QUALITY" in header:
            self.quality[frameno] = header["QUALITY"]

    def _check_data(self):
        """Warn about duplicate or unsorted timestamps
        (reference ``targetpixelfile.py:2524-2541``)."""
        if len(np.unique(self.time)) != len(self.time):
            warnings.warn(
                "The factory-created TPF contains cadences with identical "
                "TIME values.", LightkurveWarning)
        if np.any(np.diff(self.time) < 0):
            warnings.warn(
                "Cadences in the factory-created TPF do not appear to be "
                "sorted in chronological order.", LightkurveWarning)

    def get_tpf(self, hdu0_keywords=None, ext_info=None, tpf_cls=None,
                **kwargs):
        """Build the TargetPixelFile (reference ``:2522-2757``)."""
        hdu0_keywords = {str(k).upper(): v
                         for k, v in (hdu0_keywords or {}).items()}
        if tpf_cls is None:
            # class follows the TELESCOP keyword, as in the reference
            telescop = str(hdu0_keywords.get(
                "TELESCOP", self.keywords.get("TELESCOP", "Kepler")))
            tpf_cls = TessTargetPixelFile if telescop.upper() == "TESS" \
                else KeplerTargetPixelFile
        self._check_data()
        columns = {
            "TIME": self.time,
            "TIMECORR": self.timecorr,
            "CADENCENO": self.cadenceno,
            "RAW_CNTS": self.raw_cnts,
            "FLUX": self.flux,
            "FLUX_ERR": self.flux_err,
            "FLUX_BKG": self.flux_bkg,
            "FLUX_BKG_ERR": self.flux_bkg_err,
            "COSMIC_RAYS": self.cosmic_rays,
            "QUALITY": self.quality,
            "POS_CORR1": self.pos_corr1,
            "POS_CORR2": self.pos_corr2,
        }
        meta = {"OBJECT": self.target_id, "TARGETID": self.target_id,
                "MISSION": "Kepler" if tpf_cls is KeplerTargetPixelFile
                else "TESS",
                "TELESCOP": "Kepler" if tpf_cls is KeplerTargetPixelFile
                else "TESS",
                # the reference's tag, so each package reads the other's
                # files the same way
                "CREATOR": "lightkurve_tpu TargetPixelFileFactory"}
        meta.update(self.keywords)
        meta.update(hdu0_keywords or {})
        ext_header = {"1CRV5P": self.column, "2CRV5P": self.row,
                      "BJDREFI": 2454833
                      if tpf_cls is KeplerTargetPixelFile else 2457000}
        ext_header.update(ext_info or {})
        return tpf_cls._from_arrays(columns, meta, ext_header=ext_header,
                                    quality_bitmask="none", **kwargs)

    @staticmethod
    def from_fits_images(images, position=None, size=(11, 11), extension=1,
                         target_id="unnamed-target", hdu0_keywords=None,
                         tpf_cls=None, **kwargs):
        """Cut out a TPF from a stack of FFI images
        (reference ``targetpixelfile.py:1619-1867``).

        ``images`` are paths or HDULists; ``position`` is (ra, dec) in
        degrees or None to use the image centers.
        """
        from .io.fits import open_fits, HDUList
        from .wcs import TanWCS
        tpf_cls = tpf_cls or KeplerTargetPixelFile
        factory = None
        carry_keywords = {}
        wcs_kw = None
        for i, img in enumerate(images):
            hdul = img if isinstance(img, HDUList) else open_fits(img)
            hdu = hdul[extension] if len(hdul) > extension else hdul[0]
            data = np.asarray(hdu.data, dtype=float)
            header = hdu.header
            if factory is None:
                factory = TargetPixelFileFactory(
                    n_cadences=len(images), n_rows=size[0], n_cols=size[1],
                    target_id=target_id)
            if position is None:
                ccol, crow = data.shape[1] // 2, data.shape[0] // 2
            else:
                if not any(k in header for k in ("CRVAL1", "CD1_1",
                                                 "CDELT1")):
                    raise LightkurveError(
                        "Requested a positional cutout but the image "
                        "headers carry no WCS keywords (reference "
                        "targetpixelfile.py:1661 raises here too).")
                w = TanWCS.from_image_header(header)
                x, y = w.world_to_pixel(position[0], position[1], origin=0)
                ccol, crow = int(round(float(x))), int(round(float(y)))
            r0 = crow - size[0] // 2
            c0 = ccol - size[1] // 2
            cut = np.full(size, np.nan)
            r1, c1 = r0 + size[0], c0 + size[1]
            rr0, cc0 = max(r0, 0), max(c0, 0)
            rr1 = min(r1, data.shape[0])
            cc1 = min(c1, data.shape[1])
            cut[rr0 - r0: rr1 - r0, cc0 - c0: cc1 - c0] = \
                data[rr0:rr1, cc0:cc1]
            hdr = {k: header.get(k) for k in ("TSTART", "TSTOP", "TIME",
                                              "CADENCENO", "QUALITY")
                   if k in header}
            if "TIME" not in hdr and "TSTART" not in hdr:
                hdr["TIME"] = float(i)
            factory.add_cadence(frameno=i, flux=cut, header=hdr)
            factory.column = c0
            factory.row = r0
            if i == 0:
                for k in ("TELESCOP", "INSTRUME", "CHANNEL", "MODULE",
                          "OUTPUT", "QUARTER", "CAMPAIGN", "SECTOR",
                          "CAMERA", "CCD", "MISSION"):
                    if k in header:
                        carry_keywords[k] = header[k]
                if any(k in header for k in ("CRVAL1", "CD1_1", "CDELT1")):
                    # propagate the image WCS into the cutout as tabular
                    # FLUX-column (colnum 5) keywords so tpf.wcs and
                    # to_fits carry it (reference targetpixelfile.py:
                    # 1833-1860 writes 1CRPX5-style cards)
                    w0 = TanWCS.from_image_header(header)
                    wcs_kw = {
                        "1CRPX5": w0.crpix[0] - c0,
                        "2CRPX5": w0.crpix[1] - r0,
                        "1CRVL5": w0.crval[0], "2CRVL5": w0.crval[1],
                        "1CDLT5": 1.0, "2CDLT5": 1.0,
                        "11PC5": w0.cd[0, 0], "12PC5": w0.cd[0, 1],
                        "21PC5": w0.cd[1, 0], "22PC5": w0.cd[1, 1],
                        "1CTYP5": "RA---TAN", "2CTYP5": "DEC--TAN",
                    }
        kw = dict(carry_keywords)
        kw.update(hdu0_keywords or {})
        return factory.get_tpf(hdu0_keywords=kw, ext_info=wcs_kw,
                               tpf_cls=tpf_cls, **kwargs)
