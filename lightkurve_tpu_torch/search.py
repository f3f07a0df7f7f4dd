"""Archive search and download (``lightkurve_tpu/search.py``, copied: the
port never imports the JAX package; Lightkurve's ``search.py`` wraps
``astroquery.mast``).

The search is offline-first:

- :class:`SearchResult`: the table-of-products API (len/repr/indexing,
  column accessors, ``download``/``download_all``).
- :func:`search_lightcurve` / :func:`search_targetpixelfile`: the MAST
  query → join → filter chain of :mod:`.mast` when a transport is given
  or configured (``$LIGHTKURVE_TPU_MAST_FIXTURES`` for a recorded one,
  ``$LIGHTKURVE_TPU_MAST_HTTP=1`` for the live archive over HTTP,
  :mod:`.mast_http`), else a scan of local archive directories
  (``archive_dir=``, ``$LIGHTKURVE_TPU_ARCHIVE``, the cache directory) by
  file name.  A scan that finds nothing raises :class:`SearchError`.
- :func:`search_tesscut`: cutouts of FFI stacks a transport registers,
  cut on the host by ``TargetPixelFileFactory.from_fits_images``.

Downloads open files with the port's :func:`read`; a collection of light
curves is a ``LightCurveCollection``, whose ``stitch().to_stack()`` or
``to_stack()`` puts the curves on the card.  Directory scans are cached
per process (``_scan_dir``), like Lightkurve's ``@cached``
(``search.py:595,724,856``): files written after a directory's first scan
are not seen.
"""
from __future__ import annotations

import glob
import logging
import os
import re
from functools import lru_cache

import numpy as np

from .config import conf, get_cache_dir
from .utils import LightkurveError, LightkurveWarning

log = logging.getLogger(__name__)

__all__ = ["SearchResult", "search_lightcurve", "search_lightcurvefile",
           "search_targetpixelfile", "search_tesscut", "SearchError"]


class SearchError(LightkurveError):
    pass


class SearchResult:
    """Container of archive search results (reference ``search.py:75-518``).

    Backed by a list of product dicts with keys: path, target_name,
    productFilename, mission, author, exptime, year, description,
    filetype.
    """

    #: authors shown first, for v1 download() compatibility
    #: (reference ``search.py:137``)
    _SORT_PRIORITY = {"Kepler": 1, "K2": 1, "SPOC": 1, "KBONUS-BKG": 2,
                      "TESS-SPOC": 2, "QLP": 3}

    def __init__(self, table=None):
        self.table = list(table or [])
        if self.table:
            self._sort_table()
        # extra columns appended to the repr, configurable via
        # ``conf.search_result_display_extra_columns`` (reference
        # ``search.py:124``)
        try:
            self.display_extra_columns = list(
                conf.search_result_display_extra_columns or [])
        except Exception:
            self.display_extra_columns = []

    def _sort_table(self):
        """Sort by distance, pipeline priority, author, then chronology
        (reference ``search.py:126-146``).  'year' alone cannot order TESS
        sectors 99 vs 100 (#1557), hence the sequence_number tie-breaker;
        'sequence_number' alone fails for Kepler, hence 'mission'."""
        def _num(v, default=0.0):
            try:
                return float(v)
            except (TypeError, ValueError):
                # exptime can be the v1 strings 'long'/'short'/'fast'
                return {"fast": 20.0, "short": 60.0,
                        "long": 1800.0}.get(str(v).lower(), default)

        def _key(r):
            return (_num(r.get("distance")),
                    self._SORT_PRIORITY.get(r.get("author"), 9),
                    str(r.get("author") or ""),
                    _num(r.get("year")),
                    _num(r.get("sequence_number"), -1.0),
                    str(r.get("mission") or ""),
                    _num(r.get("exptime")))
        self.table.sort(key=_key)

    def __len__(self):
        return len(self.table)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return SearchResult([self.table[int(key)]])
        if isinstance(key, slice):
            return SearchResult(self.table[key])
        key = np.asarray(key)
        if key.dtype == bool:
            return SearchResult([r for r, k in zip(self.table, key) if k])
        return SearchResult([self.table[int(i)] for i in key])

    def __repr__(self):
        lines = [f"SearchResult containing {len(self)} data products.", ""]
        if self.table:
            cols = ["mission", "year", "author", "exptime", "target_name"]
            # reference ``search.py:149-160``: configured extra columns
            # are appended when at least one row carries them
            for extra in self.display_extra_columns:
                if extra not in cols and any(extra in r for r in self.table):
                    cols.append(extra)
            lines.append(" ".join([f"{'#':>6s}"]
                                  + [f"{c:>14s}" for c in cols]))
            for i, r in enumerate(self.table):
                lines.append(" ".join(
                    [f"{i:>6d}"] + [f"{str(r.get(c, '')):>14s}"
                                    for c in cols]))
        return "\n".join(lines)

    # -- column accessors ---------------------------------------------------
    def _col(self, name):
        return np.asarray([r.get(name) for r in self.table])

    @property
    def mission(self):
        return self._col("mission")

    @property
    def author(self):
        return self._col("author")

    @property
    def target_name(self):
        return self._col("target_name")

    @property
    def exptime(self):
        """Exposure times as a seconds Quantity (reference
        ``search.py:251-254``)."""
        from .units import Quantity
        vals = []
        for r in self.table:
            v = r.get("exptime")
            try:
                vals.append(float(v))
            except (TypeError, ValueError):
                vals.append({"fast": 20.0, "short": 60.0,
                             "long": 1800.0}.get(str(v).lower(), np.nan))
        return Quantity(np.asarray(vals), "s")

    @property
    def year(self):
        return self._col("year")

    @property
    def filename(self):
        return self._col("productFilename")

    @property
    def distance(self):
        """Angular distance (arcsec) from the search position for each
        product (reference ``search.py:275-278``); NaN for products
        indexed without a cone-search distance."""
        from .units import Quantity
        return Quantity(np.asarray(
            [r.get("distance", np.nan) for r in self.table], dtype=float),
            "arcsec")

    @property
    def ra(self):
        """Right Ascension for each data product found (reference
        ``search.py:241-244``)."""
        return np.asarray([r.get("s_ra", np.nan) for r in self.table],
                          dtype=float)

    @property
    def dec(self):
        """Declination for each data product found (reference
        ``search.py:246-249``)."""
        return np.asarray([r.get("s_dec", np.nan) for r in self.table],
                          dtype=float)

    @property
    def obsid(self):
        """Unique observation IDs (reference ``search.py:236-239``)."""
        vals = [r.get("obsid") for r in self.table
                if r.get("obsid") is not None]
        return np.unique(np.asarray(vals, dtype="int64"))

    @property
    def unique_targets(self):
        """Deduplicated (target_name, s_ra, s_dec) rows (reference
        ``search.py:224-234``)."""
        seen = set()
        rows = []
        for r in self.table:
            name = r.get("target_name")
            if name not in seen:
                seen.add(name)
                rows.append((name, r.get("s_ra", np.nan),
                             r.get("s_dec", np.nan)))
        return {
            "target_name": np.asarray([r[0] for r in rows]),
            "s_ra": np.asarray([r[1] for r in rows], dtype=float),
            "s_dec": np.asarray([r[2] for r in rows], dtype=float),
        }

    # -- downloads ------------------------------------------------------------
    def _materialize(self, row, download_dir=None, cutout_size=None,
                     **factory_kwargs):
        """Resolve one product row to a local FITS path (or, for TESScut
        rows, build the cutout TPF from the transport's local FFI stack —
        the offline re-design of reference ``search.py:522-594``)."""
        if row.get("productFilename") == "TESScut":
            transport = row.get("_transport")
            sector = int(row.get("sequence_number"))
            ffi_paths = getattr(transport, "ffi_sectors", {}).get(sector)
            if not ffi_paths:
                raise SearchError(
                    f"No local FFI stack registered for TESS sector "
                    f"{sector}; a recorded transport needs 'ffi_sectors' "
                    "entries to serve TESScut cutouts offline.")
            from .targetpixelfile import (TargetPixelFileFactory,
                                          TessTargetPixelFile)
            size = cutout_size if cutout_size is not None else 5
            if np.isscalar(size):
                size = (int(size), int(size))
            position = row.get("_position")     # (ra, dec) from resolver
            return TargetPixelFileFactory.from_fits_images(
                ffi_paths, position=position, size=size,
                target_id=str(row.get("target_name", "TESScut")),
                tpf_cls=TessTargetPixelFile, **factory_kwargs)
        path = row.get("path")
        if path is None and row.get("_transport") is not None:
            path = row["_transport"].download_product(
                row, download_dir or get_cache_dir())
        return path

    def download(self, quality_bitmask="default", download_dir=None,
                 cutout_size=None, **kwargs):
        """Open the first product (reference ``search.py:369-430``)."""
        if len(self) == 0:
            # the reference warns and returns None (reference :420-424)
            import warnings
            warnings.warn("Cannot download from an empty search result.",
                          LightkurveWarning)
            return None
        if len(self) != 1:
            log.warning("Warning: {} files available to download. Only the "
                        "first file has been downloaded.".format(len(self)))
        from .io.read import read
        row = self.table[0]
        path = self._materialize(row, download_dir=download_dir,
                                 cutout_size=cutout_size)
        if not isinstance(path, (str, os.PathLike)):
            return path                         # TESScut rows return a TPF
        try:
            return read(path, quality_bitmask=quality_bitmask, **kwargs)
        except LightkurveError as e:
            raise SearchError(
                f"Failed to open {path}: {e}. The file may be corrupt — "
                "remove it and search again.")

    def download_all(self, quality_bitmask="default", download_dir=None,
                     cutout_size=None, **kwargs):
        """Open all products as a collection
        (reference ``search.py:432-518``)."""
        if len(self) == 0:
            import warnings
            warnings.warn("Cannot download from an empty search result.",
                          LightkurveWarning)
            return None
        from .collections import (LightCurveCollection,
                                  TargetPixelFileCollection)
        from .io.read import read
        from .targetpixelfile import TargetPixelFile
        objs = []
        for row in self.table:
            try:
                path = self._materialize(row, download_dir=download_dir,
                                         cutout_size=cutout_size)
                if not isinstance(path, (str, os.PathLike)):
                    objs.append(path)           # TESScut rows return a TPF
                    continue
                objs.append(read(path,
                                 quality_bitmask=quality_bitmask, **kwargs))
            except LightkurveError as e:
                log.warning(f"Skipping {row.get('path')}: {e}")
        if objs and isinstance(objs[0], TargetPixelFile):
            return TargetPixelFileCollection(objs)
        return LightCurveCollection(objs)


def _archive_dirs(archive_dir=None):
    dirs = []
    if archive_dir:
        dirs.append(archive_dir)
    env = os.environ.get("LIGHTKURVE_TPU_ARCHIVE")
    if env:
        dirs.append(env)
    dirs.append(get_cache_dir())
    return [d for d in dirs if d and os.path.isdir(d)]


@lru_cache(maxsize=256)
def _scan_dir(directory):
    """Index all FITS files under a directory (filename heuristics only;
    headers are read lazily on download)."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "**", "*.fits*"),
                                 recursive=True)):
        name = os.path.basename(path).lower()
        rec = {"path": path, "productFilename": os.path.basename(path),
               "target_name": "", "mission": "", "author": "",
               "exptime": "", "year": "", "description": "",
               "filetype": ""}
        m = re.search(r"kplr(\d{9})", name)
        if m:
            rec["target_name"] = str(int(m.group(1)))
            rec["mission"] = "Kepler"
            rec["author"] = "Kepler"
            ts = re.search(r"kplr\d{9}-(\d{4})\d{9}", name)
            if ts:
                rec["year"] = int(ts.group(1))
        m = re.search(r"ktwo(\d{9})", name)
        if m:
            rec["target_name"] = str(int(m.group(1)))
            rec["mission"] = "K2"
            rec["author"] = "K2"
            c = re.search(r"-c0*(\d+)", name)
            if c:
                rec["sequence_number"] = int(c.group(1))
                rec["mission"] = f"K2 Campaign {int(c.group(1)):02d}"
        if name.startswith("tess") or name.startswith("hlsp"):
            # SPOC files embed the TIC as a zero-padded 16-digit field
            m = re.search(r"-(\d{16})-", name) or \
                re.search(r"[-_]0*(\d{7,12})[-_]", name)
            if m:
                rec["target_name"] = str(int(m.group(1)))
                rec["mission"] = "TESS"
                rec["author"] = "SPOC"
            ts = re.search(r"^tess(\d{4})\d{9,}", name)
            if ts:
                rec["year"] = int(ts.group(1))
        m = re.search(r"-s0*(\d+)", name)
        if m:
            rec["mission"] = f"TESS Sector {int(m.group(1)):02d}"
            rec["sequence_number"] = int(m.group(1))
        if "_tp" in name or "targ" in name:
            rec["filetype"] = "Target Pixel"
        elif "_lc" in name or "_llc" in name or "_slc" in name or \
                "fast-lc" in name or "lightcurve" in name or \
                "_klc" in name:
            rec["filetype"] = "Lightcurve"
        # numeric exposure times follow the mission conventions the
        # reference gets from the MAST t_exptime field: Kepler 30-min
        # long / 1-min short cadence; TESS 2-min _lc and 20-s fast-lc
        if "fast" in name:
            rec["exptime"] = 20.0
        elif "_slc" in name:
            rec["exptime"] = 60.0
        elif name.startswith("tess") and ("_lc" in name or "_tp" in name):
            rec["exptime"] = 120.0
        else:
            rec["exptime"] = 1800.0
        out.append(rec)
    return tuple(map(tuple, (r.items() for r in out)))


def _exptime_match(value, exptime):
    """Reference ``_mask_by_exptime`` (search.py:1387-1401): numeric →
    exact match; 'fast' < 60 s; 'short' 60-200 s; 'long'/'ffi' ≥ 200 s."""
    if exptime is None:
        return True
    try:
        v = float(value)
    except (TypeError, ValueError):
        return False
    if isinstance(exptime, (int, float)):
        return v == float(exptime)
    e = str(exptime).lower()
    if e == "fast":
        return v < 60
    if e == "short":
        return 60 <= v < 200
    if e in ("long", "ffi"):
        return v >= 200
    return True


def _search_products(target, filetype="Lightcurve", radius=None,
                     exptime=None, cadence=None, mission=None, author=None,
                     quarter=None, month=None, campaign=None, sector=None,
                     limit=None, archive_dir=None, transport=None):
    """Product search: through the MAST pipeline when a transport is
    available (reference ``search.py:892-1238`` semantics, offline via
    recorded fixtures — see :mod:`.mast`), else over local archive
    directories by filename heuristics."""
    from . import mast
    if transport is None:
        transport = mast.default_transport()
    if transport is not None:
        if exptime is None and cadence is not None:
            exptime = cadence
        rows = mast.search_products_mast(
            target, transport, radius=radius, filetype=filetype,
            mission=mission or ("Kepler", "K2", "TESS"),
            provenance_name=author,
            exptime=exptime if exptime is not None else (0, 9999),
            quarter=quarter, month=month, campaign=campaign,
            sector=sector, limit=limit)
        return SearchResult(rows or [])
    target_str = str(target).lower().replace(" ", "")
    # resolve KIC/EPIC/TIC prefixes to bare ids, like the reference's
    # target parsing (search.py:1115-1210)
    m = re.match(r"^(kic|epic|tic)\s*(\d+)$", target_str)
    bare_id = m.group(2) if m else (target_str if target_str.isdigit()
                                    else None)
    rows = []
    for d in _archive_dirs(archive_dir):
        for items in _scan_dir(d):
            rec = dict(items)
            if filetype.lower().startswith("light") and \
                    rec["filetype"] != "Lightcurve":
                continue
            if filetype.lower().startswith("target") and \
                    rec["filetype"] != "Target Pixel":
                continue
            hit = False
            if bare_id and rec["target_name"] == str(int(bare_id)):
                hit = True
            if target_str and target_str in \
                    rec["productFilename"].lower():
                hit = True
            if hit:
                rows.append(rec)
    if mission:
        missions = [mission] if isinstance(mission, str) else list(mission)
        rows = [r for r in rows
                if any(mm.lower() in str(r["mission"]).lower()
                       for mm in missions)]
    if author:
        authors = [author] if isinstance(author, str) else list(author)
        rows = [r for r in rows
                if any(str(a).lower() == str(r["author"]).lower()
                       for a in authors)]
    if exptime is None and cadence is not None:
        # `cadence=` is the deprecated v1 alias (reference search.py:648)
        exptime = cadence
    rows = [r for r in rows if _exptime_match(r.get("exptime"), exptime)]
    seq = sector if sector is not None else (
        campaign if campaign is not None else quarter)
    if seq is not None:
        wanted = {int(s) for s in np.atleast_1d(seq)}
        rows = [r for r in rows if r.get("sequence_number") in wanted]
    if limit:
        rows = rows[: int(limit)]
    if not rows:
        raise SearchError(
            f"No local data products found for target {target!r}. "
            "Querying MAST needs network access: pass "
            "`transport=HTTPMASTTransport()` or set "
            "LIGHTKURVE_TPU_MAST_HTTP=1; or place mission FITS files in "
            "$LIGHTKURVE_TPU_ARCHIVE or pass `archive_dir=`. "
            f"(searched: {_archive_dirs(archive_dir)})")
    return SearchResult(rows)


def search_lightcurve(target, radius=None, exptime=None, cadence=None,
                      mission=("Kepler", "K2", "TESS"), author=None,
                      quarter=None, month=None, campaign=None, sector=None,
                      limit=None, archive_dir=None, transport=None):
    """Search for light curve products (reference ``search.py:595-723``)."""
    return _search_products(target, filetype="Lightcurve", radius=radius,
                            exptime=exptime, cadence=cadence,
                            mission=mission, author=author, quarter=quarter,
                            month=month, campaign=campaign, sector=sector,
                            limit=limit, archive_dir=archive_dir,
                            transport=transport)


def search_targetpixelfile(target, radius=None, exptime=None, cadence=None,
                           mission=("Kepler", "K2", "TESS"), author=None,
                           quarter=None, month=None, campaign=None,
                           sector=None, limit=None, archive_dir=None,
                           transport=None):
    """Search for TPF products (reference ``search.py:724-855``)."""
    return _search_products(target, filetype="Target Pixel", radius=radius,
                            exptime=exptime, cadence=cadence,
                            mission=mission, author=author, quarter=quarter,
                            month=month, campaign=campaign, sector=sector,
                            limit=limit, archive_dir=archive_dir,
                            transport=transport)


def search_tesscut(target, sector=None, transport=None):
    """TESSCut FFI cutout search (reference ``search.py:856-891``).

    Network-only in the reference; here it runs against a transport whose
    ``ffi_sectors`` registry maps sector numbers to local FFI stacks —
    ``download(cutout_size=...)`` then builds the cutout TPF on the host
    via :meth:`TargetPixelFileFactory.from_fits_images`.
    """
    from . import mast
    if transport is None:
        transport = mast.default_transport()
    if transport is None:
        raise SearchError(
            "search_tesscut requires the MAST TESScut web service, which "
            "needs network access and no transport of this package serves. "
            "Register local FFI stacks with a RecordedMASTTransport "
            "(ffi_sectors) or use "
            "`TargetPixelFileFactory.from_fits_images` directly.")
    rows = mast.search_products_mast(target, transport, filetype="FFI",
                                     sector=sector)
    # carry the resolved position so download() can place the cutout
    try:
        pos = transport.resolve_object(str(target))
        for r in rows:
            r["_position"] = pos
    except Exception:
        pass
    return SearchResult(rows)


def search_lightcurvefile(*args, **kwargs):
    """Deprecated alias of :func:`search_lightcurve` (reference
    ``search.py:714-721``)."""
    import warnings
    from .utils import LightkurveDeprecationWarning
    warnings.warn("search_lightcurvefile() is deprecated, please use "
                  "search_lightcurve() instead.",
                  LightkurveDeprecationWarning)
    return search_lightcurve(*args, **kwargs)
