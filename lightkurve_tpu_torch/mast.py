"""Offline MAST search pipeline (``lightkurve_tpu/mast.py``, copied: the
port never imports the JAX package).

Lightkurve drives its archive search through ``astroquery.mast``
(reference ``search.py:892-1406``): query observations, fetch the product
list, join the two tables, synthesize user-facing columns, then filter by
mission/quarter/month/exptime.  The same pipeline runs here against a
pluggable :class:`MASTTransport`:

- :class:`RecordedMASTTransport` replays canned JSON responses (the same
  tables astroquery would return), so the full query→join→filter chain
  runs offline.
- :class:`~lightkurve_tpu_torch.mast_http.HTTPMASTTransport` queries the
  live archive over MAST's Mashup API (the criteria dict uses
  astroquery's field names).

The query semantics are Lightkurve's: exact-target-name resolution for
KIC/EPIC/TIC ids (reference ``search.py:1177-1193``), cone-search fallback
via a name resolver, the obs×products right join with mission-string
synthesis (``search.py:1025-1060``), and ``filter_products`` with the
Kepler quarter/month masks (``search.py:1240-1406``).  Host code.
"""
from __future__ import annotations

import json
import logging
import os
import re

import numpy as np

from .utils import LightkurveError

log = logging.getLogger(__name__)

__all__ = ["MASTTransport", "RecordedMASTTransport", "query_mast",
           "search_products_mast", "filter_products",
           "KEPLER_SC_MONTH_STARTS"]


#: Kepler short-cadence (quarter, month) → release start timestamp, the
#: archival lookup the reference ships as
#: ``data/short_cadence_month_lookup.csv`` (mission-defined metadata used
#: to map a file's date-stamp to its month within a quarter).
KEPLER_SC_MONTH_STARTS = {
    (0, 1): "2009131110544",
    (1, 1): "2009166044711",
    (2, 1): "2009201121230", (2, 2): "2009231120729",
    (2, 3): "2009259162342",
    (3, 1): "2009291181958", (3, 2): "2009322144938",
    (3, 3): "2009350160919",
    (4, 1): "2010009094841", (4, 2): "2010019161129",
    (4, 3): "2010049094358", (4, 4): "2010078100744",
    (5, 1): "2010111051353", (5, 2): "2010140023957",
    (5, 3): "2010174090439",
    (6, 1): "2010203174610", (6, 2): "2010234115140",
    (6, 3): "2010265121752",
    (7, 1): "2010296114515", (7, 2): "2010326094124",
    (7, 3): "2010355172524",
    (8, 1): "2011024051157", (8, 2): "2011053090032",
    (8, 3): "2011073133259",
    (9, 1): "2011116030358", (9, 2): "2011145075126",
    (9, 3): "2011177032512",
    (10, 1): "2011208035123", (10, 2): "2011240104155",
    (10, 3): "2011271113734",
    (11, 1): "2011303113607", (11, 2): "2011334093404",
    (11, 3): "2012004120508",
    (12, 1): "2012032013838", (12, 2): "2012060035710",
    (12, 3): "2012088054726",
    (13, 1): "2012121044856", (13, 2): "2012151031540",
    (13, 3): "2012179063303",
    (14, 1): "2012211050319", (14, 2): "2012242122129",
    (14, 3): "2012277125453",
    (15, 1): "2012310112549", (15, 2): "2012341132017",
    (15, 3): "2013011073258",
    (16, 1): "2013017113907", (16, 2): "2013065031647",
    (16, 3): "2013098041711",
    (17, 1): "2013121191144", (17, 2): "2013131215648",
}


class MASTTransport:
    """Protocol for archive backends the search pipeline can talk to."""

    def query_criteria(self, **criteria):
        """Return a list of observation dicts matching ``criteria``
        (astroquery field names: target_name / objectname+radius_deg /
        project / provenance_name / sequence_number / t_exptime /
        dataproduct_type)."""
        raise NotImplementedError

    def get_product_list(self, observations):
        """Return a list of product dicts for the given observations."""
        raise NotImplementedError

    def resolve_object(self, name):
        """Resolve a target name to (ra_deg, dec_deg)."""
        raise NotImplementedError

    def download_product(self, product, download_dir):
        """Materialize one product row locally; return its path."""
        raise NotImplementedError


class ResolverError(LightkurveError):
    """The transport could not resolve an object name to coordinates
    (reference ``search.py:1237`` wraps astroquery's ResolverError)."""


def _ci_in(value, options):
    return str(value).lower() in [str(o).lower() for o in options]


class RecordedMASTTransport(MASTTransport):
    """Replay canned MAST responses from a JSON fixture.

    Fixture schema (a dict, a ``.json`` path, or a directory containing
    ``mast_fixtures.json``)::

        {"resolver":     {"<name>": [ra_deg, dec_deg], ...},
         "observations": [{"obs_id": ..., "target_name": ..., "s_ra": ...,
                           "s_dec": ..., "project": "Kepler",
                           "provenance_name": "Kepler", "t_exptime": 1800,
                           "sequence_number": 3 | null,
                           "dataproduct_type": "cube"|"timeseries",
                           "description": ..., "t_min": ...}, ...],
         "products":     [{"obs_id": ..., "productFilename": ...,
                           "description": ..., "dataURI": ...,
                           "local_path": "<optional file for download>"},
                          ...],
         "ffi_sectors":  {"1": ["/path/ffi1.fits", ...]}}

    ``local_path`` entries may be relative to the fixture file's
    directory.
    """

    def __init__(self, fixtures):
        if isinstance(fixtures, (str, os.PathLike)):
            path = os.fspath(fixtures)
            if os.path.isdir(path):
                path = os.path.join(path, "mast_fixtures.json")
            with open(path) as f:
                data = json.load(f)
            self._base = os.path.dirname(os.path.abspath(path))
        else:
            data = dict(fixtures)
            self._base = os.getcwd()
        self.resolver = {str(k).lower(): tuple(v)
                         for k, v in data.get("resolver", {}).items()}
        self.observations = list(data.get("observations", []))
        self.products = list(data.get("products", []))
        self.ffi_sectors = {int(k): list(v) for k, v in
                            data.get("ffi_sectors", {}).items()}
        #: transcript of queries, handy for asserting cache behavior
        self.calls = []

    # -- resolution -----------------------------------------------------
    def resolve_object(self, name):
        key = str(name).lower().strip()
        if key in self.resolver:
            return self.resolver[key]
        # sexagesimal "HH:MM:SS.S +DD:MM:SS.S" strings (reference
        # test_search_with_skycoord passes these through SkyCoord)
        m = re.match(r"^\s*(\d+):(\d+):([\d.]+)[,\s]\s*([+-]?)(\d+):"
                     r"(\d+):([\d.]+)\s*$", str(name))
        if m:
            ra = 15.0 * (int(m.group(1)) + int(m.group(2)) / 60.0
                         + float(m.group(3)) / 3600.0)
            dec = (int(m.group(5)) + int(m.group(6)) / 60.0
                   + float(m.group(7)) / 3600.0)
            return ra, -dec if m.group(4) == "-" else dec
        # "ra, dec" decimal strings resolve positionally like MAST does
        m = re.match(r"^\s*([\d.+-]+)[,\s]\s*([\d.+-]+)\s*$", str(name))
        if m:
            return float(m.group(1)), float(m.group(2))
        raise ResolverError(
            f"Could not resolve {name!r} to a sky position.")

    # -- observations ---------------------------------------------------
    def query_criteria(self, **criteria):
        self.calls.append(("query_criteria", dict(criteria)))
        rows = [dict(r) for r in self.observations]
        target_name = criteria.pop("target_name", None)
        objectname = criteria.pop("objectname", None)
        radius_deg = float(criteria.pop("radius_deg", 0.0) or 0.0)
        if target_name is not None:
            rows = [r for r in rows
                    if str(r.get("target_name")) == str(target_name)]
        elif objectname is not None:
            ra0, dec0 = self.resolve_object(objectname)
            kept = []
            for r in rows:
                ra, dec = r.get("s_ra"), r.get("s_dec")
                if ra is None or dec is None:
                    continue
                cosd = np.cos(np.deg2rad(dec0))
                sep = np.hypot((float(ra) - ra0) * cosd, float(dec) - dec0)
                if sep <= radius_deg + 1e-12:
                    r["distance"] = sep * 3600.0          # arcsec
                    kept.append(r)
            rows = kept
        for key, val in criteria.items():
            if val is None:
                continue
            if key == "t_exptime":
                if isinstance(val, (tuple, list)) and len(val) == 2:
                    lo, hi = float(val[0]), float(val[1])
                    rows = [r for r in rows
                            if lo <= float(r.get("t_exptime", np.nan))
                            <= hi]
                elif isinstance(val, (int, float)):
                    rows = [r for r in rows
                            if float(r.get("t_exptime", np.nan))
                            == float(val)]
                # string cadence aliases are filtered downstream
            elif key == "sequence_number":
                wanted = {int(s) for s in np.atleast_1d(val)}
                rows = [r for r in rows
                        if r.get("sequence_number") in wanted]
            elif key in ("project", "provenance_name", "obs_collection",
                         "dataproduct_type"):
                opts = np.atleast_1d(val).tolist()
                rows = [r for r in rows if _ci_in(r.get(key, ""), opts)]
            else:
                rows = [r for r in rows if r.get(key) == val]
        return rows

    # -- products ---------------------------------------------------------
    def get_product_list(self, observations):
        self.calls.append(("get_product_list",
                           [r.get("obs_id") for r in observations]))
        ids = {r.get("obs_id") for r in observations}
        return [dict(p) for p in self.products if p.get("obs_id") in ids]

    # -- download -----------------------------------------------------------
    def download_product(self, product, download_dir):
        lp = product.get("local_path") or product.get("path")
        if not lp:
            raise LightkurveError(
                f"Recorded fixture has no local file for product "
                f"{product.get('productFilename')!r}.")
        if not os.path.isabs(lp):
            lp = os.path.join(self._base, lp)
        if not os.path.exists(lp):
            raise LightkurveError(f"Fixture file missing: {lp}")
        os.makedirs(download_dir, exist_ok=True)
        dest = os.path.join(download_dir,
                            product.get("productFilename",
                                        os.path.basename(lp)))
        if os.path.abspath(dest) != os.path.abspath(lp) \
                and not os.path.exists(dest):
            import shutil
            shutil.copyfile(lp, dest)
            return dest
        return lp if os.path.abspath(dest) == os.path.abspath(lp) else dest


def default_transport():
    """Resolve the ambient transport: ``$LIGHTKURVE_TPU_MAST_FIXTURES``
    (a fixture JSON path) gives the recorded transport;
    ``$LIGHTKURVE_TPU_MAST_HTTP=1`` gives the live HTTP client
    (:class:`~lightkurve_tpu_torch.mast_http.HTTPMASTTransport`);
    otherwise ``None`` (callers scan the local archive)."""
    env = os.environ.get("LIGHTKURVE_TPU_MAST_FIXTURES")
    if env:
        return RecordedMASTTransport(env)
    if os.environ.get("LIGHTKURVE_TPU_MAST_HTTP", "").strip() in (
            "1", "true", "yes"):
        from .mast_http import HTTPMASTTransport
        return HTTPMASTTransport()
    return None


# ---------------------------------------------------------------------------
# the reference's query/join/filter chain
# ---------------------------------------------------------------------------
def query_mast(target, transport, radius=None,
               project=("Kepler", "K2", "TESS"), provenance_name=None,
               exptime=(0, 9999), sequence_number=None,
               **extra_query_criteria):
    """Observation query with the reference's exact-name-then-cone logic
    (reference ``search.py:1115-1238``).

    ``radius`` is arcseconds (float).
    Returns a list of observation dicts sorted by distance, with the
    ``exptime`` alias column added.
    """
    criteria = {"project": list(np.atleast_1d(project)),
                **extra_query_criteria}
    if provenance_name is not None:
        criteria["provenance_name"] = list(np.atleast_1d(provenance_name))
    if sequence_number is not None:
        criteria["sequence_number"] = sequence_number
    if exptime is not None and not isinstance(exptime, str):
        criteria["t_exptime"] = exptime

    # exact target-name resolution for mission ids (reference
    # search.py:1177-1193 — prevents source confusion, GitHub #148/#718)
    exact_target_name = None
    target_lower = str(target).lower()
    kplr_match = re.match(r"^(kplr|kic) ?(\d+)$", target_lower)
    if kplr_match:
        exact_target_name = f"kplr{kplr_match.group(2).zfill(9)}"
    ktwo_match = re.match(r"^(ktwo|epic) ?(\d+)$", target_lower)
    if ktwo_match:
        exact_target_name = f"ktwo{ktwo_match.group(2).zfill(9)}"
    tess_match = re.match(r"^(tess|tic) ?(\d+)$", target_lower)
    if tess_match:
        # for TESS the MAST id is not zero-padded
        exact_target_name = f"{tess_match.group(2)}"

    if exact_target_name and radius is None:
        obs = transport.query_criteria(target_name=exact_target_name,
                                       **criteria)
        if obs:
            for r in obs:
                r["exptime"] = r.get("t_exptime")
                # distance is absent in name queries; add it like the
                # reference does (search.py:1211-1214)
                r.setdefault("distance", 0.0)
            return obs
        log.debug("No observations found. Now performing a cone search "
                  "instead.")

    if radius is None:
        radius = 0.0001                                   # arcsec
    try:
        obs = transport.query_criteria(objectname=str(target),
                                       radius_deg=float(radius) / 3600.0,
                                       **criteria)
    except ResolverError as exc:
        # MAST failed to resolve the name (reference search.py:1236-1238
        # re-raises astroquery's ResolverError as a SearchError)
        from .search import SearchError
        raise SearchError(str(exc)) from exc
    obs.sort(key=lambda r: float(r.get("distance", 0.0)))
    for r in obs:
        r["exptime"] = r.get("t_exptime")
    return obs


def _synthesize_mission_column(rows):
    """Add 'author' and 'mission' columns (reference ``search.py:1035-1060``):
    mission = '<project> <Quarter|Campaign|Sector> <seqno:02d>', with the
    Kepler quarter parsed from the description (sequence_number is
    unpopulated for Kepler prime) and the K2 9/10/11 split campaigns
    suffixed a/b from the product filename."""
    obs_prefix = {"Kepler": "Quarter", "K2": "Campaign", "TESS": "Sector"}
    for r in rows:
        r["author"] = r.get("provenance_name")
        proj = r.get("project", "")
        seqno = r.get("sequence_number")
        obs_seqno = f"{seqno:02d}" if seqno else ""
        if proj == "Kepler" and seqno is None:
            m = re.findall(r".*Q(\d+)", str(r.get("description", "")))
            obs_seqno = f"{int(m[0]):02d}" if m else ""
        if proj == "K2" and seqno in (9, 10, 11):
            for half, letter in zip([1, 2], ["a", "b"]):
                if f"c{seqno}{half}" in str(r.get("productFilename", "")):
                    obs_seqno = f"{seqno:02d}{letter}"
        r["mission"] = f"{proj} {obs_prefix.get(proj, '')} {obs_seqno}"
    return rows


def _mask_kepler_products(rows, quarter=None, month=None):
    """Kepler prime quarter/month mask (reference ``search.py:1328-1384``)."""
    mask = np.array([str(r.get("provenance_name", "")).lower() == "kepler"
                     for r in rows], dtype=bool)
    if mask.sum() == 0:
        return mask
    if quarter is not None:
        qmask = np.zeros(len(rows), dtype=bool)
        for q in np.atleast_1d(quarter):
            qmask |= np.array(
                [str(r.get("description", "")).lower().replace("-", "")
                 .endswith(f"q{q}") for r in rows])
        mask &= qmask
    if month is not None:
        months = np.atleast_1d(month).tolist()
        is_sc = mask & np.array(["Short" in str(r.get("description", ""))
                                 for r in rows])
        for idx in np.where(is_sc)[0]:
            desc = str(rows[idx]["description"])
            q = int(desc.split(" - ")[-1][1:].replace("-", ""))
            uri = str(rows[idx].get("dataURI", ""))
            date = uri.split("/")[-1].split("-")[1].split("_")[0]
            permitted = [KEPLER_SC_MONTH_STARTS[(q, m)] for m in months
                         if (q, m) in KEPLER_SC_MONTH_STARTS]
            if date not in permitted:
                mask[idx] = False
    return mask


def _mask_by_exptime(rows, exptime):
    """Exposure-time mask (reference ``search.py:1387-1401``)."""
    mask = np.ones(len(rows), dtype=bool)
    vals = np.array([float(r.get("exptime") or r.get("t_exptime") or
                           np.nan) for r in rows])
    if isinstance(exptime, (int, float)) and not isinstance(exptime, bool):
        mask &= vals == float(exptime)
    elif isinstance(exptime, str):
        e = exptime.lower()
        if e == "fast":
            mask &= vals < 60
        elif e == "short":
            mask &= (vals >= 60) & (vals < 200)
        elif e in ("long", "ffi"):
            mask &= vals >= 200
    return mask


def filter_products(rows, campaign=None, quarter=None, month=None,
                    sector=None, exptime=None, limit=None,
                    project=("Kepler", "K2", "TESS"), provenance_name=None,
                    filetype="Target Pixel"):
    """The reference's ``_filter_products`` (``search.py:1240-1327``) over
    a list of joined obs×product dicts."""
    if provenance_name is None:
        provenance_lower = ("kepler", "k2", "spoc")
    else:
        provenance_lower = [str(p).lower()
                            for p in np.atleast_1d(provenance_name)]
    mask = np.ones(len(rows), dtype=bool)
    # Kepler prime products only pass through their own quarter/month mask
    mask &= ~np.array([str(r.get("provenance_name", "")).lower() == "kepler"
                       for r in rows], dtype=bool)
    if "kepler" in provenance_lower and campaign is None and sector is None:
        mask |= _mask_kepler_products(rows, quarter=quarter, month=month)

    fnames = [str(r.get("productFilename", "")).lower() for r in rows]
    if filetype.lower() == "lightcurve":
        mask &= np.array([f.endswith("lc.fits") for f in fnames])
    elif filetype.lower() == "target pixel":
        mask &= np.array([f.endswith(("tp.fits", "targ.fits.gz"))
                          for f in fnames])
    elif filetype.lower() == "ffi":
        mask &= np.array(["TESScut" in str(r.get("description", ""))
                          for r in rows])
    mask &= np.array([f.endswith("fits") or f.endswith("fits.gz")
                      for f in fnames])
    mask &= _mask_by_exptime(rows, exptime)

    out = [r for r, k in zip(rows, mask) if k]
    out.sort(key=lambda r: (float(r.get("distance", 0.0)),
                            str(r.get("productFilename", ""))))
    if limit is not None:
        out = out[:limit]
    return out


def search_products_mast(target, transport, radius=None,
                         filetype="Lightcurve",
                         mission=("Kepler", "K2", "TESS"),
                         provenance_name=None, exptime=(0, 9999),
                         quarter=None, month=None, campaign=None,
                         sector=None, limit=None):
    """Full MAST product search (reference ``search.py:892-1112``):
    query → get_product_list → right join on obs_id → mission synthesis →
    filter.  Returns a list of product dicts ready for ``SearchResult``.
    """
    if isinstance(target, int):
        # mission-id disambiguation warnings (reference search.py:947-974)
        if 0 < target < 13161030:
            log.warning(
                f"Warning: {target} may refer to a different Kepler or "
                "TESS target. Please add the prefix 'KIC' or 'TIC' to "
                "disambiguate.")
            target = str(target)
        elif 200000000 < target < 252090718:
            log.warning(
                f"Warning: {target} may refer to a different K2 or TESS "
                "target. Please add the prefix 'EPIC' or 'TIC' to "
                "disambiguate.")
            target = str(target)
        elif target < 0:
            log.warning(
                f"Warning: {target} input value does not correspond to "
                "valid values in 'TIC' 'KIC' or 'EPIC'. Please check "
                "target name and try again.")
            return []
        else:
            target = f"TIC {target}"

    if quarter is not None:
        mission = "Kepler"
    if campaign is not None:
        mission = "K2"
    if sector is not None:
        mission = "TESS"
    mission = np.atleast_1d(mission).tolist()
    if provenance_name in ("any", "all") or provenance_name is None:
        provenance_name = None
    else:
        provenance_name = np.atleast_1d(provenance_name).tolist()

    extra = {}
    if filetype in ("Lightcurve", "Target Pixel"):
        extra["dataproduct_type"] = ["cube", "timeseries"]
    if filetype.lower() == "ffi" and radius is None:
        radius = 0.0001

    observations = query_mast(target, transport, radius=radius,
                              project=mission,
                              provenance_name=provenance_name,
                              exptime=exptime,
                              sequence_number=campaign or sector, **extra)
    if not observations:
        log.debug(f'No data found for target "{target}".')
        return []

    if filetype.lower() != "ffi":
        products = transport.get_product_list(observations)
        by_obs = {r.get("obs_id"): r for r in observations}
        joined = []
        for p in products:
            obs = by_obs.get(p.get("obs_id"), {})
            row = dict(obs)
            # right join: product columns win on conflicts except the
            # observation's own description/URI-style columns, which the
            # reference disambiguates with a "_products" suffix
            for k, v in p.items():
                if k in row and k in ("description", "dataURI", "size"):
                    row[k + "_products"] = v
                    # the Kepler quarter/month masks parse the PRODUCT
                    # description/dataURI (reference reads the joined
                    # column, which holds the obs values; keep those)
                else:
                    row[k] = v
            joined.append(row)
        joined.sort(key=lambda r: (float(r.get("distance", 0.0)),
                                   str(r.get("obs_id", ""))))
        _synthesize_mission_column(joined)
        out = filter_products(joined, filetype=filetype, campaign=campaign,
                              quarter=quarter, exptime=exptime,
                              project=mission,
                              provenance_name=provenance_name, month=month,
                              sector=sector, limit=limit)
        # record the transport on each row so SearchResult.download can
        # materialize fixture-backed products
        for r in out:
            r["_transport"] = transport
        return out

    # FFI (TESScut) rows
    cutouts = []
    for r in observations:
        if "TESS FFI" not in str(r.get("target_name", "")):
            continue
        s = r.get("sequence_number")
        if sector is None or s in np.atleast_1d(sector):
            cutouts.append({
                "description": f"TESS FFI Cutout (sector {s})",
                "mission": f"TESS Sector {s:02d}",
                "target_name": str(target),
                "targetid": str(target),
                "t_min": r.get("t_min"),
                "exptime": r.get("exptime", r.get("t_exptime")),
                "productFilename": "TESScut",
                "provenance_name": "TESScut",
                "author": "TESScut",
                "distance": 0.0,
                "sequence_number": s,
                "project": "TESS",
                "obs_collection": "TESS",
                "_transport": transport,
            })
    cutouts.sort(key=lambda r: (float(r.get("distance", 0.0)),
                                int(r.get("sequence_number", 0))))
    return cutouts
