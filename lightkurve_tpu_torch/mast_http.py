"""Live HTTP transport for the MAST archive (``lightkurve_tpu/mast_http.py``,
copied: the port never imports the JAX package).

Lightkurve performs its archive search through ``astroquery.mast``
(reference ``search.py:1115`` ``_query_mast`` → ``Observations.query_criteria``,
``:1024`` ``get_product_list``, ``:279-518`` product download).  astroquery
is a thin client over MAST's public **Mashup** REST API
(``https://mast.stsci.edu/api/v0/invoke``), so :class:`HTTPMASTTransport`
speaks that API directly with ``urllib`` and plugs into the same
query→join→filter chain as :class:`~lightkurve_tpu_torch.mast.RecordedMASTTransport`.

Services used (all public):

- ``Mast.Name.Lookup`` — name → (ra, dec), astroquery's ``resolve_object``.
- ``Mast.Caom.Filtered`` / ``Mast.Caom.Filtered.Position`` — the CAOM
  observation queries behind ``Observations.query_criteria``.
- ``Mast.Caom.Products`` — product list for a set of CAOM ``obsid`` values.
- ``…/api/v0.1/Download/file?uri=…`` — product download by ``dataURI``.

The transport is used only when constructed explicitly or asked for with
``LIGHTKURVE_TPU_MAST_HTTP=1``.  Every HTTP interaction goes through one
injectable ``opener`` callable; ``mashup_url`` and ``download_url`` point
it at another server (a mirror, or a local one serving recorded tables).
Transient failures (connection errors, HTTP 5xx, unreadable replies) are
retried with a backoff of ``min(2**attempt, 10)`` seconds.  Host code.
"""
from __future__ import annotations

import json
import logging
import os
import time
import urllib.parse
import urllib.request

from .mast import MASTTransport, ResolverError
from .utils import LightkurveError

log = logging.getLogger(__name__)

__all__ = ["HTTPMASTTransport"]

MASHUP_URL = "https://mast.stsci.edu/api/v0/invoke"
DOWNLOAD_URL = "https://mast.stsci.edu/api/v0.1/Download/file"

#: criteria the pipeline may pass that map 1:1 onto CAOM column filters
_FILTER_COLUMNS = ("project", "provenance_name", "obs_collection",
                   "dataproduct_type", "sequence_number", "target_name",
                   "calib_level", "obs_id")


def _default_opener(url, data=None, timeout=60.0):
    """POST (or GET when ``data is None``) and return the response bytes."""
    req = urllib.request.Request(
        url, data=data,
        headers={"User-Agent": "lightkurve-tpu-torch/0.1",
                 "Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


class HTTPMASTTransport(MASTTransport):
    """Query and download from the live MAST archive over HTTPS.

    Parameters
    ----------
    mashup_url, download_url : str
        Endpoint overrides (a mirror, or a local server).
    opener : callable(url, data=None, timeout=float) -> bytes
        Injectable HTTP layer; defaults to urllib.
    timeout : float
        Per-request timeout in seconds.
    max_retries : int
        Retries for transient failures (5xx / connection errors), with
        exponential backoff.  MAST async queries returning ``EXECUTING``
        are polled up to ``poll_limit`` times (reference behavior:
        astroquery polls until ``COMPLETE``).
    """

    def __init__(self, mashup_url=MASHUP_URL, download_url=DOWNLOAD_URL,
                 opener=None, timeout=60.0, max_retries=3, poll_limit=20,
                 pagesize=50_000):
        self.mashup_url = mashup_url
        self.download_url = download_url
        self.opener = opener or _default_opener
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.poll_limit = int(poll_limit)
        self.pagesize = int(pagesize)
        #: transcript of (service, params) calls, mirrors the recorded
        #: transport's ``calls`` for cache-behavior assertions
        self.calls = []

    # -- low-level Mashup invoke -----------------------------------------
    def _invoke(self, service, params):
        """One Mashup service call: URL-encoded JSON request, JSON reply,
        polling while the server reports ``EXECUTING``."""
        self.calls.append((service, dict(params)))
        request = {"service": service, "params": params, "format": "json",
                   "pagesize": self.pagesize, "page": 1,
                   "timeout": int(self.timeout)}
        body = ("request=" + urllib.parse.quote(
            json.dumps(request))).encode()
        last_exc = None
        for attempt in range(self.max_retries):
            try:
                raw = self.opener(self.mashup_url, data=body,
                                  timeout=self.timeout)
                reply = json.loads(raw)
                for _ in range(self.poll_limit):
                    if reply.get("status") != "EXECUTING":
                        break
                    time.sleep(min(2.0 ** attempt, 10.0))
                    raw = self.opener(self.mashup_url, data=body,
                                      timeout=self.timeout)
                    reply = json.loads(raw)
                if reply.get("status") == "ERROR":
                    raise LightkurveError(
                        f"MAST service {service} failed: "
                        f"{reply.get('msg', 'unknown error')}")
                return reply
            except (OSError, ValueError) as exc:
                last_exc = exc
                log.warning("MAST request failed (attempt %d/%d): %s",
                            attempt + 1, self.max_retries, exc)
                time.sleep(min(2.0 ** attempt, 10.0))
        raise LightkurveError(
            f"MAST service {service} unreachable after "
            f"{self.max_retries} attempts: {last_exc}")

    # -- transport protocol -----------------------------------------------
    def resolve_object(self, name):
        reply = self._invoke("Mast.Name.Lookup",
                             {"input": str(name), "format": "json"})
        coords = (reply.get("resolvedCoordinate")
                  or reply.get("data") or [])
        if not coords:
            raise ResolverError(
                f"Could not resolve {name!r} to a sky position.")
        c = coords[0]
        return float(c["ra"]), float(c.get("decl", c.get("dec")))

    def query_criteria(self, **criteria):
        """CAOM observation query with astroquery's field names; returns
        plain dicts the pipeline joins/filters (same contract as
        ``RecordedMASTTransport.query_criteria``)."""
        target_name = criteria.pop("target_name", None)
        objectname = criteria.pop("objectname", None)
        radius_deg = float(criteria.pop("radius_deg", 0.0) or 0.0)

        filters = []
        for key in _FILTER_COLUMNS:
            val = criteria.pop(key, None)
            if val is None:
                continue
            values = [v for v in
                      (val if isinstance(val, (list, tuple)) else [val])]
            filters.append({"paramName": key, "values": values})
        t_exptime = criteria.pop("t_exptime", None)
        if t_exptime is not None:
            if isinstance(t_exptime, (tuple, list)) and len(t_exptime) == 2:
                filters.append({"paramName": "t_exptime",
                                "values": [{"min": float(t_exptime[0]),
                                            "max": float(t_exptime[1])}]})
            else:
                filters.append({"paramName": "t_exptime",
                                "values": [{"min": float(t_exptime),
                                            "max": float(t_exptime)}]})
        if target_name is not None:
            filters.append({"paramName": "target_name",
                            "values": [str(target_name)]})
        for key, val in criteria.items():    # leftover exotic criteria
            if val is None:
                continue
            values = [v for v in
                      (val if isinstance(val, (list, tuple)) else [val])]
            filters.append({"paramName": key, "values": values})

        params = {"columns": "*", "filters": filters}
        if objectname is not None:
            ra, dec = self.resolve_object(objectname)
            params["position"] = f"{ra}, {dec}, {radius_deg}"
            reply = self._invoke("Mast.Caom.Filtered.Position", params)
        else:
            reply = self._invoke("Mast.Caom.Filtered", params)
        rows = [dict(r) for r in reply.get("data", [])]
        if objectname is not None:
            # the Position service returns no separation column; compute
            # it like the recorded transport (arcsec, small-angle)
            import numpy as np
            cosd = np.cos(np.deg2rad(dec))
            for r in rows:
                s_ra, s_dec = r.get("s_ra"), r.get("s_dec")
                if s_ra is None or s_dec is None:
                    continue
                sep = float(np.hypot((float(s_ra) - ra) * cosd,
                                     float(s_dec) - dec))
                r.setdefault("distance", sep * 3600.0)
        return rows

    def get_product_list(self, observations):
        # CAOM products are keyed by the numeric ``obsid`` (astroquery
        # sends a comma-separated list)
        obsids = [str(r.get("obsid")) for r in observations
                  if r.get("obsid") is not None]
        if not obsids:
            return []
        reply = self._invoke("Mast.Caom.Products",
                             {"obsid": ",".join(obsids)})
        products = [dict(p) for p in reply.get("data", [])]
        # re-key to the string obs_id the join expects: parent_obsid
        # links a product to its observation
        by_obsid = {str(r.get("obsid")): r.get("obs_id")
                    for r in observations}
        for p in products:
            parent = str(p.get("parent_obsid", p.get("obsID", "")))
            p.setdefault("obs_id", by_obsid.get(parent))
        return products

    def download_product(self, product, download_dir):
        """Stream one product to ``download_dir`` (reference
        ``search.py:279-518``: cache-dir layout, corrupt-file re-fetch)."""
        uri = product.get("dataURI")
        if not uri:
            raise LightkurveError(
                f"Product {product.get('productFilename')!r} has no "
                "dataURI to download.")
        os.makedirs(download_dir, exist_ok=True)
        fname = product.get("productFilename") or uri.rsplit("/", 1)[-1]
        dest = os.path.join(download_dir, fname)
        if os.path.exists(dest) and os.path.getsize(dest) > 0:
            return dest
        url = (self.download_url + "?uri="
               + urllib.parse.quote(str(uri), safe=""))
        last_exc = None
        for attempt in range(self.max_retries):
            try:
                raw = self.opener(url, data=None, timeout=self.timeout)
                if not raw:
                    raise LightkurveError(f"Empty download for {uri!r}")
                tmp = dest + ".part"
                with open(tmp, "wb") as f:
                    f.write(raw)
                os.replace(tmp, dest)        # atomic: no corrupt cache
                return dest
            except (OSError, LightkurveError) as exc:
                last_exc = exc
                log.warning("Download failed (attempt %d/%d): %s",
                            attempt + 1, self.max_retries, exc)
                time.sleep(min(2.0 ** attempt, 10.0))
        raise LightkurveError(
            f"Could not download {uri!r} after {self.max_retries} "
            f"attempts: {last_exc}")
