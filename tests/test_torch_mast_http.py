"""lightkurve_tpu_torch's HTTP MAST transport against a recorded Mashup
server.

Every case of ``tests/test_mast_http.py``, run against the port: its
``MockMashup`` (MAST's Mashup/invoke protocol over the recorded
observation and product tables, imported with ``_fixture_data``) answers
the port's ``HTTPMASTTransport`` through the injected opener, and one case
drives the port's default ``urllib`` opener against a real ``http.server``
on 127.0.0.1.  Then the JAX transport and the port's on the same recorded
exchange: the same requests, equal rows and equal downloads.  Tests that
inject failures patch ``time.sleep`` (the backoff sleeps
``min(2**attempt, 10)`` seconds).
"""
import http.server
import json
import threading
import urllib.parse

import pytest

from lightkurve_tpu import mast as jmast
from lightkurve_tpu.mast_http import HTTPMASTTransport as JHTTPMASTTransport
from lightkurve_tpu_torch import mast_http as tmast_http
from lightkurve_tpu_torch.mast import (RecordedMASTTransport, ResolverError,
                                       default_transport, query_mast,
                                       search_products_mast)
from lightkurve_tpu_torch.mast_http import HTTPMASTTransport
from lightkurve_tpu_torch.utils import LightkurveError
from test_mast_http import MockMashup, _fixture_data

FITS_BYTES = b"SIMPLE fake fits bytes"


def _http_transport(mock, cls=HTTPMASTTransport, **kw):
    return cls(mashup_url="https://mock.mast/invoke",
               download_url="https://mock.download/file",
               opener=mock, max_retries=3, **kw)


@pytest.fixture
def mock():
    obs, prod, res = _fixture_data()
    return MockMashup(obs, prod, res,
                      file_bytes={"tess-s0001-273985862-0120-s_lc.fits":
                                  FITS_BYTES})


def test_exact_kepler_name_query(mock):
    t = _http_transport(mock)
    rows = search_products_mast("KIC 11904151", t, filetype="Lightcurve")
    assert len(rows) == 2
    assert {r["mission"] for r in rows} == {"Kepler Quarter 02",
                                            "Kepler Quarter 11"}
    # exact-name query must not hit the resolver
    assert all("Name.Lookup" not in (c[0] or "") for c in t.calls)


def test_quarter_filter_through_http(mock):
    t = _http_transport(mock)
    rows = search_products_mast("KIC 11904151", t, filetype="Lightcurve",
                                quarter=2)
    assert len(rows) == 1 and rows[0]["mission"] == "Kepler Quarter 02"
    rows11 = search_products_mast("KIC 11904151", t,
                                  filetype="Lightcurve", quarter=11)
    assert len(rows11) == 1 and rows11[0]["mission"] == "Kepler Quarter 11"


def test_cone_search_orders_by_distance(mock):
    t = _http_transport(mock)
    rows = search_products_mast("Kepler-10", t, filetype="Target Pixel",
                                radius=3600.0)
    assert len(rows) == 2
    rows = search_products_mast("TIC 273985862", t, radius=100.0,
                                filetype="Lightcurve", mission="TESS")
    assert [r["target_name"] for r in rows] == [
        "273985862", "273985862", "273985863"]
    assert rows[0]["distance"] <= rows[-1]["distance"]


def test_sector_and_exptime_filter(mock):
    t = _http_transport(mock)
    rows = search_products_mast("TIC 273985862", t, filetype="Lightcurve",
                                mission="TESS", sector=2)
    assert len(rows) == 1 and rows[0]["mission"] == "TESS Sector 02"
    rows = search_products_mast("TIC 273985862", t, filetype="Lightcurve",
                                mission="TESS", exptime="fast")
    assert rows == []


def test_equivalence_with_recorded_transport(mock):
    """The port's HTTP client through the mock server returns the same
    filtered product set as the port's RecordedMASTTransport on the same
    tables."""
    obs, prod, resolver = _fixture_data()
    rec = RecordedMASTTransport({
        "resolver": {k: list(v) for k, v in resolver.items()},
        "observations": obs,
        "products": [{k: v for k, v in p.items() if k != "_bytes_key"}
                     for p in prod]})
    http = _http_transport(mock)
    for kwargs in ({"filetype": "Lightcurve"},
                   {"filetype": "Target Pixel"},
                   {"filetype": "Lightcurve", "quarter": 11}):
        a = search_products_mast("KIC 11904151", rec, **kwargs)
        b = search_products_mast("KIC 11904151", http, **kwargs)
        assert [r["productFilename"] for r in a] == \
            [r["productFilename"] for r in b]
        assert [r["mission"] for r in a] == [r["mission"] for r in b]


def test_resolver_error(mock):
    t = _http_transport(mock)
    with pytest.raises(ResolverError):
        t.resolve_object("definitely not a star")


def test_download_product(mock, tmp_path):
    t = _http_transport(mock)
    rows = search_products_mast("TIC 273985862", t, filetype="Lightcurve",
                                mission="TESS", sector=1)
    path = t.download_product(rows[0], str(tmp_path))
    assert path.endswith("tess-s0001-273985862-0120-s_lc.fits")
    assert open(path, "rb").read() == FITS_BYTES
    assert not (tmp_path / (path.rsplit("/", 1)[-1] + ".part")).exists()
    # cached: a second call returns without fetching again
    n_req = len(mock.requests)
    assert t.download_product(rows[0], str(tmp_path)) == path
    assert len(mock.requests) == n_req


def test_download_missing_uri_raises(mock, tmp_path):
    t = _http_transport(mock)
    with pytest.raises(LightkurveError):
        t.download_product({"productFilename": "x.fits"}, str(tmp_path))


def test_retry_on_transient_failure(mock, monkeypatch):
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    mock.fail_first = 2            # first two requests die, third works
    t = _http_transport(mock)
    obs = query_mast("KIC 11904151", t)
    assert len(obs) == 2
    assert slept == [1.0, 2.0]     # min(2**attempt, 10) after each failure


def test_executing_poll(mock, monkeypatch):
    mock.executing_polls = 2       # server says EXECUTING twice
    monkeypatch.setattr("time.sleep", lambda s: None)
    t = _http_transport(mock)
    obs = query_mast("KIC 11904151", t)
    assert len(obs) == 2


def test_unreachable_raises_after_retries(mock, monkeypatch):
    mock.fail_first = 99
    monkeypatch.setattr("time.sleep", lambda s: None)
    t = _http_transport(mock)
    with pytest.raises(LightkurveError, match="unreachable"):
        t.resolve_object("Kepler-10")
    assert len(mock.requests) == 3


def _serve(mashup, files=None, fail=()):
    """A local ``http.server`` speaking the Mashup protocol (POST) and the
    download route (GET ``?uri=``); requests whose ordinal is in ``fail``
    get a 503.  Returns (server, thread, URLs)."""
    count = [0]

    class Handler(http.server.BaseHTTPRequestHandler):
        def _reply(self, payload):
            count[0] += 1
            if count[0] in fail:
                self.send_error(503, "busy")
                return
            self.send_response(200)
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            self._reply(mashup("https://mock.mast/invoke", data=body))

        def do_GET(self):
            uri = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)["uri"][0]
            self._reply(files[uri.rsplit("/", 1)[-1]])

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    return srv, thread, (base + "/invoke", base + "/download/file")


def test_default_opener_against_localhost(tmp_path, monkeypatch):
    """urllib default opener end-to-end against a real local HTTP server
    speaking the Mashup protocol, a 503 on the first query and on the
    first download retried (no external traffic)."""
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    obs, prod, res = _fixture_data()
    name = "tess-s0001-273985862-0120-s_lc.fits"
    srv, thread, (mashup_url, download_url) = _serve(
        MockMashup(obs, prod, res), files={name: FITS_BYTES}, fail=(1, 4))
    try:
        t = HTTPMASTTransport(mashup_url=mashup_url,
                              download_url=download_url)
        assert t.opener is tmast_http._default_opener
        rows = search_products_mast("KIC 11904151", t,
                                    filetype="Lightcurve")
        assert {r["mission"] for r in rows} == {"Kepler Quarter 02",
                                                "Kepler Quarter 11"}
        rows = search_products_mast("TIC 273985862", t,
                                    filetype="Lightcurve", mission="TESS",
                                    sector=1)
        path = t.download_product(rows[0], str(tmp_path))
        assert open(path, "rb").read() == FITS_BYTES
        assert slept == [1.0, 1.0]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


def test_env_gate(monkeypatch):
    """LIGHTKURVE_TPU_MAST_HTTP=1 switches default_transport to the HTTP
    client; unset leaves it None (the local archive scan)."""
    monkeypatch.delenv("LIGHTKURVE_TPU_MAST_FIXTURES", raising=False)
    monkeypatch.delenv("LIGHTKURVE_TPU_MAST_HTTP", raising=False)
    assert default_transport() is None
    monkeypatch.setenv("LIGHTKURVE_TPU_MAST_HTTP", "1")
    assert isinstance(default_transport(), HTTPMASTTransport)


def public(rows):
    """The rows as JSON text, without the private ``_transport`` key."""
    return json.dumps([{k: v for k, v in r.items() if not k.startswith("_")}
                       for r in rows], sort_keys=True)


@pytest.mark.parametrize("query", [
    dict(target="KIC 11904151", filetype="Lightcurve"),
    dict(target="KIC 11904151", filetype="Target Pixel", quarter=11),
    dict(target="Kepler-10", filetype="Target Pixel", radius=3600.0),
    dict(target="TIC 273985862", filetype="Lightcurve", mission="TESS",
         radius=100.0),
])
def test_jax_and_port_transports_on_one_exchange(query, tmp_path):
    """The JAX package's transport and the port's, each against its own
    copy of the same recorded server: the same Mashup requests in the same
    order, equal rows through each package's pipeline, equal downloads."""
    obs, prod, res = _fixture_data()
    files = {"tess-s0001-273985862-0120-s_lc.fits": FITS_BYTES}
    mocks = [MockMashup(obs, prod, res, file_bytes=files) for _ in range(2)]
    target = query.pop("target")
    jt = _http_transport(mocks[0], cls=JHTTPMASTTransport)
    tt = _http_transport(mocks[1])
    want = jmast.search_products_mast(target, jt, **query)
    got = search_products_mast(target, tt, **query)
    assert want and public(got) == public(want)
    assert tt.calls == jt.calls
    assert mocks[1].requests == mocks[0].requests
    for row_t, row_j in zip(got, want):
        if row_t["productFilename"] in files:
            a = tt.download_product(row_t, str(tmp_path / "port"))
            b = jt.download_product(row_j, str(tmp_path / "jax"))
            assert open(a, "rb").read() == open(b, "rb").read()


def test_underfit_metric_fetches_neighbours_over_http(tmp_path, monkeypatch):
    """The under-fitting metric without ``neighbor_flux`` through each
    package's HTTP transport, the recorded server holding the target's 32
    neighbours (``test_torch_cbv``'s files), each package downloading into
    a cache of its own: equal neighbours, equal metric, and the files
    fetched are the cone search's (the target's own among them)."""
    import numpy as np
    import torch
    import lightkurve_tpu as jlk
    import lightkurve_tpu_torch as tlk
    from lightkurve_tpu.correctors import metrics as jmetrics
    from lightkurve_tpu_torch import config
    from lightkurve_tpu_torch.correctors import metrics as tmetrics
    from test_torch_cbv import (neighbour_archive, tess_vectors,
                                write_lc, write_tess_cbvs)
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)
    for var in ("HOME", "XDG_CACHE_HOME", "XDG_CONFIG_HOME",
                "LIGHTKURVE_CACHE_DIR"):
        monkeypatch.setenv(var, str(tmp_path / var.lower()))
    for conf in (jlk.conf, tlk.conf):
        monkeypatch.setattr(conf, "cache_dir", None)
    (tmp_path / "archive").mkdir()
    fixture = neighbour_archive(str(tmp_path / "archive"))
    target = write_lc(str(tmp_path / "target.fits"), "TESS", tess_vectors(),
                      1, SECTOR=10, CAMERA=2, CCD=4)
    cbv_dir = write_tess_cbvs(str(tmp_path / "cbv"))
    obs, prods, files = [], [], {}
    for i, (o, p) in enumerate(zip(fixture["observations"],
                                   fixture["products"])):
        obs.append(dict(o, obsid=5000 + i, obs_collection="TESS"))
        prods.append({k: v for k, v in p.items() if k != "local_path"}
                     | {"parent_obsid": 5000 + i})
        if p["local_path"].endswith("-0000000000001234-0195-s_lc.fits"):
            p = dict(p, local_path=target)
        files[p["productFilename"]] = open(p["local_path"], "rb").read()
    resolver = {k: tuple(v) for k, v in fixture["resolver"].items()}
    got = []
    for pkg, metrics, cls in ((jlk, jmetrics, JHTTPMASTTransport),
                              (tlk, tmetrics, HTTPMASTTransport)):
        mock = MockMashup(obs, prods, resolver, file_bytes=files)
        monkeypatch.setenv("LIGHTKURVE_CACHE_DIR",
                           str(tmp_path / f"cache_{pkg.__name__}"))
        corrector = pkg.read(target, flux_column="sap_flux").to_corrector(
            "cbv", cbv_dir=cbv_dir)
        corrector.correct_gaussian_prior(cbv_type=["SingleScale"],
                                         cbv_indices=["ALL"], alpha=1e-3)
        transport = _http_transport(mock, cls=cls)
        got.append((metrics.underfit_metric_neighbors(
            corrector.corrected_lc, radius=5000, transport=transport),
            metrics._download_and_preprocess_neighbors(
                corrector.corrected_lc, radius=5000, transport=transport),
            sorted(urllib.parse.parse_qs(urllib.parse.urlparse(u).query)
                   ["uri"][0].rsplit("/", 1)[-1]
                   for u, d in mock.requests if d is None)))
    (jm, jn, jfiles), (tm, tn, tfiles) = got
    np.testing.assert_allclose(tm, jm, rtol=1e-10)
    assert len(tn) == len(jn) == 32
    for a, b in zip(tn, jn):
        np.testing.assert_array_equal(a, b)
    assert tfiles == jfiles == sorted(files)
