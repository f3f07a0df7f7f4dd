"""The port's MAST pipeline against lightkurve_tpu's on the recorded
fixture of ``tests/test_mast_pipeline.py`` (its ``_build_fixture``,
imported): ``query_mast``, ``filter_products`` (the Kepler quarter and
month masks included) and ``search_products_mast`` give equal rows;
``search_lightcurve``/``search_targetpixelfile`` through a transport and
their downloads; ``default_transport`` under both environment variables
(the live HTTP client of each package, its opener replaced by
``test_mast_http``'s recorded Mashup server);
``search_tesscut`` → ``download(cutout_size=…)`` gives the reference's
cube and WCS.  Bars: equal.
"""
import copy
import json

import numpy as np
import pytest
import torch

from lightkurve_tpu import config as jconfig
from lightkurve_tpu import mast as jmast
from lightkurve_tpu import mast_http as jmast_http
from lightkurve_tpu import search as jsearch
from lightkurve_tpu_torch import config as tconfig
from lightkurve_tpu_torch import mast as tmast
from lightkurve_tpu_torch import mast_http as tmast_http
from lightkurve_tpu_torch import search as tsearch
from test_mast_http import MockMashup, _fixture_data
from test_mast_pipeline import _build_fixture


@pytest.fixture
def fixture(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg_config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg_cache"))
    monkeypatch.setenv("LIGHTKURVE_CACHE_DIR", str(tmp_path / "cache"))
    for var in ("LIGHTKURVE_TPU_ARCHIVE", "LIGHTKURVE_TPU_MAST_FIXTURES",
                "LIGHTKURVE_TPU_MAST_HTTP"):
        monkeypatch.delenv(var, raising=False)
    for conf in (jconfig.conf, tconfig.conf):
        monkeypatch.setattr(conf, "cache_dir", None)
    monkeypatch.setattr(tconfig, "default_device", "cpu")
    monkeypatch.setattr(tconfig, "default_dtype", torch.float64)
    return _build_fixture(tmp_path)


@pytest.fixture
def transports(fixture):
    return (jmast.RecordedMASTTransport(copy.deepcopy(fixture)),
            tmast.RecordedMASTTransport(copy.deepcopy(fixture)))


def strip(rows):
    return [{k: v for k, v in r.items() if k != "_transport"} for r in rows]


QUERIES = [
    ("kplr011904151", {}), ("KIC 11904151", {"project": "Kepler"}),
    ("KIC 4914423", {"exptime": 60}), ("TIC 273985862", {}),
    ("TIC 273985862", {"radius": 60.0}), ("Kepler-10", {}),
    ("pi Mensae", {"radius": 30.0}), ("tic 74534430", {}),
    ("EPIC 228162462", {"sequence_number": 9}),
    ("TrES-2b", {"provenance_name": ["QLP", "TESS-SPOC"]}),
    ("KIC 8462852", {"project": "TESS"}),
    ("19:02:43.1 +50:14:28.7", {"radius": 10.0}),
]


@pytest.mark.parametrize("target,kw", QUERIES,
                         ids=[f"{t}-{k}" for t, k in QUERIES])
def test_query_mast_equal(transports, target, kw):
    jt, tt = transports
    assert tmast.query_mast(target, tt, **kw) == \
        jmast.query_mast(target, jt, **kw)


def test_unresolvable_name_raises_search_error(transports):
    jt, tt = transports
    with pytest.raises(jsearch.SearchError):
        jmast.query_mast("not a star", jt)
    with pytest.raises(tsearch.SearchError):
        tmast.query_mast("not a star", tt)


PRODUCTS = [
    ("KIC 11904151", dict(filetype="Lightcurve")),
    ("KIC 11904151", dict(filetype="Target Pixel", quarter=[3, 11])),
    ("KIC 11904151", dict(filetype="Lightcurve", quarter=11,
                          exptime="short")),
    ("KIC 4914423", dict(filetype="Lightcurve", quarter=6, month=[1, 3])),
    ("KIC 4914423", dict(filetype="Target Pixel", month=2)),
    ("TIC 273985862", dict(filetype="Lightcurve", radius=60.0)),
    ("TIC 273985862", dict(filetype="Lightcurve", sector=2)),
    ("EPIC 202975993", dict(filetype="Lightcurve", campaign=11)),
    ("TrES-2b", dict(filetype="Lightcurve", provenance_name="any",
                     exptime="long")),
    ("Kepler-10", dict(filetype="Lightcurve", limit=3)),
    (74534430, dict(filetype="Lightcurve")),
    (261136679, dict(filetype="Target Pixel")),
    ("pi Mensae", dict(filetype="FFI")),
    ("pi Mensae", dict(filetype="FFI", sector=2)),
]


@pytest.mark.parametrize("target,kw", PRODUCTS,
                         ids=[f"{t}-{k}" for t, k in PRODUCTS])
def test_search_products_mast_equal(transports, target, kw):
    jt, tt = transports
    want = jmast.search_products_mast(target, jt, **kw)
    got = tmast.search_products_mast(target, tt, **kw)
    assert strip(got) == strip(want) and len(got) > 0
    assert all(r["_transport"] is tt for r in got)
    assert tt.calls == jt.calls


@pytest.mark.parametrize("kw", [dict(quarter=6), dict(quarter=6, month=1),
                                dict(quarter=6, month=[2, 3]),
                                dict(exptime="short"), dict(exptime=1800),
                                dict(filetype="Lightcurve", limit=2),
                                dict(provenance_name=["K2"]),
                                dict(campaign=6)])
def test_filter_products_masks_equal(fixture, kw):
    """``filter_products`` over the joined rows of every observation:
    the Kepler quarter and month masks, exptime, limit and provenance."""
    by_obs = {o["obs_id"]: o for o in fixture["observations"]}
    joined = []
    for p in fixture["products"]:
        row = dict(by_obs[p["obs_id"]])
        row.update(p)
        row["exptime"] = row.get("t_exptime")
        joined.append(row)
    kw = dict({"filetype": "Target Pixel"}, **kw)
    want = jmast.filter_products(copy.deepcopy(joined), **kw)
    got = tmast.filter_products(copy.deepcopy(joined), **kw)
    assert got == want
    assert tmast._synthesize_mission_column(copy.deepcopy(joined)) == \
        jmast._synthesize_mission_column(copy.deepcopy(joined))


@pytest.mark.parametrize("fn,target,kw", [
    ("search_lightcurve", "KIC 11904151", dict(quarter=[1, 2])),
    ("search_lightcurve", "TIC 273985862", dict(author="SPOC")),
    ("search_lightcurve", "TIC 273985862", dict(cadence="short")),
    ("search_targetpixelfile", "KIC 4914423", dict(quarter=6, month=2)),
    ("search_lightcurve", "TrES-2b", dict(author=["QLP", "TESS-SPOC"])),
])
def test_search_through_transport_equal(transports, fn, target, kw):
    jt, tt = transports
    want = getattr(jsearch, fn)(target, transport=jt, **kw)
    got = getattr(tsearch, fn)(target, transport=tt, **kw)
    assert strip(got.table) == strip(want.table) and len(got) > 0
    assert repr(got) == repr(want)


def test_download_through_transport_equal(transports, tmp_path):
    jt, tt = transports
    got = tsearch.search_lightcurve("TIC 273985862", sector=1, author="SPOC",
                                    transport=tt)
    want = jsearch.search_lightcurve("TIC 273985862", sector=1,
                                     author="SPOC", transport=jt)
    a = got.download(download_dir=str(tmp_path / "port"))
    b = want.download(download_dir=str(tmp_path / "ref"))
    assert type(a).__name__ == type(b).__name__ == "TessLightCurve"
    for col in ("time", "flux", "flux_err"):
        np.testing.assert_array_equal(np.asarray(getattr(a, col).value),
                                      np.asarray(getattr(b, col).value))
    assert (tmp_path / "port" / got.table[0]["productFilename"]).exists()
    coll = got.download_all()        # into the cache directory
    assert len(coll) == 1 and (tmp_path / "cache" /
                               got.table[0]["productFilename"]).exists()


def test_default_transport_from_environment(fixture, tmp_path, monkeypatch):
    assert tmast.default_transport() is None is jmast.default_transport()
    path = tmp_path / "mast_fixtures.json"
    path.write_text(json.dumps(fixture))
    monkeypatch.setenv("LIGHTKURVE_TPU_MAST_FIXTURES", str(path))
    tt, jt = tmast.default_transport(), jmast.default_transport()
    assert isinstance(tt, tmast.RecordedMASTTransport)
    assert (tt.observations, tt.products, tt.ffi_sectors) == \
        (jt.observations, jt.products, jt.ffi_sectors)
    got = tsearch.search_lightcurve("KIC 11904151", quarter=3)
    want = jsearch.search_lightcurve("KIC 11904151", quarter=3)
    assert strip(got.table) == strip(want.table) and len(got) == 1
    monkeypatch.delenv("LIGHTKURVE_TPU_MAST_FIXTURES")
    monkeypatch.setenv("LIGHTKURVE_TPU_MAST_HTTP", "1")
    tt, jt = tmast.default_transport(), jmast.default_transport()
    assert isinstance(tt, tmast_http.HTTPMASTTransport)
    assert isinstance(jt, jmast_http.HTTPMASTTransport)
    keys = ("mashup_url", "download_url", "timeout", "max_retries",
            "poll_limit", "pagesize")
    assert [getattr(tt, k) for k in keys] == [getattr(jt, k) for k in keys]
    assert tt.mashup_url == tmast_http.MASHUP_URL == jmast_http.MASHUP_URL
    # the ambient client's default opener answered by the recorded Mashup
    # server, so the search runs the whole HTTP chain with no network
    for mod in (jmast_http, tmast_http):
        monkeypatch.setattr(mod, "_default_opener",
                            MockMashup(*_fixture_data()))
    got = tsearch.search_lightcurve("KIC 11904151", quarter=2)
    want = jsearch.search_lightcurve("KIC 11904151", quarter=2)
    assert strip(got.table) == strip(want.table) and len(got) == 1


@pytest.mark.parametrize("size", [5, 7, (9, 5)])
def test_tesscut_cutout_equal(transports, size):
    jt, tt = transports
    got = tsearch.search_tesscut("pi Mensae", sector=1, transport=tt)
    want = jsearch.search_tesscut("pi Mensae", sector=1, transport=jt)
    assert strip(got.table) == strip(want.table) and repr(got) == repr(want)
    a, b = got.download(cutout_size=size), want.download(cutout_size=size)
    assert type(a).__name__ == type(b).__name__ == "TessTargetPixelFile"
    for k in b._columns:
        np.testing.assert_array_equal(a._columns[k], b._columns[k], k)
    assert dict(a._ext_header) == dict(b._ext_header) and a.meta == b.meta
    for attr in ("crpix", "crval", "cd"):
        np.testing.assert_array_equal(getattr(a.wcs, attr),
                                      getattr(b.wcs, attr))
    coll = got.download_all(cutout_size=size)
    assert type(coll).__name__ == "TargetPixelFileCollection"
    with pytest.raises(tsearch.SearchError, match="FFI stack"):
        tsearch.search_tesscut("pi Mensae", sector=2,
                               transport=tt).download()
