"""The port's offline archive search against lightkurve_tpu's: one local
archive of Kepler, K2, TESS (two-minute and 20-s fast) light curves and
TESS and K2 target pixel files, written with the port's FITS writer and
scanned by both packages.

Bars: equal -- the table rows in the same order for every filter
(mission, author, numeric and string exptime, ``cadence=``, sector,
quarter, campaign, limit), the ``repr`` with extra columns, indexing,
column accessors and ``unique_targets``; ``download``/``download_all``
give the same classes and bit-equal fluxes and times.  Every test points
``HOME``, ``XDG_*`` and ``LIGHTKURVE_CACHE_DIR`` into ``tmp_path``.
"""
import warnings

import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import config as jconfig
from lightkurve_tpu import search as jsearch
from lightkurve_tpu_torch import config as tconfig
from lightkurve_tpu_torch import search as tsearch
from test_torch_io_read import write_spoc
from test_torch_tpf import write_port_tpf

TIC_A, TIC_B, KIC, EPIC = 261136679, 12345678, 11904151, 201367065

#: (file name without ".fits", mission of the writer)
ARCHIVE = [
    (f"tess2018206045859-s0001-{TIC_A:016d}-0120-s_lc", "TESS"),
    (f"tess2018234235059-s0002-{TIC_A:016d}-0121-s_lc", "TESS"),
    (f"tess2019140104343-s0013-{TIC_A:016d}-0144-s_lc", "TESS"),
    (f"tess2020186164531-s0027-{TIC_A:016d}-0189-a_fast-lc", "TESS"),
    (f"tess2019169103026-s0012-{TIC_B:016d}-0144-s_lc", "TESS"),
    (f"kplr{KIC:09d}-2009350155506_llc", "Kepler"),
    (f"kplr{KIC:09d}-2010009091648_slc", "Kepler"),
    (f"ktwo{EPIC:09d}-c01_llc", "Kepler"),
]
TPFS = [(f"tess2018206045859-s0001-{TIC_A:016d}-0120-s_tp", "TESS"),
        (f"ktwo{EPIC:09d}-c102_lpd-targ", "Kepler")]


@pytest.fixture
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg_config"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg_cache"))
    monkeypatch.setenv("LIGHTKURVE_CACHE_DIR", str(tmp_path / "cache"))
    for var in ("LIGHTKURVE_TPU_ARCHIVE", "LIGHTKURVE_TPU_MAST_FIXTURES",
                "LIGHTKURVE_TPU_MAST_HTTP"):
        monkeypatch.delenv(var, raising=False)
    for conf in (jconfig.conf, tconfig.conf):
        monkeypatch.setattr(conf, "cache_dir", None)
        monkeypatch.setattr(conf, "search_result_display_extra_columns", [])
    monkeypatch.setattr(tconfig, "default_device", "cpu")
    monkeypatch.setattr(tconfig, "default_dtype", torch.float64)
    return tmp_path


@pytest.fixture
def archive(env):
    directory = env / "archive"
    directory.mkdir()
    rng = np.random.default_rng(4)
    for name, mission in ARCHIVE:
        write_spoc(directory, rng, name, mission)
    for i, (name, mission) in enumerate(TPFS):
        write_port_tpf(directory / f"{name}.fits", mission, seed=i)
    return str(directory)


def rows(result):
    return [{k: v for k, v in r.items() if k != "_transport"}
            for r in result.table]


def both(fn_name, *args, **kwargs):
    """The same search through both packages: (reference, port) results,
    or the SearchError both raise."""
    out = []
    for mod in (jsearch, tsearch):
        try:
            out.append(getattr(mod, fn_name)(*args, **kwargs))
        except mod.SearchError as e:
            out.append(e)
    return out


FILTERS = [
    {}, {"mission": "TESS"}, {"mission": "Kepler"}, {"mission": "K2"},
    {"mission": ("Kepler", "K2")}, {"author": "SPOC"},
    {"author": ["Kepler", "K2"]}, {"exptime": 120}, {"exptime": 20.0},
    {"exptime": 1800}, {"exptime": "fast"}, {"exptime": "short"},
    {"exptime": "long"}, {"cadence": "long"}, {"cadence": "short"},
    {"sector": 2}, {"sector": [1, 13]}, {"quarter": 3}, {"campaign": 1},
    {"limit": 2}, {"mission": "TESS", "exptime": 120, "limit": 2},
]


@pytest.mark.parametrize("target", [f"TIC {TIC_A}", str(TIC_B),
                                    f"KIC {KIC}", f"EPIC {EPIC}"])
@pytest.mark.parametrize("kw", FILTERS, ids=[str(f) for f in FILTERS])
def test_lightcurve_rows_equal(archive, target, kw):
    ref, port = both("search_lightcurve", target, archive_dir=archive, **kw)
    if isinstance(ref, Exception):
        assert isinstance(port, tsearch.SearchError)
        assert str(port).split(".")[0] == str(ref).split(".")[0]
        return
    assert rows(port) == rows(ref) and len(port) > 0


@pytest.mark.parametrize("kw", [{}, {"mission": "K2"}, {"sector": 1},
                                {"exptime": 1800}])
def test_targetpixelfile_rows_equal(archive, kw):
    for target in (f"TIC {TIC_A}", f"EPIC {EPIC}"):
        ref, port = both("search_targetpixelfile", target,
                         archive_dir=archive, **kw)
        if isinstance(ref, Exception):
            assert isinstance(port, tsearch.SearchError)
        else:
            assert rows(port) == rows(ref)


def test_result_api_equal(archive, monkeypatch):
    ref, port = both("search_lightcurve", f"TIC {TIC_A}",
                     archive_dir=archive)
    assert repr(port) == repr(ref)
    for conf in (jconfig.conf, tconfig.conf):
        monkeypatch.setattr(conf, "search_result_display_extra_columns",
                            ["sequence_number", "nonexistent"])
    ref, port = both("search_lightcurve", f"TIC {TIC_A}",
                     archive_dir=archive)
    assert "sequence_number" in repr(port) and repr(port) == repr(ref)
    for key in (0, -1, slice(1, 3), np.array([True, False, True, False]),
                np.array([3, 0])):
        assert rows(port[key]) == rows(ref[key])
    for col in ("mission", "author", "target_name", "year", "filename",
                "ra", "dec"):
        np.testing.assert_array_equal(getattr(port, col),
                                      getattr(ref, col), col)
    for col in ("exptime", "distance"):
        np.testing.assert_array_equal(getattr(port, col).value,
                                      getattr(ref, col).value, col)
        assert str(getattr(port, col).unit) == str(getattr(ref, col).unit)
    ut, uj = port.unique_targets, ref.unique_targets
    assert ut.keys() == uj.keys()
    for k in ut:
        np.testing.assert_array_equal(ut[k], uj[k], k)


def assert_same_data(a, b):
    assert type(a).__name__ == type(b).__name__
    for col in ("time", "flux", "flux_err"):
        np.testing.assert_array_equal(np.asarray(getattr(a, col).value),
                                      np.asarray(getattr(b, col).value), col)


@pytest.mark.parametrize("target,kw", [
    (f"TIC {TIC_A}", {}), (f"KIC {KIC}", {"quality_bitmask": "none"}),
    (f"TIC {TIC_A}", {"flux_column": "sap_flux"})])
def test_download_equal(archive, target, kw):
    ref, port = both("search_lightcurve", target, archive_dir=archive)
    assert_same_data(port.download(**kw), ref.download(**kw))
    cp, cj = port.download_all(**kw), ref.download_all(**kw)
    assert type(cp).__name__ == type(cj).__name__ == "LightCurveCollection"
    assert len(cp) == len(cj) == len(port)
    for a, b in zip(cp, cj):
        assert_same_data(a, b)
    assert_same_data(cp.stitch(), cj.stitch())


def test_download_tpfs_equal(archive):
    ref, port = both("search_targetpixelfile", f"TIC {TIC_A}",
                     archive_dir=archive)
    cp, cj = port.download_all(), ref.download_all()
    assert type(cp).__name__ == "TargetPixelFileCollection"
    for a, b in zip(cp, cj):
        assert type(a).__name__ == type(b).__name__
        np.testing.assert_array_equal(np.asarray(a.flux.value),
                                      np.asarray(b.flux.value))


def test_empty_and_missing(archive):
    for mod in (tsearch, jsearch):
        empty = mod.SearchResult([])
        assert len(empty) == 0 and "0 data products" in repr(empty)
        for call in (empty.download, empty.download_all):
            with pytest.warns(mod.LightkurveWarning, match="empty search"):
                assert call() is None
    ref, port = both("search_lightcurve", "TIC 999", archive_dir=archive)
    assert isinstance(ref, jsearch.SearchError)
    assert isinstance(port, tsearch.SearchError)
    assert "No local data products" in str(port) and "network" in str(port)
    with pytest.raises(tsearch.SearchError, match="network"):
        tsearch.search_tesscut("pi Men")


def test_search_lightcurvefile_warns(archive):
    with pytest.warns(tlk.LightkurveDeprecationWarning, match="deprecated"):
        port = tlk.search_lightcurvefile(f"TIC {TIC_A}", archive_dir=archive)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jlk.search_lightcurvefile(f"TIC {TIC_A}", archive_dir=archive)
    assert rows(port) == rows(ref)


def test_search_neighbors(archive):
    t = np.arange(5.0)
    out = []
    for mod in (jlk, tlk):
        lc = mod.LightCurve(time=t, flux=np.ones(5))
        lc.meta["TARGETID"] = TIC_A
        out.append(lc.search_neighbors(limit=1, archive_dir=archive))
    assert isinstance(out[1], tsearch.SearchResult)
    assert rows(out[1]) == rows(out[0]) and len(out[1]) == 2


def test_archive_from_environment(archive, monkeypatch):
    monkeypatch.setenv("LIGHTKURVE_TPU_ARCHIVE", archive)
    ref, port = both("search_lightcurve", str(TIC_B))
    assert rows(port) == rows(ref) and len(port) == 1
