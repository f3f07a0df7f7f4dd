"""lightkurve_tpu_torch's solar-system-object query against recorded SkyBot
responses.

Every case of ``tests/test_sso.py`` (its recorded texts, imported) run
against the port, each also against the JAX package on the same input:
the URLs asked for, and the frames returned, are equal.  Under the tensor
trap (``torch.Tensor.__array__`` raises).
"""
import json

import numpy as np
import pandas as pd
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu.utils import _query_solar_system_objects as jquery
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch.utils import _query_solar_system_objects as tquery
from test_sso import (SKYBOT_EMPTY, SKYBOT_ERROR, SKYBOT_ONE_OBJECT,
                      _fetch_factory)


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


@pytest.fixture(autouse=True)
def tensor_trap(monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor reached numpy without .cpu()")
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)


def asteroid_lcs(n=3):
    out = []
    for pkg in (jlk, tlk):
        lc = pkg.LightCurve(time=2458400.5 + np.arange(n) * 0.02,
                            flux=np.ones(n), flux_err=np.full(n, 1e-3))
        lc.meta.update(RA=84.2, DEC=-72.2, MISSION="TESS", TIMEFMT="jd")
        out.append(lc)
    return out


def assert_frames_equal(got, want):
    if want is None:
        assert got is None
        return
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


def test_sso_pipeline_single_object():
    """One asteroid at one epoch: parsed Num/Name/Class/Mv/epoch row."""
    seen = []
    fetch = _fetch_factory({"EPOCH=": SKYBOT_ONE_OBJECT}, seen)
    df = tquery(84.2, -72.2, [2458432.1], location="tess", fetch=fetch)
    assert len(df) == 1
    assert df.Name.iloc[0].strip() == "2000 VJ61"
    assert df.Class.iloc[0].strip() == "MB>Outer"
    assert float(df.Mv.iloc[0]) == pytest.approx(16.6)
    assert float(df.epoch.iloc[0]) == 2458432.1
    assert "-loc=C57" in seen[0]
    tquery(84.2, -72.2, [2458432.1], location="kepler",
           fetch=_fetch_factory({"EPOCH=": SKYBOT_ONE_OBJECT}, seen))
    assert "-loc=C55" in seen[-1]
    jseen = []
    want = jquery(84.2, -72.2, [2458432.1], location="tess",
                  fetch=_fetch_factory({"EPOCH=": SKYBOT_ONE_OBJECT}, jseen))
    assert_frames_equal(df, want)
    assert jseen == seen[:1]


def test_sso_error_flag_raises():
    for query in (jquery, tquery):
        with pytest.raises(IOError, match="SkyBot"):
            query(84.2, -72.2, [2458432.1], location="tess",
                  fetch=_fetch_factory({"EPOCH=": SKYBOT_ERROR}, []))


def test_sso_empty_returns_none():
    for query in (jquery, tquery):
        assert query(84.2, -72.2, [2458432.1], location="tess",
                     fetch=_fetch_factory({}, [])) is None
    assert tquery(84.2, -72.2, [2458432.1], location="tess",
                  fetch=lambda url: SKYBOT_EMPTY) is None


def test_lc_query_sso_all_mask_forms():
    """Every accepted cadence_mask form yields the single recorded
    object, in both packages."""
    jl, tl = asteroid_lcs(n=1)
    epoch = float(np.asarray(tl.time.jd)[0])
    responses = {f"EPOCH={epoch}": SKYBOT_ONE_OBJECT}
    for cm in ("all", np.asarray([True]), [True], True):
        seen = [[], []]
        want = jl.query_solar_system_objects(
            cadence_mask=cm, cache=False,
            fetch=_fetch_factory(responses, seen[0]))
        got = tl.query_solar_system_objects(
            cadence_mask=cm, cache=False,
            fetch=_fetch_factory(responses, seen[1]))
        assert len(got) == 1, cm
        assert_frames_equal(got, want)
        assert seen[1] == seen[0]
    got, mask = tl.query_solar_system_objects(
        cadence_mask=np.asarray([True]), cache=True, return_mask=True,
        fetch=_fetch_factory(responses, []))
    assert len(mask) == len(tl.flux) and mask.sum() == 1
    for bad in ("some", 3.0):
        for lc in (jl, tl):
            with pytest.raises(ValueError):
                lc.query_solar_system_objects(cadence_mask=bad,
                                              fetch=_fetch_factory({}, []))


def test_lc_query_sso_radius_defaults():
    """Default cone radius: 21 px (TESS) / 4 px (Kepler) x 15 arcsec."""
    for lc in asteroid_lcs(n=1):
        seen = []
        lc.query_solar_system_objects(cadence_mask="all",
                                      fetch=_fetch_factory({}, seen))
        assert f"-bd={21 * 15 / 3600.0}" in seen[0]
        lc.meta["MISSION"] = "Kepler"
        seen2 = []
        lc.query_solar_system_objects(cadence_mask="all",
                                      fetch=_fetch_factory({}, seen2))
        assert f"-bd={4 * 15 / 3600.0}" in seen2[0]
        lc.meta["MISSION"] = None
        with pytest.raises(ValueError, match="location"):
            lc.query_solar_system_objects(cadence_mask="all",
                                          fetch=_fetch_factory({}, []))


def test_lc_query_sso_skips_nan_flux():
    """NaN-flux cadences are not queried; ``"outliers"`` (the default
    mask) runs remove_outliers, on the CPU here."""
    for lc in asteroid_lcs(n=3):
        flux = np.asarray(lc.flux.value).copy()
        flux[1] = np.nan
        lc.flux = flux
        seen = []
        lc.query_solar_system_objects(cadence_mask="all",
                                      fetch=_fetch_factory({}, seen))
        assert len(seen) == 2
    jl, tl = asteroid_lcs(n=40)
    seen = [[], []]
    for lc, s in zip((jl, tl), seen):
        lc.flux = np.where(np.arange(40) == 7, 50.0, 1.0)
        lc.query_solar_system_objects(fetch=_fetch_factory({}, s))
    assert seen[1] == seen[0] and len(seen[1]) == 1


def test_sso_env_fixture_roundtrip(tmp_path, monkeypatch):
    """$LIGHTKURVE_TPU_SKYBOT_FIXTURES replays responses keyed by epoch
    without any fetch= argument; without it the query raises in both."""
    jl, tl = asteroid_lcs(n=1)
    for lc in (jl, tl):
        monkeypatch.delenv("LIGHTKURVE_TPU_SKYBOT_FIXTURES", raising=False)
        with pytest.raises(NotImplementedError, match="SkyBot"):
            lc.query_solar_system_objects(cadence_mask="all")
    epoch = float(np.asarray(tl.time.jd)[0])
    fx = tmp_path / "skybot.json"
    fx.write_text(json.dumps({str(epoch): SKYBOT_ONE_OBJECT}))
    monkeypatch.setenv("LIGHTKURVE_TPU_SKYBOT_FIXTURES", str(fx))
    got = tl.query_solar_system_objects(cadence_mask="all", cache=False)
    assert len(got) == 1 and got.Name.iloc[0].strip() == "2000 VJ61"
    assert_frames_equal(got, jl.query_solar_system_objects(
        cadence_mask="all", cache=False))
    fx.write_text(json.dumps({"1.0": SKYBOT_ONE_OBJECT}))
    with pytest.raises(tlk.LightkurveError, match="no response recorded"):
        tl.query_solar_system_objects(cadence_mask="all")


def test_tpf_sso_asteroid_crossing(tmp_path):
    """A synthetic asteroid-crossing TPF, written by the JAX package and
    read by the port -> photometry -> recorded SkyBot identification at
    the crossing epochs; the TPF's own query raises in both packages."""
    from tests.synthetic import make_synthetic_tpf
    jtpf = make_synthetic_tpf(n_cadences=6)
    flux = np.asarray(jtpf.hdu[1].data["FLUX"], dtype=np.float32)
    flux[2, 2, 1] += 500.0
    flux[3, 2, 3] += 500.0
    jtpf.hdu[1].data["FLUX"][:] = flux
    path = str(tmp_path / "asteroid.fits")
    jtpf.to_fits(path)
    ttpf = tlk.TessTargetPixelFile(path)
    for tpf in (jtpf, ttpf):
        with pytest.raises(NotImplementedError, match="SkyBot"):
            tpf.query_solar_system_objects()
    results = []
    for tpf in (jtpf, ttpf):
        lc = tpf.to_lightcurve(aperture_mask="all")
        lc.meta["MISSION"] = "TESS"
        lc.meta.setdefault("RA", 84.2)
        lc.meta.setdefault("DEC", -72.2)
        jd = np.asarray(lc.time.jd)
        responses = {f"EPOCH={jd[2]}": SKYBOT_ONE_OBJECT,
                     f"EPOCH={jd[3]}": SKYBOT_ONE_OBJECT}
        results.append(lc.query_solar_system_objects(
            cadence_mask="all", return_mask=True,
            fetch=_fetch_factory(responses, [])))
    (want, want_mask), (got, got_mask) = results
    assert len(got) == 2 and got_mask.sum() == 2
    assert set(np.flatnonzero(got_mask)) == {2, 3}
    assert_frames_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
