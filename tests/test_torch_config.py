"""The port's settings, convenience helpers, file shims and notebook helpers
against lightkurve_tpu's: ``conf``, ``get_config_dir`` and
``get_cache_dir`` under each environment order, with a ``lightkurve.cfg``
in Lightkurve's astropy layout; ``save()``/``reload()`` across the two
packages; a file carrying the JAX package's backend knobs; ``estimate_cdpp``;
the deprecated ``*LightCurveFile`` shims; the notebook helpers.

Bars: equal (paths, settings, reads, URLs); ``estimate_cdpp`` within 1e-10
relative.  Every test points ``HOME``, ``XDG_CONFIG_HOME``,
``XDG_CACHE_HOME`` and ``LIGHTKURVE_CACHE_DIR`` into ``tmp_path``.
"""
import configparser
import os
import warnings

import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import config as jconfig
from lightkurve_tpu_torch import config as tconfig
from tests.io.test_fits import make_tess_lc_file

CFG = """[search]
search_result_display_extra_columns = sequence_number, proposal_id

[config]
cache_dir = {cache}
"""


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch):
    """HOME in ``tmp_path``, the XDG and cache variables unset; both
    packages' ``conf`` restored after the test."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for var in ("XDG_CONFIG_HOME", "XDG_CACHE_HOME", "LIGHTKURVE_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    os.makedirs(tmp_path / "home")
    saved = [(c, dict(vars(c))) for c in (jconfig.conf, tconfig.conf)]
    yield tmp_path
    for c, attrs in saved:
        vars(c).clear()
        vars(c).update(attrs)


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(tconfig, "default_device", "cpu")
    monkeypatch.setattr(tconfig, "default_dtype", torch.float64)


def settings(conf):
    return (conf.search_result_display_extra_columns, conf.cache_dir,
            conf.warn_legacy_cache_dir)


def reload_both():
    jconfig.conf.reload()
    tconfig.conf.reload()


@pytest.mark.parametrize("xdg_config", [False, True])
@pytest.mark.parametrize("cache", ["conf", "env", "xdg", "home"])
def test_dirs_and_file_settings(home, monkeypatch, xdg_config, cache):
    """Config and cache directories in each resolution order, and a
    ``lightkurve.cfg`` with ``[search]`` and ``[config]`` sections."""
    if xdg_config:
        os.makedirs(home / "xdg_config")
        monkeypatch.setenv("XDG_CONFIG_HOME", str(home / "xdg_config"))
    assert tconfig.get_config_dir() == jconfig.get_config_dir()
    want = str(home / "from_cfg")
    with open(os.path.join(tconfig.get_config_dir(), "lightkurve.cfg"),
              "w") as f:
        f.write(CFG.format(cache=want if cache == "conf" else ""))
    reload_both()
    assert settings(tconfig.conf) == settings(jconfig.conf)
    assert tconfig.conf.search_result_display_extra_columns == [
        "sequence_number", "proposal_id"]
    if cache == "env":
        monkeypatch.setenv("LIGHTKURVE_CACHE_DIR", str(home / "env_cache"))
    if cache == "xdg":
        os.makedirs(home / "xdg_cache")
        monkeypatch.setenv("XDG_CACHE_HOME", str(home / "xdg_cache"))
    got = tconfig.get_cache_dir()
    assert got == jconfig.get_cache_dir() and os.path.isdir(got)
    assert got == {"conf": want,
                   "env": str(home / "env_cache"),
                   "xdg": str(home / "xdg_cache" / "lightkurve_tpu"),
                   "home": os.path.join(str(home / "home"), ".lightkurve_tpu",
                                        "cache")}[cache]


def test_reading_settings_creates_nothing(home):
    tconfig.conf.reload()
    assert not os.path.exists(home / "home" / ".lightkurve_tpu")


def test_save_reload_across_packages(home):
    """The port's ``save`` is read by the reference's ``reload`` and the
    other way round; the port keeps the reference's own keys."""
    tconfig.conf.cache_dir = str(home / "a")
    tconfig.conf.search_result_display_extra_columns = ["obsid", "s_ra"]
    tconfig.conf.save()
    jconfig.conf.reload()
    assert settings(jconfig.conf) == settings(tconfig.conf)

    jconfig.conf.cache_dir = str(home / "b")
    jconfig.conf.fft_backend = "native"
    jconfig.conf.search_result_display_extra_columns = ["distance"]
    jconfig.conf.save()
    tconfig.conf.search_result_display_extra_columns = []
    tconfig.conf.reload()
    assert settings(tconfig.conf) == settings(jconfig.conf)
    assert not hasattr(tconfig.conf, "fft_backend")

    tconfig.conf.save()
    cp = configparser.ConfigParser()
    cp.read(os.path.join(tconfig.get_config_dir(), "lightkurve_tpu.cfg"))
    assert cp["lightkurve_tpu"]["fft_backend"] == "native"
    jconfig.conf.reload()
    assert jconfig.conf.fft_backend == "native"
    assert settings(jconfig.conf) == settings(tconfig.conf)


def test_jax_knobs_are_read_and_ignored(home):
    with open(os.path.join(tconfig.get_config_dir(), "lightkurve_tpu.cfg"),
              "w") as f:
        f.write("[lightkurve_tpu]\nfft_backend = custom\n"
                "bls_default_backend = pallas\ndefault_dtype = float64\n"
                "enable_persistent_compile_cache = true\n"
                "search_result_display_extra_columns = obsid\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        reload_both()
    assert settings(tconfig.conf) == settings(jconfig.conf)
    assert tconfig.conf.search_result_display_extra_columns == ["obsid"]
    assert tconfig.default_dtype is torch.float64   # the fixture's, untouched
    for knob in ("fft_backend", "bls_default_backend", "default_dtype"):
        assert not hasattr(tconfig.conf, knob)


def test_top_level_names_resolve_to_the_port():
    from lightkurve_tpu_torch import time, units, utils
    assert tlk.conf is tconfig.conf
    assert (tlk.Quantity, tlk.Unit) == (units.Quantity, units.Unit)
    assert (tlk.Time, tlk.TimeDelta) == (time.Time, time.TimeDelta)
    assert tlk.TessQualityFlags is utils.TessQualityFlags
    assert tlk.ops.__name__ == "lightkurve_tpu_torch.ops"


@pytest.mark.parametrize("kwargs", [{}, {"transit_duration": 7},
                                    {"savgol_window": 51, "sigma": 4}])
def test_estimate_cdpp(kwargs):
    flux = np.random.default_rng(3).normal(1, 1e-4, 5000)
    flux[::97] += 2e-3
    want = float(np.asarray(jlk.estimate_cdpp(flux, **kwargs).value))
    got = float(np.asarray(tlk.estimate_cdpp(flux, **kwargs).value))
    assert got == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("shim", ["KeplerLightCurveFile",
                                  "TessLightCurveFile"])
def test_file_shims(tmp_path, shim):
    path = make_tess_lc_file(str(tmp_path / "lc.fits"), n=200)
    with pytest.warns(tlk.LightkurveDeprecationWarning, match="read()"):
        got = getattr(tlk, shim)(path, flux_column="sap_flux")
    direct = tlk.read(path, flux_column="sap_flux")
    with pytest.warns(jlk.LightkurveDeprecationWarning):
        ref = getattr(jlk, shim)(path, flux_column="sap_flux")
    assert type(got) is type(direct)
    assert type(got).__name__ == type(ref).__name__
    for lc in (direct, ref):
        np.testing.assert_array_equal(np.asarray(got.flux.value),
                                      np.asarray(lc.flux.value))
        np.testing.assert_array_equal(np.asarray(got.time.value),
                                      np.asarray(lc.time.value))


@pytest.mark.parametrize("url", [None, "localhost:9999"])
def test_notebook_helpers(monkeypatch, url):
    for env in (False, True):
        if env:
            monkeypatch.setenv("LK_JUPYTERHUB_EXTERNAL_URL",
                               "https://hub.example.org")
            monkeypatch.setenv("JUPYTERHUB_SERVICE_PREFIX", "/user/me/")
        got, want = (tlk.finalize_notebook_url(url),
                     jlk.finalize_notebook_url(url))
        if callable(want):
            assert callable(got)
            for port in (None, 8888, 5006):
                assert got(port) == want(port)
        else:
            assert got == want
    assert tlk.is_notebook() == jlk.is_notebook() is False
    with pytest.raises(ValueError, match="Empty host"):
        tlk.finalize_notebook_url("  ")


def test_citation(capsys):
    tlk.show_citation_instructions()
    text = capsys.readouterr().out
    assert "lightkurve_tpu_torch" in text and "ascl:1812.013" in text
    assert "TPU" not in text
