"""lightkurve_tpu_torch's periodogram classes against lightkurve_tpu.

The same numpy inputs, made from a seed, go through ``to_periodogram`` of
both packages on the CPU: the reference with x64 on (conftest), the port
with its configuration set to the CPU and float64.  Bars:

- 1e-9 of the largest power: ``LombScarglePeriodogram`` for each
  ``ls_method`` x ``normalization``, and ``model``; the frequencies equal;
- ``test_torch_percurve.assert_same`` (rtol 1e-9, exact ties may rank
  either way): ``BoxLeastSquaresPeriodogram``, fast and exact;
- rtol 1e-10: ``compute_stats``;
- equal: ``get_transit_mask``, ``autoperiod``, the default BLS grid, and
  ``Periodogram.bin``, ``smooth`` and ``flatten`` on the same spectrum;
  ``get_transit_model`` equal but for its two flux levels, which agree to
  rtol 1e-15 (torch and XLA sum in different orders; ROADMAP C).
"""
import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import periodogram as jpg
from lightkurve_tpu import units as junits
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import periodogram as tpg
from lightkurve_tpu_torch import units as tunits
from test_torch_lightcurve import assert_lc_equal
from test_torch_percurve import assert_same

ROW_RTOL = 1e-9
RTOL = 1e-10
BLS_FIELDS = ("power", "depth", "depth_err", "snr", "log_likelihood",
              "duration", "transit_time", "period")


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "default_device", "cpu")
        mp.setattr(config, "default_dtype", torch.float64)
        yield


def curve_pair(rng, n=500, jitter=True):
    """A rotating star with one transiting planet (1.37 d, 0.1 d, 3e-3),
    NaN cadences and per-cadence errors; jittered times (the exact BLS
    reads them: ROADMAP C, window edges)."""
    t = 1500.0 + np.arange(n) * 0.0139
    if jitter:
        t = t + rng.uniform(-2e-3, 2e-3, n)
    flux = 1 + 0.004 * np.sin(2 * np.pi * t / 2.9 + 0.3)
    ph = np.mod(t - 1500.35 + 0.685, 1.37) - 0.685
    flux[np.abs(ph) < 0.05] -= 3e-3
    flux = flux + 4e-4 * rng.standard_normal(n)
    flux_err = rng.uniform(3.5e-4, 4.5e-4, n)
    flux[rng.random(n) < 0.02] = np.nan
    kw = dict(time=t, flux=flux, flux_err=flux_err,
              meta={"TARGETID": 11, "LABEL": "star 11"})
    return jlk.TessLightCurve(**kw), tlk.TessLightCurve(**kw)


@pytest.fixture(scope="module")
def pair():
    return curve_pair(np.random.default_rng(4242))


def value(x):
    return np.asarray(getattr(x, "value", x), dtype=np.float64)


def assert_rows(got, want, rtol=ROW_RTOL, tag=""):
    got, want = value(got), value(want)
    assert got.shape == want.shape, tag
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= rtol, f"{tag}: {err:.3g} of the largest"


LS_CASES = [("fast", {}), ("slow", {}), ("chi2", {}), ("fastchi2", {}),
            ("chi2", {"nterms": 3}), ("fastchi2", {"nterms": 2}),
            ("auto", {}), ("fastnifty", {})]


@pytest.mark.parametrize("normalization", ["amplitude", "psd"])
@pytest.mark.parametrize("ls_method, kw", LS_CASES,
                         ids=[f"{m}{k.get('nterms', '')}"
                              for m, k in LS_CASES])
def test_lombscargle_periodogram_matches_jax(pair, ls_method, kw,
                                             normalization):
    j, t = pair
    args = dict(ls_method=ls_method, normalization=normalization,
                minimum_period=0.3, maximum_period=4.0, **kw)
    a = j.to_periodogram(**args)
    b = t.to_periodogram(**args)
    tag = f"{ls_method} {normalization}"
    assert type(b).__name__ == "LombScarglePeriodogram"
    assert (b.ls_method, b.nterms, b.default_view) == \
        (a.ls_method, a.nterms, a.default_view)
    np.testing.assert_array_equal(b.frequency.value, a.frequency.value)
    assert str(b.frequency.unit) == str(a.frequency.unit)
    assert str(b.power.unit) == str(a.power.unit)
    np.testing.assert_array_equal(b.nyquist.value, a.nyquist.value)
    assert_rows(b.power, a.power, tag=tag)
    if ls_method == "slow":
        assert_lc_equal(a.model(), b.model())
        ta = np.linspace(1500.0, 1507.0, 50)
        for freq in (None, a.frequency[7]):
            ma, mb = a.model(time=ta, frequency=freq), b.model(
                time=ta, frequency=None if freq is None else b.frequency[7])
            assert_rows(mb.flux, ma.flux, tag="model")


def test_lombscargle_irregular_grid_and_defaults_match_jax(pair):
    j, t = pair
    freq = np.sort(np.random.default_rng(1).uniform(0.3, 3.0, 300))
    a = j.to_periodogram(frequency=freq)
    b = t.to_periodogram(frequency=freq)
    assert b.ls_method == a.ls_method == "slow"
    assert_rows(b.power, a.power, tag="irregular")
    a, b = j.to_periodogram(), t.to_periodogram()
    np.testing.assert_array_equal(b.frequency.value, a.frequency.value)
    assert_rows(b.power, a.power, tag="defaults")
    np.testing.assert_array_equal(b.period_at_max_power.value,
                                  a.period_at_max_power.value)


def bls_fields(pg):
    return {k: value(getattr(pg, k)) for k in BLS_FIELDS if k != "period"} \
        | {"period": value(pg.period)}


@pytest.mark.parametrize("method", ["fast", "exact"])
@pytest.mark.parametrize("kw", [dict(period=np.linspace(0.8, 2.4, 120)),
                                dict(period=np.linspace(0.8, 2.4, 120),
                                     objective="snr", duration=[0.06, 0.1],
                                     oversample=5)],
                         ids=["likelihood", "snr"])
def test_bls_periodogram_matches_jax(pair, method, kw):
    j, t = pair
    # ``method`` of the BLS search, which to_periodogram's own shadows
    a = jpg.BoxLeastSquaresPeriodogram.from_lightcurve(j, method=method,
                                                       **kw)
    b = tpg.BoxLeastSquaresPeriodogram.from_lightcurve(t, method=method,
                                                       **kw)
    assert type(b).__name__ == "BoxLeastSquaresPeriodogram"
    assert_same(bls_fields(a), bls_fields(b), tag=method, fields=BLS_FIELDS)
    assert b.transit_time.format == a.transit_time.format == "btjd"


def test_bls_default_grid_and_autoperiod_equal(pair):
    j, t = pair
    a, b = j.to_periodogram("bls"), t.to_periodogram("bls")
    np.testing.assert_array_equal(b.period.value, a.period.value)
    assert_same(bls_fields(a), bls_fields(b), tag="default",
                fields=BLS_FIELDS)
    for args in [([0.05, 0.33], 27.0, 0.5, 9.0),
                 ([0.1], 80.0, 1.0, 30.0, 3.0)]:
        np.testing.assert_array_equal(tpg.autoperiod(*args),
                                      jpg.autoperiod(*args))


@pytest.fixture(scope="module")
def bls_pair(pair):
    j, t = pair
    grid = dict(period=np.linspace(1.2, 1.6, 60))
    return (j.flatten(window_length=51).to_periodogram("bls", **grid),
            t.flatten(window_length=51).to_periodogram("bls", **grid))


@pytest.mark.parametrize("best", [False, True])
def test_compute_stats_rtol(bls_pair, best):
    a, b = bls_pair
    kw = {} if best else dict(period=1.37, duration=0.1,
                              transit_time=1500.35)
    sa, sb = a.compute_stats(**kw), b.compute_stats(**kw)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_allclose(np.asarray(sb[k], dtype=float),
                                   np.asarray(sa[k], dtype=float),
                                   rtol=RTOL, err_msg=k)


#: the model's two levels are weighted means whose sums torch and XLA
#: add in different orders: they agree to a few ulps, not bit for bit
#: (ROADMAP C)
LEVEL_RTOL = 1e-15


@pytest.mark.parametrize("best", [False, True])
def test_transit_model_and_mask_equal(bls_pair, best):
    """The mask, and so which cadences take the in-transit level, equal;
    the levels within :data:`LEVEL_RTOL`; everything else of the model
    equal."""
    a, b = bls_pair
    kw = {} if best else dict(period=1.37, duration=0.1,
                              transit_time=1500.35)
    mask = a.get_transit_mask(**kw)
    np.testing.assert_array_equal(b.get_transit_mask(**kw), mask)
    assert 0 < mask.sum() < len(mask)
    ma, mb = a.get_transit_model(**kw), b.get_transit_model(**kw)
    np.testing.assert_allclose(mb.flux.value, ma.flux.value,
                               rtol=LEVEL_RTOL, atol=0)
    for m in (ma, mb):
        assert len(np.unique(m.flux.value[mask])) == 1
        assert len(np.unique(m.flux.value[~mask])) == 1
        m.flux = np.zeros(len(m))
    assert_lc_equal(ma, mb)
    assert ma.meta == mb.meta
    assert abs(b.period_at_max_power.value - 1.37) < 0.01


def spectra(rng, n=800):
    f = np.linspace(1.0, 300.0, n)
    p = 1e3 / f ** 1.5 * rng.chisquare(2, n) / 2
    p[400:403] += 40.0
    return ((junits.Quantity(f, junits.uHz), junits.Quantity(p, "ppm")),
            (tunits.Quantity(f, tunits.uHz), tunits.Quantity(p, "ppm")))


def assert_pg_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(b.frequency.value, a.frequency.value)
    np.testing.assert_array_equal(b.power.value, a.power.value)
    assert str(b.power.unit) == str(a.power.unit)


@pytest.mark.parametrize("op", [
    "bin10", "bin7_median", "box", "box_q", "logmedian", "flatten",
    "flatten_trend", "slice", "arith"])
def test_periodogram_host_methods_equal(rng, op):
    (fa, pa), (fb, pb) = spectra(rng)
    a = jpg.Periodogram(fa, pa, label="x")
    b = tpg.Periodogram(fb, pb, label="x")
    calls = {
        "bin10": lambda g, u: g.bin(10),
        "bin7_median": lambda g, u: g.bin(7, method="median"),
        "box": lambda g, u: g.smooth(filter_width=2.5),
        "box_q": lambda g, u: g.smooth(filter_width=u.Quantity(3.0,
                                                               u.uHz)),
        "logmedian": lambda g, u: g.smooth("logmedian", 0.05),
        "flatten": lambda g, u: g.flatten(filter_width=0.05),
        "flatten_trend": lambda g, u: g.flatten(filter_width=0.05,
                                                return_trend=True)[1],
        "slice": lambda g, u: g[100:300],
        "arith": lambda g, u: (2.0 * g + 1.0) / 3.0 - 0.5,
    }
    ra, rb = calls[op](a, junits), calls[op](b, tunits)
    assert_pg_equal(ra, rb)
    assert rb.max_power.value == ra.max_power.value
    np.testing.assert_array_equal(rb.period.value, ra.period.value)
