"""lightkurve_tpu_torch.seismology against lightkurve_tpu.seismology on the
same inputs on the CPU (the reference with x64 on, the port in float64 by
``port_on_cpu``): mode-comb SNR spectra (the reference tests' synthetic
spectrum) and one time-domain red giant of ``chip_smoke.seismic_star``.

Bars: numax on the same grid point; Delta-nu, the 2D ACF, the metric and
its smoothing within 1e-10 (relative; the ACF relative to its largest
value); the scaling relations and their errors within 1e-12; the echelle
image within 1e-12; ``to_seismology`` from a periodogram and from a light
curve (the light curve's gap fill drawing from one seeded generator in
both packages) giving the same numax and Delta-nu.
"""
import jax
import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import periodogram as jpg
from lightkurve_tpu import seismology as jseis
from lightkurve_tpu import units as ju
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import periodogram as tpg
from lightkurve_tpu_torch import seismology as tseis
from lightkurve_tpu_torch import units as tu
from lightkurve_tpu_torch.utils import LightkurveWarning

import chip_smoke

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
EXACT = 1e-12


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


def comb(numax, deltanu, fmin=1.0, fmax=400.0, fs=0.1, width=50.0,
         seed=None, cls="SNRPeriodogram"):
    """A mode comb under a Gaussian envelope (the reference tests'
    spectrum), as both packages' periodograms; with ``seed``, chi-squared
    noise on top."""
    freq = np.arange(fmin, fmax, fs)
    power = np.ones_like(freq)
    for k in range(-8, 9):
        f0 = numax + k * deltanu
        power += 40 * np.exp(-0.5 * ((freq - numax) / width) ** 2) * \
            np.exp(-0.5 * ((freq - f0) / 0.3) ** 2)
    if seed is not None:
        power *= np.random.default_rng(seed).exponential(size=freq.size)
    return (getattr(jpg, cls)(ju.Quantity(freq, ju.uHz),
                              ju.Quantity(power, "")),
            getattr(tpg, cls)(tu.Quantity(freq, tu.uHz),
                              tu.Quantity(power, "")))


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=rtol, atol=0)


def assert_numax_equal(a, b):
    assert float(b.value) == float(a.value)
    assert b.name == a.name and b.method == a.method
    da, db = a.diagnostics, b.diagnostics
    np.testing.assert_array_equal(db["numaxs"], da["numaxs"])
    scale = np.abs(da["acf2d"]).max()
    np.testing.assert_allclose(db["acf2d"] / scale, da["acf2d"] / scale,
                               rtol=0, atol=RTOL)
    close(db["metric"], da["metric"])
    close(db["metric_smooth"], da["metric_smooth"])
    assert db["window_width"] == da["window_width"]


SPECTRA = {"giant": (220.0, 16.97, {}),
           "noisy_giant": (120.0, 10.9, dict(seed=3)),
           "low_numax": (45.0, 5.1, dict(fmax=150.0, fs=0.05, width=12.0,
                                         seed=4)),
           "short_cadence": (2200.0, 103.0, dict(fmin=50.0, fmax=5000.0,
                                                 fs=0.5, width=300.0,
                                                 seed=5))}


@pytest.mark.parametrize("case", sorted(SPECTRA))
def test_numax_and_deltanu_equal(case):
    numax, dnu, kw = SPECTRA[case]
    j, t = comb(numax, dnu, **kw)
    js, ts = jseis.Seismology(j), tseis.Seismology(t)
    assert_numax_equal(js.estimate_numax(), ts.estimate_numax())
    jd, td = js.estimate_deltanu(), ts.estimate_deltanu()
    close(td.value, jd.value)
    close(td.diagnostics["lags"], jd.diagnostics["lags"])
    scale = np.abs(jd.diagnostics["acf"]).max()
    np.testing.assert_allclose(td.diagnostics["acf"] / scale,
                               jd.diagnostics["acf"] / scale, rtol=0,
                               atol=RTOL)
    np.testing.assert_array_equal(td.diagnostics["peaks"],
                                  jd.diagnostics["peaks"])
    close(td.diagnostics["deltanu_emp"], jd.diagnostics["deltanu_emp"],
          EXACT)
    assert abs(float(td.value) / dnu - 1) < 0.05
    # explicit numaxs, window and spacing
    kw = dict(numaxs=np.linspace(numax * 0.6, numax * 1.3, 40),
              window_width=numax / 8, spacing=numax / 200)
    assert_numax_equal(js.estimate_numax(**kw), ts.estimate_numax(**kw))
    close(ts.estimate_deltanu(numax=numax * 1.02).value,
          js.estimate_deltanu(numax=numax * 1.02).value)


def test_autocorrelate_equal():
    j, t = comb(120.0, 10.9, seed=7)
    for numax, width in ((120.0, 25.0), (3.0, 25.0), (398.0, 30.0)):
        a = jseis.autocorrelate(j, numax, window_width=width)
        b = tseis.autocorrelate(t, numax, window_width=width)
        assert len(a) == len(b)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=RTOL)
    assert tseis.get_fwhm(t, 100.0) == jseis.get_fwhm(j, 100.0)


@pytest.mark.parametrize("errors", [False, True])
def test_stellar_estimators_equal(errors):
    kw = dict(numax_err=0.75, deltanu_err=0.012, teff_err=80) if errors \
        else {}
    for args in ((46.12, 4.934, 4531.0), (3090.0, 135.1, 5772.0),
                 (210.0, 15.4, 4900.0)):
        for name in ("estimate_radius", "estimate_mass"):
            a = getattr(jseis, name)(*args, **kw)
            b = getattr(tseis, name)(*args, **kw)
            close(b.value, a.value, EXACT)
            close(b.error.value, a.error.value, EXACT)
            assert str(b.unit) == str(a.unit)
        lkw = {k: v for k, v in kw.items() if k != "deltanu_err"}
        a = jseis.estimate_logg(args[0], args[2], **lkw)
        b = tseis.estimate_logg(args[0], args[2], **lkw)
        close(b.value, a.value, EXACT)
        close(b.error.value, a.error.value, EXACT)
    assert tuple(tseis.stellar_estimators.NUMAX_SOL) == tuple(
        jseis.stellar_estimators.NUMAX_SOL)


def test_butler_chain_and_echelle_equal():
    j, t = comb(220.0, 16.97, seed=9)
    js, ts = jseis.Seismology(j), tseis.Seismology(t)
    js.estimate_numax(), ts.estimate_numax()
    js.estimate_deltanu(), ts.estimate_deltanu()
    for name in ("estimate_radius", "estimate_mass", "estimate_logg"):
        close(getattr(ts, name)(teff=4800).value,
              getattr(js, name)(teff=4800).value, EXACT)
    close(ts.estimate_radius(teff=4800, teff_err=50, numax_err=2.0,
                             deltanu_err=0.1).error.value,
          js.estimate_radius(teff=4800, teff_err=50, numax_err=2.0,
                             deltanu_err=0.1).error.value, EXACT)
    assert "computed values" in repr(ts)
    for kw in ({}, dict(smooth_filter_width=0, scale="log"),
               dict(minimum_frequency=150.0, maximum_frequency=300.0),
               dict(deltanu=15.0, numax=200.0)):
        for a, b in zip(js._clean_echelle(**kw), ts._clean_echelle(**kw)):
            np.testing.assert_allclose(b, a, rtol=EXACT, atol=0)
    for pkg, s in ((jseis, js), (tseis, ts)):
        with pytest.raises(ValueError, match="teff"):
            s.estimate_radius()
        with pytest.raises(AttributeError):
            pkg.Seismology(s.periodogram).estimate_deltanu()
        with pytest.raises(ValueError):
            s._clean_echelle(maximum_frequency=1e5)
    # the plots: the echelle of the same numbers equal to the reference's
    # figure (test_torch_plots holds every seismology plot), and the
    # diagnostics of an estimate without them refused alike
    import matplotlib.pyplot as plt
    from test_torch_plots import assert_same_plot
    for kw in ({}, dict(deltanu=15.0, numax=200.0)):
        kw.setdefault("deltanu", float(js.deltanu.value))
        assert_same_plot(ts.plot_echelle(**kw), js.plot_echelle(**kw))
    for pkg, s in ((jseis, js), (tseis, ts)):
        with pytest.raises(ValueError, match="No diagnostics"):
            pkg.SeismologyQuantity(s.numax).plot_diagnostics()
    assert type(tlk.diagnose_numax_acf2d(ts.numax)[0]).__name__ == "Axes"
    plt.close("all")


def test_estimator_errors_match():
    j, t = comb(220.0, 16.97)
    uneven_f = np.sort(np.random.default_rng(1).uniform(1, 400, 3000))
    uneven = (jpg.SNRPeriodogram(ju.Quantity(uneven_f, ju.uHz),
                                 ju.Quantity(np.ones(3000), "")),
              tpg.SNRPeriodogram(tu.Quantity(uneven_f, tu.uHz),
                                 tu.Quantity(np.ones(3000), "")))
    cases = [
        lambda p, s: p.estimate_numax_acf2d(s[0]),
        lambda p, s: p.estimate_numax_acf2d(s[1], window_width=0.01),
        lambda p, s: p.estimate_numax_acf2d(s[1], spacing=1e4),
        lambda p, s: p.estimate_numax_acf2d(s[1], numaxs=[0.01, 50.0]),
        lambda p, s: p.estimate_numax_acf2d(s[1], numaxs=[50.0, 1e4]),
        lambda p, s: p.estimate_deltanu_acf2d(s[1], numax=0.01),
        lambda p, s: p.estimate_deltanu_acf2d(s[1], numax=1e4),
        lambda p, s: p.estimate_deltanu_acf2d(s[0], numax=100.0),
    ]
    for i, fn in enumerate(cases):
        names = []
        for pkg, spectra in ((jseis, (uneven[0], j)), (tseis, (uneven[1],
                                                                t))):
            with pytest.raises(ValueError) as info:
                fn(pkg, spectra)
            names.append(str(info.value))
        assert names[0] == names[1], i
    for pkg, pg in ((jseis, jpg), (tseis, tpg)):
        flat = pg.Periodogram(
            (ju if pkg is jseis else tu).Quantity(np.arange(1.0, 100, 0.1),
                                                  "uHz"),
            (ju if pkg is jseis else tu).Quantity(np.ones(990), ""))
        with pytest.warns(Warning, match="background"):
            pkg.Seismology(flat)


def test_periodogram_to_seismology_equal():
    j, t = comb(150.0, 12.3, seed=11, cls="Periodogram")
    with pytest.warns(LightkurveWarning, match="background"):
        ts = t.to_seismology()
    assert type(ts).__name__ == "Seismology"
    js = j.to_seismology()
    assert_numax_equal(js.estimate_numax(), ts.estimate_numax())
    close(ts.estimate_deltanu().value, js.estimate_deltanu().value)
    _, snr = comb(150.0, 12.3, seed=11)
    assert snr.to_seismology().periodogram is snr


@pytest.fixture
def seeded_draws(monkeypatch):
    """``fill_gaps`` draws its noise from ``np.random.default_rng(None)``:
    give every such call the same seed in both packages."""
    make = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: make(13 if seed is None else seed))


def test_lightcurve_to_seismology_equal(seeded_draws):
    """A red giant of chip_smoke's generator over 150 d of long cadence
    (its 1% random losses filled by both packages' fill_gaps from one
    seeded draw): LightCurve.to_seismology, numax and Delta-nu."""
    t, f, fe, truth = chip_smoke.seismic_star(chip_smoke.SEIS_SEED + 2,
                                              days=150.0)
    j = jlk.LightCurve(time=t, flux=f, flux_err=fe)
    p = tlk.LightCurve(time=t, flux=f, flux_err=fe)
    js = j.to_seismology(normalization="psd")
    ts = p.to_seismology(normalization="psd")
    assert type(ts.periodogram).__name__ == "SNRPeriodogram"
    close(ts.periodogram.power.value, js.periodogram.power.value, 1e-8)
    assert_numax_equal(js.estimate_numax(), ts.estimate_numax())
    close(ts.estimate_deltanu().value, js.estimate_deltanu().value)
    assert abs(float(ts.numax.value) / truth["numax"] - 1) < 0.1
