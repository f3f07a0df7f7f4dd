"""The port's standalone HTML explorers against lightkurve_tpu's, at a
small size: the BLS explorer on a 1,500-cadence transit curve at
``resolution=400``, ``refine_peaks=2``, ``refine_factor=4`` (the port on
the CPU in float64); the pixel selector and the sky view on a TPF of 200
cadences × 9 × 9 with a WCS, cut by each package's
``TargetPixelFileFactory.from_fits_images`` from the same FFIs (the sky
view with 10 catalog sources and a nearby-TIC report through
``merge_nearby_tics``); the echelle explorer on a synthetic
``SNRPeriodogram``.

Bars on the page's parsed ``const D = {…}``: BLS power within 1e-9 of the
peak, the same ``best``; ``t0`` may differ only where the power ties to
1e-9 (ROADMAP C); every other number within one unit of its last printed
digit; strings, masks and flags equal.  The page outside ``D`` is equal.
The ``html=`` routes of ``interact_bls``, ``interact``, ``interact_sky``
and ``interact_echelle`` reach the exporters; without ``html=`` the
static matplotlib figures match the reference's, and ``interact_sky``
raises as the reference's does.
"""
import json
import math
import os
import re

import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import interact as jinteract
from lightkurve_tpu import utils as jutils
from lightkurve_tpu import interact_html as jhtml
from lightkurve_tpu.periodogram import SNRPeriodogram as JSNR
from lightkurve_tpu.targetpixelfile import TessTargetPixelFile as JTess
from lightkurve_tpu.units import Quantity as JQ, Unit as JU
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import interact as tinteract
from lightkurve_tpu_torch import interact_html as thtml
from lightkurve_tpu_torch.periodogram import SNRPeriodogram as TSNR
from lightkurve_tpu_torch.targetpixelfile import TessTargetPixelFile as TTess
from lightkurve_tpu_torch.units import Quantity as TQ, Unit as TU
from test_torch_tpf import tfits

BLS_POWER_RTOL = 1e-9
#: significant digits of each embedded array (``interact_html._js_array``)
SIG = {"p": 9, "t0": 9, "t": 10}


@pytest.fixture(autouse=True)
def port_on_cpu(tmp_path, monkeypatch):
    """The port on the CPU in float64; HOME, XDG_* and the cache directory
    in ``tmp_path``."""
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)
    for var, sub in (("HOME", "home"), ("XDG_CONFIG_HOME", "xdg_config"),
                     ("XDG_CACHE_HOME", "xdg_cache"),
                     ("LIGHTKURVE_CACHE_DIR", "cache")):
        monkeypatch.setenv(var, str(tmp_path / sub))


def split_page(html):
    """(page before D, parsed D, page after D)."""
    m = re.search(r"const D = (\{.*?\});\n", html, re.S)
    assert m, "no embedded data blob"
    blob = re.sub(r"([,{])([A-Za-z_][A-Za-z0-9_]*):", r'\1"\2":', m.group(1))
    return html[:m.start()], json.loads(blob), html[m.end():]


def last_digit_unit(x, sig):
    """One unit in the last of ``sig`` printed significant digits of x."""
    x = np.abs(np.asarray(x, float))
    with np.errstate(divide="ignore"):
        e = np.floor(np.log10(np.where(x > 0, x, 1.0)))
    return 10.0 ** (e - sig + 1)


def as_array(v):
    return np.array([np.nan if u is None else u for u in v], float)


def assert_close_printed(got, want, sig, name, skip=None):
    g, w = as_array(got), as_array(want)
    assert g.shape == w.shape, name
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), name)
    ok = np.isnan(w) | (np.abs(g - w) <= 1.0001 * np.maximum(
        last_digit_unit(w, sig), last_digit_unit(g, sig)))
    if skip is not None:
        ok |= skip
    assert ok.all(), (name, np.flatnonzero(~ok)[:5], g[~ok][:5], w[~ok][:5])


def assert_data_close(got, want, ties=None):
    """Every entry of two parsed ``D`` blobs within one unit of its last
    printed digit (numbers), or equal (strings, flags, masks, sources)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list) and w and isinstance(w[0], list):
            for gi, wi in zip(g, w):
                assert_close_printed(gi, wi, SIG.get(k, 6), k)
        elif isinstance(w, list) and all(
                isinstance(v, (float, int)) or v is None for v in w) and not (
                    k in ("shape", "init", "pipeline", "threshold", "aper")):
            assert_close_printed(g, w, SIG.get(k, 6), k,
                                 skip=ties if k in ("t0", "dur", "dep")
                                 else None)
        elif isinstance(w, float) and not isinstance(w, bool):
            assert g == pytest.approx(w, rel=1e-12), k
        else:
            assert g == w, k


def assert_pages_equal(port_path, ref_path, ties=None):
    pb, pd, pa = split_page(open(port_path).read())
    rb, rd, ra = split_page(open(ref_path).read())
    assert (pb, pa) == (rb, ra)
    assert_data_close(pd, rd, ties)
    return pd, rd


# ----------------------------------------------------------------------
# the BLS explorer
# ----------------------------------------------------------------------
def transit_columns(n=1500, seed=7):
    rng = np.random.default_rng(seed)
    t = 1500.0 + np.arange(n) * 0.02 + 1e-4 * rng.random(n)
    P, t0, dur, dep = 3.37, 1501.1, 0.15, 4e-3
    phase = np.abs((t - t0 + P / 2) % P - P / 2)
    f = 1.0 - dep * (phase < dur / 2) + 5e-4 * rng.standard_normal(n)
    f[rng.random(n) < 0.01] = np.nan
    return t, f, np.full(n, 5e-4)


def bls_pages(tmp_path, **kw):
    t, f, e = transit_columns()
    paths = []
    for mod in (jhtml, thtml):
        pkg = jlk if mod is jhtml else tlk
        lc = pkg.LightCurve(time=t, flux=f, flux_err=e)
        lc.meta["LABEL"] = "TIC 7"
        path = str(tmp_path / f"{mod.__name__}.html")
        assert mod.export_interact_bls_html(lc, path, **kw) == path
        paths.append(path)
    return paths


def bls_ties(pd, rd):
    """The periods whose best box differs: allowed only where the power
    ties to 1e-9 of the peak (ROADMAP C); at most 1% of them."""
    t0p, t0r = as_array(pd["t0"]), as_array(rd["t0"])
    diff = np.abs(t0p - t0r) > 1.0001 * np.maximum(last_digit_unit(t0r, 9),
                                                   last_digit_unit(t0p, 9))
    assert diff.mean() <= 0.01, diff.sum()
    return diff


@pytest.mark.parametrize("kw", [
    dict(resolution=400, refine_peaks=2, refine_factor=4),
    dict(resolution=400, refine_peaks=0, durations=[0.05, 0.1, 0.2],
         minimum_period=1.0, maximum_period=9.0),
    dict(resolution=300, refine_peaks=2, refine_factor=4, max_points=500)])
def test_bls_page_matches(tmp_path, kw):
    ref_path, port_path = bls_pages(tmp_path, **kw)
    pb, pd, pa = split_page(open(port_path).read())
    rb, rd, ra = split_page(open(ref_path).read())
    assert (pb, pa) == (rb, ra)
    assert pd["best"] == rd["best"]
    pp, pr = as_array(pd["power"]), as_array(rd["power"])
    assert np.nanmax(np.abs(pp - pr)) <= BLS_POWER_RTOL * np.nanmax(pr)
    ties = bls_ties(pd, rd)
    assert_data_close({k: v for k, v in pd.items() if k != "power"},
                      {k: v for k, v in rd.items() if k != "power"}, ties)
    n_base = kw["resolution"]
    assert len(pd["p"]) == n_base + (kw["refine_peaks"] * 80 * 4
                                     if kw["refine_peaks"] else 0)


def test_bls_page_ties_may_reorder_the_refined_peaks(tmp_path):
    """ROADMAP C: on a 400-cadence curve whose transit lies beyond the
    default grid, the base grid's power has plateaus of equal power
    (adjacent periods holding the same boxes); the two packages then agree
    within 1e-9 of the peak everywhere, but each page may take another
    period of a plateau as ``best`` and around it refine other periods.
    The pages' bests tie, and every base period is in both pages."""
    t, f, e = transit_columns(n=400)
    lcs = [pkg.LightCurve(time=t, flux=f, flux_err=e) for pkg in (jlk, tlk)]
    paths = []
    for i, (mod, lc) in enumerate(zip((jhtml, thtml), lcs)):
        paths.append(mod.export_interact_bls_html(
            lc, str(tmp_path / f"{i}.html"), resolution=20000))
    (_, rd, _), (_, pd, _) = (split_page(open(p).read()) for p in paths)
    tv = np.asarray(tinteract._preprocess_lc_for_bls(lcs[1]).time.value)
    dt = float(np.median(np.diff(tv)))
    base = np.linspace(max(4 * dt, 0.33 + dt), (tv.max() - tv.min()) / 3,
                       20000)                 # the exporter's base grid
    powers = [np.asarray(lc.normalize().to_periodogram(
        method="bls", period=base).power.value) for lc in lcs]
    peak = np.nanmax(powers[0])
    assert np.nanmax(np.abs(powers[1] - powers[0])) <= BLS_POWER_RTOL * peak
    pp, pr = as_array(pd["p"]), as_array(rd["p"])
    ib, jb = (int(np.argmin(np.abs(base - x))) for x in (pp[pd["best"]],
                                                          pr[rd["best"]]))
    assert abs(powers[0][ib] - powers[0][jb]) <= BLS_POWER_RTOL * peak
    printed = np.array([float("%.9g" % x) for x in base])
    assert np.isin(printed, np.intersect1d(pp, pr)).all()


def test_bls_page_runs_on_the_requested_device(tmp_path, monkeypatch):
    """The precompute follows ``config.default_device``: the CPU when the
    caller sets it, and the card (which raises without CUDA) otherwise."""
    from lightkurve_tpu_torch.ops import bls
    seen = []
    real = bls.bls_power_binned

    def spy(*args, **kwargs):
        seen.append(str(kwargs.get("device")))
        return real(*args, **kwargs)

    monkeypatch.setattr(bls, "bls_power_binned", spy)
    t, f, e = transit_columns(n=300)
    lc = tlk.LightCurve(time=t, flux=f, flux_err=e)
    thtml.export_interact_bls_html(lc, str(tmp_path / "a.html"),
                                   resolution=50, refine_peaks=1,
                                   refine_factor=2)
    assert seen == ["cpu", "cpu"]
    monkeypatch.setattr(config, "default_device", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            thtml.export_interact_bls_html(lc, str(tmp_path / "b.html"),
                                           resolution=50)
        assert seen == ["cpu", "cpu"]


# ----------------------------------------------------------------------
# pixels: the selector and the sky view
# ----------------------------------------------------------------------
RA0, DEC0 = 80.0, -70.0


@pytest.fixture(scope="module")
def ffis(tmp_path_factory):
    """200 FFIs of 30 × 30 with a TAN WCS and two stars."""
    d = tmp_path_factory.mktemp("ffis")
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[:30, :30]
    paths = []
    for i in range(200):
        star = 4000 * (1 - 0.01 * (i % 37 < 3))
        img = (100 + star * np.exp(-((xx - 14.3) ** 2 + (yy - 15.6) ** 2)
                                   / 2.4)
               + 900 * np.exp(-((xx - 11.8) ** 2 + (yy - 13.1) ** 2) / 2.0)
               + rng.standard_normal((30, 30)))
        if i == 17:
            img[15, 14] = np.nan
        hdr = {"TELESCOP": "TESS", "TIME": 1600.0 + i * 0.02,
               "CADENCENO": i, "SECTOR": 9, "CRPIX1": 15.0,
               "CRPIX2": 15.0, "CRVAL1": RA0, "CRVAL2": DEC0,
               "CDELT1": -21.0 / 3600, "CDELT2": 21.0 / 3600,
               "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN"}
        p = os.path.join(d, f"ffi{i:03d}.fits")
        tfits.write_fits(tfits.HDUList([
            tfits.PrimaryHDU(), tfits.ImageHDU(
                data=img.astype(np.float32), header=tfits.Header(hdr))]), p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def tpfs(ffis):
    kw = dict(position=(RA0, DEC0), size=(9, 9), target_id="TIC 5")
    return (JTess.from_fits_images(ffis, **kw),
            TTess.from_fits_images(ffis, **kw))


@pytest.mark.parametrize("kw", [{}, {"aperture_mask": "threshold"},
                                {"aperture_mask": "all",
                                 "max_cadences": 64}])
def test_pixel_page_matches(tmp_path, tpfs, kw):
    jt, tt = tpfs
    assert tt.has_wcs
    paths = [str(tmp_path / "ref.html"), str(tmp_path / "port.html")]
    jhtml.export_interact_html(jt, paths[0], **kw)
    thtml.export_interact_html(tt, paths[1], **kw)
    pd, _ = assert_pages_equal(paths[1], paths[0])
    assert pd["shape"] == [9, 9] and len(pd["pix"]) == 81


def sky_catalog(tpf, n=10, seed=3):
    """``n`` sources on (and a little off) the stamp through the TPF's own
    WCS, with magnitudes, ids and proper motions for half of them."""
    rng = np.random.default_rng(seed)
    col, row = rng.uniform(-1.2, 9.3, n), rng.uniform(-1.2, 9.3, n)
    ra, dec = tpf.wcs.pixel_to_world(col, row)
    return {"ra": np.asarray(ra), "dec": np.asarray(dec),
            "mag": np.round(rng.uniform(9, 19, n), 2),
            "id": [f"Gaia {1000 + i}" for i in range(n)],
            "pmra": np.where(np.arange(n) % 2 == 0, rng.normal(0, 40, n), 0),
            "pmdec": np.where(np.arange(n) % 2 == 0, rng.normal(0, 40, n),
                              0)}


TICS = [{"tic": "111", "gaia_id": "1003", "tmag": 10.5},
        {"tic": "222", "ra": RA0 + 0.001, "dec": DEC0 - 0.001, "tmag": 12.0},
        {"TIC": "333", "GAIA": None, "ra": RA0, "dec": DEC0}]


@pytest.mark.parametrize("kw", [{}, {"tic_catalog": TICS},
                                {"magnitude_limit": 14.0,
                                 "aperture_mask": "threshold",
                                 "catalog_epoch": 2015.5}])
def test_sky_page_matches(tmp_path, tpfs, kw):
    jt, tt = tpfs
    cat = sky_catalog(jt)
    paths = [str(tmp_path / "ref.html"), str(tmp_path / "port.html")]
    jhtml.export_interact_sky_html(jt, paths[0], catalog=cat, **kw)
    thtml.export_interact_sky_html(tt, paths[1], catalog=cat, **kw)
    pd, rd = assert_pages_equal(paths[1], paths[0])
    assert len(pd["src"]) >= 3 and pd["pm"] is True


def test_merge_nearby_tics_matches():
    cat = {"ra": [1.0, 2.0], "dec": [3.0, 4.0], "source_id": ["1003", None]}
    got = tinteract.merge_nearby_tics(cat, TICS)
    want = jinteract.merge_nearby_tics(cat, TICS)
    assert got[1:] == want[1:]
    assert json.dumps(got[0], default=str) == json.dumps(want[0],
                                                         default=str)


def test_demo_catalog_is_the_ports_copy(tmp_path, tpfs):
    path = thtml.demo_sky_catalog()
    assert path.startswith(os.path.dirname(thtml.__file__))
    assert open(path).read() == open(jhtml.demo_sky_catalog()).read()
    jt, tt = tpfs
    paths = [str(tmp_path / "ref.html"), str(tmp_path / "port.html")]
    jhtml.export_interact_sky_html(jt, paths[0], catalog=path)
    thtml.export_interact_sky_html(tt, paths[1], catalog=path)
    assert_pages_equal(paths[1], paths[0])


# ----------------------------------------------------------------------
# the echelle explorer
# ----------------------------------------------------------------------
def spectra(seed=3):
    rng = np.random.default_rng(seed)
    freq = np.arange(1.0, 300.0, 0.05)
    comb = sum(np.exp(-0.5 * ((freq - k * 11.0) / 0.3) ** 2)
               for k in range(5, 25))
    pw = 1 + 50 * np.exp(-0.5 * ((freq - 150) / 30) ** 2) * comb \
        + 0.1 * rng.random(freq.size)
    return (JSNR(JQ(freq, JU.parse("uHz")), JQ(pw, None)),
            TSNR(TQ(freq, TU.parse("uHz")), TQ(pw, None)))


@pytest.mark.parametrize("kw", [dict(deltanu=11.0),
                                dict(deltanu=11.0, numax=150.0),
                                dict(deltanu=11.0, minimum_frequency=80,
                                     maximum_frequency=220,
                                     smooth_filter_width=0.5),
                                dict(deltanu=11.0, smooth_filter_width=0)])
def test_echelle_page_matches(tmp_path, kw):
    jp, tp = spectra()
    paths = [str(tmp_path / "ref.html"), str(tmp_path / "port.html")]
    jhtml.export_interact_echelle_html(jp.to_seismology(), paths[0], **kw)
    thtml.export_interact_echelle_html(tp.to_seismology(), paths[1], **kw)
    assert_pages_equal(paths[1], paths[0])


# ----------------------------------------------------------------------
# the html= routes
# ----------------------------------------------------------------------
def test_html_routes_reach_the_exporters(tmp_path, tpfs):
    """``interact_bls(html=…)`` writes the exporter's page at 20,000 base
    periods whatever ``resolution`` asks (the reference's rule; the page's
    agreement with the reference is held above, at sizes where no plateau
    of equal power reorders the refined peaks); the pixel, sky and echelle
    routes write the reference's pages."""
    t, f, e = transit_columns(n=400)
    lc = tlk.LightCurve(time=t, flux=f, flux_err=e)
    page = lc.interact_bls(html=str(tmp_path / "bls.html"), resolution=100)
    direct = thtml.export_interact_bls_html(lc, str(tmp_path / "direct.html"),
                                            resolution=20000)
    assert page.endswith("bls.html") and open(page).read() == \
        open(direct).read()
    ref = jlk.LightCurve(time=t, flux=f, flux_err=e).interact_bls(
        html=str(tmp_path / "ref.html"), resolution=100)
    _, pd, _ = split_page(open(page).read())
    _, rd, _ = split_page(open(ref).read())
    assert len(pd["p"]) == len(rd["p"]) >= 20000

    jt, tt = tpfs
    for name, kw in (("interact", {}),
                     ("interact_sky", {"catalog": sky_catalog(jt)})):
        paths = [getattr(tpf, name)(html=str(tmp_path / f"{name}{i}.html"),
                                    **kw)
                 for i, tpf in enumerate((jt, tt))]
        assert_pages_equal(paths[1], paths[0])

    jp, tp = spectra()
    paths = [p.to_seismology().interact_echelle(
        html=str(tmp_path / f"ech{i}.html")) for i, p in enumerate((jp, tp))]
    assert_pages_equal(paths[1], paths[0])
    m = re.search(r'value="([\d.e+-]+)"', open(paths[1]).read())
    assert float(m.group(1)) == pytest.approx(299.95 / 30, rel=1e-9)


def test_without_html_the_widgets_raise(tpfs):
    """Without ``html=`` the pixel selector and the echelle explorer draw
    the reference's static figures (test_torch_plots' axes signature), the
    BLS explorer its three panels (titles, labels and legends equal; the
    BLS numbers' parity is test_torch_periodogram's), and the sky view
    raises as the reference's does."""
    import matplotlib.pyplot as plt
    from test_torch_plots import assert_same_plot, signature
    t, f, e = transit_columns()
    figs = [pkg.LightCurve(time=t, flux=f, flux_err=e).interact_bls()
            for pkg in (jlk, tlk)]
    texts = [[{k: ax[k] for k in ("xlabel", "ylabel", "title", "legend")}
              for ax in signature(fig)["axes"]] for fig in figs]
    assert len(texts[1]) == 3 and texts[1] == texts[0]
    jt, tt = tpfs
    assert_same_plot(tt.interact(), jt.interact())
    jp, tp = spectra()
    assert_same_plot(tp.to_seismology().interact_echelle(),
                     jp.to_seismology().interact_echelle())
    for tpf in (jt, tt):
        with pytest.raises(NotImplementedError, match="bokeh"):
            tpf.interact_sky()
    for interact, tpf, err in (
            (jinteract, jt, jutils.LightkurveError),
            (tinteract, tt, tlk.LightkurveError)):
        with pytest.raises(err, match="bokeh"):
            interact.show_skyview_widget(tpf)
    plt.close("all")


def test_y_limits_and_preprocess_match():
    t, f, e = transit_columns(n=500)
    assert tinteract.get_lightcurve_y_limits(f) == pytest.approx(
        jinteract.get_lightcurve_y_limits(f), rel=1e-15)
    assert tinteract.get_lightcurve_y_limits({"flux": f}) == \
        tinteract.get_lightcurve_y_limits(f)
    a = tinteract._preprocess_lc_for_bls(tlk.LightCurve(time=t, flux=f * 7,
                                                        flux_err=e))
    b = jinteract._preprocess_lc_for_bls(jlk.LightCurve(time=t, flux=f * 7,
                                                        flux_err=e))
    for col in ("time", "flux", "flux_err"):
        np.testing.assert_array_equal(np.asarray(getattr(a, col).value),
                                      np.asarray(getattr(b, col).value))
    assert math.isfinite(float(np.nanmedian(a.flux.value)))
