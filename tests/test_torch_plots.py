"""lightkurve_tpu_torch's plots against lightkurve_tpu's.

Every plotting method of the JAX package is called in both packages on
the same seeded numpy input (matplotlib's Agg backend, set in conftest),
and the two figures are held to each other by their *axes signature*
(:func:`signature`): every axes of the figure (colour bars included) with
its lines' xy data, its collections' offsets, arrays and segments, its
images' arrays and extents, its patches, its labels, title, legend
entries, limits and scales.  Floats agree to 1e-12 of their array's
largest magnitude; strings are equal.

Where a plot draws numbers the package computes (a corrector's fit, a
seismic estimate's diagnostics, a PRF fit), the port's object is given
the JAX object's numbers first (:func:`port_lc` and the like), so the
comparison holds the plotting code itself; each computation's own parity
is in its module's test file.  Every test runs under :func:`tensor_trap`:
``torch.Tensor.__array__`` raises, so a tensor reaching matplotlib
without an explicit ``.cpu()`` copy fails here as it would on the card.
"""
import warnings
from copy import deepcopy

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from matplotlib.animation import FuncAnimation
from matplotlib.axes import Axes
from matplotlib.collections import LineCollection
from matplotlib.figure import Figure

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import periodogram as jpg
from lightkurve_tpu import prf as jprf
from lightkurve_tpu import units as ju
from lightkurve_tpu import utils as jutils
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import periodogram as tpg
from lightkurve_tpu_torch import prf as tprf
from lightkurve_tpu_torch import seismology as tseis
from lightkurve_tpu_torch import time as ttime
from lightkurve_tpu_torch import units as tu
from lightkurve_tpu_torch import utils as tutils

#: floats of a signature agree to this share of their array's largest
#: magnitude
SIG_RTOL = 1e-12


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's classes on the CPU in float64, as the reference runs here
    with x64 on."""
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


@pytest.fixture(autouse=True)
def tensor_trap(monkeypatch):
    """``np.asarray(tensor)`` raises, as it does for a CUDA tensor: a plot
    or an export must copy a tensor to the host explicitly."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor reached numpy without .cpu()")
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


# ---------------------------------------------------------------------------
# axes signatures
# ---------------------------------------------------------------------------
def _figure(obj):
    if isinstance(obj, FuncAnimation):
        return obj._fig
    if isinstance(obj, Figure):
        return obj
    if isinstance(obj, Axes):
        return obj.figure
    return np.asarray(obj, dtype=object).ravel()[0].figure


def _floats(x):
    a = np.ma.asarray(x)
    return np.ma.filled(a.astype(float), np.nan)


def _axes_signature(ax):
    sig = {"xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
           "title": ax.get_title(), "xlim": _floats(ax.get_xlim()),
           "ylim": _floats(ax.get_ylim()), "xscale": ax.get_xscale(),
           "yscale": ax.get_yscale(), "lines": [], "collections": [],
           "images": [], "patches": []}
    for line in ax.get_lines():
        sig["lines"].append({"xy": _floats(line.get_xydata()),
                             "label": line.get_label(),
                             "style": (line.get_linestyle(),
                                       str(line.get_marker()))})
    for c in ax.collections:
        entry = {"type": type(c).__name__, "label": c.get_label(),
                 "offsets": _floats(c.get_offsets())}
        if c.get_array() is not None:
            entry["array"] = _floats(c.get_array())
        if isinstance(c, LineCollection):
            entry["segments"] = [_floats(s) for s in c.get_segments()]
        sig["collections"].append(entry)
    for im in ax.get_images():
        sig["images"].append({"array": _floats(im.get_array()),
                              "extent": _floats(im.get_extent())})
    for p in ax.patches:
        sig["patches"].append({"type": type(p).__name__,
                               "bbox": _floats(p.get_bbox().bounds)})
    legend = ax.get_legend()
    sig["legend"] = [t.get_text() for t in legend.get_texts()] \
        if legend is not None else None
    return sig


def signature(obj):
    """The axes signature of the figure ``obj`` draws on (an Axes, an array
    of Axes, a Figure or an animation): one entry per axes in the figure's
    order, and the figure's title."""
    fig = _figure(obj)
    return {"suptitle": fig._suptitle.get_text() if fig._suptitle else None,
            "axes": [_axes_signature(ax) for ax in fig.axes]}


def assert_same(got, want, path="signature"):
    """``got`` equals ``want``: arrays to :data:`SIG_RTOL` of their largest
    magnitude (NaN where NaN), everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, (path, got.shape, want.shape)
        finite = np.abs(want[np.isfinite(want)])
        scale = finite.max() if finite.size else 0.0
        np.testing.assert_allclose(got, want, rtol=SIG_RTOL,
                                   atol=SIG_RTOL * scale, equal_nan=True,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def assert_same_plot(got, want):
    sig_got, sig_want = signature(got), signature(want)
    assert any(ax["lines"] or ax["collections"] or ax["images"]
               for ax in sig_want["axes"]), "nothing was drawn"
    assert_same(sig_got, sig_want)


# ---------------------------------------------------------------------------
# the same objects in both packages
# ---------------------------------------------------------------------------
def port_col(col):
    """A JAX package's column as the port's: Time, Quantity or array."""
    if isinstance(col, jlk.time.TimeDelta):
        return ttime.TimeDelta(np.asarray(col.value))
    if isinstance(col, jlk.Time):
        return ttime.Time(np.asarray(col.value), format=col.format,
                          scale=col.scale)
    if isinstance(col, ju.Quantity):
        return tu.Quantity(np.array(col.value), str(col.unit))
    return np.array(col)


def port_lc(jlc):
    """The port's light curve of the same class, columns and meta as the
    JAX package's ``jlc``."""
    cls = getattr(tlk.lightcurve, type(jlc).__name__)
    out = cls.__new__(cls)
    object.__setattr__(out, "meta", deepcopy(jlc.meta))
    object.__setattr__(out, "_cols", {k: port_col(v)
                                      for k, v in jlc._cols.items()})
    return out


def curve_columns(n=600, seed=5):
    """A TESS-like curve: a rotation, a 0.7-d transit, noise, NaNs, a
    quality flag and a centroid column."""
    rng = np.random.default_rng(seed)
    t = 1500.0 + np.arange(n) * (10.0 / 60 / 24)
    flux = 1000.0 * (1 + 0.003 * np.sin(2 * np.pi * t / 1.3))
    ph = np.mod(t - 1500.2 + 0.35, 0.7) - 0.35
    flux[np.abs(ph) < 0.04] *= 1 - 4e-3
    flux += rng.normal(0, 0.5, n)
    flux[rng.choice(n, 4, replace=False)] = np.nan
    err = np.full(n, 0.5)
    return t, flux, err


def lc_pair(n=600, seed=5, label="TIC 7", **meta):
    t, f, e = curve_columns(n, seed)
    out = []
    for pkg, units in ((jlk, ju), (tlk, tu)):
        lc = pkg.TessLightCurve(time=pkg.Time(t, format="btjd"),
                                flux=units.Quantity(f, "electron / s"),
                                flux_err=units.Quantity(e, "electron / s"),
                                meta={"LABEL": label, **meta})
        lc["quality"] = (np.arange(n) % 97 == 0).astype(np.int32)
        lc["centroid_col"] = units.Quantity(
            30 + 0.01 * np.sin(np.arange(n) / 20), "pix")
        out.append(lc)
    return out


# ---------------------------------------------------------------------------
# utils.plot_image
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, dict(scale="sqrt", title="sqrt"),
                                dict(scale="log", vmin=2.0),
                                dict(show_colorbar=False, origin="upper",
                                     clabel="e/s")])
def test_plot_image_equal(kw):
    img = np.random.default_rng(1).gamma(2.0, 50.0, (9, 7))
    img[2, 3] = np.nan
    want = jutils.plot_image(img, **kw)
    got = tutils.plot_image(torch.as_tensor(img), **kw)
    assert_same_plot(got, want)
    with pytest.raises(ValueError, match="scale"):
        tutils.plot_image(img, scale="cubic")


# ---------------------------------------------------------------------------
# LightCurve, FoldedLightCurve and the collections
# ---------------------------------------------------------------------------
LC_CASES = [
    ("plot", {}),
    ("plot", dict(normalize=True, title="normalized")),
    ("plot", dict(offset=3.0, label="offset", column="centroid_col")),
    ("scatter", {}),
    ("scatter", dict(c="k", s=2)),
    ("scatter", dict(colorbar_label="phase", marker="x")),
    ("errorbar", {}),
    ("errorbar", dict(yerr=2.0, ls="-", xlabel="t", ylabel="f")),
    ("plot_river", dict(period=0.7)),
    ("plot_river", dict(period=0.7, epoch_time=1500.2, method="median")),
    ("plot_river", dict(period=0.7, method="sigma", bin_points=3,
                        minimum_phase=-0.3, maximum_phase=0.3)),
    ("plot_river", dict(period=0.7, bin_points=10_000)),
]


@pytest.mark.parametrize("method,kw", LC_CASES)
def test_lightcurve_plots_equal(method, kw):
    jl, tl = lc_pair()
    if kw.get("colorbar_label"):
        kw = dict(kw, c=np.linspace(0, 1, len(jl)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = getattr(jl, method)(**kw)
        n_want = len(caught)
        got = getattr(tl, method)(**kw)
    assert_same_plot(got, want)
    # plot_river's bin_points reset warns in both packages
    assert [str(w.message) for w in caught[n_want:]] == \
        [str(w.message) for w in caught[:n_want]]


@pytest.mark.parametrize("method,kw", [
    ("plot", {}), ("scatter", dict(s=3)), ("errorbar", {}),
    ("plot_river", {}), ("plot_river", dict(method="median")),
])
@pytest.mark.parametrize("normalize_phase", [False, True])
def test_folded_plots_equal(method, kw, normalize_phase):
    jl, tl = lc_pair()
    fold = dict(period=0.7, epoch_time=1500.2,
                normalize_phase=normalize_phase)
    jf, tf = jl.fold(**fold), tl.fold(**fold)
    want = getattr(jf, method)(**kw)
    got = getattr(tf, method)(**kw)
    assert_same_plot(got, want)


def test_folded_plot_river_needs_a_period():
    jl, tl = lc_pair()
    for lc in (jl, tl):
        folded = lc.fold(period=0.7)
        folded.meta["PERIOD"] = None
        with pytest.raises(ValueError, match="period"):
            folded.plot_river()


def test_lightcurve_collection_plot_equal():
    pairs = [lc_pair(seed=s, label=f"TIC {s}") for s in range(3)]
    jc = jlk.LightCurveCollection([p[0] for p in pairs])
    tc = tlk.LightCurveCollection([p[1] for p in pairs])
    assert_same_plot(tc.plot(offset=5.0), jc.plot(offset=5.0))
    assert_same_plot(tc.plot(normalize=True, alpha=0.5),
                     jc.plot(normalize=True, alpha=0.5))


# ---------------------------------------------------------------------------
# periodograms
# ---------------------------------------------------------------------------
def periodogram_pair(cls="Periodogram", unit="1 / d", seed=2):
    rng = np.random.default_rng(seed)
    freq = np.linspace(0.05, 20.0, 700)
    power = rng.gamma(1.0, 1.0, freq.size) + 30 * np.exp(
        -0.5 * ((freq - 3.0) / 0.05) ** 2)
    return [getattr(pkg, cls)(units.Quantity(freq, unit),
                              units.Quantity(power, "electron / s"),
                              label="TIC 9")
            for pkg, units in ((jpg, ju), (tpg, tu))]


@pytest.mark.parametrize("kw", [
    {}, dict(view="period"), dict(scale="log"),
    dict(view="period", scale="log", xlabel="P", ylabel="A", title="t"),
    dict(label="", c="r"),
])
def test_periodogram_plot_equal(kw):
    jp, tp = periodogram_pair()
    assert_same_plot(tp.plot(**kw), jp.plot(**kw))


@pytest.mark.parametrize("kw", [{}, dict(view="frequency"),
                                dict(ylabel="power")])
def test_bls_periodogram_plot_equal(kw):
    jl, tl = lc_pair()
    grid = dict(period=np.linspace(0.5, 1.5, 400), duration=[0.05, 0.08])
    jp = jl.normalize().to_periodogram("bls", **grid)
    tp = tl.normalize().to_periodogram("bls", **grid)
    # the plot of the JAX package's numbers (the BLS's own parity is
    # test_torch_periodogram's)
    tp.power = tu.Quantity(np.array(jp.power.value), str(jp.power.unit))
    assert_same_plot(tp.plot(**kw), jp.plot(**kw))
    assert tp.plot().get_ylabel() == jp.plot().get_ylabel() == "BLS Power"


# ---------------------------------------------------------------------------
# target pixel files and the explorers' static panels
# ---------------------------------------------------------------------------
def tpf_pair(mission="TESS", **kw):
    from test_torch_tpf import make_both
    return make_both(mission, **kw)


@pytest.mark.parametrize("kw", [
    {}, dict(frame=7, aperture_mask="pipeline", mask_color="red"),
    dict(cadenceno=130, bkg=True, show_colorbar=False, title="t"),
    dict(column="FLUX_ERR", aperture_mask="all", cmap="gray"),
])
@pytest.mark.parametrize("mission", ["TESS", "K2"])
def test_tpf_plot_equal(kw, mission):
    jt, tt = tpf_pair(mission)
    assert_same_plot(tt.plot(**kw), jt.plot(**kw))


@pytest.mark.parametrize("kw", [
    {}, dict(normalize=True, aperture_mask="pipeline", title="pixels"),
    dict(markersize=2, color="k"),
])
def test_tpf_plot_pixels_equal(kw):
    jt, tt = tpf_pair(shape=(4, 3))
    assert_same_plot(tt.plot_pixels(**kw), jt.plot_pixels(**kw))


def test_tpf_plot_pixels_periodograms_equal(monkeypatch):
    """``periodogram=True``: each pixel's periodogram drawn; the
    periodograms come from one numpy stand-in in both packages, so the
    plots, not the Lomb-Scargle (test_torch_lombscargle's), are held."""
    def stand_in(pkg, units):
        def to_periodogram(self, *args, **kwargs):
            f = np.fft.rfftfreq(len(self), 0.02)[1:]
            p = np.abs(np.fft.rfft(np.asarray(self.flux.value)))[1:]
            return pkg.periodogram.Periodogram(units.Quantity(f, "1 / d"),
                                               units.Quantity(p, ""))
        return to_periodogram
    monkeypatch.setattr(jlk.LightCurve, "to_periodogram", stand_in(jlk, ju))
    monkeypatch.setattr(tlk.LightCurve, "to_periodogram", stand_in(tlk, tu))
    jt, tt = tpf_pair(shape=(3, 3))
    assert_same_plot(tt.plot_pixels(periodogram=True),
                     jt.plot_pixels(periodogram=True))


@pytest.mark.parametrize("kw", [{}, dict(step=7, interval=50, cmap="gray")])
def test_tpf_animate_equal(kw):
    jt, tt = tpf_pair()
    ja, ta = jt.animate(**kw), tt.animate(**kw)
    assert ta._interval == ja._interval
    frames = list(ja.new_frame_seq())
    assert list(ta.new_frame_seq()) == frames and len(frames) > 1
    for i in frames:
        ta._func(i)
        ja._func(i)
        assert_same_plot(ta, ja)


def test_tpf_collection_plot_equal():
    pairs = [tpf_pair(seed=s) for s in range(2)]
    for n in (1, 2):
        jc = jlk.TargetPixelFileCollection([p[0] for p in pairs[:n]])
        tc = tlk.TargetPixelFileCollection([p[1] for p in pairs[:n]])
        assert_same_plot(tc.plot(), jc.plot())


@pytest.mark.parametrize("kw", [
    {}, dict(aperture_mask="all", ylim_func=lambda lc: (0, 2e5)),
    dict(aperture_mask=np.zeros((9, 8), bool)),
    dict(transform_func=lambda lc: lc.normalize()),
])
def test_interact_static_panel_equal(kw, tmp_path):
    jt, tt = tpf_pair()
    assert_same_plot(tt.interact(**kw), jt.interact(**kw))
    got = tt.interact(exported_filename=str(tmp_path / "port"))
    want = jt.interact(exported_filename=str(tmp_path / "jax"))
    assert_same_plot(got, want)
    a = tlk.read(str(tmp_path / "port.fits"))
    b = jlk.read(str(tmp_path / "jax.fits"))
    np.testing.assert_allclose(a.flux.value, b.flux.value, rtol=1e-12)


def test_interact_bls_static_panels_equal(monkeypatch):
    """The three panels of ``interact_bls()`` without ``html=``; the BLS
    periodogram the panels read is the JAX package's in both (its parity
    is test_torch_periodogram's)."""
    jl, tl = lc_pair(n=900)
    real = tlk.LightCurve.to_periodogram
    seen = []

    def jax_numbers(self, *args, **kwargs):
        pg = real(self, *args, **kwargs)
        jpg_ = port_to_jax(self).to_periodogram(*args, **kwargs)
        for name in ("power", "duration", "transit_time", "depth"):
            col = getattr(jpg_, name)
            setattr(pg, name, tu.Quantity(np.array(col.value), str(col.unit))
                    if isinstance(col, ju.Quantity) else np.array(col))
        seen.append(pg)
        return pg
    monkeypatch.setattr(tlk.LightCurve, "to_periodogram", jax_numbers)
    kw = dict(minimum_period=0.5, maximum_period=1.5, resolution=300)
    want = jl.interact_bls(**kw)
    got = tl.interact_bls(**kw)
    assert len(seen) == 1
    assert_same_plot(got, want)


def port_to_jax(tlc):
    """The JAX package's light curve with ``tlc``'s columns and meta."""
    cls = getattr(jlk.lightcurve, type(tlc).__name__)
    out = cls.__new__(cls)
    cols = {}
    for k, v in tlc._cols.items():
        if isinstance(v, ttime.Time):
            cols[k] = jlk.Time(np.asarray(v.value), format=v.format,
                               scale=v.scale)
        elif isinstance(v, tu.Quantity):
            cols[k] = ju.Quantity(np.array(v.value), str(v.unit))
        else:
            cols[k] = np.array(v)
    object.__setattr__(out, "meta", deepcopy(tlc.meta))
    object.__setattr__(out, "_cols", cols)
    return out


# ---------------------------------------------------------------------------
# seismology
# ---------------------------------------------------------------------------
def port_value(v):
    """A JAX package's value (a Quantity, an array, a number) as the
    port's."""
    if isinstance(v, ju.Quantity):
        return tu.Quantity(np.array(v.value), str(v.unit))
    return np.array(v) if isinstance(v, np.ndarray) else v


def port_estimate(jq, plot_method):
    """The port's SeismologyQuantity with the JAX estimate's value, error
    and diagnostics."""
    return tseis.SeismologyQuantity(
        port_value(ju.Quantity(jq.value, jq.unit)), name=jq.name,
        error=jq.error, method=jq.method,
        diagnostics={k: port_value(v) for k, v in jq.diagnostics.items()},
        diagnostics_plot_method=plot_method)


def seismology_pair():
    from test_torch_seismology import comb
    j, t = comb(220.0, 16.97, seed=9)
    js, ts = jlk.Seismology(j), tseis.Seismology(t)
    js.estimate_numax()
    js.estimate_deltanu()
    ts.numax = port_estimate(js.numax, tlk.diagnose_numax_acf2d)
    ts.deltanu = port_estimate(js.deltanu, tlk.diagnose_deltanu_acf2d)
    return js, ts


@pytest.mark.parametrize("kw", [
    {}, dict(scale="log", cmap="viridis"),
    dict(deltanu=15.0, numax=200.0, smooth_filter_width=0),
    dict(minimum_frequency=150.0, maximum_frequency=300.0),
])
def test_plot_echelle_equal(kw):
    js, ts = seismology_pair()
    assert_same_plot(ts.plot_echelle(**kw), js.plot_echelle(**kw))


def test_seismology_diagnostics_equal():
    js, ts = seismology_pair()
    assert_same_plot(ts.diagnose_numax(), js.diagnose_numax())
    assert_same_plot(ts.diagnose_deltanu(), js.diagnose_deltanu())
    assert_same_plot(ts.numax.plot_diagnostics(periodogram=ts.periodogram),
                     js.numax.plot_diagnostics(periodogram=js.periodogram))
    assert_same_plot(tlk.diagnose_deltanu_acf2d(ts.deltanu),
                     jlk.diagnose_deltanu_acf2d(js.deltanu))
    assert_same_plot(tlk.diagnose_numax_acf2d(ts.numax),
                     jlk.diagnose_numax_acf2d(js.numax))
    for s in (js, ts):
        with pytest.raises(ValueError, match="No diagnostics"):
            type(s.numax)(s.numax).plot_diagnostics()


@pytest.mark.parametrize("estimated", [True, False])
@pytest.mark.parametrize("kw", [{}, dict(n_panels=3, cmap="Greys",
                                         scale="log")])
def test_interact_echelle_static_equal(estimated, kw):
    js, ts = seismology_pair()
    if not estimated:
        for s in (js, ts):
            del s.deltanu
    assert_same_plot(ts.interact_echelle(**kw), js.interact_echelle(**kw))


# ---------------------------------------------------------------------------
# correctors
# ---------------------------------------------------------------------------
def design_matrices(seed=4, n=150):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4))
    out = []
    for pkg in (jlk, tlk):
        a = pkg.DesignMatrix(X, name="a", prior_mu=np.arange(4.0),
                             prior_sigma=[1.0, np.inf, 0.5, 2.0])
        b = pkg.DesignMatrix(X[:, :2] ** 2, name="b")
        out.append((a, b, pkg.DesignMatrixCollection([a, b])))
    return out


@pytest.mark.parametrize("method", ["plot", "plot_priors"])
def test_design_matrix_plots_equal(method):
    (ja, jb, jc), (ta, tb, tc) = design_matrices()
    for j, t in ((ja, ta), (jb, tb), (jc, tc)):
        assert_same_plot(getattr(t, method)(), getattr(j, method)())
    kw = dict(cmap="gray") if method == "plot" else {}
    assert_same_plot(getattr(ta, method)(**kw), getattr(ja, method)(**kw))


#: the fitted state a corrector's diagnostic plots draw
FIT_STATE = ("coefficients", "outlier_mask", "cadence_mask", "window_points",
             "arclength", "pld_aperture_mask", "background_aperture_mask",
             "aperture_mask")


def give_port_the_fit(tc, jc):
    """The port's corrector with the JAX corrector's fitted state: light
    curves by :func:`port_lc`, arrays copied."""
    for name in ("lc", "corrected_lc", "model_lc"):
        setattr(tc, name, port_lc(getattr(jc, name)))
    tc.diagnostic_lightcurves = {k: port_lc(v) for k, v in
                                 jc.diagnostic_lightcurves.items()}
    for name in FIT_STATE:
        if getattr(jc, name, None) is not None:
            setattr(tc, name, np.array(getattr(jc, name)))


def regression_pair():
    from test_torch_correctors import regression_lc
    out = []
    for pkg in (jlk, tlk):
        lc = regression_lc(pkg, np.random.default_rng(6))
        tv = lc.time.value
        dm = pkg.DesignMatrix(np.stack([np.sin(2 * np.pi * tv / 3.7),
                                        np.cos(2 * np.pi * tv / 3.7)], 1),
                              name="sys", prior_sigma=np.full(2, 100.0))
        spline = pkg.correctors.create_spline_matrix(tv, n_knots=6)
        rc = pkg.RegressionCorrector(lc)
        mask = np.ones(len(lc), bool)
        mask[100:120] = False
        rc.correct(pkg.DesignMatrixCollection([dm, spline]),
                   cadence_mask=mask, sigma=3, niters=4)
        out.append(rc)
    give_port_the_fit(out[1], out[0])
    return out


@pytest.mark.parametrize("method", ["diagnose", "diagnose_priors"])
def test_regression_corrector_plots_equal(method):
    jr, tr = regression_pair()
    assert_same_plot(getattr(tr, method)(), getattr(jr, method)())
    for pkg in (jlk, tlk):
        fresh = pkg.RegressionCorrector(jlk.LightCurve(
            time=[1.0, 2.0], flux=[1.0, 2.0]) if pkg is jlk else
            tlk.LightCurve(time=[1.0, 2.0], flux=[1.0, 2.0]))
        with pytest.raises(ValueError, match="correct"):
            getattr(fresh, method)()


@pytest.mark.parametrize("mission", ["TESS", "K2"])
def test_pld_corrector_plots_equal(mission):
    from test_torch_correctors import pld_tpfs
    j, t = pld_tpfs(mission)
    jp, tp = jlk.PLDCorrector(j), tlk.PLDCorrector(t)
    for p in (jp, tp):
        with pytest.raises(ValueError, match="correct"):
            p.diagnose()
        with pytest.raises(ValueError, match="correct"):
            p.diagnose_masks()
    jp.correct(pld_order=1, pca_components=3)
    tp.correct(pld_order=1, pca_components=3)
    give_port_the_fit(tp, jp)
    assert_same_plot(tp.diagnose(), jp.diagnose())
    assert_same_plot(tp.diagnose_masks(), jp.diagnose_masks())


def test_sff_corrector_plots_equal():
    from test_torch_correctors import sff_lcs
    j, t = sff_lcs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc, tc = j.to_corrector("sff"), t.to_corrector("sff")
        jc.correct(windows=10, bins=4)
        tc.correct(windows=10, bins=4)
    give_port_the_fit(tc, jc)
    assert_same_plot(tc.diagnose(), jc.diagnose())
    assert_same_plot(tc.diagnose_arclength(), jc.diagnose_arclength())


@pytest.fixture(scope="module")
def cbv_files(tmp_path_factory):
    from test_torch_cbv import write_lc, write_tess_cbvs, tess_vectors
    root = tmp_path_factory.mktemp("cbv_plots")
    return {"tess": write_tess_cbvs(str(root / "tess")),
            "tess_lc": write_lc(str(root / "tess_lc.fits"), "TESS",
                                tess_vectors(), 1, SECTOR=10, CAMERA=2,
                                CCD=4)}


def cbv_pair(cbv_files):
    out = []
    for pkg in (jlk, tlk):
        lc = pkg.read(cbv_files["tess_lc"], flux_column="sap_flux")
        out.append(lc.to_corrector("cbv", cbv_dir=cbv_files["tess"]))
    return out


@pytest.mark.parametrize("kw", [{}, dict(cbv_indices=[1, 3, 9]),
                                dict(cbv_indices="all", lw=0.5)])
def test_cbv_plot_equal(cbv_files, kw):
    jc, tc = cbv_pair(cbv_files)
    for a, b in zip(jc.cbvs, tc.cbvs):
        assert_same_plot(b.plot(**kw), a.plot(**kw))
    for bad in ("some", [0, 1]):
        for c in (jc, tc):
            with pytest.raises(ValueError):
                c.cbvs[0].plot(cbv_indices=bad)


def test_cbv_diagnose_equal(cbv_files):
    jc, tc = cbv_pair(cbv_files)
    kw = dict(cbv_type=["SingleScale"], cbv_indices=["ALL"], alpha=1e-2)
    jc.correct_gaussian_prior(**kw)
    tc.correct_gaussian_prior(**kw)
    give_port_the_fit(tc, jc)
    assert_same_plot(tc.diagnose(), jc.diagnose())


def test_cbv_goodness_metric_scan_plot_equal(cbv_files, monkeypatch):
    """The scan's plot over nine α; both packages' metrics are one
    stand-in reading the prior width each fit used (the metrics' own
    parity is test_torch_cbv's), and the under-fitting metric raises on
    one α in both, which the scan draws as NaN."""
    jc, tc = cbv_pair(cbv_files)
    for c in (jc, tc):
        def over(n_samples=10, c=c):
            return float(np.log10(c.design_matrix_collection.matrices[0]
                                  .prior_sigma[0]))

        def under(neighbor_flux=None, c=c):
            sigma = c.design_matrix_collection.matrices[0].prior_sigma[0]
            if sigma > 1e3:
                raise ValueError("stand-in failure")
            return 1.0 / (1.0 + sigma)
        monkeypatch.setattr(c, "over_fitting_metric", over)
        monkeypatch.setattr(c, "under_fitting_metric", under)
    kw = dict(cbv_type=["SingleScale"], cbv_indices=["ALL"])
    assert_same_plot(tc.goodness_metric_scan_plot(**kw),
                     jc.goodness_metric_scan_plot(**kw))


# ---------------------------------------------------------------------------
# PRF photometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["gaussian", "simple_kepler", "kepler"])
def test_prf_model_plot_equal(kind, tmp_path):
    from test_torch_prf import make_prf, write_calibration
    prf_dir = write_calibration(str(tmp_path), 56) if kind == "kepler" \
        else None
    j, t = make_prf("jax", kind, prf_dir), make_prf("torch", kind, prf_dir)
    assert isinstance(t.evaluate(7.0, 5.0), torch.Tensor)
    assert_same_plot(t.plot(), j.plot())
    assert_same_plot(t.plot(cmap="gray"), j.plot(cmap="gray"))


def prf_pair(n=6):
    from test_torch_prf import noisy, scene
    models = {"jax": scene("jax"), "torch": scene("torch")}
    truth = models["jax"].initial_guess()
    cube = noisy(np.asarray(models["jax"].predict_from_array(truth)), n)
    return models, cube


@pytest.mark.parametrize("kw", [{}, dict(scale="sqrt", cmap="viridis")])
def test_tpf_model_plots_equal(kw, monkeypatch):
    models, cube = prf_pair()
    j, t = models["jax"], models["torch"]
    assert_same_plot(t.plot(**kw), j.plot(**kw))
    p = j.initial_guess() * 1.01
    assert_same_plot(t.plot(p, **kw), j.plot(p, **kw))
    # plot_diagnostics fits the image: both fits give the JAX fit's
    # numbers (the fit's parity is test_torch_prf's)
    fitted = j.fit(cube[0])
    monkeypatch.setattr(j, "fit", lambda data: fitted)
    monkeypatch.setattr(t, "fit", lambda data: t.get_initial_guesses()
                        .from_array(fitted.to_array()))
    want = j.plot_diagnostics(cube[0], **kw)
    got = t.plot_diagnostics(torch.as_tensor(cube[0]), **kw)
    np.testing.assert_array_equal(got.to_array(), want.to_array())
    assert_same_plot(plt.gcf(), plt.figure(plt.get_fignums()[-2]))


def test_prf_photometry_plot_results_equal():
    models, cube = prf_pair()
    j = jprf.PRFPhotometry(models["jax"])
    t = tprf.PRFPhotometry(models["torch"])
    for p in (j, t):
        with pytest.raises(ValueError, match="run"):
            p.plot_results()
    j.run(cube, n_iter=5)
    t.run(cube, n_iter=5)
    # the JAX fit's numbers in the port (the fit's parity is
    # test_torch_prf's)
    t.opt_params, t.losses = j.opt_params.copy(), np.array(j.losses)
    t._results = None
    for star in (0, 1):
        assert_same_plot(t.plot_results(star), j.plot_results(star))
    np.testing.assert_allclose(t.get_residual_image(torch.as_tensor(cube), 2),
                               j.get_residual_image(cube, 2), rtol=1e-12,
                               atol=1e-12 * np.abs(cube).max())
