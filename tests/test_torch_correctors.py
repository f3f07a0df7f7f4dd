"""lightkurve_tpu_torch's correctors against lightkurve_tpu's, on the same
numpy inputs on the CPU (the reference with x64 on; the port's
configuration set to the CPU and float64 by the ``port_on_cpu`` fixture;
every PCA on JAX's Gaussian draw, the port's draw function patched).

Bars:
- equal: design-matrix construction, ``standardize``, ``append_constant``,
  ``split``, ``validate``'s warnings and errors, the dense and sparse
  spline bases, the collections, the SFF window points and thruster
  firings;
- rtol 1e-10: ``DesignMatrix.pca`` (each column's sign aligned);
- rtol 1e-9: ``RegressionCorrector.correct`` (its coefficients, model,
  corrected flux and outlier mask), ``PLDCorrector.correct`` on Kepler
  (K2) and TESS pixel files (NaN ``flux_err`` cases included),
  ``SFFCorrector.correct`` and the over-fitting metric;
- PLD at K2's defaults, whose 16 components per order are mostly noise
  with near-equal singular values: within 4 times the reference's own
  change under a one-ulp jolt of the pixels.
"""
import warnings

import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import correctors as jcor
from lightkurve_tpu.correctors import metrics as jmetrics
from lightkurve_tpu.correctors import sffcorrector as jsff
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import correctors as tcor
from lightkurve_tpu_torch import targetpixelfile as ttpf
from lightkurve_tpu_torch.correctors import metrics as tmetrics
from lightkurve_tpu_torch.correctors import sffcorrector as tsff
from lightkurve_tpu_torch.ops import solve as tsolve
from synthetic import make_synthetic_tpf, sawtooth_motion
from test_torch_solve import align_signs, jax_draw

RTOL = 1e-9
PCA_TOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu_with_jax_draw(monkeypatch):
    """The port on the CPU in float64, its PCA on JAX's Gaussian draw."""
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)
    monkeypatch.setattr(tsolve, "gaussian_test_matrix", jax_draw)


def values(x):
    return np.asarray(getattr(x, "value", x))


def assert_lc_close(a, b, rtol=RTOL, atol=1e-12):
    assert type(a).__name__ == type(b).__name__
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        va, vb = values(a[name]), values(b[name])
        if va.dtype.kind == "f":
            np.testing.assert_allclose(vb, va, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(vb, va, err_msg=name)


def assert_dm_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(b.values, a.values)
    assert list(b.columns) == list(a.columns)
    assert b.name == a.name
    np.testing.assert_array_equal(b.prior_mu, a.prior_mu)
    np.testing.assert_array_equal(b.prior_sigma, a.prior_sigma)


def port_twin(jtpf):
    """The port's TPF of a JAX TPF's arrays."""
    cls = getattr(ttpf, type(jtpf).__name__)
    tpf = cls._from_arrays({k: v.copy() for k, v in jtpf._columns.items()},
                           dict(jtpf.meta), ext_header=dict(jtpf._ext_header),
                           aperture=jtpf._aperture.copy(),
                           quality_bitmask="none")
    return tpf


def matrix(rng, n=120, k=5):
    X = rng.standard_normal((n, k))
    X[rng.random((n, k)) < 0.1] = 0.0
    X[:, 2] = 3.0                                   # a constant column
    return X


@pytest.mark.parametrize("sparse", [False, True])
def test_design_matrix_transforms_equal(sparse):
    rng = np.random.default_rng(1)
    X = matrix(rng)
    kind = "SparseDesignMatrix" if sparse else "DesignMatrix"
    kw = dict(name="m", prior_mu=np.arange(5.0), prior_sigma=np.ones(5) * 2)
    j, t = getattr(jcor, kind)(X, **kw), getattr(tcor, kind)(X, **kw)
    assert_dm_equal(j, t)
    assert_dm_equal(j.standardize(), t.standardize())
    assert_dm_equal(j.append_constant(), t.append_constant())
    assert_dm_equal(j.split([30, 80]), t.split([30, 80]))
    assert_dm_equal(j.split(50), t.split(50))
    assert t.rank == j.rank
    np.testing.assert_array_equal(t[3], j[3])
    for bad in (dict(prior_sigma=np.zeros(5)), dict(prior_mu=np.ones(2))):
        for mod in (jcor, tcor):
            with pytest.raises(ValueError):
                getattr(mod, kind)(X, **bad).validate()


def test_design_matrix_low_rank_warns_in_both():
    X = np.ones((50, 6))
    for mod in (jcor, tcor):
        with pytest.warns(Warning, match="low rank"):
            mod.DesignMatrix(X).validate()


@pytest.mark.parametrize("nterms", [2, 4])
def test_design_matrix_pca_matches_jax(nterms):
    rng = np.random.default_rng(2)
    base = rng.standard_normal((200, 3))
    X = base @ rng.standard_normal((3, 12)) + 0.01 * rng.standard_normal(
        (200, 12))
    j, t = jcor.DesignMatrix(X, name="p").pca(nterms), \
        tcor.DesignMatrix(X, name="p").pca(nterms)
    assert t.shape == j.shape and t.name == j.name
    np.testing.assert_allclose(align_signs(t.values, j.values), j.values,
                               rtol=0, atol=PCA_TOL)


@pytest.mark.parametrize("kw", [dict(n_knots=8), dict(n_knots=6, degree=2),
                                dict(knots=[0.3, 0.5, 0.9]),
                                dict(n_knots=7, include_intercept=False)])
def test_spline_matrices_equal(kw):
    x = np.sort(np.random.default_rng(3).uniform(0, 1.2, 150))
    assert_dm_equal(jcor.create_spline_matrix(x, **kw),
                    tcor.create_spline_matrix(x, **kw))
    kw.pop("include_intercept", None)
    assert_dm_equal(jcor.create_sparse_spline_matrix(x, **kw),
                    tcor.create_sparse_spline_matrix(x, **kw))


@pytest.mark.parametrize("sparse", [False, True])
def test_design_matrix_collections_equal(sparse):
    rng = np.random.default_rng(4)
    kind = "SparseDesignMatrix" if sparse else "DesignMatrix"
    coll = "SparseDesignMatrixCollection" if sparse \
        else "DesignMatrixCollection"
    parts = []
    for mod in (jcor, tcor):
        a = getattr(mod, kind)(matrix(np.random.default_rng(5)), name="a",
                               prior_sigma=np.full(5, 3.0))
        b = getattr(mod, kind)(rng.standard_normal((120, 2)), name="b")
        parts.append(getattr(mod, coll)([a, b]))
        rng = np.random.default_rng(4)
    j, t = parts
    np.testing.assert_array_equal(t.values, j.values)
    np.testing.assert_array_equal(t.prior_mu, j.prior_mu)
    np.testing.assert_array_equal(t.prior_sigma, j.prior_sigma)
    np.testing.assert_array_equal(t.columns, j.columns)
    assert_dm_equal(j.to_designmatrix(), t.to_designmatrix())
    assert_dm_equal(j["b"], t["b"])
    for a, b in zip(j.split([40]).matrices, t.split([40]).matrices):
        assert_dm_equal(a, b)
    for a, b in zip(j.standardize().matrices, t.standardize().matrices):
        assert_dm_equal(a, b)
    j.validate()
    t.validate()


def regression_lc(mod, rng, n=400):
    t = np.arange(n) * 0.02
    flux = 1000.0 + 8.0 * np.sin(2 * np.pi * t / 3.7) + rng.standard_normal(n)
    flux[rng.random(n) < 0.02] += 30.0
    return mod.LightCurve(time=t, flux=flux, flux_err=np.ones(n))


@pytest.mark.parametrize("propagate_errors", [False, True])
def test_regression_corrector_matches_jax(propagate_errors):
    out = []
    for mod, cor in ((jlk, jcor), (tlk, tcor)):
        rng = np.random.default_rng(6)
        lc = regression_lc(mod, rng)
        tv = lc.time.value
        dm = cor.DesignMatrix(np.stack([np.sin(2 * np.pi * tv / 3.7),
                                        np.cos(2 * np.pi * tv / 3.7)], 1),
                              name="sys", prior_sigma=np.full(2, 100.0))
        # the B-spline basis sums to one: it carries the offset, so no
        # constant column (with one the system is singular and its
        # coefficients, not its model, depend on the solver)
        spline = cor.create_spline_matrix(tv, n_knots=6)
        rc = cor.RegressionCorrector(lc)
        mask = np.ones(len(lc), bool)
        mask[100:120] = False
        clc = rc.correct(cor.DesignMatrixCollection([dm, spline]),
                         cadence_mask=mask, sigma=3, niters=4,
                         propagate_errors=propagate_errors, seed=3)
        out.append((rc, clc))
    (jr, jc), (tr, tc) = out
    assert_lc_close(jc, tc)
    assert_lc_close(jr.model_lc, tr.model_lc)
    np.testing.assert_array_equal(tr.outlier_mask, jr.outlier_mask)
    assert tr.outlier_mask.sum() > 0
    np.testing.assert_allclose(tr.coefficients, jr.coefficients, rtol=RTOL)
    np.testing.assert_allclose(tr.coefficients_err, jr.coefficients_err,
                               rtol=RTOL, equal_nan=True)
    for k in jr.diagnostic_lightcurves:
        assert_lc_close(jr.diagnostic_lightcurves[k],
                        tr.diagnostic_lightcurves[k])
    # the under-fitting metric without neighbours searches the archive by
    # the target's TARGETID, which this curve lacks: refused alike
    for mod, r in ((jmetrics, jr), (tmetrics, tr)):
        with pytest.raises(mod.MinTargetsError, match="TARGETID"):
            r.compute_underfit_metric()
    # the diagnostic plot of the JAX fit's numbers in both packages
    # (test_torch_plots holds every corrector plot)
    from test_torch_plots import assert_same_plot, give_port_the_fit
    give_port_the_fit(tr, jr)
    assert_same_plot(tr.diagnose(), jr.diagnose())
    import matplotlib.pyplot as plt
    plt.close("all")


def pld_tpfs(mission, **kw):
    if mission == "K2":
        j = make_synthetic_tpf(n_cadences=300, shape=(7, 7), mission="K2",
                               motion=sawtooth_motion(amp_col=0.4),
                               noise=0.5, star_flux=8000.0, seed=3, **kw)
    else:
        j = make_synthetic_tpf(n_cadences=300, shape=(7, 7), mission="TESS",
                               noise=0.5, star_flux=8000.0, seed=4, **kw)
        tv = np.asarray(j.time.value)
        j.flux = np.asarray(j.flux.value) + (
            40.0 * np.sin(2 * np.pi * (tv - tv[0]) / 1.3) ** 2)[:, None, None]
    return j, port_twin(j)


#: PLD settings whose kept components stand apart in the pixels' spectrum
PLD_SETTINGS = [dict(pld_order=1, pca_components=3),
                dict(pld_order=2, pca_components=4, restore_trend=False),
                dict(pld_aperture_mask="all", pld_order=1, sparse=True)]


@pytest.mark.parametrize("mission, kw", [("TESS", {})] + [
    (mission, kw) for mission in ("K2", "TESS") for kw in PLD_SETTINGS])
def test_pld_corrector_matches_jax(mission, kw):
    """Corrected flux, model and per-submatrix models within rtol 1e-9
    (absolute: 1e-9 of the median flux).  The K2 defaults (orders to 3,
    16 components each) have their own test below.  The coefficients are
    not compared: the spline basis sums to one beside the constant
    column, so only the priors fix the split between them, a direction
    the model does not see."""
    j, t = pld_tpfs(mission)
    jp, tp = jcor.PLDCorrector(j), tcor.PLDCorrector(t)
    assert_lc_close(jp.lc, tp.lc)
    jc, tc = jp.correct(**kw), tp.correct(**kw)
    atol = RTOL * np.median(jc.flux.value)
    assert_lc_close(jc, tc, atol=atol)
    assert_lc_close(jp.model_lc, tp.model_lc, atol=atol)
    for k in jp.diagnostic_lightcurves:
        assert_lc_close(jp.diagnostic_lightcurves[k],
                        tp.diagnostic_lightcurves[k], atol=atol)
    np.testing.assert_array_equal(tp.pld_aperture_mask, jp.pld_aperture_mask)
    np.testing.assert_array_equal(tp.outlier_mask, jp.outlier_mask)


def test_pld_corrector_k2_defaults_within_the_references_own_spread():
    """K2's defaults keep 16 components of each order, most of them noise
    with near-equal singular values, and the last order-1 component is
    the rounding noise of the normalised pixels' zero sum: there the
    SVD's vectors turn on rounding, and the reference's own corrected flux moves by ``spread`` (of
    the median flux) when the pixels move by one ulp.  The port, whose
    LAPACK rounds differently, must lie within 4 ``spread`` of it, and
    both must lower the CDPP of the raw aperture flux."""
    j, t = pld_tpfs("K2")
    want = jcor.PLDCorrector(j).correct()
    got = tcor.PLDCorrector(t).correct()
    jolted, _ = pld_tpfs("K2")
    jolted.flux = np.asarray(jolted.flux.value) * (1 + 2.0 ** -52)
    again = jcor.PLDCorrector(jolted).correct()
    scale = np.median(want.flux.value)
    spread = np.max(np.abs(again.flux.value - want.flux.value)) / scale
    gap = np.max(np.abs(got.flux.value - want.flux.value)) / scale
    assert 0 < spread < 1e-2
    assert gap <= 4 * spread, (gap, spread)
    raw = t.to_lightcurve(aperture_mask="threshold").estimate_cdpp()
    assert got.estimate_cdpp() < raw


def test_pld_corrector_nan_flux_err_like_jax():
    """All-NaN flux_err raises in both; some NaN drops those cadences in
    both, and the corrections agree."""
    for mod in ("jax", "port"):
        j, t = pld_tpfs("K2")
        tpf = j if mod == "jax" else t
        tpf.flux_err = np.full(tpf.shape, np.nan)
        with pytest.raises(ValueError):
            (jcor if mod == "jax" else tcor).PLDCorrector(tpf).correct()
    j, t = pld_tpfs("K2")
    for tpf in (j, t):
        ferr = np.asarray(tpf.flux_err.value).copy()
        ferr[::7] = np.nan
        tpf.flux_err = ferr
    jp, tp = jcor.PLDCorrector(j), tcor.PLDCorrector(t)
    assert len(tp.lc) == len(jp.lc) == 300 - len(range(0, 300, 7))
    jc, tc = jp.correct(**PLD_SETTINGS[0]), tp.correct(**PLD_SETTINGS[0])
    assert_lc_close(jc, tc, atol=RTOL * np.median(jc.flux.value))


def sff_lcs(n=1200, seed=7):
    """A K2-like curve: roll motion along an arc, a thruster firing every
    ~6 h (a sharp reset of the arc), the flux depending on the arc."""
    rng = np.random.default_rng(seed)
    t = 2000.0 + np.arange(n) * 0.0204
    phase = np.mod(t - t[0], 0.25) / 0.25
    col = 300.0 + 0.6 * phase + 0.01 * rng.standard_normal(n)
    row = 500.0 + 0.3 * phase ** 1.3 + 0.01 * rng.standard_normal(n)
    flux = 1e4 * (1 - 0.004 * (phase - 0.5) ** 2) \
        * (1 + 0.001 * np.sin(2 * np.pi * t / 4.0)) \
        + 3.0 * rng.standard_normal(n)
    out = []
    for mod in (jlk, tlk):
        out.append(mod.KeplerLightCurve(
            time=t, flux=flux, flux_err=np.full(n, 3.0), centroid_col=col,
            centroid_row=row, meta={"MISSION": "K2", "TARGETID": 5}))
    return out


def test_thruster_firings_and_window_points_equal():
    j, _ = sff_lcs()
    col, row = values(j["centroid_col"]), values(j["centroid_row"])
    arc = jsff._estimate_arclength(col, row)
    np.testing.assert_array_equal(tsff._estimate_arclength(col, row), arc)
    want = jsff._get_thruster_firings(arc)
    assert want.sum() > 10
    np.testing.assert_array_equal(tsff._get_thruster_firings(arc), want)
    np.testing.assert_array_equal(
        tsff._get_window_points(col, row, 20),
        jsff._get_window_points(col, row, 20))


@pytest.mark.parametrize("kw", [{}, dict(windows=10, bins=4,
                                         restore_trend=True)])
def test_sff_corrector_matches_jax(kw):
    j, t = sff_lcs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc = j.to_corrector("sff")
        tc = t.to_corrector("sff")
    assert type(tc).__name__ == "SFFCorrector"
    assert_lc_close(jc.correct(**kw), tc.correct(**kw))
    np.testing.assert_array_equal(tc.window_points, jc.window_points)
    # the roll's 6-h sawtooth (0.1% of the flux) is removed: the scatter
    # falls towards the noise's (0.03%)
    raw = np.std(t.normalize().flux.value)
    assert np.std(tc.corrected_lc.normalize().flux.value) < 0.6 * raw
    a = jc.compute_overfit_metric(n_samples=3, seed=1)
    b = tc.compute_overfit_metric(n_samples=3, seed=1)
    np.testing.assert_allclose(b, a, rtol=RTOL)


def test_overfit_metric_matches_jax():
    j, t = sff_lcs(n=600)
    for n_samples, seed in ((2, 0), (5, 3)):
        a = jcor.overfit_metric_lombscargle(j, j * 1.0001 + 0.5,
                                            n_samples=n_samples, seed=seed)
        b = tcor.overfit_metric_lombscargle(t, t * 1.0001 + 0.5,
                                            n_samples=n_samples, seed=seed)
        np.testing.assert_allclose(b, a, rtol=RTOL)


def test_to_corrector_entry_points():
    j, t = pld_tpfs("TESS")
    assert type(t.to_corrector("pld")).__name__ == "PLDCorrector"
    assert_lc_close(j.to_lightcurve(method="pld"),
                    t.to_lightcurve(method="pld"))
    _, lc = sff_lcs(n=300)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert isinstance(lc.to_corrector("sff"), tcor.SFFCorrector)
    # the CBV corrector wants e-/s fluxes, as the reference's does
    jl, _ = sff_lcs(n=300)
    for curve in (jl, lc):
        with pytest.raises(ValueError, match="e-/s"):
            curve.to_corrector("cbv")
    with pytest.raises(ValueError):
        lc.to_corrector("pld")
