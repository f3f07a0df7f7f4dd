"""lightkurve_tpu_torch's PRF photometry against lightkurve_tpu's, on the same
numpy inputs on the CPU: the reference with x64 on, the port in float64
(``port_on_cpu``).

Bars:
- evaluate: within :data:`EVAL_TOL` of the image's peak (GaussianPRF,
  SimpleKeplerPRF, and KeplerPRF from a calibration file both packages
  read), including a rotated case;
- gradient: the six partial images within :data:`GRAD_TOL` of each
  image's largest |value| (the reference's ``jax.jacfwd``);
- priors: values equal, derivatives against ``jax.grad`` and
  ``jax.hessian`` within 1e-12 relative, the tie at a wall pinned;
- ``PRFPhotometry.run``: ``opt_params`` and ``losses`` within
  :data:`RUN_RTOL` relative of the reference's (parameters near 0 against
  their column's scale, see :func:`assert_params_close`);
- the port in float32 against itself in float64: :data:`F32_RTOL`;
- the reference's float32 fit off its float64 fit by more than
  :data:`NODE_MOVE` at a node of a TESS file, the port's fit of the float32
  cube within :data:`RUN_RTOL` of the reference's float64 fit;
- the TPF API on port-written files: the light curves' flux within
  :data:`RUN_RTOL`, time axes and meta equal.
"""
import os

import jax
import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import prf as jprf
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import prf as tprf
from lightkurve_tpu_torch.io.fits import HDUList, Header, ImageHDU, PrimaryHDU
from lightkurve_tpu_torch.utils import LightkurveError, channel_to_module_output
from test_torch_tpf import write_port_tpf

import chip_smoke

EVAL_TOL = 1e-12
GRAD_TOL = 1e-9
#: measured: 7.2e-16 (two stars), 1.6e-14 (focus and motion), 2.5e-16
#: (pinned background) on opt_params; 2.2e-14 on the losses; 3.1e-16 on
#: the TPF files' PRF flux
RUN_RTOL = 1e-9
#: measured: 2.7e-8 (the two-star scene, 20 iterations)
F32_RTOL = 1e-5
PACKAGES = {"jax": jprf, "torch": tprf}
TRUTH = np.array([2.83, 3.12, 5000.0, 6.17, 5.88, 3000.0, 40.0])


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port on the CPU in float64, as the reference runs here with x64
    on."""
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_calibration(directory, channel, sigma=1.5 / 2.3548, oversample=50,
                      radius=6):
    """A ``kplrMM.O_*_prf.fits`` file of ``channel`` with five different
    PRF images (Gaussians of slightly different widths) at the corners
    and the centre of the channel, written by the port's FITS writer."""
    n = 2 * radius * oversample + 1
    ax = (np.arange(n) - (n - 1) / 2) / oversample
    xx, yy = np.meshgrid(ax, ax)
    hdus = [PrimaryHDU(header=Header({"SIMPLE": True}))]
    for i, (c1, c2) in enumerate([(12, 20), (12, 1044), (1111, 20),
                                  (1111, 1044), (550, 532)]):
        s = sigma * (1 + 0.05 * i)
        img = np.exp(-(xx ** 2 + yy ** 2) / (2 * s ** 2))
        img = (img / img.sum() * oversample ** 2).astype(">f4")
        hdus.append(ImageHDU(data=img, header=Header(
            {"CRVAL1P": c1, "CRVAL2P": c2})))
    module, output = channel_to_module_output(channel)
    HDUList(hdus).writeto(os.path.join(
        directory, f"kplr{module:02}.{output}_2011265_prf.fits"))
    return directory


def make_prf(pkg, kind, prf_dir=None):
    mod = PACKAGES[pkg]
    kw = dict(shape=(9, 11), column=5, row=3)
    if kind == "gaussian":
        return mod.GaussianPRF(**kw)
    if kind == "simple_kepler":
        return mod.SimpleKeplerPRF(channel=16, **kw)
    return mod.KeplerPRF(channel=56, prf_dir=prf_dir, **kw)


CASES = [dict(center_col=10.3, center_row=7.6, flux=123.4),
         dict(center_col=5.01, center_row=3.01, flux=1.0),          # corner
         dict(center_col=15.9, center_row=11.9, flux=2.0),          # far edge
         dict(center_col=10.0, center_row=8.0, flux=5.0,
              scale_col=1.2, scale_row=0.8),                        # scales
         dict(center_col=10.2, center_row=7.9, flux=5.0, scale_col=1.1,
              rotation_angle=0.3)]                                  # rotated


@pytest.mark.parametrize("kind", ["gaussian", "simple_kepler", "kepler"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_evaluate_and_gradient_match_jax(tmp_path, kind, case):
    """The (10.0, 8.0) case puts KeplerPRF's samples on the supersampled
    grid's nodes, where the gradient takes the tie convention of
    ``jnp.clip``."""
    d = write_calibration(str(tmp_path), 56) if kind == "kepler" else None
    j, t = make_prf("jax", kind, d), make_prf("torch", kind, d)
    np.testing.assert_array_equal(t.supersampled_prf, j.supersampled_prf)
    want = np.asarray(j.evaluate(**CASES[case]))
    got = host(t.evaluate(**CASES[case]))
    assert got.shape == want.shape == (9, 11)
    assert np.abs(got - want).max() <= EVAL_TOL * np.abs(want).max()
    np.testing.assert_array_equal(host(t(**CASES[case])), got)
    for g, w in zip(t.gradient(**CASES[case]), j.gradient(**CASES[case])):
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-300)


def test_evaluate_broadcasts_over_a_batch():
    t = make_prf("torch", "gaussian")
    cols = torch.tensor([10.3, 9.0, 11.2], dtype=torch.float64)
    out = t.evaluate(cols, 7.6, torch.tensor([1.0, 2.0, 3.0],
                                             dtype=torch.float64))
    assert out.shape == (3, 9, 11)
    for i in range(3):
        np.testing.assert_allclose(
            host(out[i]), host(t.evaluate(float(cols[i]), 7.6, i + 1.0)),
            rtol=0, atol=1e-15)


def test_kepler_prf_calibration_errors_and_plots(tmp_path):
    with pytest.raises(LightkurveError, match="prf_dir"):
        tprf.KeplerPRF(channel=56, shape=(5, 5), column=0, row=0)
    with pytest.raises(LightkurveError, match="No PRF calibration file"):
        tprf.KeplerPRF(channel=56, shape=(5, 5), column=0, row=0,
                       prf_dir=str(tmp_path))
    # the plots draw the reference's figures (test_torch_plots holds them
    # all): the model's image, and a refusal before any run
    from test_torch_plots import assert_same_plot
    assert_same_plot(tprf.GaussianPRF(shape=(5, 5)).plot(),
                     jprf.GaussianPRF(shape=(5, 5)).plot())
    for mod in (jprf, tprf):
        with pytest.raises(ValueError, match="run"):
            mod.PRFPhotometry(mod.TPFModel()).plot_results()
    import matplotlib.pyplot as plt
    plt.close("all")


# ---------------------------------------------------------------------------
# priors and parameters
# ---------------------------------------------------------------------------
PRIORS = [("UniformPrior", (1.0, 3.0)), ("GaussianPrior", (2.0, 0.3)),
          ("FixedValuePrior", (2.5,))]
POINTS = np.array([0.5, 1.0, 1.7, 2.5, 3.0, 3.4])


@pytest.mark.parametrize("name,args", PRIORS)
def test_prior_values_and_derivatives(name, args):
    jp, tp = getattr(jprf, name)(*args), getattr(tprf, name)(*args)
    assert tp.mean == jp.mean and repr(tp) == repr(jp)
    x = torch.as_tensor(POINTS)
    for what in ("evaluate", "penalty", "__call__"):
        want = np.array([float(getattr(jp, what)(v)) for v in POINTS])
        np.testing.assert_array_equal(host(getattr(tp, what)(x)), want)
        for v, w in zip(POINTS, want):
            assert float(getattr(tp, what)(float(v))) == w
    g, h = tp.derivatives(x)
    jg = np.array([float(jax.grad(jp.penalty)(v)) for v in POINTS])
    jh = np.array([float(jax.hessian(jp.penalty)(v)) for v in POINTS])
    np.testing.assert_allclose(host(g), jg, rtol=1e-12, atol=0)
    np.testing.assert_allclose(host(h), jh, rtol=1e-12, atol=0)


def test_uniform_prior_tie_splits_the_derivative():
    """On a wall (x == lb or ub) jax.grad of ``maximum`` splits the
    derivative 0.5/0.5, so the penalty's second derivative is a quarter
    of 2e6 there (0 inside, 2e6 outside)."""
    tp = tprf.UniformPrior(1.0, 3.0)
    g, h = tp.derivatives(torch.tensor([1.0, 2.0, 3.0, 3.5],
                                       dtype=torch.float64))
    np.testing.assert_array_equal(host(g), [0.0, 0.0, 0.0, 1e6])
    np.testing.assert_array_equal(host(h), [5e5, 0.0, 5e5, 2e6])
    jp = jprf.UniformPrior(1.0, 3.0)
    assert float(jax.hessian(jp.penalty)(1.0)) == 5e5


def test_prior_containers_match():
    for mod in (jprf, tprf):
        sp = mod.StarPrior(col=1.5, row=mod.GaussianPrior(2, 0.1),
                           flux=mod.UniformPrior(0, 10), targetid="T")
        assert isinstance(sp.col, mod.FixedValuePrior)
        assert float(sp(1.5, 2.0, 5.0)) == 0.0
        assert not np.isfinite(float(sp(1.6, 2.0, 5.0)))
        assert float(mod.BackgroundPrior(2.0)(2.0)) == 0.0
        assert float(mod.FocusPrior()(1, 1, 0)) == 0.0
        assert float(mod.MotionPrior()(0.3, 0.0)) == pytest.approx(0.045)
    assert repr(tprf.FocusPrior()) == repr(jprf.FocusPrior())


def scene(pkg, background=True, focus=False, motion=False, **kw):
    """The reference bench's two-star scene in either package."""
    mod = PACKAGES[pkg]
    prf = mod.GaussianPRF(shape=(9, 9), column=0, row=0)
    var = kw.get("star_var", 0.5)
    stars = [mod.StarPrior(col=mod.GaussianPrior(2.8, var),
                           row=mod.GaussianPrior(3.1, var),
                           flux=mod.UniformPrior(0.0, 2e4)),
             mod.StarPrior(col=mod.GaussianPrior(6.2, var),
                           row=mod.GaussianPrior(5.9, var),
                           flux=mod.UniformPrior(0.0, 2e4))]
    return mod.TPFModel(
        star_priors=stars, prfmodel=prf,
        background_prior=mod.BackgroundPrior(
            flux=mod.UniformPrior(0.0, 100.0)),
        focus_prior=kw.get("focus_prior", mod.FocusPrior)(),
        motion_prior=mod.MotionPrior(),
        fit_background=background, fit_focus=focus, fit_motion=motion)


def n_free(flags):
    background, focus, motion = flags
    return 6 + background + 3 * focus + 2 * motion


FLAGS = [(b, f, m) for b in (True, False) for f in (True, False)
         for m in (True, False)]


@pytest.mark.parametrize("flags", FLAGS)
def test_parameters_round_trip(flags):
    j, t = scene("jax", *flags), scene("torch", *flags)
    guess = t.get_initial_guesses()
    arr = guess.to_array()
    np.testing.assert_array_equal(arr, j.get_initial_guesses().to_array())
    np.testing.assert_array_equal(t.initial_guess(), arr)
    assert len(arr) == n_free(flags)
    values = arr + np.arange(len(arr)) * 0.01
    back = guess.from_array(values)
    np.testing.assert_array_equal(back.to_array(), values)
    assert repr(back) == repr(j.get_initial_guesses().from_array(values))
    assert (back.background.fitted, back.focus.fitted,
            back.motion.fitted) == flags


@pytest.mark.parametrize("flags", FLAGS)
def test_predict_prior_and_gradient_match(flags):
    j, t = scene("jax", *flags), scene("torch", *flags)
    p = np.r_[TRUTH[:6], [40.0] * flags[0], [1.02, 0.99, 0.05] * flags[1],
              [0.02, -0.03] * flags[2]]
    assert len(p) == n_free(flags)
    want = j.predict(p)
    got = t.predict(p)
    assert np.abs(got - want).max() <= EVAL_TOL * np.abs(want).max()
    np.testing.assert_allclose(host(t.predict_from_array(p)), got, rtol=0,
                               atol=0)
    for q in (p, p + 0.37):
        np.testing.assert_allclose(float(t.prior_penalty(q)),
                                   float(j.prior_penalty(q)), rtol=1e-12)
        assert t.logp_prior(q) == pytest.approx(j.logp_prior(q), rel=1e-12)
    # stars on pixel centres put the samples on the supersampled grid's
    # nodes, 6 px away on its first and last (the support's edges): the
    # reference differentiates its separable form there unless the focus
    # is fitted
    nodes = p.copy()
    nodes[:6] = [1.5, 1.5, 5000.0, 7.5, 7.5, 3000.0]
    for q in (p, nodes):
        for g, w in zip(t.gradient(q), j.gradient(q)):
            assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(),
                                                         1e-300)
    assert repr(t).splitlines()[:3] == repr(j).splitlines()[:3]


# ---------------------------------------------------------------------------
# PRFPhotometry.run
# ---------------------------------------------------------------------------
def noisy(img, n, seed=3, nan_cadences=()):
    rng = np.random.default_rng(seed)
    cube = img[None] + 2.0 * rng.standard_normal((n,) + img.shape)
    cube[list(nan_cadences)] = np.nan
    return cube


def focus_motion_scene(pkg):
    """Two stars with focus and motion fitted.  The stars' positions carry
    tight priors and the scene an anisotropic focus: with the bench's loose
    priors the shifts are degenerate with the positions and a circular
    PRF's rotation is not identified, and the reference's own fit moves by
    up to 0.8 relative under a 1e-15 jolt of its input after 25
    iterations (no fit to compare with)."""
    mod = PACKAGES[pkg]
    return scene(pkg, True, True, True, star_var=0.01,
                 focus_prior=lambda: mod.FocusPrior(
                     scale_col=mod.UniformPrior(0.5, 1.5),
                     scale_row=mod.UniformPrior(0.5, 1.5),
                     rotation_angle=mod.UniformPrior(-0.5, 0.5)))


def pinned_scene(pkg):
    """``tests/prf/test_tpfmodel.py``'s pinned background: one star, a
    FixedValuePrior(0) background while the truth has 5."""
    mod = PACKAGES[pkg]
    prf = mod.GaussianPRF(shape=(7, 7), column=0, row=0, sigma=1.2)
    return mod.TPFModel(
        star_priors=[mod.StarPrior(col=mod.GaussianPrior(3.5, 0.25),
                                   row=mod.GaussianPrior(3.5, 0.25),
                                   flux=mod.UniformPrior(100.0, 1e5))],
        background_prior=mod.BackgroundPrior(flux=mod.FixedValuePrior(0.0)),
        prfmodel=prf, fit_background=True)


def scene_cube(name, n):
    if name == "two stars":
        models = {p: scene(p) for p in PACKAGES}
        img = models["jax"].predict(TRUTH)
    elif name == "focus and motion":
        models = {p: focus_motion_scene(p) for p in PACKAGES}
        img = models["jax"].predict(np.r_[TRUTH, 1.2, 0.85, 0.2, 0.02,
                                          -0.03])
    else:
        models = {p: pinned_scene(p) for p in PACKAGES}
        img = np.asarray(models["jax"].prfmodel(3.5, 3.5, 1000.0)) + 5.0
    return models, noisy(img, n)


def assert_params_close(got, want, rtol=RUN_RTOL):
    """Each parameter within ``rtol`` of the reference's, relative to its
    own size or, for parameters near 0 (a pinned background, the shifts),
    to 1."""
    scale = np.maximum(np.abs(want), 1.0)
    err = np.abs(got - want) / scale
    assert err.max() <= rtol, err.max(axis=0)


@pytest.mark.parametrize("name,n_iter", [("two stars", 25),
                                         ("focus and motion", 25),
                                         ("pinned background", 40)])
def test_run_matches_jax(name, n_iter):
    models, cube = scene_cube(name, 32)
    j = jprf.PRFPhotometry(models["jax"])
    t = tprf.PRFPhotometry(models["torch"])
    want = j.run(cube, n_iter=n_iter)
    got = t.run(cube, n_iter=n_iter)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert_params_close(got, want)
    np.testing.assert_allclose(t.losses, j.losses, rtol=RUN_RTOL, atol=0)
    assert len(t.results) == 32
    assert repr(t.results[5]) == repr(
        models["torch"].get_initial_guesses().from_array(got[5]))
    if name == "pinned background":
        assert np.abs(got[:, 3]).max() < 1e-3
    lc, jlc = t.to_lightcurve(), j.to_lightcurve()
    np.testing.assert_array_equal(lc.time.value, np.arange(32.0))
    np.testing.assert_array_equal(lc.time.value, jlc.time.value)
    np.testing.assert_array_equal(lc.flux.value, got[:, 2])
    assert str(lc.flux.unit) == str(jlc.flux.unit)
    np.testing.assert_allclose(t.get_residual_image(cube, 7),
                               j.get_residual_image(cube, 7), rtol=0,
                               atol=1e-9 * np.abs(cube[7]).max())


def test_run_cadences_and_single_image():
    models, cube = scene_cube("two stars", 12)
    t = tprf.PRFPhotometry(models["torch"])
    j = jprf.PRFPhotometry(models["jax"])
    assert_params_close(t.run(cube, cadences=[1, 4, 9]),
                        j.run(cube, cadences=[1, 4, 9]))
    assert_params_close(t.run(cube[3]), j.run(cube[3]))
    fit_t = models["torch"].fit(cube[2], n_iter=30)
    fit_j = models["jax"].fit(cube[2], n_iter=30)
    assert_params_close(fit_t.to_array(), fit_j.to_array())
    # a CPU tensor keeps its device and dtype
    out = t.run(torch.as_tensor(cube[:4]))
    assert out.dtype == np.float64 and out.shape == (4, 7)


def test_all_nan_images_fit_as_zero_images():
    """The reference fits a cadence whose image is all NaN as a zero image
    (``np.nan_to_num``): both packages give the same near-zero fluxes."""
    models, cube = scene_cube("two stars", 16)
    cube[[3, 11]] = np.nan
    cube[5, 2:4, 2:4] = np.nan
    want = jprf.PRFPhotometry(models["jax"]).run(cube, n_iter=20)
    got = tprf.PRFPhotometry(models["torch"]).run(cube, n_iter=20)
    assert_params_close(got, want)
    for i in (3, 11):
        np.testing.assert_allclose(got[i, [2, 5]], want[i, [2, 5]],
                                   rtol=RUN_RTOL, atol=0)
        assert np.abs(got[i, [2, 5]]).max() < 1e-6


def test_float32_cube_against_float64():
    """A float32 cube (the card's default) is fitted in float64: the fit
    moves only by its pixels' rounding."""
    models, cube = scene_cube("two stars", 64)
    t = tprf.PRFPhotometry(models["torch"])
    f64 = t.run(torch.as_tensor(cube), n_iter=20)
    f32 = t.run(torch.as_tensor(cube).float(), n_iter=20)
    assert f32.dtype == np.float64
    assert np.max(np.abs(f32 - f64) / np.abs(f64)) <= F32_RTOL
    assert np.isfinite(t.losses).all()
    up = t.run(torch.as_tensor(cube).float().double(), n_iter=20)
    np.testing.assert_array_equal(f32, up)


#: the cadence of phase 13's first TESS file (``chip_smoke.tess_tpfs`` on
#: the CPU) whose float64 fit sits on the supersampled node at row 505.5,
#: closer than float32's spacing there (measured: 505.4999874), and the
#: share of the median flux past which the reference's float32 fit is held
#: to move there (measured: 4.90e-4; the other cadences of the file move by
#: 1.3e-7 at most)
NODE_CADENCE = 11795
NODE_MOVE = 1e-4


def test_reference_float32_fit_leaves_a_node(tmp_path):
    """Why the port's LM runs in float64 whatever the cube's dtype: the
    reference's own float32 fit jumps off a node where its float64 fit
    sits (the node derivative is not the slope there), while the port's
    fit of the float32 cube stays on the reference's float64 fit."""
    path = str(tmp_path / "tess.fits")
    chip_smoke.tess_tpfs(device="cpu")[0][0].to_fits(path)
    cads = np.arange(NODE_CADENCE - 4, NODE_CADENCE + 4)
    f64 = jlk.read(path).extract_prf_photometry(cadences=cads).opt_params
    with jax.enable_x64(False):
        f32 = jlk.read(path).extract_prf_photometry(cadences=cads).opt_params
    assert f32.dtype == np.float32
    assert abs(f64[4, 1] - 505.5) < np.spacing(np.float32(505.5))
    move = np.abs(f32[:, 2] - f64[:, 2]) / np.median(f64[:, 2])
    assert np.argmax(move) == 4 and move[4] > NODE_MOVE
    assert np.delete(move, 4).max() < 1e-5
    port = tlk.read(path)
    cube = torch.as_tensor(port.flux.value[cads], dtype=torch.float32)
    assert_params_close(tprf.PRFPhotometry(port.get_model()).run(cube), f64)


def test_run_refuses_the_card_without_cuda(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models, cube = scene_cube("two stars", 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprf.PRFPhotometry(models["torch"]).run(cube)
    out = tprf.PRFPhotometry(models["torch"]).run(cube, device="cpu")
    assert out.shape == (2, 7)


# ---------------------------------------------------------------------------
# the TPF API on port-written files
# ---------------------------------------------------------------------------
def read_both(path):
    return jlk.read(path), tlk.read(path)


def assert_lc_flux_close(got, want):
    np.testing.assert_array_equal(got.time.value, want.time.value)
    np.testing.assert_allclose(got.flux.value, want.flux.value,
                               rtol=RUN_RTOL, atol=0)


@pytest.mark.parametrize("mission", ["TESS", "K2"])
def test_tpf_prf_photometry_matches_jax(tmp_path, mission):
    path = write_port_tpf(tmp_path / "tpf.fits", mission)
    j, t = read_both(path)
    lc_j = j.to_lightcurve(method="prf")
    lc_t = t.to_lightcurve(method="prf")
    # the reference's to_lightcurve(method="prf") passes no time: its
    # light curve runs on arange(n)
    np.testing.assert_array_equal(lc_t.time.value,
                                  np.arange(len(t.time), dtype=float))
    assert_lc_flux_close(lc_t, lc_j)
    cads = [0, 3, 17, 40]
    pj = j.extract_prf_photometry(cadences=cads)
    pt = t.extract_prf_photometry(cadences=cads, parallel=False)
    assert_params_close(pt.opt_params, pj.opt_params)
    np.testing.assert_allclose(pt.losses, pj.losses, rtol=RUN_RTOL)
    mj, mt = j.get_model(), t.get_model()
    np.testing.assert_array_equal(mt.initial_guess(), mj.initial_guess())
    assert type(mt.prfmodel).__name__ == type(mj.prfmodel).__name__
    assert (mt.prfmodel.shape, mt.prfmodel.column, mt.prfmodel.row) == (
        mj.prfmodel.shape, mj.prfmodel.column, mj.prfmodel.row)
    assert mt.star_priors[0].targetid == mj.star_priors[0].targetid
    mt2 = t.get_model(fit_motion=True)
    assert mt2.fit_motion and len(mt2.initial_guess()) == 6


def test_kepler_prf_model_and_lightcurve(tmp_path):
    path = write_port_tpf(tmp_path / "k2.fits", "K2")
    j, t = read_both(path)
    for want, got in ((j.get_prf_model(), t.get_prf_model()),
                      (j.get_prf_model(prf_dir=write_calibration(
                          str(tmp_path), t.channel)),
                       t.get_prf_model(prf_dir=str(tmp_path)))):
        assert type(got).__name__ == type(want).__name__
        assert (got.shape, got.column, got.row, got.channel) == (
            want.shape, want.column, want.row, want.channel)
        np.testing.assert_array_equal(got.supersampled_prf,
                                      want.supersampled_prf)
    kepler = t.get_prf_model(prf_dir=str(tmp_path))
    assert type(kepler).__name__ == "KeplerPRF"
    lj, lt = j.prf_lightcurve(), t.prf_lightcurve()
    assert type(lt).__name__ == type(lj).__name__ == "KeplerLightCurve"
    np.testing.assert_array_equal(lt.time.value, t.time.value)
    assert_lc_flux_close(lt, lj)
    for key in ("QUALITY", "CHANNEL", "CAMPAIGN", "QUARTER", "MISSION",
                "RA_OBJ", "DEC_OBJ", "TARGETID"):
        assert lt.meta[key] == lj.meta[key], key
    pj = j.extract_prf_photometry(prf=j.get_prf_model(prf_dir=str(tmp_path)))
    pt = t.extract_prf_photometry(prf=kepler)
    assert_params_close(pt.opt_params, pj.opt_params)
