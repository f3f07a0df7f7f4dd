"""lightkurve_tpu_torch's CBV corrector and under-fitting metric against
lightkurve_tpu's, on the same synthetic CBV and light-curve files (written
once, read by both packages) on the CPU: the reference with x64 on, the
port in float64 (``port_on_cpu``).

Bars:
- equal: the loaders (TESS single-scale, multiscale bands and spike, a
  missing band's empty placeholder, the ``fast`` file selection, Kepler's
  ``MODOUT_m_o`` extension by quarter and K2's by campaign and channel),
  ``align`` (cadences added and dropped), the design matrices, the error
  paths (same exception types);
- rtol 1e-12: ``interpolate`` (PCHIP between cadences, extrapolated both
  ways or zero-filled);
- rtol 1e-10: ``correct_gaussian_prior``'s corrected flux and
  coefficients (TESS with bands, Kepler, K2, interpolated CBVs), the
  under-fitting metric given ``neighbor_flux``;
- ``test_torch_solve``'s ElasticNet bar (rtol 1e-9, atol 1e-14) for
  ``correct_elasticnet``'s coefficients;
- rtol 1e-6 for ``correct()``'s optimised α, both packages drawing the
  over-fitting metric's noise from the same seeded generator (and with
  ``target_over_score=0``, where nothing is drawn).
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import utils as jutils
from lightkurve_tpu.correctors import metrics as jmetrics
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import utils as tutils
from lightkurve_tpu_torch.correctors import metrics as tmetrics
from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                          PrimaryHDU, write_fits)
from test_torch_solve import RTOL as SOLVE_RTOL

N = 400
CAD0 = 100
GAP = slice(200, 212)
T0 = 1500.0
DT = 0.02
N_SINGLE, N_BAND, N_SPIKE = 5, 3, 2
RTOL = 1e-10
INTERP_RTOL = 1e-12
ALPHA_RTOL = 1e-6


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


def smooth_vectors(t, k, seed, periods=(0.6, 8.0)):
    """k orthonormal smooth vectors on ``t``: sinusoids of periods in
    ``periods``, orthonormalised."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(*periods, k)
    raw = np.sin(2 * np.pi * t[:, None] / p + rng.uniform(0, 6.3, k))
    q, _ = np.linalg.qr(raw)
    return q.T


def spike_vectors(n, k, seed):
    rng = np.random.default_rng(seed)
    v = np.zeros((k, n))
    for i in range(k):
        v[i, rng.choice(n, 6, replace=False)] = rng.standard_normal(6)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def cbv_table(extname, t, vectors, time_col="TIME", gap_col="GAP"):
    cols = {time_col: t, "CADENCENO": np.arange(CAD0, CAD0 + N,
                                                 dtype=np.int32)}
    gap = np.zeros(N, np.uint8)
    gap[GAP] = 1
    cols[gap_col] = gap
    for i, v in enumerate(vectors, 1):
        v = v.copy()
        v[GAP] = 0.0
        cols[f"VECTOR_{i}"] = v.astype(np.float32)
    return BinTableHDU(data=cols, header=Header({"EXTNAME": extname}))


def cbv_times():
    return T0 + DT * np.arange(N)


def write_tess_cbvs(directory, sector=10, camera=2, ccd=4, n_bands=3,
                    fast=False, seed=0):
    t = cbv_times()
    tag = f"{camera}.{ccd}"
    hdus = [PrimaryHDU(header=Header({"TELESCOP": "TESS", "SECTOR": sector,
                                      "CAMERA": camera, "CCD": ccd})),
            cbv_table(f"CBV.single-scale.{tag}", t,
                      smooth_vectors(t, N_SINGLE, seed))]
    for b in range(1, n_bands + 1):
        hdus.append(cbv_table(
            f"CBV.multiscale-band-{b}.{tag}", t,
            smooth_vectors(t, N_BAND, seed + b, (0.2 * b, 2.0 * b))))
    hdus.append(cbv_table(f"CBV.spike.{tag}", t,
                          spike_vectors(N, N_SPIKE, seed + 9)))
    name = (f"tess2019-s{sector:04d}-{camera}-{ccd}-0140-"
            f"{'fast-' if fast else 's_'}cbv.fits")
    os.makedirs(directory, exist_ok=True)
    write_fits(HDUList(hdus), os.path.join(directory, name), overwrite=True)
    return directory


def write_kepler_cbvs(directory, mission="Kepler", qc=8, module=16,
                      output=4, seed=20):
    bkjd = cbv_times() - 1000.0
    ext = cbv_table(f"MODOUT_{module}_{output}", bkjd + 54832.5,
                    smooth_vectors(bkjd, N_SINGLE, seed),
                    time_col="TIME_MJD", gap_col="GAPFLAG")
    other = cbv_table("MODOUT_2_1", bkjd + 54832.5,
                      smooth_vectors(bkjd, 2, seed + 1),
                      time_col="TIME_MJD", gap_col="GAPFLAG")
    name = (f"kplr2011-q{qc:02d}-d25_lcbv.fits" if mission == "Kepler"
            else f"ktwo-c{qc:02d}-d14_lcbv.fits")
    os.makedirs(directory, exist_ok=True)
    write_fits(HDUList([PrimaryHDU(header=Header({"TELESCOP": "Kepler"})),
                        other, ext]),
               os.path.join(directory, name), overwrite=True)
    return directory


def write_lc(path, mission, vectors, seed, keep=None, time_shift=0.0,
             **cards):
    """A SPOC- or Kepler-pipeline-style light-curve file whose SAP flux
    carries ``vectors`` (rows, on the CBVs' cadences) at a random mix, the
    cadences ``keep`` of the CBVs' grid, 3 NaN fluxes."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(N), np.arange(N)[GAP]) if keep is None \
        else keep
    t = cbv_times()[keep] + time_shift
    kepler = mission in ("Kepler", "K2")
    if kepler:
        t = t - 1000.0
    f0 = 5000.0
    coef = rng.uniform(-1, 1, len(vectors)) * 0.01 * f0 / np.abs(
        vectors).max(1)
    sap = f0 + coef @ vectors[:, keep] + np.sqrt(f0) * \
        rng.standard_normal(len(keep)) * 0.05
    sap[rng.choice(len(keep), 3, replace=False)] = np.nan
    h0 = {"TELESCOP": "Kepler" if kepler else "TESS", "MISSION": mission,
          "CREATOR": ("FluxExporter2PipelineModule" if kepler
                      else "LightCurveExporterPipelineModule"),
          "ORIGIN": "NASA/Ames", "OBJECT": "T 1",
          ("KEPLERID" if kepler else "TICID"): 1234}
    h0.update(cards)
    cols = {"TIME": t, "CADENCENO": (CAD0 + keep).astype(np.int32),
            "SAP_FLUX": sap.astype(np.float32),
            "SAP_FLUX_ERR": np.full(len(keep), 0.05 * np.sqrt(f0),
                                    np.float32),
            "PDCSAP_FLUX": sap.astype(np.float32),
            "PDCSAP_FLUX_ERR": np.full(len(keep), 0.05 * np.sqrt(f0),
                                       np.float32),
            ("SAP_QUALITY" if kepler else "QUALITY"):
                np.zeros(len(keep), np.int32)}
    units = {"TUNIT3": "e-/s", "TUNIT4": "e-/s", "TUNIT5": "e-/s",
             "TUNIT6": "e-/s"}
    th = {"EXTNAME": "LIGHTCURVE", "BJDREFI": 2454833 if kepler else 2457000,
          "BJDREFF": 0.0, "TIMESYS": "TDB", **units}
    write_fits(HDUList([PrimaryHDU(header=Header(h0)),
                        BinTableHDU(data=cols, header=Header(th))]), path,
               overwrite=True)
    return path


def tess_vectors():
    t = cbv_times()
    return np.concatenate([smooth_vectors(t, N_SINGLE, 0)[:3],
                           spike_vectors(N, N_SPIKE, 9)])


def read_both(path):
    return (jlk.read(path, flux_column="sap_flux"),
            tlk.read(path, flux_column="sap_flux"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cbv")
    d = {"tess": write_tess_cbvs(str(root / "tess")),
         "tess_one_band": write_tess_cbvs(str(root / "one"), n_bands=1),
         "tess_no_band": write_tess_cbvs(str(root / "none"), n_bands=0),
         "kepler": write_kepler_cbvs(str(root / "kepler")),
         "k2": write_kepler_cbvs(str(root / "k2"), "K2", 15,
                                 *tutils.channel_to_module_output(24))}
    write_tess_cbvs(d["tess"], fast=True, seed=5)
    tcards = dict(SECTOR=10, CAMERA=2, CCD=4)
    d["tess_lc"] = write_lc(str(root / "tess_lc.fits"), "TESS",
                            tess_vectors(), 1, **tcards)
    d["tess_fast_lc"] = write_lc(str(root / "tess2019-fast-lc.fits"), "TESS",
                                 tess_vectors(), 2, **tcards)
    kv = smooth_vectors(cbv_times() - 1000.0, N_SINGLE, 20)
    d["kepler_lc"] = write_lc(str(root / "kepler_lc.fits"), "Kepler", kv, 3,
                              QUARTER=8,
                              CHANNEL=tutils.module_output_to_channel(16, 4))
    d["k2_lc"] = write_lc(str(root / "k2_lc.fits"), "K2", kv, 4,
                          CAMPAIGN=15, CHANNEL=24)
    rng = np.random.default_rng(6)
    d["tess_shifted_lc"] = write_lc(
        str(root / "shifted_lc.fits"), "TESS", tess_vectors(), 5,
        keep=np.sort(rng.choice(np.arange(30, 370), 200, replace=False)),
        time_shift=0.4 * DT, **tcards)
    d["tess_wide_lc"] = write_lc(
        str(root / "wide_lc.fits"), "TESS", tess_vectors(), 6,
        keep=np.arange(N), time_shift=-0.3 * DT, **tcards)
    return d


def assert_cbvs_equal(a, b, rtol=0.0):
    assert type(a).__name__ == type(b).__name__
    assert list(a.columns) == list(b.columns)
    for k in a.columns:
        va, vb = np.asarray(a.columns[k]), np.asarray(b.columns[k])
        assert va.dtype.kind == vb.dtype.kind, k
        if va.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(vb, va, rtol=rtol, atol=1e-15,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(vb, va, err_msg=k)
    np.testing.assert_array_equal(b.time.value, a.time.value)
    assert b.time.format == a.time.format
    for attr in ("cbv_type", "band", "mission", "sector", "camera", "ccd",
                 "quarter", "campaign", "channel", "module", "output",
                 "cbv_indices"):
        assert getattr(b, attr, None) == getattr(a, attr, None), attr
    assert dict(b.meta) == dict(a.meta)


def load_both(kind, **kw):
    out = []
    for mod in (jlk.correctors, tlk.correctors):
        out.append(getattr(mod, f"load_{kind}_cbvs")(**kw))
    return out


@pytest.mark.parametrize("cbv_type, band", [
    ("SingleScale", None), ("MultiScale", 1), ("MultiScale", 3),
    ("MultiScale", 4), ("Spike", None)])
@pytest.mark.parametrize("fast", [False, True])
def test_load_tess_cbvs_equal(files, cbv_type, band, fast):
    a, b = load_both("tess", cbv_dir=files["tess"], sector=10, camera=2,
                     ccd=4, cbv_type=cbv_type, band=band, fast_cadence=fast)
    assert_cbvs_equal(a, b)
    if band == 4:                       # absent: the empty placeholder
        assert b.band is None and len(b) == 1
    else:
        assert len(b) == N and b.band == band


@pytest.mark.parametrize("kind, kw", [
    ("kepler", dict(mission="Kepler", quarter=8, module=16, output=4)),
    ("k2", dict(mission="K2", campaign=15, channel=24))])
def test_load_kepler_cbvs_equal(files, kind, kw):
    a, b = load_both("kepler", cbv_dir=files[kind], **kw)
    assert_cbvs_equal(a, b)
    assert b.cbv_indices == list(range(1, N_SINGLE + 1))
    assert b.time.format == "mjd"


@pytest.mark.parametrize("lc_key, n_bands_dir", [
    ("tess_lc", "tess"), ("tess_lc", "tess_one_band"),
    ("tess_lc", "tess_no_band"), ("tess_fast_lc", "tess"),
    ("kepler_lc", "kepler"), ("k2_lc", "k2")])
def test_corrector_loads_and_aligns_equal(files, lc_key, n_bands_dir):
    """The CBV sets a corrector loads (TESS: single-scale, each band until
    the first absent one, spike; the ``fast`` file for a 20-s product's
    name) aligned to the light curve."""
    jl, tl = read_both(files[lc_key])
    jc = jl.to_corrector("cbv", cbv_dir=files[n_bands_dir])
    tc = tl.to_corrector("cbv", cbv_dir=files[n_bands_dir])
    assert type(tc).__name__ == "CBVCorrector"
    assert len(tc.cbvs) == len(jc.cbvs)
    if n_bands_dir.startswith("tess"):
        want = {"tess": 5, "tess_one_band": 3, "tess_no_band": 2}
        assert len(tc.cbvs) == want[n_bands_dir]
    for a, b in zip(jc.cbvs, tc.cbvs):
        assert_cbvs_equal(a, b)
        np.testing.assert_array_equal(b.cadenceno,
                                      np.asarray(tc.lc["cadenceno"]))
    if lc_key == "tess_fast_lc":       # the fast file's vectors differ
        s = tlk.correctors.load_tess_cbvs(cbv_dir=files["tess"], sector=10,
                                          camera=2, ccd=4)
        assert not np.allclose(tc.cbvs[0]["VECTOR_1"][:5],
                               s.align(tc.lc)["VECTOR_1"][:5])


def test_align_adds_and_drops_cadences_equal(files):
    jl, tl = read_both(files["tess_wide_lc"])
    jl, tl = jl.remove_nans(), tl.remove_nans()
    extra = np.asarray(tl["cadenceno"]).copy()
    a, b = load_both("tess", cbv_dir=files["tess"], sector=10, camera=2,
                     ccd=4)
    # a light curve with cadences past the CBVs' last one
    jl["cadenceno"] = np.asarray(jl["cadenceno"]) + 7
    tl["cadenceno"] = extra + 7
    ja, ta = a.align(jl), b.align(tl)
    assert_cbvs_equal(ja, ta)
    assert len(ta) == len(tl)
    assert np.isnan(ta["VECTOR_1"][-7:]).all() and ta["GAP"][-7:].all()


@pytest.mark.parametrize("extrapolate", [True, False])
@pytest.mark.parametrize("lc_key", ["tess_shifted_lc", "tess_wide_lc"])
def test_interpolate_equal(files, lc_key, extrapolate):
    jl, tl = read_both(files[lc_key])
    for cbv_type, band in (("SingleScale", None), ("MultiScale", 2),
                           ("Spike", None)):
        a, b = load_both("tess", cbv_dir=files["tess"], sector=10,
                         camera=2, ccd=4, cbv_type=cbv_type, band=band)
        assert_cbvs_equal(a.interpolate(jl, extrapolate=extrapolate),
                          b.interpolate(tl, extrapolate=extrapolate),
                          rtol=INTERP_RTOL)
    if lc_key == "tess_wide_lc" and not extrapolate:
        v = b.interpolate(tl)["VECTOR_1"]
        assert v[0] == 0.0                # before the first node: zero


def test_interpolate_at_the_nodes_equals_align(files):
    """Where the light curve's times are the CBVs' own (the gap flagged),
    PCHIP returns the nodes: interpolated and aligned CBVs are equal."""
    _, tl = read_both(files["tess_lc"])
    tl = tl.remove_nans()
    b = tlk.correctors.load_tess_cbvs(cbv_dir=files["tess"], sector=10,
                                      camera=2, ccd=4)
    np.testing.assert_array_equal(b.interpolate(tl)["VECTOR_3"],
                                  b.align(tl)["VECTOR_3"].astype(float))


def corrected_pair(files, lc_key, cbv_dir, method, **kw):
    jl, tl = read_both(files[lc_key])
    init = kw.pop("init", {})
    jc = jl.to_corrector("cbv", cbv_dir=files[cbv_dir], **init)
    tc = tl.to_corrector("cbv", cbv_dir=files[cbv_dir], **init)
    return (jc, getattr(jc, method)(**kw)), (tc, getattr(tc, method)(**kw))


GAUSSIAN_CASES = {
    "tess": ("tess_lc", "tess", dict(
        cbv_type=["SingleScale", "Spike"],
        cbv_indices=[np.arange(1, 4), np.arange(1, 4)], alpha=1e-4)),
    "tess_bands": ("tess_lc", "tess", dict(
        cbv_type=["SingleScale", "MultiScale.2", "Spike"],
        cbv_indices=[[1, 2, 3], [1, 3, 9], [1, 2, 3]], alpha=10.0)),
    "tess_interpolated": ("tess_shifted_lc", "tess", dict(
        init=dict(interpolate_cbvs=True, extrapolate_cbvs=True),
        cbv_type=["SingleScale"], cbv_indices=[[1, 2, 3]], alpha=1e-2)),
    "kepler": ("kepler_lc", "kepler", dict(alpha=1e-20)),
    "k2": ("k2_lc", "k2", dict(cbv_indices=[np.arange(1, 6)], alpha=0.0)),
}


@pytest.mark.parametrize("case", sorted(GAUSSIAN_CASES))
def test_correct_gaussian_prior_equal(files, case):
    lc_key, cbv_dir, kw = GAUSSIAN_CASES[case]
    (jc, jout), (tc, tout) = corrected_pair(files, lc_key, cbv_dir,
                                            "correct_gaussian_prior", **kw)
    f = jout.flux.value
    np.testing.assert_allclose(tout.flux.value, f, rtol=RTOL)
    np.testing.assert_allclose(tc.coefficients, jc.coefficients, rtol=RTOL,
                               atol=1e-9)
    assert list(tc.design_matrix_collection.columns) == list(
        jc.design_matrix_collection.columns)
    np.testing.assert_array_equal(tc.design_matrix_collection.values,
                                  jc.design_matrix_collection.values)
    # with a weak prior the systematics are gone: the residual is noise
    if kw["alpha"] <= 1e-2:
        assert np.std(tout.flux.value) < 0.2 * np.nanstd(
            np.asarray(tc.lc.flux.value))


def test_mixed_index_list_the_reference_refuses(files):
    """``cbv_indices=[np.arange(1, 4), "ALL"]`` (the upstream tutorials'
    form): the reference's ``np.atleast_1d`` of the list raises numpy's
    inhomogeneous-shape ValueError; the port takes it, and gives the
    reference's result for the same columns named by equal-length
    arrays (the spike set has 2 vectors, so ``np.arange(1, 4)`` names
    them all)."""
    jl, tl = read_both(files["tess_lc"])
    jc = jl.to_corrector("cbv", cbv_dir=files["tess"])
    tc = tl.to_corrector("cbv", cbv_dir=files["tess"])
    kw = dict(cbv_type=["SingleScale", "Spike"], alpha=1e-4)
    with pytest.raises(ValueError, match="inhomogeneous"):
        jc.correct_gaussian_prior(cbv_indices=[np.arange(1, 4), "ALL"], **kw)
    want = jc.correct_gaussian_prior(
        cbv_indices=[np.arange(1, 4), np.arange(1, 4)], **kw)
    got = tc.correct_gaussian_prior(cbv_indices=[np.arange(1, 4), "ALL"],
                                    **kw)
    np.testing.assert_allclose(got.flux.value, want.flux.value, rtol=RTOL)
    for bad in ([1, 2], np.arange(1, 3), 3):
        for c in (jc, tc):
            with pytest.raises(ValueError, match="must be lists"):
                c.correct_gaussian_prior(cbv_indices=bad, **kw)


@pytest.mark.parametrize("l1_ratio", [0.01, 0.5])
def test_correct_elasticnet_equal(files, l1_ratio):
    (jc, jout), (tc, tout) = corrected_pair(
        files, "tess_lc", "tess", "correct_elasticnet",
        cbv_type=["SingleScale", "Spike"], cbv_indices=["ALL", "ALL"],
        alpha=1e-3, l1_ratio=l1_ratio)
    np.testing.assert_allclose(tc.coefficients, jc.coefficients,
                               rtol=SOLVE_RTOL, atol=1e-14)
    np.testing.assert_allclose(tout.flux.value, jout.flux.value,
                               rtol=SOLVE_RTOL)
    assert tc.fista_iterations > 0


def neighbours(corrector, k=12, seed=7):
    """k neighbours' fluxes on the corrector's cadences: the first
    systematic at random weights plus white noise, normalised."""
    rng = np.random.default_rng(seed)
    n = len(corrector.lc)
    v = np.asarray(corrector.cbvs[0]["VECTOR_1"], float)
    return [rng.uniform(0.5, 2) * 0.002 * v / np.abs(v).max()
            + 3e-4 * rng.standard_normal(n) for _ in range(k)]


@pytest.fixture
def seeded_draws(monkeypatch):
    """Both packages' over-fitting metric draws its white noise from
    ``np.random.default_rng(None)``: give every such call the same seed."""
    make = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: make(11 if seed is None else seed))


@pytest.mark.parametrize("over", [0.5, 0.0])
def test_correct_optimised_alpha_equal(files, seeded_draws, over):
    jl, tl = read_both(files["tess_lc"])
    jc = jl.to_corrector("cbv", cbv_dir=files["tess"])
    tc = tl.to_corrector("cbv", cbv_dir=files["tess"])
    nb = neighbours(tc)
    kw = dict(cbv_type=["SingleScale"], cbv_indices=["ALL"],
              alpha_bounds=(1e-4, 1e4), max_iter=10, neighbor_flux=nb,
              target_over_score=over, verbose=False)
    jout, tout = jc.correct(**kw), tc.correct(**kw)
    np.testing.assert_allclose(tc.alpha, jc.alpha, rtol=ALPHA_RTOL)
    np.testing.assert_allclose(tc.under_fitting_score,
                               jc.under_fitting_score, rtol=1e-6)
    np.testing.assert_allclose(tc.over_fitting_score, jc.over_fitting_score,
                               rtol=1e-6)
    np.testing.assert_allclose(tout.flux.value, jout.flux.value, rtol=1e-6)
    assert 1e-4 <= tc.alpha <= 1e4


def neighbour_archive(directory, n=32, tic0=2000):
    """``n`` neighbours of ``write_lc``'s target (TIC 1234) as SPOC files,
    and a recorded MAST fixture listing them and the target, placed
    around it within 0.5 degrees (the resolver knows the target by its
    TIC id, as the under-fitting metric searches for it)."""
    rng = np.random.default_rng(8)
    ra0, dec0 = 80.0, -70.0
    obs, prods = [], []
    for i, tic in enumerate([1234] + [tic0 + k for k in range(n)]):
        name = f"tess2020-s0010-{tic:016d}-0195-s_lc.fits"
        path = os.path.join(directory, name)
        if tic != 1234:
            write_lc(path, "TESS", tess_vectors(), 100 + i, SECTOR=10,
                     CAMERA=2, CCD=4, TICID=tic)
        ra, dec = (ra0, dec0) if tic == 1234 else (
            ra0 + rng.uniform(-1, 1), dec0 + rng.uniform(-0.5, 0.5))
        obs.append({"obs_id": f"tess_s0010_{tic}", "target_name": str(tic),
                    "s_ra": ra, "s_dec": dec, "project": "TESS",
                    "provenance_name": "SPOC", "t_exptime": 120,
                    "sequence_number": 10, "dataproduct_type": "timeseries",
                    "description": "TESS Sector 10"})
        prods.append({"obs_id": f"tess_s0010_{tic}", "productFilename": name,
                      "description": "Light curves",
                      "dataURI": f"mast:TESS/product/{name}",
                      "local_path": path})
    return {"resolver": {"1234": [ra0, dec0]}, "observations": obs,
            "products": prods}


def test_underfit_metric_with_neighbours_equal(files, tmp_path, monkeypatch):
    (jc, _), (tc, _) = corrected_pair(files, "tess_lc", "tess",
                                      "correct_gaussian_prior", alpha=1e-3)
    nb = neighbours(tc)
    a = jc.under_fitting_metric(neighbor_flux=nb)
    b = tc.under_fitting_metric(neighbor_flux=nb)
    np.testing.assert_allclose(b, a, rtol=RTOL)
    np.testing.assert_allclose(tc.compute_underfit_metric(neighbor_flux=nb),
                               jc.compute_underfit_metric(neighbor_flux=nb),
                               rtol=RTOL)
    np.testing.assert_allclose(
        tmetrics.underfit_metric_neighbors(tc.corrected_lc,
                                           neighbor_flux=nb[:3]),
        jmetrics.underfit_metric_neighbors(jc.corrected_lc,
                                           neighbor_flux=nb[:3]),
        rtol=RTOL)
    x = np.random.default_rng(3).standard_normal((50, 6))
    np.testing.assert_allclose(tmetrics._compute_correlation(x),
                               jmetrics._compute_correlation(x), rtol=1e-13)
    # without neighbor_flux: the neighbours come from the archive, here a
    # recorded MAST transport (the ambient one, from the environment, as
    # correct() reaches it; and one passed in), copied into a cache
    # directory inside tmp_path
    for var in ("HOME", "XDG_CACHE_HOME", "XDG_CONFIG_HOME",
                "LIGHTKURVE_CACHE_DIR"):
        monkeypatch.setenv(var, str(tmp_path / var.lower()))
    for conf in (jlk.conf, tlk.conf):
        monkeypatch.setattr(conf, "cache_dir", None)
    (tmp_path / "archive").mkdir()
    fixture = neighbour_archive(str(tmp_path / "archive"))
    (tmp_path / "mast.json").write_text(json.dumps(fixture))
    monkeypatch.setenv("LIGHTKURVE_TPU_MAST_FIXTURES",
                       str(tmp_path / "mast.json"))
    a, b = jc.under_fitting_metric(), tc.under_fitting_metric()
    np.testing.assert_allclose(b, a, rtol=RTOL)
    assert 0 <= b <= 1
    want = jmetrics._download_and_preprocess_neighbors(jc.corrected_lc)
    got = tmetrics._download_and_preprocess_neighbors(tc.corrected_lc)
    assert len(got) == len(want) == 32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.delenv("LIGHTKURVE_TPU_MAST_FIXTURES")
    from lightkurve_tpu_torch.mast import RecordedMASTTransport
    transport = RecordedMASTTransport(copy.deepcopy(fixture))
    np.testing.assert_allclose(
        tmetrics.underfit_metric_neighbors(tc.corrected_lc,
                                           transport=transport,
                                           radius=5000),
        jmetrics.underfit_metric_neighbors(
            jc.corrected_lc, radius=5000,
            transport=jlk.mast.RecordedMASTTransport(
                copy.deepcopy(fixture))), rtol=RTOL)
    for mod, lc in ((jmetrics, jc.corrected_lc), (tmetrics, tc.corrected_lc)):
        with pytest.raises(mod.MinTargetsError, match="neighbors found"):
            mod.underfit_metric_neighbors(lc, radius=5000, min_targets=40,
                                          transport=copy.deepcopy(transport))
    for mod in (jmetrics, tmetrics):
        with pytest.raises(mod.MinTargetsError):
            mod.underfit_metric_neighbors(tc.corrected_lc, neighbor_flux=[])
        with pytest.raises(ValueError, match="same shape"):
            mod.underfit_metric_neighbors(
                tc.corrected_lc, neighbor_flux=[np.ones(5), np.ones(6)])


def test_align_to_lc_equal(files):
    jl, tl = read_both(files["tess_wide_lc"])
    jr, tr = read_both(files["tess_shifted_lc"])
    a, b = jmetrics._align_to_lc(jl, jr), tmetrics._align_to_lc(tl, tr)
    for name in a.columns:
        np.testing.assert_array_equal(np.asarray(getattr(b[name], "value",
                                                         b[name])),
                                      np.asarray(getattr(a[name], "value",
                                                         a[name])))


def test_error_paths_match(files):
    jl, tl = read_both(files["tess_lc"])
    kl, _ = read_both(files["kepler_lc"])
    _, tk = read_both(files["kepler_lc"])
    cases = [
        (lambda p, lc: p.correctors.CBVCorrector(lc), "no_dir"),
        (lambda p, lc: p.correctors.CBVCorrector(
            lc, extrapolate_cbvs=True, cbv_dir=files["tess"]), "extrap"),
        (lambda p, lc: p.correctors.CBVCorrector(
            lc.normalize(), cbv_dir=files["tess"]), "units"),
        (lambda p, lc: lc.to_corrector("cbv", cbv_dir=files["tess"])
         .correct_gaussian_prior(cbv_type="SingleScale"), "str_type"),
        (lambda p, lc: lc.to_corrector("cbv", cbv_dir=files["tess"])
         .correct_gaussian_prior(cbv_type=["SingleScale"],
                                 cbv_indices=["ALL", "ALL"]), "lengths"),
        (lambda p, lc: lc.to_corrector("cbv", cbv_dir=files["tess"])
         .correct_gaussian_prior(cbv_type=None, cbv_indices=None),
         "nothing"),
        (lambda p, lc: lc.to_corrector("cbv", cbv_dir=files["tess"])
         .correct_gaussian_prior(cbv_type=None), "xor"),
        (lambda p, lc: p.correctors.load_tess_cbvs(
            cbv_dir=files["tess"], sector=10, camera=2, ccd=4,
            cbv_type="MultiScale"), "no_band"),
        (lambda p, lc: p.correctors.load_tess_cbvs(
            cbv_dir=files["tess"], sector=10, camera=2, ccd=4, band=2),
         "band_single"),
        (lambda p, lc: p.correctors.load_tess_cbvs(
            cbv_dir=files["tess"], sector=10, camera=2, ccd=4,
            cbv_type="SuperSingleScale"), "bad_type"),
        (lambda p, lc: p.correctors.load_tess_cbvs(
            cbv_dir=os.path.join(files["tess"], "empty"), sector=10,
            camera=2, ccd=4), "no_file"),
        (lambda p, lc: p.correctors.load_kepler_cbvs(
            cbv_dir=files["kepler"], quarter=8), "no_channel"),
        (lambda p, lc: p.correctors.load_tess_cbvs(
            cbv_dir=files["tess"], sector=10, camera=2, ccd=4)
         .to_designmatrix(cbv_indices=[0]), "index_0"),
        (lambda p, lc: p.correctors.load_tess_cbvs(
            cbv_dir=files["tess"], sector=10, camera=2, ccd=4)
         .align(type(lc)(time=[1.0, 2.0], flux=[1.0, 2.0])), "no_cad"),
    ]
    for fn, name in cases:
        errs = []
        for pkg, lc in ((jlk, jl), (tlk, tl)):
            try:
                fn(pkg, lc)
            except Exception as e:          # noqa: BLE001 - compared below
                errs.append(type(e).__name__)
            else:
                errs.append(None)
        assert errs[0] is not None, (name, errs)
        assert errs[0] == errs[1], (name, errs)
    for pkg, lc in ((jlk, kl), (tlk, tk)):
        with pytest.raises(ValueError, match="Single-Scale"):
            lc.to_corrector("cbv", cbv_dir=files["kepler"]) \
                .correct_gaussian_prior(cbv_type=["Spike"])
    with pytest.raises(tutils.LightkurveError, match="network"):
        tl.to_corrector("cbv")
    assert jutils.LightkurveError.__name__ == tutils.LightkurveError.__name__
    # the plots' refusals, alike (their figures are test_torch_plots')
    for lc in (jl, tl):
        c = lc.to_corrector("cbv", cbv_dir=files["tess"])
        with pytest.raises(ValueError, match="correct"):
            c.diagnose()
        for bad in ("some", [0, 2]):
            with pytest.raises(ValueError, match="cbv_indices|index"):
                c.cbvs[0].plot(cbv_indices=bad)
