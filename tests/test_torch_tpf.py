"""lightkurve_tpu_torch's target pixel files, their collection and
``TPFStack`` against lightkurve_tpu's, on the same numpy inputs on the CPU
(the reference with x64 on; the port's configuration set to the CPU and
float64 by the ``port_on_cpu`` fixture).

Bars:
- equal: files written by the port's ``to_fits`` and read by both
  packages (every column, the quality mask, the aperture, the WCS, the
  meta), aperture masks (threshold, background, pipeline), quadratic
  centroids, ``cutout``, arithmetic, slicing, coordinates and
  ``from_fits_images`` of local files;
- rtol 1e-12: the device reductions (``to_lightcurve`` in each flux
  method, moment centroids, ``estimate_background``) and
  ``TPFStack.extract_aperture_photometry``;
- rtol 1e-9: ``TPFStack.pld_correct`` on JAX's PCA draw (the port's draw
  function patched), at orders 1 and 2, and on a sector of pixels under
  two momentum-dump drifts;
- on the port's own draw: corrected flux within :data:`OWN_DRAW_RTOL` of
  the aperture flux level of JAX's (the components span the same
  subspace up to rounding, see ``test_torch_solve``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkurve_tpu as jlk
import lightkurve_tpu_torch as tlk
from lightkurve_tpu import targetpixelfile as jtpf
from lightkurve_tpu.batch import TPFStack as JStack
from lightkurve_tpu.collections import TargetPixelFileCollection as JColl
from lightkurve_tpu_torch import batch as tbatch
from lightkurve_tpu_torch import config
from lightkurve_tpu_torch import targetpixelfile as ttpf
from lightkurve_tpu_torch.collections import TargetPixelFileCollection \
    as TColl
from lightkurve_tpu_torch.io import fits as tfits
from lightkurve_tpu_torch.ops import solve as tsolve
from test_torch_solve import jax_draw

RTOL = 1e-12
PLD_RTOL = 1e-9
#: pld_correct on the port's own PCA draw against JAX's draw: largest
#: difference over the median aperture flux
OWN_DRAW_RTOL = 1e-9


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's pixel classes on the CPU in float64, as the reference
    runs here with x64 on."""
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float64)


@pytest.fixture
def jax_pca_draw(monkeypatch):
    monkeypatch.setattr(tsolve, "gaussian_test_matrix", jax_draw)


def tpf_arrays(mission="TESS", n=120, shape=(9, 8), seed=0, motion=0.3):
    """A TPF's columns, primary meta, table header and aperture: a star
    with centroid motion, background, noise, NaN pixels, flagged cadences
    (a default-bitmask bit and one outside it) and, for TESS, NaN times."""
    rng = np.random.default_rng(seed)
    h, w = shape
    t0 = 1500.0 if mission == "TESS" else 500.0
    t = t0 + np.arange(n) * 0.02
    yy, xx = np.mgrid[:h, :w]
    dc = motion * np.sin(2 * np.pi * t / 0.7)
    dr = 0.5 * motion * np.cos(2 * np.pi * t / 0.9)
    c0, r0 = (w - 1) / 2 + 0.2, (h - 1) / 2 - 0.1
    star = 6000.0 * (1 - 0.002 * (np.mod(t - t0, 0.9) < 0.08))
    flux = np.exp(-((xx - c0 - dc[:, None, None]) ** 2
                    + (yy - r0 - dr[:, None, None]) ** 2) / (2 * 1.1 ** 2))
    flux = star[:, None, None] * flux / (2 * np.pi * 1.1 ** 2) + 20.0
    flux += 2.0 * rng.standard_normal(flux.shape)
    err = np.sqrt(np.abs(flux)) * 0.1
    flux[rng.random(flux.shape) < 0.01] = np.nan
    quality = np.zeros(n, np.int32)
    quality[[5, 40]] = 32 if mission == "TESS" else 1           # default
    quality[[7]] = 2 ** 20 if mission == "TESS" else 2 ** 19     # not
    if mission == "TESS":
        t[[11, 60]] = np.nan
    columns = {"TIME": t, "CADENCENO": np.arange(n, dtype=np.int32) + 100,
               "FLUX": flux.astype(np.float32),
               "FLUX_ERR": err.astype(np.float32),
               "FLUX_BKG": np.full(flux.shape, 3.0, np.float32),
               "FLUX_BKG_ERR": np.full(flux.shape, 0.5, np.float32),
               "QUALITY": quality,
               "POS_CORR1": dc.astype(np.float32),
               "POS_CORR2": dr.astype(np.float32)}
    meta = {"OBJECT": "synthetic",
            "TELESCOP": "TESS" if mission == "TESS" else "Kepler",
            "MISSION": mission, "RA_OBJ": 80.0, "DEC_OBJ": -70.0,
            "CREATOR": "TargetPixelExporterPipelineModule"}
    meta.update({"TICID": 99, "SECTOR": 3, "CAMERA": 1, "CCD": 2}
                if mission == "TESS" else
                {"KEPLERID": 99, "CAMPAIGN": 4, "CHANNEL": 42,
                 "MISSION": "K2"})
    header = {"1CRV5P": 100, "2CRV5P": 200,
              "BJDREFI": 2457000 if mission == "TESS" else 2454833,
              "1CRPX5": (w + 1) / 2, "2CRPX5": (h + 1) / 2,
              "1CRVL5": 80.0, "2CRVL5": -70.0,
              "1CDLT5": -21.0 / 3600, "2CDLT5": 21.0 / 3600,
              "11PC5": 1.0, "12PC5": 0.0, "21PC5": 0.0, "22PC5": 1.0,
              "1CTYP5": "RA---TAN", "2CTYP5": "DEC--TAN"}
    aperture = np.zeros(shape, np.int32)
    aperture[...] = 1
    aperture[int(r0) - 1:int(r0) + 2, int(c0) - 1:int(c0) + 2] = 3
    aperture[0, :] |= 4
    return columns, meta, header, aperture


def make_both(mission="TESS", **kw):
    """The same arrays as a JAX TPF and a port TPF (no file)."""
    columns, meta, header, aperture = tpf_arrays(mission, **kw)
    cls = "TessTargetPixelFile" if mission == "TESS" \
        else "KeplerTargetPixelFile"
    out = []
    for mod in (jtpf, ttpf):
        cols = {k: v.copy() for k, v in columns.items()}
        cols["TIME"] = np.nan_to_num(cols["TIME"])
        tpf = getattr(mod, cls)._from_arrays(cols, dict(meta),
                                             ext_header=dict(header),
                                             aperture=aperture.copy(),
                                             quality_bitmask="none")
        out.append(tpf)
    return out


def write_port_tpf(path, mission="TESS", **kw):
    """A TPF file written by the port's ``to_fits`` from raw columns (with
    the flagged cadences and NaN times still in it)."""
    columns, meta, header, aperture = tpf_arrays(mission, **kw)
    cls = ttpf.TessTargetPixelFile if mission == "TESS" \
        else ttpf.KeplerTargetPixelFile
    tpf = cls._from_arrays(columns, meta, ext_header=header,
                           aperture=aperture, quality_bitmask="none")
    tpf.to_fits(str(path))
    return str(path)


def values(x):
    return np.asarray(getattr(x, "value", x))


def assert_lc_close(a, b, rtol=RTOL):
    assert type(a).__name__ == type(b).__name__
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        va, vb = values(a[name]), values(b[name])
        if va.dtype.kind == "f":
            np.testing.assert_allclose(vb, va, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(vb, va, err_msg=name)


@pytest.mark.parametrize("mission", ["TESS", "K2"])
@pytest.mark.parametrize("bitmask", ["default", "none", "hard"])
def test_port_written_tpf_read_by_both(tmp_path, mission, bitmask):
    path = write_port_tpf(tmp_path / "tpf.fits", mission)
    j = jlk.read(path, quality_bitmask=bitmask)
    t = tlk.read(path, quality_bitmask=bitmask)
    assert type(t).__name__ == type(j).__name__ == (
        "TessTargetPixelFile" if mission == "TESS"
        else "KeplerTargetPixelFile")
    np.testing.assert_array_equal(t.quality_mask, j.quality_mask)
    if bitmask != "none":
        assert not t.quality_mask.all()
    assert sorted(t._columns) == sorted(j._columns)
    for k in j._columns:
        np.testing.assert_array_equal(t._columns[k], j._columns[k], k)
        np.testing.assert_array_equal(t._columns_raw[k],
                                      j._columns_raw[k], k)
    np.testing.assert_array_equal(t._aperture, j._aperture)
    np.testing.assert_array_equal(t.pipeline_mask, j.pipeline_mask)
    for attr in ("crpix", "crval", "cd"):
        np.testing.assert_array_equal(getattr(t.wcs, attr),
                                      getattr(j.wcs, attr))
    assert t.meta == j.meta
    assert (t.column, t.row, t.shape, t.targetid, t.mission) == (
        j.column, j.row, j.shape, j.targetid, j.mission)
    assert t.time.format == j.time.format
    np.testing.assert_array_equal(t.time.value, j.time.value)
    for a, b in zip(t.get_coordinates(), j.get_coordinates()):
        np.testing.assert_array_equal(a, b)
    if mission == "TESS":
        np.testing.assert_array_equal(t.background_mask, j.background_mask)


@pytest.mark.parametrize("mission", ["TESS", "K2"])
@pytest.mark.parametrize("aperture", ["default", "pipeline", "threshold",
                                      "all", "array"])
@pytest.mark.parametrize("flux_method", ["sum", "median", "mean"])
def test_to_lightcurve_matches_jax(mission, aperture, flux_method):
    j, t = make_both(mission)
    if aperture == "array":
        aperture = np.zeros(j.shape[1:], bool)
        aperture[2:6, 3:5] = True
    jl = j.to_lightcurve(aperture_mask=aperture, flux_method=flux_method)
    tl = t.to_lightcurve(aperture_mask=aperture, flux_method=flux_method)
    assert_lc_close(jl, tl)
    assert {k: v for k, v in jl.meta.items() if k != "APERTURE_MASK"} == \
        {k: v for k, v in tl.meta.items() if k != "APERTURE_MASK"}
    np.testing.assert_array_equal(tl.meta["APERTURE_MASK"],
                                  jl.meta["APERTURE_MASK"])


@pytest.mark.parametrize("kw", [{}, dict(threshold=1.5),
                                dict(threshold=2, reference_pixel=(1, 1)),
                                dict(threshold=0, reference_pixel=None)])
def test_threshold_masks_equal(kw):
    j, t = make_both("K2")
    np.testing.assert_array_equal(t.create_threshold_mask(**kw),
                                  j.create_threshold_mask(**kw))
    for name in ("background", "pipeline", "empty", "all"):
        np.testing.assert_array_equal(t._parse_aperture_mask(name),
                                      j._parse_aperture_mask(name))


@pytest.mark.parametrize("method", ["moments", "quadratic"])
@pytest.mark.parametrize("aperture", ["pipeline", "threshold"])
def test_centroids_match_jax(method, aperture):
    j, t = make_both("TESS")
    for a, b in zip(t.estimate_centroids(aperture, method=method),
                    j.estimate_centroids(aperture, method=method)):
        assert str(a.unit) == str(b.unit)
        if method == "quadratic":
            np.testing.assert_array_equal(a.value, b.value)
        else:
            np.testing.assert_allclose(a.value, b.value, rtol=RTOL,
                                       equal_nan=True)


def test_background_and_bkg_lightcurve_match_jax():
    j, t = make_both("TESS")
    for kw in ({}, {"aperture_mask": "all"}):
        assert_lc_close(j.estimate_background(**kw),
                        t.estimate_background(**kw))
    assert_lc_close(j.get_bkg_lightcurve(), t.get_bkg_lightcurve())
    assert_lc_close(j.get_bkg_lightcurve("pipeline"),
                    t.get_bkg_lightcurve("pipeline"))


def test_cutout_arithmetic_and_slicing_equal():
    j, t = make_both("K2")
    for kw in ({}, dict(center=(2, 3), size=3), dict(size=(4, 5))):
        jc, tc = j.cutout(**kw), t.cutout(**kw)
        assert tc.shape == jc.shape
        for k in jc._columns:
            np.testing.assert_array_equal(tc._columns[k], jc._columns[k])
        np.testing.assert_array_equal(tc._aperture, jc._aperture)
        assert dict(tc._ext_header) == dict(jc._ext_header)
    for op in (lambda a: a + 5.0, lambda a: a - 2.0, lambda a: a * 3.0,
               lambda a: a / 4.0, lambda a: 2.0 * a):
        for k in ("FLUX", "FLUX_ERR"):
            np.testing.assert_array_equal(op(t)._columns[k],
                                          op(j)._columns[k])
    for key in (3, slice(10, 40), np.arange(0, 100, 7)):
        for k in j._columns:
            np.testing.assert_array_equal(t[key]._columns[k],
                                          j[key]._columns[k])


def test_to_fits_round_trips_in_the_port(tmp_path):
    _, t = make_both("TESS")
    t.meta["CREATOR"] = "TargetPixelExporterPipelineModule"
    path = str(tmp_path / "back.fits")
    t.to_fits(path)
    back = tlk.read(path, quality_bitmask="none")
    for k in t._columns:
        np.testing.assert_array_equal(back._columns[k], t._columns[k])
    np.testing.assert_array_equal(back._aperture, t._aperture)
    assert isinstance(t.hdu, tfits.HDUList)


def write_images(directory, n=6, wcs=True):
    rng = np.random.default_rng(12)
    paths = []
    yy, xx = np.mgrid[:40, :50]
    for i in range(n):
        img = 100 + 5000 * np.exp(-((xx - 24.3) ** 2 + (yy - 19.6) ** 2)
                                  / 2.4) + rng.standard_normal((40, 50))
        hdr = {"TELESCOP": "TESS", "TIME": 100.0 + i, "CADENCENO": i,
               "SECTOR": 7}
        if wcs:
            hdr.update({"CRPIX1": 25.0, "CRPIX2": 20.0, "CRVAL1": 80.0,
                        "CRVAL2": -70.0, "CDELT1": -0.001,
                        "CDELT2": 0.001})
        p = os.path.join(directory, f"ffi{i:02d}.fits")
        tfits.write_fits(tfits.HDUList([
            tfits.PrimaryHDU(), tfits.ImageHDU(
                data=img.astype(np.float32), header=tfits.Header(hdr))]), p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("position", [None, (80.0, -70.0)])
def test_from_fits_images_equal(tmp_path, position):
    paths = write_images(str(tmp_path))
    j = jtpf.TessTargetPixelFile.from_fits_images(paths, position=position,
                                                  size=(7, 9))
    t = ttpf.TessTargetPixelFile.from_fits_images(paths, position=position,
                                                  size=(7, 9))
    assert type(t).__name__ == type(j).__name__
    for k in j._columns:
        np.testing.assert_array_equal(t._columns[k], j._columns[k], k)
    assert t.meta == j.meta
    assert dict(t._ext_header) == dict(j._ext_header)
    assert_lc_close(j.to_lightcurve(aperture_mask="threshold"),
                    t.to_lightcurve(aperture_mask="threshold"))


def test_read_tpf_collection_and_refusals(tmp_path):
    paths = [write_port_tpf(tmp_path / f"t{i}.fits", "TESS", seed=i)
             for i in range(3)]
    coll = tlk.read_tpf_collection(paths + [str(tmp_path / "missing")])
    assert isinstance(coll, TColl) and len(coll) == 3
    t = coll[0]
    # the plots draw the reference's figures for the same file
    # (test_torch_plots holds every TPF plot); the live sky view and the
    # solar-system query of a TPF raise, as the reference's do
    import matplotlib.pyplot as plt
    from test_torch_plots import assert_same_plot
    j = jlk.read(paths[0])
    for name in ("plot", "plot_pixels", "interact"):
        assert_same_plot(getattr(t, name)(), getattr(j, name)())
    assert_same_plot(t.animate(), j.animate())
    for tpf in (j, t):
        for name in ("interact_sky", "query_solar_system_objects"):
            with pytest.raises(NotImplementedError):
                getattr(tpf, name)()
    plt.close("all")
    lc = t.to_lightcurve(method="prf")
    assert len(lc) == len(t) and np.isfinite(lc.flux.value).all()


def stack_pair(n_targets=4, n=150, shape=(7, 7)):
    """The same TPFs as a JAX and a port collection and stack."""
    pairs = [make_both("TESS", n=n, shape=shape, seed=s, motion=0.25)
             for s in range(n_targets)]
    jc, tc = JColl([p[0] for p in pairs]), TColl([p[1] for p in pairs])
    return jc, tc, JStack.from_collection(jc, aperture_mask="pipeline"), \
        tc.to_stack(aperture_mask="pipeline", device="cpu",
                    dtype=torch.float64)


def test_stack_photometry_matches_jax_and_each_file():
    jc, tc, js, ts = stack_pair()
    jl, tl = js.extract_aperture_photometry(), ts.extract_aperture_photometry()
    for f in ("time", "flux", "flux_err", "mask"):
        np.testing.assert_allclose(getattr(tl, f).numpy(),
                                   np.asarray(getattr(jl, f)), rtol=RTOL)
    for i, tpf in enumerate(tc):
        lc = tpf.to_lightcurve(aperture_mask="pipeline")
        m = tl.mask[i].numpy()
        np.testing.assert_array_equal(m, np.isfinite(lc.flux.value))
        np.testing.assert_allclose(tl.flux[i].numpy()[m], lc.flux.value[m],
                                   rtol=RTOL)


@pytest.mark.parametrize("order", [1, 2])
def test_pld_correct_matches_jax(jax_pca_draw, order):
    _, _, js, ts = stack_pair()
    want = js.pld_correct(pld_order=order, n_pca_terms=3)
    got = ts.pld_correct(pld_order=order, n_pca_terms=3)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.flux.numpy(), np.asarray(want.flux),
                               rtol=PLD_RTOL)
    np.testing.assert_allclose(got.flux_err.numpy(),
                               np.asarray(want.flux_err), rtol=PLD_RTOL)


def test_pld_correct_own_draw_close_to_jax():
    _, _, js, ts = stack_pair()
    want = np.asarray(js.pld_correct().flux)
    got = ts.pld_correct().flux.numpy()
    scale = np.median(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < OWN_DRAW_RTOL


def sector_pixels(B=4, n=19_440, shape=(11, 11), seed=21,
                  drift=(0.06, 0.03)):
    """A TESS-like pixel stack (float32): a sector of two-minute cadences,
    Gaussian PSFs of 10^4-10^5 e/s on 10-50 e/s/px, photon noise, a
    pointing jitter of 0.05 px and a drift of ``drift`` px (column, row)
    reset every 3.125 d common to all, 3% of each target's cadences NaN;
    the aperture within 2 px of each PSF centre."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * (2.0 / 60 / 24)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    saw = np.mod(t, 3.125) / 3.125 - 0.5
    dc = drift[0] * saw + 0.05 * rng.standard_normal(n)
    dr = drift[1] * saw + 0.05 * rng.standard_normal(n)
    flux = np.empty((B, n, h, w), np.float32)
    err = np.empty_like(flux)
    ap = np.zeros((B, h, w), bool)
    for i in range(B):
        c0, r0 = 5 + rng.uniform(-0.3, 0.3, 2)
        s = rng.uniform(0.8, 1.2)
        psf = np.exp(-((xx - c0 - dc[:, None, None]) ** 2
                       + (yy - r0 - dr[:, None, None]) ** 2) / (2 * s * s))
        img = 10 ** rng.uniform(4, 5) * psf / (2 * np.pi * s * s) \
            + rng.uniform(10, 50)
        e = np.sqrt(img / 120.0)
        flux[i] = img + e * rng.standard_normal(img.shape)
        flux[i, rng.random(n) < 0.03] = np.nan
        err[i] = e
        ap[i] = np.hypot(xx - c0, yy - r0) <= 2.0
    return tbatch.TPFStack(flux=torch.as_tensor(flux),
                           flux_err=torch.as_tensor(err),
                           time=torch.as_tensor(np.tile(t, (B, 1))),
                           aperture=torch.as_tensor(ap))


def dump_residual(flux, mask, t, period=3.125, n_bins=50):
    """Each target's corrected flux over its median, binned in the phase of
    the momentum dumps: the largest less the smallest bin median."""
    b = np.floor(np.mod(t, period) / period * n_bins).astype(int)
    out = []
    for f, m in zip(flux, mask):
        r = f[m] / np.median(f[m]) - 1
        med = [np.median(r[b[m] == k]) for k in range(n_bins)]
        out.append(max(med) - min(med))
    return np.array(out)


@pytest.mark.parametrize("drift,deeper", [((0.06, 0.03), False),
                                          ((0.3, 0.15), True)])
def test_pld_correct_matches_jax_under_dump_drift(jax_pca_draw, drift,
                                                   deeper):
    """A sector of pixels with a momentum-dump drift of 0.06 and of 0.3 px
    per cycle, order-1 PLD with 3 components: the port's corrected flux
    within rtol 1e-9 of the reference's, so what either leaves at the dump
    period is the other's too.  At 0.3 px the reference leaves a residual
    in the dump phase deeper than the 400-ppm transits of the card's
    pixel phase; at 0.06 px it does not."""
    st = sector_pixels(drift=drift)
    ts = tbatch.TPFStack(flux=st.flux.double(),
                         flux_err=st.flux_err.double(), time=st.time,
                         aperture=st.aperture)
    js = JStack(flux=jnp.asarray(ts.flux.numpy()),
                flux_err=jnp.asarray(ts.flux_err.numpy()),
                time=jnp.asarray(ts.time.numpy()),
                aperture=jnp.asarray(ts.aperture.numpy()))
    got, want = ts.pld_correct(), js.pld_correct()
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_allclose(got.flux.numpy(), np.asarray(want.flux),
                               rtol=PLD_RTOL)
    residual = dump_residual(np.asarray(want.flux), m, ts.time[0].numpy())
    assert (residual.max() > 4e-4) == deeper


#: ROADMAP C4: float32 pld_correct against float64 on the same float32
#: pixels, the largest difference over each target's median flux
C4_RTOL = 1e-5


def c4_gap(stack32, monkeypatch=None):
    want = tbatch.TPFStack(flux=stack32.flux.double(),
                           flux_err=stack32.flux_err.double(),
                           time=stack32.time.double(),
                           aperture=stack32.aperture).pld_correct()
    got = stack32.pld_correct()
    assert got.flux.dtype == torch.float32
    assert torch.equal(got.mask, want.mask)
    g, w, m = got.flux.double().numpy(), want.flux.numpy(), want.mask.numpy()
    return max(np.abs(g[i] - w[i])[m[i]].max() / np.median(w[i][m[i]])
               for i in range(len(w)))


def test_float32_pld_correct_solves_in_float64(monkeypatch):
    """ROADMAP C4: in float32, ``pld_correct`` keeps the corrected flux
    within :data:`C4_RTOL` of float64 (a fortieth of a 400-ppm transit)
    because it solves in float64; with the same solves in float32 the gap
    passes the bar (the NaN cadences' rows of zero pixels, which the
    reference's PCA takes in, leave the float32 normal equations
    ill-conditioned: ROADMAP C)."""
    stack = sector_pixels()
    assert c4_gap(stack) < C4_RTOL
    fit = tsolve.iterative_clipped_regression

    def float32_fit(X, y, fe, mask, mu, sig, **kw):
        w, m, s = fit(X.float(), y.float(), fe.float(), mask, mu.float(),
                      sig.float(), **kw)
        return w.double(), m, s.double()

    monkeypatch.setattr(tsolve, "iterative_clipped_regression", float32_fit)
    assert c4_gap(stack) > C4_RTOL


def test_float32_moment_centroids_keep_sub_micropixel_offsets(monkeypatch):
    """ROADMAP C5: in float32 the moment centroids of a cutout whose
    corner sits at column 1000, row 2000 stay within 5e-6 px of float64
    (an absolute float32 column there is quantised at 6e-5 px, and SFF's
    arclength, which matches values across windows, then goes wrong)."""
    _, t = make_both("K2")
    t._ext_header.update({"1CRV5P": 1000, "2CRV5P": 2000})
    want = [c.value for c in t.estimate_centroids("pipeline")]
    monkeypatch.setattr(config, "default_dtype", torch.float32)
    got = [c.value for c in t.estimate_centroids("pipeline")]
    assert got[0].dtype == np.float64
    for g, w in zip(got, want):
        assert np.nanmax(np.abs(g - w)) < 5e-6
        assert np.nanmin(w) > 999
