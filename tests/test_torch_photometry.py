"""lightkurve_tpu_torch's ops/photometry.py against lightkurve_tpu's on the
same numpy cubes, on the CPU in float64: aperture photometry (sum, median,
mean), moment centroids and the background estimate, over one target and
a batch of targets, with NaN pixels, cadences whose aperture is all NaN,
cadences whose image is all zero and errors that are all NaN.  Bar: rtol
1e-12, NaN where the reference gives NaN."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightkurve_tpu.ops import photometry as jphot
from lightkurve_tpu_torch.ops import photometry as tphot

RTOL = 1e-12


def cube(lead, seed=0, t=40, h=7, w=6):
    """A star on a background, NaN pixels, one cadence with an all-NaN
    aperture, one all-zero cadence and one cadence of NaN errors."""
    rng = np.random.default_rng(seed)
    flux = 100.0 + 50.0 * rng.random(lead + (t, h, w))
    flux[..., 3, 3] += 5000.0
    err = np.sqrt(np.abs(flux))
    flux[rng.random(flux.shape) < 0.05] = np.nan
    aperture = np.zeros(lead + (h, w), bool)
    aperture[..., 2:5, 2:5] = True
    aperture[..., 0, 0] = True
    flux[..., 4, 2:5, 2:5] = np.nan
    flux[..., 4, 0, 0] = np.nan
    flux[..., 7, :, :] = 0.0
    err[..., 9, :, :] = np.nan
    bkg = ~aperture
    return flux, err, aperture, bkg


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0, equal_nan=True)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("method", ["sum", "median", "mean"])
def test_aperture_photometry_matches_jax(lead, method):
    flux, err, aperture, _ = cube(lead)
    jf, je = jphot.aperture_photometry_cube(
        jnp.asarray(flux), jnp.asarray(err), jnp.asarray(aperture),
        flux_method=method)
    tf, te = tphot.aperture_photometry_cube(
        torch.as_tensor(flux), torch.as_tensor(err),
        torch.as_tensor(aperture), flux_method=method)
    close(tf, jf)
    close(te, je)
    assert np.all(np.isnan(tf.numpy()[..., [4, 7]]))
    assert np.all(np.isnan(te.numpy()[..., 9]))
    with pytest.raises(ValueError):
        tphot.aperture_photometry_cube(torch.as_tensor(flux),
                                       torch.as_tensor(err),
                                       torch.as_tensor(aperture), "max")


@pytest.mark.parametrize("lead", [(), (3,)])
def test_centroid_moments_matches_jax(lead):
    flux, _, aperture, _ = cube(lead, seed=1)
    jc, jr = jphot.centroid_moments_cube(jnp.asarray(flux),
                                         jnp.asarray(aperture), 100, 200)
    tc, tr = tphot.centroid_moments_cube(torch.as_tensor(flux),
                                         torch.as_tensor(aperture), 100, 200)
    close(tc, jc)
    close(tr, jr)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("per_cadence", [False, True])
def test_background_estimate_matches_jax(lead, per_cadence):
    flux, _, _, bkg = cube(lead, seed=2)
    if per_cadence:
        bkg = np.broadcast_to(bkg[..., None, :, :], flux.shape).copy()
        bkg[..., 5, :, :] = False                  # a cadence with none
    want = jphot.background_estimate_cube(jnp.asarray(flux),
                                          jnp.asarray(bkg))
    got = tphot.background_estimate_cube(torch.as_tensor(flux),
                                         torch.as_tensor(bkg))
    close(got, want)
