"""lightkurve_tpu_torch's ops/solve.py and ops/peaks.py against
lightkurve_tpu's, on the same numpy inputs on the CPU in float64.

Bars:
- rtol 1e-9: ``solve_regression`` (with and without priors, masked rows,
  batched), ``iterative_clipped_regression`` (its final mask equal),
  ``chol_solve_small`` (its 1e-30 pivot clamp on a zero row included),
  ``elasticnet_fista`` and ``fit_gaussian_lm``;
- ``randomized_pca`` on JAX's own Gaussian draw (the port's draw function
  patched): singular values rtol 1e-10, components within 1e-10 after each
  column's sign is aligned (an SVD's signs are a convention);
- on the port's own draw (a torch generator cannot repeat JAX's): the
  components' projection matrices within :data:`OWN_DRAW_PROJ_TOL` of
  JAX's, where the spectrum has a gap after the kept components;
- ``find_peaks_mask``: equal to JAX's and to scipy's ``find_peaks``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import find_peaks

from lightkurve_tpu.ops import peaks as jpeaks
from lightkurve_tpu.ops import solve as jsolve
from lightkurve_tpu_torch.ops import peaks as tpeaks
from lightkurve_tpu_torch.ops import solve as tsolve

RTOL = 1e-9
PCA_TOL = 1e-10
#: the port's own PCA draw against JAX's draw: largest entry of the
#: difference of the two projection matrices U Uᵀ (10 power iterations on
#: a spectrum with a gap of 10x after the kept components)
OWN_DRAW_PROJ_TOL = 1e-8


def t(x):
    return torch.as_tensor(np.asarray(x))


def jax_draw(seed, shape, dtype, device):
    """JAX's Gaussian test matrix of ``randomized_pca``, handed over as
    numpy: with it the port's PCA repeats the reference's."""
    g = jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float64)
    return torch.as_tensor(np.array(g), dtype=dtype, device=device)


@pytest.fixture
def jax_pca_draw(monkeypatch):
    monkeypatch.setattr(tsolve, "gaussian_test_matrix", jax_draw)


def regression_inputs(rng, B=None, n=240, k=6, outliers=True):
    lead = () if B is None else (B,)
    X = rng.standard_normal(lead + (n, k))
    X[..., -1] = 1.0
    w_true = rng.standard_normal(lead + (k,)) * 3
    fe = rng.uniform(0.5, 2.0, lead + (n,))
    y = np.einsum("...nk,...k->...n", X, w_true) + fe * rng.standard_normal(
        lead + (n,))
    if outliers:
        out = rng.random(lead + (n,)) < 0.03
        y[out] += 25 * fe[out]
    mask = rng.random(lead + (n,)) > 0.05
    return X, y, fe, mask


@pytest.mark.parametrize("priors", ["none", "sigma", "mu_sigma"])
def test_solve_regression_matches_jax(priors):
    rng = np.random.default_rng(1)
    X, y, fe, mask = regression_inputs(rng)
    k = X.shape[1]
    mu = sig = None
    if priors != "none":
        sig = rng.uniform(0.5, 5.0, k)
        sig[-1] = np.inf
        mu = rng.standard_normal(k) if priors == "mu_sigma" else None
    jw, js = jsolve.solve_regression(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(fe), jnp.asarray(mask),
        None if mu is None else jnp.asarray(mu),
        None if sig is None else jnp.asarray(sig))
    tw, ts = tsolve.solve_regression(
        t(X), t(y), t(fe), t(mask), None if mu is None else t(mu),
        None if sig is None else t(sig))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)


def test_solve_regression_batched_matches_jax_vmap():
    rng = np.random.default_rng(2)
    X, y, fe, mask = regression_inputs(rng, B=4)
    k = X.shape[-1]
    sig = np.full(k, 10.0)
    jw, js = jax.vmap(lambda *a: jsolve.solve_regression(
        *a, jnp.zeros(k), jnp.asarray(sig)))(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(fe), jnp.asarray(mask))
    tw, ts = tsolve.solve_regression(t(X), t(y), t(fe), t(mask),
                                     torch.zeros(k, dtype=torch.float64),
                                     t(sig))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)


@pytest.mark.parametrize("batched", [False, True])
def test_iterative_clipped_regression_matches_jax(batched):
    rng = np.random.default_rng(3)
    X, y, fe, mask = regression_inputs(rng, B=3 if batched else None)
    k = X.shape[-1]
    mu, sig = np.zeros(k), np.full(k, np.inf)

    def jfit(X, y, fe, mask):
        return jsolve.iterative_clipped_regression(
            X, y, fe, mask, jnp.asarray(mu), jnp.asarray(sig), sigma=3.0,
            niters=4)

    jargs = [jnp.asarray(a) for a in (X, y, fe, mask)]
    jw, jm, js = (jax.vmap(jfit) if batched else jfit)(*jargs)
    tw, tm, ts = tsolve.iterative_clipped_regression(
        t(X), t(y), t(fe), t(mask), t(mu), t(sig), sigma=3.0, niters=4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (~tm.numpy() & mask).sum() > 0          # outliers were clipped
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)


@pytest.mark.parametrize("case", ["spd3", "spd5_batched", "zero_row",
                                  "zero_row_rhs"])
def test_chol_solve_small_matches_jax(case):
    rng = np.random.default_rng(4)
    k = 5 if case == "spd5_batched" else 3
    lead = (7,) if case == "spd5_batched" else ()
    M = rng.standard_normal(lead + (k, k))
    A = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(k)
    b = rng.standard_normal(lead + (k,))
    if case.startswith("zero_row"):
        # an all-zero Jacobian column: the reference clamps its pivot to
        # 1e-30, so x there is b there times 1e30 (0 for a zero b)
        A[1, :] = 0.0
        A[:, 1] = 0.0
        b[1] = 0.0 if case == "zero_row" else 1e-25
    want = np.asarray(jsolve.chol_solve_small(jnp.asarray(A),
                                              jnp.asarray(b)))
    got = tsolve.chol_solve_small(t(A), t(b)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("l1_ratio", [0.0, 0.5, 1.0])
def test_elasticnet_fista_matches_jax(l1_ratio):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((300, 8))
    w = np.array([2.0, 0, 0, -1.5, 0, 0.5, 0, 0])
    y = X @ w + 0.1 * rng.standard_normal(300)
    want = np.asarray(jsolve.elasticnet_fista(
        jnp.asarray(X), jnp.asarray(y), 0.05, l1_ratio))
    got, iterations = tsolve.elasticnet_fista(t(X), t(y), 0.05, l1_ratio)
    got = got.numpy()
    assert 0 < iterations < 50_000
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


def low_rank(rng, lead=(), m=300, n=40, k=4):
    """A matrix whose k leading singular values stand 10x above the rest."""
    U, _ = np.linalg.qr(rng.standard_normal(lead + (m, n)))
    V, _ = np.linalg.qr(rng.standard_normal(lead + (n, n)))
    s = np.concatenate([[20.0, 12.0, 7.0, 4.0][:k],
                        0.3 * np.linspace(1, 0.1, n - k)])
    return (U * s) @ np.swapaxes(V, -1, -2)


def align_signs(got, want):
    """Flip each column of ``got`` (..., m, k) to the sign of ``want``'s."""
    sign = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    return got * sign


@pytest.mark.parametrize("lead", [(), (3,)])
def test_randomized_pca_matches_jax_on_its_draw(jax_pca_draw, lead):
    rng = np.random.default_rng(6)
    A = low_rank(rng, lead)
    fn = lambda a: jsolve.randomized_pca(a, 4)  # noqa: E731
    for _ in lead:
        fn = jax.vmap(fn)
    jU, js, jVt = (np.asarray(x) for x in fn(jnp.asarray(A)))
    tU, ts, tVt = (x.numpy() for x in tsolve.randomized_pca(t(A), 4))
    np.testing.assert_allclose(ts, js, rtol=PCA_TOL)
    np.testing.assert_allclose(align_signs(tU, jU), jU, rtol=0, atol=PCA_TOL)
    np.testing.assert_allclose(
        align_signs(np.swapaxes(tVt, -1, -2), np.swapaxes(jVt, -1, -2)),
        np.swapaxes(jVt, -1, -2), rtol=0, atol=PCA_TOL)


def test_randomized_pca_own_draw_spans_jax_subspace():
    rng = np.random.default_rng(7)
    A = low_rank(rng, (2,))
    jU = np.asarray(jax.vmap(lambda a: jsolve.randomized_pca(a, 4)[0])(
        jnp.asarray(A)))
    tU = tsolve.randomized_pca(t(A), 4)[0].numpy()
    proj = lambda U: U @ np.swapaxes(U, -1, -2)  # noqa: E731
    assert np.max(np.abs(proj(tU) - proj(jU))) < OWN_DRAW_PROJ_TOL
    # the draw is the seed's: two calls agree bit for bit, another seed not
    again = tsolve.randomized_pca(t(A), 4)[0].numpy()
    np.testing.assert_array_equal(again, tU)
    g0 = tsolve.gaussian_test_matrix(0, (5, 3), torch.float64, "cpu")
    g1 = tsolve.gaussian_test_matrix(1, (5, 3), torch.float64, "cpu")
    assert not torch.equal(g0, g1)


@pytest.mark.parametrize("distance", [1, 3, 7.5])
def test_find_peaks_mask_matches_jax_and_scipy(distance):
    """Equal to JAX's, also where equal peaks tie (values rounded), and
    to scipy's where no two peaks tie (scipy breaks ties the other way)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal(200)
    x[50:54] = 5.0                                # a flat-topped peak
    for values in (x, np.round(x, 1)):
        got = tpeaks.find_peaks_mask(t(values), distance).numpy()
        want = np.asarray(jpeaks.find_peaks_mask(jnp.asarray(values),
                                                 distance))
        np.testing.assert_array_equal(got, want)
    got = tpeaks.find_peaks_mask(t(x), distance).numpy()
    np.testing.assert_array_equal(np.nonzero(got)[0],
                                  find_peaks(x, distance=distance)[0])


@pytest.mark.parametrize("p0", [(100.0, 0.0, 0.01), (50.0, 0.005, 0.015)])
def test_fit_gaussian_lm_matches_jax(p0):
    rng = np.random.default_rng(9)
    x = np.linspace(-0.05, 0.05, 400)
    y = 80.0 * np.exp(-0.5 * ((x - 0.003) / 0.008) ** 2)
    y = np.maximum(y + rng.standard_normal(400), 0.0)
    w = np.sqrt(np.maximum(y, 1e-12))
    want = np.asarray(jpeaks.fit_gaussian_lm(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), np.asarray(p0)))
    got = tpeaks.fit_gaussian_lm(t(x), t(y), t(w), p0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
