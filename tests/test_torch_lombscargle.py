"""The Lomb-Scargle engines of lightkurve_tpu_torch against lightkurve_tpu.

The same numpy inputs, made from a seed, go through each ported function
and its JAX counterpart on the CPU in float64 (x64 on, as conftest sets
it); the FFT methods against both FFT backends of the reference
(``conf.fft_backend`` "custom", its split-real matmul FFT, and "native",
``jnp.fft``).  Bars:

- equal: ``fast_precompute`` (also where a float32 fraction would round
  to 1.0), ``bls_objective_single``'s ``in_transit``, the frequencies of
  ``to_periodogram``;
- rtol 1e-12: ``extirpolate``, ``extirpolate_batched``;
- 1e-9 of each row's largest value: ``trig_sum``, ``lombscargle_fast``,
  ``lombscargle_fastchi2`` (also on a grid up to Nyquist, where its rank
  truncation engages), ``to_periodogram``;
- rtol 1e-10: ``lombscargle_direct``, ``lombscargle_chi2``, the entry-list
  Cholesky, ``bls_objective_single``'s statistics;
- the numpy oracles of ``tests/oracles.py`` at the bars that
  ``tests/test_ops_lombscargle.py`` holds the reference to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightkurve_tpu.batch import LightCurveStack as JStack
from lightkurve_tpu.config import conf
from lightkurve_tpu.ops import bls as jbls
from lightkurve_tpu.ops import lombscargle as jls
from lightkurve_tpu_torch.batch import LightCurveStack as TStack
from lightkurve_tpu_torch.ops import bls as tbls
from lightkurve_tpu_torch.ops import lombscargle as tls
from oracles import ls_fast, ls_slow

ROW_RTOL = 1e-9
RTOL = 1e-10
EXTIRP_RTOL = 1e-12
NORMALIZATIONS = ("standard", "model", "log", "psd")
F0, DF, NF = 0.05, 0.003, 700


def t_(a):
    return torch.from_numpy(np.asarray(a))


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_rows(got, want, rtol=ROW_RTOL, err_msg=""):
    """Within ``rtol`` of each row's largest |value|."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    err = np.max(np.abs(got - want) / scale)
    assert err <= rtol, f"{err_msg}: {err:.3g} of the row's largest"


def assert_close(got, want, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=0,
                               err_msg=err_msg)


@pytest.fixture(params=["custom", "native"])
def fft_backend(request):
    """The reference's FFT backend; it binds when a function is traced,
    so the jit caches are cleared around each switch."""
    old = conf.fft_backend
    conf.fft_backend = request.param
    jax.clear_caches()
    yield request.param
    conf.fft_backend = old
    jax.clear_caches()


def curves(rng, n=400, B=3, baseline=27.0):
    """Times, B sinusoids with noise, shared and per-curve dy."""
    t = np.sort(rng.uniform(0, baseline, n))
    Y = np.stack([1.0 + 0.01 * np.sin(2 * np.pi * t / 2.5),
                  1.0 + 0.02 * np.cos(2 * np.pi * t / 5.0 + 0.3),
                  1.0 + 0.004 * np.sin(2 * np.pi * t / 0.7)])[:B]
    Y = Y + 2e-3 * rng.normal(size=Y.shape)
    return t, Y, rng.uniform(1e-3, 3e-3, n), rng.uniform(1e-3, 3e-3, (B, n))


def pick_dy(kind, dy, dyB):
    return {"none": None, "shared": dy, "per-curve": dyB}[kind]


# ---------------------------------------------------------------------------
# host set-up and extirpolation
# ---------------------------------------------------------------------------
def boundary_times():
    """A regular grid plus one time whose float64 grid fraction is
    1 - 2^-30: it rounds to 1.0 in float32 unless re-split."""
    Nfft = jls.fast_precompute(np.array([0.0, 1.0, 2.0]), 0.05, 0.01,
                               100)["Nfft"]
    t_bad = (5.0 + (1.0 - 2.0 ** -30)) / (Nfft * 0.01)
    return np.sort(np.concatenate([np.arange(64) * 0.37, [t_bad]]))


@pytest.mark.parametrize("case", ["random", "frac_boundary"])
def test_fast_precompute_matches_jax(rng, case):
    if case == "random":
        t, args = curves(rng)[0] + 2457000.0, (F0, DF, NF, 5, 4)
    else:
        t, args = boundary_times(), (0.05, 0.01, 100)
    want = jls.fast_precompute(t, *args)
    got = tls.fast_precompute(t, *args)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert (got["frac"].astype(np.float32) < 1.0).all()


def test_boundary_time_gives_finite_float32_power():
    t = boundary_times()
    y = 1 + 0.01 * np.sin(2 * np.pi * 0.4 * t)
    power = tls.lombscargle_fast(t, t_(y.astype(np.float32)), 0.05, 0.01, 100)
    assert power.dtype == torch.float32
    assert bool(torch.isfinite(power).all())


@pytest.mark.parametrize("batched", [False, True])
def test_extirpolate_matches_jax(rng, batched):
    """Synthetic grid positions: exact hits (frac 0), and bins at both
    ends of the grid, where the spread is clamped."""
    N, M, n = 256, 4, 500
    xi = rng.integers(0, N, n)
    xi[:6] = [0, 1, N - 1, N - 2, 0, N - 1]
    frac = rng.random(n)
    frac[rng.random(n) < 0.1] = 0.0
    frac[4:6] = 0.0
    y = rng.normal(size=(3, n)) if batched else rng.normal(size=n)
    jfn, tfn = ((jls.extirpolate_batched, tls.extirpolate_batched)
                if batched else (jls.extirpolate, tls.extirpolate))
    want = np.asarray(jfn(jnp.asarray(xi, jnp.int32), jnp.asarray(frac),
                          jnp.asarray(y), N, M))
    got = tfn(t_(xi), t_(frac), t_(y), N, M)
    assert got.shape == want.shape
    np.testing.assert_allclose(np_(got), want, rtol=EXTIRP_RTOL, atol=0)


def test_precompute_cache_keys_on_dtype(rng):
    t = curves(rng)[0]
    a = tls._fast_precompute_device(t, F0, DF, NF, 5, 4, torch.float64,
                                    torch.device("cpu"))
    assert tls._fast_precompute_device(t, F0, DF, NF, 5, 4, torch.float64,
                                       torch.device("cpu")) is a
    b = tls._fast_precompute_device(t, F0, DF, NF, 5, 4, torch.float32,
                                    torch.device("cpu"))
    assert b["frac"].dtype == torch.float32 and a["xi"].dtype == torch.int64
    assert torch.equal(b["xi"], a["xi"])


# ---------------------------------------------------------------------------
# trig sums and the fast periodogram
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batched", [False, True])
def test_trig_sum_matches_jax(rng, fft_backend, batched):
    t, Y, _, _ = curves(rng)
    h = Y if batched else Y[0]
    for f0, factor in ((0.0, 1), (F0, 2)):
        want = jls.trig_sum(t, jnp.asarray(h), DF, NF, f0=f0,
                            freq_factor=factor)
        got = tls.trig_sum(t, t_(h), DF, NF, f0=f0, freq_factor=factor)
        for g, w, name in zip(got, want, "SC"):
            assert_rows(g, w, err_msg=f"{name} f0={f0} x{factor}")


@pytest.mark.parametrize("normalization", NORMALIZATIONS)
@pytest.mark.parametrize("dy_kind", ["none", "shared", "per-curve"])
def test_fast_matches_jax(rng, fft_backend, dy_kind, normalization):
    t, Y, dy, dyB = curves(rng)
    d = pick_dy(dy_kind, dy, dyB)
    kw = dict(normalization=normalization)
    want = jls.lombscargle_fast(t, jnp.asarray(Y), F0, DF, NF,
                                dy=None if d is None else jnp.asarray(d),
                                **kw)
    got = tls.lombscargle_fast(t, t_(Y), F0, DF, NF,
                               dy=None if d is None else t_(d), **kw)
    assert_rows(got, want, err_msg="batched")
    d1 = None if d is None else d[-1] if d.ndim == 2 else d
    want = jls.lombscargle_fast(t, jnp.asarray(Y[-1]), F0, DF, NF,
                                dy=None if d1 is None else jnp.asarray(d1),
                                **kw)
    got = tls.lombscargle_fast(t, t_(Y[-1]), F0, DF, NF,
                               dy=None if d1 is None else t_(d1), **kw)
    assert_rows(got, want, err_msg="single")


@pytest.mark.parametrize("fit_mean,center_data",
                         [(False, True), (False, False), (True, False)])
def test_fast_fit_mean_center_data_match_jax(rng, fft_backend, fit_mean,
                                             center_data):
    t, Y, dy, _ = curves(rng)
    kw = dict(fit_mean=fit_mean, center_data=center_data)
    want = jls.lombscargle_fast(t, jnp.asarray(Y), F0, DF, NF,
                                dy=jnp.asarray(dy), **kw)
    got = tls.lombscargle_fast(t, t_(Y), F0, DF, NF, dy=t_(dy), **kw)
    assert_rows(got, want)


# ---------------------------------------------------------------------------
# fastchi2 and its truncated solve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nterms", [1, 2, 3])
def test_fastchi2_matches_jax(rng, fft_backend, nterms):
    """One curve with dy None, the batch over shared dy, the batch over
    per-curve dy; the normalizations in turn."""
    t, Y, dy, dyB = curves(rng)
    cases = (("standard", Y[0], None), ("psd", Y, dy),
             (NORMALIZATIONS[nterms - 1], Y, dyB))
    for norm, y, d in cases:
        kw = dict(nterms=nterms, normalization=norm)
        want = jls.lombscargle_fastchi2(
            t, jnp.asarray(y), F0, DF, NF,
            dy=None if d is None else jnp.asarray(d), **kw)
        got = tls.lombscargle_fastchi2(t, t_(y), F0, DF, NF,
                                       dy=None if d is None else t_(d), **kw)
        assert_rows(got, want, err_msg=f"{norm} dy={np.shape(d)}")


def nyquist_case():
    """tests/test_ops_lombscargle.py::test_fastchi2_near_nyquist_no_blowup:
    a regular grid searched up to its Nyquist frequency."""
    t = np.arange(300) * 0.02
    y = (1.0 + 3e-3 * np.sin(2 * np.pi * t / 1.3)
         + 1.5e-3 * np.sin(4 * np.pi * t / 1.3))
    df = 1.0 / (t[-1] - t[0]) / 5.0
    return t, y, df, df, int(25.0 / df)


def test_fastchi2_near_nyquist_truncates_as_jax(fft_backend):
    t, y, f0, df, Nf = nyquist_case()
    Y = np.stack([y, 1.0 + 2e-3 * np.cos(2 * np.pi * t / 0.9)])
    kw = dict(nterms=2, normalization="psd")
    want = jls.lombscargle_fastchi2(t, jnp.asarray(Y), f0, df, Nf, **kw)
    got = tls.lombscargle_fastchi2(t, t_(Y), f0, df, Nf, **kw)
    assert_rows(got, want)
    # the truncation engages on this grid: without it the power leaves
    # the bound of the total chi2, with it both packages stay inside it
    chi2_ref = np.sum((Y - Y.mean(axis=1, keepdims=True)) ** 2, axis=1)
    free = tls.lombscargle_fastchi2(t, t_(Y), f0, df, Nf, rcond=0.0, **kw)
    assert not np.all(np_(free).max(axis=1) <= chi2_ref * 1.001)
    assert np.all(np_(got).max(axis=1) <= chi2_ref * 1.001)


@pytest.mark.parametrize("rcond", [0.0, 1e-6])
def test_chol_quadform_rows_match_jax(rng, rcond):
    """Entry lists of SPD systems, some of them rank-deficient up to a
    perturbation of 1e-9 (where the truncation drops a column), against
    the reference's solve; and the stacked view against numpy."""
    k, batch = 5, 64
    X = rng.normal(size=(batch, k + 3, k))
    X[: batch // 2, :, -1] = (X[: batch // 2, :, 0]
                              + 1e-9 * rng.normal(size=(batch // 2, k + 3)))
    A = np.einsum("bni,bnj->bij", X, X) + 1e-12 * np.eye(k)
    b = rng.normal(size=(batch, k))
    rows = [[A[:, i, j] for j in range(k)] for i in range(k)]
    want = np.asarray(jls._chol_quadform_rows(
        [[jnp.asarray(a) for a in r] for r in rows],
        [jnp.asarray(b[:, i]) for i in range(k)], rcond=rcond))
    got = tls._chol_quadform_rows([[t_(a) for a in r] for r in rows],
                                  [t_(b[:, i]) for i in range(k)],
                                  rcond=rcond)
    assert_close(got, want)
    good = slice(batch // 2, None)
    solve = np.einsum("bi,bi->b", b, np.linalg.solve(A, b[..., None])[..., 0])
    assert_close(tls._chol_quadform(t_(A[good]), t_(b[good])), solve[good],
                 rtol=5e-5)


# ---------------------------------------------------------------------------
# the direct methods
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normalization", NORMALIZATIONS)
@pytest.mark.parametrize("with_dy", [False, True])
def test_direct_matches_jax(rng, normalization, with_dy):
    """300 frequencies in chunks of 128: the last chunk is ragged."""
    t, Y, dy, _ = curves(rng)
    freqs = np.linspace(0.05, 2.0, 300)
    d = dy if with_dy else None
    kw = dict(normalization=normalization, chunk=128)
    want = jls.lombscargle_direct(jnp.asarray(t), jnp.asarray(Y),
                                  jnp.asarray(freqs),
                                  dy=None if d is None else jnp.asarray(d),
                                  **kw)
    got = tls.lombscargle_direct(t_(t), t_(Y), t_(freqs),
                                 dy=None if d is None else t_(d), **kw)
    assert_close(got, want)


@pytest.mark.parametrize("method", ["direct", "chi2"])
@pytest.mark.parametrize("center_data", [False, True])
def test_direct_without_mean_fit_matches_jax(rng, method, center_data):
    t, Y, dy, _ = curves(rng)
    freqs = np.linspace(0.05, 2.0, 200)
    kw = dict(fit_mean=False, center_data=center_data)
    jfn = getattr(jls, f"lombscargle_{method}")
    tfn = getattr(tls, f"lombscargle_{method}")
    want = jfn(jnp.asarray(t), jnp.asarray(Y), jnp.asarray(freqs),
               dy=jnp.asarray(dy), **kw)
    assert_close(tfn(t_(t), t_(Y), t_(freqs), dy=t_(dy), **kw), want)


@pytest.mark.parametrize("nterms", [1, 2, 3])
@pytest.mark.parametrize("with_dy", [False, True])
def test_chi2_matches_jax(rng, nterms, with_dy):
    """300 frequencies in chunks of 128; one curve and the batch."""
    t, Y, dy, _ = curves(rng)
    freqs = np.linspace(0.05, 2.0, 300)
    d = dy if with_dy else None
    kw = dict(nterms=nterms, normalization=NORMALIZATIONS[nterms],
              chunk=128)
    for y in (Y, Y[1]):
        want = jls.lombscargle_chi2(jnp.asarray(t), jnp.asarray(y),
                                    jnp.asarray(freqs),
                                    dy=None if d is None else jnp.asarray(d),
                                    **kw)
        got = tls.lombscargle_chi2(t_(t), t_(y), t_(freqs),
                                   dy=None if d is None else t_(d), **kw)
        assert_close(got, want)


@pytest.mark.parametrize("method", ["direct", "chi2"])
def test_direct_time_origin_invariance(method):
    """JD-scale host times are shifted in float64 before the float32
    phases (tests/test_ops_lombscargle.py's bar)."""
    rng = np.random.default_rng(0)
    t = np.arange(800) * 0.02
    y = t_((1 + 0.01 * np.sin(2 * np.pi * t / 2.5)
            + 0.001 * rng.standard_normal(800)).astype(np.float32))
    freqs = t_(np.linspace(0.1, 2.0, 200).astype(np.float32))
    fn = getattr(tls, f"lombscargle_{method}")
    np.testing.assert_allclose(np_(fn(t + 2457000.0, y, freqs)),
                               np_(fn(t, y, freqs)), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# against the numpy oracles
# ---------------------------------------------------------------------------
def oracle_data(rng, n=1500, baseline=27.0):
    t = np.sort(rng.uniform(0, baseline, n))
    y = 1.0 + 0.01 * np.sin(2 * np.pi * t / 2.5) + 0.002 * rng.normal(size=n)
    return t, y, np.full(n, 0.002)


@pytest.mark.parametrize("normalization", ["standard", "psd"])
@pytest.mark.parametrize("with_dy", [False, True])
def test_direct_matches_slow_oracle(rng, normalization, with_dy):
    t, y, dy = oracle_data(rng)
    freqs = np.linspace(0.02, 3.0, 400)
    d = dy if with_dy else None
    want = ls_slow(t, y, freqs, dy=d, normalization=normalization)
    got = tls.lombscargle_direct(t_(t), t_(y), t_(freqs),
                                 dy=None if d is None else t_(d),
                                 normalization=normalization)
    np.testing.assert_allclose(np_(got), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("normalization", ["standard", "psd"])
def test_fast_matches_fast_oracle(rng, normalization):
    t, y, dy = oracle_data(rng)
    f0, df, Nf = 0.05, 0.001, 2000
    want = ls_fast(t, y, f0, df, Nf, dy=dy, normalization=normalization)
    got = tls.lombscargle_fast(t, t_(y), f0, df, Nf, dy=t_(dy),
                               normalization=normalization)
    np.testing.assert_allclose(np_(got), want, rtol=1e-8,
                               atol=1e-10 * want.max())


def test_fast_approximates_direct(rng):
    t, y, _ = oracle_data(rng)
    f0, df, Nf = 0.05, 0.001, 2000
    exact = np_(tls.lombscargle_direct(t_(t), t_(y),
                                       t_(f0 + df * np.arange(Nf)),
                                       normalization="psd"))
    fast = np_(tls.lombscargle_fast(t, t_(y), f0, df, Nf,
                                    normalization="psd"))
    assert np.max(np.abs(fast - exact)) / exact.max() < 1e-4
    assert np.argmax(fast) == np.argmax(exact)


# ---------------------------------------------------------------------------
# bls_objective_single
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_dy", [False, True])
def test_bls_objective_single_matches_jax(rng, with_dy):
    """Jittered times (no sample on a box edge); the box placed at a
    transit time from a long way before the first sample."""
    n = 2000
    t = np.sort(rng.uniform(0, 27, n)) + 1325.0
    period, duration, tt = 2.37, 0.16, 1301.113
    ph = np.mod(t - tt + period / 2, period) - period / 2
    y = 1.0 + 1e-3 * rng.normal(size=n)
    y[np.abs(ph) < duration / 2] -= 3e-3
    dy = rng.uniform(5e-4, 2e-3, n) if with_dy else None
    want = jbls.bls_objective_single(
        jnp.asarray(t), jnp.asarray(y), None if dy is None
        else jnp.asarray(dy), period, duration, tt)
    got = tbls.bls_objective_single(t_(t), t_(y), None if dy is None
                                    else t_(dy), period, duration, tt)
    assert got.keys() == want.keys()
    assert np.array_equal(np_(got["in_transit"]), np_(want["in_transit"]))
    assert 0 < np_(got["in_transit"]).sum() < n
    for k in want:
        if k != "in_transit":
            assert_close(got[k], want[k], err_msg=k)
    assert abs(float(got["depth"]) - 3e-3) < 3e-4


# ---------------------------------------------------------------------------
# LightCurveStack.to_periodogram
# ---------------------------------------------------------------------------
def stack_arrays(rng, layout, B=8, n=600):
    """B curves with per-cadence dy and ~5% masked cadences (flux 0 there)
    on one grid, or on four grids offset as consecutive sectors (rows of
    a grid not adjacent, the first row's grid the third in sorted
    order)."""
    base = np.arange(n) * (2.0 / 60 / 24) * 4 + 0.0011
    grid = (np.zeros(B, int) if layout == "single"
            else np.array([2, 0, 3, 1, 2, 0, 3, 1])[:B])
    t = base[None, :] + 27.4 * grid[:, None] + 1500.0
    period = rng.uniform(0.5, 2.0, (B, 1))
    flux = (1.0 + 0.01 * np.sin(2 * np.pi * t / period)
            + 1e-3 * rng.normal(size=(B, n)))
    dy = 1e-3 * rng.uniform(0.7, 1.3, (B, n))
    mask = rng.random((B, n)) >= 0.05
    flux[~mask] = 0.0
    return t, flux, dy, mask


@pytest.mark.parametrize("normalization", ["standard", "psd"])
@pytest.mark.parametrize("layout", ["single", "mixed"])
def test_to_periodogram_matches_jax(rng, layout, normalization):
    arrays = stack_arrays(rng, layout)
    jstack = JStack(*(jnp.asarray(a) for a in arrays))
    tstack = TStack.from_numpy(*arrays, device="cpu", dtype=torch.float64)
    want_f, want_p = jstack.to_periodogram(normalization=normalization)
    got_f, got_p = tstack.to_periodogram(normalization=normalization)
    assert isinstance(got_f, np.ndarray) and got_f.dtype == np.float64
    assert np.array_equal(got_f, want_f)
    assert isinstance(got_p, torch.Tensor)
    assert got_p.device == tstack.device and got_p.dtype == torch.float64
    assert_rows(got_p, want_p)
    # a band and an oversampled grid
    kw = dict(minimum_frequency=0.2, maximum_frequency=3.0,
              oversample_factor=3, normalization=normalization)
    want_f, want_p = jstack.to_periodogram(**kw)
    got_f, got_p = tstack.to_periodogram(**kw)
    assert np.array_equal(got_f, want_f)
    assert_rows(got_p, want_p)


def test_to_periodogram_float32_stack_matches_float64(rng):
    """A float32 stack keeps its dtype; its peaks are those of float64 on
    the same float32-rounded inputs."""
    arrays = [a if a.dtype == bool else a.astype(np.float32)
              for a in stack_arrays(rng, "single")]
    f32 = TStack.from_numpy(*arrays, device="cpu", dtype=torch.float32)
    f64 = TStack.from_numpy(*arrays, device="cpu", dtype=torch.float64)
    freqs32, p32 = f32.to_periodogram()
    freqs64, p64 = f64.to_periodogram()
    assert p32.dtype == torch.float32
    assert np.array_equal(freqs32, freqs64)
    assert torch.equal(p32.argmax(1), p64.argmax(1))
    assert_rows(p32.double(), p64, rtol=1e-4)


# ---------------------------------------------------------------------------
# where host arrays go
# ---------------------------------------------------------------------------
ENTRY_CALLS = {
    "lombscargle_fast": lambda t, y, dev: tls.lombscargle_fast(
        t, y, F0, DF, NF, device=dev),
    "lombscargle_fastchi2": lambda t, y, dev: tls.lombscargle_fastchi2(
        t, y, F0, DF, NF, nterms=2, device=dev),
    "trig_sum": lambda t, y, dev: tls.trig_sum(t, y, DF, NF, f0=F0,
                                               device=dev)[0],
    "lombscargle_direct": lambda t, y, dev: tls.lombscargle_direct(
        t, y, F0 + DF * np.arange(64), device=dev),
    "lombscargle_chi2": lambda t, y, dev: tls.lombscargle_chi2(
        t, y, F0 + DF * np.arange(64), nterms=2, device=dev),
    "bls_objective_single": lambda t, y, dev: tbls.bls_objective_single(
        t, y, None, 2.5, 0.2, 1.0, device=dev)["depth"],
}


@pytest.mark.parametrize("name", sorted(ENTRY_CALLS))
def test_host_arrays_go_to_the_card_unless_cpu_is_asked(rng, monkeypatch,
                                                         name):
    """A numpy ``y`` goes to the card by default, so without CUDA the call
    raises; with ``device="cpu"`` it gives the bits of a CPU tensor ``y``,
    and a tensor ``y`` keeps its device."""
    call = ENTRY_CALLS[name]
    t, Y, _, _ = curves(rng, B=1)
    y = Y[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(t, y, None)
    got = call(t, y, "cpu")
    want = call(t, t_(y), None)
    assert got.device.type == "cpu" and want.device.type == "cpu"
    assert torch.equal(got, want)
