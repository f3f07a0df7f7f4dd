"""lightkurve_tpu_torch.ops.interp and ops.acf against lightkurve_tpu's on
the same numpy inputs on the CPU (the reference with x64 on, the port in
float64).

Bars: rtol 1e-12 for the linear interpolations (padded ``n_valid``, ranks
given), the PCHIP slopes and values (scipy's edge rule, the two-point
case, ``extrapolate=False`` giving NaN, a (k, n) set of vectors on one
grid, a batch of rows vmapped in the reference) and the windowed
autocorrelation (windows clipped at both ends; relative to each window's
lag-0 value); the PCHIP values also against scipy's PchipInterpolator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import PchipInterpolator

from lightkurve_tpu.ops import acf as jacf
from lightkurve_tpu.ops import interp as jint
from lightkurve_tpu_torch.ops import acf as tacf
from lightkurve_tpu_torch.ops import interp as tint

jax.config.update("jax_enable_x64", True)

RTOL = 1e-12


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, equal_nan=True)


def grid(rng, n, lo=1500.0, span=27.0):
    return np.sort(lo + span * rng.random(n))


@pytest.mark.parametrize("n_valid", [None, 2, 7, 12])
def test_interp_linear_extrap_matches_jax(n_valid):
    rng = np.random.default_rng(1)
    xp = grid(rng, 12)
    fp = rng.standard_normal(12)
    x = np.concatenate([[1490.0, xp[0]], grid(rng, 40, 1498.0, 31.0),
                        [xp[-1], 1540.0]])
    want = jint.interp_linear_extrap(jnp.asarray(x), jnp.asarray(xp),
                                     jnp.asarray(fp), n_valid)
    got = tint.interp_linear_extrap(t(x), t(xp), t(fp), n_valid)
    close(got, want)


def test_interp_linear_extrap_batched_rows_match_vmapped_jax():
    rng = np.random.default_rng(2)
    xp = np.stack([grid(rng, 10) for _ in range(3)])
    fp = rng.standard_normal((3, 10))
    x = np.stack([grid(rng, 25, 1495.0, 35.0) for _ in range(3)])
    nv = np.array([10, 4, 2])
    want = jax.vmap(jint.interp_linear_extrap)(
        jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(nv))
    got = tint.interp_linear_extrap(t(x), t(xp), t(fp), t(nv))
    close(got, want)


def test_interp_linear_ranked_matches_jax():
    rng = np.random.default_rng(3)
    x = grid(rng, 60)
    kept = rng.random(60) < 0.4
    xp = np.where(kept, x, 0.0)[np.argsort(~kept, kind="stable")]
    fp = rng.standard_normal(60)
    ranks = np.cumsum(kept) - kept
    nv = int(kept.sum())
    want = jint.interp_linear_ranked(jnp.asarray(x), jnp.asarray(xp),
                                     jnp.asarray(fp), jnp.asarray(ranks), nv)
    got = tint.interp_linear_ranked(t(x), t(xp), t(fp), t(ranks), nv)
    close(got, want)


def pchip_cases():
    rng = np.random.default_rng(4)
    x = grid(rng, 30)
    y = rng.standard_normal(30)
    y[10:14] = y[9]                           # a flat run: zero slopes
    y[20:23] = np.linspace(0, 5, 3)           # a steep monotone stretch
    return {"random": (x, y), "two_points": (x[:2], y[:2]),
            "three_points": (x[:3], np.array([0.0, 1.0, -3.0])),
            "monotone": (x, np.cumsum(rng.random(30)))}


@pytest.mark.parametrize("case", sorted(pchip_cases()))
@pytest.mark.parametrize("extrapolate", [True, False])
def test_pchip_matches_jax_and_scipy(case, extrapolate):
    x, y = pchip_cases()[case]
    rng = np.random.default_rng(5)
    xq = np.concatenate([[x[0] - 0.7, x[0]], np.sort(
        x[0] + (x[-1] - x[0]) * rng.random(50)), [x[-1], x[-1] + 0.4]])
    close(tint.pchip_slopes(t(x), t(y)),
          jint.pchip_slopes(jnp.asarray(x), jnp.asarray(y)))
    want = jint.pchip_interpolate(jnp.asarray(xq), jnp.asarray(x),
                                  jnp.asarray(y), extrapolate=extrapolate)
    got = tint.pchip_interpolate(t(xq), t(x), t(y), extrapolate=extrapolate)
    close(got, want)
    ref = PchipInterpolator(x, y, extrapolate=extrapolate)(xq)
    close(got, ref, rtol=1e-9, atol=1e-12)
    if not extrapolate:
        assert np.isnan(got.numpy()[[0, -1]]).all()
        assert np.isfinite(got.numpy()[1:-1]).all()


def test_pchip_vectors_on_one_grid_and_batched_rows():
    """(k, n) vectors on one (n,) grid in one call equal the reference's
    call per vector; (b, n) grids with their own rows equal the vmapped
    reference."""
    rng = np.random.default_rng(6)
    x = grid(rng, 40)
    ys = rng.standard_normal((5, 40))
    xq = np.sort(x[0] - 1 + (x[-1] - x[0] + 2) * rng.random(70))
    got = tint.pchip_interpolate(t(xq), t(x), t(ys))
    assert got.shape == (5, 70)
    for k in range(5):
        close(got[k], jint.pchip_interpolate(jnp.asarray(xq),
                                             jnp.asarray(x),
                                             jnp.asarray(ys[k])))
    xs = np.stack([grid(rng, 40) for _ in range(3)])
    xqs = np.stack([np.sort(r[0] + (r[-1] - r[0]) * rng.random(20))
                    for r in xs])
    want = jax.vmap(jint.pchip_interpolate)(jnp.asarray(xqs),
                                            jnp.asarray(xs),
                                            jnp.asarray(ys[:3]))
    close(tint.pchip_interpolate(t(xqs), t(xs), t(ys[:3])), want)


def test_pchip_at_its_nodes_returns_them():
    rng = np.random.default_rng(7)
    x = grid(rng, 25)
    y = rng.standard_normal((3, 25))
    np.testing.assert_array_equal(
        tint.pchip_interpolate(t(x), t(x), t(y)).numpy(), y)


@pytest.mark.parametrize("window", [16, 37])
def test_autocorrelate_windows_matches_jax(window):
    """Windows inside the spectrum and clipped at both ends (Python
    slicing's rule): equal lengths, ACFs within 1e-12 of each window's
    lag-0 value."""
    rng = np.random.default_rng(8)
    power = 1.0 + rng.exponential(size=300)
    starts = np.array([-window - 3, -window // 2, -1, 0, 5, 120,
                       300 - window, 300 - window // 2, 299, 305])
    wa, wn = jacf.autocorrelate_windows(jnp.asarray(power),
                                        jnp.asarray(starts), window)
    ga, gn = tacf.acf2d(t(power), t(starts), window)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    wa = np.asarray(wa)
    scale = np.maximum(np.abs(wa[:, :1]), 1e-300)
    close(ga.numpy() / scale, wa / scale, rtol=0, atol=RTOL)
    # against np.correlate on the clipped, zero-mean slices
    for row, s in enumerate(starts):
        seg = power[max(s, 0):max(s + window, 0)]
        if len(seg):
            seg = seg - seg.mean()
            full = np.correlate(seg, seg, "full")[len(seg) - 1:]
            close(ga[row, :len(seg)].numpy(), full, rtol=0,
                  atol=1e-12 * max(abs(full[0]), 1e-300))
