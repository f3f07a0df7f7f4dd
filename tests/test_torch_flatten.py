"""The detrend layer of lightkurve_tpu_torch against lightkurve_tpu.

The same numpy inputs, made from a seed, go through each ported function
and its JAX counterpart on the CPU in float64 (x64 on, as conftest sets
it): the masked reductions, sigma clipping, the segment-aware
Savitzky-Golay filter (also against ``scipy.signal.savgol_filter``), the
trend interpolation, ``flatten_batch`` on the cases of
``tests/test_detrend.py`` (also against the numpy oracle ``flatten_np``),
the stack methods, and flatten followed by the shared-grid sweep.  Bars:
masks equal, values within rtol 1e-10 of the JAX package and within the
rtol 1e-8 that ``tests/test_detrend.py`` holds against the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import savgol_filter
from torch.utils._python_dispatch import TorchDispatchMode

from lightkurve_tpu.batch import LightCurveStack as JStack
from lightkurve_tpu.ops import detrend as jdetrend
from lightkurve_tpu.ops import interp as jinterp
from lightkurve_tpu.ops import masked as jmasked
from lightkurve_tpu.ops import savgol as jsavgol
from lightkurve_tpu.ops import stats as jstats
from lightkurve_tpu.parallel.checkpoint import SweepRunner as JRunner
from lightkurve_tpu_torch.batch import LightCurveStack as TStack
from lightkurve_tpu_torch.ops import detrend, interp, masked, savgol, stats
from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner as TRunner
from oracles import flatten_np

RTOL = 1e-10
ORACLE_RTOL = 1e-8


def t_(a):
    return torch.from_numpy(np.asarray(a))


def assert_close(got, want, rtol=RTOL, atol=1e-13, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def masked_rows(rng, B=6, n=300):
    """Values with ~30% masked entries, a row with none valid and a row
    with one valid entry."""
    x = rng.normal(size=(B, n))
    mask = rng.random((B, n)) > 0.3
    mask[0] = False
    mask[1] = False
    mask[1, 17] = True
    return x, mask


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_masked_quantile_matches_jax(rng, q):
    x, mask = masked_rows(rng)
    want = jmasked.masked_quantile(jnp.asarray(x), jnp.asarray(mask), q)
    assert_close(masked.masked_quantile(t_(x), t_(mask), q), want)
    if q == 0.5:
        assert_close(masked.masked_median(t_(x), t_(mask)),
                     jmasked.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    # another axis, as the reference moves it last
    assert_close(masked.masked_quantile(t_(x.T), t_(mask.T), q, axis=0),
                 want)


def test_masked_moments_match_jax(rng):
    x, mask = masked_rows(rng)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    for name in ("masked_sum", "masked_mean", "masked_var", "masked_std"):
        assert_close(getattr(masked, name)(t_(x), t_(mask)),
                     getattr(jmasked, name)(jx, jm), err_msg=name)
    assert_close(masked.masked_var(t_(x), t_(mask), ddof=1),
                 jmasked.masked_var(jx, jm, ddof=1))
    xn = np.where(rng.random(x.shape) < 0.1, np.nan, x)
    got, ok = masked.nan_to_mask(t_(xn), t_(mask))
    want, jok = jmasked.nan_to_mask(jnp.asarray(xn), jm)
    assert_close(got, want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("n_groups", [4, 16, 24])
def test_masked_median_grouped_matches_jax(rng, n_groups):
    """Groups of one, two and many samples, empty groups (0.0), ties, an
    invalid mask, and more groups than flatten's 16."""
    B, n = 5, 257
    x = np.round(rng.normal(size=(B, n)), 1)          # ties
    gid = np.sort(rng.integers(0, n_groups, (B, n)), axis=1)
    gid[0] = np.minimum(gid[0], 1)                     # groups 2.. empty
    gid[1, :] = n_groups - 1
    gid[1, 5] = 0                                      # a group of one
    gid[1, 6:8] = 1                                    # a group of two
    valid = rng.random((B, n)) > 0.2
    for v in (None, valid):
        want = jmasked.masked_median_grouped(
            jnp.asarray(x), jnp.asarray(gid, jnp.int32), n_groups,
            valid=None if v is None else jnp.asarray(v))
        got = masked.masked_median_grouped(t_(x), t_(gid), n_groups,
                                           valid=None if v is None else t_(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for g in range(n_groups):
            member = (gid == g) & (True if v is None else v)
            ref = masked.masked_median(t_(x), t_(member))
            ref = torch.where(t_(member).any(-1), ref, 0.0)
            np.testing.assert_array_equal(got[:, g].numpy(), ref.numpy())


@pytest.mark.parametrize("cenfunc", ["median", "mean"])
def test_sigma_clip_mask_matches_jax(rng, cenfunc):
    x = rng.normal(size=(4, 500))
    x[:, ::37] += 8.0
    x[2, 3] = np.nan
    mask = rng.random(x.shape) > 0.05
    for kw in (dict(sigma=3.0), dict(sigma=5.0, sigma_lower=2.0,
                                    maxiters=2)):
        want = jstats.sigma_clip_mask(jnp.asarray(x), jnp.asarray(mask),
                                      cenfunc=cenfunc, **kw)
        got = stats.sigma_clip_mask(t_(x), t_(mask), cenfunc=cenfunc, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats.sigma_clip_mask(t_(x), sigma=3.0)[2, 3]


@pytest.mark.parametrize("window", [1, 13, 500, 900])
def test_running_mean_matches_jax(rng, window):
    x = rng.normal(size=(3, 500))
    got = stats.running_mean(t_(x), window)
    assert_close(got, jstats.running_mean(jnp.asarray(x), window))
    w = min(window, 500)
    assert_close(got[0, 0], x[0, :w].mean(), rtol=1e-12)


@pytest.mark.parametrize("w, p", [(11, 2), (31, 3), (101, 2)])
def test_savgol_matches_scipy_interp_mode(rng, w, p):
    """Whole rows, no segments: scipy's savgol_filter, mode='interp'."""
    y = np.cumsum(rng.normal(size=(3, 400)), axis=1) + 100
    H = savgol.savgol_design_matrix(w, p)
    np.testing.assert_array_equal(H, jsavgol.savgol_design_matrix(w, p))
    got = savgol.savgol_filter_interp(t_(y), H)
    for i in range(3):
        assert_close(got[i], savgol_filter(y[i], w, p), rtol=ORACLE_RTOL,
                     atol=1e-8)


def segments(n, cuts):
    """Per-sample [lo, hi) of the segments that start at ``cuts``."""
    edges = np.concatenate([[0], cuts, [n]])
    seg = np.searchsorted(edges, np.arange(n), side="right") - 1
    return edges[seg], edges[seg + 1]


@pytest.mark.parametrize("w", [31, 101])
def test_savgol_segments_and_nans_match_jax(rng, w):
    """Rows of several segments, some shorter than the window, NaNs inside
    long segments and padding past the last: every sample of a segment at
    least ``w`` long equals the JAX package's (the others are the callers'
    to overwrite)."""
    B, n = 4, 1200
    x = 1.0 + 0.01 * np.cumsum(rng.normal(size=(B, n)), axis=1)
    los, his = [], []
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(20, n - 20), 3 + b,
                                  replace=False))
        lo, hi = segments(n, cuts)
        pad = n - 60 * b                       # padding: isolated samples
        lo = np.where(np.arange(n) < pad, lo, np.arange(n))
        hi = np.where(np.arange(n) < pad, np.minimum(hi, pad), pad)
        los.append(lo)
        his.append(hi)
    lo, hi = np.array(los), np.array(his)
    x[rng.random(x.shape) < 0.01] = np.nan
    H = savgol.savgol_design_matrix(w, 2)
    want = np.asarray(jsavgol.savgol_filter_interp(
        jnp.asarray(x), jnp.asarray(H), jnp.asarray(lo, jnp.int32),
        jnp.asarray(hi, jnp.int32)))
    got = savgol.savgol_filter_interp(t_(x), H, t_(lo), t_(hi)).numpy()
    ok = (hi - lo) >= w
    assert ok.sum() > B * n // 2
    assert_close(got[ok], want[ok])


def test_savgol_holds_no_window_per_sample(rng):
    """No tensor of the filter holds a window per sample: every op's output
    stays within a few (B, n) rows, where the reference's intermediate is
    (B, w, n)."""
    B, n, w = 4, 2048, 101
    x = t_(rng.normal(size=(B, n)))
    lo, hi = (t_(a) for a in segments(n, [700, 1500]))
    sizes = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    sizes.append(o.numel())
            return out

    with Record():
        savgol.savgol_filter_interp(x, savgol.savgol_design_matrix(w, 2),
                                    lo, hi)
    assert max(sizes) <= 4 * B * n < B * w * n


def test_interp_linear_fill_matches_jax(rng):
    """Interior points, head and tail extrapolation, a row with one kept
    sample, a row with two, one with none and one with all."""
    B, n = 6, 200
    x = np.cumsum(rng.uniform(0.01, 0.03, (B, n)), axis=1)
    f = rng.normal(size=(B, n))
    kept = rng.random((B, n)) > 0.6
    kept[0, :10] = kept[0, -10:] = False
    kept[1] = False
    kept[1, 77] = True
    kept[2] = False
    kept[2, [40, 41]] = True
    kept[3] = False
    kept[4] = True
    f = np.where(kept, f, np.nan)
    want = np.asarray(jinterp.interp_linear_fill(
        jnp.asarray(x), jnp.asarray(kept), jnp.asarray(f)))
    got = interp.interp_linear_fill(t_(x), t_(kept), t_(f)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert_close(got[fin], want[fin])
    assert np.all(got[1] == f[1, 77]) and np.all(np.isnan(got[3]))


def initial_mask(f, sigma=3.0):
    """The reference's mask before its flatten loop (as test_detrend.py)."""
    extra = np.isfinite(f)
    extra &= np.nan_to_num(np.abs(f - np.nanmedian(f))) <= (
        np.nanstd(f) * sigma)
    return extra


def flatten_case(rng, case, B=4):
    """Rows of one case of tests/test_detrend.py, each from its own draw:
    (t, f, valid, break_tolerance, the oracle's break_tolerance, n_pad)."""
    rows = []
    for _ in range(B):
        if case == "simple":
            n = 500
            t = np.arange(n) * 0.02
            f = (1.0 + 0.05 * np.sin(2 * np.pi * t / 4.0)
                 + 0.005 * rng.normal(size=n))
        elif case == "gaps":
            n = 600
            t = np.arange(n) * 0.02
            t[n // 3:] += 2.0
            t[2 * n // 3:] += 3.0
            f = (1.0 + 0.03 * np.sin(2 * np.pi * t / 3.0)
                 + 0.004 * rng.normal(size=n))
        elif case == "outliers_nans":
            n = 400
            t = np.arange(n) * 0.02
            f = (1.0 + 0.02 * np.sin(2 * np.pi * t / 2.0)
                 + 0.003 * rng.normal(size=n))
            f[50] = 3.0
            f[100] = np.nan
            f[200] += 0.05
        elif case in ("short_segment", "no_break_tolerance"):
            n = 200 if case == "short_segment" else 300
            t = np.arange(n) * 0.02
            if case == "short_segment":
                t[190:] += 5.0
            else:
                t[150:] += 4.0
            f = 1.0 + 0.02 * np.sin(t) + 0.01 * rng.normal(size=n)
        elif case == "many_segments":
            # 24 segments, some shorter than the window: ids past 15
            # share one median, as lightkurve_tpu's do
            n = 1200
            t = np.arange(n) * 0.02
            for cut in np.sort(rng.choice(np.arange(10, n - 5), 23,
                                          replace=False)):
                t[cut:] += 1.0
            f = (1.0 + 0.02 * np.sin(2 * np.pi * t / 5.0)
                 + 0.003 * rng.normal(size=n))
        rows.append((t, f))
    bt = np.nan if case == "no_break_tolerance" else 5.0
    t = np.array([r[0] for r in rows])
    f = np.array([r[1] for r in rows])
    valid = np.array([initial_mask(r) for r in f])
    return t, f, valid, bt


def both_flattens(t, f, valid, bt, w=31, niters=3, sigma=3.0):
    H = savgol.savgol_design_matrix(w, 2)
    jt, jv = jdetrend.flatten_batch(
        jnp.asarray(t), jnp.asarray(np.nan_to_num(f)), jnp.asarray(valid),
        jnp.asarray(H), jnp.asarray(bt), jnp.asarray(sigma), niters=niters)
    tt, tv = detrend.flatten_batch(t_(t), t_(np.nan_to_num(f)), t_(valid),
                                   H, bt, sigma, niters=niters)
    return (np.asarray(jt), np.asarray(jv)), (tt.numpy(), tv.numpy())


@pytest.mark.parametrize("case", ["simple", "gaps", "outliers_nans",
                                  "short_segment", "no_break_tolerance",
                                  "many_segments"])
def test_flatten_batch_matches_jax_and_oracle(rng, case):
    t, f, valid, bt = flatten_case(rng, case)
    (jt, jv), (tt, tv) = both_flattens(t, f, valid, bt)
    np.testing.assert_array_equal(tv, jv)
    assert_close(tt, jt)
    for i in range(len(t)):
        want_trend, want_mask = flatten_np(
            t[i], f[i], window_length=31, polyorder=2,
            break_tolerance=None if np.isnan(bt) else bt, niters=3, sigma=3)
        if case == "many_segments":
            # upstream takes each segment's median on its own; segments
            # past the 16th share one here (ROADMAP, queue C)
            continue
        np.testing.assert_array_equal(tv[i], want_mask)
        assert_close(tt[i], want_trend, rtol=ORACLE_RTOL, atol=1e-10)


def test_flatten_many_segments_share_the_last_median(rng):
    """Every segment id past max_segments - 1 shares one median in the
    short-segment fallback, as lightkurve_tpu clips it: 20 short segments
    of 12 samples each, a window of 31, so every sample takes a median."""
    n = 240
    t = np.arange(n) * 0.02 + np.repeat(np.arange(20), 12) * 1.0
    f = 1.0 + np.repeat(np.arange(20), 12) * 0.01
    valid = np.ones(n, bool)
    H = savgol.savgol_design_matrix(31, 2)
    trend, _ = detrend.flatten(t_(t), t_(f), t_(valid), H, 5.0, 3.0)
    jtrend, _ = jdetrend.flatten(jnp.asarray(t), jnp.asarray(f),
                                 jnp.asarray(valid), jnp.asarray(H),
                                 jnp.asarray(5.0), jnp.asarray(3.0))
    assert_close(trend, np.asarray(jtrend))
    assert_close(trend[:15 * 12], f[:15 * 12])
    assert_close(trend[15 * 12:], np.full(5 * 12, np.median(f[15 * 12:])))


def test_flatten_padding_does_not_change_the_trend(rng):
    """Padded (valid=False) tails with finite, increasing times leave the
    rows' trends as they were (as test_detrend.py)."""
    t, f, valid, bt = flatten_case(rng, "simple")
    pad = 50
    tp = np.concatenate([t, t[:, -1:] + 0.02 * (1 + np.arange(pad))], 1)
    fp = np.concatenate([f, np.full((len(t), pad), 99.0)], 1)
    vp = np.concatenate([valid, np.zeros((len(t), pad), bool)], 1)
    H = savgol.savgol_design_matrix(31, 2)
    ref, _ = detrend.flatten_batch(t_(t), t_(f), t_(valid), H, bt, 3.0)
    got, vout = detrend.flatten_batch(t_(tp), t_(fp), t_(vp), H, bt, 3.0)
    assert_close(got[:, :-pad], ref.numpy(), rtol=1e-8)
    assert not vout[:, -pad:].any()
    (jt, jv), (tt, tv) = both_flattens(tp, fp, vp, bt)
    np.testing.assert_array_equal(tv, jv)
    assert_close(tt, jt)


def stack_arrays(rng, B=8, n=1024):
    """A padded stack: a sinusoidal trend with a drift per curve, one
    transit each, per-cadence flux_err, ~3% masked cadences, a gap, and a
    padded tail on half the rows."""
    t = np.tile(np.arange(n) * 0.02 + 0.0011, (B, 1))
    t[:, n // 2:] += 1.5                                 # a gap
    trend = (1.0 + rng.uniform(0.005, 0.01, (B, 1)) * np.sin(
        2 * np.pi * t / rng.uniform(2.0, 10.0, (B, 1)))
        + 1e-3 * (t - t[:, :1]) / 20.0)
    fe = 2e-4 * rng.uniform(0.7, 1.3, (B, n))
    flux = trend * (1.0 + fe * rng.standard_normal((B, n)))
    p_inj = rng.uniform(1.8, 3.2, B)
    for i in range(B):
        ph = np.mod(t[i] - 0.4 + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.06] *= 1.0 - 6e-3
    flux[:, ::97] += 3e-3                                # outliers
    mask = rng.random((B, n)) >= 0.03
    mask[::2, n - 100:] = False                          # padding
    flux[~mask] = 0.0
    return (t, flux, fe, mask), p_inj


def both_stacks(arrays):
    j = JStack(*(jnp.asarray(a) for a in arrays))
    t = TStack.from_numpy(*arrays, dtype=torch.float64, device="cpu")
    return j, t


def assert_stacks_close(js, ts, rtol=RTOL):
    for f in ("time", "flux", "flux_err"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a))
        fin = np.isfinite(a)
        assert_close(b[fin], a[fin], rtol=rtol, err_msg=f)
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))


@pytest.mark.parametrize("kw", [dict(), dict(window_length=31),
                                dict(window_length=101, polyorder=5,
                                     break_tolerance=None, niters=2,
                                     sigma=4)])
def test_stack_flatten_matches_jax(rng, kw):
    js, ts = both_stacks(stack_arrays(rng)[0])
    jflat, jtrend = js.flatten(return_trend=True, **kw)
    tflat, ttrend = ts.flatten(return_trend=True, **kw)
    assert_stacks_close(jflat, tflat)
    assert_stacks_close(jtrend, ttrend)
    assert_stacks_close(js.flatten(**kw), tflat)


def test_stack_flatten_polyorder_past_the_window(rng):
    """polyorder >= window_length fits degree window_length - 1, as the
    reference builds H."""
    js, ts = both_stacks(stack_arrays(rng, B=3, n=300)[0])
    assert_stacks_close(js.flatten(window_length=5, polyorder=9),
                        ts.flatten(window_length=5, polyorder=9))


@pytest.mark.parametrize("kw", [dict(), dict(sigma=3.0, maxiters=2),
                                dict(sigma=2.5, cenfunc="mean")])
def test_remove_outliers_matches_jax(rng, kw):
    js, ts = both_stacks(stack_arrays(rng)[0])
    np.testing.assert_array_equal(ts.remove_outliers(**kw).mask.numpy(),
                                  np.asarray(js.remove_outliers(**kw).mask))


@pytest.mark.parametrize("kw", [dict(), dict(transit_duration=7,
                                             savgol_window=31, sigma=4.0)])
def test_estimate_cdpp_batch_matches_jax(rng, kw):
    js, ts = both_stacks(stack_arrays(rng)[0])
    got = ts.estimate_cdpp_batch(**kw)
    assert isinstance(got, np.ndarray) and got.shape == (len(ts),)
    assert_close(got, js.estimate_cdpp_batch(**kw))
    assert np.all(np.isfinite(got)) and np.all(got > 0)


def test_flatten_then_shared_sweep_matches_jax(tmp_path, rng):
    """The slice as a whole: flatten, then SweepRunner(method="shared")
    over the flattened stack (per-cadence weights after the division by
    the trend), in both packages: the same winners, and each injected
    period recovered."""
    arrays, p_inj = stack_arrays(rng, B=6, n=700)
    js, ts = both_stacks(arrays)
    jflat, tflat = js.flatten(window_length=101), ts.flatten(
        window_length=101)
    periods, durations = np.linspace(1.5, 3.5, 48), np.array([0.1, 0.2])
    kw = dict(chunk_periods=16, method="shared")
    ja = JRunner(jflat, periods, durations, str(tmp_path / "j.npz"),
                 **kw).run()
    tb = TRunner(tflat, periods, durations, str(tmp_path / "t.npz"),
                 **kw).run()
    for f in ("period", "duration", "transit_time"):
        np.testing.assert_array_equal(tb[f], ja[f], err_msg=f)
    for f in ("power", "depth", "depth_snr", "log_likelihood"):
        assert_close(tb[f], ja[f], rtol=1e-9, atol=1e-12, err_msg=f)
    assert np.all(np.abs(tb["period"] - p_inj) / p_inj < 0.02)
