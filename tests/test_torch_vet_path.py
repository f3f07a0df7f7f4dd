"""The public single-curve path against the benchmark's plain reference.

``LightCurve.flatten`` and ``LightCurveStack.flatten`` at their defaults,
and ``to_periodogram("bls")`` after the flatten, in the float32
configuration on the CPU, held against ``perfbench/reference.py`` (lightkurve's
flatten in numpy, the binned likelihood BLS, both in float64) on seeded
curves at a small size, to the limits of the benchmark's ``tess_sector.vet``
cell:

- a Kepler-like curve of 46 segments, most shorter than the window, so
  that each takes its own median, and a stack of 8 such curves;
- a TESS curve at BTJD 1325 with float64 times and 4-cadence masked runs:
  lightkurve splits such a run only where float64 rounding puts its
  5-cadence step above 5 median steps; a time rounded to float32 is
  1.2e-4 d coarse there and splits every one;
- the winner of ``to_periodogram("bls")`` on that curve, whose transits
  sit at the runs.

In float64 both methods give, on curves of 16 segments or fewer, what the
flatten op gives with its 16 tracked medians (``max_segments=16``, the
JAX package's semantics) to 1e-12.
"""
import json
import os

import numpy as np
import pytest
import torch

from lightkurve_tpu_torch import LightCurve, config
from lightkurve_tpu_torch.batch import LightCurveStack
from lightkurve_tpu_torch.ops import detrend
from lightkurve_tpu_torch.ops.savgol import savgol_design_matrix
from lightkurve_tpu_torch.time import Time
from perfbench import check as chk
from perfbench import data
from perfbench import reference as ref
from perfbench.harness import ROOT

FL = dict(window_length=101, polyorder=2, break_tolerance=5, niters=3,
          sigma=3)
DURATIONS = [0.05, 0.1, 0.15, 0.2, 0.25, 0.33]
TESS_CADENCE = 2.0 / 1440


def limits():
    path = os.path.join(ROOT, "perfbench", "workloads", "tess_sector.vet.json")
    with open(path) as f:
        return json.load(f)["limits"]


@pytest.fixture(autouse=True)
def port_float32_on_cpu(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", torch.float32)


def kepler_like(rng, segments=46):
    """Float64 times of ``segments`` segments of 30-200 half-hour cadences
    from BKJD 131.5, 0.5-2 d apart; a rotating star's flux (0.1%) with
    noise, 2% of the cadences NaN; flux_err."""
    cad = 0.0204
    t, start = [], 131.5
    for n in rng.integers(30, 200, segments):
        t.append(start + cad * np.arange(n))
        start = t[-1][-1] + rng.uniform(0.5, 2.0)
    t = np.concatenate(t)
    err = 1e-4 * rng.uniform(0.7, 1.3, t.size)
    flux = (1.0 + 1e-3 * np.sin(2 * np.pi * t / rng.uniform(4, 10))
            + err * rng.standard_normal(t.size))
    flux[rng.random(t.size) < 0.02] = np.nan
    return t, flux, err


def tess_with_runs(rng, segments=6, length=500):
    """Float64 BTJD times of ``segments`` segments of 2-min cadences from
    1325.2931, 0.5 d apart; in each, 40 to 60 cadences from its start, a
    run of 4 masked (NaN) cadences that lightkurve does not split (its
    5-cadence step at most 5 median steps in float64); a rotating star
    with a 3e-3-deep 0.05-d transit 15 cadences into every segment, which
    a split at the run would leave in a segment shorter than the
    window."""
    seg = 1325.2931 + TESS_CADENCE * np.arange(length)
    step = length * TESS_CADENCE + 0.5
    t = np.concatenate([seg + i * step for i in range(segments)])
    err = 2e-4 * rng.uniform(0.7, 1.3, t.size)
    flux = (1.0 + 0.005 * np.sin(2 * np.pi * t / 4.7)
            + err * rng.standard_normal(t.size))
    ph = np.mod(t - t[15] + step / 2, step) - step / 2
    flux[np.abs(ph) < 0.025] -= 3e-3
    med = np.median(np.diff(t))
    for lo in range(0, t.size, length):
        j = next(j for j in range(lo + 40, lo + 60)
                 if t[j + 5] - t[j] <= 5 * med)
        flux[j + 1:j + 5] = np.nan
    return t, flux, err


def reference_flat(t, flux, err):
    valid = np.isfinite(flux)
    return chk.reference_flatten(t, flux, valid, err, FL)


def test_a_curve_of_46_segments_takes_each_segment_median(rng):
    t, flux, err = kepler_like(rng)
    lc = LightCurve(time=Time(t, format="bkjd"), flux=flux, flux_err=err)
    got = lc.flatten(window_length=FL["window_length"]).flux.value
    want, _ = reference_flat(t, flux, err)
    e = chk.flat_errors([got], [want], [np.isfinite(flux)])
    assert chk.curve_p99(e) <= limits()["flat_err_curve_p99"]


def test_a_stack_of_46_segment_curves(rng):
    """8 curves on one float32 time grid of 46 segments, the stack's
    dtype; the reference flattens the same float32 times."""
    t, _, _ = kepler_like(rng)
    t32 = t.astype(np.float32)
    B, n = 8, t.size
    err = 1e-4 * rng.uniform(0.7, 1.3, (B, n))
    flux = (1.0 + 1e-3 * np.sin(2 * np.pi * t32[None] / rng.uniform(
        4, 10, (B, 1))) + err * rng.standard_normal((B, n)))
    mask = rng.random((B, n)) >= 0.02
    stack = LightCurveStack.from_numpy(np.broadcast_to(t32, (B, n)),
                                       np.where(mask, flux, 0.0), err, mask,
                                       device="cpu")
    got = stack.flatten(window_length=FL["window_length"]).flux.numpy()
    want = [chk.reference_flatten(t32, flux[i], mask[i], err[i], FL)[0]
            for i in range(B)]
    e = chk.flat_errors(got, want, mask)
    assert chk.curve_p99(e) <= limits()["flat_err_curve_p99"]


def test_btjd_times_keep_lightkurve_gaps(rng):
    t, flux, err = tess_with_runs(rng)
    lc = LightCurve(time=Time(t, format="btjd"), flux=flux, flux_err=err)
    got = lc.flatten(window_length=FL["window_length"]).flux.value
    want, _ = reference_flat(t, flux, err)
    e = chk.flat_errors([got], [want], [np.isfinite(flux)])
    assert chk.curve_p99(e) <= limits()["flat_err_curve_p99"]


def test_the_bls_winner_after_the_flatten(rng):
    """Periods from 1 d: below it 0.33-d boxes that fill a period win on
    any flattened curve."""
    t, flux, err = tess_with_runs(rng)
    lc = LightCurve(time=Time(t, format="btjd"), flux=flux, flux_err=err)
    pg = lc.flatten(window_length=FL["window_length"]).to_periodogram(
        method="bls", minimum_period=1.0)
    valid = np.isfinite(flux)
    rflat, rerr = reference_flat(t, flux, err)
    tv = t[valid]
    baseline = tv.max() - tv.min()
    df = 10 * min(DURATIONS) / baseline ** 2
    f_max, f_min = 1.0, 3.0 / baseline
    periods = 1.0 / (f_max - df * np.arange(1 + round((f_max - f_min) / df)))
    geom = ref.Geometry.of(periods, DURATIONS, 10)
    np.testing.assert_allclose(1.0 / pg.frequency.value, periods, rtol=1e-14)
    ts = torch.as_tensor(tv - tv.min())
    y = torch.as_tensor(rflat[valid][None])
    dy = torch.as_tensor(rerr[valid][None])
    ok = torch.ones_like(y, dtype=torch.bool)
    best = ref.bls_grid(ts, y, dy, ok, geom)["power"].max(1).values.numpy()
    i = int(np.nanargmax(pg.power.value))
    win = dict(period=[periods[i]],
               duration=[geom.durations[np.argmin(np.abs(
                   geom.durations - pg.duration[i].value))]],
               transit_time=[pg.transit_time[i].value],
               power=[pg.power[i].value], depth=[pg.depth[i].value])
    gap, err_ = chk.judge_winners(win, best, ts, y, dy, ok, geom,
                                  float(tv.min()), grid_dtype=np.float64)
    lim = limits()
    assert gap <= lim["winner_gap"] and err_ <= lim["winner_err"]


def few_segments(rng, B=3, segments=12):
    """Float64 rows of ``segments`` segments, some shorter than the
    window, 5% masked."""
    n = 60 * segments
    t = np.arange(n) * 0.02 + np.repeat(np.arange(segments), 60) * 1.0
    t = np.broadcast_to(t, (B, n)).copy()
    flux = (1.0 + 0.02 * np.sin(2 * np.pi * t / 3.0)
            + 1e-3 * rng.standard_normal((B, n)))
    mask = rng.random((B, n)) >= 0.05
    return t, flux, mask


def test_float64_results_equal_the_16_segment_op(rng, monkeypatch):
    """On 12 segments, both public methods give what ``flatten_batch``
    gives with 16 tracked medians, in float64, to 1e-12."""
    monkeypatch.setattr(config, "default_dtype", torch.float64)
    t, flux, mask = few_segments(rng)
    H = savgol_design_matrix(FL["window_length"], 2)
    tt, ft, mt = (torch.as_tensor(a) for a in (t, flux, mask))
    want, _ = detrend.flatten_batch(tt, ft, mt, H, 5.0, 3.0,
                                    max_segments=16)
    stack = LightCurveStack.from_numpy(t, np.where(mask, flux, 0.0),
                                       np.full_like(flux, 1e-3), mask,
                                       device="cpu")
    _, trend = stack.flatten(window_length=FL["window_length"],
                             return_trend=True)
    np.testing.assert_allclose(trend.flux.numpy(), want.numpy(), rtol=1e-12,
                               atol=0)
    # the curve's own call: NaN where masked, and its global pre-mask
    f = np.where(mask[0], flux[0], np.nan)
    keep = np.isfinite(f)
    keep[keep] = np.abs(f[keep] - np.median(f[keep])) <= 3 * np.std(f[keep])
    want, _ = detrend.flatten_batch(tt[:1], torch.as_tensor(f[None]),
                                    torch.as_tensor(keep[None]), H, 5.0, 3.0,
                                    max_segments=16)
    lc = LightCurve(time=Time(t[0], format="btjd"), flux=f,
                    flux_err=np.full_like(f, 1e-3))
    _, lc_trend = lc.flatten(window_length=FL["window_length"],
                             return_trend=True)
    np.testing.assert_allclose(lc_trend.flux.value, want[0].numpy(),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("curve", ["kepler_like", "tess_with_runs"])
def test_the_flatten_with_no_host_read_gives_the_same_trend(rng, curve):
    """``flatten_batch(static=True)``, the flatten a CUDA graph captures,
    against the flatten that reads the end windows' positions on the host,
    both with every segment's median in float64: the same trend to 1e-12
    (the end windows' products differ only in the matrix product's
    shape)."""
    t, flux, _ = globals()[curve](rng)
    keep = np.isfinite(flux)
    H = savgol_design_matrix(FL["window_length"], 2)
    args = [torch.as_tensor(a[None]) for a in (t, np.nan_to_num(flux), keep)]
    want, want_valid = detrend.flatten_batch(*args, H, 5.0, 3.0,
                                             max_segments=None)
    got, got_valid = detrend.flatten_batch(*args, H, 5.0, 3.0,
                                           max_segments=None, static=True)
    assert torch.equal(got_valid, want_valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=0)


def test_the_flatten_graph_on_the_card(monkeypatch):
    """On a CUDA device ``LightCurve.flatten`` replays one captured graph
    per length and settings: each curve gets the trend that the uncaptured
    flatten gives it on the card, in float32 with float64 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    from lightkurve_tpu_torch import lightcurve
    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(lightcurve, "_FLATTEN_GRAPHS", {})
    H = torch.as_tensor(savgol_design_matrix(FL["window_length"], 2),
                        device="cuda").to(torch.float32)
    t, _, _ = tess_with_runs(np.random.default_rng(7))
    for i in range(3):
        _, flux, err = tess_with_runs(np.random.default_rng(i))
        lc = LightCurve(time=Time(t, format="btjd"), flux=flux, flux_err=err)
        _, trend = lc.flatten(window_length=FL["window_length"],
                              return_trend=True)
        keep = np.isfinite(flux)
        keep[keep] = np.abs(flux[keep] - np.median(flux[keep])) <= \
            3 * np.std(flux[keep])
        want, _ = detrend.flatten(
            torch.as_tensor(t, device="cuda"),
            torch.as_tensor(np.nan_to_num(flux), device="cuda",
                            dtype=torch.float32),
            torch.as_tensor(keep, device="cuda"), H, 5.0, 3.0,
            max_segments=None)
        np.testing.assert_allclose(trend.flux.value, want.cpu().numpy(),
                                   rtol=2e-6, atol=0)
    graphs = list(lightcurve._FLATTEN_GRAPHS.values())
    assert len(graphs) == 1 and graphs[0].graph is not None
