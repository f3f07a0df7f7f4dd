"""The frozen reference, generators and grids against independent forms."""
import json
import os

import numpy as np
import pytest
import torch
from scipy.interpolate import interp1d
from scipy.signal import savgol_filter

from perfbench import data
from perfbench import reference as ref
from perfbench.harness import ROOT


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name)) as f:
        return json.load(f)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    r = ref.tf32_round(x)
    assert np.all(np.abs(r - x) <= np.abs(x) * 2.0 ** -11)
    assert np.array_equal(ref.tf32_round(r), r)
    bits = r.view(np.int32) & 0x1FFF
    assert not bits.any()
    t = ref.tf32_round(torch.as_tensor(x))
    assert np.array_equal(t.numpy(), r)


@pytest.mark.parametrize("window,polyorder", [(11, 2), (101, 2), (31, 3)])
def test_savgol_matches_scipy(window, polyorder):
    x = np.random.default_rng(1).normal(size=517).cumsum()
    got = ref.savgol(x, window, polyorder)
    want = savgol_filter(x, window, polyorder)
    assert np.max(np.abs(got - want)) < 1e-9 * np.max(np.abs(want))


def _flatten_scipy(time, flux, window_length, polyorder, break_tolerance,
                   niters, sigma):
    """lightkurve's ``flatten`` loop, with scipy's filter and
    interpolator."""
    m = np.isfinite(flux)
    m &= np.nan_to_num(np.abs(flux - np.nanmedian(flux))) <= (
        np.nanstd(flux) * sigma)
    for _ in range(niters):
        tm, fm = time[m], flux[m]
        dt = tm[1:] - tm[:-1]
        cut = np.where(dt > break_tolerance * np.nanmedian(dt))[0] + 1
        low, high = np.append([0], cut), np.append(cut, len(tm))
        trend = np.zeros(len(tm))
        for lo, hi in zip(low, high):
            if window_length > hi - lo or hi - lo < break_tolerance:
                trend[lo:hi] = np.nanmedian(fm[lo:hi])
            else:
                trend[lo:hi] = savgol_filter(fm[lo:hi], window_length,
                                             polyorder)
        mask1 = np.nan_to_num(np.abs(fm - trend)) < (
            np.nanstd(fm - trend) * sigma + 1e-14)
        trend_signal = interp1d(tm[mask1], trend[mask1],
                                fill_value="extrapolate")(time)
        new = np.zeros_like(m)
        new[np.where(m)[0][mask1]] = True
        m = new
    return trend_signal


def test_flatten_matches_lightkurves_loop():
    rng = np.random.default_rng(2)
    t = np.concatenate([np.arange(700), 760 + np.arange(300),
                        1100 + np.arange(40)]) * (2 / 1440)
    flux = 1 + 0.01 * np.sin(t) + 2e-4 * rng.normal(size=t.size)
    flux[rng.random(t.size) < 0.01] += 3e-3
    flux[rng.random(t.size) < 0.03] = np.nan
    got = ref.flatten(t, flux, 101, 2, 5, 3, 3)
    want = _flatten_scipy(t, flux, 101, 2, 5, 3, 3)
    assert np.max(np.abs(got - want)) < 1e-12


def _bls_loops(t, y, dy, periods, durations, oversample):
    """The binned BLS with per-period loops (a frozen copy of the
    repository's numpy oracle), likelihood objective, wrapped windows."""
    w = 1.0 / dy ** 2
    bin_d = durations.min() / oversample
    k_durs = [max(int(d / bin_d + 0.5), 1) for d in durations]
    ts = t - t.min()
    out = np.zeros((3, len(periods)))
    for ip, p in enumerate(periods):
        nbp = int(np.ceil(p / bin_d))
        ind = np.minimum((np.mod(ts, p) / bin_d).astype(int), nbp - 1)
        km = max(k_durs)
        hw = np.bincount(ind, weights=w, minlength=nbp + km)
        hwy = np.bincount(ind, weights=w * y, minlength=nbp + km)
        hw[nbp:nbp + km - 1] += hw[:km - 1]
        hwy[nbp:nbp + km - 1] += hwy[:km - 1]
        cw, cwy = (np.concatenate([[0.0], np.cumsum(h)]) for h in (hw, hwy))
        best = -np.inf
        for k in k_durs:
            if k > nbp:
                continue
            b = np.arange(nbp)
            w_in, wy_in = cw[b + k] - cw[b], cwy[b + k] - cwy[b]
            w_out, wy_out = w.sum() - w_in, (w * y).sum() - wy_in
            ok = (w_in > 0) & (w_out > 0)
            depth = np.where(ok, wy_out / np.where(ok, w_out, 1)
                             - wy_in / np.where(ok, w_in, 1), 0)
            obj = np.where(ok, 0.5 * w_in * depth ** 2, -np.inf)
            i = int(np.argmax(obj))
            if obj[i] > best:
                best = obj[i]
                out[:, ip] = (obj[i], k, i)
    return out


def test_bls_grid_matches_loops_and_bls_at():
    rng = np.random.default_rng(3)
    t = np.arange(3000) * (2 / 1440) + 0.0011
    y = 1 + 2e-4 * rng.normal(size=t.size)
    y[np.abs(np.mod(t - 0.3, 1.3) - 0.65) > 0.6] -= 1e-3
    dy = 2e-4 * rng.uniform(0.7, 1.3, t.size)
    valid = rng.random(t.size) > 0.03
    periods = np.linspace(0.4, 1.9, 40)
    durations = np.array([0.05, 0.1, 0.2])
    geom = ref.Geometry.of(periods, durations, 10)
    ts = torch.as_tensor(t - t.min())
    got = ref.bls_grid(ts, torch.as_tensor(y[None]),
                       torch.as_tensor(dy[None]),
                       torch.as_tensor(valid[None]), geom, budget=2 ** 16)
    want = _bls_loops(t[valid], y[valid], dy[valid], periods, durations, 10)
    np.testing.assert_allclose(got["power"][0].numpy(), want[0], rtol=1e-9)
    np.testing.assert_array_equal(got["k"][0].numpy(), want[1])
    np.testing.assert_array_equal(got["b"][0].numpy(), want[2])
    i = np.arange(len(periods))
    at = ref.bls_at(ts, torch.as_tensor(np.tile(y, (40, 1))),
                    torch.as_tensor(np.tile(dy, (40, 1))),
                    torch.as_tensor(np.tile(valid, (40, 1))), geom, i,
                    want[1].astype(int), want[2].astype(int))
    np.testing.assert_allclose(at["power"], want[0], rtol=1e-9)


def test_recover_start_bin_round_trip():
    d_phase = 0.005
    for period in (0.3314, 1.0, 2.71):
        nbp = int(np.ceil(period / d_phase))
        for k in (10, 66):
            b = np.arange(nbp)
            t0 = np.mod((b + 0.5 * k) * d_phase, period) + 1325.29
            got = ref.recover_start_bin(t0, 1325.29, np.full(nbp, period),
                                        np.full(nbp, k), d_phase,
                                        np.full(nbp, nbp))
            np.testing.assert_array_equal(got, b)


def test_grids_and_shapes_as_the_configurations_state():
    for name in ("tess_sector_2min.json", "kepler_lc_q1q17.json"):
        cfg = _config(name)
        t = data.time_grid(cfg)
        assert t.size == cfg["time"]["n_cadences"]
        assert np.all(np.diff(t) > 0)
        assert abs(t[-1] - t[0] - cfg["time"]["baseline_days"]) < 0.01
        assert data.period_grid(cfg, t).size == cfg["search"]["n_periods"]
    kep = _config("kepler_lc_q1q17.json")
    n = kep["time"]["n_cadences"]
    assert n - data.masked_count(kep, n) == kep["time"]["n_valid_cadences"]
    tess = data.period_grid(_config("tess_sector_2min.json"))
    assert abs(tess[0] - (0.33 + 2 / 1440)) < 1e-9
    df = 10 * 0.05 / 27.998611 ** 2          # autoperiod's spacing
    assert abs(1 / tess[-1] - 3 / 27.998611) <= df / 2


def test_stacks_are_seeded_and_share_their_shapes():
    cfg = _config("tess_sector_2min.json")
    cfg["time"]["segments"] = [[0.0, 500], [2.0, 500]]
    t = data.time_grid(cfg)
    a = data.make_stack(cfg, 2 ** 31 + 7, "stack0", 5, "cpu", t)
    b = data.make_stack(cfg, 2 ** 31 + 7, "stack0", 5, "cpu", t)
    c = data.make_stack(cfg, 2 ** 31 + 8, "stack0", 5, "cpu", t)
    for k in ("flux", "flux_err", "mask"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["flux"], c["flux"])
    masked = (~a["mask"]).sum(1)
    assert torch.all(masked == data.masked_count(cfg, t.size))
    assert torch.all(a["flux"][~a["mask"]] == 0)
