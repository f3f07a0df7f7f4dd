"""The comparison that decides ``correct``.

Every number is a largest error over the checked sample, so a single
wrong answer fails the run:

- ``flat_err_curve_p99``: for each checked curve the 99th percentile of
  the absolute difference between its flattened flux and the reference's
  over its valid cadences; the largest over the curves.  A curve's
  percentile passes the float32 rounding of a few hundred cadences near a
  segment's edge and fails a mis-flattened segment (a Kepler segment is
  2% of its curve; PERF.md);
- ``winner_gap``: for each checked curve, how far the reference's
  likelihood at the reported winner (period, duration, mid-transit time)
  lies below the reference's best over the whole grid, as a share of that
  best (a winner off the grid, or on no start bin, reads infinite);
- ``winner_err``: the larger of the relative difference of the reported
  power from the reference's at the reported winner and the difference of
  the reported depth there over the larger of the reference's depth and
  its uncertainty (a box that holds almost the whole period has a depth
  near nought).
"""
from __future__ import annotations

import numpy as np

from . import reference as ref
from .reference import FLOAT64

__all__ = ["reference_flatten", "winners_of_grid", "judge_winners",
           "match_winners", "flat_errors", "curve_p99"]


def _worst(values):
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return np.inf
    values = np.where(np.isnan(values), np.inf, values)
    return float(values.max())


def reference_flatten(t, flux, valid, err, fl, prec=FLOAT64):
    """The reference's flattened flux and flux_err of one curve (valid
    cadences only enter; others read NaN)."""
    f = np.where(valid, flux, np.nan)
    trend = ref.flatten(t, f, window_length=fl["window_length"],
                        polyorder=fl["polyorder"],
                        break_tolerance=fl["break_tolerance"],
                        niters=fl["niters"], sigma=fl["sigma"], prec=prec)
    return f / trend, np.where(valid, err, np.nan) / trend


def flat_errors(got, want, valid):
    """|got - want| at the valid cadences of each row pair, one array a
    row (infinite where the program's value is not finite)."""
    out = []
    for g, w, v in zip(got, want, valid):
        d = np.abs(np.asarray(g, np.float64)[v] - w[v])
        out.append(np.where(np.isfinite(d), d, np.inf))
    return out


def curve_p99(errors):
    """The largest over curves of each curve's 99th-percentile error
    (``errors``: one array a curve); infinite with no curve or a value
    that is not finite."""
    worst = np.inf if not len(errors) else 0.0
    for e in errors:
        e = np.ravel(e)
        if e.size == 0 or not np.all(np.isfinite(e)):
            return np.inf
        worst = max(worst, float(np.quantile(e, 0.99)))
    return worst


def winners_of_grid(grid, geom, t_first):
    """The (period, duration, transit_time) of each curve's best cell of a
    :func:`reference.bls_grid` result, as a search reports them."""
    power = grid["power"].cpu().numpy()
    best = np.argmax(power, axis=1)
    rows = np.arange(power.shape[0])
    k = grid["k"].cpu().numpy()[rows, best].astype(np.int64)
    b = grid["b"].cpu().numpy()[rows, best]
    period = geom.periods[best]
    dur = np.array([geom.durations[list(geom.k_durs).index(int(v))]
                    for v in k])
    t0 = np.mod((b + 0.5 * k) * geom.d_phase, period) + t_first
    return dict(period=period, duration=dur, transit_time=t0,
                power=power[rows, best], best_index=best, k=k,
                b=b.astype(np.int64))


def match_winners(win, geom, t_first, grid_dtype=np.float32):
    """Grid indices (period, duration bins, start bin) of reported
    winners; -1 where a winner is not on the grid as the search was
    handed it (periods and durations in ``grid_dtype``)."""
    per = np.asarray(win["period"], np.float64)
    grid = geom.periods.astype(grid_dtype).astype(np.float64)
    idx = np.clip(np.searchsorted(grid, per), 0, grid.size - 1)
    lo = np.clip(idx - 1, 0, grid.size - 1)
    idx = np.where(np.abs(grid[lo] - per) < np.abs(grid[idx] - per), lo,
                   idx)
    p_ok = grid[idx] == per
    durs = geom.durations.astype(grid_dtype).astype(np.float64)
    dur = np.asarray(win["duration"], np.float64)
    j = np.argmin(np.abs(durs[None, :] - dur[:, None]), axis=1)
    d_ok = durs[j] == dur
    k = np.asarray(geom.k_durs)[j]
    b = ref.recover_start_bin(win["transit_time"], t_first,
                              geom.periods[idx], k, geom.d_phase,
                              geom.nbins()[idx])
    ok = p_ok & d_ok & (b >= 0)
    return np.where(ok, idx, -1), k, np.where(ok, b, 0), ok


def judge_winners(win, best_power, ts, y, dy, valid, geom, t_first,
                  grid_dtype=np.float32):
    """(winner_gap, winner_err) of reported winners ``win`` (host arrays
    per curve: period, duration, transit_time, power, depth) against the
    reference's curves ``y``, ``dy``, ``valid`` (tensors) whose best
    likelihoods are ``best_power``."""
    idx, k, b, ok = match_winners(win, geom, t_first, grid_dtype)
    at = ref.bls_at(ts, y, dy, valid, geom, np.where(ok, idx, 0), k, b)
    power_at = np.where(ok, at["power"], np.nan)
    gap = (best_power - power_at) / best_power
    p_err = np.abs(np.asarray(win["power"], np.float64) - power_at) / \
        np.abs(power_at)
    d_err = np.abs(np.asarray(win["depth"], np.float64) - at["depth"]) / \
        np.maximum(np.abs(at["depth"]), at["depth_err"])
    return _worst(gap), _worst(np.maximum(p_err, d_err))
