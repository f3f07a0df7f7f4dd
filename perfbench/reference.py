"""The plain reference that decides ``correct``.

Straightforward NumPy (the flatten) and PyTorch (the box least squares
grid) implementations of the algorithms a cell runs, written from their
definitions and importing nothing of the program:

- :func:`flatten` is lightkurve's ``LightCurve.flatten``: NaN and global
  outlier pre-mask, gaps where consecutive kept times differ by more than
  ``break_tolerance`` median steps, a Savitzky-Golay filter (scipy's
  ``mode="interp"``: the centred window inside a segment, a polynomial fit
  of the first and last window at its ends) on every segment at least a
  window long and the segment's median on shorter ones, ``niters`` rounds
  of sigma clipping against the trend, and the trend linearly
  interpolated (and extrapolated) over every time.
- :func:`bls_grid` is the binned BLS of astropy's kernel family with the
  likelihood objective: bins of ``min(duration) / oversample``, each
  duration a whole number of bins, every start bin of every period with
  windows wrapping across the period's edge, depth the difference of the
  weighted means out and in.  Float64, on any torch device.

Both take a :class:`Precision`.  ``FLOAT64`` is the reference; ``TF32``
is the control: float32 arithmetic whose every product takes inputs
rounded to TF32's 10-bit mantissa, the precision below the configurations'
float32 with TF32 off.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Precision", "FLOAT64", "TF32", "tf32_round", "flatten",
           "savgol", "bls_grid", "bls_at", "recover_start_bin",
           "Geometry"]


def tf32_round(x):
    """``x`` (float32 array or tensor) rounded to TF32's 10-bit mantissa
    (round to nearest, ties away from zero), returned in float32."""
    if isinstance(x, torch.Tensor):
        b = x.to(torch.float32).contiguous().view(torch.int32)
        b = (b + 0x1000) & ~0x1FFF
        return b.view(torch.float32)
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    b = (b + np.int32(0x1000)) & np.int32(~0x1FFF)
    return b.view(np.float32)


@dataclass(frozen=True)
class Precision:
    """The arithmetic of a reference run: its dtype, and whether each
    product's inputs are first rounded to TF32."""
    name: str
    np_dtype: type
    torch_dtype: torch.dtype
    tf32: bool

    def operand(self, x):
        """An input of a product, in this precision."""
        if isinstance(x, torch.Tensor):
            x = x.to(self.torch_dtype)
        else:
            x = np.asarray(x, self.np_dtype)
        return tf32_round(x) if self.tf32 else x

    def bins(self, phase, d_phase):
        """Fold bins ``floor(phase / d_phase)``; in TF32 the division is
        the product with the reciprocal, both operands rounded."""
        if not self.tf32:
            return torch.floor(phase / d_phase).to(torch.int64)
        inv = torch.tensor(1.0 / d_phase, dtype=self.torch_dtype,
                           device=phase.device)
        return torch.floor(self.operand(phase) * self.operand(inv)).to(
            torch.int64)

    def array(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.torch_dtype)
        return np.asarray(x, self.np_dtype)


FLOAT64 = Precision("float64", np.float64, torch.float64, False)
TF32 = Precision("tf32", np.float32, torch.float32, True)


# ---------------------------------------------------------------------------
# flatten
# ---------------------------------------------------------------------------
def _savgol_maps(window, polyorder):
    """(centre coefficients (w,), left edge map (h, w), right edge map
    (h, w)) of scipy's ``savgol_filter(mode="interp")`` for smoothing."""
    h = window // 2
    pos = np.arange(-h, h + 1, dtype=np.float64)
    A = np.vander(pos, polyorder + 1, increasing=True)
    centre = np.linalg.pinv(A)[0]
    V = np.vander(np.arange(window, dtype=np.float64) - h, polyorder + 1,
                  increasing=True)
    fit = V @ np.linalg.pinv(V)             # (w, w): values of the fit
    return centre, fit[:h], fit[window - h:]


def savgol(x, window, polyorder, prec=FLOAT64, maps=None):
    """scipy's ``savgol_filter(x, window, polyorder)`` (``mode="interp"``)
    of a 1-D array at least ``window`` long, in ``prec``."""
    centre, left, right = maps or _savgol_maps(window, polyorder)
    h = window // 2
    xs = prec.operand(x)
    c = prec.operand(centre)
    y = np.correlate(xs, c, mode="valid").astype(prec.np_dtype)
    lo = prec.operand(left) @ xs[:window]
    hi = prec.operand(right) @ xs[-window:]
    return np.concatenate([lo, y, hi]).astype(prec.np_dtype)


def _interp_extrapolate(x, xp, fp):
    """Linear interpolation through (xp, fp), extrapolated linearly past
    both ends (scipy's ``interp1d(fill_value="extrapolate")``)."""
    y = np.interp(x, xp, fp)
    if xp.size >= 2:
        lo, hi = x < xp[0], x > xp[-1]
        s0 = (fp[1] - fp[0]) / (xp[1] - xp[0])
        s1 = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
        y = np.where(lo, fp[0] + (x - xp[0]) * s0, y)
        y = np.where(hi, fp[-1] + (x - xp[-1]) * s1, y)
    return y


def flatten(time, flux, window_length=101, polyorder=2, break_tolerance=5,
            niters=3, sigma=3, prec=FLOAT64, maps=None):
    """lightkurve's ``flatten`` trend of one curve: ``time``, ``flux`` 1-D
    host arrays, NaN flux where a cadence is missing.  Returns the trend
    at every time (float64)."""
    time = np.asarray(time, np.float64)
    flux = prec.array(flux)
    finite = np.isfinite(flux)
    fv = flux[finite]
    m = finite.copy()
    m[finite] = np.abs(fv - np.median(fv)) <= np.std(fv) * sigma
    bt = np.nan if break_tolerance is None else float(break_tolerance)
    maps = maps or _savgol_maps(window_length, polyorder)
    trend_all = None
    for _ in range(niters):
        tm, fm = prec.array(time[m]), flux[m]
        dt = tm[1:] - tm[:-1]
        cut = np.nonzero(dt > bt * np.median(dt))[0] + 1
        low = np.concatenate([[0], cut])
        high = np.concatenate([cut, [tm.size]])
        trend = np.empty(tm.size, prec.np_dtype)
        for lo, hi in zip(low, high):
            if window_length > hi - lo or hi - lo < bt:
                trend[lo:hi] = np.median(fm[lo:hi])
            else:
                trend[lo:hi] = savgol(fm[lo:hi], window_length, polyorder,
                                      prec, maps)
        resid = fm - trend
        keep = np.abs(resid) < np.std(resid) * sigma + 1e-14
        trend_all = _interp_extrapolate(
            time, time[m][keep].astype(np.float64),
            trend[keep].astype(np.float64))
        idx = np.nonzero(m)[0]
        m = np.zeros_like(m)
        m[idx[keep]] = True
    return trend_all


# ---------------------------------------------------------------------------
# box least squares
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Geometry:
    """A search's grid: trial periods (float64), the bin width and each
    duration's whole number of bins."""
    periods: np.ndarray
    durations: np.ndarray
    d_phase: float
    k_durs: tuple

    @classmethod
    def of(cls, periods, durations, oversample):
        durations = np.asarray(durations, np.float64)
        d_phase = float(durations.min()) / oversample
        k = tuple(max(int(d / d_phase + 0.5), 1) for d in durations)
        return cls(np.asarray(periods, np.float64), durations, d_phase, k)

    def nbins(self):
        return np.ceil(self.periods / self.d_phase).astype(np.int64)


def _weights(y, dy, valid, prec):
    w = torch.where(valid, 1.0 / torch.square(prec.array(dy)), 0.0)
    y = torch.where(valid, prec.array(y), 0.0)
    return w, prec.operand(w) * prec.operand(y)


def bls_grid(ts, y, dy, valid, geom, prec=FLOAT64, budget=2 ** 25):
    """The likelihood of every (start bin, duration) of every period for K
    curves on one time grid, reduced per period.

    ts : (n,) times from the grid's first time; y, dy, valid : (K, n)
    tensors on one device.  Returns a dict of (K, P) float64 tensors on
    the same device: ``power`` (the period's best likelihood),
    ``k`` (its duration in bins) and ``b`` (its start bin)."""
    dev = y.device
    K, n = y.shape
    f = prec.torch_dtype
    ts = prec.array(ts.to(dev))
    w, wy = _weights(y, dy, valid, prec)
    periods = torch.as_tensor(geom.periods, dtype=f, device=dev)
    nbp_all = torch.as_tensor(geom.nbins(), device=dev)
    kmax = max(geom.k_durs)
    P = periods.shape[0]
    step = max(1, budget // max(K * n, 1))
    out = {k: torch.empty((K, P), dtype=torch.float64, device=dev)
           for k in ("power", "k", "b")}
    for lo in range(0, P, step):
        pc = periods[lo:lo + step]
        nbp = nbp_all[lo:lo + step]
        C = pc.shape[0]
        ph = torch.fmod(ts[None, :], pc[:, None])               # (C, n)
        ind = torch.minimum(prec.bins(ph, geom.d_phase), (nbp - 1)[:, None])
        NB = int(nbp.max()) + kmax
        flat = ((torch.arange(C, device=dev)[:, None, None] * K
                 + torch.arange(K, device=dev)[None, :, None]) * NB
                + ind[:, None, :]).reshape(-1)
        hist = [torch.zeros(C * K * NB, dtype=f, device=dev).index_add_(
            0, flat, v[None].expand(C, K, n).reshape(-1)).view(C, K, NB)
            for v in (w, wy)]
        del flat
        rows = torch.arange(NB, device=dev)
        src = rows[None, :] - nbp[:, None]                          # (C, NB)
        wrap = (src >= 0) & (src < kmax - 1)
        src = torch.where(wrap, src, 0)[:, None, :].expand(C, K, NB)
        ext = [h + torch.where(wrap[:, None, :], torch.gather(h, 2, src),
                               0.0) for h in hist]
        cs = [torch.cat([torch.zeros((C, K, 1), dtype=f, device=dev),
                         torch.cumsum(e, 2)], 2) for e in ext]
        tot = [torch.gather(c, 2, nbp[:, None, None].expand(C, K, 1))
               for c in cs]
        best = torch.full((C, K), -torch.inf, dtype=torch.float64,
                          device=dev)
        best_k = torch.zeros((C, K), dtype=torch.float64, device=dev)
        best_b = torch.zeros((C, K), dtype=torch.float64, device=dev)
        starts = rows[:NB - kmax]
        S = starts.size(0)
        for k in geom.k_durs:
            w_in = cs[0][:, :, k:k + S] - cs[0][:, :, :S]
            wy_in = cs[1][:, :, k:k + S] - cs[1][:, :, :S]
            w_out = tot[0] - w_in
            ok = ((w_in > 0) & (w_out > 0)
                  & (starts[None, None, :] < nbp[:, None, None])
                  & (k <= nbp)[:, None, None])
            w_in_s = torch.where(ok, w_in, 1.0)
            depth = ((tot[1] - wy_in) / torch.where(ok, w_out, 1.0)
                     - wy_in / w_in_s)
            obj = torch.where(ok, 0.5 * prec.operand(w_in_s)
                              * prec.operand(depth) * depth, -torch.inf)
            val, arg = obj.to(torch.float64).max(2)
            better = val > best
            best = torch.where(better, val, best)
            best_k = torch.where(better, float(k), best_k)
            best_b = torch.where(better, arg.to(torch.float64), best_b)
        out["power"][:, lo:lo + C] = best.T
        out["k"][:, lo:lo + C] = best_k.T
        out["b"][:, lo:lo + C] = best_b.T
    return out


def bls_at(ts, y, dy, valid, geom, p_index, k, b, prec=FLOAT64):
    """The box statistics of one (period, duration, start bin) per curve,
    the binned definition of :func:`bls_grid`.  ``p_index``, ``k``, ``b``
    are (K,) integer arrays.  Returns a dict of (K,) float64 host arrays:
    ``power`` (likelihood), ``depth`` and its uncertainty ``depth_err``
    (NaN where the window is empty or holds every sample)."""
    dev = y.device
    f = prec.torch_dtype
    ts = prec.array(ts.to(dev))
    w, wy = _weights(y, dy, valid, prec)
    per = torch.as_tensor(geom.periods[p_index], dtype=f, device=dev)
    nbp = torch.as_tensor(geom.nbins()[p_index], device=dev)
    ph = torch.fmod(ts[None, :], per[:, None])                 # (K, n)
    ind = torch.minimum(prec.bins(ph, geom.d_phase), (nbp - 1)[:, None])
    kk = torch.as_tensor(np.asarray(k), device=dev)[:, None]
    bb = torch.as_tensor(np.asarray(b), device=dev)[:, None]
    rel = torch.remainder(ind - bb, nbp[:, None])
    inside = rel < kk
    w_in = (w * inside).sum(1)
    wy_in = (wy * inside).sum(1)
    W, WY = w.sum(1), wy.sum(1)
    ok = (w_in > 0) & (W - w_in > 0)
    depth = ((WY - wy_in) / torch.where(ok, W - w_in, 1.0)
             - wy_in / torch.where(ok, w_in, 1.0))
    power = torch.where(ok, 0.5 * w_in * depth * depth, torch.nan)
    sigma = torch.sqrt(1.0 / torch.where(ok, w_in, 1.0)
                       + 1.0 / torch.where(ok, W - w_in, 1.0))
    return {k: torch.where(ok, v, torch.nan).double().cpu().numpy()
            for k, v in (("power", power), ("depth", depth),
                         ("depth_err", sigma))}


def recover_start_bin(transit_time, t_first, period, k, d_phase, nbins_p):
    """The start bin of the window whose mid-time is ``transit_time``
    (``t_first + ((b + k/2) d_phase mod period)``), or -1 where no start
    bin below ``nbins_p`` gives it within a tenth of a bin.  All
    arguments are arrays of one length."""
    x = (np.asarray(transit_time, np.float64) - t_first) / d_phase - 0.5 * k
    x = np.where(np.isfinite(x), x, -1e18)            # no start bin
    best = np.full(x.shape, -1, np.int64)
    err = np.full(x.shape, np.inf)
    for shift in (0.0, period / d_phase, -period / d_phase):
        b = np.round(x + shift)
        e = np.abs(x + shift - b)
        ok = (b >= 0) & (b < nbins_p) & (e < err)
        best = np.where(ok, np.where(ok, b, 0).astype(np.int64), best)
        err = np.where(ok, e, err)
    return np.where(err < 0.1, best, -1)
