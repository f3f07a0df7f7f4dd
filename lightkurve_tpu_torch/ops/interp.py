"""Interpolation: linear with extrapolation, and PCHIP.

Counterpart of ``lightkurve_tpu/ops/interp.py``.  The reference's
``scipy.interpolate.interp1d(..., fill_value="extrapolate")`` (the flatten
trend spread back over masked cadences, ``lightcurve.py:1053-1058``) is
:func:`interp_linear_fill` (kept cadences marked in place),
:func:`interp_linear_extrap` (sample points given, padded rows allowed)
and :func:`interp_linear_ranked` (their ranks given);
``scipy.interpolate.PchipInterpolator`` (the CBVs onto a light curve's
times, ``cbvcorrector.py:1309``) is :func:`pchip_interpolate` with
:func:`pchip_slopes`.  Every function takes leading batch dimensions, so
one call interpolates all of a CBV set's vectors, (k, n).
"""
from __future__ import annotations

import torch

__all__ = ["interp_linear_extrap", "interp_linear_ranked",
           "interp_linear_fill", "pchip_interpolate", "pchip_slopes"]


def _take_b(a, idx):
    """``a`` gathered at ``idx`` along the last axis, the leading axes of
    both broadcast against each other."""
    nd = max(a.dim(), idx.dim())
    a = a.reshape((1,) * (nd - a.dim()) + a.shape)
    idx = idx.reshape((1,) * (nd - idx.dim()) + idx.shape)
    return torch.take_along_dim(a, idx, -1)


def _searchsorted(xp, x, right=False):
    """``torch.searchsorted`` with the leading axes of the sorted rows
    ``xp`` and the queries ``x`` broadcast against each other."""
    if xp.dim() == 1:
        return torch.searchsorted(xp, x.contiguous(), right=right)
    lead = torch.broadcast_shapes(xp.shape[:-1], x.shape[:-1])
    return torch.searchsorted(
        xp.expand(*lead, xp.shape[-1]).contiguous(),
        x.expand(*lead, x.shape[-1]).contiguous(), right=right)


def interp_linear_extrap(x, xp, fp, n_valid=None):
    """Piecewise-linear interpolation with linear extrapolation at both
    ends, ``scipy.interpolate.interp1d(xp, fp, fill_value="extrapolate")``.

    ``x`` (..., m) queries; ``xp`` (..., n) ascending sample positions,
    of which only the first ``n_valid`` (a number or a (...,) tensor;
    default all) count; ``fp`` (..., n) the samples."""
    n = xp.shape[-1]
    if n_valid is None:
        n_valid = n
    n_valid = torch.as_tensor(n_valid, device=xp.device)
    valid = torch.arange(n, device=xp.device) < n_valid[..., None]
    xp_s = torch.where(valid, xp, torch.inf)
    idx = _searchsorted(xp_s, x)
    return _interp_at_ranks(x, xp, fp, idx, n_valid)


def interp_linear_ranked(x, xp, fp, ranks, n_valid):
    """:func:`interp_linear_extrap` given the ranks: ``ranks[i]`` is the
    number of valid ``xp`` entries strictly below ``x[i]``."""
    return _interp_at_ranks(x, xp, fp, ranks,
                            torch.as_tensor(n_valid, device=xp.device))


def _interp_at_ranks(x, xp, fp, idx, n_valid):
    # segment [idx - 1, idx], clamped into the valid range [0, n_valid - 1]
    top = torch.clamp(n_valid[..., None], min=2) - 1
    hi = torch.minimum(torch.clamp(idx, min=1), top)
    lo = hi - 1
    x_lo, x_hi = _take_b(xp, lo), _take_b(xp, hi)
    f_lo, f_hi = _take_b(fp, lo), _take_b(fp, hi)
    denom = x_hi - x_lo
    slope = torch.where(denom != 0, (f_hi - f_lo) / torch.where(
        denom == 0, 1.0, denom), 0.0)
    return f_lo + slope * (x - x_lo)


def _take(a, i):
    return torch.gather(a, -1, torch.clamp(i, 0, a.shape[-1] - 1))


def interp_linear_fill(x, kept, f):
    """Piecewise-linear interpolation with linear extrapolation at both
    ends through the points ``(x[kept], f[kept])``, evaluated at every
    ``x``; ``x`` ascending along the last axis.

    Endpoints follow the reference's clamped ranks: an interior sample
    uses the last kept sample strictly before it and the first kept at or
    after it; the head extrapolates through the first two kept samples,
    the tail through the last two.  A row with one kept sample is constant
    at its value (no slope), and a row with none takes the value of ``f``
    at its last sample (NaN in flatten, where unkept samples hold NaN).
    """
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand(x.shape)
    # last kept at or before i, and the one before that
    last = torch.cummax(torch.where(kept, idx, -1), -1).values
    p1 = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], -1)
    p2 = torch.where(p1 >= 0, _take(p1, p1), -1)
    # first kept at or after i, and the one after that
    first = torch.flip(torch.cummin(torch.flip(
        torch.where(kept, idx, n), [-1]), -1).values, [-1])
    after = torch.cat([first[..., 1:], torch.full_like(first[..., :1], n)],
                      -1)
    n1, n2 = first, torch.where(first < n, _take(after, first), n)
    pv1, pv2, nv1, nv2 = p1 >= 0, p2 >= 0, n1 < n, n2 < n
    px1, px2, nx1, nx2 = (_take(x, i) for i in (p1, p2, n1, n2))
    pf1, pf2, nf1, nf2 = (_take(f, i) for i in (p1, p2, n1, n2))

    head = ~pv1                                           # rank 0
    x_lo = torch.where(head, nx1, torch.where(
        nv1, px1, torch.where(pv2, px2, px1)))
    f_lo = torch.where(head, nf1, torch.where(
        nv1, pf1, torch.where(pv2, pf2, pf1)))
    x_hi = torch.where(head, torch.where(nv2, nx2, nx1),
                       torch.where(nv1, nx1, px1))
    f_hi = torch.where(head, torch.where(nv2, nf2, nf1),
                       torch.where(nv1, nf1, pf1))
    denom = x_hi - x_lo
    slope = torch.where(denom != 0, (f_hi - f_lo) / torch.where(
        denom == 0, 1.0, denom), 0.0)
    return f_lo + slope * (x - x_lo)


def pchip_slopes(x, y):
    """Derivatives of the PCHIP (Fritsch-Carlson) monotone cubic through
    ``(x, y)`` along the last axis, scipy's ``PchipInterpolator`` rules:
    the weighted harmonic mean inside where the neighbouring slopes share
    a sign (else 0), the one-sided three-point estimate with scipy's
    monotonicity clamps at the ends, the secant when there are two
    points.  ``x`` strictly ascending, at least two points."""
    h = torch.diff(x, dim=-1)
    delta = torch.diff(y, dim=-1) / h
    h0, h1 = h[..., :-1], h[..., 1:]
    d0, d1 = delta[..., :-1], delta[..., 1:]
    w1 = 2 * h1 + h0
    w2 = h1 + 2 * h0
    same_sign = (d0 * d1) > 0
    denom = torch.where(same_sign,
                        w1 / torch.where(d0 == 0, 1.0, d0)
                        + w2 / torch.where(d1 == 0, 1.0, d1), 1.0)
    interior = torch.where(same_sign, (w1 + w2) / denom, 0.0)

    def edge(h0, h1, d0, d1):
        # scipy's _edge_case: the one-sided three-point estimate
        d = ((2 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
        mask0 = torch.sign(d) != torch.sign(d0)
        mask1 = (torch.sign(d0) != torch.sign(d1)) & (
            torch.abs(d) > 3 * torch.abs(d0))
        d = torch.where(mask0, 0.0, d)
        return torch.where(mask1 & ~mask0, 3 * d0, d)

    if x.shape[-1] == 2:
        left = right = delta[..., 0]
    else:
        left = edge(h[..., 0], h[..., 1], delta[..., 0], delta[..., 1])
        right = edge(h[..., -1], h[..., -2], delta[..., -1], delta[..., -2])
    left, right = (torch.broadcast_to(e, interior.shape[:-1])
                   for e in (left, right))
    return torch.cat([left[..., None], interior, right[..., None]], -1)


def pchip_interpolate(xq, x, y, extrapolate=True):
    """The PCHIP interpolant of ``(x, y)`` (last axis) at ``xq``; past the
    ends the end segments' cubics continue, or NaN when ``extrapolate`` is
    False.  ``y`` may carry more leading axes than ``x`` (several vectors
    on one grid)."""
    d = pchip_slopes(x, y)
    n = x.shape[-1]
    idx = torch.clamp(_searchsorted(x, xq, right=True) - 1, 0, n - 2)
    x0, x1 = _take_b(x, idx), _take_b(x, idx + 1)
    y0, y1 = _take_b(y, idx), _take_b(y, idx + 1)
    d0, d1 = _take_b(d, idx), _take_b(d, idx + 1)
    h = x1 - x0
    t = (xq - x0) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t * t * (3 - 2 * t)
    h11 = t * t * (t - 1)
    out = h00 * y0 + h10 * h * d0 + h01 * y1 + h11 * h * d1
    if not extrapolate:
        out = torch.where((xq < x[..., :1]) | (xq > x[..., -1:]),
                          torch.nan, out)
    return out
