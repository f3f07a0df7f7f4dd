"""Linear interpolation of a trend over every cadence.

Counterpart of ``lightkurve_tpu/ops/interp.py``, so far only
:func:`interp_linear_fill`, which spreads the flatten trend from its kept
cadences back over all of them (the reference's ``interp1d(...,
fill_value="extrapolate")``, ``lightcurve.py:1053-1058``).
"""
from __future__ import annotations

import torch

__all__ = ["interp_linear_fill"]


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
