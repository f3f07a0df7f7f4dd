"""Sigma clipping and running statistics over the last axis.

Counterpart of ``lightkurve_tpu/ops/stats.py``.  ``sigma_clip_mask`` is
the mask-based form of ``astropy.stats.sigma_clip`` as the reference's
``remove_outliers`` and ``estimate_cdpp`` use it: center = median, spread
= std (ddof=0), ``maxiters`` iterations, each a no-op once converged
(the same fixed point).
"""
from __future__ import annotations

import torch

from .masked import masked_mean, masked_median, masked_std

__all__ = ["sigma_clip_mask", "running_mean"]


def sigma_clip_mask(x, mask=None, sigma=5.0, sigma_lower=None,
                    sigma_upper=None, maxiters=5, cenfunc="median",
                    stdfunc="std"):
    """Iterative sigma clipping over the last axis.

    x : (..., n); mask : (..., n) bool, True for valid input (non-finite
    entries are masked too); sigma, sigma_lower, sigma_upper : thresholds
    (astropy semantics); maxiters : iterations (astropy's default 5);
    cenfunc : "median" or "mean"; stdfunc : "std" (ddof=0).

    Returns a bool tensor, True where the point was REJECTED (non-finite
    input points included), as the ``.mask`` of astropy's result.
    """
    if stdfunc != "std":
        raise ValueError(f"stdfunc must be 'std' (got {stdfunc!r})")
    sigma_lower = sigma if sigma_lower is None else sigma_lower
    sigma_upper = sigma if sigma_upper is None else sigma_upper
    valid = torch.isfinite(x)
    if mask is not None:
        valid = valid & mask
    x0 = torch.where(valid, x, 0.0)
    cen_fn = masked_median if cenfunc == "median" else masked_mean
    for _ in range(int(maxiters)):
        center = cen_fn(x0, valid)[..., None]
        std = masked_std(x0, valid)[..., None]
        valid = valid & (x0 >= center - sigma_lower * std) & (
            x0 <= center + sigma_upper * std)
    return ~valid


def running_mean(x, window_size):
    """Moving average over the last axis by cumulative sums; output length
    ``n - window_size + 1`` (the reference's ``utils.running_mean``)."""
    w = min(int(window_size), x.shape[-1])
    csum = torch.cumsum(x, -1)
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=csum.dtype,
                       device=x.device)
    csum = torch.cat([zero, csum], -1)
    return (csum[..., w:] - csum[..., :-w]) / float(w)
