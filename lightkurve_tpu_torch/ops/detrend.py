"""Savitzky-Golay flatten of a batch of light curves.

Counterpart of ``lightkurve_tpu/ops/detrend.py``, which re-implements the
reference's ``LightCurve.flatten`` (``lightcurve.py:943-1078``): masking,
gap segmentation at ``dt > break_tolerance * median(dt)``, per-segment SG
filtering with the short-segment median fallback, the iterative sigma
clip, and the linear interpolation and extrapolation of the trend over
every cadence.  Here as batched tensor code over (B, n): the valid
samples of each row are moved to its front in their order (the
reference's ``flux[mask]``) by a stable sort on the validity key, and the
segment bounds come from running maxima and minima of break positions.
"""
from __future__ import annotations

import torch

from .interp import interp_linear_fill
from .masked import masked_median, masked_median_grouped, masked_std
from .savgol import savgol_filter_interp

__all__ = ["flatten", "flatten_batch"]


def _segment_bounds(brk):
    """Each position's [lo, hi) segment bounds given break flags (``brk[i]``:
    a segment starts at i; ``brk[..., 0]`` is True): ``lo`` the last break
    at or before i, ``hi`` the first break after i, else n."""
    n = brk.shape[-1]
    idx = torch.arange(n, device=brk.device).expand(brk.shape)
    lo = torch.cummax(torch.where(brk, idx, 0), -1).values
    first = torch.flip(torch.cummin(torch.flip(
        torch.where(brk, idx, n), [-1]), -1).values, [-1])
    hi = torch.cat([first[..., 1:], torch.full_like(first[..., :1], n)], -1)
    return lo, hi


def flatten_batch(time, flux, valid, H, break_tolerance, sigma, niters=3,
                  max_segments=16):
    """The SG trend of each row of a (masked, padded) batch.

    time, flux : (B, n) tensors; padded tail entries must be finite and
        each row's valid times ascending.
    valid : (B, n) bool, True where the sample enters the fit.
    H : (w, w) SG projection matrix (``savgol_design_matrix``).
    break_tolerance : float; NaN disables gap splitting (the reference
        turns None into NaN, ``lightcurve.py:1015-1016``).
    sigma : clip threshold.  niters : sigma-clip iterations.
    max_segments : segments whose medians the short-segment fallback
        tracks; segment ids past it share the last one's median, as
        ``lightkurve_tpu`` does.

    Returns (trend, valid_out): the trend at every time (interpolated
    through the kept samples) and the mask after clipping, both (B, n).
    """
    H = torch.as_tensor(H, dtype=flux.dtype, device=flux.device)
    w = H.shape[0]
    bt, sigma = float(break_tolerance), float(sigma)
    B, n = flux.shape
    idx = torch.arange(n, device=flux.device)

    def one_iter(valid):
        m = valid.sum(-1, keepdim=True)
        in_m = idx < m
        # valid samples first, each group in its original order
        order = torch.sort((~valid).to(torch.uint8), dim=-1,
                           stable=True).indices
        ct, cf = torch.gather(time, -1, order), torch.gather(flux, -1, order)

        # gaps over the compacted times (lightcurve.py:1022-1027)
        dt = torch.cat([ct[:, 1:] - ct[:, :-1],
                        torch.zeros_like(ct[:, :1])], -1)
        med_dt = masked_median(dt, idx < m - 1)[:, None]
        is_gap = dt > bt * med_dt                        # NaN tol: none
        brk = torch.cat([torch.ones_like(valid[:, :1]), is_gap[:, :-1]], -1)
        brk = brk | ~in_m                                # padding: alone
        lo, hi = _segment_bounds(brk)
        hi = torch.minimum(hi, m)                        # end at padding
        seglen = hi - lo
        trend_c = savgol_filter_interp(cf, H, lo, hi)

        # short-segment median fallback (lightcurve.py:1035-1038)
        seg_id = torch.clamp(torch.cumsum(brk, -1) - 1, 0, max_segments - 1)
        seg_med = masked_median_grouped(cf, seg_id, max_segments, valid=in_m)
        short = (w > seglen) | (seglen < bt)
        trend_c = torch.where(short, torch.gather(seg_med, -1, seg_id),
                              trend_c)

        # clip outliers against the trend (lightcurve.py:1049-1056)
        resid = cf - trend_c
        std = masked_std(resid, in_m)[:, None]
        keep = (torch.abs(resid) < std * sigma + 1e-14) & in_m

        # the kept trend back at original positions (NaN marks the
        # dropped), then interpolated over every time
        merged = torch.where(keep, trend_c, torch.nan)
        trend_orig = torch.empty_like(merged).scatter_(-1, order, merged)
        valid_new = torch.isfinite(trend_orig)
        return valid_new, interp_linear_fill(time, valid_new, trend_orig)

    for _ in range(max(int(niters), 1)):
        valid, trend = one_iter(valid)
    return trend, valid


def flatten(time, flux, valid, H, break_tolerance, sigma, niters=3,
            max_segments=16):
    """:func:`flatten_batch` of one (n,) light curve; returns (trend,
    valid_out), each (n,)."""
    trend, valid = flatten_batch(time[None], flux[None], valid[None], H,
                                 break_tolerance, sigma, niters, max_segments)
    return trend[0], valid[0]
