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

Times may be float64 beside float32 fluxes: the gaps are then found, and
the trend interpolated, on the times as given (a BTJD time rounded to
float32 moves by up to 6e-5 d, which turns masked runs into gaps).
"""
from __future__ import annotations

import torch

from ..diagnostics import span
from .interp import interp_linear_fill
from .masked import (masked_median, masked_median_grouped, masked_std,
                     segment_medians)
from .savgol import savgol_filter_interp

__all__ = ["FlattenGraph", "flatten", "flatten_batch"]


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


def _medians(cf, brk, lo, hi, in_m, max_segments):
    """Each compacted sample's segment median: its own segment's
    (``max_segments=None``), or that of segment id ``min(id,
    max_segments - 1)`` over the ids' pooled samples."""
    if max_segments is None:
        return segment_medians(cf, lo, hi)
    seg_id = torch.clamp(torch.cumsum(brk, -1) - 1, 0, max_segments - 1)
    med = masked_median_grouped(cf, seg_id, max_segments, valid=in_m)
    return torch.gather(med, -1, seg_id)


def flatten_batch(time, flux, valid, H, break_tolerance, sigma, niters=3,
                  max_segments=16, static=False):
    """The SG trend of each row of a (masked, padded) batch.

    time, flux : (B, n) tensors; padded tail entries must be finite and
        each row's valid times ascending.  ``time`` may be float64 with
        ``flux`` in float32; the trend comes back in ``flux``'s dtype.
    valid : (B, n) bool, True where the sample enters the fit.
    H : (w, w) SG projection matrix (``savgol_design_matrix``).
    break_tolerance : float; NaN disables gap splitting (the reference
        turns None into NaN, ``lightcurve.py:1015-1016``).
    sigma : clip threshold.  niters : sigma-clip iterations.
    max_segments : segments whose medians the short-segment fallback
        tracks; segment ids past it share the last one's median, as
        ``lightkurve_tpu`` does.  ``None`` tracks every segment, as
        lightkurve does (:func:`~.masked.segment_medians`).
    static : no read on the host, so that the call can be captured in a
        CUDA graph (``savgol_filter_interp(static=True)``; with
        ``max_segments=None``, as :class:`FlattenGraph` calls it).

    Returns (trend, valid_out): the trend at every time (interpolated
    through the kept samples) and the mask after clipping, both (B, n).
    """
    B, n = flux.shape
    niters = max(int(niters), 1)
    with span("flatten", curves=B, cadences=n, niters=niters):
        with span("flatten.design"):
            # cast where the flux is: a host cast of a (w, w) matrix wakes
            # torch's CPU thread pool, whose spinning threads then slow the
            # host's launches (14 ms of a 36-ms single-curve flatten at
            # w = 901 on an H100's host)
            H = torch.as_tensor(H, device=flux.device).to(flux.dtype)
        w = H.shape[0]
        bt, sigma = float(break_tolerance), float(sigma)
        idx = torch.arange(n, device=flux.device)

        def one_iter(valid):
            with span("flatten.compact"):
                m = valid.sum(-1, keepdim=True)
                in_m = idx < m
                # valid samples first, each group in its original order
                order = torch.sort((~valid).to(torch.uint8), dim=-1,
                                   stable=True).indices
                ct = torch.gather(time, -1, order)
                cf = torch.gather(flux, -1, order)

            # gaps over the compacted times (lightcurve.py:1022-1027)
            with span("flatten.gaps"):
                dt = torch.cat([ct[:, 1:] - ct[:, :-1],
                                torch.zeros_like(ct[:, :1])], -1)
                med_dt = masked_median(dt, idx < m - 1)[:, None]
                is_gap = dt > bt * med_dt                # NaN tol: none
                brk = torch.cat([torch.ones_like(valid[:, :1]),
                                 is_gap[:, :-1]], -1)
                brk = brk | ~in_m                        # padding: alone
                lo, hi = _segment_bounds(brk)
                hi = torch.minimum(hi, m)                # end at padding
                seglen = hi - lo
            with span("flatten.savgol"):
                trend_c = savgol_filter_interp(cf, H, lo, hi, static)

            # short-segment median fallback (lightcurve.py:1035-1038)
            with span("flatten.median"):
                short = (w > seglen) | (seglen < bt)
                trend_c = torch.where(short, _medians(
                    cf, brk, lo, hi, in_m, max_segments), trend_c)

            # clip outliers against the trend (lightcurve.py:1049-1056)
            with span("flatten.clip"):
                resid = cf - trend_c
                std = masked_std(resid, in_m)[:, None]
                keep = (torch.abs(resid) < std * sigma + 1e-14) & in_m

                # the kept trend back at original positions (NaN marks the
                # dropped), then interpolated over every time
                merged = torch.where(keep, trend_c, torch.nan)
                trend_orig = torch.empty_like(merged).scatter_(-1, order,
                                                               merged)
                valid_new = torch.isfinite(trend_orig)
                return valid_new, interp_linear_fill(time, valid_new,
                                                     trend_orig)

        for it in range(niters):
            with span("flatten.iter", index=it):
                valid, trend = one_iter(valid)
    return trend.to(flux.dtype), valid


def flatten(time, flux, valid, H, break_tolerance, sigma, niters=3,
            max_segments=16):
    """:func:`flatten_batch` of one (n,) light curve; returns (trend,
    valid_out), each (n,)."""
    trend, valid = flatten_batch(time[None], flux[None], valid[None], H,
                                 break_tolerance, sigma, niters, max_segments)
    return trend[0], valid[0]


class FlattenGraph:
    """:func:`flatten_batch` of one curve on a CUDA device, with every
    segment's own median, captured once as a CUDA graph for a length, its
    dtypes and the settings, then replayed for each curve.

    On one curve the flatten is ~450 small kernels and 6 host reads, and
    the host's launches set its pace; a replay is one launch and no read.
    Inputs are copied into the graph's own tensors; ``H`` is the (w, w)
    projection matrix on the device in the flux's dtype.  Built where the
    capture fails, the instance runs the flatten as it is, uncaptured.
    """

    def __init__(self, time, flux, valid, H, break_tolerance, sigma,
                 niters=3):
        self.args = (H, float(break_tolerance), float(sigma), int(niters))
        self.time, self.flux, self.valid = (x[None].clone()
                                            for x in (time, flux, valid))
        dev = flux.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):   # cuFFT plans and buffers first
            self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = self._run()
        except RuntimeError:
            self.graph = None

    def _run(self):
        return flatten_batch(self.time, self.flux, self.valid, *self.args,
                             max_segments=None, static=True)

    def __call__(self, time, flux, valid):
        """(trend, valid_out), each (n,), of one curve's (n,) tensors."""
        if self.graph is None:
            return flatten(time, flux, valid, *self.args, max_segments=None)
        n, niters = flux.shape[-1], self.args[-1]
        with span("flatten", curves=1, cadences=n, niters=niters,
                  graph=True):
            for mine, x in zip((self.time, self.flux, self.valid),
                               (time, flux, valid)):
                mine[0].copy_(x)
            self.graph.replay()
            return tuple(x[0].clone() for x in self.out)
