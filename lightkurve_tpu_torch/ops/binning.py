"""Segmented-reduction time binning over tensors.

Counterpart of ``lightkurve_tpu/ops/binning.py``: the per-bin mean,
root-mean-square and population standard deviation of astropy's
``aggregate_downsample`` and the reference's ``rmse_reduceat`` /
``nanstd_reduceat`` (``lightcurve.py:175-251``), as ``index_add_``
segment sums (``jax.ops.segment_sum`` in the reference).  Bins with no
valid sample give NaN.  ``LightCurve.bin`` itself stays host numpy, as in
``lightkurve_tpu``.
"""
from __future__ import annotations

import torch

__all__ = ["bin_time", "bin_aggregate", "bin_ids"]


def _segsum(values, seg_ids, n_bins):
    out = torch.zeros(n_bins, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids, values)


def bin_ids(x, start, width, n_bins):
    """Each sample's bin ``floor((x - start) / width)``, clipped into
    [0, n_bins), and whether it fell inside before the clip."""
    ids = torch.floor((x - start) / width).to(torch.int64)
    in_range = (ids >= 0) & (ids < n_bins)
    return torch.clamp(ids, 0, n_bins - 1), in_range


def bin_aggregate(values, mask, seg_ids, n_bins):
    """Per-bin nanmean / rmse / nanstd of ``values`` grouped by ``seg_ids``.

    values : (n,) samples; mask : (n,) bool, True = valid (NaNs must
    already be excluded); seg_ids : (n,) integer bin per sample, out-of-range
    ids clipped by the caller with ``mask`` False; n_bins : int.

    Returns mean, rmse, std, count: (n_bins,) tensors (NaN where
    count == 0).
    """
    seg_ids = seg_ids.to(torch.int64)
    v = torch.where(mask, values, 0.0)
    cnt = _segsum(mask.to(v.dtype), seg_ids, n_bins)
    s1 = _segsum(v, seg_ids, n_bins)
    s2 = _segsum(v * v, seg_ids, n_bins)
    safe = torch.clamp(cnt, min=1.0)
    mean = s1 / safe
    rmse = torch.sqrt(s2 / safe)
    # two-pass population std (no cancellation; as nanstd_reduceat)
    d = torch.where(mask, values - mean[seg_ids], 0.0)
    std = torch.sqrt(_segsum(d * d, seg_ids, n_bins) / safe)
    empty = cnt == 0
    return (torch.where(empty, torch.nan, mean),
            torch.where(empty, torch.nan, rmse),
            torch.where(empty, torch.nan, std), cnt)


def bin_time(time, values, mask, start, bin_size, n_bins):
    """Equal-width time binning: returns (bin_mid_times, mean, rmse, std,
    count).  Samples before ``start`` or past the last bin are dropped, as
    ``aggregate_downsample``'s windowing does."""
    ids, in_range = bin_ids(time, start, bin_size, n_bins)
    mean, rmse, std, cnt = bin_aggregate(values, mask & in_range, ids, n_bins)
    mids = start + (torch.arange(n_bins, dtype=time.dtype,
                                 device=time.device) + 0.5) * bin_size
    return mids, mean, rmse, std, cnt
