"""Mask-aware reductions over the last axis.

Counterpart of ``lightkurve_tpu/ops/masked.py``.  Stacks carry a boolean
validity mask beside fixed-shape tensors in place of NaN semantics; each
function reduces over the LAST axis and broadcasts over leading batch
axes.  The formulas are the reference's, term for term, so float64
results agree to rounding.
"""
from __future__ import annotations

import torch

__all__ = [
    "nan_to_mask", "masked_sum", "masked_mean", "masked_var", "masked_std",
    "masked_median", "masked_quantile", "masked_median_grouped",
    "segment_medians",
]


def nan_to_mask(x, mask=None):
    """Return (x with invalid entries zeroed, validity mask), combining
    non-finite entries and ``mask``."""
    finite = torch.isfinite(x)
    if mask is not None:
        finite = finite & mask
    return torch.where(finite, x, 0.0), finite


def masked_sum(x, mask, axis=-1):
    return torch.where(mask, x, 0.0).sum(axis)


def _count(mask, axis, dtype):
    return mask.sum(axis).to(dtype)


def masked_mean(x, mask, axis=-1):
    """Mean over valid entries; NaN where a row has none."""
    n = _count(mask, axis, x.dtype)
    s = masked_sum(x, mask, axis)
    return torch.where(n > 0, s / torch.clamp(n, min=1), torch.nan)


def masked_var(x, mask, axis=-1, ddof=0):
    """Variance over valid entries (``np.nanvar`` semantics)."""
    n = _count(mask, axis, x.dtype)
    mu = masked_mean(x, mask, axis)
    d = torch.where(mask, x - mu.unsqueeze(axis), 0.0)
    ss = (d * d).sum(axis)
    denom = n - ddof
    return torch.where(denom > 0, ss / torch.clamp(denom, min=1), torch.nan)


def masked_std(x, mask, axis=-1, ddof=0):
    return torch.sqrt(masked_var(x, mask, axis, ddof))


def masked_quantile(x, mask, q, axis=-1):
    """Quantile ``q`` over valid entries with numpy's linear interpolation:
    a sort with invalid entries pushed to +inf, then the value at the
    fractional rank.  NaN where a row has no valid entry."""
    if axis != -1:
        x, mask = x.movedim(axis, -1), mask.movedim(axis, -1)
    xs = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    n = mask.sum(-1)
    pos = q * (n.to(xs.dtype) - 1.0)
    last = xs.shape[-1] - 1
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = pos - lo.to(xs.dtype)
    v_lo = torch.gather(xs, -1, lo[..., None])[..., 0]
    v_hi = torch.gather(xs, -1, hi[..., None])[..., 0]
    # at integer ranks the hi sample may sit in the +inf padding and
    # 0 * inf is NaN: select rather than rely on frac vanishing
    out = torch.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
    return torch.where(n > 0, out, torch.nan)


def masked_median(x, mask, axis=-1):
    """Median over valid entries (``np.nanmedian``)."""
    return masked_quantile(x, mask, 0.5, axis=axis)


def masked_median_grouped(x, group_id, n_groups, valid=None):
    """Per-group medians over the last axis: ``[masked_median(x, (group_id
    == g) & valid) for g in range(n_groups)]``, from one sort keyed on
    (group, value) and a gather at each group's two middle ranks.  Empty
    groups give 0.0, as the reference's do.

    x : (..., n) values; group_id : (..., n) integer group of each sample,
    in [0, n_groups); valid : optional (..., n) bool, invalid samples
    belong to no group.  Returns (..., n_groups) medians.
    """
    n = x.shape[-1]
    gid = group_id.to(torch.int64)
    if valid is not None:
        gid = torch.where(valid, gid, n_groups)        # park invalids last
    # by value, then stably by group: each group's values ascending
    by_value = torch.sort(x, dim=-1, stable=True)
    gid_v = torch.gather(gid, -1, by_value.indices)
    by_group = torch.sort(gid_v, dim=-1, stable=True)
    vs = torch.gather(by_value.values, -1, by_group.indices)
    counts = torch.zeros(x.shape[:-1] + (n_groups + 1,), dtype=torch.int64,
                         device=x.device)
    counts.scatter_add_(-1, gid, torch.ones_like(gid))
    ng_i = counts[..., :n_groups]
    start = torch.cumsum(ng_i, -1) - ng_i               # first rank of g
    ng = ng_i.to(x.dtype)
    pos = 0.5 * (ng - 1.0)
    lo = torch.clamp(torch.floor(pos), 0, n - 1)
    hi = torch.minimum(lo + 1, torch.clamp(ng - 1, min=0))

    def at(rank):
        idx = torch.clamp(start + rank.to(torch.int64), 0, n - 1)
        return torch.gather(vs, -1, idx)

    v_lo, v_hi = at(lo), at(hi)
    med = v_lo + (pos - lo) * (v_hi - v_lo)
    return torch.where(ng > 0, med, 0.0)


def segment_medians(x, lo, hi):
    """Each sample's median over its own segment, for segments that are
    contiguous runs along the last axis: sample i belongs to ``[lo[i],
    hi[i])``, as :func:`~lightkurve_tpu_torch.ops.detrend._segment_bounds`
    gives them.  Any number of segments.  The sort needs only ``lo``: a
    sample whose ``hi`` is at most its ``lo`` (a row's padding) is a
    segment of its own and gets its own value.

    Sorted by value, then stably by segment start, each segment's values
    land ascending at the segment's own positions, so its two middle
    ranks are gathers at ``lo + (hi - lo - 1) // 2`` and the next: no
    count per segment and no read on the host.  The arithmetic is
    :func:`masked_median_grouped`'s, so the medians agree bit for bit.

    x, lo, hi : (..., n).  Returns (..., n) medians.
    """
    n = x.shape[-1]
    by_value = torch.sort(x, dim=-1, stable=True)
    lo_v = torch.gather(lo, -1, by_value.indices)
    by_seg = torch.sort(lo_v, dim=-1, stable=True)
    vs = torch.gather(by_value.values, -1, by_seg.indices)
    ng = (hi - lo).to(x.dtype)
    pos = 0.5 * (ng - 1.0)
    r_lo = torch.clamp(torch.floor(pos), 0, n - 1)
    r_hi = torch.minimum(r_lo + 1, torch.clamp(ng - 1, min=0))

    def at(rank):
        return torch.gather(vs, -1, torch.clamp(lo + rank.to(torch.int64),
                                                0, n - 1))

    v_lo, v_hi = at(r_lo), at(r_hi)
    return v_lo + (pos - r_lo) * (v_hi - v_lo)
