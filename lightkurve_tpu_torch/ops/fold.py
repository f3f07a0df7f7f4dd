"""Phase folding and transit masks over tensors.

Counterpart of ``lightkurve_tpu/ops/fold.py``: the tensor forms of the
reference's ``LightCurve.fold`` (``lightcurve.py:1089-1214``, astropy
``TimeSeries.fold``) and ``create_transit_mask`` (``lightcurve.py:3035``).
``LightCurve.fold`` and ``create_transit_mask`` themselves stay host numpy,
as in ``lightkurve_tpu``; these serve batched callers.
"""
from __future__ import annotations

import torch

from .bls import _mod

__all__ = ["fold_phase", "transit_mask", "bin_folded"]


def _like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def fold_phase(time, period, epoch_time=None, epoch_phase=0.0,
               wrap_phase=None, normalize_phase=False):
    """Phase of each time w.r.t. (period, epoch).

    phase = ((t - epoch_time + epoch_phase) mod P), wrapped so that values
    >= ``wrap_phase`` are reduced by one period (astropy ``fold`` semantics;
    default wrap at P/2 giving [-P/2, P/2)).  With ``normalize_phase`` the
    result is divided by P (and ``epoch_phase``/``wrap_phase`` are given in
    units of phase).
    """
    if epoch_time is None:
        epoch_time = time.reshape(-1)[0]
    period = _like(period, time)
    if normalize_phase:
        eph = _like(epoch_phase, time) * period
        wrap = period * (0.5 if wrap_phase is None
                         else _like(wrap_phase, time))
    else:
        eph = _like(epoch_phase, time)
        wrap = period * 0.5 if wrap_phase is None else _like(wrap_phase,
                                                             time)
    phase = _mod(time - epoch_time + eph, period)
    phase = torch.where(phase >= wrap, phase - period, phase)
    if normalize_phase:
        phase = phase / period
    return phase


def transit_mask(time, period, transit_time, duration):
    """Boolean in-transit mask of (n,) times; arrays of planets broadcast.

    Kernel (reference ``lightcurve.py:3035``):
    ``abs((t - t0 + 0.5 P) % P - 0.5 P) < 0.5 * duration``.
    """
    period = torch.atleast_1d(_like(period, time))[..., None]
    t0 = torch.atleast_1d(_like(transit_time, time))[..., None]
    dur = torch.atleast_1d(_like(duration, time))[..., None]
    hp = 0.5 * period
    m = torch.abs(_mod(time[None, :] - t0 + hp, period) - hp) < 0.5 * dur
    return torch.any(m, dim=0)


def bin_folded(phase, values, mask, n_bins, phase_min, phase_max):
    """Equal-width phase binning; returns (mids, mean, rmse, std, count)."""
    from .binning import bin_aggregate, bin_ids
    width = (phase_max - phase_min) / n_bins
    ids, in_range = bin_ids(phase, phase_min, width, n_bins)
    mean, rmse, std, cnt = bin_aggregate(values, mask & in_range, ids, n_bins)
    mids = phase_min + (torch.arange(n_bins, dtype=phase.dtype,
                                     device=phase.device) + 0.5) * width
    return mids, mean, rmse, std, cnt
