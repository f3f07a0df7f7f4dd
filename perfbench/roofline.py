"""The least time a shared-grid BLS search can take on the card.

A frozen copy of the arithmetic of ``lightkurve_tpu_torch/roofline.py``
(its peaks and its per-window operation counts), counted here from the
inputs the benchmark hands to a search -- the curves, their valid
cadences, the weights regime, the trial periods, the durations and the
oversampling -- and never from a kernel's launch plan, so that the count
is the same whichever route or kernel does the work.

Per trial period the algorithm must fold every valid sample into each
curve's columns (two columns a curve, the weights and the weighted
fluxes, in the weighted regime; one column a curve and one count column
shared by all curves in the uniform regime), form every prefix row
(the period's bins and the wrap rows of the longest window), and scan
every window: each start bin of each duration that fits the period.  It
reads each input once and writes each output once.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PEAKS", "search_counts", "least_seconds"]

#: NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, at its 700-W limit: float32
#: operations/s outside the tensor cores and device-memory bytes/s
PEAKS = {"f32": 67e12, "hbm": 3.35e12}
#: operations per window and curve of a weighted scan: two prefix
#: differences, w_out, the two reciprocals and their sum, depth (two
#: products, one difference), the objective (two products) and the
#: running-maximum compare
OPS_WEIGHTED = 12
#: a uniform scan shares the counts between curves: per window and curve
#: the flux prefix difference, depth, the objective and the compare ...
OPS_UNIFORM_CURVE = 7
#: ... and once per window for all curves n_in, n_out, the reciprocals,
#: their sum and 0.5 * n_in
OPS_UNIFORM_WINDOW = 6
#: the winners a search returns per curve: period, power, depth,
#: depth_err, depth_snr, log_likelihood, duration, transit_time (float64)
WINNER_FIELDS = 8


def _geometry(periods, durations, oversample):
    durations = np.asarray(durations, np.float64)
    d_phase = float(durations.min()) / oversample
    k = np.array([max(int(d / d_phase + 0.5), 1) for d in durations])
    nbp = np.ceil(np.asarray(periods, np.float64) / d_phase).astype(np.int64)
    return nbp, k


def search_counts(valid_samples, curves, cadences, periods, durations,
                  oversample=10, weighted=True, itemsize=4):
    """(bytes, operations) of one search over ``periods``.

    valid_samples : the valid cadences summed over all curves.
    curves, cadences : the stack's shape as handed over (B, n).
    weighted : per-cadence weights (the flattened stacks) or one weight
        per curve with every cadence valid (the uniform regime)."""
    nbp, k = _geometry(periods, durations, oversample)
    k_max = int(k.max())
    P = nbp.size
    windows = int(sum(int((k <= p).sum()) * int(p) for p in nbp))
    rows = int(np.sum(nbp + k_max - 1))
    if weighted:
        fold = 2 * (valid_samples * P + curves * rows)
        scan = curves * OPS_WEIGHTED * windows
        # flux and flux_err, the shared time row, the boolean mask
        inputs = (2 * curves * cadences + cadences) * itemsize + \
            curves * cadences
    else:
        fold = (valid_samples + cadences) * P + (curves + 1) * rows
        scan = (curves * OPS_UNIFORM_CURVE + OPS_UNIFORM_WINDOW) * windows
        inputs = (curves * cadences + cadences + curves) * itemsize
    outputs = WINNER_FIELDS * curves * 8
    nbytes = inputs + outputs + P * 8 + len(k) * 8
    return float(nbytes), float(fold + scan)


def least_seconds(nbytes, ops):
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate, with which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAKS["hbm"], ops / PEAKS["f32"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
