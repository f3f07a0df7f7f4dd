"""Shared-time-grid Box Least Squares over a batch of light curves.

Counterpart of the shared-grid half of ``lightkurve_tpu/ops/bls.py``
(``bls_power_shared_batch`` and the scans behind it).  Every curve of the
batch shares one time grid, so the fold of samples into phase bins is the
same for every curve at each trial period.  Two regimes:

* **uniform** -- every curve's weights are constant in time (``dy=None``
  or one ``dy`` per curve).  Box statistics then depend only on counts;
  the fold, prefix sums and window scan run in kernel K-F
  (:mod:`.bls_fused`), and each curve's weight re-enters as a scalar
  rescale (:func:`_uniform_stats_rescale`).
* **weighted** -- per-sample ``dy`` and masked samples (``dy = inf``), as
  real mission data has.  The fold is a one-hot matrix product over
  ``[w | w*y]`` followed by a cumulative sum, both plain torch in full
  float32 (TF32 off); the window scan is kernel K-W (:mod:`.bls_window`).

CUDA tensors take the kernels; CPU tensors take their plain versions.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import numpy_dtype
from .bls_fused import (fold_ids, fused_scan_uniform, max_nbins_bound,
                        nbins_per_period)
from .bls_window import window_scan

__all__ = ["bls_power_shared_batch"]


@contextlib.contextmanager
def _full_f32_matmul(device):
    """Run float32 matrix products in full float32: the fold's one-hot
    product must not round its flux operand to TF32."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _weighted_fold(ts, WWY, pc, d_phase, nbins, max_nbins_p, k_max,
                   wrap=True):
    """Inclusive bin prefix sums (C, npad, 2B) of the circular
    double-deposit fold of ``WWY`` (n, 2B) at periods ``pc`` (C,), and the
    per-period bin counts (C,).  Every sample lands at its fold bin and,
    in wrap mode, again ``nbins_p`` rows later, so windows that cross the
    period edge read their wrapped head from the extension rows.  The rows
    are sized from ``max_nbins_p`` (:func:`.bls_fused.max_nbins_bound`),
    which can exceed ``nbins`` by one."""
    npad = -(-(max(nbins, max_nbins_p) + k_max - 1) // 128) * 128
    rows = torch.arange(npad, device=WWY.device, dtype=torch.int32)
    nbp = nbins_per_period(pc, d_phase)
    ids = fold_ids(ts, pc, d_phase, nbins)                     # (C, n)
    onehot = ids[:, None, :] == rows[None, :, None]            # (C, npad, n)
    if wrap:
        # the astropy edge mode leaves the extension rows empty, so edge
        # windows truncate against zeros
        onehot = onehot | ((ids + nbp[:, None])[:, None, :]
                           == rows[None, :, None])
    with _full_f32_matmul(WWY.device):
        hist = torch.matmul(onehot.to(WWY.dtype), WWY)         # (C, npad, 2B)
    return torch.cumsum(hist, dim=1), nbp


def _bls_shared_scan(ts, W, WY, periods, k_durs, dur_values, d_phase, nbins,
                     max_nbins_p, use_likelihood, chunk, wrap=True):
    """Weighted shared-grid scan.  W, WY (n, B); returns a dict of (B, P)
    tensors (power is the raw window objective; the caller recomputes it
    from log_likelihood or depth_snr)."""
    B = W.shape[1]
    WWY = torch.cat([W, WY], dim=1)                            # (n, 2B)
    total = WWY.sum(0)                                         # (2B,)
    parts = []
    for i in range(0, periods.shape[0], chunk):
        pc = periods[i:i + chunk]
        csum, nbp = _weighted_fold(ts, WWY, pc, d_phase, nbins, max_nbins_p,
                                   max(k_durs), wrap)
        best = window_scan(csum, nbp, pc, total, k_durs, dur_values, d_phase,
                           use_likelihood)
        w_in_b = best.pop("w_in")
        w_out_b = total[:B] - w_in_b
        best["depth_err"] = torch.sqrt(1.0 / w_in_b + 1.0 / w_out_b)
        best["depth_snr"] = best["depth"] / best["depth_err"]
        best["log_likelihood"] = 0.5 * w_in_b * best["depth"] ** 2
        parts.append(best)
    return {f: torch.cat([p[f] for p in parts]).T for f in parts[0]}


def _uniform_stats_rescale(best, n_in_b, c_b, n_total, use_likelihood):
    """Convert the count-based winner stats of a uniform-weights scan to
    weighted statistics via the per-curve scalar weight ``c_b`` (1/dy²;
    0 for all-inf batch-padding rows, which must sort last)."""
    n_out_b = n_total - n_in_b
    err_n = torch.sqrt(1.0 / n_in_b + 1.0 / n_out_b)
    sqrt_c = torch.sqrt(c_b)[None, :]                          # (1, B)
    best["depth_err"] = err_n / sqrt_c
    best["depth_snr"] = best["depth"] / err_n * sqrt_c
    best["log_likelihood"] = (0.5 * n_in_b * best["depth"] ** 2
                              * c_b[None, :])
    best["power"] = (best["log_likelihood"] if use_likelihood
                     else best["depth_snr"])
    # zero-weight rows (all-inf dy batch padding, c_b = 0) must sort LAST
    padded = (c_b == 0.0)[None, :]
    for f in ("power", "depth_snr", "log_likelihood"):
        best[f] = torch.where(padded, -torch.inf, best[f])
    return best


def _bls_shared_scan_uniform(ts, Y0, c_b, periods, k_durs, dur_values,
                             d_phase, nbins, max_nbins_p, use_likelihood,
                             chunk, wrap=True):
    """Uniform-weights shared-grid scan; Y0 (n, B) mean-shifted flux,
    ``c_b`` (B,) per-curve weights.  Returns a dict of (B, P) tensors."""
    out = fused_scan_uniform(ts, Y0, periods, k_durs, dur_values, d_phase,
                             nbins, max_nbins_p, use_likelihood, wrap, chunk)
    n_in_b = out.pop("n_in")
    best = _uniform_stats_rescale(out, n_in_b, c_b, float(Y0.shape[0]),
                                  use_likelihood)
    return {f: v.T for f, v in best.items()}


def _bucket_periods(periods, d_phase, k_max):
    """Group trial periods by required histogram 128-row tile count.

    Returns ``(groups, inv)``: ``groups`` is a list of
    ``(index_array, nbins_bucket)`` and ``inv`` restores the original
    period order after concatenating group outputs."""
    p_np = np.asarray(periods, dtype=np.float64)
    nb_i = np.ceil(p_np / d_phase).astype(np.int64)
    tiles = np.maximum((nb_i + k_max - 1 + 127) // 128, 1)
    nb_bucket = tiles * 128 - (k_max - 1)
    order = np.argsort(tiles, kind="stable")
    inv = np.argsort(order)
    groups = []
    lo = 0
    while lo < len(order):
        hi = lo + 1
        while hi < len(order) and tiles[order[hi]] == tiles[order[lo]]:
            hi += 1
        idx = order[lo:hi]
        groups.append((idx, int(nb_bucket[idx[0]])))
        lo = hi
    return groups, inv


def _detect_uniform_weights(dy):
    """True iff every curve's weights are constant along time (host check).

    Only inspects ``None`` or host (numpy) arrays; callers that know their
    weights are row-constant (the sweep runner) pass
    ``uniform_weights=True``.  Rows of all-``inf`` (batch padding) are
    allowed: they get weight 0.
    """
    if dy is None:
        return True
    if not isinstance(dy, np.ndarray) or dy.ndim != 2:
        return False
    if not np.all(dy == dy[:, :1]):
        return False
    col = dy[:, 0]
    return bool(np.all((col > 0) & (np.isfinite(col) | np.isinf(col))))


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def bls_power_shared_batch(t, Y, dy, periods, durations, oversample=10,
                           objective="likelihood", chunk=16, nbins=None,
                           d_phase=None, bucket=False, edge_mode="wrap",
                           uniform_weights=None):
    """Batched BLS for curves sharing ONE time grid.

    Parameters
    ----------
    t : (n,) shared times (tensor or array).
    Y : (B, n) fluxes; its device and dtype set those of the computation.
    dy : (B, n) uncertainties, None, or inf-masked padding.
    periods : (P,) trial periods; durations : (D,) box durations.
    uniform_weights : None (auto-detect on host arrays), True (caller
        asserts per-curve-constant ``dy``), or False (force the weighted
        scan).
    bucket : group trial periods by required histogram size (128-row
        tiles) so short periods don't pay for the longest period's bins.
    edge_mode : 'wrap' (circular windows across the period edge) or
        'astropy' (edge windows truncate against empty padding bins).

    Returns a dict of (B, P) tensors: power, depth, depth_err, depth_snr,
    log_likelihood, duration, transit_time, period.

    The duration grid is quantized to ``min(duration)/oversample`` phase
    bins; reported durations are the given values.  Weights are
    normalized to mean 1 for float32 accuracy, and the normalization is
    undone on the outputs.
    """
    if uniform_weights is None:
        uniform_weights = _detect_uniform_weights(dy)
    if not isinstance(Y, torch.Tensor):
        Y = torch.as_tensor(np.asarray(Y))
    device, dtype = Y.device, Y.dtype
    t = _as_tensor(t, device)
    # the grid geometry is read on the host: keep a host copy of the
    # periods in the data dtype, and ship host periods without a blocking
    # copy (the sweep runner dispatches its next chunk before it waits)
    np_dtype = numpy_dtype(dtype)
    if isinstance(periods, torch.Tensor):
        periods = periods.to(device=device, dtype=dtype)
        p_host = periods.cpu().numpy()
    else:
        p_host = np.ascontiguousarray(periods, dtype=np_dtype)
        periods = torch.from_numpy(p_host)
        if device.type == "cuda":
            periods = periods.pin_memory().to(device, non_blocking=True)
    durations_np = np.asarray(
        durations.cpu() if isinstance(durations, torch.Tensor) else durations,
        dtype=np.float64)
    use_likelihood = objective == "likelihood"
    wrap = edge_mode != "astropy"
    B = Y.shape[0]
    if not uniform_weights:
        if dy is None:
            W = torch.ones_like(Y)
        else:
            W = 1.0 / torch.square(_as_tensor(dy, device, dtype))
        finite = torch.isfinite(W)
        w_scale = torch.where(finite, W, 0.0).mean()
        Wn = torch.where(finite, W / w_scale, 0.0)
        # mean-shift the flux: depth is shift-invariant, and the fold then
        # sums w·(y−μ) relative to the transit signal, not the continuum
        mu = ((Wn * Y).sum(1) / torch.clamp(Wn.sum(1), min=1e-30))[:, None]
    else:
        if dy is None:
            c_b = torch.ones((B,), dtype=dtype, device=device)
        else:
            dy0 = _as_tensor(dy, device, dtype)[:, 0]
            c_b = torch.where(torch.isfinite(dy0), 1.0 / torch.square(dy0),
                              0.0)
        mu = Y.mean(1, keepdim=True)
    t_min = t.min()
    ts = (t - t_min).to(dtype)

    if d_phase is None:
        d_phase = float(durations_np.min()) / oversample
    if nbins is None:
        nbins = int(np.ceil(float(np.max(p_host)) / d_phase))
    # round-half-UP (+0.5 truncation), never Python round()'s banker's
    # rounding of half-bin ties
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in durations_np)
    dvals = tuple(float(d) for d in durations_np)
    k_max = max(k_durs)

    if uniform_weights:
        Y0 = (Y - mu).T.contiguous()
        scan, cols = _bls_shared_scan_uniform, (Y0, c_b)
    else:
        scan, cols = _bls_shared_scan, (Wn.T.contiguous(),
                                        (Wn * (Y - mu)).T.contiguous())

    def run(p_sub, p_sub_host, nb):
        # the host copy bounds the bins per period without a device read
        max_nbp = max_nbins_bound(p_sub_host, d_phase, dtype)
        return scan(ts, *cols, p_sub, k_durs, dvals, float(d_phase), int(nb),
                    max_nbp, use_likelihood, chunk, wrap=wrap)

    if bucket:
        groups, order = _bucket_periods(p_host, d_phase, k_max)
        outs = [run(periods[torch.as_tensor(idx, device=device)],
                    p_host[idx], nb) for idx, nb in groups]
        order_t = torch.as_tensor(order, device=device)
        out = {f: torch.cat([o[f] for o in outs], dim=1)[:, order_t]
               for f in outs[0]}
    else:
        out = run(periods, p_host, nbins)

    if not uniform_weights:
        # undo the weight normalization w → w/s
        s = w_scale
        out["depth_err"] = out["depth_err"] / torch.sqrt(s)
        out["depth_snr"] = out["depth_snr"] * torch.sqrt(s)
        out["log_likelihood"] = out["log_likelihood"] * s
        out["power"] = (out["log_likelihood"] if use_likelihood
                        else out["depth_snr"])
    out["transit_time"] = out["transit_time"] + t_min
    out["period"] = periods[None, :].expand(B, periods.shape[0])
    return out
