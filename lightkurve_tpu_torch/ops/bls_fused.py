"""Fused uniform-weight BLS scan (kernel K-F) and its plain version.

Counterpart of ``lightkurve_tpu/ops/bls_fused_pallas.py``
(``bls_fused_scan_uniform``).  For curves whose weights are constant in
time the box depth depends only on counts::

    depth = tot_y / n_out - y_in * (1/n_in + 1/n_out)

so one shared count column replaces per-curve weights.  For each trial
period the scan folds the shared time grid into bins
``ids = clip(trunc(fmod(ts, P) * (1/d_phase)), 0, nbins - 1)``, builds the
inclusive prefix sums of the mean-shifted flux with the circular wrap
extension (every sample deposited at ``ids`` and, in wrap mode, again at
``ids + nbins_p``), then runs the duration-window scan.  The result holds
COUNT-based winner statistics; ``ops.bls._uniform_stats_rescale`` turns
them into weighted statistics.

:func:`fused_scan_uniform` launches the CUDA kernel (``csrc/bls_fused.cu``)
for CUDA tensors and runs :func:`fused_scan_uniform_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import numpy_dtype
from .bls_window import (_check_cuda, _undersized, durations_args,
                         transit_time)

__all__ = ["fused_scan_uniform", "fused_scan_uniform_plain", "fold_ids",
           "nbins_per_period", "max_nbins_bound", "inv_d_phase"]

_FIELDS = ("power", "depth", "n_in", "transit_time", "duration")


def inv_d_phase(d_phase, dtype):
    """1/d_phase rounded in ``dtype``.  Bin positions are ``x * (1/d_phase)``,
    not ``x / d_phase``: the reference's compiler folds its division by the
    constant bin width into this product, and the two differ by one ulp,
    enough to move a sample that sits on a bin edge."""
    np_dtype = numpy_dtype(dtype)
    return float(np_dtype.type(1) / np_dtype.type(d_phase))


def fold_ids(ts, pc, d_phase, nbins):
    """Fold bins (C, n): exact fmod (never t - floor(t/P)·P, which is off
    by one ulp on bin edges), times the dtype-rounded 1/d_phase, truncating
    int cast, clip to ``nbins - 1``."""
    inv = torch.tensor(inv_d_phase(d_phase, ts.dtype), dtype=ts.dtype,
                       device=ts.device)
    phase = torch.fmod(ts[None, :], pc[:, None])
    return torch.clamp((phase * inv).to(torch.int32), 0, nbins - 1)


def nbins_per_period(pc, d_phase):
    """ceil(pc · (1/d_phase)) in the dtype of ``pc``, as int32."""
    inv = torch.tensor(inv_d_phase(d_phase, pc.dtype), dtype=pc.dtype,
                       device=pc.device)
    return torch.ceil(pc * inv).to(torch.int32)


def max_nbins_bound(p_host, d_phase, dtype):
    """The largest :func:`nbins_per_period` of the host periods ``p_host``,
    computed on the host by the device's rule (periods and 1/d_phase
    rounded in ``dtype``), so it bounds the kernel's rows without a device
    read.  It can exceed ``ceil(max(p_host) / d_phase)`` by one."""
    np_dtype = numpy_dtype(dtype)
    inv = np_dtype.type(inv_d_phase(d_phase, dtype))
    return int(np.ceil(np.max(np.asarray(p_host, dtype=np_dtype)) * inv))


def _chunk_uniform(ts, Y0, tot_y, pc, k_durs, dur_values, d_phase, nbins,
                   max_nbins_p, use_likelihood, wrap):
    n, B = Y0.shape
    dtype = Y0.dtype
    k_max = max(k_durs)
    npad = -(-(max(nbins, max_nbins_p) + k_max - 1) // 128) * 128
    n_total = float(n)
    rows = torch.arange(npad, device=Y0.device, dtype=torch.int32)
    nbp = nbins_per_period(pc, d_phase)                        # (C,)
    ids = fold_ids(ts, pc, d_phase, nbins)                     # (C, n)
    ids2 = ids + nbp[:, None]                                  # wrap copy
    onehot = ids[:, None, :] == rows[None, :, None]            # (C, npad, n)
    if wrap:
        onehot = onehot | (ids2[:, None, :] == rows[None, :, None])
    cs_y = torch.cumsum(torch.matmul(onehot.to(dtype), Y0), dim=1)
    # count prefix directly: sum_i [ids_i <= r] (+ the wrap copy's); exact
    cs_n = (ids[:, None, :] <= rows[None, :, None]).sum(-1, dtype=dtype)
    if wrap:
        cs_n = cs_n + (ids2[:, None, :] <= rows[None, :, None]).sum(
            -1, dtype=dtype)
    cs_n = cs_n[..., None]                                     # (C, npad, 1)
    C = pc.shape[0]
    zeros_y = torch.zeros((C, 1, B), dtype=dtype, device=Y0.device)
    zeros_n = torch.zeros((C, 1, 1), dtype=dtype, device=Y0.device)
    zp_y = torch.cat([zeros_y, cs_y, zeros_y.expand(C, k_max - 1, B)], 1)
    zp_n = torch.cat([zeros_n, cs_n, zeros_n.expand(C, k_max - 1, 1)], 1)
    cex_y, cex_n = zp_y[:, :npad], zp_n[:, :npad]
    valid_rows = rows[None, :] < nbp[:, None]                  # (C, npad)
    best_v = best_arg = best_j = None
    for j, k in enumerate(k_durs):
        n_in = zp_n[:, k:k + npad] - cex_n
        y_in = zp_y[:, k:k + npad] - cex_y
        n_out = n_total - n_in
        valid = (valid_rows & (k <= nbp)[:, None])[..., None]
        okn = valid & (n_in > 0) & (n_out > 0)
        inv_in = 1.0 / torch.where(okn, n_in, 1.0)
        inv_out = 1.0 / torch.where(okn, n_out, 1.0)
        s = inv_in + inv_out
        depth = tot_y * inv_out - y_in * s                     # (C, npad, B)
        if use_likelihood:
            obj = (0.5 * torch.where(okn, n_in, 1.0)) * depth * depth
        else:
            obj = depth * torch.rsqrt(s)
        obj = torch.where(okn, obj, -torch.inf)
        v, arg = torch.max(obj, dim=1)                         # first max
        if best_v is None:
            best_v, best_arg = v, arg
            best_j = torch.zeros_like(arg)
        else:
            upd = v > best_v
            best_v = torch.where(upd, v, best_v)
            best_arg = torch.where(upd, arg, best_arg)
            best_j = torch.where(upd, j, best_j)
    # winner reconstruction from the prefix sums; when no window was valid
    # the statistics fall back to n_in = n_out = 1 at bin 0
    ks = torch.tensor(k_durs, dtype=torch.int64, device=Y0.device)
    dvs = torch.tensor(dur_values, dtype=dtype, device=Y0.device)
    kbest = ks[best_j]
    hi = (best_arg + kbest - 1)[:, None, :]
    lo = (best_arg - 1).clamp(min=0)[:, None, :]
    has_lo = (best_arg > 0)
    y_in_b = (torch.gather(cs_y, 1, hi)[:, 0]
              - torch.where(has_lo, torch.gather(cs_y, 1, lo)[:, 0], 0.0))
    cn = cs_n[..., 0]
    n_in_w = (torch.gather(cn, 1, hi[:, 0])
              - torch.where(has_lo, torch.gather(cn, 1, lo[:, 0]), 0.0))
    ok_w = torch.isfinite(best_v)
    n_in_b = torch.where(ok_w, n_in_w, 1.0)
    inv_out_w = 1.0 / torch.where(ok_w, n_total - n_in_w, 1.0)
    s_w = 1.0 / n_in_b + inv_out_w
    depth_b = tot_y * inv_out_w - y_in_b * s_w
    t0 = transit_time(best_arg, kbest, d_phase, pc[:, None])
    return _undersized(dict(power=best_v, depth=depth_b, n_in=n_in_b,
                            transit_time=t0, duration=dvs[best_j]),
                       nbp > max_nbins_p)


def fused_scan_uniform_plain(ts, Y0, periods, k_durs, dur_values, d_phase,
                             nbins, max_nbins_p, use_likelihood=True,
                             wrap=True, chunk=16):
    """Plain torch uniform scan: the staged form of
    ``_bls_shared_scan_uniform`` (one-hot matmul fold, cumsum, shifted
    windows), ``chunk`` periods at a time.

    ts (n,), Y0 (n, B) mean-shifted flux, periods (P,).  ``max_nbins_p``
    bounds ``nbins_per_period(periods)`` (:func:`max_nbins_bound`); a
    period above it gets NaN statistics, as the kernel gives.  Returns a
    dict of (P, B) tensors: power, depth, n_in, transit_time, duration
    (count-based statistics)."""
    fused_scan_uniform_plain.calls += 1
    tot_y = Y0.sum(0)
    parts = [_chunk_uniform(ts, Y0, tot_y, periods[i:i + chunk], k_durs,
                            dur_values, d_phase, nbins, int(max_nbins_p),
                            use_likelihood, wrap)
             for i in range(0, periods.shape[0], chunk)]
    return {f: torch.cat([p[f] for p in parts]) for f in _FIELDS}


fused_scan_uniform_plain.calls = 0


def fused_scan_uniform(ts, Y0, periods, k_durs, dur_values, d_phase, nbins,
                       max_nbins_p, use_likelihood=True, wrap=True, chunk=16):
    """Fused uniform scan: kernel K-F on CUDA tensors (all periods in one
    launch; ``chunk`` is not used there), the plain version on CPU
    tensors.  Same arguments and result as
    :func:`fused_scan_uniform_plain`; ``max_nbins_p`` sizes the kernel's
    shared memory."""
    if Y0.device.type == "cpu":
        return fused_scan_uniform_plain(ts, Y0, periods, k_durs, dur_values,
                                        d_phase, nbins, max_nbins_p,
                                        use_likelihood, wrap, chunk)
    from ._build import check_status, cuda_library
    dtype = Y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Y0 must be float32 or float64 (got {dtype})")
    n, B = Y0.shape
    P = periods.shape[0]
    _check_cuda("Y0", Y0, dtype)
    _check_cuda("ts", ts, dtype, (n,))
    _check_cuda("periods", periods, dtype, (P,))
    k_arr, v_arr = durations_args(k_durs, dur_values)
    k_max = int(k_arr.max())
    tot_y = Y0.sum(0)
    nbp = nbins_per_period(periods, d_phase)
    # shared-memory rows per block: a period reads nbins_p + k_max - 1 rows
    rows_cap = int(max_nbins_p) + k_max - 1
    outs = [torch.empty((P, B), dtype=dtype, device=Y0.device)
            for _ in _FIELDS]
    lib = cuda_library()
    fn = (lib.lk_bls_fused_uniform_f32 if dtype == torch.float32
          else lib.lk_bls_fused_uniform_f64)
    with torch.cuda.device(Y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(ts.data_ptr(), Y0.data_ptr(), tot_y.data_ptr(),
                  periods.data_ptr(), nbp.data_ptr(), n, B, P, int(nbins),
                  k_max, rows_cap, k_arr.ctypes.data_as(ctypes.c_void_p),
                  v_arr.ctypes.data_as(ctypes.c_void_p), len(k_arr),
                  float(d_phase), inv_d_phase(d_phase, dtype),
                  int(bool(use_likelihood)), int(bool(wrap)),
                  *[o.data_ptr() for o in outs], stream)
    check_status(lib, code, "bls_fused_uniform")
    fused_scan_uniform.launches += 1
    return dict(zip(_FIELDS, outs))


fused_scan_uniform.launches = 0
