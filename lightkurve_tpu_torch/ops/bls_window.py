"""BLS duration-window scans over bin prefix sums: kernels K-W (weighted)
and K-U (uniform weights) and their plain versions.

Counterpart of ``lightkurve_tpu/ops/bls_window_pallas.py``
(``window_scan_pallas`` and ``window_scan_pallas_uniform``).

**K-W** takes the inclusive bin prefix sums of ``[sum w | sum w*y]`` of
the circular double-deposit fold and, for every (trial period, curve),
tries every start bin ``r < nbins_p`` and every duration
``k <= nbins_p``::

    w_in  = csum[r + k - 1] - csum[r - 1]      (w_out = total - w_in)
    depth = wy_out / w_out - wy_in / w_in
    objective = 0.5 * w_in * depth**2          (likelihood)
                or depth / sqrt(1/w_in + 1/w_out)  (snr)

A window is valid when ``w_in > 0`` and ``w_out > 0``; invalid windows
are -inf.  Over ``r`` the first maximum wins; over ``k`` a later duration
wins only if it is strictly greater.

**K-U** is the same search for curves whose weights are constant in time:
the prefix sums of the mean-shifted flux ``cs_y`` (C, npad, B) and ONE
count prefix ``cs_n`` (C, npad) shared by every curve, so the depth is
``tot_y / n_out - y_in * (1/n_in + 1/n_out)`` and the statistics are
count-based (``ops.bls._uniform_stats_rescale`` applies the weights).

In both, a period whose windows would reach past the ``npad`` rows of the
prefix sums (a fold sized for fewer bins than ``nbins_p``) gets NaN
statistics.  :func:`window_scan` and :func:`window_scan_uniform` launch
the CUDA kernels (``csrc/bls_window.cu``, ``csrc/bls_window_uniform.cu``)
for CUDA tensors and run :func:`window_scan_plain` and
:func:`window_scan_uniform_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["window_scan", "window_scan_plain", "window_scan_uniform",
           "window_scan_uniform_plain", "transit_time"]

_FIELDS = ("power", "depth", "w_in", "transit_time", "duration")
_UNIFORM_FIELDS = ("power", "depth", "n_in", "transit_time", "duration")


def transit_time(arg, k, d_phase, pc):
    """t0 = (arg + k/2)·d_phase folded into [0, pc) by the floor form, in
    the dtype of ``pc`` (``arg``/``k`` integer tensors, ``pc`` (C, 1))."""
    t0 = (arg.to(pc.dtype) + 0.5 * k.to(pc.dtype)) * d_phase
    return t0 - torch.floor(t0 / pc) * pc


def window_scan_plain(csum, nbins_p, pc, total, k_durs, dur_values, d_phase,
                      use_likelihood=True):
    """Plain torch window scan: the staged form of ``_bls_shared_scan``.

    csum (C, npad, 2B), nbins_p (C,) int, pc (C,), total (2B,).  Returns a
    dict of (C, B) tensors: power, depth, w_in, transit_time, duration.
    """
    window_scan_plain.calls += 1
    C, npad, twoB = csum.shape
    B = twoB // 2
    dtype = csum.dtype
    rows = torch.arange(npad, device=csum.device)
    c_ex = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    tw, twy = total[:B], total[B:]
    pcol = pc.to(dtype)[:, None]
    best = None
    for k, dur_val in zip(k_durs, dur_values):
        in_sums = torch.roll(csum, -(k - 1), dims=1) - c_ex
        w_in, wy_in = in_sums[..., :B], in_sums[..., B:]
        w_out, wy_out = tw - w_in, twy - wy_in
        valid = ((rows[None, :] < nbins_p[:, None])
                 & (k <= nbins_p)[:, None])[..., None]
        ok = valid & (w_in > 0) & (w_out > 0)
        w_in_s = torch.where(ok, w_in, 1.0)
        w_out_s = torch.where(ok, w_out, 1.0)
        depth = wy_out / w_out_s - wy_in / w_in_s
        if use_likelihood:
            obj = 0.5 * w_in_s * depth * depth
        else:
            obj = depth * torch.rsqrt(1.0 / w_in_s + 1.0 / w_out_s)
        obj = torch.where(ok, obj, -torch.inf)
        v, arg = torch.max(obj, dim=1)          # first maximum, (C, B)
        sel = arg[:, None, :]
        cand = dict(power=v,
                    depth=torch.gather(depth, 1, sel)[:, 0],
                    w_in=torch.gather(w_in, 1, sel)[:, 0],
                    transit_time=transit_time(
                        arg, torch.full_like(arg, k), d_phase, pcol),
                    duration=torch.full_like(v, dur_val))
        if best is None:
            best = cand
        else:
            upd = cand["power"] > best["power"]
            best = {f: torch.where(upd, cand[f], best[f]) for f in best}
    return _undersized(best, _past_rows(nbins_p, max(k_durs), npad))


def _past_rows(nbins_p, k_max, npad):
    """Periods (C,) whose windows would read past ``npad`` prefix rows."""
    return nbins_p + torch.clamp(nbins_p, max=k_max) - 1 > npad


def _undersized(best, short):
    """NaN every statistic of the periods flagged in ``short`` (C,): their
    windows reach past the rows the caller sized, so no result is given."""
    return {f: torch.where(short[:, None], torch.nan, v)
            for f, v in best.items()}


window_scan_plain.calls = 0


def _check_cuda(name, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def durations_args(k_durs, dur_values):
    """Host arrays for a kernel's duration list (kept alive by the
    caller for the duration of the C call)."""
    k = np.ascontiguousarray(k_durs, dtype=np.int32)
    v = np.ascontiguousarray(dur_values, dtype=np.float64)
    if k.shape != v.shape or not 1 <= k.size <= 32:
        raise ValueError("need 1..32 durations with one value each")
    if np.any(k < 1):
        raise ValueError("duration bin counts must be >= 1")
    return k, v


def window_scan(csum, nbins_p, pc, total, k_durs, dur_values, d_phase,
                use_likelihood=True):
    """Weighted window scan: kernel K-W on CUDA tensors, the plain version
    on CPU tensors.  Same arguments and result as
    :func:`window_scan_plain`."""
    if csum.device.type == "cpu":
        return window_scan_plain(csum, nbins_p, pc, total, k_durs,
                                 dur_values, d_phase, use_likelihood)
    from ._build import check_status, cuda_library
    dtype = csum.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"csum must be float32 or float64 (got {dtype})")
    C, npad, twoB = csum.shape
    if twoB % 2:
        raise ValueError("csum's last axis must hold [w | w*y] (even size)")
    B = twoB // 2
    _check_cuda("csum", csum, dtype)
    _check_cuda("nbins_p", nbins_p, torch.int32, (C,))
    _check_cuda("pc", pc, dtype, (C,))
    _check_cuda("total", total, dtype, (twoB,))
    if max(k_durs) > npad:
        raise ValueError("a duration spans more bins than csum holds")
    k_arr, v_arr = durations_args(k_durs, dur_values)
    outs = [torch.empty((C, B), dtype=dtype, device=csum.device)
            for _ in _FIELDS]
    lib = cuda_library()
    fn = (lib.lk_bls_window_weighted_f32 if dtype == torch.float32
          else lib.lk_bls_window_weighted_f64)
    with torch.cuda.device(csum.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(csum.data_ptr(), nbins_p.data_ptr(), pc.data_ptr(),
                  total.data_ptr(), C, npad, B,
                  k_arr.ctypes.data_as(ctypes.c_void_p),
                  v_arr.ctypes.data_as(ctypes.c_void_p), len(k_arr),
                  float(d_phase), int(bool(use_likelihood)),
                  *[o.data_ptr() for o in outs], stream)
    check_status(lib, code, "bls_window_weighted")
    window_scan.launches += 1
    return dict(zip(_FIELDS, outs))


window_scan.launches = 0


def uniform_scan_staged(cs_y, cs_n, nbins_p, pc, tot_y, n_total, k_durs,
                        dur_values, d_phase, use_likelihood=True):
    """The staged uniform window scan of ``_bls_shared_scan_uniform`` in
    torch: every duration's windows as static slices of the zero-padded
    prefix sums, the first maximum over start bins, a later duration only
    if strictly greater, then the winner's statistics reconstructed from
    the prefix sums (n_in = n_out = 1 at bin 0 when no window is valid).
    cs_y (C, npad, B), cs_n (C, npad), nbins_p (C,), pc (C,), tot_y (B,);
    returns a dict of (C, B) tensors (no row check: see
    :func:`window_scan_uniform_plain`)."""
    C, npad, B = cs_y.shape
    dtype, device = cs_y.dtype, cs_y.device
    k_max = max(k_durs)
    rows = torch.arange(npad, device=device, dtype=torch.int32)
    cs_n = cs_n[..., None]                                     # (C, npad, 1)
    zeros_y = torch.zeros((C, 1, B), dtype=dtype, device=device)
    zeros_n = torch.zeros((C, 1, 1), dtype=dtype, device=device)
    zp_y = torch.cat([zeros_y, cs_y, zeros_y.expand(C, k_max - 1, B)], 1)
    zp_n = torch.cat([zeros_n, cs_n, zeros_n.expand(C, k_max - 1, 1)], 1)
    cex_y, cex_n = zp_y[:, :npad], zp_n[:, :npad]
    valid_rows = rows[None, :] < nbins_p[:, None]              # (C, npad)
    best_v = best_arg = best_j = None
    for j, k in enumerate(k_durs):
        n_in = zp_n[:, k:k + npad] - cex_n
        y_in = zp_y[:, k:k + npad] - cex_y
        n_out = n_total - n_in
        valid = (valid_rows & (k <= nbins_p)[:, None])[..., None]
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
    ks = torch.tensor(k_durs, dtype=torch.int64, device=device)
    dvs = torch.tensor(dur_values, dtype=dtype, device=device)
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
    t0 = transit_time(best_arg, kbest, d_phase, pc.to(dtype)[:, None])
    return dict(power=best_v, depth=depth_b, n_in=n_in_b, transit_time=t0,
                duration=dvs[best_j])


def window_scan_uniform_plain(cs_y, cs_n, nbins_p, pc, tot_y, n_total,
                              k_durs, dur_values, d_phase,
                              use_likelihood=True):
    """Plain torch uniform window scan (:func:`uniform_scan_staged`) with
    K-U's row check: a period whose windows would reach past the ``npad``
    rows gets NaN.  Returns a dict of (C, B) tensors: power, depth, n_in,
    transit_time, duration (count-based statistics)."""
    window_scan_uniform_plain.calls += 1
    best = uniform_scan_staged(cs_y, cs_n, nbins_p, pc, tot_y, n_total,
                               k_durs, dur_values, d_phase, use_likelihood)
    return _undersized(best, _past_rows(nbins_p, max(k_durs),
                                        cs_y.shape[1]))


window_scan_uniform_plain.calls = 0


def window_scan_uniform(cs_y, cs_n, nbins_p, pc, tot_y, n_total, k_durs,
                        dur_values, d_phase, use_likelihood=True):
    """Uniform window scan: kernel K-U on CUDA tensors, the plain version
    on CPU tensors.  Same arguments and result as
    :func:`window_scan_uniform_plain`."""
    if cs_y.device.type == "cpu":
        return window_scan_uniform_plain(cs_y, cs_n, nbins_p, pc, tot_y,
                                         n_total, k_durs, dur_values,
                                         d_phase, use_likelihood)
    from ._build import check_status, cuda_library
    dtype = cs_y.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cs_y must be float32 or float64 (got {dtype})")
    C, npad, B = cs_y.shape
    _check_cuda("cs_y", cs_y, dtype)
    _check_cuda("cs_n", cs_n, dtype, (C, npad))
    _check_cuda("nbins_p", nbins_p, torch.int32, (C,))
    _check_cuda("pc", pc, dtype, (C,))
    _check_cuda("tot_y", tot_y, dtype, (B,))
    if max(k_durs) > npad:
        raise ValueError("a duration spans more bins than cs_y holds")
    k_arr, v_arr = durations_args(k_durs, dur_values)
    outs = [torch.empty((C, B), dtype=dtype, device=cs_y.device)
            for _ in _UNIFORM_FIELDS]
    lib = cuda_library()
    fn = (lib.lk_bls_window_uniform_f32 if dtype == torch.float32
          else lib.lk_bls_window_uniform_f64)
    with torch.cuda.device(cs_y.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(cs_y.data_ptr(), cs_n.data_ptr(), nbins_p.data_ptr(),
                  pc.data_ptr(), tot_y.data_ptr(), C, npad, B,
                  k_arr.ctypes.data_as(ctypes.c_void_p),
                  v_arr.ctypes.data_as(ctypes.c_void_p), len(k_arr),
                  float(d_phase), float(n_total), int(bool(use_likelihood)),
                  *[o.data_ptr() for o in outs], stream)
    check_status(lib, code, "bls_window_uniform")
    window_scan_uniform.launches += 1
    return dict(zip(_UNIFORM_FIELDS, outs))


window_scan_uniform.launches = 0
