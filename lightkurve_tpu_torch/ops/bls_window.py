"""Weighted BLS duration-window scan (kernel K-W) and its plain version.

Counterpart of ``lightkurve_tpu/ops/bls_window_pallas.py``
(``window_scan_pallas``).  The scan takes the inclusive bin prefix sums of
``[sum w | sum w*y]`` of the circular double-deposit fold and, for every
(trial period, curve), tries every start bin ``r < nbins_p`` and every
duration ``k <= nbins_p``::

    w_in  = csum[r + k - 1] - csum[r - 1]      (w_out = total - w_in)
    depth = wy_out / w_out - wy_in / w_in
    objective = 0.5 * w_in * depth**2          (likelihood)
                or depth / sqrt(1/w_in + 1/w_out)  (snr)

A window is valid when ``w_in > 0`` and ``w_out > 0``; invalid windows
are -inf.  Over ``r`` the first maximum wins; over ``k`` a later duration
wins only if it is strictly greater.  A period whose windows would reach
past the ``npad`` rows of ``csum`` (a fold sized for fewer bins than
``nbins_p``) gets NaN statistics.

:func:`window_scan` launches the CUDA kernel (``csrc/bls_window.cu``) for
CUDA tensors and runs :func:`window_scan_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["window_scan", "window_scan_plain", "transit_time"]

_FIELDS = ("power", "depth", "w_in", "transit_time", "duration")


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
    k_max = max(k_durs)
    return _undersized(best,
                       nbins_p + torch.clamp(nbins_p, max=k_max) - 1 > npad)


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
