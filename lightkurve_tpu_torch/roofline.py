"""Analytic roofline accounting for the hot paths.

Counterpart of ``lightkurve_tpu/roofline.py``.  Each ``*_cost`` function
returns the algorithmic work of a path, the same algorithm in both
packages: the operations the algorithm needs (not what a compiler emits)
and a lower bound on the device-memory bytes (each logical operand
streamed the least number of times).  ``fractions_of_peak`` turns (cost,
seconds, device) into

- ``mfu``        — flops / (dt × the device's peak operation rate)
- ``membw_frac`` — bytes_min / (dt × the device's peak memory rate)

against the published peaks in :data:`PEAKS`.  The matrix products of
the port run in full float32 (:func:`config.full_f32_matmul`), so the
operation peak defaults to float32 outside the tensor cores.

The ``bound_*`` functions give each BLS kernel's least time on the card
(ms, and whether bytes or operations bound it): the larger of the bytes
the function must move (each input read once, each output written once)
over the memory rate, and its operations over the float32 rate, at the
H100 SXM's peaks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PEAKS", "device_peaks", "fractions_of_peak", "ls_fast_cost",
           "fastchi2_cost", "flatten_cost", "acf_windows_cost",
           "pld_photometry_cost", "shared_uniform_cost", "bound_fused",
           "bound_weighted_fused", "bound_weighted", "bound_uniform",
           "bound_staged_fold", "bound_curve"]

#: peaks per device, in operations/s by type (``f32``, ``f64`` outside the
#: tensor cores; ``tf32``, ``bf16``, ``f64_tensor``: dense tensor-core
#: rates, no sparsity) and device-memory bytes/s (``hbm``)
PEAKS = {
    # NVIDIA H100 SXM5 80 GB (NVIDIA data sheet, at its 700-W limit)
    "h100_sxm": {"f32": 67e12, "f64": 34e12, "tf32": 494.7e12,
                 "bf16": 989.4e12, "f64_tensor": 67e12, "hbm": 3.35e12},
    # NVIDIA H100 PCIe 80 GB (NVIDIA data sheet, at its 350-W limit)
    "h100_pcie": {"f32": 51e12, "f64": 26e12, "tf32": 378e12,
                  "bf16": 756e12, "f64_tensor": 51e12, "hbm": 2.0e12},
    # nominal host figures, so that a CPU run gives well-formed fractions
    "cpu": {"f32": 5e11, "f64": 2.5e11, "tf32": 5e11, "bf16": 1e12,
            "f64_tensor": 2.5e11, "hbm": 100e9},
}


def _device_name(device):
    """The name to look up: ``torch.cuda.get_device_name`` of a CUDA
    device, ``"cpu"`` for the host, any other string as it is."""
    if device is None:
        from . import config
        device = config.resolve_device(None)
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return device
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_peaks(device=None):
    """The :data:`PEAKS` row of a torch device or a device name (``None``:
    the configured device), with its key under ``kind``.  Any H100 but the
    PCIe card is taken as the SXM part ("NVIDIA H100 80GB HBM3")."""
    name = _device_name(device).lower()
    key = "cpu"
    if "h100" in name:
        key = "h100_pcie" if "pcie" in name else "h100_sxm"
    return dict(PEAKS[key], kind=key)


def fractions_of_peak(cost, seconds, device=None, matmul_peak="f32"):
    """{'mfu', 'membw_frac', ...} for an analytic ``cost`` dict run in
    ``seconds`` on ``device``."""
    peaks = device_peaks(device)
    out = {"flops": float(cost["flops"]),
           "hbm_bytes_min": float(cost["hbm_bytes"]),
           "mfu": round(cost["flops"] / (seconds * peaks[matmul_peak]), 4),
           "membw_frac": round(
               cost["hbm_bytes"] / (seconds * peaks["hbm"]), 4),
           "peak_basis": f"{peaks['kind']}:{matmul_peak}"}
    return out


def _fft_flops(batch, length):
    """Complex-FFT flop count, the standard 5·N·log2(N) per transform."""
    return 5.0 * batch * length * math.log2(length)


def ls_fast_cost(n, B, Nf, oversampling=5, Mfft=4, fit_mean=True,
                 dtype_bytes=4):
    """Press-Rybicki fast LS (``ops/lombscargle.py::lombscargle_fast``):
    per trig_sum = extirpolation scatter ((M+1) segment-sums of ~6 flops
    per sample) + one complex FFT of the packed pair; 3 trig sums when
    fit_mean (h = wy, w on grid 1; w on grid 2) + O(Nf) postprocessing."""
    Nfft = 1 << int(Nf * oversampling - 1).bit_length()
    n_tsum = 3 if fit_mean else 2
    extirp = n_tsum * 2 * B * n * (Mfft + 1) * 6.0
    fft = n_tsum * _fft_flops(B, Nfft)
    post = 30.0 * B * Nf
    # grids written+read around each FFT (complex), power out
    bytes_min = (n_tsum * B * Nfft * 2 * dtype_bytes * 2
                 + B * Nf * dtype_bytes)
    return {"flops": extirp + fft + post, "hbm_bytes": bytes_min,
            "detail": {"Nfft": Nfft, "fft_flops": fft}}


def fastchi2_cost(n, B, Nf, nterms, oversampling=5, Mfft=4, fit_mean=True,
                  dtype_bytes=4):
    """FFT multi-term LS (``lombscargle_fastchi2``): 3k harmonic trig
    sums (each an extirpolation + FFT) + the per-frequency Cholesky
    quadform over M = 2k+fit_mean columns (~M³/3 + M² flops per
    frequency, all elementwise over Nf)."""
    k = nterms
    Nfft = 1 << int(Nf * oversampling - 1).bit_length()
    n_tsum = 3 * k
    extirp = n_tsum * 2 * B * n * (Mfft + 1) * 6.0
    fft = n_tsum * _fft_flops(B, Nfft)
    M = 2 * k + (1 if fit_mean else 0)
    chol = B * Nf * (M ** 3 / 3.0 + 3.0 * M ** 2)
    bytes_min = (n_tsum * B * Nfft * 2 * dtype_bytes * 2
                 + (M * (M + 1) / 2 + M) * B * Nf * dtype_bytes
                 + B * Nf * dtype_bytes)
    return {"flops": extirp + fft + chol, "hbm_bytes": bytes_min,
            "detail": {"Nfft": Nfft, "chol_flops": chol}}


def flatten_cost(n, B, window, niters=3, dtype_bytes=4):
    """SG flatten (``ops/detrend.py::flatten_batch``): per iteration one
    width-``window`` convolution (2·window flops/sample) plus the clip
    pass (~12 flops/sample)."""
    conv = niters * 2.0 * window * B * n
    clip = niters * 12.0 * B * n
    bytes_min = niters * 4 * B * n * dtype_bytes
    return {"flops": conv + clip, "hbm_bytes": bytes_min, "detail": {}}


def acf_windows_cost(B, n_centers, win, dtype_bytes=4):
    """Batched windowed autocorrelation (``ops/acf.py``): per (target,
    center) one forward + one inverse complex FFT at 2·win padding."""
    L = 1 << int(2 * win - 1).bit_length()
    fft = 2.0 * _fft_flops(B * n_centers, L)
    bytes_min = B * n_centers * L * 2 * dtype_bytes * 2
    return {"flops": fft, "hbm_bytes": bytes_min, "detail": {"L": L}}


def pld_photometry_cost(B, T, H, W, n_pca, dtype_bytes=4):
    """Aperture photometry + PLD correct per TPF stack: masked reductions
    over the cube (~4 flops/voxel), PCA via randomized range finding
    (~6·T·p·(p+q) matmul flops with p pixels, q=n_pca+8), and the
    regression solve (T·k² + k³ per target, k = n_pca+2)."""
    p = H * W
    vox = 4.0 * B * T * p
    q = n_pca + 8
    pca = 6.0 * B * T * p * q
    k = n_pca + 2
    solve = B * (2.0 * T * k * k + k ** 3 / 3.0)
    bytes_min = B * T * p * dtype_bytes * 3
    return {"flops": vox + pca + solve, "hbm_bytes": bytes_min,
            "detail": {}}


# ---------------------------------------------------------------------------
# the BLS kernels' least time on the card
# ---------------------------------------------------------------------------
PEAK_BYTES_S = PEAKS["h100_sxm"]["hbm"]
PEAK_F32_S = PEAKS["h100_sxm"]["f32"]
PEAK_F64_S = PEAKS["h100_sxm"]["f64"]
#: operations per window and curve of the weighted scan (K-W, K-WF), whose
#: weights differ per curve: two prefix differences, w_out, the two
#: reciprocals and their sum, depth (two products, one difference), the
#: objective (two products) and the running-maximum compare
OPS_WEIGHTED = 12
#: the uniform scans (K-F, K-U) share the counts between curves: per window
#: and curve they need the flux prefix difference, depth (two products,
#: one difference), the objective (two products) and the compare ...
OPS_UNIFORM_CURVE = 7
#: ... and once per window for all curves n_in, n_out, the two
#: reciprocals, their sum and 0.5 * n_in
OPS_UNIFORM_WINDOW = 6


def _windows(nbp, k_durs):
    """Windows the scans evaluate per curve: every start bin r < nbins_p of
    every duration k <= nbins_p, summed over the periods."""
    nbp = np.asarray(nbp.cpu() if hasattr(nbp, "cpu") else nbp, np.int64)
    return int(sum(int(p) * sum(k <= p for k in k_durs) for p in nbp))


def _bound(nbytes, ops, peak_ops_s=PEAK_F32_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _outputs_bytes(C, B, item):
    return 5 * C * B * item + C * 8          # five (C, B) fields, pc, nbins_p


def _uniform_scan_ops(B, windows):
    return (B * OPS_UNIFORM_CURVE + OPS_UNIFORM_WINDOW) * windows


def _fold_ops(n, nbp, k_max, wrap):
    """Adds per column of one fold over the periods: one deposit per
    sample, the prefix of every row, and in wrap mode one add per wrap row
    (the extension rows are total + prefix; no second deposit is
    needed)."""
    rows = int(np.sum(nbp + k_max - 1))
    return n * len(nbp) + rows + (k_max - 1) * len(nbp) * bool(wrap)


def _fused_counts(n, B, item, nbp, k_durs, wrap):
    """K-F's (bytes, operations) for one launch over the periods whose bins
    are ``nbp``: the flux (n, B), the times and the weights read once, the
    outputs written once; per period every sample folded into each curve's
    column and the shared count column (:func:`_fold_ops`), then the
    window scans."""
    fold = (B + 1) * _fold_ops(n, nbp, max(k_durs), wrap)
    return ((n * B + n + B) * item + _outputs_bytes(len(nbp), B, item),
            fold + _uniform_scan_ops(B, _windows(nbp, k_durs)))


def bound_fused(ts, Y0, pc, k_durs, dur_values, d_phase, nbins, max_nbp,
                like=True, wrap=True, chunk=8):
    """K-F's least time for one launch (:func:`_fused_counts`)."""
    from .ops.bls_fused import nbins_per_period
    n, B = Y0.shape
    nbp = nbins_per_period(pc, d_phase).cpu().numpy()
    return _bound(*_fused_counts(n, B, Y0.element_size(), nbp, k_durs, wrap))


def shared_uniform_cost(n, B, periods, durations, oversample=10,
                        dtype=torch.float32):
    """The work of one uniform-weight ``bls_power_shared_batch`` call with
    ``bucket=True`` on the fused route (K-F), as :func:`fractions_of_peak`
    takes it: K-F's operations and bytes (:func:`_fused_counts`) summed
    over the call's launches, one per group of periods of one 128-row tile
    count (``ops.bls._bucket_periods``)."""
    from .ops.bls import _bucket_periods
    from .ops.bls_fused import nbins_per_period
    durations = np.asarray(durations, np.float64)
    d_phase = float(durations.min()) / oversample
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in durations)
    pc = torch.as_tensor(np.asarray(periods, np.float64), dtype=dtype)
    groups, _ = _bucket_periods(pc.numpy(), d_phase, max(k_durs))
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = ops = 0
    for idx, _ in groups:
        nbp = nbins_per_period(pc[torch.as_tensor(idx)], d_phase).numpy()
        b, o = _fused_counts(n, B, item, nbp, k_durs, True)
        nbytes, ops = nbytes + b, ops + o
    return {"flops": float(ops), "hbm_bytes": float(nbytes),
            "detail": {"launches": len(groups)}}


def bound_weighted_fused(ts, W, WY, pc, k_durs, dur_values, d_phase, nbins,
                         max_nbp, like=True, wrap=True, chunk=8):
    """K-WF: reads W, WY (n, B) and the times once; per period it folds
    every sample into each curve's two columns (:func:`_fold_ops`) and
    scans the windows at 12 operations per window and curve."""
    from .ops.bls_fused import nbins_per_period
    n, B = W.shape
    item = W.element_size()
    nbp = nbins_per_period(pc, d_phase).cpu().numpy()
    fold = 2 * B * _fold_ops(n, nbp, max(k_durs), wrap)
    return _bound((2 * n * B + n + 2 * B) * item
                  + _outputs_bytes(len(nbp), B, item),
                  fold + B * OPS_WEIGHTED * _windows(nbp, k_durs))


def bound_weighted(csum, nbp, pc, total, k_durs, dur_values, d_phase,
                   like=True):
    """K-W: reads the prefix sums (C, npad, 2B) once and scans the
    windows of every curve."""
    C, npad, twoB = csum.shape
    item = csum.element_size()
    return _bound(csum.numel() * item + twoB * item
                  + _outputs_bytes(C, twoB // 2, item),
                  twoB // 2 * OPS_WEIGHTED * _windows(nbp, k_durs))


def bound_uniform(cs_y, cs_n, nbp, pc, tot_y, n_total, k_durs, dur_values,
                  d_phase, like=True):
    """K-U: reads the flux prefix sums (C, npad, B) and the count prefix
    (C, npad) once and scans the windows of every curve."""
    C, npad, B = cs_y.shape
    item = cs_y.element_size()
    return _bound((cs_y.numel() + cs_n.numel() + B) * item
                  + _outputs_bytes(C, B, item),
                  _uniform_scan_ops(B, _windows(nbp, k_durs)))


def bound_staged_fold(ts, X, pc, d_phase, nbins, max_nbp, k_max, wrap=True):
    """K-SF: per period it reads the row of ``X`` (n, cols) of each of its
    m deposits (counted from this run's fold: the samples, and in wrap
    mode those of the first npad - nbins_p rows again) and its int32
    source, the npad + 1 row starts, and writes npad prefix rows; one add
    per value read."""
    from .ops.bls_fused import fold_rows
    from .ops.bls_staged_fold import fold_deposits
    cols, item = X.shape[1], X.element_size()
    npad = fold_rows(nbins, max_nbp, k_max)
    _, row_start, _ = fold_deposits(ts, pc, d_phase, nbins, npad, wrap)
    m, C = int(row_start[:, -1].sum()), pc.shape[0]
    return _bound((m + C * npad) * cols * item + (m + C * (npad + 1)) * 4,
                  m * cols)


def bound_curve(ts, w, wy, pc, durations, d_phase, nbins, like=True,
                wrap=True, reciprocal=False):
    """K-PC: reads each curve's float64 times, weights and weighted fluxes
    (B, n) and the grid once, writes each (curve, period)'s five float64
    statistics and its int32 index once; per (curve, period) it folds
    every sample into two columns, takes the prefix of the period's rows
    (:func:`.ops.bls_curve.curve_rows`) and scans its windows at 12
    operations each, in float64, so at the float64 rate."""
    from .ops.bls_curve import curve_k_bins, curve_rows
    B, n = w.shape
    p_host = pc.cpu().numpy().astype(np.float64)
    k = curve_k_bins(durations.cpu().numpy(), d_phase)
    nbp = np.minimum(np.ceil(p_host / d_phase), nbins).astype(np.int64)
    rows = curve_rows(p_host, k, d_phase, nbins)
    P = len(p_host)
    fold = 2 * B * (n * P + int(rows.sum()))
    scan = B * OPS_WEIGHTED * _windows(nbp, k.tolist())
    nbytes = (B * n * (8 + 2 * w.element_size()) + (P + len(k)) * 8
              + B * P * (5 * 8 + 4))
    return _bound(nbytes, fold + scan, PEAK_F64_S)
