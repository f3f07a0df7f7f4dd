"""Per-curve binned BLS search (kernel K-PC) and its plain version.

The fast per-curve method (:func:`.bls.bls_power_binned`,
``LightCurve.to_periodogram("bls")`` and ``SweepRunner(method="fast")``)
folds every curve on its own time row: bins
``clip(trunc(x mod P / d_phase), 0, nbins - 1)`` (or the product with the
float64-rounded ``1/d_phase`` where ``reciprocal``), float64 bin prefix
sums of the weights and weighted fluxes, then every start bin × duration
window of the period, the first maximum of the objective kept.  Counterpart
of ``_bls_one_period_binned`` / ``_bls_scan_binned`` in
``lightkurve_tpu/ops/bls.py``, which XLA compiles (no Pallas kernel).

:func:`curve_scan_plain` is the search in plain torch, a chunk of periods
at a time (sorted bin ids, a float64 cumsum, ``searchsorted``, gathered
windows); :func:`curve_scan` launches K-PC (``csrc/bls_curve_fused.cu``),
all periods in one call, for CUDA tensors.  :func:`curve_route` picks
between them on the host, by the device, before any launch.  The helpers of
both per-curve methods (:func:`_mod`, :func:`_sorted_prefix`,
:func:`_take`, :func:`_chunks`) live here too.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..diagnostics import count, span
from .bls_fused import shared_memory_optin
from .bls_window import _check_cuda

__all__ = ["curve_scan", "curve_scan_plain", "curve_route", "curve_block",
           "curve_k_bins", "curve_rows", "curve_plan", "curve_slots",
           "curve_layout"]

_STATS = ("power", "depth", "depth_err", "depth_snr", "log_likelihood")


def _mod(x, y):
    """``x mod y`` as the reference computes it: the exact ``fmod``, moved
    into the divisor's sign (``torch.remainder`` rounds differently)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _take(a, best):
    return torch.gather(a, -1, best[..., None])[..., 0]


def _sorted_prefix(w, wy, order):
    """Prefix sums (B, C, n + 1), leading 0, of the weights and weighted
    fluxes (B, n) taken in each (curve, period)'s sample ``order``, in
    float64 whatever the data dtype: a window's sums are differences of
    two prefix sums over the whole curve (ROADMAP C3)."""
    B, C, n = order.shape
    zero = torch.zeros((B, C, 1), dtype=torch.float64, device=w.device)
    return tuple(torch.cat([zero, torch.cumsum(torch.gather(
        v[:, None, :].expand(B, C, n), -1, order), -1,
        dtype=torch.float64)], -1) for v in (w, wy))


def _chunks(periods, chunk):
    """The first period of each chunk of a per-curve scan; the caller's
    work on a chunk runs under its span ``bls.curve.chunk``, and each
    chunk counts once in ``bls.curve.chunks``."""
    P = periods.shape[0]
    for index, lo in enumerate(range(0, P, chunk)):
        with span("bls.curve.chunk", index=index,
                  periods=min(chunk, P - lo)):
            count("bls.curve.chunks")
            yield lo


def _k_bins(durations, d_phase):
    """Durations in bins, round half up, at least 1 (int64)."""
    return torch.clamp((durations / d_phase + 0.5).to(torch.int64), min=1)


def _from_best(best, durations, k_durs, d_phase, pc):
    """The duration and the mid-transit time (wrapped into [0, period))
    of each winner, from its flat index ``start * D + j`` (B, C);
    ``d_phase`` a 0-d float64 tensor or a Python number (the same
    product)."""
    D = durations.shape[0]
    i0, j = best // D, best % D
    t0 = (i0.to(pc.dtype) + 0.5 * k_durs[j].to(pc.dtype)) * d_phase
    period = pc[None, :]
    return durations[j], t0 - torch.floor(t0 / period) * period


def _fold_plain(ts, w, wy, pc, d_phase, nbins, reciprocal=False):
    """The plain fold of B curves at C periods: their bins (B, C, n)
    ``clip(trunc(phase / d_phase), 0, nbins - 1)`` (with ``reciprocal``
    the product with 1/d_phase rounded in float64), the exclusive bin
    prefix sums (B, C, nbins + 1) of ``w`` and ``wy`` in float64, from
    each curve's samples sorted by bin and a cumulative sum (deterministic,
    no float atomics), and the bins of each period (C,)."""
    B = w.shape[0]
    C = pc.shape[0]
    phase = _mod(ts[:, None, :], pc[None, :, None])
    pos = phase * (1.0 / d_phase) if reciprocal else phase / d_phase
    ids = torch.clamp(pos.to(torch.int64), 0, nbins - 1)
    ids_s, order = torch.sort(ids, dim=-1, stable=True)         # (B, C, n)
    cw_s, cwy_s = _sorted_prefix(w, wy, order)
    # bin prefix cw[b] = Σ over samples with ids < b, b = 0..nbins
    edges = torch.arange(nbins + 1, device=w.device).expand(B, C, -1)
    first = torch.searchsorted(ids_s, edges.contiguous(), right=False)
    nbins_p = torch.clamp(torch.ceil(pc / d_phase).to(torch.int64),
                          max=nbins)
    return (ids, torch.gather(cw_s, -1, first), torch.gather(cwy_s, -1, first),
            nbins_p)


def _chunk_plain(ts, w, wy, pc, durations, d_phase, nbins, use_likelihood,
                 wrap=True, reciprocal=False):
    """Binned box search of B curves at C periods: ts, w, wy (B, n), pc
    (C,), the fold of :func:`_fold_plain`.  Returns a dict of (B, C)
    float64 tensors."""
    B = w.shape[0]
    C, D = pc.shape[0], durations.shape[0]
    dev = w.device
    _, cw, cwy, nbins_p = _fold_plain(ts, w, wy, pc, d_phase, nbins,
                                      reciprocal)
    nbp = nbins_p[None, :, None]
    total_w = torch.gather(cw, -1, nbp.expand(B, C, 1))
    total_wy = torch.gather(cwy, -1, nbp.expand(B, C, 1))

    k_durs = _k_bins(durations, d_phase)
    starts = torch.arange(nbins, device=dev)                    # (T0,)
    ends = starts[:, None] + k_durs[None, :]                    # (T0, D)
    if wrap:
        # circular: windows past the period edge wrap to the start
        wraps = ends[None] > nbins_p[:, None, None]             # (C, T0, D)
        ends_m = torch.where(wraps, ends[None] - nbins_p[:, None, None],
                             ends[None])
    else:
        # astropy edge convention: windows past the period edge read empty
        # bins (truncated transits), no wrap-around
        ends_m = torch.minimum(ends, torch.tensor(nbins, device=dev))
        ends_m = ends_m[None].expand(C, -1, -1)
    # gathers clamp out-of-range indices, as the reference's do (only
    # windows that are masked invalid below reach them)
    ends_m = torch.clamp(ends_m, 0, nbins).reshape(1, C, -1).expand(B, C, -1)
    idx_s = starts[None, None, :].expand(B, C, -1)

    def window(c, tot):
        c_end = torch.gather(c, -1, ends_m).reshape(B, C, nbins, D)
        c_start = torch.gather(c, -1, idx_s)[..., None]
        if wrap:
            return torch.where(wraps[None], (tot[..., None] - c_start) + c_end,
                               c_end - c_start)
        return c_end - c_start

    w_in, wy_in = window(cw, total_w), window(cwy, total_wy)
    w_out = total_w[..., None] - w_in
    wy_out = total_wy[..., None] - wy_in
    ok = ((w_in > 0) & (w_out > 0)
          & (starts[None, None, :, None] < nbins_p[None, :, None, None])
          & (k_durs[None, None, None, :] <= nbins_p[None, :, None, None]))
    w_in_s = torch.where(ok, w_in, 1.0)
    w_out_s = torch.where(ok, w_out, 1.0)
    depth = wy_out / w_out_s - wy_in / w_in_s
    depth_err = torch.sqrt(1.0 / w_in_s + 1.0 / w_out_s)
    snr = depth / depth_err
    loglike = 0.5 * w_in_s * depth * depth
    objective = torch.where(ok, loglike if use_likelihood else snr,
                            -torch.inf).reshape(B, C, -1)
    best = torch.argmax(objective, dim=-1)                      # first max
    flat = lambda a: _take(a.reshape(B, C, -1), best)           # noqa: E731
    duration, t0 = _from_best(best, durations, k_durs, d_phase, pc)
    return dict(power=flat(objective), depth=flat(depth),
                depth_err=flat(depth_err), depth_snr=flat(snr),
                log_likelihood=flat(loglike), duration=duration,
                transit_time=t0)


def curve_scan_plain(ts, w, wy, periods, durations, d_phase, nbins,
                     use_likelihood, wrap=True, reciprocal=False, chunk=16):
    """Plain torch per-curve binned search, ``chunk`` periods at a time,
    each under a ``bls.curve.chunk`` span.  ts (B, n) float64 times from
    each curve's first sample, w and wy (B, n) weights and weighted fluxes
    (any float dtype), periods (P,) and durations (D,) float64, d_phase a
    0-d float64 tensor on their device.  Returns a dict of (B, P) float64
    tensors: power, depth, depth_err, depth_snr, log_likelihood, duration,
    transit_time (in [0, period)).  ``calls`` counts the calls on a CUDA
    device, where the plain version stands in for the kernel; on the CPU
    it is the route and the yardstick."""
    if w.is_cuda:
        curve_scan_plain.calls += 1
    parts = [_chunk_plain(ts, w, wy, periods[i:i + chunk], durations,
                          d_phase, nbins, use_likelihood, wrap=wrap,
                          reciprocal=reciprocal)
             for i in _chunks(periods, chunk)]
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}


curve_scan_plain.calls = 0


def curve_route(device):
    """``"kernel"`` (K-PC) for a CUDA device, whatever the grid (periods
    whose columns do not fit shared memory take its L2 kernel);
    ``"plain"`` for any other device.  Read on the host before any
    launch."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


_BLOCKS = {}


def curve_block(max_rows, dtype, device):
    """The block K-PC launches on ``device`` where its largest period needs
    ``max_rows`` rows: (periods per block at most, shared memory bytes,
    resident blocks per SM), from the occupancy calculator
    (``block_of`` in csrc/bls_curve_fused.cu), once per process."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (dtype == torch.float64, int(max_rows), index)
    if key not in _BLOCKS:
        from ._build import check_status, cuda_library
        lib = cuda_library()
        out = [ctypes.c_int(0) for _ in range(3)]
        with torch.cuda.device(index):
            code = lib.lk_bls_curve_block(int(key[0]), key[1],
                                          *[ctypes.byref(v) for v in out])
        check_status(lib, code, "curve block")
        _BLOCKS[key] = tuple(v.value for v in out)
    return _BLOCKS[key]


def curve_k_bins(d_host, d_phase):
    """The durations in bins on the host, as :func:`_k_bins` computes them
    on the device (round half up, at least 1)."""
    d = np.asarray(d_host, np.float64)
    return np.maximum((d / d_phase + 0.5).astype(np.int64), 1)


def curve_rows(p_host, k_host, d_phase, nbins):
    """The rows (two float64 columns each) K-PC's warp of each period
    reads, computed on the host as the kernel computes them: the period's
    bins ``min(ceil(p / d_phase), nbins)`` plus the longest duration, at
    most ``nbins``, plus the leading 0."""
    nbp = np.clip(np.ceil(np.asarray(p_host, np.float64) / d_phase), 0,
                  nbins)
    return (np.minimum(nbins, nbp + int(np.max(k_host))) + 1).astype(
        np.int64)


def curve_plan(rows, warps, smem):
    """Periods packed into blocks of the shared-memory kernel in their
    order, greedily: a block takes the next period while it holds fewer
    than ``warps`` and the rows of all fit ``smem`` bytes (16 a row).  A
    period of 0 rows (one the L2 kernel takes) holds a warp of its block
    and no rows; where every period has 0 rows there is no block.  Returns
    each block's first period and the end (G + 1,) and each period's first
    row in its block (P,)."""
    if not np.any(rows):
        return np.zeros(1, np.int64), np.zeros(len(rows), np.int64)
    cap = int(smem) // 16
    starts, off = [0], np.empty(len(rows), np.int64)
    used = count = 0
    for i, r in enumerate(rows.tolist()):
        if count == warps or used + r > cap:
            starts.append(i)
            used = count = 0
        off[i] = used
        used += r
        count += 1
    starts.append(len(rows))
    return np.asarray(starts, np.int64), off


#: bytes of global memory K-PC's L2 kernel may take for its warps' columns
L2_WORKSPACE = 1 << 29
#: warps of the L2 kernel an SM at most
L2_WARPS_PER_SM = 16


def curve_slots(items, rows, device):
    """The warps of K-PC's L2 kernel for ``items`` (curve, period) pairs
    of at most ``rows`` rows: one a pair, at most :data:`L2_WARPS_PER_SM`
    an SM, their columns (16 bytes a row) within :data:`L2_WORKSPACE`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(int(items), L2_WARPS_PER_SM * sms,
                      L2_WORKSPACE // (16 * int(rows))))


_PLANS = {}
_PLANS_KEPT = 16


def curve_layout(p_host, k_host, d_phase, nbins, dtype, device):
    """K-PC's layout of a grid on ``device``: the periods whose rows
    (:func:`curve_rows`) fit a block's opt-in shared memory packed into
    blocks of the shared-memory kernel (:func:`curve_block`,
    :func:`curve_plan`), the rest listed for the L2 kernel.  Returns the
    int32 plan on the device (the durations in bins, the blocks' first
    periods and the end, each period's first row and rows, 0 for the L2
    kernel's, then the L2 kernel's periods), the block count, the L2
    kernel's period count, the block's warps and shared memory, and the
    L2 kernel's rows a column.  The last few are kept, keyed by the grid,
    for a caller that searches curve after curve on one grid."""
    key = (p_host.tobytes(), float(d_phase), int(nbins),
           tuple(k_host.tolist()), dtype, str(device))
    hit = _PLANS.get(key)
    if hit is None:
        rows = curve_rows(p_host, k_host, d_phase, nbins)
        long = 16 * rows > shared_memory_optin(device)
        short = np.where(long, 0, rows)
        warps = smem = 0
        if not long.all():
            warps, smem, _ = curve_block(int(short.max()), dtype, device)
        starts, off = curve_plan(short, warps, smem)
        longs = np.flatnonzero(long)
        plan = torch.from_numpy(np.concatenate(
            [k_host, starts, off, short, longs]).astype(np.int32))
        if device.type == "cuda":
            plan = plan.pin_memory().to(device, non_blocking=True)
        if len(_PLANS) >= _PLANS_KEPT:
            _PLANS.pop(next(iter(_PLANS)))
        hit = _PLANS[key] = (plan, len(starts) - 1, len(longs), warps, smem,
                             int(rows[long].max()) if long.any() else 0)
    return hit


def _launch(ts, w, wy, periods, k_host, d_phase, nbins, use_likelihood,
            wrap, reciprocal, layout):
    """One launch of K-PC (its shared-memory kernel, then its L2 kernel,
    each where it has periods) on checked tensors, with the
    :func:`curve_layout` of the grid: the winners' statistics (a dict of
    (B, P) float64 tensors) and their flat indices (B, P) int32."""
    from ._build import check_status, cuda_library
    plan, groups, n_long, warps, smem, ws_rows = layout
    B, n = w.shape
    P = periods.shape[0]
    dev = w.device
    outs = [torch.empty((B, P), dtype=torch.float64, device=dev)
            for _ in _STATS]
    best = torch.empty((B, P), dtype=torch.int32, device=dev)
    slots, ws = 0, None
    if n_long:
        slots = curve_slots(B * n_long, ws_rows, dev)
        ws = torch.empty(2 * ws_rows * slots, dtype=torch.float64,
                         device=dev)
    lib = cuda_library()
    fn = (lib.lk_bls_curve_fused_f32 if w.dtype == torch.float32
          else lib.lk_bls_curve_fused_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(ts.data_ptr(), w.data_ptr(), wy.data_ptr(),
                  periods.data_ptr(), plan.data_ptr(), len(k_host), n, B, P,
                  groups, n_long, warps, smem, nbins, d_phase, 1.0 / d_phase,
                  int(bool(reciprocal)), int(bool(use_likelihood)),
                  int(bool(wrap)), None if ws is None else ws.data_ptr(),
                  ws_rows, slots, *[o.data_ptr() for o in outs],
                  best.data_ptr(), stream)
    check_status(lib, code, "bls_curve_fused")
    return dict(zip(_STATS, outs)), best


def curve_scan(ts, w, wy, periods, durations, d_phase, nbins,
               use_likelihood, wrap, reciprocal, p_host, d_host):
    """Kernel K-PC: the search of :func:`curve_scan_plain` in one call
    for CUDA tensors (all periods, no chunks: the shared-memory kernel,
    then the L2 kernel for periods too long for it), the same arguments
    and result; raises for any other device (the caller routes,
    :func:`curve_route`).  ``p_host`` and ``d_host`` are the periods and
    durations on the host, from which the launch is laid out without a
    device read.  The window statistics come from the plain version's
    float64 expressions on bin prefix sums taken in another order (the
    same bits where those sums are exact, as float32 data's are); the
    transit times from the winners' bins as the plain version computes
    them."""
    f64 = torch.float64
    dtype = w.dtype
    if dtype not in (torch.float32, f64):
        raise TypeError(f"w must be float32 or float64 (got {dtype})")
    B, n = w.shape
    P, D = periods.shape[0], durations.shape[0]
    w, wy = w.contiguous(), wy.contiguous()
    _check_cuda("w", w, dtype)
    _check_cuda("wy", wy, dtype, (B, n))
    _check_cuda("ts", ts, f64, (B, n))
    _check_cuda("periods", periods, f64, (P,))
    _check_cuda("durations", durations, f64, (D,))
    d_phase, nbins = float(d_phase), int(nbins)
    p_host = np.asarray(p_host, np.float64)
    k_host = curve_k_bins(d_host, d_phase)
    layout = curve_layout(p_host, k_host, d_phase, nbins, dtype, w.device)
    out, best = _launch(ts, w, wy, periods, k_host, d_phase, nbins,
                        use_likelihood, wrap, reciprocal, layout)
    curve_scan.launches += 1
    count("bls.curve.kernel")
    # d_phase as a Python number: a product with it rounds as with a 0-d
    # float64 tensor, and a tensor made from it would be a blocking copy
    out["duration"], out["transit_time"] = _from_best(
        best.to(torch.int64), durations, layout[0][:D].to(torch.int64),
        d_phase, periods)
    return out


curve_scan.launches = 0
