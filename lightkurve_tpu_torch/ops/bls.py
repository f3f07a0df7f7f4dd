"""Box Least Squares over batches of light curves.

Counterpart of ``lightkurve_tpu/ops/bls.py``.

**Shared time grid** (:func:`bls_power_shared_batch`).  Every curve of the
batch shares one time grid, so the fold of samples into phase bins is the
same for every curve at each trial period.  Two regimes, each with two
routes chosen on the host from shapes before any launch (``fold_impl``,
:func:`fold_route`): a fused kernel (fold, prefix sums and window scan in
one launch per call, one warp per (period, curve), while a block of one
warp fits the card's shared memory), or the staged route (the fold
kernel K-SF, :mod:`.bls_staged_fold`, then a window kernel), whose limit
is device memory instead.  Either takes the flux as (n, B) views of the
(B, n) batch, the layout the fused kernels read; the staged route makes
one contiguous (n, cols) copy per call for K-SF.

* **uniform** -- every curve's weights are constant in time (``dy=None``
  or one ``dy`` per curve).  Box statistics then depend only on counts,
  and each curve's weight re-enters as a scalar rescale
  (:func:`_uniform_stats_rescale`).  Fused: kernel K-F (:mod:`.bls_fused`).
  Staged: K-SF and the window kernel K-U
  (:func:`.bls_window.window_scan_uniform`); the fold holds its prefix
  rows and its deposit indices (:func:`staged_fold_bytes`) per period,
  and the route takes as many periods per call as half the free memory
  holds, at least one (:func:`staged_slice`).
* **weighted** -- per-sample ``dy`` and masked samples (``dy = inf``), as
  real mission data has.  Fused: kernel K-WF (:mod:`.bls_fused_weighted`).
  Staged: K-SF over ``[w | w*y]`` and the window kernel K-W
  (:mod:`.bls_window`), as many periods per call as half the free memory
  holds (:func:`staged_slice`).

**Per curve** (:func:`bls_power`, exact; :func:`bls_power_binned`, fast):
each curve folds on its own time grid, in plain torch with the curves as
a batch dimension (the reference's ``vmap`` written out): sorted phases,
prefix sums and batched ``searchsorted`` range queries, no kernel.  The
fold and its sums are float64 whatever the data dtype (ROADMAP C3).

CUDA tensors take the kernels; CPU tensors take their plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import numpy_dtype, on_device
from ..diagnostics import count, set_attrs, span
from .bls_fused import (fold_rows, fused_fits, fused_scan_uniform,
                        max_nbins_bound)
from .bls_fused_weighted import fused_scan_weighted
from .bls_staged_fold import staged_fold
from .bls_window import window_scan, window_scan_uniform

__all__ = ["bls_power_shared_batch", "bls_power", "bls_power_direct",
           "bls_power_binned", "bls_objective_single", "fold_route"]

FOLD_IMPLS = ("auto", "fused", "staged")


def _staged_scan_weighted(ts, W, WY, periods, k_durs, dur_values, d_phase,
                          nbins, max_nbins_p, use_likelihood, chunk, wrap):
    """The staged weighted route: K-SF over ``[w | w*y]``
    (:func:`.bls_staged_fold.staged_fold`) then K-W, ``chunk`` periods at
    a time, fewer where the fold's memory would pass the device's free
    memory (:func:`staged_slice`).  Returns a dict of (P, B) tensors, as
    :func:`.bls_fused_weighted.fused_scan_weighted` does."""
    n, B = W.shape
    WWY = torch.cat([W, WY], dim=1)               # (n, 2B), contiguous
    total = WWY.sum(0)
    npad = fold_rows(nbins, max_nbins_p, max(k_durs))
    step = staged_slice(chunk, npad, n, 2 * B, W.element_size(),
                        _free_device_bytes(W.device))
    set_attrs(slices=-(-periods.shape[0] // step))
    parts = []
    for i in range(0, periods.shape[0], step):
        pc = periods[i:i + step]
        csum, _, nbp = staged_fold(ts, WWY, pc, d_phase, nbins, max_nbins_p,
                                   max(k_durs), wrap)
        parts.append(window_scan(csum, nbp, pc, total, k_durs, dur_values,
                                 d_phase, use_likelihood))
        del csum
    return {f: torch.cat([p[f] for p in parts]) for f in parts[0]}


def _bls_shared_scan(ts, W, WY, periods, k_durs, dur_values, d_phase, nbins,
                     max_nbins_p, use_likelihood, chunk, wrap=True,
                     fold_impl="auto"):
    """Weighted shared-grid scan.  W, WY (n, B); returns a dict of (B, P)
    tensors (power is the raw window objective; the caller recomputes it
    from log_likelihood or depth_snr)."""
    route = fold_route(fold_impl, max_nbins_p, max(k_durs), W.dtype,
                       W.device, weighted=True, curves=W.shape[1])
    set_attrs(route=route, slices=0)
    scan = fused_scan_weighted if route == "fused" else _staged_scan_weighted
    best = scan(ts, W, WY, periods, k_durs, dur_values, d_phase, nbins,
                max_nbins_p, use_likelihood, chunk=chunk, wrap=wrap)
    w_in_b = best.pop("w_in")
    w_out_b = W.sum(0) - w_in_b
    best["depth_err"] = torch.sqrt(1.0 / w_in_b + 1.0 / w_out_b)
    best["depth_snr"] = best["depth"] / best["depth_err"]
    best["log_likelihood"] = 0.5 * w_in_b * best["depth"] ** 2
    return {f: v.T for f, v in best.items()}


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


#: "auto"'s route crossovers, per card (its ``torch.cuda.get_device_name``)
#: and regime (``weighted``): ``(curves, rows)`` pairs, read in order; a
#: call of at least ``curves`` curves takes the fused kernel while its rows
#: are at most ``rows`` (the last pair the call reaches decides), and the
#: staged route past them.  From the wall time of one SweepRunner chunk
#: on each route at ``chip_smoke.py`` phase 5's route points (PERF.md
#: section 6), each crossover between the nearest measured points: at
#: 2048 curves the fused kernels win to 1,465 rows and the staged routes
#: from 1,865 (within 10% either way to 1,965); at 1024 curves the fused
#: kernels win at 1,865 rows and the staged routes at 3,665; at 256 curves
#: the fused kernels win or come within 3% to 3,665 rows, the staged
#: routes' host work per call weighing more per curve, and the staged
#: routes win at one warp.  Cadences (8,192 to 38,880) did not move the
#: crossover past that margin.
ROUTE_CROSSOVERS = {
    "NVIDIA H100 80GB HBM3": {
        False: ((0, 4096), (1024, 2600), (2048, 1700)),
        True: ((0, 4096), (1024, 2600), (2048, 1700))},
}


def auto_route(rows, curves, weighted, card, fits):
    """The route "auto" takes for a call of ``curves`` curves whose
    periods need ``rows`` fold rows, on the card named ``card`` (``None``
    for the CPU), where ``fits`` says whether a fused block of one warp
    fits its shared memory: the staged route where it does not; on a card
    in :data:`ROUTE_CROSSOVERS`, its crossover; on any other device the
    fused kernel, the stated default.  A pure function of shapes."""
    if not fits:
        return "staged"
    table = ROUTE_CROSSOVERS.get(card)
    if table is None:
        return "fused"
    max_rows = -1
    for min_curves, rows_cap in table[bool(weighted)]:
        if curves >= min_curves:
            max_rows = rows_cap
    return "fused" if rows <= max_rows else "staged"


def fold_route(fold_impl, max_nbins_p, k_max, dtype, device,
               weighted=False, curves=0):
    """The route of one call: ``"fused"`` (K-F, or K-WF when ``weighted``)
    or ``"staged"`` (K-SF and K-U, or K-W).  ``"auto"`` decides from the
    call's shapes on the host, before any launch (:func:`auto_route`): its
    rows (``max_nbins_p + k_max - 1``), its ``curves``, the regime, the
    card and whether a fused block of one warp fits the card's shared
    memory (:func:`.bls_fused.fused_fits`; the kernel then picks its own
    width).  An explicit choice is returned as given."""
    if fold_impl not in FOLD_IMPLS:
        raise ValueError(f"fold_impl must be one of {FOLD_IMPLS} "
                         f"(got {fold_impl!r})")
    if fold_impl != "auto":
        return fold_impl
    device = torch.device(device)
    rows = int(max_nbins_p) + int(k_max) - 1
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else None)
    return auto_route(rows, int(curves), weighted, card,
                      fused_fits(rows, dtype, device, weighted))


#: share of the device's free memory one call of the staged fold may take
STAGED_MEMORY_SHARE = 0.5


def staged_fold_bytes(npad, n, cols, itemsize):
    """Device bytes a staged fold holds for one period: its prefix rows
    (npad, cols) (``cols`` is B for the uniform regime's flux, 2B for the
    weighted regime's ``[w | w*y]``) and its index bytes
    (:func:`.bls_staged_fold.fold_deposits`): per cadence 64 (its fold
    bin and wrap row, and for its two deposits the row, the sorted row,
    the sort's int64 order, its int64 remainder and the int32 source), per
    row 16 (the searched edge, the int64 and int32 row starts) and the
    count prefix."""
    return npad * cols * itemsize + 64 * n + npad * (16 + itemsize)


def _free_device_bytes(device):
    """Bytes the caching allocator can still hand out on ``device``: the
    device's free memory plus what the cache holds unused; ``None`` for the
    CPU (no limit is applied there)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))


def staged_slice(chunk, npad, n, cols, itemsize, free_bytes):
    """Periods per call of the staged fold: at most ``chunk``, at least
    one, and no more than :data:`STAGED_MEMORY_SHARE` of ``free_bytes``
    holds (``None``: ``chunk``).  One period that does not fit still runs,
    and the allocator raises."""
    if free_bytes is None:
        return chunk
    fit = int(STAGED_MEMORY_SHARE * free_bytes
              // staged_fold_bytes(npad, n, cols, itemsize))
    return max(1, min(chunk, fit))


def _staged_scan_uniform(ts, Y0, periods, k_durs, dur_values, d_phase, nbins,
                         max_nbins_p, use_likelihood, chunk, wrap):
    """The staged uniform route: K-SF (:func:`.bls_staged_fold.staged_fold`,
    on one contiguous copy of ``Y0`` per call) then K-U, ``chunk`` periods
    at a time, fewer where the fold's memory (:func:`staged_fold_bytes`)
    would pass the device's free memory (:func:`staged_slice`).  Returns a
    dict of (P, B) count-based statistics, as
    :func:`.bls_fused.fused_scan_uniform` does."""
    n, B = Y0.shape
    tot_y = Y0.sum(0)
    Yc = Y0.contiguous()
    npad = fold_rows(nbins, max_nbins_p, max(k_durs))
    step = staged_slice(chunk, npad, n, B, Y0.element_size(),
                        _free_device_bytes(Y0.device))
    set_attrs(slices=-(-periods.shape[0] // step))
    parts = []
    for i in range(0, periods.shape[0], step):
        pc = periods[i:i + step]
        cs_y, cs_n, nbp = staged_fold(ts, Yc, pc, d_phase, nbins,
                                      max_nbins_p, max(k_durs), wrap)
        parts.append(window_scan_uniform(cs_y, cs_n, nbp, pc, tot_y, float(n),
                                         k_durs, dur_values, d_phase,
                                         use_likelihood))
        del cs_y, cs_n
    return {f: torch.cat([p[f] for p in parts]) for f in parts[0]}


def _bls_shared_scan_uniform(ts, Y0, c_b, periods, k_durs, dur_values,
                             d_phase, nbins, max_nbins_p, use_likelihood,
                             chunk, wrap=True, fold_impl="auto"):
    """Uniform-weights shared-grid scan; Y0 (n, B) mean-shifted flux,
    ``c_b`` (B,) per-curve weights.  Returns a dict of (B, P) tensors."""
    route = fold_route(fold_impl, max_nbins_p, max(k_durs), Y0.dtype,
                       Y0.device, curves=Y0.shape[1])
    set_attrs(route=route, slices=0)
    scan = fused_scan_uniform if route == "fused" else _staged_scan_uniform
    out = scan(ts, Y0, periods, k_durs, dur_values, d_phase, nbins,
               max_nbins_p, use_likelihood, wrap=wrap, chunk=chunk)
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


def _host_f64(x):
    """A grid (tensor or array) as a float64 host array."""
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def bls_power_shared_batch(t, Y, dy, periods, durations, oversample=10,
                           objective="likelihood", chunk=16, nbins=None,
                           d_phase=None, bucket=False, edge_mode="wrap",
                           uniform_weights=None, fold_impl="auto",
                           device=None):
    """Batched BLS for curves sharing ONE time grid.

    Parameters
    ----------
    t : (n,) shared times (tensor or array).
    Y : (B, n) fluxes; its device and dtype set those of the computation.
        A host array goes to ``device`` (default the card; ``"cpu"`` for
        the plain versions); a tensor stays on its device unless
        ``device`` is given.
    dy : (B, n) uncertainties, None, or inf-masked padding.
    periods : (P,) trial periods; durations : (D,) box durations.
    uniform_weights : None (auto-detect on host arrays), True (caller
        asserts per-curve-constant ``dy``), or False (force the weighted
        scan).
    bucket : group trial periods by required histogram size (128-row
        tiles) so short periods don't pay for the longest period's bins.
    edge_mode : 'wrap' (circular windows across the period edge) or
        'astropy' (edge windows truncate against empty padding bins).
    fold_impl : the route of either regime (:func:`fold_route`):
        ``"auto"`` (the fused kernel while a block of one warp fits the
        card's shared memory for the periods of the call, or of each
        ``bucket`` group; the staged route otherwise), ``"fused"`` (K-F
        or K-WF; raises where one curve's rows do not fit) or ``"staged"``
        (K-SF and K-U or K-W).

    Returns a dict of (B, P) tensors: power, depth, depth_err, depth_snr,
    log_likelihood, duration, transit_time, period.

    The duration grid is quantized to ``min(duration)/oversample`` phase
    bins; reported durations are the given values.  Weights are
    normalized to mean 1 for float32 accuracy, and the normalization is
    undone on the outputs.
    """
    with span("bls.prepare"):
        if uniform_weights is None:
            uniform_weights = _detect_uniform_weights(dy)
        Y = on_device(Y, device)
        device, dtype = Y.device, Y.dtype
        t = _as_tensor(t, device)
        # the grid geometry is read on the host: keep a host copy of the
        # periods in the data dtype, and ship host periods without a
        # blocking copy (the sweep runner dispatches its next chunk before
        # it waits)
        np_dtype = numpy_dtype(dtype)
        if isinstance(periods, torch.Tensor):
            periods = periods.to(device=device, dtype=dtype)
            p_host = periods.cpu().numpy()
        else:
            p_host = np.ascontiguousarray(periods, dtype=np_dtype)
            periods = torch.from_numpy(p_host)
            if device.type == "cuda":
                periods = periods.pin_memory().to(device, non_blocking=True)
        durations_np = _host_f64(durations)
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
            # mean-shift the flux: depth is shift-invariant, and the fold
            # then sums w·(y−μ) relative to the transit signal, not the
            # continuum
            mu = ((Wn * Y).sum(1)
                  / torch.clamp(Wn.sum(1), min=1e-30))[:, None]
        else:
            if dy is None:
                c_b = torch.ones((B,), dtype=dtype, device=device)
            else:
                dy0 = _as_tensor(dy, device, dtype)[:, 0]
                c_b = torch.where(torch.isfinite(dy0),
                                  1.0 / torch.square(dy0), 0.0)
            mu = Y.mean(1, keepdim=True)
        t_min = t.min()
        ts = (t - t_min).to(dtype)

        if d_phase is None:
            d_phase = float(durations_np.min()) / oversample
        if nbins is None:
            nbins = int(np.ceil(float(np.max(p_host)) / d_phase))
        # round-half-UP (+0.5 truncation), never Python round()'s banker's
        # rounding of half-bin ties
        k_durs = tuple(int(max(int(d / d_phase + 0.5), 1))
                       for d in durations_np)
        dvals = tuple(float(d) for d in durations_np)
        k_max = max(k_durs)

        # (n, B) views of (B, n) tensors: the layout the fused kernels read;
        # the staged route copies them to contiguous (n, cols) once per call
        if uniform_weights:
            scan, cols = _bls_shared_scan_uniform, ((Y - mu).T, c_b)
        else:
            scan, cols = _bls_shared_scan, (Wn.T, (Wn * (Y - mu)).T)

    def run(p_sub, p_sub_host, nb):
        # the host copy bounds the bins per period without a device read
        max_nbp = max_nbins_bound(p_sub_host, d_phase, dtype)
        with span("bls.search", rows=int(max_nbp) + k_max - 1, curves=B,
                  periods=len(p_sub_host)):
            return scan(ts, *cols, p_sub, k_durs, dvals, float(d_phase),
                        int(nb), max_nbp, use_likelihood, chunk, wrap=wrap,
                        fold_impl=fold_impl)

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


# ---------------------------------------------------------------------------
# Per-curve BLS: every curve folds on its own time grid.  The reference
# vmaps a one-curve function over the batch; here the curves (and a chunk
# of periods) are batch dimensions of plain torch ops.
# ---------------------------------------------------------------------------
def _mod(x, y):
    """``x mod y`` as the reference computes it: the exact ``fmod``, moved
    into the divisor's sign (``torch.remainder`` rounds differently)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _curve_inputs(t, y, dy, periods, durations):
    """Tensors (B, n) of times from each curve's first sample, weights and
    weighted fluxes; each curve's first time; the periods and durations.
    The weights and weighted fluxes are in the data dtype (of the tensor
    ``y``); the fold's geometry -- times, periods, durations -- is float64
    whatever it is, and host times lose their origin before any cast: in
    float32 a BTJD time rounds to ~1e-4 d, and a sample on a bin or
    window edge (on a regular cadence grid, every few cadences of a
    period's first cycle) falls on either side (ROADMAP C3)."""
    device, dtype, f64 = y.device, y.dtype, torch.float64
    if isinstance(t, torch.Tensor):
        t = t.to(device=device, dtype=f64)
        t_min = t.min(-1, keepdim=True).values
        ts = t - t_min
    else:
        t = np.asarray(t, dtype=np.float64)
        t_host = t.min(-1, keepdims=True)
        ts = torch.as_tensor(t - t_host, device=device)
        t_min = torch.as_tensor(t_host, device=device)
    w = (torch.ones_like(y) if dy is None
         else 1.0 / torch.square(_as_tensor(dy, device, dtype)))
    return (ts, w, w * y, t_min, _as_tensor(periods, device, f64),
            _as_tensor(durations, device, f64))


def _batched(fn, t, y, dy, *args):
    """Run ``fn`` on (B, n) curves; a 1-D curve comes back without the
    batch axis."""
    one = np.ndim(y) == 1
    if one:
        y = y[None]
        t = t[None] if np.ndim(t) == 1 else t
        dy = dy if dy is None else dy[None]
    out = fn(t, y, dy, *args)
    return {k: v[0] for k, v in out.items()} if one else out


def _periods_per_step(B, work, budget=2 ** 25):
    """Periods per batched step so (B, periods, work) intermediates stay
    near ``budget`` elements."""
    return max(1, budget // max(B * work, 1))


def _range_sums(ph_sorted, cw, cwy, lo, hi, period, total_w, total_wy):
    """Σw, Σwy over phases in the OPEN interval (lo, hi) mod period.
    ph_sorted (..., n), cw / cwy (..., n + 1), lo / hi (..., Q)."""
    lo_m = _mod(lo, period)
    hi_m = _mod(hi, period)
    i_lo = torch.searchsorted(ph_sorted, lo_m.contiguous(), right=True)
    i_hi = torch.searchsorted(ph_sorted, hi_m.contiguous(), right=False)
    c_lo_w, c_hi_w = torch.gather(cw, -1, i_lo), torch.gather(cw, -1, i_hi)
    c_lo_wy = torch.gather(cwy, -1, i_lo)
    c_hi_wy = torch.gather(cwy, -1, i_hi)
    # non-wrapping: (lo_m, hi_m); wrapping: (lo_m, P) ∪ [0, hi_m)
    wraps = lo_m >= hi_m
    w_in = torch.where(wraps, (total_w - c_lo_w) + c_hi_w, c_hi_w - c_lo_w)
    wy_in = torch.where(wraps, (total_wy - c_lo_wy) + c_hi_wy,
                        c_hi_wy - c_lo_wy)
    return w_in, wy_in


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


def _bls_one_period(ts, w, wy, pc, t0_grid, durations, use_likelihood):
    """Best-fit box statistics of B curves at C periods: ts, w, wy (B, n),
    pc (C,).  Returns a dict of (B, C) tensors."""
    B, n = w.shape
    C, D = pc.shape[0], durations.shape[0]
    phase = _mod(ts[:, None, :], pc[None, :, None])            # (B, C, n)
    ph_s, order = torch.sort(phase, dim=-1, stable=True)
    cw, cwy = _sorted_prefix(w, wy, order)
    total_w, total_wy = cw[..., n:], cwy[..., n:]
    # windows centred at t0 with width d: open interval (t0-d/2, t0+d/2),
    # flattened t0-major as (T0, D)
    lo = (t0_grid[:, None] - durations[None, :] / 2.0).reshape(-1)
    hi = (t0_grid[:, None] + durations[None, :] / 2.0).reshape(-1)
    period = pc[None, :, None]
    w_in, wy_in = _range_sums(ph_s, cw, cwy, lo.expand(B, C, -1),
                              hi.expand(B, C, -1), period, total_w, total_wy)
    w_out = total_w - w_in
    wy_out = total_wy - wy_in
    ok = (w_in > 0) & (w_out > 0)
    w_in_s = torch.where(ok, w_in, 1.0)
    w_out_s = torch.where(ok, w_out, 1.0)
    depth = wy_out / w_out_s - wy_in / w_in_s
    depth_err = torch.sqrt(1.0 / w_in_s + 1.0 / w_out_s)
    snr = depth / depth_err
    loglike = 0.5 * w_in_s * depth * depth
    objective = loglike if use_likelihood else snr
    # mask t0 beyond one period (the grid is sized for the longest period)
    t0_ok = (t0_grid[None, :, None] < pc[:, None, None]).expand(
        C, t0_grid.shape[0], D).reshape(C, -1)
    objective = torch.where(ok & t0_ok, objective, -torch.inf)
    best = torch.argmax(objective, dim=-1)                      # first max
    return dict(power=_take(objective, best), depth=_take(depth, best),
                depth_err=_take(depth_err, best),
                depth_snr=_take(snr, best),
                log_likelihood=_take(loglike, best),
                duration=durations[best % D], transit_time=t0_grid[best // D])


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


def _bls_scan(ts, w, wy, periods, durations, d_phase, use_likelihood, chunk,
              t0_count):
    t0_grid = torch.arange(t0_count, device=w.device, dtype=ts.dtype) * d_phase
    parts = [_bls_one_period(ts, w, wy, periods[i:i + chunk], t0_grid,
                             durations, use_likelihood)
             for i in _chunks(periods, chunk)]
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}


def bls_power(t, y, dy, periods, durations, oversample=10,
              objective="likelihood", chunk=None, t0_count=None,
              d_phase=None, device=None):
    """Exact BLS periodogram over a period grid, one fold per curve.

    t, y : (n,) one curve, or (B, n) curves each on its own time grid.
        A host array ``y`` goes to ``device`` (default the card; ``"cpu"``
        for plain torch there), a tensor stays on its device unless
        ``device`` is given.
    dy : uncertainties of the same shape, or None (uniform); ``dy = inf``
        excludes a sample.
    periods, durations : 1-D grids.  oversample : t0 spacing is
    min(durations)/oversample.  chunk : periods per batched step (default:
    sized from the batch).  Returns a dict of (P,) or (B, P) tensors:
    power, depth, depth_err, depth_snr, log_likelihood, duration,
    transit_time (absolute), period.
    """
    if d_phase is None:
        d_phase = float(_host_f64(durations).min()) / oversample
    if t0_count is None:
        t0_count = int(np.ceil(float(_host_f64(periods).max())
                               / d_phase)) + 1

    def run(t, y, dy):
        ts, w, wy, t_min, pc, durs = _curve_inputs(t, y, dy, periods,
                                                   durations)
        step = chunk or _periods_per_step(w.shape[0], max(
            w.shape[1], t0_count * durs.shape[0]))
        set_attrs(chunks=-(-pc.shape[0] // step))
        out = _bls_scan(ts, w, wy, pc, durs, d_phase,
                        objective == "likelihood", step, t0_count)
        out["transit_time"] = out["transit_time"] + t_min
        out["period"] = pc[None, :].expand(w.shape[0], pc.shape[0])
        return {k: v.to(w.dtype) for k, v in out.items()}

    with span("bls.curve", route="exact", periods=np.shape(periods)[0]):
        return _batched(run, t, on_device(y, device), dy)


# The sorted-phase search IS the exact ("direct") objective.
bls_power_direct = bls_power


def bls_objective_single(t, y, dy, period, duration, transit_time,
                         use_likelihood=True, device=None):
    """Box statistics of one curve at ONE (period, duration, transit
    time), as ``compute_stats`` and ``get_transit_model`` of a BLS
    periodogram read them: a dict of depth, depth_err, depth_snr,
    log_likelihood, y_in, y_out (0-d tensors) and the (n,) boolean
    in_transit.  ``y``'s device and dtype set the computation's: a host
    array ``y`` goes to ``device`` (default the card), a tensor stays on
    its device unless ``device`` is given.  ``use_likelihood`` is
    accepted as the reference's signature has it and changes nothing."""
    y = on_device(y, device)
    device, dtype = y.device, y.dtype
    t = _as_tensor(t, device, dtype)
    w = (torch.ones_like(y) if dy is None
         else 1.0 / torch.square(_as_tensor(dy, device, dtype)))
    period, duration, transit_time = (
        torch.as_tensor(v, dtype=dtype, device=device)
        for v in (period, duration, transit_time))
    hp = 0.5 * period
    in_t = torch.abs(_mod(t - transit_time + hp, period) - hp) \
        < 0.5 * duration
    w_in = torch.sum(torch.where(in_t, w, 0.0))
    w_out = torch.sum(torch.where(in_t, 0.0, w))
    y_in = torch.sum(torch.where(in_t, w * y, 0.0)) / w_in
    y_out = torch.sum(torch.where(in_t, 0.0, w * y)) / w_out
    depth = y_out - y_in
    depth_err = torch.sqrt(1.0 / w_in + 1.0 / w_out)
    return dict(depth=depth, depth_err=depth_err, depth_snr=depth / depth_err,
                log_likelihood=0.5 * w_in * depth * depth,
                y_in=y_in, y_out=y_out, in_transit=in_t)


def _bls_one_period_binned(ts, w, wy, pc, durations, d_phase, nbins,
                           use_likelihood, wrap=True, reciprocal=False):
    """Binned box search of B curves at C periods: ts, w, wy (B, n), pc
    (C,).  Fold bins are ``clip(trunc(phase / d_phase), 0, nbins - 1)``,
    or with ``reciprocal`` the product with 1/d_phase rounded in the
    geometry's dtype (float64, :func:`_curve_inputs`).  The per-bin sums
    come from each curve's samples sorted by bin and a cumulative sum
    (deterministic, no float atomics).  Returns a dict of (B, C) float64
    tensors."""
    B = w.shape[0]
    C, D = pc.shape[0], durations.shape[0]
    dev = w.device
    phase = _mod(ts[:, None, :], pc[None, :, None])
    pos = phase * (1.0 / d_phase) if reciprocal else phase / d_phase
    ids = torch.clamp(pos.to(torch.int64), 0, nbins - 1)
    ids_s, order = torch.sort(ids, dim=-1, stable=True)         # (B, C, n)
    cw_s, cwy_s = _sorted_prefix(w, wy, order)
    # bin prefix cw[b] = Σ over samples with ids < b, b = 0..nbins
    edges = torch.arange(nbins + 1, device=dev).expand(B, C, -1)
    first = torch.searchsorted(ids_s, edges.contiguous(), right=False)
    cw = torch.gather(cw_s, -1, first)                          # (B, C, nb+1)
    cwy = torch.gather(cwy_s, -1, first)
    nbins_p = torch.clamp(torch.ceil(pc / d_phase).to(torch.int64),
                          max=nbins)                            # (C,)
    nbp = nbins_p[None, :, None]
    total_w = torch.gather(cw, -1, nbp.expand(B, C, 1))
    total_wy = torch.gather(cwy, -1, nbp.expand(B, C, 1))

    k_durs = torch.clamp((durations / d_phase + 0.5).to(torch.int64), min=1)
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
    i0, id_ = best // D, best % D
    # mid-transit of the binned window, wrapped into [0, period)
    t0 = (starts[i0].to(ts.dtype) + 0.5 * k_durs[id_].to(ts.dtype)) * d_phase
    period = pc[None, :]
    t0 = t0 - torch.floor(t0 / period) * period
    return dict(power=flat(objective), depth=flat(depth),
                depth_err=flat(depth_err), depth_snr=flat(snr),
                log_likelihood=flat(loglike), duration=durations[id_],
                transit_time=t0)


def _bls_scan_binned(ts, w, wy, periods, durations, d_phase, use_likelihood,
                     chunk, nbins, wrap=True, reciprocal=False):
    parts = [_bls_one_period_binned(ts, w, wy, periods[i:i + chunk],
                                    durations, d_phase, nbins,
                                    use_likelihood, wrap=wrap,
                                    reciprocal=reciprocal)
             for i in _chunks(periods, chunk)]
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}


def bls_power_binned(t, y, dy, periods, durations, oversample=10,
                     objective="likelihood", chunk=None, nbins=None,
                     d_phase=None, edge_mode="wrap", device=None):
    """Binned BLS periodogram (the fast per-curve path; same arguments,
    ``device`` included, and outputs as :func:`bls_power`), with transit
    boundaries quantized to min(duration)/oversample phase bins as
    astropy's kernel does.

    ``edge_mode``: 'wrap' (default) evaluates circular windows across the
    period edge; 'astropy' truncates edge windows against empty padding
    bins, as the astropy kernel does.
    """
    return _binned(t, on_device(y, device), dy, periods, durations,
                   oversample, objective, chunk, nbins, d_phase, edge_mode)


def _binned(t, y, dy, periods, durations, oversample=10,
            objective="likelihood", chunk=None, nbins=None, d_phase=None,
            edge_mode="wrap", reciprocal=False):
    """:func:`bls_power_binned`; ``reciprocal`` places samples in bins by
    the product with the dtype-rounded 1/d_phase, as the reference's
    compiled sweep step does (there d_phase is a constant, which its
    compiler turns into that product), where the standalone reference call
    divides (d_phase is a traced argument there)."""
    if d_phase is None:
        d_phase = float(_host_f64(durations).min()) / oversample
    if nbins is None:
        nbins = int(np.ceil(float(_host_f64(periods).max()) / d_phase))

    def run(t, y, dy):
        ts, w, wy, t_min, pc, durs = _curve_inputs(t, y, dy, periods,
                                                   durations)
        # d_phase in the geometry's dtype (float64)
        dp = torch.tensor(d_phase, dtype=ts.dtype, device=w.device)
        step = chunk or _periods_per_step(w.shape[0], max(
            w.shape[1], nbins * durs.shape[0]))
        set_attrs(chunks=-(-pc.shape[0] // step))
        out = _bls_scan_binned(ts, w, wy, pc, durs, dp,
                               objective == "likelihood", step, nbins,
                               wrap=edge_mode != "astropy",
                               reciprocal=reciprocal)
        out["transit_time"] = out["transit_time"] + t_min
        out["period"] = pc[None, :].expand(w.shape[0], pc.shape[0])
        return {k: v.to(w.dtype) for k, v in out.items()}

    with span("bls.curve", route="binned", periods=np.shape(periods)[0]):
        return _batched(run, t, y, dy)
