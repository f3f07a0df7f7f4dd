"""Drive lightkurve_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. build the CUDA kernels (K-F, K-WF, K-W, K-U, K-SF) from the
     checkout's sources, one nvcc per source, all started together;
  2. hold each kernel against its plain torch version on the card at a
     small shape, in float64 (exact logic) and float32, over both edge
     modes and objectives, and at the tile-edge grid where a period needs
     one bin more than the host count (rows sized from the bound: equal;
     sized from the count: NaN, as the plain versions give); K-W and K-U
     also at a ragged batch (250 curves) and with ten durations up to
     2.5 d; the fused kernels and K-SF give the same bits on two runs, and
     K-SF's empty astropy-mode rows repeat the row before them bit for
     bit;
  3. uniform main path at full size: a 2048-file synthetic TESS sector
     written with the port's FITS writer, streamed through
     StreamingStackLoader into SweepRunner(method="shared");
  4. weighted main path at full size: a SPOC-like in-memory stack
     (per-cadence dy, ~3% masked cadences) through SweepRunner; then its
     first chunk through bls_power_shared_batch on both routes, each a
     path of its own: fold_impl="fused" (K-WF) and "staged" (K-SF and
     K-W), whose winners must agree, their power gaps within C2's float32
     rounding bound;
  6. the long-baseline uniform sweeps, 2048 curves, 4,096 periods in four
     chunks each: one 27-d sector (19,440 cadences) over 1-9 d, and two
     consecutive sectors (38,880 cadences) over 1-18 d; then the
     two-sector chunk 4 through bls_power_shared_batch on both routes,
     each a path of its own: "fused" (K-F) and "staged" (K-SF and K-U);
  7. the mixed-grid sweep: 2048 SPOC-like curves on four sector grids,
     one shared-grid search per grid, held against four single-grid
     sweeps of the same rows;
  8. the per-curve methods, SweepRunner(method="fast") and "exact", at
     2048 x 8192 (plain torch, no kernel);
 10. flatten, then search: 2048 SPOC-like curves over a 27-d sector
     (19,440 cadences, a 1-d downlink gap, a stellar trend per curve,
     outliers, ~3% masked) in float32 through LightCurveStack.flatten
     (window 901, TF32 flags at PyTorch's defaults; timed, with its peak
     memory, and at window 101), then SweepRunner(method="shared") over
     1-9 d in four chunks on the per-cadence weights the flatten leaves;
     the flatten held float64 on the card against float64 on the CPU (64
     curves) and float32 against float64 on the card; then the same
     sector with deep transits and faster rotators, whose recovery after
     the flatten is logged with lightkurve_tpu's 16 tracked segments and
     with 64 (the reference flatten's limits);
  9. one call past the one-hot fold's old memory ceiling: a year of
     two-minute cadences (262,800) x 2048 curves in float32, 4 periods
     near 300 d (~60,000 rows), through bls_power_shared_batch on the
     automatic route, which must take the staged one (K-SF and K-U); then
     the same scan against the plain versions on the card, 2 periods per
     slice;
  5. each kernel against its plain version at its main path's shapes, in
     float64 and float32, timed in float32, with its bound (the larger of
     bytes over the memory rate and operations over the float32 rate), the
     staged kernels also per launch at the width the staged route launches
     them (8 periods) and K-W and K-U with one duration beside all: K-F,
     K-WF and K-W on the 8,192-cadence batch, K-U and K-SF on the two-sector
     sweep's chunk 4 (K-SF also against the one-hot fold it replaced, its
     library yardstick), K-F (float32) on both long sweeps' chunk 4; and
     both routes at the route points (every chunk of the sweeps of phases
     3, 4, 6 and 10, the longest of each cadence count also at 256 curves,
     16.4-16.9 d on one sector, and where a fused block holds one warp):
     one SweepRunner chunk's wall time per route through the entry point
     (the staged route at 8 periods per call), the route "auto" takes,
     the winners per (period, curve) against each other and C2's bound.
Each path (the sweeps of phases 3, 4, 6, 7, 8 and 10 on the automatic
route, the four forced-route runs of phases 4 and 6, and phase 9) runs
with every launch count set to 0 just before it and read just after; a
path fails if a plain version ran, and a sweep fails unless its launches
are what the route rule (ops.bls.fold_route) gives its chunks.  The
kernels line gives each kernel's launches summed over the paths and,
under ``launches_by_path``, each path's own.

Prints the card, a JSON line of kernel records, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure, and
when no CUDA device is present.

    python3 chip_smoke.py --profile

builds the kernels and profiles one full-size sweep chunk per shared-grid
cell, phase 10's flatten and two forced-route chunks instead
(torch.profiler: device time per kernel, the device's idle share, each
kernel's bound over the chunk).
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the north-star search configuration (tools/northstar_run.py)
DURATIONS = np.array([0.05, 0.10, 0.15, 0.20, 0.25, 0.33])
OVERSAMPLE = 10

F64_RTOL = 1e-9
F32_WINNER_SHARE = 0.999
F32_RTOL = 1e-3
RECOVERY_SHARE = 0.99
RECOVERY_RTOL = 0.01
#: K-SF against its plain version: a prefix row may differ by this share of
#: its column's sum of |x| (absolute, as a mean-shifted prefix crosses
#: zero).  The kernel sums each column sequentially and torch's cumsum on
#: the card by a parallel scan; in float32 the two orders drift apart by
#: about eps x sqrt(deposits) of the running sum
F64_FOLD_TOL = 1e-12
F32_FOLD_TOL = 1e-4

def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def start_sweep():
    """Wait for queued device work and reset the peak memory count."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def peak_memory():
    import torch
    gib = torch.cuda.max_memory_allocated() / 2**30
    return f"peak device memory {gib:.3f} GiB allocated"


def cuda_time_ms(fn, reps=3):
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    from lightkurve_tpu_torch.io import native
    from lightkurve_tpu_torch.ops import _build
    t0 = time.time()
    _build.cuda_library()
    t_cuda = time.time() - t0
    t0 = time.time()
    native.library()
    t_fits = time.time() - t0
    log(f"build: CUDA kernels {t_cuda:.2f}s, FITS reader {t_fits:.2f}s")
    for line in _build.build_log("lk_bls_kernels").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_inputs(dtype, B=256, n=2048, P=257, seed=7):
    """Shared-grid inputs at the check shape: injected transits, per-
    cadence dy with ~3% masked cadences, the north-star durations."""
    import torch
    from lightkurve_tpu_torch.ops.bls_fused_weighted import weighted_fold
    from lightkurve_tpu_torch.ops.bls_fused import (max_nbins_bound,
                                                    uniform_fold)
    from tools import make_sector as ms
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    t = ms.time_grid()[:n]
    Y = 1.0 + ms.NOISE * rng.standard_normal((B, n))
    p_inj = rng.uniform(0.4, 0.9, B)
    t0_inj = rng.uniform(0, p_inj)
    for i in range(B):
        ph = np.mod(t - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        Y[i, np.abs(ph) < 0.05] -= ms.DEPTH
    dy = ms.NOISE * rng.uniform(0.8, 1.25, (B, n))
    dy[rng.random((B, n)) < 0.03] = np.inf
    periods = np.linspace(0.4, (t[-1] - t[0]) / 3, P)
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in DURATIONS)
    ts = torch.as_tensor(t - t.min(), dtype=dtype, device=dev)
    Yt = torch.as_tensor(Y, dtype=dtype, device=dev)
    pc = torch.as_tensor(periods, dtype=dtype, device=dev)
    nbins = int(np.ceil(float(pc.max()) / d_phase))
    max_nbp = max_nbins_bound(pc.cpu().numpy(), d_phase, dtype)
    Y0 = (Yt - Yt.mean(1, keepdim=True)).T.contiguous()
    W = 1.0 / torch.square(torch.as_tensor(dy, dtype=dtype, device=dev))
    W = W / W[torch.isfinite(W)].mean()
    W = torch.where(torch.isfinite(W), W, 0.0)
    mu = (W * Yt).sum(1, keepdim=True) / W.sum(1, keepdim=True)
    WWY = torch.cat([W.T, (W * (Yt - mu)).T], 1).contiguous()
    total = WWY.sum(0)
    folds, ufolds = {}, {}
    for wrap in (True, False):
        parts = [weighted_fold(ts, WWY, pc[i:i + 64], d_phase, nbins,
                                max_nbp, max(k_durs), wrap)
                 for i in range(0, P, 64)]
        folds[wrap] = (torch.cat([c for c, _ in parts]).contiguous(),
                       torch.cat([b for _, b in parts]).contiguous())
        parts = [uniform_fold(ts, Y0, pc[i:i + 64], d_phase, nbins, max_nbp,
                              max(k_durs), wrap) for i in range(0, P, 64)]
        ufolds[wrap] = tuple(torch.cat([p[j] for p in parts]).contiguous()
                             for j in range(3))
    return dict(ts=ts, Y0=Y0, pc=pc, k_durs=k_durs,
                dur_values=tuple(float(d) for d in DURATIONS),
                d_phase=d_phase, nbins=nbins, max_nbp=max_nbp, total=total,
                WWY=WWY, folds=folds, ufolds=ufolds)


def compare_fold(name, got, want, X, f64, step=16):
    """K-SF's result (prefix rows, count prefix, bins per period) against
    its plain version's on the columns ``X`` (n, cols): the count prefix
    and the bins exactly, the prefix rows within the fold bar (periods
    compared ``step`` at a time).  Returns the max |prefix row error|."""
    import torch
    (cs, cn, nbp), (ws, wn, wnbp) = got, want
    if not (torch.equal(cn, wn) and torch.equal(nbp, wnbp)):
        raise AssertionError(f"{name}: count prefix or bins differ")
    scale = X.abs().sum(0).clamp(min=torch.finfo(X.dtype).tiny)
    err = share = 0.0
    for i in range(0, cs.shape[0], step):
        d = (cs[i:i + step] - ws[i:i + step]).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / scale).max()))
    tol = F64_FOLD_TOL if f64 else F32_FOLD_TOL
    log(f"  {name}: max |prefix error| {err:.3g}, {share:.3g} of the "
        f"column's sum |x| (bar {tol:g})")
    if share > tol:
        raise AssertionError(f"{name}: prefix rows off by {share:.3g} of "
                             f"the column's sum |x|")
    return err


def check_empty_rows(fold):
    """K-SF's astropy-mode fold (no wrap deposits): every row from a
    period's last deposit on holds the same bits, across the segments the
    kernel cuts its rows into (the exact ties of truncated windows)."""
    cs, cn, _ = fold
    tail = (cn == cn[:, -1:])[..., None]
    if not bool(((cs == cs[:, -1:]) | ~tail).all()):
        raise AssertionError("K-SF: an empty row differs from the row "
                             "before it")


def compare(name, got, want, f64):
    """Kernel result ``got`` against plain ``want`` (dicts of (C, B)).
    Returns (max |power error| over agreeing cells, max relative error)."""
    g = {k: v.double().cpu().numpy() for k, v in got.items()}
    w = {k: v.double().cpu().numpy() for k, v in want.items()}
    for k in w:
        if not np.array_equal(np.isfinite(g[k]), np.isfinite(w[k])):
            raise AssertionError(f"{name}: -inf/finite pattern differs in {k}")
    fin = np.isfinite(w["power"])
    same = ((g["duration"] == w["duration"])
            & (g["transit_time"] == w["transit_time"]))
    flips = fin & ~same
    if f64:
        same_or_tie = same | ~fin
        if flips.any():
            for c, b in zip(*np.nonzero(flips)):
                log(f"  {name}: winner flip at period {c} curve {b}: power "
                    f"{g['power'][c, b]!r} vs {w['power'][c, b]!r}, "
                    f"dur {g['duration'][c, b]} vs {w['duration'][c, b]}, "
                    f"t0 {g['transit_time'][c, b]!r} vs "
                    f"{w['transit_time'][c, b]!r}")
            rel = np.abs(g["power"] - w["power"]) / np.abs(w["power"])
            if np.any(rel[flips] > F64_RTOL):
                raise AssertionError(f"{name}: f64 winner flip beyond a tie")
        mask = same_or_tie
        for k in w:
            a, b = g[k][mask & np.isfinite(w[k])], w[k][mask & np.isfinite(
                w[k])]
            if not np.allclose(a, b, rtol=F64_RTOL, atol=1e-12):
                bad = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
                raise AssertionError(f"{name}: f64 {k} off by rel {bad:.3g}")
    else:
        share = 1.0 - flips.sum() / max(fin.sum(), 1)
        log(f"  {name}: f32 identical winners in {share:.6f} of "
            f"{fin.sum()} finite cells ({flips.sum()} differ)")
        if share < F32_WINNER_SHARE:
            raise AssertionError(f"{name}: f32 winner share {share:.6f} < "
                                 f"{F32_WINNER_SHARE}")
    m = fin & same
    err = np.abs(g["power"][m] - w["power"][m])
    rel = {k: float(np.max(np.abs(g[k][m] - w[k][m])
                           / np.maximum(np.abs(w[k][m]), 1e-300)))
           for k in ("power", "depth")}
    log(f"  {name}: max rel err power {rel['power']:.3g}, depth "
        f"{rel['depth']:.3g}; max abs err power {err.max():.3g}")
    if not f64 and max(rel.values()) > F32_RTOL:
        raise AssertionError(f"{name}: f32 rel error {rel} > {F32_RTOL}")
    return float(err.max()), max(rel.values())


def phase_kernels():
    """K-F, K-WF, K-W and K-U against their plain versions, both edge
    modes and both objectives, and K-SF over both regimes' columns in both
    edge modes, float64 then float32.  Returns per-kernel f32 errors."""
    import torch
    from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                          bls_staged_fold, bls_window)
    errs = {"K-F": 0.0, "K-WF": 0.0, "K-W": 0.0, "K-U": 0.0, "K-SF": 0.0}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        x = check_inputs(dtype)
        C, npad, twoB = x["folds"][True][0].shape
        B = twoB // 2
        log(f"check {dtype}: B={B} n={x['ts'].shape[0]} P={C} "
            f"nbins={x['nbins']} k_durs={x['k_durs']}")
        common = (x["k_durs"], x["dur_values"], x["d_phase"])
        W, WY = (x["WWY"][:, :B].contiguous(), x["WWY"][:, B:].contiguous())
        for wrap in (True, False):
            for like in (True, False):
                tag = f"{'wrap' if wrap else 'astropy'}/" \
                      f"{'likelihood' if like else 'snr'}"
                e = {}
                for name, kern, plain, args in (
                        ("K-F", bls_fused.fused_scan_uniform,
                         bls_fused.fused_scan_uniform_plain,
                         (x["ts"], x["Y0"], x["pc"], *common, x["nbins"],
                          x["max_nbp"], like, wrap)),
                        ("K-WF", bls_fused_weighted.fused_scan_weighted,
                         bls_fused_weighted.fused_scan_weighted_plain,
                         (x["ts"], W, WY, x["pc"], *common, x["nbins"],
                          x["max_nbp"], like, wrap)),
                        ("K-W", bls_window.window_scan,
                         bls_window.window_scan_plain,
                         (*x["folds"][wrap], x["pc"], x["total"], *common,
                          like)),
                        ("K-U", bls_window.window_scan_uniform,
                         bls_window.window_scan_uniform_plain,
                         (*x["ufolds"][wrap], x["pc"], x["Y0"].sum(0),
                          float(x["Y0"].shape[0]), *common, like))):
                    got, want = kern(*args), plain(*args)
                    torch.cuda.synchronize()
                    e[name], _ = compare(f"{name} {tag}", got, want, f64)
                if not f64:
                    for name, v in e.items():
                        errs[name] = max(errs[name], v)
            for cols, X in (("flux", x["Y0"]), ("[w | w*y]", x["WWY"])):
                args = (x["ts"], X, x["pc"], x["d_phase"], x["nbins"],
                        x["max_nbp"], max(x["k_durs"]), wrap)
                got = bls_staged_fold.staged_fold(*args)
                e = compare_fold(
                    f"K-SF {'wrap' if wrap else 'astropy'}/{cols}", got,
                    bls_staged_fold.staged_fold_plain(*args), X, f64)
                if not f64:
                    errs["K-SF"] = max(errs["K-SF"], e)
                if not wrap:
                    check_empty_rows(got)
    log("  K-SF: in astropy mode every row past a period's last deposit "
        "repeats that row bit for bit")
    check_tile_edge()
    check_ragged()
    check_long_durations()
    check_deterministic()
    return errs


def check_long_durations(B=256, n=2048, seed=13):
    """K-W and K-U with ten durations up to 2.5 d (k_max 500 bins) at
    periods of 2.6-2.8 d: past eight durations the scans keep 32 running
    bests, and where a tile of rows and its 500-row halo outgrow the
    shared-memory budget (float64 K-W and K-U, float32 K-W) they read
    their rows from global memory.  Against the plain versions, float64
    and float32."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    from lightkurve_tpu_torch.ops.bls_fused_weighted import weighted_fold
    from tools import make_sector as ms
    rng = np.random.default_rng(seed)
    t = ms.time_grid()[:n]
    durations = np.linspace(0.05, 2.5, 10)
    d_phase = float(durations.min()) / OVERSAMPLE
    k_durs = tuple(int(d / d_phase + 0.5) for d in durations)
    common = (k_durs, tuple(float(d) for d in durations), d_phase)
    periods = np.linspace(2.6, 2.8, 9)
    nbins = int(np.ceil(periods.max() / d_phase))
    for dtype in (torch.float64, torch.float32):
        ts = torch.as_tensor(t - t.min(), dtype=dtype, device="cuda")
        Y = torch.as_tensor(1.0 + ms.NOISE * rng.standard_normal((n, B)),
                            dtype=dtype, device="cuda")
        Y0 = Y - Y.mean(0)
        pc = torch.as_tensor(periods, dtype=dtype, device="cuda")
        bound = bls_fused.max_nbins_bound(periods, d_phase, dtype)
        WWY = torch.cat([torch.ones_like(Y0), Y0], 1)
        csum, nbp = weighted_fold(ts, WWY, pc, d_phase, nbins, bound,
                                  max(k_durs))
        args = (csum, nbp, pc, WWY.sum(0), *common)
        cs_y, cs_n, unbp = bls_fused.uniform_fold(ts, Y0, pc, d_phase, nbins,
                                                  bound, max(k_durs))
        uargs = (cs_y, cs_n, unbp, pc, Y0.sum(0), float(n), *common)
        f64 = dtype == torch.float64
        compare(f"K-W ten durations {dtype}", bls_window.window_scan(*args),
                bls_window.window_scan_plain(*args), f64)
        compare(f"K-U ten durations {dtype}",
                bls_window.window_scan_uniform(*uargs),
                bls_window.window_scan_uniform_plain(*uargs), f64)


def check_ragged(B=250):
    """K-W and K-U on B curves, B not a multiple of a block's 32: the last
    block's curves past B read nothing and its rows take the per-value
    copies; float64, against the plain versions."""
    import torch
    from lightkurve_tpu_torch.ops import bls_window
    x = check_inputs(torch.float64)
    full = x["Y0"].shape[1]
    common = (x["k_durs"], x["dur_values"], x["d_phase"])
    for wrap in (True, False):
        csum, nbp = x["folds"][wrap]
        csum = torch.cat([csum[..., :B], csum[..., full:full + B]],
                         -1).contiguous()
        total = torch.cat([x["total"][:B], x["total"][full:full + B]])
        args = (csum, nbp, x["pc"], total, *common)
        compare(f"K-W B={B}", bls_window.window_scan(*args),
                bls_window.window_scan_plain(*args), True)
        cs_y, cs_n, unbp = x["ufolds"][wrap]
        uargs = (cs_y[..., :B].contiguous(), cs_n, unbp, x["pc"],
                 x["Y0"][:, :B].sum(0), float(x["Y0"].shape[0]), *common)
        compare(f"K-U B={B}", bls_window.window_scan_uniform(*uargs),
                bls_window.window_scan_uniform_plain(*uargs), True)


def check_deterministic():
    """The fused kernels and K-SF sum in a fixed order (no float
    atomics): two runs on the same inputs give the same bits."""
    import torch
    from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                          bls_staged_fold)
    x = check_inputs(torch.float32)
    B = x["Y0"].shape[1]
    common = (x["k_durs"], x["dur_values"], x["d_phase"], x["nbins"],
              x["max_nbp"])
    W, WY = (x["WWY"][:, :B].contiguous(), x["WWY"][:, B:].contiguous())
    for name, fn, args in (
            ("K-F", bls_fused.fused_scan_uniform,
             (x["ts"], x["Y0"], x["pc"], *common)),
            ("K-WF", bls_fused_weighted.fused_scan_weighted,
             (x["ts"], W, WY, x["pc"], *common))):
        a, b = fn(*args), fn(*args)
        if not all(torch.equal(a[f], b[f]) for f in a):
            raise AssertionError(f"{name}: two runs differ")
    fold = (x["ts"], x["WWY"], x["pc"], x["d_phase"], x["nbins"],
            x["max_nbp"], max(x["k_durs"]))
    a, b = bls_staged_fold.staged_fold(*fold), bls_staged_fold.staged_fold(
        *fold)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError("K-SF: two runs differ")
    log("  K-F, K-WF and K-SF: two runs on the same inputs are "
        "bit-identical")


def check_tile_edge(B=256, n=2048, seed=11):
    """The float64 tile-edge grid of tests/test_torch_bls.py on the card:
    the longest period (0.71 d + 1e-16) has 72 bins by the device's rule
    and 71 by ceil(p / d_phase), and 71 + 58 - 1 rows fill one 128-row
    tile.  With rows sized from the host bound every kernel equals its
    plain version; with rows sized from the count alone that period is
    NaN in kernel and plain version alike, and the others are unchanged."""
    import torch
    from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                          bls_window)
    from lightkurve_tpu_torch.ops.bls_fused_weighted import weighted_fold
    from tools import make_sector as ms
    dt = torch.float64
    rng = np.random.default_rng(seed)
    d_phase = 0.01
    periods = np.array([0.5, 0.6, 0.71 + 1e-16])
    dvals, k_durs = (0.1, 0.58), (10, 58)
    nbins = int(np.ceil(periods.max() / d_phase))
    bound = bls_fused.max_nbins_bound(periods, d_phase, dt)
    if (nbins, bound) != (71, 72):
        raise AssertionError(f"tile-edge grid gives {(nbins, bound)}")
    t = ms.time_grid()[:n]
    Y = 1.0 + ms.NOISE * rng.standard_normal((B, n))
    ts = torch.as_tensor(t - t.min(), dtype=dt, device="cuda")
    Y0 = torch.as_tensor((Y - Y.mean(1, keepdims=True)).T.copy(), dtype=dt,
                         device="cuda")
    pc = torch.as_tensor(periods, dtype=dt, device="cuda")
    W = torch.ones_like(Y0)
    WWY = torch.cat([W, Y0], 1)
    common = (k_durs, dvals, d_phase)

    def run(rows_bound):
        csum, nbp = weighted_fold(ts, WWY, pc, d_phase, nbins, rows_bound,
                                  max(k_durs))
        args = (csum, nbp, pc, WWY.sum(0), *common)
        fargs = (ts, Y0, pc, *common, nbins, rows_bound)
        wargs = (ts, W, Y0, pc, *common, nbins, rows_bound)
        cs_y, cs_n, unbp = bls_fused.uniform_fold(ts, Y0, pc, d_phase, nbins,
                                                  rows_bound, max(k_durs))
        uargs = (cs_y, cs_n, unbp, pc, Y0.sum(0), float(n), *common)
        return {"K-F": (bls_fused.fused_scan_uniform(*fargs),
                        bls_fused.fused_scan_uniform_plain(*fargs)),
                "K-WF": (bls_fused_weighted.fused_scan_weighted(*wargs),
                         bls_fused_weighted.fused_scan_weighted_plain(
                             *wargs)),
                "K-W": (bls_window.window_scan(*args),
                        bls_window.window_scan_plain(*args)),
                "K-U": (bls_window.window_scan_uniform(*uargs),
                        bls_window.window_scan_uniform_plain(*uargs))}

    good, short = run(bound), run(nbins)
    for name, (got, want) in good.items():
        compare(f"{name} tile edge", got, want, True)
        for f in got:
            for out in short[name]:
                if not (torch.isnan(out[f][-1]).all() and torch.allclose(
                        out[f][:-1], got[f][:-1], rtol=F64_RTOL, atol=1e-12)):
                    raise AssertionError(f"{name} tile edge: rows sized "
                                         f"from the count, {f} not NaN or "
                                         f"the other periods changed")
    log("  tile edge: rows from the bound equal the plain versions; rows "
        "from the count give NaN for that period in both")


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path at full size
# ---------------------------------------------------------------------------
def recovery(best_period, p_inj):
    ok = np.abs(best_period - p_inj) / p_inj < RECOVERY_RTOL
    return float(ok.mean())


def write_sector(directory, n_files):
    """The synthetic sector of tools/make_sector.py (its layout, seed rule
    and headers) written with the port's FITS writer; returns the paths
    and the injected periods."""
    from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                              PrimaryHDU, write_fits)
    from tools import make_sector as ms
    os.makedirs(directory, exist_ok=True)
    t = ms.time_grid()
    quality = np.zeros(ms.N, dtype=np.int32)
    paths, truth = [], []
    for ib in range(n_files // ms.BATCH):
        flux, p_inj = ms.batch_flux(ib, t)
        truth.append(p_inj)
        for i in range(ms.BATCH):
            g = ib * ms.BATCH + i
            path = ms.file_path(directory, g)
            ph = Header({"TELESCOP": "TESS", "ORIGIN": "lightkurve_tpu",
                         "CREATOR": "make_sector.py",
                         "OBJECT": f"SYNTH {g}", "TICID": g,
                         "SECTOR": ms.SECTOR, "MISSION": "TESS",
                         "TRUTHP": float(p_inj[i])})
            table = BinTableHDU(data={
                "TIME": t,
                "PDCSAP_FLUX": flux[i].astype(np.float32),
                "PDCSAP_FLUX_ERR": np.full(ms.N, ms.NOISE, dtype=np.float32),
                "QUALITY": quality,
            }, header=Header({"EXTNAME": "LIGHTCURVE",
                              "BJDREFI": 2457000, "BJDREFF": 0.0,
                              "TIMESYS": "TDB", "TUNIT2": "e-/s",
                              "TUNIT3": "e-/s"}))
            write_fits(HDUList([PrimaryHDU(header=ph), table]), path,
                       overwrite=True)
            paths.append(path)
    return paths, np.concatenate(truth)


def phase_uniform(tmp, B=2048, n_periods=25_000, chunk_periods=12_500):
    import torch
    from lightkurve_tpu_torch.io.pipeline import StreamingStackLoader
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from tools import make_sector as ms
    t0 = time.time()
    paths, p_inj = write_sector(os.path.join(tmp, "sector"), B)
    log(f"uniform: wrote {len(paths)} FITS files in {time.time() - t0:.1f}s")
    t = ms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, n_periods)
    loader = StreamingStackLoader(paths, batch_size=B, length=ms.N,
                                  dtype=torch.float32, device="cuda")
    start_sweep()
    t0 = time.time()
    best, fluxes = [], []
    routes = dict.fromkeys(kernel_table(), 0)
    sweep_s = 0.0
    for k, stack in enumerate(loader):
        for key, v in expected_launches(stack, periods,
                                        chunk_periods).items():
            routes[key] += v
        torch.cuda.synchronize()
        t1 = time.time()
        runner = SweepRunner(stack, periods, DURATIONS,
                             os.path.join(tmp, f"uniform_{k}.npz"),
                             chunk_periods=chunk_periods, method="shared",
                             async_save=True)
        state = runner.run()
        sweep_s += time.time() - t1
        if not runner.done or not os.path.exists(runner.checkpoint_path):
            raise AssertionError("uniform sweep did not finish/checkpoint")
        best.append(state["period"])
        fluxes.append(stack.flux)
    total_s = time.time() - t0
    share = recovery(np.concatenate(best), p_inj)
    rate = B * n_periods / sweep_s
    log(f"uniform: B={B} N={ms.N} P={n_periods} in "
        f"{-(-n_periods // chunk_periods)} chunks: sweep {sweep_s:.3f}s "
        f"({rate:.6g} curve-period evals/s), load+sweep {total_s:.3f}s; "
        f"recovered {share:.4f}; {peak_memory()}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"uniform recovery {share} < {RECOVERY_SHARE}")
    # the loader's side-stream copies with batches in flight: the same
    # files in quarter batches, device work queued on each before the
    # next is staged, must give the same flux as the one big batch
    flux = torch.cat(fluxes)
    quarter = StreamingStackLoader(paths, batch_size=B // 4, length=ms.N,
                                   dtype=torch.float32, device="cuda")
    for k, stack in enumerate(quarter):
        torch.cumsum(stack.flux, 1)
        if not torch.equal(stack.flux, flux[k * (B // 4):(k + 1) * (B // 4)]):
            raise AssertionError(f"streamed batch {k} differs")
    log(f"uniform: {k + 1} streamed batches of {B // 4} equal the "
        f"{B}-curve batch")
    return dict(seconds=sweep_s, rate=rate, recovered=share, routes=routes)


def spoc_like_stack(B=2048, seed=2024, dtype=None):
    """In-memory SPOC-like batch: per-cadence dy, ~3% masked cadences,
    one injected box transit per curve."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from tools import make_sector as ms
    rng = np.random.default_rng(seed)
    t = ms.time_grid()
    dy = ms.NOISE * rng.uniform(0.7, 1.3, (B, ms.N))
    flux = 1.0 + dy * rng.standard_normal((B, ms.N))
    p_inj = rng.uniform(1.2, 3.5, B)
    inject_transits(flux, t, p_inj, rng)
    mask = rng.random((B, ms.N)) >= 0.03
    flux[~mask] = 0.0
    stack = LightCurveStack.from_numpy(np.tile(t, (B, 1)), flux,
                                       dy, mask, device="cuda",
                                       dtype=dtype or torch.float32)
    return stack, p_inj


def phase_weighted(tmp, B=2048, n_periods=4096, chunk_periods=2048):
    """Phase 4: the weighted sweep.  Returns its numbers, the launches the
    route rule gives (:func:`expected_launches`) and, as ``route_check``,
    the stack and its first chunk's periods for :func:`compare_routes`."""
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from tools import make_sector as ms
    stack, p_inj = spoc_like_stack(B)
    t = ms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, n_periods)
    start_sweep()
    t0 = time.time()
    runner = SweepRunner(stack, periods, DURATIONS,
                         os.path.join(tmp, "weighted.npz"),
                         chunk_periods=chunk_periods, method="shared",
                         async_save=True)
    state = runner.run()
    sweep_s = time.time() - t0
    share = recovery(state["period"], p_inj)
    rate = B * n_periods / sweep_s
    log(f"weighted: B={B} N={ms.N} P={n_periods} in {runner.n_chunks} "
        f"chunks: sweep {sweep_s:.3f}s ({rate:.6g} curve-period evals/s); "
        f"masked {1 - float(stack.mask.float().mean()):.4f}; "
        f"recovered {share:.4f}; {peak_memory()}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"weighted recovery {share} < {RECOVERY_SHARE}")
    return dict(seconds=sweep_s, rate=rate, recovered=share,
                routes=expected_launches(stack, periods, chunk_periods),
                route_check=(stack, periods[:chunk_periods]))


#: C2: how far two routes' float32 powers may lie apart, relative, where
#: their winners agree and where they differ.  The routes sum the same
#: deposits in two orders, and each running sum drifts by about an ulp
#: per add times the root of its adds; a fold holds at most 2n deposits
#: per column (each cadence once, and once more into a wrap row).  Two
#: windows whose powers lie within that of each other may swap places, so
#: a differing winner's gap is held to the same bound
ROUTE_GAP_ULPS = 4
#: differing winners logged one by one per comparison, at most
ROUTE_GAP_LOG = 32


def route_gap_bound(n):
    """C2's bound on the relative power gap between two routes' winners,
    for a fold of ``n`` cadences: ``ROUTE_GAP_ULPS`` float32 ulps times
    the square root of the deposits per column, at most 2n."""
    return ROUTE_GAP_ULPS * float(np.finfo(np.float32).eps) * np.sqrt(2 * n)


def route_gaps(name, a, b, n, keys=("duration", "transit_time")):
    """C2 on two routes' results ``a``, ``b`` (dicts of arrays of one
    shape, per (curve, period) or per curve): where the winners (``keys``)
    agree, the largest relative power error; where they differ, each
    cell's relative gap between the two winners' powers.  Both are held to
    :func:`route_gap_bound`; a gap past it is a fold fault.  Logs the
    differing cells (the first ``ROUTE_GAP_LOG``); returns (agreeing max,
    largest gap, bound)."""
    a = {k: np.asarray(v, np.float64) for k, v in a.items()}
    b = {k: np.asarray(v, np.float64) for k, v in b.items()}
    fin = np.isfinite(b["power"]) & np.isfinite(a["power"])
    same = np.ones(fin.shape, bool)
    for k in keys:
        same &= a[k] == b[k]
    rel = np.abs(a["power"] - b["power"]) / np.abs(b["power"])
    agree = float(rel[fin & same].max()) if (fin & same).any() else 0.0
    differ = fin & ~same
    gaps = rel[differ]
    bound = route_gap_bound(n)
    for cell in list(zip(*np.nonzero(differ)))[:ROUTE_GAP_LOG]:
        log(f"  {name}: winners differ at {tuple(int(c) for c in cell)}: "
            f"power {a['power'][cell]!r} vs {b['power'][cell]!r}, relative "
            f"gap {rel[cell]:.3g}")
    gap = float(gaps.max()) if gaps.size else 0.0
    log(f"  {name}: C2 {int(differ.sum())} of {int(fin.sum())} winners "
        f"differ, largest relative power gap {gap:.3g}; agreeing winners' "
        f"max relative power error {agree:.3g}; float32 rounding bound "
        f"{bound:.3g} ({ROUTE_GAP_ULPS} ulps x sqrt(2 x {n}))")
    if gap > bound or agree > bound:
        raise AssertionError(f"{name}: the routes' powers differ past the "
                             f"float32 rounding bound: a fold fault")
    return agree, gap, bound


def route_call(stack, pvals, impl):
    """One SweepRunner chunk of ``stack`` at the periods ``pvals`` through
    the entry point ``bls_power_shared_batch``, called as SweepRunner's
    step calls it, on the route ``impl``; returns the (B, P) result and the
    per-curve winners on the host."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls import bls_power_shared_batch
    from lightkurve_tpu_torch.parallel.checkpoint import (_FIELDS,
                                                          _chunk_nbins,
                                                          _k_max,
                                                          _reduce_winner)
    dtype = stack.flux.dtype
    np_dtype = numpy_dtype(dtype)
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    pvals = np.asarray(pvals).astype(np_dtype)
    dy = torch.where(stack.mask, stack.flux_err,
                     torch.tensor(torch.inf, dtype=dtype, device="cuda"))
    uniform = is_uniform(stack)
    out = bls_power_shared_batch(
        stack.time[0].to(dtype), stack.flux, dy, pvals,
        DURATIONS.astype(np_dtype), oversample=OVERSAMPLE, d_phase=d_phase,
        nbins=_chunk_nbins(pvals, d_phase, _k_max(DURATIONS, d_phase)),
        chunk=8, uniform_weights=uniform, fold_impl=impl)
    return out, dict(zip(_FIELDS, _reduce_winner(
        out, len(pvals)).cpu().numpy()))


def is_uniform(stack):
    """Whether SweepRunner searches ``stack`` in the uniform regime (no
    masked cadence, one flux_err per curve)."""
    import torch
    err = stack.flux_err
    return bool(torch.all(stack.mask)) and bool(torch.all(err == err[:, :1]))


def compare_routes(name, stack, pvals):
    """One SweepRunner chunk of ``stack`` at the periods ``pvals`` through
    the entry point on both routes (:func:`route_call`), each route a path
    of its own (:func:`drive`): ``fold_impl="fused"`` must launch K-F (K-WF
    for weights) and no other kernel, ``"staged"`` K-SF and K-U (K-W) and
    no other.  The per-curve winners must be the same period, duration and
    transit time in >= 99.9% of curves, with power within rtol 1e-3 where
    they are (the float32 bars), and the power gaps within C2's bound
    (:func:`route_gaps`).  Logs each route's seconds; returns each path's
    launches."""
    uniform = is_uniform(stack)

    def run(impl):
        start_sweep()
        t0 = time.time()
        return route_call(stack, pvals, impl)[1], time.time() - t0

    win, secs, runs = {}, {}, {}
    for impl, kerns in (("fused", ("K-F",) if uniform else ("K-WF",)),
                        ("staged", ("K-SF", "K-U") if uniform
                         else ("K-SF", "K-W"))):
        path = f"{name}, {impl} route"
        (win[impl], secs[impl]), runs[path] = drive(
            path, run, impl, expect=kerns,
            forbid=tuple(k for k in kernel_table() if k not in kerns))
    a, b = win["fused"], win["staged"]
    same = ((a["period"] == b["period"]) & (a["duration"] == b["duration"])
            & (a["transit_time"] == b["transit_time"]))
    share = float(same.mean())
    rel = float(np.max(np.abs(a["power"][same] - b["power"][same])
                       / np.abs(b["power"][same]))) if same.any() else 0.0
    log(f"{name}: fused route {secs['fused']:.3f}s, staged route "
        f"{secs['staged']:.3f}s for {len(pvals)} periods; identical winners "
        f"in {share:.6f} of {len(same)} curves, max rel power error "
        f"{rel:.3g}")
    if share < F32_WINNER_SHARE or rel > F32_RTOL:
        raise AssertionError(f"{name}: the two routes' winners differ")
    route_gaps(name, a, b, stack.shape[1],
               keys=("period", "duration", "transit_time"))
    return runs


# ---------------------------------------------------------------------------
# phase 5: kernels against plain, and their times, at the main path's shapes
# ---------------------------------------------------------------------------
def main_shape_inputs(dtype, P, B=2048):
    """The kernels' inputs as the main path gives them: B curves x 8192
    cadences (the SPOC-like batch), the P longest periods of the uniform
    cell's grid (the most bins), the north-star durations, the bin count
    SweepRunner's step picks for them and the host bound ops.bls sizes
    the kernels' rows with; K-W's prefix sums from the weighted fold in
    SweepRunner's calls of 8 periods."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from lightkurve_tpu_torch.ops.bls_fused_weighted import weighted_fold
    from tools import make_sector as ms
    stack, _ = spoc_like_stack(B, seed=5, dtype=dtype)
    t = ms.time_grid()
    grid = np.linspace(1.0, (t[-1] - t[0]) / 3, 25_000)
    p_host = grid[-P:].astype(numpy_dtype(dtype))
    pc = torch.as_tensor(p_host, device="cuda")
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in DURATIONS)
    k_max = max(k_durs)
    # SweepRunner's per-chunk bin count (parallel/checkpoint.py)
    nb = int(np.ceil(float(np.max(p_host)) / d_phase))
    nbins = max((nb + k_max - 1 + 127) // 128, 1) * 128 - (k_max - 1)
    max_nbp = max_nbins_bound(p_host, d_phase, dtype)
    ts = stack.time[0] - stack.time[0].min()
    Y = stack.flux
    Y0 = (Y - Y.mean(1, keepdim=True)).T.contiguous()
    Wn = torch.where(stack.mask, 1.0 / stack.flux_err ** 2, 0.0)
    Wn = Wn / Wn.mean()
    mu = (Wn * Y).sum(1, keepdim=True) / Wn.sum(1, keepdim=True)
    W, WY = Wn.T.contiguous(), (Wn * (Y - mu)).T.contiguous()
    WWY = torch.cat([W, WY], 1)
    parts = [weighted_fold(ts, WWY, pc[i:i + 8], d_phase, nbins, max_nbp,
                           k_max) for i in range(0, P, 8)]
    csum = torch.cat([c for c, _ in parts]).contiguous()
    nbp = torch.cat([b for _, b in parts]).contiguous()
    del parts, stack, WWY
    common = (k_durs, tuple(float(d) for d in DURATIONS), d_phase)
    return dict(fold_args=(ts, Y0, pc, *common, nbins, max_nbp, True, True,
                           8),
                weighted_args=(ts, W, WY, pc, *common, nbins, max_nbp, True,
                               True, 8),
                win_args=(csum, nbp, pc, torch.cat([W.sum(0), WY.sum(0)]),
                          *common, True),
                desc=f"B={B} N={ms.N} P={P} (periods {p_host[0]:.4f}-"
                     f"{p_host[-1]:.4f} d, {max_nbp} bins, fold sized for "
                     f"{nbins}) {dtype}")


def phase_main_shapes():
    """K-F, K-WF and K-W against their plain versions on the same inputs at
    the main path's shapes, float64 (64 periods) then float32 (256
    periods); the float32 pair timed plain, kernel, kernel, plain, with
    the fused kernels' blocks and breakdowns; K-W also per 8-period
    launch, the width the staged route launches it at.  Returns
    the float32 max |power error|, (kernel ms, plain ms), (bound ms, bound
    by) and, for K-W, (ms, bound ms) per 8-period launch."""
    import torch
    from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                          bls_window)
    errs, times, bounds, launches = {}, {}, {}, {}
    for dtype, P in ((torch.float64, 64), (torch.float32, 256)):
        f64 = dtype == torch.float64
        x = main_shape_inputs(dtype, P)
        log(f"main shapes: {x['desc']}")
        for name, kern, plain, args, bound in (
                ("K-F", bls_fused.fused_scan_uniform,
                 bls_fused.fused_scan_uniform_plain, x["fold_args"],
                 bound_fused),
                ("K-WF", bls_fused_weighted.fused_scan_weighted,
                 bls_fused_weighted.fused_scan_weighted_plain,
                 x["weighted_args"], bound_weighted_fused),
                ("K-W", bls_window.window_scan, bls_window.window_scan_plain,
                 x["win_args"], bound_weighted)):
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            e, _ = compare(f"{name} main shapes", got, want, f64)
            del got, want
            if f64:
                continue
            errs[name] = e
            times[name] = time_pair(name, kern, plain, args)
            bounds[name] = bound(*args)
            log(f"bound {name}: {bounds[name][0]:.6f} ms "
                f"({bounds[name][1]})")
            if name == "K-W":
                launches[name] = launch_time(
                    name, kern, bound, first_periods(args, (0, 1, 2)))
                scan_breakdown(name, kern, args, 4)
        if not f64:
            rows_cap = x["fold_args"][7] + max(x["fold_args"][3]) - 1
            for name, weighted, kern in (
                    ("K-F", False, bls_fused.fused_scan_uniform),
                    ("K-WF", True, bls_fused_weighted.fused_scan_weighted)):
                warps, blocks = bls_fused.fused_block(rows_cap, dtype,
                                                      "cuda", weighted)
                log(f"{name} block at {rows_cap} rows: {warps} warps, "
                    f"{blocks} resident blocks per SM ({warps * blocks} "
                    f"warps per SM, occupancy calculator)")
                fused_breakdown(name, kern, x["weighted_args" if weighted
                                              else "fold_args"], weighted)
        del x
        torch.cuda.empty_cache()
    return errs, times, bounds, launches


def first_periods(args, per_period, k=8):
    """``args`` cut to their first ``k`` periods: the entries at the
    indices ``per_period`` have one row per period."""
    return tuple(a[:k] if i in per_period else a for i, a in enumerate(args))


def launch_time(name, kern, bound, args):
    """A kernel's time for one launch on ``args`` (the staged route's
    width) and its bound there; returns (ms, bound ms)."""
    ms = cuda_time_ms(lambda: kern(*args))
    b = bound(*args)
    log(f"{name} per launch at the staged route's width: {ms:.3f} ms, "
        f"bound {b[0]:.6f} ms ({b[1]})")
    return ms, b[0]


def scan_breakdown(name, kern, args, k_at):
    """Where a window scan's time goes: the same call timed with all the
    durations and with the first only (``args[k_at]`` and the next entry
    are the durations' bins and values): the bytes it moves do not depend
    on the durations, its window arithmetic does."""
    one = args[:k_at] + (args[k_at][:1], args[k_at + 1][:1]) + args[
        k_at + 2:]
    full = cuda_time_ms(lambda: kern(*args))
    dur1 = cuda_time_ms(lambda: kern(*one))
    log(f"{name} breakdown: {full:.3f} ms with {len(args[k_at])} "
        f"durations, {dur1:.3f} ms with the first duration only")


def fused_breakdown(name, kern, args, weighted):
    """Where a fused kernel's time goes: the same call timed with all the
    durations, with the first duration only (the window scan's share) and
    with a quarter of the cadences (the fold's share)."""
    cols = 2 if weighted else 1
    ts, data, rest = args[0], args[1:1 + cols], args[1 + cols:]
    one = rest[:1] + (rest[1][:1], rest[2][:1]) + rest[3:]
    q = ts.shape[0] // 4
    quarter = (ts[:q].contiguous(),) + tuple(c[:q].contiguous()
                                             for c in data) + rest
    full = cuda_time_ms(lambda: kern(*args))
    dur1 = cuda_time_ms(lambda: kern(ts, *data, *one))
    quart = cuda_time_ms(lambda: kern(*quarter))
    log(f"{name} breakdown: {full:.3f} ms with {len(rest[1])} durations "
        f"and {ts.shape[0]} cadences, {dur1:.3f} ms with the first "
        f"duration only, {quart:.3f} ms with {q} cadences")


def time_pair(name, kern, plain, args, run_plain=None):
    """Kernel and plain version on the same inputs, timed plain, kernel,
    kernel, plain (CUDA events); returns (best kernel ms, best plain ms).
    ``run_plain`` replaces the plain call where it runs in slices."""
    if run_plain is None:
        run_plain = lambda: plain(*args)  # noqa: E731
    p1 = cuda_time_ms(run_plain)
    k1 = cuda_time_ms(lambda: kern(*args))
    k2 = cuda_time_ms(lambda: kern(*args))
    p2 = cuda_time_ms(run_plain)
    log(f"times {name}: kernel {k1:.3f}/{k2:.3f} ms, plain "
        f"{p1:.3f}/{p2:.3f} ms")
    return min(k1, k2), min(p1, p2)


# ---------------------------------------------------------------------------
# the least time the card could take (bound_ms): the larger of the bytes
# the function must move (inputs read once, outputs written once) over the
# memory rate, and its operations over the float32 rate
# ---------------------------------------------------------------------------
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_S = 67e12          # H100 SXM float32 outside the tensor cores
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


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
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


def bound_fused(ts, Y0, pc, k_durs, dur_values, d_phase, nbins, max_nbp,
                like=True, wrap=True, chunk=8):
    """K-F: reads the flux (n, B) and times once; per period it folds every
    sample into each curve's column and the shared count column
    (:func:`_fold_ops`) and scans the windows."""
    from lightkurve_tpu_torch.ops.bls_fused import nbins_per_period
    n, B = Y0.shape
    item = Y0.element_size()
    nbp = nbins_per_period(pc, d_phase).cpu().numpy()
    fold = (B + 1) * _fold_ops(n, nbp, max(k_durs), wrap)
    return _bound((n * B + n + B) * item + _outputs_bytes(len(nbp), B, item),
                  fold + _uniform_scan_ops(B, _windows(nbp, k_durs)))


def bound_weighted_fused(ts, W, WY, pc, k_durs, dur_values, d_phase, nbins,
                         max_nbp, like=True, wrap=True, chunk=8):
    """K-WF: reads W, WY (n, B) and the times once; per period it folds
    every sample into each curve's two columns (:func:`_fold_ops`) and
    scans the windows at 12 operations per window and curve."""
    from lightkurve_tpu_torch.ops.bls_fused import nbins_per_period
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
    from lightkurve_tpu_torch.ops.bls_fused import fold_rows
    from lightkurve_tpu_torch.ops.bls_staged_fold import fold_deposits
    cols, item = X.shape[1], X.element_size()
    npad = fold_rows(nbins, max_nbp, k_max)
    _, row_start, _ = fold_deposits(ts, pc, d_phase, nbins, npad, wrap)
    m, C = int(row_start[:, -1].sum()), pc.shape[0]
    return _bound((m + C * npad) * cols * item + (m + C * (npad + 1)) * 4,
                  m * cols)


# ---------------------------------------------------------------------------
# phase 5, second half: the long-baseline sweeps' shapes (K-U and K-SF on
# the staged route of the two-sector sweep's chunk 4, K-F on both sweeps'
# last chunks) and the route points
# ---------------------------------------------------------------------------
LONG_N = 19_440             # 27.0 d of two-minute cadences: one TESS sector
SECTOR_DAYS = 27.4          # one TESS sector: the offset between sectors
LONG_GRID = (1.0, 9.0, 4096)
#: two consecutive sectors (the second starts 27.4 d after the first),
#: searched to baseline/3
TWO_SECTOR_GRID = (1.0, 18.0, 4096)
#: the route point where a fused block holds one warp in float32 (27,065
#: rows): periods near 134.7 d at two sectors' cadences, 16 of them
NARROW_GRID = (134.6, 134.7, 16)


def sector_times(n_sectors=1):
    """Two-minute cadence midtimes of ``n_sectors`` consecutive 27-d
    sectors on one grid."""
    from tools import make_sector as ms
    one = np.arange(LONG_N) * (2.0 / 60 / 24) + ms.T_OFFSET
    return np.concatenate([one + SECTOR_DAYS * k for k in range(n_sectors)])


def long_sector_stack(B=2048, seed=2027, dtype=None, n_sectors=1,
                      p_max=8.5):
    """In-memory stack of B curves on ``n_sectors`` consecutive sectors of
    19,440 two-minute cadences each, constant dy, one box transit each
    (periods uniform in 1.2 d to ``p_max``)."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from tools import make_sector as ms
    rng = np.random.default_rng(seed)
    t = sector_times(n_sectors)
    flux = 1.0 + ms.NOISE * rng.standard_normal((B, t.size))
    p_inj = rng.uniform(1.2, p_max, B)
    inject_transits(flux, t, p_inj, rng)
    stack = LightCurveStack.from_numpy(
        np.broadcast_to(t, (B, t.size)), flux, np.full_like(flux, ms.NOISE),
        np.ones(flux.shape, bool), device="cuda",
        dtype=dtype or torch.float32)
    return stack, p_inj


def long_inputs(dtype, n_sectors, p_host, B=2048):
    """Uniform inputs of a long-baseline sweep (:func:`long_sector_stack`,
    B curves on ``n_sectors`` sectors) at the host periods ``p_host``, with
    the bin count SweepRunner's step picks for them and rows from the host
    bound; ``fused_args`` are K-F's arguments in SweepRunner's form."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from lightkurve_tpu_torch.parallel.checkpoint import (_chunk_nbins,
                                                          _k_max)
    stack, _ = long_sector_stack(B, seed=5, dtype=dtype, n_sectors=n_sectors)
    p_host = np.asarray(p_host).astype(numpy_dtype(dtype))
    pc = torch.as_tensor(p_host, device="cuda")
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in DURATIONS)
    nbins = _chunk_nbins(p_host, d_phase, _k_max(DURATIONS, d_phase))
    max_nbp = max_nbins_bound(p_host, d_phase, dtype)
    ts = stack.time[0] - stack.time[0].min()
    Y = stack.flux
    Y0 = (Y - Y.mean(1, keepdim=True)).T.contiguous()
    common = (k_durs, tuple(float(d) for d in DURATIONS), d_phase)
    return dict(ts=ts, Y0=Y0, pc=pc, p_host=p_host, common=common,
             nbins=nbins, max_nbp=max_nbp,
             fused_args=(ts, Y0, pc, *common, nbins, max_nbp, True, True,
                         8),
             desc=f"B={B} N={ts.shape[0]} P={len(p_host)} (periods "
                  f"{p_host[0]:.4f}-{p_host[-1]:.4f} d, {max_nbp} bins, "
                  f"{max_nbp + max(k_durs) - 1} rows) {dtype}")


def uniform_window_args(x):
    """K-U's arguments for the inputs ``x`` of :func:`long_inputs`: K-SF's
    fold in SweepRunner's calls of 8 periods, concatenated."""
    import torch
    from lightkurve_tpu_torch.ops.bls_staged_fold import staged_fold
    ts, Y0, pc, common = x["ts"], x["Y0"], x["pc"], x["common"]
    k_durs, _, d_phase = common
    parts = [staged_fold(ts, Y0, pc[i:i + 8], d_phase, x["nbins"],
                         x["max_nbp"], max(k_durs))
             for i in range(0, pc.shape[0], 8)]
    cs_y, cs_n, nbp = (torch.cat([p[j] for p in parts]).contiguous()
                       for j in range(3))
    del parts
    return (cs_y, cs_n, nbp, pc, Y0.sum(0), float(Y0.shape[0]), *common,
            True)


def route_stack(t, weighted, B=2048, seed=2032):
    """B curves on the times ``t`` for the route points, one box transit
    each (periods 1.2-8.5 d); ``weighted``: per-cadence dy 0.7-1.3 x the
    noise and ~3% masked cadences, else one dy and nothing masked."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from tools import make_sector as ms
    rng = np.random.default_rng(seed)
    shape = (B, t.size)
    dy = ms.NOISE * (rng.uniform(0.7, 1.3, shape) if weighted
                     else np.ones(shape))
    flux = 1.0 + dy * rng.standard_normal(shape)
    inject_transits(flux, t, rng.uniform(1.2, 8.5, B), rng)
    mask = (rng.random(shape) >= 0.03) if weighted else np.ones(shape, bool)
    flux[~mask] = 0.0
    return LightCurveStack.from_numpy(np.broadcast_to(t, shape), flux, dy,
                                      mask, device="cuda",
                                      dtype=torch.float32)


def inject_transits(flux, t, p_inj, rng, depth=None):
    """Subtract a box transit of 0.1 d and ``depth`` (default the synthetic
    sector's) at a random epoch from each row of ``flux`` (on the times
    ``t``) at its period ``p_inj``."""
    from tools import make_sector as ms
    t0_inj = rng.uniform(0, p_inj)
    for i in range(len(flux)):
        ph = np.mod(t - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.05] -= ms.DEPTH if depth is None else depth


def chunk_ranges(grid, chunk_periods):
    """The (first, last) period of each chunk SweepRunner cuts ``grid``
    (lo, hi, count) into."""
    p = np.linspace(*grid)
    return [(p[lo], p[min(lo + chunk_periods, len(p)) - 1])
            for lo in range(0, len(p), chunk_periods)]


#: the route points' smaller batches, beside the sweeps' 2048 curves
FEWER_CURVES = (1024, 256)


def route_points():
    """Phase 5's route points: (tag, cadences, weighted, (first, last)
    period, periods, curves).  Every chunk of the shared sweeps of phases
    3, 4, 6 and 10 (at 256 of its periods, spread over it: a call's rows
    come from its longest period), the longest chunk of each cadence count
    also at 256 curves and the long sweeps' also at 1024, 16.4-16.9 d on
    one sector (3,445 rows), and both regimes where a fused block holds one
    warp (:data:`NARROW_GRID`), at 2048 and 256 curves."""
    from tools import make_sector as ms
    t = ms.time_grid()
    top = (t[-1] - t[0]) / 3
    pts = []
    for weighted, grid, chunk in ((False, (1.0, top, 25_000), 12_500),
                                  (True, (1.0, top, 4096), 2048)):
        for k, span in enumerate(chunk_ranges(grid, chunk)):
            pts.append((f"8,192 cadences, chunk {k + 1}", 8192, weighted,
                        span, 256, 2048))
        pts.append(("8,192 cadences, chunk 2", 8192, weighted, span, 256,
                    256))
    for weighted in (False, True):
        for k, span in enumerate(chunk_ranges(LONG_GRID, 1024)):
            pts.append((f"one sector, chunk {k + 1}", LONG_N, weighted, span,
                        256, 2048))
        for curves in FEWER_CURVES:
            pts.append(("one sector, chunk 4", LONG_N, weighted, span, 256,
                        curves))
        pts.append(("one sector, 16.4-16.9 d", LONG_N, weighted,
                    (16.4, 16.9), 256, 2048))
    spans = chunk_ranges(TWO_SECTOR_GRID, 1024)
    for weighted in (False, True):
        for k, span in enumerate(spans):
            if k == len(spans) - 1 or not weighted:
                pts.append((f"two sectors, chunk {k + 1}", 2 * LONG_N,
                            weighted, span, 256, 2048))
        for curves in FEWER_CURVES:
            pts.append(("two sectors, chunk 4", 2 * LONG_N, weighted,
                        spans[-1], 256, curves))
        for curves in (2048, 256):
            pts.append(("one-warp block", 2 * LONG_N, weighted,
                        NARROW_GRID[:2], NARROW_GRID[2], curves))
    return pts


def route_point(tag, stack, pvals, reps=2):
    """Both routes on one SweepRunner chunk of ``stack`` at ``pvals``
    through the entry point (:func:`route_call`: 8 periods per staged
    call), each timed by its wall time to its winners on the host, staged,
    fused, fused, staged after one untimed run of each; the untimed runs'
    results held against each other per (period, curve): the float32 bars
    (:func:`compare`) and C2's bound (:func:`route_gaps`).  Logs the rows,
    the fused block and the route "auto" takes; returns a record."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused
    from lightkurve_tpu_torch.ops.bls import fold_route
    from lightkurve_tpu_torch.parallel.checkpoint import _k_max

    def run(impl):
        start_sweep()
        t0 = time.perf_counter()
        out = route_call(stack, pvals, impl)[0]
        return out, time.perf_counter() - t0

    weighted = not is_uniform(stack)
    (fo, _), (so, _) = run("fused"), run("staged")
    T = lambda out: {k: v.T for k, v in out.items()}  # noqa: E731
    compare(f"routes, {tag}", T(fo), T(so), False)
    B, n = stack.shape
    gaps = route_gaps(f"routes, {tag}", {k: v.cpu() for k, v in fo.items()},
                      {k: v.cpu() for k, v in so.items()}, n)
    del fo, so
    times = {"fused": [], "staged": []}
    for impl in ("staged", "fused", "fused", "staged")[:4 if reps > 1
                                                        else 2]:
        times[impl].append(run(impl)[1])
    fused, staged = min(times["fused"]), min(times["staged"])
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_max = _k_max(DURATIONS, d_phase)
    max_nbp = bls_fused.max_nbins_bound(pvals, d_phase, torch.float32)
    rows = max_nbp + k_max - 1
    auto = fold_route("auto", max_nbp, k_max, torch.float32,
                      stack.device, weighted, curves=B)
    warps, _ = bls_fused.fused_block(rows, torch.float32, stack.device,
                                     weighted)
    best = min(fused, staged)
    ok = {"fused": fused, "staged": staged}[auto] <= 1.1 * best
    log(f"route point {tag}, {'weighted' if weighted else 'uniform'}: "
        f"B={B} N={n} rows={rows} P={len(pvals)} (periods {pvals[0]:.4f}-"
        f"{pvals[-1]:.4f} d): fused {'/'.join(f'{x:.4f}' for x in times['fused'])} s "
        f"({warps}-warp block), staged "
        f"{'/'.join(f'{x:.4f}' for x in times['staged'])} s; faster "
        f"{'fused' if fused < staged else 'staged'} "
        f"{max(fused, staged) / best:.2f}x; auto takes {auto!r}, "
        f"{'within 10% of the faster' if ok else 'more than 10% slower'}; "
        f"{peak_memory()}")
    return dict(tag=tag, weighted=weighted, B=B, n=n, rows=rows,
                fused=fused, staged=staged, auto=auto, ok=ok, gaps=gaps)


def phase_routes():
    """Phase 5's route points (:func:`route_points`), each timed on both
    routes (:func:`route_point`); logs how many "auto" got within 10% of
    the faster route and returns the records."""
    import torch
    from tools import make_sector as ms
    grids = {8192: ms.time_grid(), LONG_N: sector_times(1),
             2 * LONG_N: sector_times(2)}
    records, stacks = [], {}
    for tag, n, weighted, (lo, hi), count, B in route_points():
        if (n, weighted) not in stacks:
            stacks.clear()
            torch.cuda.empty_cache()
            stacks[(n, weighted)] = route_stack(grids[n], weighted)
        full = stacks[(n, weighted)]
        stack = full if B == len(full) else full._replace(
            time=full.time[:B], flux=full.flux[:B],
            flux_err=full.flux_err[:B], mask=full.mask[:B])
        records.append(route_point(tag, stack, np.linspace(lo, hi, count),
                                   reps=1 if count < 256 else 2))
    stacks.clear()
    torch.cuda.empty_cache()
    ok = sum(r["ok"] for r in records)
    log(f"route points: auto within 10% of the faster route at {ok} of "
        f"{len(records)}")
    return records


def fold_times(x, slice_periods=8):
    """K-SF on the inputs ``x`` of :func:`long_inputs`, all periods in one
    launch, against its plain version and the one-hot fold it replaced
    (:func:`uniform_fold`, one matrix product and a cumsum: its library
    yardstick), both in slices of ``slice_periods``; timed plain, kernel,
    kernel, plain, then the one-hot fold; also per 8-period launch.
    Returns its float32 max |prefix error|, (kernel ms, plain ms), (bound
    ms, bound by), the one-hot fold's ms and (ms, bound ms) per launch."""
    import torch
    from lightkurve_tpu_torch.ops.bls_fused import uniform_fold
    from lightkurve_tpu_torch.ops.bls_staged_fold import (staged_fold,
                                                          staged_fold_plain)
    ts, Y0, pc = x["ts"], x["Y0"], x["pc"]
    k_durs, _, d_phase = x["common"]
    args = (ts, Y0, pc, d_phase, x["nbins"], x["max_nbp"], max(k_durs))

    def sliced(fn):
        def run():
            parts = [fn(ts, Y0, pc[i:i + slice_periods], *args[3:])
                     for i in range(0, pc.shape[0], slice_periods)]
            return tuple(torch.cat([p[j] for p in parts]) for j in range(3))
        return run

    plain, onehot = sliced(staged_fold_plain), sliced(uniform_fold)
    got = staged_fold(*args)
    err = compare_fold("K-SF long shapes", got, plain(), Y0, False)
    compare_fold("K-SF against the one-hot fold", got, onehot(), Y0, False)
    del got
    torch.cuda.empty_cache()
    times = time_pair("K-SF", staged_fold, None, args, run_plain=plain)
    library = cuda_time_ms(onehot, reps=1)
    bound = bound_staged_fold(*args)
    log(f"K-SF at {x['desc']}: {times[0]:.3f} ms for {pc.shape[0]} periods "
        f"in one launch, bound {bound[0]:.3f} ms ({bound[1]}); the one-hot "
        f"fold (GEMM + cumsum, {slice_periods} periods per call) "
        f"{library:.3f} ms, {library / times[0]:.1f}x the kernel")
    per = launch_time("K-SF", staged_fold, bound_staged_fold,
                      first_periods(args, (2,)))
    return err, times, bound, library, per


def phase_long_shapes(slice_periods=32):
    """K-U and K-SF where the main path runs them, the two-sector sweep's
    chunk 4 on the staged route (2048 x 38,880, its longest periods):
    against their plain versions in float64 (64 periods) then float32 (256
    periods in one launch; the plain versions in slices), timed, with
    their times per 8-period launch and K-SF's one-hot yardstick
    (:func:`fold_times`).  K-F against its plain version in float32 at
    both long sweeps' last chunks (their widest rows).  Returns per kernel
    (K-U, K-SF)
    its float32 max error, (kernel ms, plain ms), (bound ms, bound by) and
    (ms, bound ms) per 8-period launch, K-SF's one-hot ms, and K-F's
    float32 max |power error| here."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    from lightkurve_tpu_torch.ops.bls_staged_fold import (staged_fold,
                                                          staged_fold_plain)
    kern, plain = (bls_window.window_scan_uniform,
                   bls_window.window_scan_uniform_plain)
    two = np.linspace(*TWO_SECTOR_GRID)
    out = {}
    for dtype, P in ((torch.float64, 64), (torch.float32, 256)):
        f64 = dtype == torch.float64
        x = long_inputs(dtype, 2, two[-P:])
        args = uniform_window_args(x)
        log(f"long shapes, K-U: {x['desc']}, fold rows {args[0].shape[1]}")
        cs_y, cs_n, nbp, pc = args[:4]

        def plain_sliced():
            return {f: torch.cat(v) for f, v in zip(
                ("power", "depth", "n_in", "transit_time", "duration"),
                zip(*[plain(cs_y[i:i + slice_periods],
                            cs_n[i:i + slice_periods],
                            nbp[i:i + slice_periods],
                            pc[i:i + slice_periods], *args[4:]).values()
                      for i in range(0, P, slice_periods)]))}

        got, want = kern(*args), plain_sliced()
        torch.cuda.synchronize()
        e, _ = compare("K-U long shapes", got, want, f64)
        del got, want
        if f64:
            for i in range(0, P, 8):
                fold = (x["ts"], x["Y0"], pc[i:i + 8], x["common"][2],
                        x["nbins"], x["max_nbp"], max(x["common"][0]))
                compare_fold(f"K-SF long shapes, periods {i}-{i + 7}",
                             staged_fold(*fold), staged_fold_plain(*fold),
                             x["Y0"], True)
            del x, args, cs_y, cs_n
            torch.cuda.empty_cache()
            continue
        times = time_pair("K-U", kern, plain, args, plain_sliced)
        bound = bound_uniform(*args)
        tiles = -(-cs_y.shape[2] // 32)
        log(f"K-U launch width: grid ({P}, {tiles}) blocks of 32 x 8 "
            f"threads for {P} periods, (8, {tiles}) at the main path's 8 "
            f"periods per call; {times[0]:.3f} ms for {P} periods in one "
            f"launch; bound {bound[0]:.3f} ms ({bound[1]})")
        out["K-U"] = (e, times, bound, launch_time(
            "K-U", kern, bound_uniform, first_periods(args, (0, 1, 2, 3))))
        scan_breakdown("K-U", kern, args, 6)
        del args, cs_y, cs_n
        torch.cuda.empty_cache()
        fe, ftimes, fbound, library, fper = fold_times(x)
        out["K-SF"] = (fe, ftimes, fbound, fper)
    kf_err = 0.0
    for y in (long_inputs(torch.float32, 1, np.linspace(*LONG_GRID)[-256:]),
              x):
        got = bls_fused.fused_scan_uniform(*y["fused_args"])
        want = bls_fused.fused_scan_uniform_plain(*y["fused_args"])
        torch.cuda.synchronize()
        log(f"long shapes, K-F: {y['desc']}")
        kf_err = max(kf_err, compare("K-F long shapes", got, want,
                                     False)[0])
        del got, want, y
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return out, library, kf_err


# ---------------------------------------------------------------------------
# phases 6-8: the long-sector, mixed-grid and per-curve sweeps at full width
# ---------------------------------------------------------------------------
def expected_launches(stack, periods, chunk_periods):
    """What the route rule (``ops.bls.fold_route``) gives each chunk of
    SweepRunner(method="shared") over ``stack``: per time grid of its rows
    (one shared-grid search each) and chunk (the last padded by repeating
    its last period, as SweepRunner pads it), one launch of the fused
    kernel, or one launch of K-SF and of the window scan per 8 periods on
    the staged route.  Returns the launches per kernel."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls import fold_route
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from lightkurve_tpu_torch.parallel.checkpoint import _k_max
    dtype = stack.flux.dtype
    weighted = not is_uniform(stack)
    fused, window = ("K-WF", "K-W") if weighted else ("K-F", "K-U")
    groups = torch.unique(stack.time, dim=0, return_counts=True)[1].tolist()
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_max = _k_max(DURATIONS, d_phase)
    want = dict.fromkeys(kernel_table(), 0)
    for lo in range(0, len(periods), chunk_periods):
        chunk = np.asarray(periods[lo:lo + chunk_periods]).astype(
            numpy_dtype(dtype))
        max_nbp = max_nbins_bound(chunk, d_phase, dtype)
        for curves in groups:
            if fold_route("auto", max_nbp, k_max, dtype, stack.device,
                          weighted, curves=curves) == "fused":
                want[fused] += 1
            else:
                want["K-SF"] += -(-chunk_periods // 8)
                want[window] += -(-chunk_periods // 8)
    return want


def check_routes(name, want, launches):
    """A sweep path's launches against :func:`expected_launches`: a fused
    kernel exactly as often as the rule gives it, the staged route's
    kernels at least once per 8 periods of each staged chunk (a call may
    split further to fit device memory), and no kernel the rule gives no
    chunk."""
    for k, n in want.items():
        if (launches[k] < n) if n and k in ("K-SF", "K-W", "K-U") else (
                launches[k] != n):
            raise AssertionError(f"{name}: launches {launches}, the route "
                                 f"rule gives {want}")
    log(f"{name}: launches as the route rule gives them ({want})")


def phase_long_sector(tmp, name, n_sectors, grid, p_max, B=2048,
                      chunk_periods=1024, staged_chunk=None):
    """Phase 6: a long-baseline uniform sweep, 4,096 periods in four
    chunks: one 27-d sector searched over 1-9 d, and two consecutive
    sectors searched over 1-18 d; each chunk takes the route the rule
    gives it.  Returns the sweep's numbers, the launches the rule gives
    (:func:`expected_launches`) and, with
    ``staged_chunk``, as ``route_check`` the stack and that chunk's
    periods for :func:`compare_routes`."""
    import torch
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    stack, p_inj = long_sector_stack(B, dtype=torch.float32,
                                     n_sectors=n_sectors, p_max=p_max)
    periods = np.linspace(*grid)
    start_sweep()
    t0 = time.time()
    runner = SweepRunner(stack, periods, DURATIONS,
                         os.path.join(tmp, f"long_{n_sectors}.npz"),
                         chunk_periods=chunk_periods, method="shared",
                         async_save=True)
    state = runner.run()
    sweep_s = time.time() - t0
    share = recovery(state["period"], p_inj)
    rate = B * len(periods) / sweep_s
    log(f"{name}: B={B} N={stack.shape[1]} P={len(periods)} in "
        f"{runner.n_chunks} chunks: sweep {sweep_s:.3f}s ({rate:.6g} "
        f"curve-period evals/s); recovered {share:.4f}; "
        f"{peak_memory()}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"{name} recovery {share} < {RECOVERY_SHARE}")
    out = dict(seconds=sweep_s, rate=rate, recovered=share,
               routes=expected_launches(stack, periods, chunk_periods))
    if staged_chunk is not None:
        lo = staged_chunk * chunk_periods
        out["route_check"] = (stack, periods[lo:lo + chunk_periods])
    return out


def mixed_grid_stack(B=2048, n_grids=4, seed=2028):
    """The bls_spoc_like batch: B curves on n_grids 8,192-cadence grids
    (B / n_grids curves each), the grids offset as consecutive sectors;
    per-cadence dy 0.7-1.3 x 2e-4, ~3% masked cadences, one transit each."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from tools import make_sector as ms
    rng = np.random.default_rng(seed)
    per = B // n_grids
    t = (ms.time_grid()[None, :]
         + SECTOR_DAYS * np.repeat(np.arange(n_grids), per)[:, None])
    dy = ms.NOISE * rng.uniform(0.7, 1.3, (B, ms.N))
    flux = 1.0 + dy * rng.standard_normal((B, ms.N))
    p_inj = rng.uniform(1.2, 3.5, B)
    t0_inj = rng.uniform(0, p_inj)
    for i in range(B):
        ph = np.mod(t[i] - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.05] -= ms.DEPTH
    mask = rng.random((B, ms.N)) >= 0.03
    flux[~mask] = 0.0
    stack = LightCurveStack.from_numpy(t, flux, dy, mask, device="cuda",
                                       dtype=torch.float32)
    return stack, p_inj, per


def mixed_grid_periods():
    from tools import make_sector as ms
    t = ms.time_grid()
    return np.linspace(1.0, (t[-1] - t[0]) / 3, 4096)


def phase_mixed_grid(tmp, stack, p_inj, chunk_periods=2048):
    """Phase 7: the mixed-grid sweep through SweepRunner(method="shared"),
    one shared-grid search per time grid; 4,096 periods in two chunks."""
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    periods = mixed_grid_periods()
    start_sweep()
    t0 = time.time()
    runner = SweepRunner(stack, periods, DURATIONS,
                         os.path.join(tmp, "mixed.npz"),
                         chunk_periods=chunk_periods, method="shared",
                         async_save=True)
    state = runner.run()
    sweep_s = time.time() - t0
    share = recovery(state["period"], p_inj)
    rate = len(stack) * len(periods) / sweep_s
    log(f"mixed grids: B={len(stack)} N={stack.shape[1]} P={len(periods)} "
        f"in {runner.n_chunks} chunks: sweep {sweep_s:.3f}s ({rate:.6g} "
        f"curve-period evals/s); recovered {share:.4f}; "
        f"{peak_memory()}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"mixed-grid recovery {share} < "
                             f"{RECOVERY_SHARE}")
    return dict(seconds=sweep_s, rate=rate, recovered=share, state=state,
                routes=expected_launches(stack, periods, chunk_periods))


def check_mixed_against_single(tmp, stack, mixed, per, chunk_periods=2048):
    """The mixed-grid winners against four single-grid sweeps of the same
    rows: identical winners in >= 99.9% of curves, power within rtol
    1e-3 (the float32 bars)."""
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    periods = mixed_grid_periods()
    state = mixed["state"]
    same = rel = 0.0
    for g in range(len(stack) // per):
        rows = slice(g * per, (g + 1) * per)
        sub = stack._replace(time=stack.time[rows], flux=stack.flux[rows],
                             flux_err=stack.flux_err[rows],
                             mask=stack.mask[rows])
        one = SweepRunner(sub, periods, DURATIONS,
                          os.path.join(tmp, f"single_{g}.npz"),
                          chunk_periods=chunk_periods,
                          method="shared").run()
        eq = ((one["period"] == state["period"][rows])
              & (one["duration"] == state["duration"][rows])
              & (one["transit_time"] == state["transit_time"][rows]))
        same += eq.sum()
        if eq.any():
            rel = max(rel, float(np.max(np.abs(one["power"][eq]
                                               - state["power"][rows][eq])
                                        / np.abs(one["power"][eq]))))
    share = same / len(stack)
    log(f"mixed grids: identical winners to the four single-grid sweeps in "
        f"{share:.6f} of curves, max rel power error {rel:.3g}")
    if share < F32_WINNER_SHARE or rel > F32_RTOL:
        raise AssertionError("mixed-grid sweep differs from its single-grid "
                             "sweeps")


def phase_percurve(tmp, B=2048, n_periods=1024, chunk_periods=512):
    """Phase 8: SweepRunner(method="fast") and method="exact" on the
    SPOC-like batch (2048 x 8192), 1,024 periods; plain torch, no kernel."""
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from tools import make_sector as ms
    stack, p_inj = spoc_like_stack(B, seed=2029)
    t = ms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, n_periods)
    out = {}
    for method in ("fast", "exact"):
        start_sweep()
        t0 = time.time()
        state = SweepRunner(stack, periods, DURATIONS,
                            os.path.join(tmp, f"percurve_{method}.npz"),
                            chunk_periods=chunk_periods, method=method,
                            async_save=True).run()
        sweep_s = time.time() - t0
        share = recovery(state["period"], p_inj)
        log(f"per-curve {method}: B={B} N={ms.N} P={n_periods}: sweep "
            f"{sweep_s:.3f}s ({B * n_periods / sweep_s:.6g} curve-period "
            f"evals/s); recovered {share:.4f}; {peak_memory()}")
        if share < RECOVERY_SHARE:
            raise AssertionError(f"per-curve {method} recovery {share} < "
                                 f"{RECOVERY_SHARE}")
        out[method] = dict(seconds=sweep_s, recovered=share)
    return out


# ---------------------------------------------------------------------------
# phase 9: one call past the one-hot fold's old memory ceiling
# ---------------------------------------------------------------------------
#: a year of two-minute cadences
YEAR_N = 262_800
#: 4 periods near 300 d: ~60,000 rows, 1.6e10 rows x cadences, where one
#: period of the one-hot fold (npad x n x 5 bytes) passed 80 GB
CEILING_GRID = (299.9, 300.1, 4)


def phase_past_ceiling(B=2048, seed=2030):
    """Phase 9: bls_power_shared_batch on the automatic route at 262,800
    cadences x 2048 curves (uniform weights, float32), 4 periods near
    300 d: no fused block fits, so the staged route (K-SF and K-U) takes
    it.  Logs the time and the peak memory; returns the inputs and the
    result for :func:`check_past_ceiling`."""
    import torch
    from lightkurve_tpu_torch.ops.bls import bls_power_shared_batch
    from tools import make_sector as ms
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = (torch.arange(YEAR_N, dtype=torch.float64, device="cuda")
         * (2.0 / 60 / 24) + ms.T_OFFSET)
    Y = 1.0 + ms.NOISE * torch.randn((B, YEAR_N), generator=gen,
                                     device="cuda", dtype=torch.float32)
    periods = np.linspace(*CEILING_GRID)
    start_sweep()
    t0 = time.time()
    out = bls_power_shared_batch(t, Y, None, periods, DURATIONS,
                                 oversample=OVERSAMPLE, chunk=8)
    torch.cuda.synchronize()
    secs = time.time() - t0
    for f, v in out.items():
        if tuple(v.shape) != (B, len(periods)) or not bool(
                torch.isfinite(v).all()):
            raise AssertionError(f"past the ceiling: {f} not finite of "
                                 f"shape {(B, len(periods))}")
    log(f"past the ceiling: B={B} N={YEAR_N} P={len(periods)} (periods "
        f"{periods[0]}-{periods[-1]} d) in {secs:.3f}s; {peak_memory()}")
    return dict(t=t, Y=Y, periods=periods, out=out, seconds=secs)


def check_past_ceiling(x, slice_periods=2):
    """The staged scan of phase 9's inputs (K-SF and K-U) against the plain
    versions on the card, ``slice_periods`` periods per slice (the float32
    bars); the entry point's depths and durations are the scan's."""
    import torch
    from lightkurve_tpu_torch.ops.bls import _staged_scan_uniform
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from lightkurve_tpu_torch.ops.bls_staged_fold import staged_fold_plain
    from lightkurve_tpu_torch.ops.bls_window import window_scan_uniform_plain
    t, Y, out = x["t"], x["Y"], x["out"]
    p_host = x["periods"].astype(np.float32)
    pc = torch.as_tensor(p_host, device="cuda")
    ts = (t - t.min()).to(Y.dtype)
    Y0 = (Y - Y.mean(1, keepdim=True)).T
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in DURATIONS)
    dvals = tuple(float(d) for d in DURATIONS)
    nbins = int(np.ceil(float(np.max(p_host)) / d_phase))
    max_nbp = max_nbins_bound(p_host, d_phase, Y.dtype)
    got = _staged_scan_uniform(ts, Y0, pc, k_durs, dvals, d_phase, nbins,
                               max_nbp, True, 8, True)
    Yc, tot_y, parts = Y0.contiguous(), Y0.sum(0), []
    for i in range(0, len(p_host), slice_periods):
        cs_y, cs_n, nbp = staged_fold_plain(ts, Yc, pc[i:i + slice_periods],
                                            d_phase, nbins, max_nbp,
                                            max(k_durs))
        parts.append(window_scan_uniform_plain(
            cs_y, cs_n, nbp, pc[i:i + slice_periods], tot_y,
            float(Y.shape[1]), k_durs, dvals, d_phase))
        del cs_y, cs_n
    want = {f: torch.cat([p[f] for p in parts]) for f in parts[0]}
    compare("past the ceiling, staged scan", got, want, False)
    for f in ("depth", "duration"):
        if not torch.equal(out[f], got[f].T):
            raise AssertionError(f"past the ceiling: the entry point's {f} "
                                 f"is not the staged scan's")


# ---------------------------------------------------------------------------
# phase 10: the batched SG flatten, then the search, at full width
# ---------------------------------------------------------------------------
#: phase 10's flatten: 30-h windows (901 two-minute cadences), more than 3x
#: the longest north-star duration (0.33 d), as TESS users set it
FLATTEN_KW = dict(window_length=901, polyorder=2, break_tolerance=5,
                  niters=3, sigma=3)
#: the mid-sector downlink gap of phase 10's sector
DOWNLINK_GAP_DAYS = 1.0
#: phase 10's transits and stellar rotation periods (d)
FLATTEN_DEPTH = 4e-4
FLATTEN_ROTATION = (4.0, 10.0)
#: the card's float64 flatten against the CPU's, and float32 against
#: float64 on the card (relative, where both masks keep the cadence)
FLATTEN_F64_RTOL = 1e-9
FLATTEN_F32_RTOL = 1e-5
FLATTEN_F32_MASK_SHARE = 0.999
#: the share of cadences kept by both whose float32 trend is within
#: FLATTEN_F32_RTOL after every iteration
FLATTEN_F32_TREND_SHARE = 0.9999


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's default TF32 flags inside the block (float32 matrix
    products in full precision, cuDNN convolutions allowed TF32), whatever
    :func:`main` set; restored after."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def flatten_arrays(B=2048, seed=2031, depth=FLATTEN_DEPTH,
                   rotation=FLATTEN_ROTATION):
    """Phase 10's SPOC-like batch as host arrays (time, flux, flux_err,
    mask): B curves over one 27-d sector of two-minute cadences (19,440)
    with a mid-sector downlink gap; per-cadence dy 0.7-1.3 x 2e-4; a
    stellar trend per curve (a sinusoid of 0.5-1% at a period in
    ``rotation`` and a linear drift of up to 0.5% over the sector); one
    box transit of 0.1 d and ``depth`` each (periods 1.2-8.5 d); ~0.1%
    outliers at 10 dy; ~3% masked cadences.  Returns the arrays and the
    injected periods."""
    from tools import make_sector as ms
    rng = np.random.default_rng(seed)
    t = sector_times(1)
    t[LONG_N // 2:] += DOWNLINK_GAP_DAYS
    shape = (B, t.size)
    dy = ms.NOISE * rng.uniform(0.7, 1.3, shape)
    trend = (1.0 + rng.uniform(0.005, 0.01, (B, 1)) * np.sin(
        2 * np.pi * t / rng.uniform(*rotation, (B, 1))
        + rng.uniform(0, 2 * np.pi, (B, 1)))
        + rng.uniform(-0.005, 0.005, (B, 1)) * (t - t[0]) / (t[-1] - t[0]))
    flux = np.ones(shape)
    p_inj = rng.uniform(1.2, 8.5, B)
    inject_transits(flux, t, p_inj, rng, depth)
    flux = flux * trend + dy * rng.standard_normal(shape)
    out = rng.random(shape) < 0.001
    flux[out] += 10 * dy[out]
    mask = rng.random(shape) >= 0.03
    flux[~mask] = 0.0
    return (np.broadcast_to(t, shape), flux, dy, mask), p_inj


def phase_flatten(tmp, B=2048, chunk_periods=1024):
    """Phase 10: the port's detrend-then-search path on the card.  A
    float32 stack of :func:`flatten_arrays`, ``LightCurveStack.flatten``
    (:data:`FLATTEN_KW`, TF32 flags at PyTorch's defaults), timed with its
    peak memory and again at the class default window (101), then
    SweepRunner(method="shared") over :data:`LONG_GRID` in four chunks:
    the flattened flux_err makes the weights per cadence.  Returns the
    numbers, the launches the route rule gives and the host arrays."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    arrays, p_inj = flatten_arrays(B)
    stack = LightCurveStack.from_numpy(*arrays, device="cuda",
                                       dtype=torch.float32)
    with torch_default_tf32():
        stack.flatten(window_length=31)                      # warm-up
        start_sweep()
        t0 = time.perf_counter()
        flat = stack.flatten(**FLATTEN_KW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        start_sweep()
        t0 = time.perf_counter()
        stack.flatten(**dict(FLATTEN_KW, window_length=101))
        torch.cuda.synchronize()
        secs_101 = time.perf_counter() - t0
    log(f"flatten: B={B} N={stack.shape[1]} float32, window 901: "
        f"{secs:.3f}s, peak device memory {peak:.3f} GiB allocated (a "
        f"(B, w, n) float32 tensor would be "
        f"{B * 901 * stack.shape[1] * 4 / 1e9:.1f} GB); window 101: "
        f"{secs_101:.3f}s")
    good = flat.flux[stack.mask]
    if not bool(torch.isfinite(good).all()):
        raise AssertionError("flatten: non-finite flattened flux")
    periods = np.linspace(*LONG_GRID)
    routes = expected_launches(flat, periods, chunk_periods)
    start_sweep()
    t0 = time.perf_counter()
    runner = SweepRunner(flat, periods, DURATIONS,
                         os.path.join(tmp, "flatten_search.npz"),
                         chunk_periods=chunk_periods, method="shared",
                         async_save=True)
    state = runner.run()
    sweep_s = time.perf_counter() - t0
    share = recovery(state["period"], p_inj)
    rate = B * len(periods) / sweep_s
    log(f"flatten -> search: B={B} N={stack.shape[1]} P={len(periods)} in "
        f"{runner.n_chunks} chunks: sweep {sweep_s:.3f}s ({rate:.6g} "
        f"curve-period evals/s); median flattened flux "
        f"{float(good.median()):.6f}; recovered {share:.4f}; "
        f"{peak_memory()}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"flatten -> search recovery {share} < "
                             f"{RECOVERY_SHARE}")
    return dict(flatten_s=secs, flatten_101_s=secs_101, peak_gib=peak,
                seconds=sweep_s, rate=rate, recovered=share, routes=routes,
                arrays=arrays)


def flatten_limits(tmp, B=2048, chunk_periods=1024):
    """Where the reference's flatten stops serving the search: phase 10's
    sector with deep transits (the synthetic sector's 3e-3, which the
    flatten's clip removes, so each transit's gap splits a segment) and
    rotation periods of 2-10 d, searched as in phase 10 after
    ``flatten_batch`` with lightkurve_tpu's 16 tracked segments and with
    64.  Logs each recovery and how many misses have periods under the
    window plus a transit (1.35 d: segments between transits shorter than
    the window take the median fallback); no bar (ROADMAP, queue C)."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.ops.detrend import flatten_batch
    from lightkurve_tpu_torch.ops.savgol import savgol_design_matrix
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from tools import make_sector as ms
    arrays, p_inj = flatten_arrays(B, depth=ms.DEPTH, rotation=(2.0, 10.0))
    stack = LightCurveStack.from_numpy(*arrays, device="cuda",
                                       dtype=torch.float32)
    kw = FLATTEN_KW
    H = savgol_design_matrix(kw["window_length"], kw["polyorder"])
    short = p_inj < (kw["window_length"] * 2.0 / 60 / 24 + 0.1)
    for max_segments in (16, 64):
        trend, _ = flatten_batch(stack.time, stack.flux, stack.mask, H,
                                 kw["break_tolerance"], kw["sigma"],
                                 niters=kw["niters"],
                                 max_segments=max_segments)
        flat = stack._replace(flux=stack.flux / trend,
                              flux_err=stack.flux_err / trend)
        state = SweepRunner(flat, np.linspace(*LONG_GRID), DURATIONS,
                            os.path.join(tmp, f"limits_{max_segments}.npz"),
                            chunk_periods=chunk_periods,
                            method="shared").run()
        hit = np.abs(state["period"] - p_inj) / p_inj < RECOVERY_RTOL
        log(f"flatten limits: depth {ms.DEPTH:g}, rotation 2-10 d, "
            f"{max_segments} tracked segments: recovered {hit.mean():.4f}; "
            f"{int((~hit & short).sum())} of {int((~hit).sum())} misses "
            f"at periods under 1.35 d ({int(short.sum())} curves)")


def check_flatten(arrays, rows=64):
    """Phase 10's flatten (:func:`~lightkurve_tpu_torch.ops.detrend.
    flatten_batch` with :data:`FLATTEN_KW`, TF32 flags at PyTorch's
    defaults) held three ways, each pair on the same inputs (float64
    runs take the float32-rounded times and fluxes, so a pair differs only
    in its arithmetic): float64 on the card against float64 on the CPU for
    ``rows`` curves (trends within :data:`FLATTEN_F64_RTOL`, clipped masks
    equal); float32 against float64 on the card for the whole batch after
    one iteration (one compaction and segmentation from the input mask:
    trends within :data:`FLATTEN_F32_RTOL` at every cadence) and after all
    of them (masks agreeing on :data:`FLATTEN_F32_MASK_SHARE` of the
    cadences; trends within :data:`FLATTEN_F32_RTOL` on
    :data:`FLATTEN_F32_TREND_SHARE` of the cadences both keep, the rest
    near a clip or a gap decision that an earlier iteration took the other
    way).  Logs the maxima."""
    import torch
    from lightkurve_tpu_torch.ops.detrend import flatten_batch
    from lightkurve_tpu_torch.ops.savgol import savgol_design_matrix
    kw = FLATTEN_KW
    H = savgol_design_matrix(kw["window_length"], kw["polyorder"])
    t, f, _, m = (np.asarray(a, np.float32) if a.dtype != bool else a
                  for a in arrays)

    def run(dtype, device, sl=slice(None), niters=kw["niters"]):
        def put(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a[sl]), dtype=dt,
                                   device=device)
        with torch_default_tf32():
            return flatten_batch(put(t, dtype), put(f, dtype),
                                 put(m, torch.bool), H,
                                 kw["break_tolerance"], kw["sigma"],
                                 niters=niters)

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return torch.nan_to_num((a - b).abs() / b.abs(), nan=np.inf)

    (tc, vc), (th, vh) = (run(torch.float64, dev, slice(0, rows))
                          for dev in ("cuda", "cpu"))
    same = torch.equal(vc.cpu(), vh)
    r64 = float(rel(tc, th).max())
    log(f"flatten check: float64 card vs CPU, {rows} curves: clipped masks "
        f"{'equal' if same else 'DIFFER'}, max relative trend error "
        f"{r64:.3g} (bar {FLATTEN_F64_RTOL:g})")
    if not same or r64 > FLATTEN_F64_RTOL:
        raise AssertionError("flatten: float64 on the card differs from the "
                             "CPU")
    del tc, vc, th, vh
    one = float(rel(run(torch.float32, "cuda", niters=1)[0],
                    run(torch.float64, "cuda", niters=1)[0]).max())
    t32, v32 = run(torch.float32, "cuda")
    t64, v64 = run(torch.float64, "cuda")
    agree = float((v32 == v64).double().mean())
    both = (v32 & v64).cpu()
    err = rel(t32, t64)[both]
    within = float((err <= FLATTEN_F32_RTOL).double().mean())
    log(f"flatten check: float32 vs float64 on the card, {len(t)} curves: "
        f"one iteration, max relative trend error {one:.3g} (bar "
        f"{FLATTEN_F32_RTOL:g}); {kw['niters']} iterations, clipped masks "
        f"agree on {agree:.6f} of cadences, trends within "
        f"{FLATTEN_F32_RTOL:g} on {within:.8f} of the cadences both keep "
        f"(bars {FLATTEN_F32_MASK_SHARE}, {FLATTEN_F32_TREND_SHARE}), max "
        f"{float(err.max()):.3g}, 99.99th percentile "
        f"{float(err.kthvalue(int(0.9999 * err.numel())).values):.3g}")
    if (one > FLATTEN_F32_RTOL or agree < FLATTEN_F32_MASK_SHARE
            or within < FLATTEN_F32_TREND_SHARE):
        raise AssertionError("flatten: float32 differs from float64 past "
                             "the bars")


# ---------------------------------------------------------------------------
# --profile: one full-size sweep chunk per regime under torch.profiler
# ---------------------------------------------------------------------------
def chunk_bounds(stack, periods, impl, launch_periods=8):
    """Each kernel's bound over one chunk's launches (:func:`route_call`),
    summed over the chunk's time grids (one shared-grid search each): the
    route ``impl`` gives (``"auto"``: the route rule's), the fused
    kernel's one launch, or the staged route's launches of
    ``launch_periods`` periods, K-SF's and the window scan's each summed
    over them."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls import fold_route
    from lightkurve_tpu_torch.ops.bls_fused import (fold_rows,
                                                    max_nbins_bound,
                                                    nbins_per_period)
    from lightkurve_tpu_torch.parallel.checkpoint import _chunk_nbins, _k_max
    dtype = stack.flux.dtype
    n = stack.shape[1]
    uniform = is_uniform(stack)
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    p_host = np.asarray(periods).astype(numpy_dtype(dtype))
    k_durs = tuple(int(max(int(d / d_phase + 0.5), 1)) for d in DURATIONS)
    common = (k_durs, tuple(float(d) for d in DURATIONS), d_phase)
    nbins = _chunk_nbins(p_host, d_phase, _k_max(DURATIONS, d_phase))
    max_nbp = max_nbins_bound(p_host, d_phase, dtype)
    npad = fold_rows(nbins, max_nbp, max(k_durs))
    pc = torch.as_tensor(p_host, device="cuda")
    meta = lambda *shape: torch.empty(shape, dtype=dtype,  # noqa: E731
                                      device="meta")
    grids, counts = torch.unique(stack.time, dim=0, return_counts=True)
    total = {}

    def add(kernel, ms):
        total[kernel] = total.get(kernel, 0.0) + ms

    for t, B in zip(grids.to(dtype), counts.tolist()):
        ts = t - t.min()
        route = fold_route(impl, max_nbp, max(k_durs), dtype, stack.device,
                           not uniform, curves=B)
        if route == "fused" and uniform:
            add("K-F", bound_fused(ts, meta(n, B), pc, *common, nbins,
                                   max_nbp)[0])
            continue
        if route == "fused":
            add("K-WF", bound_weighted_fused(ts, meta(n, B), meta(n, B), pc,
                                             *common, nbins, max_nbp)[0])
            continue
        cols = B if uniform else 2 * B
        for i in range(0, len(p_host), launch_periods):
            p = pc[i:i + launch_periods]
            C, nbp = p.shape[0], nbins_per_period(p, d_phase)
            add("K-SF", bound_staged_fold(ts, meta(n, cols), p, d_phase,
                                          nbins, max_nbp, max(k_durs))[0])
            if uniform:
                add("K-U", bound_uniform(meta(C, npad, B), meta(C, npad),
                                         nbp, p, meta(B), float(n),
                                         *common)[0])
            else:
                add("K-W", bound_weighted(meta(C, npad, cols), nbp, p,
                                          meta(cols), *common)[0])
    return total


def phase_profile(tmp, B=2048):
    """One SweepRunner chunk per shared-grid cell, traced after a warm-up
    run of the same chunk: the upper 12,500 periods of the uniform cell's
    grid and the upper 2048 of the weighted cell's (B x 8192), chunk 4 of
    the two-sector sweep (its last 1,024 periods, B x 38,880, on the auto
    route), the upper 2048 periods of the mixed-grid sweep and chunk 4 of
    phase 10's search of its flattened sector; phase 10's flatten; and
    the two forced chunks of phases 4 and 6 (the weighted cell's first
    2048 periods on the staged route, the two-sector chunk 4 on the fused
    one) through the entry point (:func:`route_call`).  Prints device
    time per kernel, the device's
    idle share of the chunk's wall time (the profiler adds host cost to
    every launch, so this share is an upper bound of the untraced one) and
    each kernel's bound over the chunk's launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from tools import make_sector as ms
    t = ms.time_grid()
    top = (t[-1] - t[0]) / 3
    flux = np.concatenate([ms.batch_flux(ib, t)[0]
                           for ib in range(B // ms.BATCH)])
    uniform = LightCurveStack.from_numpy(
        np.tile(t, (B, 1)), flux, np.full_like(flux, ms.NOISE),
        np.ones(flux.shape, bool), device="cuda", dtype=torch.float32)
    weighted, _ = spoc_like_stack(B)
    two = long_sector_stack(B, n_sectors=2, p_max=17.0)[0]
    weighted_grid = np.linspace(1.0, top, 4096)
    sector = LightCurveStack.from_numpy(*flatten_arrays(B)[0], device="cuda",
                                        dtype=torch.float32)
    flat = sector.flatten(**FLATTEN_KW)
    cells = (("uniform", uniform, np.linspace(1.0, top, 25_000)[12_500:],
              "auto"),
             ("weighted", weighted, weighted_grid[2048:], "auto"),
             ("two sectors, chunk 4", two,
              np.linspace(*TWO_SECTOR_GRID)[3072:], "auto"),
             ("two sectors, chunk 4, fused route", two,
              np.linspace(*TWO_SECTOR_GRID)[3072:], "fused"),
             ("weighted, chunk 1, staged route", weighted,
              weighted_grid[:2048], "staged"),
             ("mixed grids", mixed_grid_stack(B)[0],
              mixed_grid_periods()[2048:], "auto"),
             ("flatten, window 901", sector, (), "flatten"),
             ("flatten -> search, chunk 4", flat,
              np.linspace(*LONG_GRID)[3072:], "auto"))
    for i, (name, stack, periods, impl) in enumerate(cells):
        def chunk(tag):
            if impl == "flatten":
                stack.flatten(**FLATTEN_KW)
            elif impl == "auto":
                SweepRunner(stack, periods, DURATIONS,
                            os.path.join(tmp, f"profile_{i}_{tag}.npz"),
                            chunk_periods=len(periods), method="shared",
                            async_save=True).run()
            else:
                route_call(stack, periods, impl)
            torch.cuda.synchronize()

        chunk("warm")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("sweep_chunk"):
                chunk("traced")
        events = prof.events()
        span = next(e for e in events if e.name == "sweep_chunk"
                    and e.device_type == DeviceType.CPU).time_range
        spans, by_name = [], {}
        for e in events:
            if e.device_type != DeviceType.CUDA or e.name == "sweep_chunk":
                continue
            spans.append((e.time_range.start, e.time_range.end))
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
        busy, end = 0.0, span.start
        for lo, hi in sorted(spans):
            lo, hi = max(lo, end), min(hi, span.end)
            if hi > lo:
                busy += hi - lo
                end = hi
        wall = span.end - span.start
        device = sum(us for us, _ in by_name.values())
        log(f"profile {name}: B={B} N={stack.shape[1]} P={len(periods)}: "
            f"device "
            f"{device / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms of "
            f"{wall / 1e3:.3f} ms wall, idle {1 - busy / wall:.4f}; "
            f"{peak_memory()}")
        for k, (us, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            log(f"  {us / 1e3:10.3f} ms {us / device:.4f} x{cnt} {k[:100]}")
        if impl != "flatten":
            log(f"  bounds over the chunk's launches: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in
                chunk_bounds(stack, periods, impl).items()))


def kernel_table():
    """Each kernel's wrapper (which counts launches) and plain version
    (which counts calls)."""
    from lightkurve_tpu_torch.ops import (bls_fused, bls_fused_weighted,
                                          bls_staged_fold, bls_window)
    return {"K-F": (bls_fused.fused_scan_uniform,
                    bls_fused.fused_scan_uniform_plain),
            "K-WF": (bls_fused_weighted.fused_scan_weighted,
                     bls_fused_weighted.fused_scan_weighted_plain),
            "K-W": (bls_window.window_scan, bls_window.window_scan_plain),
            "K-U": (bls_window.window_scan_uniform,
                    bls_window.window_scan_uniform_plain),
            "K-SF": (bls_staged_fold.staged_fold,
                     bls_staged_fold.staged_fold_plain)}


def drive(name, fn, *args, expect=(), forbid=()):
    """Run one path with every launch and plain-call count set to 0 just
    before it; read the counts just after.  Fails if a kernel in
    ``expect`` never launched, one in ``forbid`` did, or any plain version
    ran.  Returns (the path's result, its launches per kernel)."""
    table = kernel_table()
    for kern, plain in table.values():
        kern.launches = 0
        plain.calls = 0
    t0 = time.time()
    result = fn(*args)
    launches = {k: kern.launches for k, (kern, _) in table.items()}
    plain_calls = {k: plain.calls for k, (_, plain) in table.items()}
    log(f"{name}: launches {launches}; plain calls {plain_calls}; phase "
        f"{time.time() - t0:.1f}s")
    if any(plain_calls.values()):
        raise AssertionError(f"{name} ran a plain version: {plain_calls}")
    for k in expect:
        if launches[k] < 1:
            raise AssertionError(f"{name} never launched {k}")
    for k in forbid:
        if launches[k]:
            raise AssertionError(f"{name} launched {k}")
    return result, launches


KERNELS = (
    ("K-F", "K-F fused uniform BLS scan", "lightkurve_tpu_torch/csrc/"
     "bls_fused.cu", "lightkurve_tpu/ops/bls_fused_pallas.py:190"),
    ("K-WF", "K-WF fused weighted BLS scan", "lightkurve_tpu_torch/csrc/"
     "bls_weighted_fused.cu", "lightkurve_tpu/ops/bls.py:358-373 (XLA fold) "
     "+ lightkurve_tpu/ops/bls_window_pallas.py:316"),
    ("K-W", "K-W weighted BLS window scan", "lightkurve_tpu_torch/csrc/"
     "bls_window.cu", "lightkurve_tpu/ops/bls_window_pallas.py:316"),
    ("K-U", "K-U uniform BLS window scan", "lightkurve_tpu_torch/csrc/"
     "bls_window_uniform.cu", "lightkurve_tpu/ops/bls_window_pallas.py:253"),
    ("K-SF", "K-SF bin-ordered staged BLS fold", "lightkurve_tpu_torch/csrc/"
     "bls_staged_fold.cu", "lightkurve_tpu/ops/bls.py:340-373 (XLA one-hot "
     "fold + cumsum)"),
)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one sweep chunk per regime instead "
                             "of the checks")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    phase_build()
    if args.profile:
        with tempfile.TemporaryDirectory() as tmp:
            phase_profile(tmp)
        return 0
    phase_kernels()
    runs = {}
    others = lambda *keep: tuple(k for k in kernel_table()  # noqa: E731
                                 if k not in keep)

    def sweep(path, fn, *args):
        """A sweep path: its launches as the route rule gives them."""
        result, runs[path] = drive(path, fn, *args)
        check_routes(path, result.pop("routes"), runs[path])
        return result

    with tempfile.TemporaryDirectory() as tmp:
        uni = sweep("uniform main path (phase 3)", phase_uniform, tmp)
        wei = sweep("weighted main path (phase 4)", phase_weighted, tmp)
        runs.update(compare_routes("weighted, chunk 1",
                                   *wei.pop("route_check")))
        lng = sweep("long-sector sweep (phase 6)", phase_long_sector, tmp,
                    "long sector", 1, LONG_GRID, 8.5)
        two = sweep("two-sector sweep (phase 6)", lambda: phase_long_sector(
            tmp, "two sectors", 2, TWO_SECTOR_GRID, 17.0, staged_chunk=3))
        runs.update(compare_routes("two sectors, chunk 4",
                                   *two.pop("route_check")))
        stack, p_inj, per = mixed_grid_stack()
        mix = sweep("mixed-grid sweep (phase 7)", phase_mixed_grid, tmp,
                    stack, p_inj)
        check_mixed_against_single(tmp, stack, mix, per)
        del stack
        path = "per-curve sweeps (phase 8)"
        pcv, runs[path] = drive(path, phase_percurve, tmp, forbid=others())
        torch.cuda.empty_cache()
        flt = sweep("flatten -> search (phase 10)", phase_flatten, tmp)
        check_flatten(flt.pop("arrays"))
        flatten_limits(tmp)
    torch.cuda.empty_cache()
    path = "past the one-hot ceiling (phase 9)"
    big, runs[path] = drive(path, phase_past_ceiling,
                            expect=("K-SF", "K-U"),
                            forbid=others("K-SF", "K-U"))
    check_past_ceiling(big)
    del big
    torch.cuda.empty_cache()
    errs, times, bounds, per_launch = phase_main_shapes()
    long, library, kf_err = phase_long_shapes()
    for key, (e, t, b, per) in long.items():
        errs[key], times[key], bounds[key], per_launch[key] = e, t, b, per
    errs["K-F"] = max(errs["K-F"], kf_err)
    phase_routes()
    log(f"main paths: uniform {uni['rate']:.6g}, weighted "
        f"{wei['rate']:.6g}, long sector {lng['rate']:.6g}, two sectors "
        f"{two['rate']:.6g}, mixed grids {mix['rate']:.6g}, flatten -> "
        f"search {flt['rate']:.6g} curve-period evals/s (flatten "
        f"{flt['flatten_s']:.3f}s); per-curve fast "
        f"{pcv['fast']['seconds']:.3f}s, exact "
        f"{pcv['exact']['seconds']:.3f}s; "
        f"smoke {time.time() - t_start:.1f}s")
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         "launches": sum(r[key] for r in runs.values()),
         "launches_by_path": {p: r[key] for p, r in runs.items() if r[key]},
         "max_abs_err": errs[key], "ms": times[key][0],
         "plain_ms": times[key][1], "bound_ms": bounds[key][0],
         "bound_by": bounds[key][1],
         "library_ms": library if key == "K-SF" else None,
         "launch_ms": per_launch.get(key, (None, None))[0],
         "launch_bound_ms": per_launch.get(key, (None, None))[1]}
        for key, name, source, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
