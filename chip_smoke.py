"""Drive lightkurve_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. build the CUDA kernels (K-F, K-W) from the checkout's sources;
  2. hold each kernel against its plain torch version on the card at a
     small shape, in float64 (exact logic) and float32, over both edge
     modes and objectives, and at the tile-edge grid where a period needs
     one bin more than the host count (rows sized from the bound: equal;
     sized from the count: NaN, as the plain versions give);
  3. uniform main path at full size: a 2048-file synthetic TESS sector
     written with the port's FITS writer, streamed through
     StreamingStackLoader into SweepRunner(method="shared");
  4. weighted main path at full size: a SPOC-like in-memory stack
     (per-cadence dy, ~3% masked cadences) through SweepRunner;
  5. each kernel against its plain version at the main path's shapes
     (2048 curves x 8192 cadences, the grid's longest periods, the
     sweep's bin count and the host bound of ops.bls), in float64 and
     float32, and both timed in float32.

Prints the card, a JSON line of kernel records, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure, and
when no CUDA device is present.

    python3 chip_smoke.py --profile

builds the kernels and profiles one full-size sweep chunk per regime
instead (torch.profiler: device time per kernel, the device's idle
share).
"""
import argparse
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


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_memory(device):
    import torch
    if torch.device(device).type != "cuda":
        return "peak device memory not measured (CPU)"
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
def check_inputs(dtype, B=256, n=2048, P=257, seed=7, device="cuda"):
    """Shared-grid inputs at the check shape: injected transits, per-
    cadence dy with ~3% masked cadences, the north-star durations."""
    import torch
    from lightkurve_tpu_torch.ops.bls import _weighted_fold
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from tools import make_sector as ms
    dev = torch.device(device)
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
    folds = {}
    for wrap in (True, False):
        parts = [_weighted_fold(ts, WWY, pc[i:i + 64], d_phase, nbins,
                                max_nbp, max(k_durs), wrap)
                 for i in range(0, P, 64)]
        folds[wrap] = (torch.cat([c for c, _ in parts]).contiguous(),
                       torch.cat([b for _, b in parts]).contiguous())
    return dict(ts=ts, Y0=Y0, pc=pc, k_durs=k_durs,
                dur_values=tuple(float(d) for d in DURATIONS),
                d_phase=d_phase, nbins=nbins, max_nbp=max_nbp, total=total,
                folds=folds)


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
    """K-F and K-W against their plain versions, both edge modes and both
    objectives, float64 then float32.  Returns per-kernel f32 errors."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    errs = {"K-F": 0.0, "K-W": 0.0}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        x = check_inputs(dtype)
        C, npad, twoB = x["folds"][True][0].shape
        log(f"check {dtype}: B={twoB // 2} n={x['ts'].shape[0]} P={C} "
            f"nbins={x['nbins']} k_durs={x['k_durs']}")
        common = (x["k_durs"], x["dur_values"], x["d_phase"])
        for wrap in (True, False):
            for like in (True, False):
                tag = f"{'wrap' if wrap else 'astropy'}/" \
                      f"{'likelihood' if like else 'snr'}"
                got = bls_fused.fused_scan_uniform(
                    x["ts"], x["Y0"], x["pc"], *common, x["nbins"],
                    x["max_nbp"], like, wrap)
                want = bls_fused.fused_scan_uniform_plain(
                    x["ts"], x["Y0"], x["pc"], *common, x["nbins"],
                    x["max_nbp"], like, wrap)
                torch.cuda.synchronize()
                e, _ = compare(f"K-F {tag}", got, want, f64)
                csum, nbp = x["folds"][wrap]
                got = bls_window.window_scan(csum, nbp, x["pc"], x["total"],
                                             *common, like)
                want = bls_window.window_scan_plain(
                    csum, nbp, x["pc"], x["total"], *common, like)
                torch.cuda.synchronize()
                e2, _ = compare(f"K-W {tag}", got, want, f64)
                if not f64:
                    errs["K-F"] = max(errs["K-F"], e)
                    errs["K-W"] = max(errs["K-W"], e2)
    check_tile_edge()
    return errs


def check_tile_edge(B=256, n=2048, seed=11):
    """The float64 tile-edge grid of tests/test_torch_bls.py on the card:
    the longest period (0.71 d + 1e-16) has 72 bins by the device's rule
    and 71 by ceil(p / d_phase), and 71 + 58 - 1 rows fill one 128-row
    tile.  With rows sized from the host bound both kernels equal their
    plain versions; with rows sized from the count alone that period is
    NaN in kernel and plain version alike, and the others are unchanged."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    from lightkurve_tpu_torch.ops.bls import _weighted_fold
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
    WWY = torch.cat([torch.ones_like(Y0), Y0], 1)
    common = (k_durs, dvals, d_phase)

    def run(rows_bound):
        csum, nbp = _weighted_fold(ts, WWY, pc, d_phase, nbins, rows_bound,
                                   max(k_durs))
        args = (csum, nbp, pc, WWY.sum(0), *common)
        fargs = (ts, Y0, pc, *common, nbins, rows_bound)
        return {"K-F": (bls_fused.fused_scan_uniform(*fargs),
                        bls_fused.fused_scan_uniform_plain(*fargs)),
                "K-W": (bls_window.window_scan(*args),
                        bls_window.window_scan_plain(*args))}

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


def phase_uniform(tmp, B=2048, n_periods=25_000, chunk_periods=12_500,
                  device="cuda"):
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
                                  dtype=torch.float32, device=device)
    reset_peak(device)
    t0 = time.time()
    best, fluxes = [], []
    sweep_s = 0.0
    for k, stack in enumerate(loader):
        sync(device)
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
        f"recovered {share:.4f}; {peak_memory(device)}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"uniform recovery {share} < {RECOVERY_SHARE}")
    # the loader's side-stream copies with batches in flight: the same
    # files in quarter batches, device work queued on each before the
    # next is staged, must give the same flux as the one big batch
    flux = torch.cat(fluxes)
    quarter = StreamingStackLoader(paths, batch_size=B // 4, length=ms.N,
                                   dtype=torch.float32, device=device)
    for k, stack in enumerate(quarter):
        torch.cumsum(stack.flux, 1)
        if not torch.equal(stack.flux, flux[k * (B // 4):(k + 1) * (B // 4)]):
            raise AssertionError(f"streamed batch {k} differs")
    log(f"uniform: {k + 1} streamed batches of {B // 4} equal the "
        f"{B}-curve batch")
    return dict(seconds=sweep_s, rate=rate, recovered=share)


def spoc_like_stack(B=2048, seed=2024, device="cuda", dtype=None):
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
    t0_inj = rng.uniform(0, p_inj)
    for i in range(B):
        ph = np.mod(t - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.05] -= ms.DEPTH
    mask = rng.random((B, ms.N)) >= 0.03
    flux[~mask] = 0.0
    stack = LightCurveStack.from_numpy(np.tile(t, (B, 1)), flux,
                                       dy, mask, device=device,
                                       dtype=dtype or torch.float32)
    return stack, p_inj


def phase_weighted(tmp, B=2048, n_periods=4096, chunk_periods=2048,
                   device="cuda"):
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from tools import make_sector as ms
    stack, p_inj = spoc_like_stack(B, device=device)
    t = ms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, n_periods)
    sync(device)
    reset_peak(device)
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
        f"recovered {share:.4f}; {peak_memory(device)}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"weighted recovery {share} < {RECOVERY_SHARE}")
    return dict(seconds=sweep_s, rate=rate, recovered=share)


# ---------------------------------------------------------------------------
# phase 5: kernels against plain, and their times, at the main path's shapes
# ---------------------------------------------------------------------------
def main_shape_inputs(dtype, P, B=2048):
    """Both kernels' inputs as the main path gives them: B curves x 8192
    cadences (the SPOC-like batch), the P longest periods of the uniform
    cell's grid (the most bins), the north-star durations, the bin count
    SweepRunner's step picks for them and the host bound ops.bls sizes
    the kernels' rows with; the weighted fold in SweepRunner's chunks of
    8 periods."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls import _weighted_fold
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
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
    W = torch.where(stack.mask, 1.0 / stack.flux_err ** 2, 0.0)
    W = W / W.mean()
    mu = (W * Y).sum(1, keepdim=True) / W.sum(1, keepdim=True)
    WWY = torch.cat([W.T, (W * (Y - mu)).T], 1).contiguous()
    total = WWY.sum(0)

    def fold():
        return [_weighted_fold(ts, WWY, pc[i:i + 8], d_phase, nbins,
                               max_nbp, k_max) for i in range(0, P, 8)]

    parts = fold()
    csum = torch.cat([c for c, _ in parts]).contiguous()
    nbp = torch.cat([b for _, b in parts]).contiguous()
    del parts
    common = (k_durs, tuple(float(d) for d in DURATIONS), d_phase)
    return dict(fold_args=(ts, Y0, pc, *common, nbins, max_nbp, True, True,
                           8),
                win_args=(csum, nbp, pc, total, *common, True), fold=fold,
                desc=f"B={B} N={ms.N} P={P} (periods {p_host[0]:.4f}-"
                     f"{p_host[-1]:.4f} d, {max_nbp} bins, fold sized for "
                     f"{nbins}) {dtype}")


def phase_main_shapes():
    """Each kernel against its plain version on the same inputs at the main
    path's shapes, float64 (64 periods) then float32 (256 periods); the
    float32 pair timed plain, kernel, kernel, plain.  Returns the float32
    max |power error| and (kernel ms, plain ms) per kernel."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    errs, times = {}, {}
    for dtype, P in ((torch.float64, 64), (torch.float32, 256)):
        f64 = dtype == torch.float64
        x = main_shape_inputs(dtype, P)
        log(f"main shapes: {x['desc']}")
        for name, kern, plain, args in (
                ("K-F", bls_fused.fused_scan_uniform,
                 bls_fused.fused_scan_uniform_plain, x["fold_args"]),
                ("K-W", bls_window.window_scan, bls_window.window_scan_plain,
                 x["win_args"])):
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            e, _ = compare(f"{name} main shapes", got, want, f64)
            del got, want
            if f64:
                continue
            errs[name] = e
            p1 = cuda_time_ms(lambda: plain(*args))
            k1 = cuda_time_ms(lambda: kern(*args))
            k2 = cuda_time_ms(lambda: kern(*args))
            p2 = cuda_time_ms(lambda: plain(*args))
            times[name] = (min(k1, k2), min(p1, p2))
            log(f"times {name}: kernel {k1:.3f}/{k2:.3f} ms, plain "
                f"{p1:.3f}/{p2:.3f} ms")
        if not f64:
            log(f"times weighted fold (one-hot matmul + cumsum, torch): "
                f"{cuda_time_ms(x['fold']):.3f} ms for the same {P} periods")
        del x
        torch.cuda.empty_cache()
    return errs, times


# ---------------------------------------------------------------------------
# --profile: one full-size sweep chunk per regime under torch.profiler
# ---------------------------------------------------------------------------
def phase_profile(tmp, B=2048):
    """One SweepRunner chunk per regime at B x 8192, traced after a warm-up
    run of the same chunk: the upper 12,500 periods of the uniform cell's
    grid, the upper 2048 of the weighted cell's.  Prints device time per
    kernel and the device's idle share of the chunk's wall time (the
    profiler adds host cost to every launch, so this share is an upper
    bound of the untraced one)."""
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
    cells = (("uniform", uniform, np.linspace(1.0, top, 25_000)[12_500:]),
             ("weighted", weighted, np.linspace(1.0, top, 4096)[2048:]))
    for name, stack, periods in cells:
        def chunk(tag):
            SweepRunner(stack, periods, DURATIONS,
                        os.path.join(tmp, f"profile_{name}_{tag}.npz"),
                        chunk_periods=len(periods), method="shared",
                        async_save=True).run()
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
        log(f"profile {name}: B={B} N={ms.N} P={len(periods)}: device "
            f"{device / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms of "
            f"{wall / 1e3:.3f} ms wall, idle {1 - busy / wall:.4f}; "
            f"{peak_memory('cuda')}")
        for k, (us, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            log(f"  {us / 1e3:10.3f} ms {us / device:.4f} x{cnt} {k[:100]}")


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
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if args.profile:
        with tempfile.TemporaryDirectory() as tmp:
            phase_profile(tmp)
        return 0
    phase_kernels()
    counters = (bls_fused.fused_scan_uniform, bls_window.window_scan)
    plains = (bls_fused.fused_scan_uniform_plain,
              bls_window.window_scan_plain)
    for c in counters:
        c.launches = 0
    for p in plains:
        p.calls = 0
    with tempfile.TemporaryDirectory() as tmp:
        uni = phase_uniform(tmp)
        if bls_fused.fused_scan_uniform.launches < 1:
            raise AssertionError("uniform main path never launched K-F")
        wei = phase_weighted(tmp)
        launches = {"K-F": bls_fused.fused_scan_uniform.launches,
                    "K-W": bls_window.window_scan.launches}
        plain_calls = [p.calls for p in plains]
    log(f"main path launches: {launches}; plain calls: {plain_calls}")
    if launches["K-W"] < 1:
        raise AssertionError("weighted main path never launched K-W")
    if any(plain_calls):
        raise AssertionError(f"main path ran a plain version: {plain_calls}")
    errs, times = phase_main_shapes()
    log(f"main path: uniform {uni['rate']:.6g} evals/s, weighted "
        f"{wei['rate']:.6g} evals/s")
    kernels = [
        {"name": "K-F fused uniform BLS scan", "route": "cuda",
         "source": "lightkurve_tpu_torch/csrc/bls_fused.cu",
         "replaces": "lightkurve_tpu/ops/bls_fused_pallas.py:190",
         "launches": launches["K-F"], "max_abs_err": errs["K-F"],
         "ms": times["K-F"][0], "plain_ms": times["K-F"][1]},
        {"name": "K-W weighted BLS window scan", "route": "cuda",
         "source": "lightkurve_tpu_torch/csrc/bls_window.cu",
         "replaces": "lightkurve_tpu/ops/bls_window_pallas.py:316",
         "launches": launches["K-W"], "max_abs_err": errs["K-W"],
         "ms": times["K-W"][0], "plain_ms": times["K-W"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
