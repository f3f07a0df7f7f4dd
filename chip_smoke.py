"""Drive lightkurve_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. build the CUDA kernels (K-F, K-W, K-U) from the checkout's sources,
     one nvcc per source, all started together;
  2. hold each kernel against its plain torch version on the card at a
     small shape, in float64 (exact logic) and float32, over both edge
     modes and objectives, and at the tile-edge grid where a period needs
     one bin more than the host count (rows sized from the bound: equal;
     sized from the count: NaN, as the plain versions give);
  3. uniform main path at full size: a 2048-file synthetic TESS sector
     written with the port's FITS writer, streamed through
     StreamingStackLoader into SweepRunner(method="shared") (K-F);
  4. weighted main path at full size: a SPOC-like in-memory stack
     (per-cadence dy, ~3% masked cadences) through SweepRunner (K-W);
  6. the long-baseline uniform sweeps, 2048 curves, 4,096 periods in four
     chunks each: one 27-d sector (19,440 cadences) over 1-9 d, where K-F
     takes every chunk (the last at its 16-curve tile), and two
     consecutive sectors (38,880 cadences) over 1-18 d, whose last chunk
     needs more rows than a 16-curve K-F tile holds and takes the staged
     route (torch fold + K-U); each chunk's route is checked against the
     rule;
  7. the mixed-grid sweep: 2048 SPOC-like curves on four sector grids,
     one shared-grid search per grid (K-W), held against four single-grid
     sweeps of the same rows;
  8. the per-curve methods, SweepRunner(method="fast") and "exact", at
     2048 x 8192 (plain torch, no kernel);
  5. each kernel against its plain version at its main path's shapes, in
     float64 and float32, timed in float32, with its bound (the larger of
     bytes over the memory rate and operations over the float32 rate):
     K-F and K-W on the 8,192-cadence batch, K-U on the two-sector
     sweep's staged chunk, and K-F (float32) at its 16-curve tile on the
     one- and two-sector sweeps' chunks that run it so; and K-F at the
     tile it gets against the staged route on the same inputs, at the
     one-sector sweep's longest periods (16 curves), at 16.4-16.9 d on
     one sector and at the two-sector sweep's longest periods (8).
Each main path (3, 4, 6, 7, 8) runs with every launch count set to 0
just before it and read just after; a path fails if a kernel it needs
never launched or a plain version ran.

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
    from lightkurve_tpu_torch.ops.bls import _weighted_fold
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
        parts = [_weighted_fold(ts, WWY, pc[i:i + 64], d_phase, nbins,
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
                folds=folds, ufolds=ufolds)


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
    """K-F, K-W and K-U against their plain versions, both edge modes and
    both objectives, float64 then float32.  Returns per-kernel f32
    errors."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    errs = {"K-F": 0.0, "K-W": 0.0, "K-U": 0.0}
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
                cs_y, cs_n, unbp = x["ufolds"][wrap]
                uargs = (cs_y, cs_n, unbp, x["pc"], x["Y0"].sum(0),
                         float(x["Y0"].shape[0]), *common, like)
                got = bls_window.window_scan_uniform(*uargs)
                want = bls_window.window_scan_uniform_plain(*uargs)
                torch.cuda.synchronize()
                e3, _ = compare(f"K-U {tag}", got, want, f64)
                if not f64:
                    errs["K-F"] = max(errs["K-F"], e)
                    errs["K-W"] = max(errs["K-W"], e2)
                    errs["K-U"] = max(errs["K-U"], e3)
    check_tile_edge()
    return errs


def check_tile_edge(B=256, n=2048, seed=11):
    """The float64 tile-edge grid of tests/test_torch_bls.py on the card:
    the longest period (0.71 d + 1e-16) has 72 bins by the device's rule
    and 71 by ceil(p / d_phase), and 71 + 58 - 1 rows fill one 128-row
    tile.  With rows sized from the host bound every kernel equals its
    plain version; with rows sized from the count alone that period is
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
        cs_y, cs_n, unbp = bls_fused.uniform_fold(ts, Y0, pc, d_phase, nbins,
                                                  rows_bound, max(k_durs))
        uargs = (cs_y, cs_n, unbp, pc, Y0.sum(0), float(n), *common)
        return {"K-F": (bls_fused.fused_scan_uniform(*fargs),
                        bls_fused.fused_scan_uniform_plain(*fargs)),
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
    sweep_s = 0.0
    for k, stack in enumerate(loader):
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
    return dict(seconds=sweep_s, rate=rate, recovered=share)


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
    t0_inj = rng.uniform(0, p_inj)
    for i in range(B):
        ph = np.mod(t - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.05] -= ms.DEPTH
    mask = rng.random((B, ms.N)) >= 0.03
    flux[~mask] = 0.0
    stack = LightCurveStack.from_numpy(np.tile(t, (B, 1)), flux,
                                       dy, mask, device="cuda",
                                       dtype=dtype or torch.float32)
    return stack, p_inj


def phase_weighted(tmp, B=2048, n_periods=4096, chunk_periods=2048):
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
    max |power error|, (kernel ms, plain ms) and (bound ms, bound by) per
    kernel."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    errs, times, bounds = {}, {}, {}
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
            times[name] = time_pair(name, kern, plain, args)
            bounds[name] = (bound_fused(*args) if name == "K-F"
                            else bound_weighted(*args))
        if not f64:
            log(f"times weighted fold (one-hot matmul + cumsum, torch): "
                f"{cuda_time_ms(x['fold']):.3f} ms for the same {P} periods")
        del x
        torch.cuda.empty_cache()
    return errs, times, bounds


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
#: operations per window and curve of the weighted scan (K-W), whose
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


def bound_fused(ts, Y0, pc, k_durs, dur_values, d_phase, nbins, max_nbp,
                like=True, wrap=True, chunk=8):
    """K-F: reads the flux (n, B) and times once; per period it deposits
    every sample (twice with the wrap copy) into each curve's rows and the
    shared count rows, takes their prefix and scans the windows."""
    from lightkurve_tpu_torch.ops.bls_fused import nbins_per_period
    n, B = Y0.shape
    item = Y0.element_size()
    nbp = nbins_per_period(pc, d_phase).cpu().numpy()
    rows = int(np.sum(nbp + max(k_durs) - 1))
    fold = (B + 1) * ((2 if wrap else 1) * n * len(nbp) + rows)
    return _bound((n * B + n + B) * item + _outputs_bytes(len(nbp), B, item),
                  fold + _uniform_scan_ops(B, _windows(nbp, k_durs)))


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


# ---------------------------------------------------------------------------
# phase 5, second half: the long-baseline sweeps' shapes (K-U on the staged
# route, K-F at its 16-curve tile)
# ---------------------------------------------------------------------------
LONG_N = 19_440             # 27.0 d of two-minute cadences: one TESS sector
SECTOR_DAYS = 27.4          # one TESS sector: the offset between sectors
LONG_GRID = (1.0, 9.0, 4096)
#: two consecutive sectors (the second starts 27.4 d after the first),
#: searched to baseline/3
TWO_SECTOR_GRID = (1.0, 18.0, 4096)


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
    t0_inj = rng.uniform(0, p_inj)
    for i in range(B):
        ph = np.mod(t - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.05] -= ms.DEPTH
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
    Y0 = (stack.flux - stack.flux.mean(1, keepdim=True)).T.contiguous()
    del stack
    common = (k_durs, tuple(float(d) for d in DURATIONS), d_phase)
    return dict(ts=ts, Y0=Y0, pc=pc, p_host=p_host, common=common,
                nbins=nbins, max_nbp=max_nbp,
                fused_args=(ts, Y0, pc, *common, nbins, max_nbp, True, True,
                            8),
                desc=f"B={B} N={ts.shape[0]} P={len(p_host)} (periods "
                     f"{p_host[0]:.4f}-{p_host[-1]:.4f} d, {max_nbp} bins, "
                     f"{max_nbp + max(k_durs) - 1} rows) {dtype}")


def uniform_window_args(x):
    """K-U's arguments for the inputs ``x`` of :func:`long_inputs`: the
    uniform fold in SweepRunner's calls of 8 periods, concatenated."""
    import torch
    from lightkurve_tpu_torch.ops.bls_fused import uniform_fold
    ts, Y0, pc, common = x["ts"], x["Y0"], x["pc"], x["common"]
    k_durs, _, d_phase = common
    parts = [uniform_fold(ts, Y0, pc[i:i + 8], d_phase, x["nbins"],
                          x["max_nbp"], max(k_durs))
             for i in range(0, pc.shape[0], 8)]
    cs_y, cs_n, nbp = (torch.cat([p[j] for p in parts]).contiguous()
                       for j in range(3))
    del parts
    return (cs_y, cs_n, nbp, pc, Y0.sum(0), float(Y0.shape[0]), *common,
            True)


def fused_tile(x):
    """Curves per block K-F runs for the inputs ``x`` on this card."""
    from lightkurve_tpu_torch.ops import bls_fused
    rows_cap = x["max_nbp"] + max(x["common"][0]) - 1
    optin = bls_fused.shared_memory_optin(x["Y0"].device)
    tile = bls_fused.FUSED_TILE
    while not bls_fused.fused_tile_fits(rows_cap, x["Y0"].dtype, optin, tile):
        tile //= 2
    return tile


def route_times(x):
    """K-F at the tile it gets against the staged route (the torch fold and
    K-U in SweepRunner's 8-period calls) on the inputs ``x``, timed staged,
    K-F, K-F, staged; logs the rows, the tile and the route 'auto' takes."""
    from lightkurve_tpu_torch.ops import bls_fused
    from lightkurve_tpu_torch.ops.bls import _staged_scan_uniform, fold_route
    args = x["fused_args"][:-3] + (True,)
    staged = lambda: _staged_scan_uniform(  # noqa: E731
        *args, chunk=8, wrap=True)
    fused = lambda: bls_fused.fused_scan_uniform(  # noqa: E731
        *args, wrap=True, chunk=8)
    s1 = cuda_time_ms(staged, reps=2)
    f1 = cuda_time_ms(fused, reps=2)
    f2 = cuda_time_ms(fused, reps=2)
    s2 = cuda_time_ms(staged, reps=2)
    route = fold_route("auto", x["max_nbp"], max(x["common"][0]),
                       x["Y0"].dtype, x["Y0"].device)
    log(f"routes at {x['desc']}: auto takes {route!r}; K-F at a "
        f"{fused_tile(x)}-curve tile {f1:.3f}/{f2:.3f} ms, staged route "
        f"(fold + K-U, 8 periods per call) {s1:.3f}/{s2:.3f} ms")


def phase_long_shapes(slice_periods=32):
    """K-U where the main path runs it, the two-sector sweep's staged
    chunk 4 (2048 x 38,880, its longest periods): against its plain version
    in float64 (64 periods) then float32 (256 periods in one launch; the
    plain version in slices of 32), timed, with its time per 8-period
    launch.  K-F against its plain version at its 16-curve tile, float32,
    where the main path runs it so: the one-sector sweep's chunk 4 and the
    two-sector sweep's chunk 3.  Both uniform routes timed on the same
    inputs (:func:`route_times`) at the one-sector sweep's longest periods
    (K-F at 16 curves), at 16.4-16.9 d on one sector (K-F at 8) and at the
    two-sector sweep's longest periods (K-F at 8).
    Returns K-U's float32 max |power error|, (kernel ms, plain ms) and
    (bound ms, bound by), and K-F's float32 max |power error| here."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    kern, plain = (bls_window.window_scan_uniform,
                   bls_window.window_scan_uniform_plain)
    two = np.linspace(*TWO_SECTOR_GRID)
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
            del x, args, cs_y, cs_n
            torch.cuda.empty_cache()
            continue
        times = time_pair("K-U", kern, plain, args, plain_sliced)
        bound = bound_uniform(*args)
        narrow = tuple(a[:8] for a in args[:4]) + args[4:]
        per_launch = cuda_time_ms(lambda: kern(*narrow))
        tiles = -(-cs_y.shape[2] // 32)
        log(f"K-U launch width: grid ({P}, {tiles}) blocks of 32 x 8 "
            f"threads for {P} periods, (8, {tiles}) at the main path's 8 "
            f"periods per call: {per_launch:.3f} ms per "
            f"8-period launch, {times[0]:.3f} ms for {P} periods in one "
            f"launch; bound {bound[0]:.3f} ms ({bound[1]})")
        del args, narrow, cs_y, cs_n
        torch.cuda.empty_cache()
    kf_err = 0.0
    for n_sectors, p_host in ((1, np.linspace(*LONG_GRID)[-256:]),
                              (2, two[2048:3072][-256:])):
        y = long_inputs(torch.float32, n_sectors, p_host)
        tile = fused_tile(y)
        if tile != 16:
            raise AssertionError(f"K-F takes a {tile}-curve tile at "
                                 f"{y['desc']}, not 16")
        got = bls_fused.fused_scan_uniform(*y["fused_args"])
        want = bls_fused.fused_scan_uniform_plain(*y["fused_args"])
        torch.cuda.synchronize()
        log(f"long shapes, K-F: {y['desc']}, {tile}-curve tile")
        kf_err = max(kf_err, compare(f"K-F {tile}-curve tile", got, want,
                                     False)[0])
        del got, want
        if n_sectors == 1:
            route_times(y)
        del y
        torch.cuda.empty_cache()
    # past K-F's 16-curve tile on one sector's cadences, then on two
    route_times(long_inputs(torch.float32, 1, np.linspace(16.4, 16.9, 256)))
    route_times(x)
    del x
    torch.cuda.empty_cache()
    return e, times, bound, kf_err


# ---------------------------------------------------------------------------
# phases 6-8: the long-sector, mixed-grid and per-curve sweeps at full width
# ---------------------------------------------------------------------------
def expected_routes(periods, chunk_periods, dtype):
    """What the route rule gives each chunk of a uniform shared sweep
    (SweepRunner pads the last chunk by repeating its last period): the
    number of chunks on K-F and the K-U launches of the staged chunks (one
    per 8 periods)."""
    import torch
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls import fold_route
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from lightkurve_tpu_torch.parallel.checkpoint import _k_max
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    fused = staged = 0
    for lo in range(0, len(periods), chunk_periods):
        chunk = periods[lo:lo + chunk_periods].astype(numpy_dtype(dtype))
        route = fold_route("auto", max_nbins_bound(chunk, d_phase, dtype),
                           _k_max(DURATIONS, d_phase), dtype,
                           torch.device("cuda"))
        fused += route == "fused"
        staged += (route == "staged") * -(-chunk_periods // 8)
    return {"K-F": fused, "K-U": staged}


def phase_long_sector(tmp, name, n_sectors, grid, p_max, B=2048,
                      chunk_periods=1024):
    """Phase 6: a long-baseline uniform sweep, 4,096 periods in four
    chunks: one 27-d sector searched over 1-9 d (K-F takes every chunk,
    the last at its 16-curve tile), and two consecutive sectors searched
    over 1-18 d (the last chunk's rows pass K-F's 16-curve tile, so it
    takes the staged route).  Returns the sweep's numbers and the launches
    the route rule predicts."""
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
    return dict(seconds=sweep_s, rate=rate, recovered=share,
                routes=expected_routes(periods, chunk_periods,
                                       torch.float32))


def check_routes(name, result, launches):
    """Each chunk went where the route rule sends it."""
    want = result["routes"]
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{name}: launches {launches}, the route rule "
                             f"gives {want}")




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
    return dict(seconds=sweep_s, rate=rate, recovered=share, state=state)


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
# --profile: one full-size sweep chunk per regime under torch.profiler
# ---------------------------------------------------------------------------
def phase_profile(tmp, B=2048):
    """One SweepRunner chunk per shared-grid cell, traced after a warm-up
    run of the same chunk: the upper 12,500 periods of the uniform cell's
    grid and the upper 2048 of the weighted cell's (B x 8192), the staged
    chunk of the two-sector sweep (its last 1,024 periods, B x 38,880)
    and the upper 2048 periods of the mixed-grid sweep.  Prints device
    time per kernel and the device's idle share of the chunk's wall time
    (the profiler adds host cost to every launch, so this share is an
    upper bound of the untraced one)."""
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
             ("weighted", weighted, np.linspace(1.0, top, 4096)[2048:]),
             ("two sectors, staged chunk",
              long_sector_stack(B, n_sectors=2, p_max=17.0)[0],
              np.linspace(*TWO_SECTOR_GRID)[3072:]),
             ("mixed grids", mixed_grid_stack(B)[0],
              mixed_grid_periods()[2048:]))
    for i, (name, stack, periods) in enumerate(cells):
        def chunk(tag):
            SweepRunner(stack, periods, DURATIONS,
                        os.path.join(tmp, f"profile_{i}_{tag}.npz"),
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
        log(f"profile {name}: B={B} N={stack.shape[1]} P={len(periods)}: "
            f"device "
            f"{device / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms of "
            f"{wall / 1e3:.3f} ms wall, idle {1 - busy / wall:.4f}; "
            f"{peak_memory()}")
        for k, (us, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            log(f"  {us / 1e3:10.3f} ms {us / device:.4f} x{cnt} {k[:100]}")


def kernel_table():
    """Each kernel's wrapper (which counts launches) and plain version
    (which counts calls)."""
    from lightkurve_tpu_torch.ops import bls_fused, bls_window
    return {"K-F": (bls_fused.fused_scan_uniform,
                    bls_fused.fused_scan_uniform_plain),
            "K-W": (bls_window.window_scan, bls_window.window_scan_plain),
            "K-U": (bls_window.window_scan_uniform,
                    bls_window.window_scan_uniform_plain)}


def drive(name, fn, *args, expect=(), forbid=()):
    """Run one main path with every launch and plain-call count set to 0
    just before it; read the counts just after.  Fails if a kernel in
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
    ("K-W", "K-W weighted BLS window scan", "lightkurve_tpu_torch/csrc/"
     "bls_window.cu", "lightkurve_tpu/ops/bls_window_pallas.py:316"),
    ("K-U", "K-U uniform BLS window scan", "lightkurve_tpu_torch/csrc/"
     "bls_window_uniform.cu", "lightkurve_tpu/ops/bls_window_pallas.py:253"),
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
    with tempfile.TemporaryDirectory() as tmp:
        uni, runs["uniform"] = drive("uniform main path (phase 3)",
                                     phase_uniform, tmp, expect=("K-F",),
                                     forbid=("K-U",))
        wei, runs["weighted"] = drive("weighted main path (phase 4)",
                                      phase_weighted, tmp, expect=("K-W",))
        lng, runs["long"] = drive("long-sector sweep (phase 6)",
                                  phase_long_sector, tmp, "long sector", 1,
                                  LONG_GRID, 8.5, expect=("K-F",))
        check_routes("long sector", lng, runs["long"])
        two, runs["two"] = drive("two-sector sweep (phase 6)",
                                 phase_long_sector, tmp, "two sectors", 2,
                                 TWO_SECTOR_GRID, 17.0,
                                 expect=("K-F", "K-U"))
        check_routes("two sectors", two, runs["two"])
        stack, p_inj, per = mixed_grid_stack()
        mix, runs["mixed"] = drive("mixed-grid sweep (phase 7)",
                                   phase_mixed_grid, tmp, stack, p_inj,
                                   expect=("K-W",))
        check_mixed_against_single(tmp, stack, mix, per)
        del stack
        pcv, runs["per-curve"] = drive("per-curve sweeps (phase 8)",
                                       phase_percurve, tmp,
                                       forbid=("K-F", "K-W", "K-U"))
    torch.cuda.empty_cache()
    errs, times, bounds = phase_main_shapes()
    errs["K-U"], times["K-U"], bounds["K-U"], kf_err = phase_long_shapes()
    errs["K-F"] = max(errs["K-F"], kf_err)
    log(f"main paths: uniform {uni['rate']:.6g}, weighted "
        f"{wei['rate']:.6g}, long sector {lng['rate']:.6g}, two sectors "
        f"{two['rate']:.6g}, mixed grids {mix['rate']:.6g} curve-period "
        f"evals/s; per-curve fast "
        f"{pcv['fast']['seconds']:.3f}s, exact "
        f"{pcv['exact']['seconds']:.3f}s; "
        f"smoke {time.time() - t_start:.1f}s")
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces,
         "launches": sum(r[key] for r in runs.values()),
         "max_abs_err": errs[key], "ms": times[key][0],
         "plain_ms": times[key][1], "bound_ms": bounds[key][0],
         "bound_by": bounds[key][1], "library_ms": None}
        for key, name, source, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
