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
 11. Lomb-Scargle on the stack (plain torch: index_add_ and torch.fft, no
     BLS kernel may launch), each part a path of its own: (1)
     LightCurveStack.to_periodogram() on phase 10's raw sector in float32
     (timed, peak memory, the rotation recovered on 99% of curves,
     float32 vs float64 on the card, float64 card vs CPU on 64 curves);
     (2) lombscargle_fast at the bench's LS shape, 2048 x 8,192 at 16,384
     frequencies; (3) phase 7's four-grid stack against single-grid calls;
     (4) fastchi2 (3 harmonics, 100,000 frequencies, one curve) against
     the direct chi2 at 2,048 and a batched per-curve-dy call of 256
     curves; (5) direct against fast in float64, 64 curves x 2,048
     frequencies; (6) the row order: the dry run's phase 3 rows (13 x 512,
     1,024 frequencies), the first 4 called alone and two equal calls of
     all 13, against one call of 13 (the reference dry run's LS bar:
     a curve's power may not depend on the other curves of the call);
 12. the LightCurve API: phase 10's sector written as 2048 TESS files
     (SPOC-style: flagged spacecraft events shared by every file, each
     curve's masked cadences as NaN flux), read_lc_collection (timed,
     files/s), to_stack() on the card (one time grid), stack.flatten and
     bls_search over 1-9 d in four calls with the launches the route rule
     gives, recovery, and the winners against from_numpy of the same
     float32 arrays (C2's bound); then 16 curves each by read() and by
     stack[i], one at a time on the card in float32: normalize,
     remove_outliers, flatten, the BLS periodogram on the reference's
     default grid (peak within 1% of the injected period and of the
     stack's winner), compute_stats, get_transit_model and
     get_transit_mask, fold and bin, the Lomb-Scargle periodogram of the
     raw curve (peak within one frequency step of the rotation) and
     estimate_cdpp against estimate_cdpp_batch; on 2 curves the card's
     float32 periodograms against the CPU's float64; no kernel may launch
     in the single-curve part;
 13. pixels: (a) a TPFStack of 512 TESS targets x phase 10's sector x 11 x
     11 pixels made on the card in float32 (Gaussian PSFs, photon noise, a
     pointing jitter and momentum-dump sawtooth common to all, 3% NaN
     cadences, phase 10's 400-ppm transits), extract_aperture_photometry
     and pld_correct(pld_order=1, n_pca_terms=3) (timed on a second call,
     peak memory), flatten and bls_search over 1-9 d in four calls with
     the launches the route rule gives (K-WF x4 at 512 curves); the same
     search of the uncorrected aperture flux; call 4 through both routes
     (K-WF; K-SF and K-W) within C2's bound, and K-WF and K-W against
     their plain versions and K-SF against the float64 fold of its
     float32 columns, on the inputs the entry point gives them there (its
     256 longest periods); recovery of the transits of
     expected SNR >= 8.745 and no lower than the uncorrected search's; 4
     targets' float32 corrected flux against float64 on the CPU; (b)
     files written by the port's to_fits and read back (files/s): 8 TESS
     TPFs through to_lightcurve, threshold masks, centroids both ways,
     estimate_background, PLDCorrector.correct(), flatten and the BLS
     periodogram (peak within 1% of the injected period), the
     collection's TPFStack photometry against each file's; 4 K2-like
     Kepler TPFs through to_corrector("sff") (CDPP below the raw curve's),
     a spline RegressionCorrector and the over-fitting metric; 2 files of
     each kind against float64 on the CPU; no kernel may launch in (b);
 14. CBV cotrending and asteroseismology: (a) one TESS CCD's CBV file (16
     single-scale vectors, three multiscale bands of 8, 8 spike vectors,
     float32, over phase 10's sector with its downlink gap flagged) and
     256 SPOC-style target files (photon noise, 3% NaN cadences, phase
     10's 400-ppm transits, a mix of single-scale and spike systematics at
     0.1-1% of the flux in the SAP flux), each target through
     read(flux_column="sap_flux"), to_corrector("cbv") and
     correct_gaussian_prior (a second pass over 16 timed); correct() with
     its alpha search on 4 (50 neighbours' SAP flux for the under-fitting
     metric), correct_elasticnet on 4 (seconds, FISTA iterations),
     interpolated CBVs on 4 (equal to the aligned result within 1e-6 of
     the median flux), 2 against float64 on the CPU; no kernel may launch
     there; then the corrected curves' to_stack(), flatten and bls_search
     over 1-9 d in four calls with the launches the route rule gives
     (K-WF x4 at 256 curves), recovery of the transits of expected SNR >=
     8.745 and no lower than the uncorrected SAP flux's search, and K-WF,
     K-SF and K-W against their plain versions on call 4's inputs; (b) 32
     red giants as KEPSEISMIC files (the whole mission in long cadence,
     ~65,000 cadences) and 4 solar-like stars as Kepler short-cadence
     files (~130,000), synthetic oscillators from fixed seeds, each through
     read, normalize, the PSD periodogram to Nyquist, flatten,
     to_seismology, numax, Delta-nu and the scaling relations (timed on a
     second call); the share with numax within 5% and Delta-nu within 2%
     at least lightkurve_tpu's on the same stars on the CPU; 2 giants and
     1 solar-like star against float64 on the CPU; no kernel may launch
     in (b);
 15. PRF photometry: (a) bench.py's two-star 9 x 9 GaussianPRF scene at
     19,440 cadences (float32 images, 20 LM iterations, the fit in
     float64 as ROADMAP C4 has it) through
     PRFPhotometry.run, the second run timed (cadence-fits/s), the
     medians within 5% (fluxes), 0.05 px (positions) and 20% (background)
     of the truth, 2,048 cadences against the same fit on the CPU within
     1e-12;
     (b) phase 13's 8 TESS files through read ->
     extract_prf_photometry() -> to_lightcurve(time=...) (timed per file
     on a second pass), the all-NaN cadences' flux set to NaN, then
     to_stack() -> flatten -> bls_search over 1-9 d in four calls (K-WF x4
     by the route rule at 8 curves), the injected period within 1% on all
     8, and K-WF and K-SF against their plain versions on call 4's
     inputs; to_lightcurve(method="prf") on arange(n); 2 files' first
     2,048 cadences against the same fit on the CPU within 1e-12 of the
     median flux;
     (c) phase 13's 4 K2 files through prf_lightcurve() (SimpleKeplerPRF
     of the CHANNEL keyword), and one through a KeplerPRF read from a
     calibration file the smoke writes, within 1e-4 of the same fit with
     the Gaussian it was made from; no kernel may launch in the fits;
 16. the archive search and the explorers (HOME, XDG_* and
     LIGHTKURVE_CACHE_DIR inside the run's temporary directory): 512
     targets x 2 sectors of phase 10's data (19,440 cadences each, the
     second sector 27.4 d after the first, transits of 1.2-17 d) written
     as 1,024 SPOC-named TESS light-curve files, and 8 SPOC-named pixel
     files of phase 13 (b); (a) every target through
     search_lightcurve("TIC ...", author="SPOC", exptime=120,
     archive_dir=...) -> download_all() -> stitch() twice (the second
     pass timed: targets/s, files/s), LightCurveCollection(stitched)
     .to_stack() on the card (timed), bit-equal to the stack of
     read_lc_collection of the same paths stitched per target, flatten
     (window 901) and bls_search over 1-18 d in four calls (K-WF x4 by the
     route rule at 512 curves), recovery of 99%, K-WF and K-SF against
     their plain versions on call 4's inputs; (b) 16 targets through a
     RecordedMASTTransport listing the same products: rows and
     download_all() equal to the archive scan's; (c) 64 FFIs of 256 x 256
     as the transport's ffi_sectors: search_tesscut -> download(
     cutout_size=11) equal to the host's cut, to_lightcurve() on the card
     within 1e-6 of the CPU's float64; (d) interact_bls(html=...) on one
     stitched curve (20,000 periods and refined grids at up to 8 peaks;
     seconds, second call) against the card's float64 page, a
     2,000-period page in float32 and
     float64 on the card against the CPU's float64 (power within 1e-5 and
     1e-9 of the peak plus one printed digit, the same best period or a
     tie; every precompute on the card), the pixel, sky (25 sources
     through the TPF's WCS) pages, whose data the host computes, equal to
     the CPU's float64 pages, and the echelle page (one KEPSEISMIC giant)
     within 5e-4 of the float64 page's peak, a one-bin shift of that
     spectrum reading above it; search -> stitch at least 25 targets/s
     and the explorer under 2 s; no kernel may launch in (b)-(d);
 18. the archive over HTTP (after phase 16, HOME and the rest as there): a
     Mashup server of the standard library on 127.0.0.1 (a free port, in
     a thread of this process) serving phase 16's 1,024 files and phase
     14's 256 CBV target files as MAST's tables and Download route: (a)
     every target through search_lightcurve(..., transport=
     HTTPMASTTransport(...)) -> download_all(download_dir=<fresh>) ->
     stitch() twice, the first pass with three requests answered 503 and
     retried, the second timed (targets/s beside phase 16's), rows and
     curves equal to phase 16's; to_stack() -> flatten -> bls_search over
     1-18 d in four calls (K-WF x4 by the route rule), the winners
     bit-equal to phase 16 (a)'s; call 4 through both routes (K-WF; K-SF
     and K-W), and K-WF, K-SF and K-W against their plain versions there;
     (b) 4 CBV targets through correct() with the neighbours' flux given
     (made from the local files of the cone search's rows over HTTP) and
     with none, the under-fitting metric fetching them over HTTP: the same
     alpha and scores, the files served the cone's; (c) the plots and the
     exports: without matplotlib or pandas (this card's machine) a plot,
     to_pandas() and the SkyBot query raise ImportError naming the
     package; with them, card-made PRF and BLS periodogram plots and an
     export against the CPU's; no kernel may launch in (b) or (c);
 19. the port's drivers: (a) lightkurve_tpu_torch.bench.run() at its full
     default shape (2048 x 8,192 x 16,384 periods and its eight
     companions; its JSON line printed): no companion may fail, the
     primary must find the injected period and the PRF fit both stars;
     then K-F and K-WF against their plain versions on the inputs of the
     primary's call and of bls_cliff's weighted call at the 256 longest
     periods; (b) the north-star search through
     lightkurve_tpu_torch.tools.northstar_run.main: the sector's 10,240
     files written by make_sector.ensure_sector, then five batches of
     2048 curves x 100,000 periods in fits mode (StreamingStackLoader,
     SweepRunner(method="shared", async_save=True)), recovery >= 99%, 8
     K-F launches a batch and no other kernel; its rates, wall, load wait
     and device-memory growth printed as a JSON line;
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
     the winners per (period, curve) against each other and C2's bound;
 17. multi-device: four gloo ranks spawned on the one card
     (parallel.launch.run_ranks; every rank calls with the whole arrays and
     gets the whole result back): (a) phase 10's sector through
     sharded_flatten (window 901) and SweepRunner(method="shared",
     mesh=2x2) over 1-9 d in four chunks of 1,024, uninterrupted and killed
     after two chunks then resumed by a fresh runner (bit-equal), against
     the unsharded flatten (logged) and the unsharded sweep of the same
     flattened flux in the parent (the same period on >= 99.9% of curves,
     every power gap within C2's bound), recovery >= 99%, evaluations/s,
     each rank's chunk seconds, the gathers' seconds and peak memory; (b) a
     4x1 mesh over 2049 uniform curves of phase 3's sector kind:
     sharded_bls over 4,096 periods (K-F) and sharded_lombscargle at 16,384
     frequencies against the unsharded calls (the reference dry run's
     bars); (c) a 1x4 mesh over the two-sector stack's 256 longest chunk-4
     periods (K-SF and K-U, 64 a rank) against the unsharded call (C2);
     (d) sharded_pld_photometry of 128 pixel targets (4 x 32) against
     pld_correct (one float32 ulp); on rank 0 the first K-WF call of (a),
     the K-F call of (b) and the K-SF and K-U calls of (c) against their
     plain versions (K-SF against the float64 fold); (e)
     dryrun_multichip(4) at the reference's sizes.
Each path (the sweeps of phases 3, 4, 6, 7, 8, 10, 12, 13, 14, 15, 16,
18 and 19 on the automatic route, the eight forced-route runs of phases
4, 6, 13 and 18,
phase 9, and each rank's parts (a)-(d) and dry run in phase 17) runs
with every launch count set to 0 just before it and read just after; a
path fails if a plain version ran, and a sweep fails unless its launches
are what the route rule (ops.bls.fold_route) gives its chunks (in phase
17, the rule for the rank's shard: its curves and periods).  The
kernels line gives each kernel's launches summed over the paths and,
under ``launches_by_path``, each path's own.

Prints the card, a JSON line of kernel records, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure, and
when no CUDA device is present.

    python3 chip_smoke.py --profile

builds the kernels and profiles one full-size sweep chunk per shared-grid
cell, phase 10's flatten, phase 11's default to_periodogram call and its
fastchi2 call, phase 12's single-curve BLS periodogram, phase 13's
pld_correct of its 512 targets and PLDCorrector.correct() of one TESS
file, phase 14's correct_gaussian_prior and correct() of one CBV target
and one giant's seismology chain, phase 15's extract_prf_photometry of one
TESS file, phase 16's search -> download_all -> stitch of one target and
interact_bls(html=...) of its stitched curve, and two forced-route chunks
instead (torch.profiler: device time per kernel, the device's idle share,
each kernel's bound over the chunk; the Lomb-Scargle calls', the BLS
periodogram's, the pixel calls', the PRF fit's, the search's and the
explorer's launches and device time by kind of op).

    python3 chip_smoke.py --ls-f64

runs only phase 11's float64 card-against-CPU check of the sector, as
the first Lomb-Scargle work of the process and again after a float32
call, and logs where the error peaks and the denominators there.

    python3 chip_smoke.py --cells [--port DIR]

builds the kernels and measures, checking only that each sweep ran:
phase 11's sector and bench-shape rates and the row-order gaps of its
part 6, then phase 6's two-sector sweep three times, each a fresh
SweepRunner on a fresh checkpoint, with its wall and process CPU seconds,
launches and the card's clocks after it; prints one JSON line.  With
``--port DIR`` it imports lightkurve_tpu_torch from DIR (another checkout,
for example a parent commit unpacked by ``git archive``), so two versions
are compared in one call: parent, change, change, parent.
"""
import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# the north-star search configuration (tools/northstar_run.py in the port)
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


def sync_timed(fn):
    """``fn()`` and its seconds, to the end of its device work."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    """The synthetic sector's first ``n_files`` files
    (``lightkurve_tpu_torch.tools.make_sector.ensure_sector``, the port's
    FITS writer); returns the paths and the injected periods."""
    from lightkurve_tpu_torch.tools import make_sector as ms
    batches = n_files // ms.BATCH
    paths = ms.ensure_sector(directory, batches, verbose=False)
    return paths, np.concatenate([ms.batch_truth(ib)[0]
                                  for ib in range(batches)])


def phase_uniform(tmp, B=2048, n_periods=25_000, chunk_periods=12_500):
    import torch
    from lightkurve_tpu_torch.io.pipeline import StreamingStackLoader
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
                     torch.tensor(torch.inf, dtype=dtype,
                                  device=stack.flux.device))
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.roofline import (bound_fused, bound_weighted,
                                               bound_weighted_fused)
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
    from lightkurve_tpu_torch.tools import make_sector as ms
    one = np.arange(LONG_N) * (2.0 / 60 / 24) + ms.T_OFFSET
    return np.concatenate([one + SECTOR_DAYS * k for k in range(n_sectors)])


def long_sector_stack(B=2048, seed=2027, dtype=None, n_sectors=1,
                      p_max=8.5):
    """In-memory stack of B curves on ``n_sectors`` consecutive sectors of
    19,440 two-minute cadences each, constant dy, one box transit each
    (periods uniform in 1.2 d to ``p_max``)."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.roofline import bound_staged_fold
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
    from lightkurve_tpu_torch.roofline import bound_uniform
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
def expected_launches(stack, periods, chunk_periods, launch_periods=8):
    """What the route rule (``ops.bls.fold_route``) gives each chunk of
    SweepRunner(method="shared") over ``stack``: per time grid of its rows
    (one shared-grid search each) and chunk (the last padded by repeating
    its last period, as SweepRunner pads it), one launch of the fused
    kernel, or one launch of K-SF and of the window scan per
    ``launch_periods`` periods on the staged route (SweepRunner's 8;
    ``bls_search`` calls with the entry point's default, 16).  Returns the
    launches per kernel."""
    import torch
    groups = torch.unique(stack.time, dim=0, return_counts=True)[1].tolist()
    blocks = [np.asarray(periods[lo:lo + chunk_periods])
              for lo in range(0, len(periods), chunk_periods)]
    want = dict.fromkeys(kernel_table(), 0)
    for curves in groups:
        for k, v in route_launches(blocks, curves, not is_uniform(stack),
                                   stack.flux.dtype, stack.device,
                                   launch_periods, chunk_periods).items():
            want[k] += v
    return want


def route_launches(blocks, curves, weighted, dtype, device, launch_periods,
                   block_periods=None):
    """What the route rule gives one shared-grid call of ``curves`` curves
    at each host period block of ``blocks``: one launch of the fused
    kernel, or on the staged route one launch of K-SF and of the window
    scan per ``launch_periods`` of the block's ``block_periods`` periods
    (default its length; a block padded to that size keeps its longest
    period).  Returns the launches per kernel."""
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops.bls import fold_route
    from lightkurve_tpu_torch.ops.bls_fused import max_nbins_bound
    from lightkurve_tpu_torch.parallel.checkpoint import _k_max
    fused, window = ("K-WF", "K-W") if weighted else ("K-F", "K-U")
    d_phase = float(DURATIONS.min()) / OVERSAMPLE
    k_max = _k_max(DURATIONS, d_phase)
    want = dict.fromkeys(kernel_table(), 0)
    for block in blocks:
        block = np.asarray(block).astype(numpy_dtype(dtype))
        max_nbp = max_nbins_bound(block, d_phase, dtype)
        if fold_route("auto", max_nbp, k_max, dtype, device, weighted,
                      curves=curves) == "fused":
            want[fused] += 1
        else:
            n = -(-(block_periods or len(block)) // launch_periods)
            want["K-SF"] += n
            want[window] += n
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


def timed_sweep(name, stack, periods, p_inj, path, chunk_periods=1024):
    """SweepRunner(method="shared") over ``stack`` from a fresh checkpoint
    at ``path``, timed from the runner's construction to its last winners
    (wall and process CPU seconds); fails unless it starts at chunk 0 and
    recovers RECOVERY_SHARE of the injected periods.  Returns the
    numbers."""
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    B = stack.shape[0]
    start_sweep()
    t0, cpu0 = time.time(), time.process_time()
    runner = SweepRunner(stack, periods, DURATIONS, path,
                         chunk_periods=chunk_periods, method="shared",
                         async_save=True)
    if runner.next_chunk:
        raise AssertionError(f"{name}: the sweep resumed at chunk "
                             f"{runner.next_chunk}")
    state = runner.run()
    sweep_s = time.time() - t0
    cpu_s = time.process_time() - cpu0
    share = recovery(state["period"], p_inj)
    rate = B * len(periods) / sweep_s
    log(f"{name}: B={B} N={stack.shape[1]} P={len(periods)} in "
        f"{runner.n_chunks} chunks: sweep {sweep_s:.3f}s ({rate:.6g} "
        f"curve-period evals/s; process CPU {cpu_s:.3f}s); recovered "
        f"{share:.4f}; {peak_memory()}")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"{name} recovery {share} < {RECOVERY_SHARE}")
    return dict(seconds=sweep_s, cpu_seconds=cpu_s, rate=rate,
                recovered=share)


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
    stack, p_inj = long_sector_stack(B, dtype=torch.float32,
                                     n_sectors=n_sectors, p_max=p_max)
    periods = np.linspace(*grid)
    out = timed_sweep(name, stack, periods, p_inj,
                      os.path.join(tmp, f"long_{n_sectors}.npz"),
                      chunk_periods)
    out["routes"] = expected_launches(stack, periods, chunk_periods)
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    from lightkurve_tpu_torch.tools import make_sector as ms
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
                   rotation=FLATTEN_ROTATION, periods=(1.2, 8.5), t=None):
    """Phase 10's SPOC-like batch as host arrays (time, flux, flux_err,
    mask): B curves over one 27-d sector of two-minute cadences (19,440)
    with a mid-sector downlink gap, or over the times ``t``; per-cadence
    dy 0.7-1.3 x 2e-4; a stellar trend per curve (a sinusoid of 0.5-1% at
    a period in ``rotation`` and a linear drift of up to 0.5% over the
    span); one box transit of 0.1 d and ``depth`` each (periods in
    ``periods``, d); ~0.1% outliers at 10 dy; ~3% masked cadences.
    Returns the arrays, the injected transit periods and the rotation
    periods."""
    from lightkurve_tpu_torch.tools import make_sector as ms
    rng = np.random.default_rng(seed)
    if t is None:
        t = sector_times(1)
        t[LONG_N // 2:] += DOWNLINK_GAP_DAYS
    shape = (B, t.size)
    dy = ms.NOISE * rng.uniform(0.7, 1.3, shape)
    amplitude = rng.uniform(0.005, 0.01, (B, 1))
    p_rot = rng.uniform(*rotation, (B, 1))
    trend = (1.0 + amplitude * np.sin(
        2 * np.pi * t / p_rot + rng.uniform(0, 2 * np.pi, (B, 1)))
        + rng.uniform(-0.005, 0.005, (B, 1)) * (t - t[0]) / (t[-1] - t[0]))
    flux = np.ones(shape)
    p_inj = rng.uniform(*periods, B)
    inject_transits(flux, t, p_inj, rng, depth)
    flux = flux * trend + dy * rng.standard_normal(shape)
    out = rng.random(shape) < 0.001
    flux[out] += 10 * dy[out]
    mask = rng.random(shape) >= 0.03
    flux[~mask] = 0.0
    return (np.broadcast_to(t, shape), flux, dy, mask), p_inj, p_rot[:, 0]


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
    arrays, p_inj, _ = flatten_arrays(B)
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
    from lightkurve_tpu_torch.tools import make_sector as ms
    arrays, p_inj, _ = flatten_arrays(B, depth=ms.DEPTH,
                                      rotation=(2.0, 10.0))
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
# phase 11: Lomb-Scargle on the stack (plain torch: torch.fft, index_add_)
# ---------------------------------------------------------------------------
#: the bench's LS companion (bench.py:491-506): B x 8,192 cadences,
#: 16,384 frequencies from 0.05 /d
LS_BENCH_NF = 16_384
#: fastchi2 against the direct chi2 (bench.py:607-640): one 8,192-cadence
#: curve, 3 harmonics, 100,000 frequencies against the first 2,048
FASTCHI2_NF = 100_000
FASTCHI2_DIRECT_NF = 2048
FASTCHI2_NTERMS = 3
#: curves of the batched fastchi2 call with per-curve dy
FASTCHI2_BATCH = 256
#: fastchi2 against chi2, of the largest chi2 power (the bar of
#: tests/test_ops_lombscargle.py::test_fastchi2_default_accuracy_class)
FASTCHI2_RTOL = 1e-3
#: fast against direct, of each row's largest power (the bar of
#: tests/test_ops_lombscargle.py::test_fast_approximates_direct)
LS_DIRECT_RTOL = 1e-4
#: a mixed-grid call against single-grid calls, of each row's largest
LS_MIXED_RTOL = 1e-5


def ls_time(fn, reps=1):
    """Wall time of ``fn()`` (after one warm-up call, which builds the FFT
    plans and the cached set-up) over ``reps`` calls ending in a
    synchronize, with the peak device memory of the timed calls.  Returns
    (the last result, seconds per call, peak GiB)."""
    import torch
    fn()
    start_sweep()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / reps
    return out, secs, torch.cuda.max_memory_allocated() / 2**30


def row_error(got, want):
    """The largest |got - want| over each row's largest |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1)).max())


def shared_bins(t, f0, df, Nf):
    """The most deposits one ``index_add_`` of the extirpolation puts in
    one grid point (samples with the same first Lagrange point), and how
    many grid points take more than one, on the grid of ``t`` at
    frequencies ``f0 + df * [0, Nf)``."""
    from lightkurve_tpu_torch.ops.lombscargle import fast_precompute
    pre = fast_precompute(t, f0, df, Nf)
    ilo = np.clip(pre["xi"].astype(np.int64) - 2, 0, pre["Nfft"] - 4)
    counts = np.unique(ilo, return_counts=True)[1]
    return int(counts.max()), int((counts > 1).sum())


def fastchi2_grid(t):
    """bench.py's fastchi2 grid: from 0.05 /d, about 50x oversampled."""
    return 0.05, 2.0 / float(t[-1] - t[0]) / 50.0


def ls_sector(B=2048, rows=64, device="cuda"):
    """Part 1: ``LightCurveStack.to_periodogram()`` (psd, to Nyquist,
    oversample 1) on phase 10's raw sector, float32.  Timed; the highest
    peak of RECOVERY_SHARE of the curves within one step (1/baseline) of
    the rotation frequency; float32 against float64 on the same
    float32-rounded inputs (peaks on F32_WINNER_SHARE of the curves,
    power at the float64 peak within F32_RTOL); float64 on the card
    against the CPU for ``rows`` curves (F64_RTOL of each row's
    largest).  Returns the numbers."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    arrays, _, p_rot = flatten_arrays(B)
    stack = LightCurveStack.from_numpy(*arrays, device=device,
                                       dtype=torch.float32)
    (freqs, p32), secs, peak = ls_time(stack.to_periodogram)
    rate = B * len(freqs) / secs
    log(f"LS sector: B={B} N={stack.shape[1]} Nf={len(freqs)} float32: "
        f"to_periodogram {secs:.4f}s ({rate:.6g} curve-frequency evals/s), "
        f"peak device memory {peak:.3f} GiB allocated")
    if p32.shape != (B, len(freqs)) or not bool(torch.isfinite(p32).all()):
        raise AssertionError("LS sector: power not finite or misshapen")
    t0 = stack.time[0].cpu().numpy().astype(np.float64)
    step = 1.0 / (t0[-1] - t0[0])
    log("LS sector: deposits sharing a grid point in one scatter: "
        + "; ".join(f"grid x{m}: at most {c[0]}, at {c[1]} points"
                    for m in (1, 2) for c in [shared_bins(
                        t0, m * freqs[0], m * step, len(freqs))]))
    k32 = p32.argmax(1).cpu().numpy()
    hit = np.abs(freqs[k32] - 1.0 / p_rot) <= step
    share = float(hit.mean())
    log(f"LS sector: highest peak within {step:.6f} /d of the rotation "
        f"frequency on {share:.4f} of curves (bar {RECOVERY_SHARE})")
    for i in np.nonzero(~hit)[0][:16]:
        log(f"  miss: curve {i}, rotation {p_rot[i]:.3f} d, peak at "
            f"{freqs[k32[i]]:.5f} /d ({1 / freqs[k32[i]]:.3f} d)")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"LS sector recovery {share} < "
                             f"{RECOVERY_SHARE}")
    f64 = stack._replace(time=stack.time.double(), flux=stack.flux.double(),
                         flux_err=stack.flux_err.double())
    freqs64, p64 = f64.to_periodogram()
    k64 = p64.argmax(1)
    same = float((k64.cpu().numpy() == k32).mean())
    at = torch.arange(B, device=p64.device)
    rel = float(((p32[at, k64].double() - p64[at, k64]).abs()
                 / p64[at, k64]).max())
    log(f"LS sector: float32 vs float64 on the card: same peak on "
        f"{same:.6f} of curves (bar {F32_WINNER_SHARE}), max relative power "
        f"error at the float64 peak {rel:.3g} (bar {F32_RTOL:g})")
    if (not np.array_equal(freqs64, freqs) or same < F32_WINNER_SHARE
            or rel > F32_RTOL):
        raise AssertionError("LS sector: float32 differs from float64 past "
                             "the bars")
    del p32
    check_ls_f64(f64, p64, freqs, rows)
    return dict(seconds=secs, rate=rate, peak_gib=peak, recovered=share,
                nf=len(freqs))


def ls_denominators(stack, f0, df, Nf):
    """``lombscargle_fast``'s CC and SS (fit_mean) over the sum of weights,
    (B, Nf), for a float64 stack's weights (dy = inf on masked cadences):
    where one is small, the power divides rounding by it."""
    import torch
    from lightkurve_tpu_torch.ops.lombscargle import trig_sum
    t = stack.time[0].cpu().numpy()
    w = torch.where(stack.mask, stack.flux_err.double() ** -2, 0.0)
    ws = w.sum(-1, keepdim=True)
    S, C = trig_sum(t, w, df, Nf, f0=f0)
    S2, C2 = trig_sum(t, w, df, Nf, f0=f0, freq_factor=2)
    tan = (S2 - 2 * S * C / ws) / (C2 - (C * C - S * S) / ws)
    C2w = 1 / torch.sqrt(1 + tan * tan)
    S2w = tan * C2w
    Cw = np.sqrt(0.5) * torch.sqrt(1 + C2w)
    Sw = np.sqrt(0.5) * torch.sign(S2w) * torch.sqrt(1 - C2w)
    CC = 0.5 * (ws + C2 * C2w + S2 * S2w) - (C * Cw + S * Sw) ** 2 / ws
    SS = 0.5 * (ws - C2 * C2w - S2 * S2w) - (S * Cw - C * Sw) ** 2 / ws
    return CC / ws, SS / ws


def check_ls_f64(f64, p64, freqs, rows=64, tag="LS sector", ends=8):
    """Float64 ``to_periodogram`` on the card (``p64`` of stack ``f64``)
    against the CPU on the first ``rows`` curves: within F64_RTOL of each
    row's largest power.  Logs where the error peaks (curve, frequency
    over Nyquist, power there, CC and SS over the sum of weights there),
    the smallest denominator on the grid, the error in the ``ends`` bins
    at either end of the grid and inside them, the spread of the CPU's
    own result under a relative 2^-52 perturbation of the fluxes (what
    rounding alone moves at this shape), and a second card call against
    the first."""
    import torch
    sub = f64._replace(time=f64.time[:rows].cpu(), flux=f64.flux[:rows].cpu(),
                       flux_err=f64.flux_err[:rows].cpu(),
                       mask=f64.mask[:rows].cpu())
    freqs_cpu, p_cpu = sub.to_periodogram()
    rel = ((p64[:rows].cpu() - p_cpu).abs()
           / p_cpu.abs().amax(-1, keepdim=True))
    err = float(rel.max())
    i, k = np.unravel_index(int(rel.argmax()), rel.shape)
    t0 = sub.time[0].numpy()
    nyquist = 0.5 / np.median(np.diff(t0))
    df = freqs[1] - freqs[0]
    cc, ss = ls_denominators(sub, freqs[0], df, len(freqs))
    low = torch.minimum(cc, ss)
    li, lk = np.unravel_index(int(low.argmin()), low.shape)
    edge = torch.zeros(len(freqs), dtype=torch.bool)
    edge[:ends] = edge[-ends:] = True
    gen = torch.Generator().manual_seed(0)
    jolt = sub._replace(flux=sub.flux * (1 + 2.0 ** -52 * torch.randn(
        sub.flux.shape, generator=gen, dtype=torch.float64)))
    spread = row_error(jolt.to_periodogram()[1], p_cpu)
    rerun = row_error(f64.to_periodogram()[1], p64)
    log(f"{tag}: float64 card vs CPU, {rows} curves: max error {err:.3g} "
        f"of each row's largest power (bar {F64_RTOL:g}), at curve {i}, "
        f"{freqs[k]:.5f} /d (index {k}, {freqs[k] / nyquist:.5f} of "
        f"Nyquist), power there {float(p_cpu[i, k] / p_cpu[i].max()):.3g} "
        f"of the row's largest, CC {float(cc[i, k]):.4g} and SS "
        f"{float(ss[i, k]):.4g} of the weights' sum there; smallest "
        f"denominator on the grid {float(low[li, lk]):.4g} (curve {li}, "
        f"index {lk}); error in the {ends} bins at either end "
        f"{float(rel[:, edge].max()):.3g}, inside "
        f"{float(rel[:, ~edge].max()):.3g}; "
        f"the CPU under a 2^-52 jolt of the fluxes moves {spread:.3g}; a "
        f"second card call differs from the first by {rerun:.3g}")
    if not np.array_equal(freqs_cpu, freqs) or err > F64_RTOL:
        raise AssertionError(f"{tag}: float64 on the card differs from the "
                             "CPU")
    return err


def ls_f64_cold(B=2048, rows=64):
    """``--ls-f64``: the float64 card-against-CPU check of phase 11 part 1
    as the first Lomb-Scargle work of a fresh process (no cuFFT plan, an
    empty set-up cache), then again after a float32 call, as the smoke
    orders them."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    arrays, _, _ = flatten_arrays(B)
    stack = LightCurveStack.from_numpy(*arrays, device="cuda",
                                       dtype=torch.float32)
    f64 = stack._replace(time=stack.time.double(), flux=stack.flux.double(),
                         flux_err=stack.flux_err.double())
    freqs, p64 = f64.to_periodogram()
    check_ls_f64(f64, p64, freqs, rows, tag="LS f64, cold")
    stack.to_periodogram()
    freqs, p64 = f64.to_periodogram()
    check_ls_f64(f64, p64, freqs, rows, tag="LS f64, after float32")


def bench_ls_inputs(B=2048, device="cuda"):
    """The bench's LS inputs: B curves of the uniform cell's sector
    (``make_sector.batch_flux``) on bench.py's time grid (8,192
    two-minute cadences from 0), dy 2e-4 per cadence, float32."""
    import torch
    from lightkurve_tpu_torch.tools import make_sector as ms
    t = np.arange(ms.N) * (2.0 / 60 / 24)
    flux = np.concatenate([ms.batch_flux(ib, t)[0]
                           for ib in range(-(-B // ms.BATCH))])[:B]
    y = torch.as_tensor(flux, dtype=torch.float32, device=device)
    return t, y, torch.full_like(y, ms.NOISE)


def ls_bench_shape(B=2048, device="cuda"):
    """Part 2: ``lombscargle_fast`` at the bench's LS shape (B x 8,192,
    16,384 frequencies on bench.py:491-506's grid), the second of two
    calls timed."""
    import torch
    from lightkurve_tpu_torch.ops.lombscargle import lombscargle_fast
    t, y, dy = bench_ls_inputs(B, device)
    df = 60.0 / LS_BENCH_NF / float(t[-1] - t[0] + 1)
    power, secs, peak = ls_time(
        lambda: lombscargle_fast(t, y, 0.05, df, LS_BENCH_NF, dy=dy))
    rate = B * LS_BENCH_NF / secs
    log(f"LS bench shape: B={B} N={len(t)} Nf={LS_BENCH_NF} float32: "
        f"{secs:.4f}s ({rate:.6g} curve-frequency evals/s), peak device "
        f"memory {peak:.3f} GiB allocated")
    if power.shape != (B, LS_BENCH_NF) or not bool(
            torch.isfinite(power).all()):
        raise AssertionError("LS bench shape: power not finite or "
                             "misshapen")
    return dict(seconds=secs, rate=rate, peak_gib=peak)


#: the row-order check (phase 11 part 6): the reference dry run's LS bar
#: (``__graft_entry__.py:231-234``)
LS_ROWS_RTOL, LS_ROWS_ATOL = 1e-5, 1e-8


def ls_rows(check=True):
    """Part 6: does a curve's float32 power depend on the other curves of
    the call?  The dry run's phase 3 rows (13 curves of 512 cadences at
    0.02 d, 1e-3 noise, a transit at 1.7 d, dy 1e-3; 1,024 frequencies
    from 0.05 in steps of 0.002): the first 4 called alone, and a second
    call of all 13, each against one call of 13.  Returns the largest
    relative gap of each; with ``check``, fails past LS_ROWS_RTOL and
    LS_ROWS_ATOL."""
    import torch
    from lightkurve_tpu_torch.ops.lombscargle import lombscargle_fast
    rng = np.random.default_rng(7)
    t = np.arange(512) * 0.02
    y_np = 1.0 + 1e-3 * rng.standard_normal((13, 512))
    ph = np.mod(t - 0.5 + 1.7 / 2, 1.7) - 1.7 / 2
    y_np[:, np.abs(ph) < 0.05] -= 5e-3
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    dy = torch.full_like(y, 1e-3)

    def ls(rows):
        return lombscargle_fast(t, y[rows], 0.05, 0.002, 1024, dy=dy[rows],
                                normalization="psd").double().cpu().numpy()

    whole = ls(slice(None))
    out = {}
    for name, got, want in (("rows", ls(slice(0, 4)), whole[:4]),
                            ("repeat", ls(slice(None)), whole)):
        out[f"{name}_gap"] = float((np.abs(got - want) / np.abs(want)).max())
        out[f"{name}_close"] = bool(np.allclose(
            got, want, rtol=LS_ROWS_RTOL, atol=LS_ROWS_ATOL))
    log(f"LS rows: 4 curves alone vs in a call of 13: largest relative "
        f"gap {out['rows_gap']:.3g}; two equal calls of 13: "
        f"{out['repeat_gap']:.3g} (bar rtol {LS_ROWS_RTOL:g}, atol "
        f"{LS_ROWS_ATOL:g})")
    if check and not (out["rows_close"] and out["repeat_close"]):
        raise AssertionError("LS rows: a curve's power depends on the "
                             "other curves of the call")
    return out


def ls_mixed(B=2048):
    """Part 3: phase 7's four-grid stack through ``to_periodogram`` (one
    batched call per grid), held against single-grid ``lombscargle_fast``
    calls on each grid's rows at the mixed call's frequencies, with the
    same psd rescale: the same peak on every curve, power within
    LS_MIXED_RTOL of each row's largest.  The first grid's rows also go
    through ``to_periodogram`` as a single-grid stack: its frequencies,
    from the same first row, must be the mixed call's."""
    import torch
    from lightkurve_tpu_torch.ops.lombscargle import lombscargle_fast
    stack, _, per = mixed_grid_stack(B)
    (freqs, power), secs, peak = ls_time(stack.to_periodogram)
    t0 = time.perf_counter()
    stack._grid_groups()
    grouping = time.perf_counter() - t0
    log(f"LS mixed grids: B={B} N={stack.shape[1]} Nf={len(freqs)}, "
        f"{B // per} grids: {secs:.4f}s "
        f"({B * len(freqs) / secs:.6g} curve-frequency evals/s), of which "
        f"grouping the rows by grid on the host {grouping:.4f}s; peak "
        f"device memory {peak:.3f} GiB allocated")
    fs = freqs[0]                     # the default grid starts one step up
    dy = torch.where(stack.mask, stack.flux_err, torch.inf)
    n_valid = stack.mask.sum(1, keepdim=True).double()
    err, same = 0.0, 0
    for g in range(B // per):
        rows = slice(g * per, (g + 1) * per)
        one = lombscargle_fast(stack.time[rows][0].cpu().numpy(),
                               stack.flux[rows], fs, fs, len(freqs),
                               dy=dy[rows], normalization="psd")
        one = one * 2.0 / (n_valid[rows] * fs).to(one.dtype)
        same += int((one.argmax(1) == power[rows].argmax(1)).sum())
        err = max(err, row_error(power[rows], one))
    first = stack._replace(time=stack.time[:per], flux=stack.flux[:per],
                           flux_err=stack.flux_err[:per],
                           mask=stack.mask[:per])
    same_freqs = np.array_equal(first.to_periodogram()[0], freqs)
    log(f"LS mixed grids: same peak as the single-grid calls on {same} of "
        f"{B} curves, max error {err:.3g} of each row's largest (bar "
        f"{LS_MIXED_RTOL:g}); the first grid's own stack gives "
        f"{'the same' if same_freqs else 'OTHER'} frequencies")
    if same < B or err > LS_MIXED_RTOL or not same_freqs:
        raise AssertionError("LS mixed grids differ from the single-grid "
                             "calls")
    return dict(seconds=secs)


def fastchi2_peak_bytes(B, Nf, nterms, itemsize):
    """The batched fastchi2's live (B, Nf) arrays with per-curve dy: about
    2 (2k + 1)^2 of them (the trig sums, the normal matrices' lower
    triangles, the Cholesky factors, their inverses and the solution)."""
    return 2 * (2 * nterms + 1) ** 2 * B * Nf * itemsize


def ls_fastchi2(B=FASTCHI2_BATCH, device="cuda", nf=FASTCHI2_NF,
                n_direct=FASTCHI2_DIRECT_NF):
    """Part 4: ``lombscargle_fastchi2`` with FASTCHI2_NTERMS harmonics at
    ``nf`` frequencies on one curve of the bench's inputs (bench.py:
    607-640), against ``lombscargle_chi2`` at its first ``n_direct``
    frequencies (FASTCHI2_RTOL of the largest chi2 power); the speed
    ratio per frequency; then a batched call of ``B`` curves with
    per-curve dy, its peak memory beside :func:`fastchi2_peak_bytes`."""
    import torch
    from lightkurve_tpu_torch.ops.lombscargle import (lombscargle_chi2,
                                                      lombscargle_fastchi2)
    t, y, dy = bench_ls_inputs(max(B, 1), device)
    f0, df = fastchi2_grid(t)
    k = FASTCHI2_NTERMS
    fast, secs, peak = ls_time(lambda: lombscargle_fastchi2(
        t, y[0], f0, df, nf, nterms=k), reps=8)
    freqs = torch.as_tensor(f0 + df * np.arange(n_direct),
                            dtype=torch.float32, device=device)
    t_dev = torch.as_tensor(t, dtype=torch.float32, device=device)
    direct, secs_d, _ = ls_time(lambda: lombscargle_chi2(
        t_dev, y[0], freqs, nterms=k), reps=3)
    err = float((fast[:n_direct].double() - direct.double()).abs().max()
                / direct.double().abs().max())
    ratio = (secs_d / n_direct) / (secs / nf)
    log(f"fastchi2: N={len(t)} nterms={k} Nf={nf} float32: {secs:.5f}s "
        f"({nf / secs:.6g} frequency evals/s), peak device memory "
        f"{peak:.3f} GiB; chi2 at {n_direct} frequencies {secs_d:.5f}s; "
        f"per frequency fastchi2 is {ratio:.4g}x faster; max error "
        f"{err:.3g} of the largest chi2 power (bar {FASTCHI2_RTOL:g})")
    if not bool(torch.isfinite(fast).all()) or err > FASTCHI2_RTOL:
        raise AssertionError("fastchi2 differs from chi2 past the bar")
    want = fastchi2_peak_bytes(B, nf, k, 4) / 2**30
    batch, secs_b, peak_b = ls_time(lambda: lombscargle_fastchi2(
        t, y[:B], f0, df, nf, dy=dy[:B], nterms=k))
    log(f"fastchi2 batched, per-curve dy: B={B} Nf={nf}: {secs_b:.4f}s "
        f"({B * nf / secs_b:.6g} curve-frequency evals/s), peak device "
        f"memory {peak_b:.3f} GiB allocated (worked out: about {want:.3f} "
        f"GiB of (B, Nf) arrays)")
    if batch.shape != (B, nf) or not bool(torch.isfinite(batch).all()):
        raise AssertionError("fastchi2 batched: power not finite or "
                             "misshapen")
    return dict(seconds=secs, ratio=ratio, batch_seconds=secs_b,
                batch_peak_gib=peak_b)


def ls_direct(B=64, nf=2048, device="cuda"):
    """Part 5: ``lombscargle_direct`` against ``lombscargle_fast`` in
    float64 on the card, on ``B`` curves of phase 10's sector generator
    (masked cadences filled with the curve's median, uniform weights),
    psd, at the first ``nf`` frequencies of the sector's default grid:
    within LS_DIRECT_RTOL of each row's largest and the same peak."""
    import torch
    from lightkurve_tpu_torch.ops.lombscargle import (lombscargle_direct,
                                                      lombscargle_fast)
    (t, flux, _, mask), _, _ = flatten_arrays(B)
    flux = np.where(mask, flux, np.median(flux, axis=1, keepdims=True))
    y = torch.as_tensor(flux, dtype=torch.float64, device=device)
    t0 = np.asarray(t[0], np.float64)
    fs = 1.0 / (t0[-1] - t0[0])
    freqs = fs + fs * np.arange(nf)
    exact = lombscargle_direct(t0, y, freqs, normalization="psd")
    fast = lombscargle_fast(t0, y, fs, fs, nf, normalization="psd")
    err = row_error(fast, exact)
    same = bool(torch.equal(fast.argmax(1), exact.argmax(1)))
    log(f"LS direct vs fast: B={B} N={len(t0)} Nf={nf} float64 on the card: "
        f"max error {err:.3g} of each row's largest (bar "
        f"{LS_DIRECT_RTOL:g}); {'same' if same else 'DIFFERENT'} peaks")
    if err > LS_DIRECT_RTOL or not same:
        raise AssertionError("LS direct differs from fast past the bar")


def phase_ls():
    """Phase 11: the Lomb-Scargle path (the profile is
    ``--profile``'s), each part a path of its own that launches none of
    the BLS kernels.  Returns part 1's numbers and the others' times."""
    import torch
    out = {}
    for name, fn in (("sector", ls_sector), ("bench", ls_bench_shape),
                     ("mixed", ls_mixed), ("fastchi2", ls_fastchi2),
                     ("direct", ls_direct), ("rows", ls_rows)):
        out[name], _ = drive(f"Lomb-Scargle {name} (phase 11)", fn,
                             forbid=tuple(kernel_table()))
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: the LightCurve API on the card
# ---------------------------------------------------------------------------
#: the sector's spacecraft events: cadences every file flags with a bit of
#: TESS's default quality bitmask (Desat), which ``read`` drops
LC_EVENT_FLAG = 32
LC_EVENTS = np.arange(400, LONG_N, 800)
#: curves taken one at a time, each through ``read`` and ``stack[i]``
LC_SINGLE = 16
#: of those, also through float64 on the CPU
LC_F64_CURVES = 2
#: the card's float32 BLS periodogram against the CPU's float64 on the same
#: curve: power at the float64 peak, relative
LC_F32_POWER_RTOL = 1e-4
#: LightCurve.estimate_cdpp against LightCurveStack.estimate_cdpp_batch:
#: the two estimators differ by design (the single curve's running mean
#: spans the cadences it dropped, the batch keeps windows wholly of valid
#: cadences; up to 1.5% on this sector in float64), so the card's float32
#: ratio of the two is held to the CPU's float64 ratio, within this
LC_CDPP_F32_RTOL = 1e-3
#: the bin width of the folded curve's ``bin`` (d)
LC_FOLD_BIN = 0.01
#: the single-curve BLS peak is read at periods from the stack search's
#: shortest (1 d) up: below it the default grid's 0.33-d boxes nearly fill
#: the period, and the reference's objective 0.5 w_in depth^2 then rewards
#: a box whose out-of-transit part is a few cadences (ROADMAP C)
LC_MIN_PERIOD = LONG_GRID[0]


def write_lc_sector(directory, arrays, names=None, tics=None, sector=99):
    """Phase 10's sector as SPOC-style TESS light-curve files (TIME,
    PDCSAP_FLUX, PDCSAP_FLUX_ERR, QUALITY), written with the port's FITS
    writer: every file flags the same :data:`LC_EVENTS` cadences with
    :data:`LC_EVENT_FLAG`; each curve's own masked cadences have NaN flux
    and no flag.  ``names`` (file names), ``tics`` (TIC ids) and
    ``sector`` default to ``tess-s0099-{i:016d}_lc.fits``, ``i`` and 99.
    Returns the paths."""
    from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                              PrimaryHDU, write_fits)
    t, flux, dy, mask = arrays
    if names is None:
        names = [f"tess-s0099-{i:016d}_lc.fits" for i in range(len(flux))]
    if tics is None:
        tics = list(range(len(flux)))
    os.makedirs(directory, exist_ok=True)
    quality = np.zeros(t.shape[1], np.int32)
    quality[LC_EVENTS] = LC_EVENT_FLAG
    table_header = {"EXTNAME": "LIGHTCURVE", "BJDREFI": 2457000,
                    "BJDREFF": 0.0, "TIMESYS": "TDB", "TUNIT1": "BJD - 2457000",
                    "TUNIT2": "e-/s", "TUNIT3": "e-/s"}
    paths = []
    for i in range(len(flux)):
        path = os.path.join(directory, names[i])
        ph = Header({"TELESCOP": "TESS", "MISSION": "TESS",
                     "ORIGIN": "NASA/Ames",
                     "CREATOR": "LightCurveExporterPipelineModule",
                     "OBJECT": f"TIC {tics[i]}", "TICID": int(tics[i]),
                     "SECTOR": sector})
        table = BinTableHDU(data={
            "TIME": t[i],
            "PDCSAP_FLUX": np.where(mask[i], flux[i], np.nan).astype(
                np.float32),
            "PDCSAP_FLUX_ERR": dy[i].astype(np.float32),
            "QUALITY": quality}, header=Header(table_header))
        write_fits(HDUList([PrimaryHDU(header=ph), table]), path,
                   overwrite=True)
        paths.append(path)
    return paths


def lc_search(stack, periods, chunk_periods):
    """``LightCurveStack.bls_search`` over ``periods`` in chunks of
    ``chunk_periods`` (one call each, so each chunk takes its own route);
    returns each curve's winner (period, power, duration, transit_time) as
    host arrays."""
    import torch
    best = None
    for lo in range(0, len(periods), chunk_periods):
        out = stack.bls_search(periods[lo:lo + chunk_periods], DURATIONS,
                               oversample=OVERSAMPLE)
        k = out["power"].argmax(1, keepdim=True)
        win = {f: torch.gather(out[f], 1, k)[:, 0]
               for f in ("period", "power", "duration", "transit_time")}
        if best is None:
            best = win
        else:
            take = win["power"] > best["power"]
            best = {f: torch.where(take, win[f], best[f]) for f in best}
    return {f: v.cpu().numpy() for f, v in best.items()}


def phase_lc_stack(tmp, card, B=2048, chunk_periods=1024):
    """Phase 12, many curves: phase 10's sector written as 2048 TESS files
    (:func:`write_lc_sector`), read with ``read_lc_collection`` (timed),
    ``to_stack()`` on the card in float32 (timed), flattened
    (:data:`FLATTEN_KW`) and searched with ``bls_search`` over
    :data:`LONG_GRID` in four chunks of 1,024 periods; its launches are
    what the route rule gives (``bls_search`` folds 16 periods per staged
    call).  Checks one time grid, the cadences kept and recovery.
    Returns the numbers, the routes, the winners and the stacks."""
    import torch
    from lightkurve_tpu_torch.io.read import read_lc_collection
    arrays, p_inj, p_rot = flatten_arrays(B)
    t0 = time.perf_counter()
    paths = write_lc_sector(os.path.join(tmp, "lc_sector"), arrays)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coll = read_lc_collection(paths)
    read_s = time.perf_counter() - t0
    if len(coll) != B or {type(lc).__name__ for lc in coll} != {
            "TessLightCurve"}:
        raise AssertionError("LightCurve API: read_lc_collection did not "
                             "give one TessLightCurve per file")
    n_kept = LONG_N - len(LC_EVENTS)
    if {len(lc) for lc in coll} != {n_kept}:
        raise AssertionError("LightCurve API: the quality mask did not drop "
                             "exactly the flagged cadences")
    log(f"LightCurve API: read_lc_collection of {B} TESS files x {LONG_N} "
        f"cadences: {read_s:.3f}s, {B / read_s:.6g} files/s (written in "
        f"{write_s:.3f}s) [{card}]")
    start_sweep()
    t0 = time.perf_counter()
    stack = coll.to_stack()
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    one_grid = bool(torch.all(stack.time == stack.time[0:1]))
    log(f"LightCurve API: to_stack() {stack_s:.3f}s, shape {stack.shape}, "
        f"{stack.flux.dtype} on {stack.device}, one time grid: {one_grid} "
        f"[{card}]")
    if (not one_grid or stack.shape != (B, n_kept)
            or stack.device.type != "cuda"
            or stack.flux.dtype != torch.float32):
        raise AssertionError("LightCurve API: to_stack() is not one float32 "
                             "time grid on the card")
    start_sweep()
    t0 = time.perf_counter()
    flat = stack.flatten(**FLATTEN_KW)
    torch.cuda.synchronize()
    flatten_s = time.perf_counter() - t0
    periods = np.linspace(*LONG_GRID)
    routes = expected_launches(flat, periods, chunk_periods,
                               launch_periods=16)
    start_sweep()
    t0 = time.perf_counter()
    best = lc_search(flat, periods, chunk_periods)
    search_s = time.perf_counter() - t0
    share = recovery(best["period"], p_inj)
    rate = B * len(periods) / search_s
    log(f"LightCurve API: stack.flatten (window 901) {flatten_s:.3f}s; "
        f"bls_search B={B} N={n_kept} P={len(periods)} in "
        f"{len(periods) // chunk_periods} calls {search_s:.3f}s ({rate:.6g} "
        f"curve-period evals/s); recovered {share:.4f}; {peak_memory()} "
        f"[{card}]")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"LightCurve API recovery {share} < "
                             f"{RECOVERY_SHARE}")
    return dict(read_s=read_s, files_per_s=B / read_s, stack_s=stack_s,
                flatten_s=flatten_s, seconds=search_s, rate=rate,
                recovered=share, routes=routes, best=best, stack=stack,
                arrays=arrays, paths=paths, p_inj=p_inj, p_rot=p_rot)


def check_lc_stack_against_numpy(lcs, chunk_periods=1024):
    """The collection's search against ``LightCurveStack.from_numpy`` of
    the same float32 arrays on the same cadences (phase 10's arrays less
    the flagged ones), flattened and searched the same way: the same
    winners, or differing ones within C2's bound."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    t, flux, dy, mask = lcs["arrays"]
    keep = np.ones(t.shape[1], bool)
    keep[LC_EVENTS] = False
    f32 = np.where(mask, flux, 0.0).astype(np.float32)[:, keep]
    ref = LightCurveStack.from_numpy(t[:, keep], f32,
                                     dy.astype(np.float32)[:, keep],
                                     mask[:, keep], device="cuda",
                                     dtype=torch.float32)
    stack = lcs["stack"]
    same = {k: bool(torch.equal(getattr(stack, k), getattr(ref, k)))
            for k in ("time", "flux", "flux_err", "mask")}
    want = lc_search(ref.flatten(**FLATTEN_KW), np.linspace(*LONG_GRID),
                     chunk_periods)
    log(f"LightCurve API: to_stack() against from_numpy on the same float32 "
        f"arrays: tensors equal {same}")
    route_gaps("LightCurve API vs from_numpy", lcs["best"], want,
               stack.shape[1], keys=("period", "duration", "transit_time"))


def lc_chain(lc):
    """The single-curve chain on one LightCurve, on the configured device:
    normalize, remove_outliers, flatten (window 901), the BLS periodogram
    on the reference's default grid with its vetting calls, fold and bin,
    the Lomb-Scargle periodogram of the raw curve and estimate_cdpp.
    Returns the pieces and each step's seconds."""
    flat, flat_s = sync_timed(lambda: lc.normalize().remove_outliers()
                              .flatten(window_length=FLATTEN_KW[
                                  "window_length"]))
    grid, bls_s = sync_timed(lambda: flat.to_periodogram("bls"))
    bls = grid[grid.period.value >= LC_MIN_PERIOD]
    period = bls.period_at_max_power
    best = dict(period=period, duration=bls.duration_at_max_power,
                transit_time=bls.transit_time_at_max_power)
    stats = bls.compute_stats(**best)
    model = bls.get_transit_model(**best)
    in_transit = bls.get_transit_mask(**best)
    folded = flat.fold(period, best["transit_time"])
    binned = folded.bin(time_bin_size=LC_FOLD_BIN)
    ls, ls_s = sync_timed(lc.to_periodogram)
    cdpp = float(lc.estimate_cdpp().value)
    return dict(flat=flat, grid=grid, bls=bls, stats=stats, model=model,
                in_transit=in_transit, folded=folded, binned=binned, ls=ls,
                cdpp=cdpp, flat_s=flat_s, bls_s=bls_s, ls_s=ls_s)


def check_chain(tag, out, p_inj, p_rot, stack_period):
    """One chain's checks: finite vetting numbers, a two-level model whose
    low level is the transit mask, a binned fold, the BLS peak within 1%
    of the injected period and of the stack's winner, and the
    Lomb-Scargle peak within one frequency step of the rotation."""
    bls, ls = out["bls"], out["ls"]
    period = float(bls.period_at_max_power.value)
    stats = out["stats"]
    depth, depth_err = stats["depth"]
    levels = np.unique(out["model"].flux.value)
    f = ls.frequency.value
    step = f[1] - f[0]
    f_peak = f[np.nanargmax(ls.power.value)]
    binned = out["binned"].flux.value
    problems = []
    if not (np.isfinite(depth) and depth > 0 and depth_err > 0):
        problems.append(f"compute_stats depth {stats['depth']}")
    if len(levels) != 2 or not np.array_equal(
            out["model"].flux.value == levels.min(), out["in_transit"]):
        problems.append("transit model and mask disagree")
    if np.isfinite(binned).sum() <= 0.9 * len(binned):
        problems.append("the binned fold is mostly empty")
    if abs(period - p_inj) / p_inj >= RECOVERY_RTOL:
        problems.append(f"BLS peak {period:.5f} d, injected {p_inj:.5f} d")
    if abs(period - stack_period) / stack_period >= RECOVERY_RTOL:
        problems.append(f"BLS peak {period:.5f} d, the stack's winner "
                        f"{stack_period:.5f} d")
    if abs(f_peak - 1.0 / p_rot) > step:
        problems.append(f"LS peak {1 / f_peak:.4f} d, rotation "
                        f"{p_rot:.4f} d (step {step:.5f} /d)")
    if problems:
        raise AssertionError(f"LightCurve API, {tag}: " + "; ".join(problems))
    return period


def phase_lc_single(lcs, card):
    """Phase 12, single curves: :data:`LC_SINGLE` curves, each taken both
    by ``read(path)`` and by ``stack[i]`` (the raw stack), through
    :func:`lc_chain` on the card in float32 (the configuration's
    defaults), each held by :func:`check_chain`; ``estimate_cdpp`` held
    against the stack's ``estimate_cdpp_batch``
    (:data:`LC_CDPP_F32_RTOL`); and on :data:`LC_F64_CURVES` curves the
    card's float32 BLS and Lomb-Scargle periodograms against the CPU's
    float64 on the same curves (the CPU's float64 flatten for the BLS):
    the same peaks, BLS power within :data:`LC_F32_POWER_RTOL`.  Returns
    the median times."""
    import torch
    from lightkurve_tpu_torch import config
    from lightkurve_tpu_torch.collections import LightCurveCollection
    from lightkurve_tpu_torch.io.read import read
    stack, best = lcs["stack"], lcs["best"]
    batch32 = stack.estimate_cdpp_batch()[:LC_SINGLE]
    times = {"flat_s": [], "bls_s": [], "ls_s": []}
    n_periods, ratio32, singles, short = None, [], [], 0
    start_sweep()
    for i in range(LC_SINGLE):
        for how, lc in (("read", read(lcs["paths"][i])), ("stack", stack[i])):
            out = lc_chain(lc)
            check_chain(f"curve {i} by {how}", out, lcs["p_inj"][i],
                        lcs["p_rot"][i], float(best["period"][i]))
            for k in times:
                times[k].append(out[k])
            n_periods = len(out["grid"].period)
            short += float(out["grid"].period_at_max_power.value) \
                < LC_MIN_PERIOD
            if how == "read":
                singles.append(lc)
                ratio32.append(out["cdpp"] / batch32[i])
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"LightCurve API: {LC_SINGLE} curves x 2 (read, stack[i]), float32 "
        f"on the card, N={LONG_N - len(LC_EVENTS)}: flatten "
        f"{med['flat_s'] * 1e3:.1f} ms, BLS periodogram "
        f"{med['bls_s'] * 1e3:.1f} ms ({n_periods} periods, "
        f"{n_periods / med['bls_s']:.6g} curve-period evals/s), LS "
        f"{med['ls_s'] * 1e3:.1f} ms (medians); {peak:.3f} GiB peak device "
        f"memory [{card}]; the default grid's highest peak below "
        f"{LC_MIN_PERIOD:g} d on {short} of {2 * LC_SINGLE} curves")
    # float64 on the CPU: estimate_cdpp of each curve and of the batch,
    # and the periodograms of LC_F64_CURVES curves
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = "cpu", torch.float64
    try:
        batch64 = LightCurveCollection(singles).to_stack(
            device="cpu", dtype=torch.float64).estimate_cdpp_batch()
        ratio64 = [lc.estimate_cdpp().value / b
                   for lc, b in zip(singles, batch64)]
        f64 = []
        for lc in singles[:LC_F64_CURVES]:
            flat = lc.normalize().remove_outliers().flatten(
                window_length=FLATTEN_KW["window_length"])
            f64.append((lc, flat, flat.to_periodogram("bls"),
                        lc.to_periodogram()))
    finally:
        config.default_device, config.default_dtype = prev
    gap = np.abs(np.asarray(ratio32) - np.asarray(ratio64))
    log(f"LightCurve API: estimate_cdpp / estimate_cdpp_batch, card float32 "
        f"{np.min(ratio32):.6f}-{np.max(ratio32):.6f}, CPU float64 "
        f"{np.min(ratio64):.6f}-{np.max(ratio64):.6f}; largest difference "
        f"{gap.max():.3g} (bar {LC_CDPP_F32_RTOL:g})")
    if gap.max() > LC_CDPP_F32_RTOL:
        raise AssertionError("LightCurve API: estimate_cdpp against "
                             "estimate_cdpp_batch differs from float64")
    for i, (lc, flat, bls64, ls64) in enumerate(f64):
        bls32, ls32 = flat.to_periodogram("bls"), lc.to_periodogram()
        bls32, bls64 = (g[g.period.value >= LC_MIN_PERIOD]
                        for g in (bls32, bls64))
        k = int(np.nanargmax(bls64.power.value))
        rel = abs(float(bls32.power.value[k]) / bls64.power.value[k] - 1)
        same_bls = int(np.nanargmax(bls32.power.value)) == k
        same_ls = (int(np.nanargmax(ls32.power.value))
                   == int(np.nanargmax(ls64.power.value)))
        log(f"LightCurve API: curve {i}, card float32 vs CPU float64: BLS "
            f"peak {'same' if same_bls else 'differs'} "
            f"({bls64.period[k].value:.6f} d), power at it {rel:.3g} "
            f"relative (bar {LC_F32_POWER_RTOL:g}); LS peak "
            f"{'same' if same_ls else 'differs'}")
        if not (same_bls and same_ls and rel <= LC_F32_POWER_RTOL):
            raise AssertionError(f"LightCurve API: curve {i}'s float32 "
                                 "periodograms differ from float64")
    return med


# ---------------------------------------------------------------------------
# phase 13: pixels on the card (target pixel files, PLD, the correctors)
# ---------------------------------------------------------------------------
#: phase 13's stack: TESS targets of 11 x 11 pixels over phase 10's sector
PIX_B = 512
PIX_SHAPE = (11, 11)
PIX_SEED = 2033
#: star flux (log10 e/s), background (e/s/px), PSF sigma (px), the PSF
#: centre's offset from the middle pixel (px)
PIX_FLUX = (3.5, 5.0)
PIX_BKG = (10.0, 50.0)
PIX_PSF_SIGMA = (0.8, 1.2)
PIX_CENTRE = 0.3
#: the pointing: white jitter common to every target (px rms) and a
#: momentum-dump sawtooth (a drift of this many px per cycle in column and
#: row, reset at every dump)
PIX_JITTER = 0.05
PIX_DUMP_DAYS = 3.125
PIX_DUMP_DRIFT = (0.06, 0.03)
#: share of each target's cadences whose image is NaN
PIX_NAN_SHARE = 0.03
#: seconds of exposure per cadence (photon noise)
PIX_EXPOSURE_S = 120.0
#: the aperture: pixels whose centre lies within this many px of the PSF
PIX_APERTURE_PX = 2.0
#: pld_correct's configuration (lightkurve_tpu's bench, bench.py:423-453)
PIX_PLD = dict(pld_order=1, n_pca_terms=3)
#: recovery: a transit is detectable where its measured signal-to-noise
#: passes the 7.1-sigma threshold of the Kepler and TESS pipelines
#: (Jenkins et al. 2010, ApJ 713, L87).  A measured SNR scatters with
#: unit variance about the expected one (photon noise of star and aperture
#: background, every valid in-transit cadence), so from an expected SNR of
#: 7.1 + 1.645 it passes the threshold in 95% of draws.  The search of the
#: PLD-corrected stack must recover at least PIX_RECOVERY_SHARE of the
#: targets of expected SNR >= PIX_SNR; over all targets it must recover at
#: least as many as the search of the uncorrected aperture flux
PIX_RECOVERY_SHARE = 0.95
PIX_DETECT_SNR = 7.1
PIX_SNR = PIX_DETECT_SNR + 1.645
#: periods of call 4 (its longest) at which phase 13 holds the kernels of
#: its search against their plain versions
PIX_KERNEL_PERIODS = 256
#: targets held in float64 on the CPU against the card's float32, and the
#: bar on their corrected flux (largest difference over the median flux,
#: 2.5% of the injected depth)
PIX_F64_TARGETS = 4
PIX_F64_RTOL = 1e-5
#: phase 13 (b): TESS files (brighter stars, so every transit shows on one
#: curve) and K2-like Kepler files
PIX_FILES = 8
PIX_FILE_FLUX = (4.7, 5.0)
K2_FILES = 4
K2_N = 3500
K2_SHAPE = (8, 8)
K2_CADENCE_D = 29.4 / 60 / 24
K2_FIRING_D = 0.25
#: files held in float64 on the CPU, per kind
PIX_F64_FILES = 2


def pixel_sector(B, seed, device, dtype=None, flux_range=PIX_FLUX,
                 chunk=64):
    """Phase 13's TESS pixel stack, made on ``device`` from ``seed``: B
    targets x phase 10's sector (19,440 two-minute cadences with its
    downlink gap) x 11 x 11 pixels.  Each target: a Gaussian PSF (sigma
    0.8-1.2 px) centred within 0.3 px of the middle, star flux
    10^3.5-10^5 e/s (``flux_range``), background 10-50 e/s/px, photon
    noise of a two-minute exposure; a pointing common to all targets
    (white jitter of 0.05 px rms and a momentum-dump sawtooth every
    3.125 d); one 0.1-d transit of phase 10's depth (400 ppm) at a period
    of 1.2-8.5 d; 3% of cadences NaN.  Returns the
    :class:`~lightkurve_tpu_torch.batch.TPFStack` (aperture: the pixels
    within 2 px of each PSF centre) and the truth: injected periods, the
    expected transit SNR, the pointing."""
    import torch
    from lightkurve_tpu_torch.batch import TPFStack
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    t = sector_times(1)
    t[LONG_N // 2:] += DOWNLINK_GAP_DAYS
    N = t.size
    H, W = PIX_SHAPE
    star = 10 ** rng.uniform(*flux_range, B)
    bkg = rng.uniform(*PIX_BKG, B)
    sig = rng.uniform(*PIX_PSF_SIGMA, B)
    c0 = (W - 1) / 2 + rng.uniform(-PIX_CENTRE, PIX_CENTRE, B)
    r0 = (H - 1) / 2 + rng.uniform(-PIX_CENTRE, PIX_CENTRE, B)
    p_inj = rng.uniform(1.2, 8.5, B)
    transit = np.ones((B, N))
    inject_transits(transit, t, p_inj, rng, FLATTEN_DEPTH)
    nan_cad = rng.random((B, N)) < PIX_NAN_SHARE
    saw = np.mod(t - t[0], PIX_DUMP_DAYS) / PIX_DUMP_DAYS - 0.5
    dcol = PIX_DUMP_DRIFT[0] * saw + PIX_JITTER * rng.standard_normal(N)
    drow = PIX_DUMP_DRIFT[1] * saw + PIX_JITTER * rng.standard_normal(N)
    yy, xx = np.mgrid[:H, :W]
    aperture = np.hypot(xx[None] - c0[:, None, None],
                        yy[None] - r0[:, None, None]) <= PIX_APERTURE_PX
    # expected SNR: the aperture's share of the PSF at rest, photon noise
    # of star and background, every valid in-transit cadence
    s2 = 2 * sig[:, None, None] ** 2
    psf0 = np.exp(-((xx[None] - c0[:, None, None]) ** 2
                    + (yy[None] - r0[:, None, None]) ** 2) / s2) / (np.pi * s2)
    f_ap = star * (psf0 * aperture).sum((1, 2))
    noise = np.sqrt((f_ap + bkg * aperture.sum((1, 2))) / PIX_EXPOSURE_S)
    n_in = ((transit < 1) & ~nan_cad).sum(1)
    snr = FLATTEN_DEPTH * f_ap * np.sqrt(n_in) / noise
    gen = torch.Generator(device=device).manual_seed(seed)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    tt = put(t)
    flux = torch.empty((B, N, H, W), dtype=dtype, device=device)
    err = torch.empty_like(flux)
    xg, yg = put(xx), put(yy)
    dc, dr = put(dcol), put(drow)
    for lo in range(0, B, chunk):
        s = slice(lo, lo + chunk)
        b = len(range(B)[s])
        cx = put(c0[s])[:, None, None, None] + dc[None, :, None, None]
        cy = put(r0[s])[:, None, None, None] + dr[None, :, None, None]
        two_s2 = 2 * put(sig[s])[:, None, None, None] ** 2
        psf = torch.exp(-((xg - cx) ** 2 + (yg - cy) ** 2) / two_s2) / (
            np.pi * two_s2)
        img = put(star[s])[:, None, None, None] * put(transit[s])[
            :, :, None, None] * psf + put(bkg[s])[:, None, None, None]
        e = torch.sqrt(img / PIX_EXPOSURE_S)
        img = img + e * torch.randn(img.shape, generator=gen, dtype=dtype,
                                    device=device)
        bad = torch.as_tensor(nan_cad[s], device=device)[:, :, None, None]
        flux[s] = torch.where(bad, torch.nan, img)
        err[s] = e
        del psf, img, e, bad
    stack = TPFStack(flux=flux, flux_err=err, time=tt[None].expand(B, N),
                     aperture=torch.as_tensor(aperture, device=device),
                     meta=[{"TICID": i} for i in range(B)],
                     time_format="btjd")
    truth = dict(p_inj=p_inj, snr=snr, dcol=dcol, drow=drow, star=star,
                 bkg=bkg, time=t)
    return stack, truth


def pixel_search(stack, chunk_periods=1024):
    """``flatten`` (phase 10's window) then ``bls_search`` over
    :data:`LONG_GRID` in four calls; returns the flattened stack, the
    winners and the search's seconds."""
    import torch
    flat = stack.flatten(**FLATTEN_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = lc_search(flat, np.linspace(*LONG_GRID), chunk_periods)
    return flat, best, time.perf_counter() - t0


def phase_pixels_stack(card, B=PIX_B):
    """Phase 13 (a), the sector-scale path: :func:`pixel_sector` on the
    card in float32, ``extract_aperture_photometry`` and
    ``pld_correct(pld_order=1, n_pca_terms=3)`` (timed on a second call,
    with the peak device memory), then ``flatten`` and ``bls_search``
    over 1-9 d in four calls.  Checks finite corrected flux of the valid
    cadences and the recovery (:data:`PIX_RECOVERY_SHARE` of the targets
    of expected SNR >= :data:`PIX_SNR`).  Returns the numbers, the launches
    the route rule gives, and what the other checks need."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack, truth = pixel_sector(B, PIX_SEED, "cuda")
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    stack.pld_correct(**PIX_PLD)                              # warm-up
    start_sweep()
    t0 = time.perf_counter()
    raw = stack.extract_aperture_photometry()
    torch.cuda.synchronize()
    phot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    corrected = stack.pld_correct(**PIX_PLD)
    torch.cuda.synchronize()
    pld_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    good = corrected.flux[corrected.mask]
    log(f"pixels: B={B} x {LONG_N} cadences x {PIX_SHAPE[0]}x{PIX_SHAPE[1]} "
        f"px float32 (cube {stack.flux.numel() * 4 / 1e9:.3f} GB; made on "
        f"the card in {make_s:.3f}s): extract_aperture_photometry "
        f"{phot_s:.3f}s, pld_correct(pld_order=1, n_pca_terms=3) "
        f"{pld_s:.3f}s, {B / pld_s:.6g} targets/s, photometry + PLD "
        f"{B / (phot_s + pld_s):.6g} targets/s; peak device memory "
        f"{peak:.3f} GiB allocated [{card}]")
    if not bool(torch.isfinite(good).all()) or not bool(
            torch.equal(corrected.mask, raw.mask)):
        raise AssertionError("pixels: non-finite corrected flux, or masks "
                             "that differ from the photometry's")
    periods = np.linspace(*LONG_GRID)
    flat, best, search_s = pixel_search(corrected)
    routes = expected_launches(flat, periods, 1024, launch_periods=16)
    share = recovery(best["period"], truth["p_inj"])
    bright = truth["snr"] >= PIX_SNR
    share_bright = recovery(best["period"][bright], truth["p_inj"][bright])
    log(f"pixels: PLD -> flatten -> bls_search B={B} P={len(periods)} in 4 "
        f"calls: search {search_s:.3f}s ({B * len(periods) / search_s:.6g} "
        f"curve-period evals/s); recovered {share:.4f} of all, "
        f"{share_bright:.4f} of the {int(bright.sum())} of expected SNR >= "
        f"{PIX_SNR:g} (bar {PIX_RECOVERY_SHARE}); "
        f"{recovery_bands(best, truth)} [{card}]")
    if share_bright < PIX_RECOVERY_SHARE:
        raise AssertionError(f"pixels: recovery {share_bright} of the "
                             f"detectable transits < {PIX_RECOVERY_SHARE}")
    return dict(make_s=make_s, phot_s=phot_s, pld_s=pld_s, peak_gib=peak,
                seconds=search_s, recovered=share,
                recovered_bright=share_bright, routes=routes, stack=stack,
                raw=raw, corrected=corrected, flat=flat, truth=truth,
                bright=bright)


def recovery_bands(best, truth, edges=(PIX_DETECT_SNR, 12.0)):
    """The recovery of the targets of expected SNR at or above each of
    ``edges``, as text."""
    return ", ".join(
        f"{recovery(best['period'][b], truth['p_inj'][b]):.4f} of the "
        f"{int(b.sum())} of SNR >= {e:g}"
        for e, b in ((e, truth["snr"] >= e) for e in edges))


def phase_pixels_raw(px, card):
    """Phase 13 (a), the same search on the uncorrected aperture flux:
    its recovery, which the corrected search must not fall below."""
    flat, best, secs = pixel_search(px["raw"])
    share = recovery(best["period"], px["truth"]["p_inj"])
    b = px["bright"]
    share_bright = recovery(best["period"][b], px["truth"]["p_inj"][b])
    log(f"pixels: the uncorrected aperture flux -> flatten -> bls_search: "
        f"recovered {share:.4f} of all, {share_bright:.4f} of expected SNR "
        f">= {PIX_SNR:g}; {recovery_bands(best, px['truth'])}; with PLD "
        f"{px['recovered']:.4f} and {px['recovered_bright']:.4f} [{card}]")
    if px["recovered"] < share:
        raise AssertionError("pixels: the PLD-corrected search recovers "
                             "fewer transits than the uncorrected one")
    return dict(routes=expected_launches(flat, np.linspace(*LONG_GRID), 1024,
                                         launch_periods=16),
                recovered=share, recovered_bright=share_bright)


def phase_pixels(tmp, card, sweep, runs):
    """Phase 13, each part a path of its own: (a) the PLD-corrected search
    and the uncorrected one (their launches as the route rule gives them,
    through ``sweep``), call 4 on both routes, the float32-against-float64
    check; (b) the single files, where no kernel may launch.  Adds the
    paths' launches to ``runs``; returns (a)'s times and (b)'s numbers."""
    import torch
    t0 = time.time()
    px = sweep("pixels, PLD -> search (phase 13)", phase_pixels_stack, card)
    sweep("pixels, uncorrected -> search (phase 13)", phase_pixels_raw, px,
          card)
    call4 = np.linspace(*LONG_GRID)[3072:]
    runs.update(pixel_routes(px["flat"], call4))
    errs = check_pixel_kernels(px["flat"], call4[-PIX_KERNEL_PERIODS:])
    check_pixels_f64(px, card)
    numbers = {k: px[k] for k in ("phot_s", "pld_s", "peak_gib")}
    numbers["errs"] = errs
    del px
    torch.cuda.empty_cache()
    files, _ = drive("pixels, files (phase 13)", phase_pixels_files, tmp,
                     card, forbid=tuple(kernel_table()))
    torch.cuda.empty_cache()
    log(f"phase 13: {time.time() - t0:.1f}s")
    return numbers, files


def pixel_routes(flat, pvals, label="pixels", phase=13):
    """Call 4 of phase 13 (a)'s search (``pvals``) on the corrected,
    flattened stack (or, with ``label`` and ``phase``, another weighted
    search's) through the entry point on both routes
    (:func:`route_call`), each a path of its own: ``fold_impl="fused"``
    launches K-WF and no other kernel, ``"staged"`` K-SF and K-W and no
    other (the route rule gives this call the fused kernel at 512
    curves).  The winners' power gaps are held to C2's bound
    (:func:`route_gaps`).  Returns each path's launches."""
    runs, win = {}, {}
    for impl, kerns in (("fused", ("K-WF",)), ("staged", ("K-SF", "K-W"))):
        path = f"{label}, call 4, {impl} route (phase {phase})"
        win[impl], runs[path] = drive(
            path, lambda: route_call(flat, pvals, impl)[1], expect=kerns,
            forbid=tuple(k for k in kernel_table() if k not in kerns))
    route_gaps(f"{label}, call 4", win["fused"], win["staged"],
               flat.shape[1], keys=("period", "duration", "transit_time"))
    return runs


class _Caught(Exception):
    """Stops the entry point once it has handed the scan its inputs."""


def caught_scan(name, call):
    """The arguments ``ops.bls`` hands its scan ``name``
    (``fused_scan_weighted``, ``fused_scan_uniform``) in ``call()``,
    caught before the scan runs, so no kernel launches."""
    from lightkurve_tpu_torch.ops import bls
    seen, scan = [], getattr(bls, name)

    def catch(*args, **kw):
        seen.append((args, kw))
        raise _Caught

    setattr(bls, name, catch)
    try:
        call()
    except _Caught:
        pass
    finally:
        setattr(bls, name, scan)
    return seen[0]


def entry_scan_args(stack, pvals):
    """The arguments ``bls_power_shared_batch`` hands the weighted scan for
    one SweepRunner chunk of ``stack`` at ``pvals`` (:func:`route_call`)."""
    return caught_scan("fused_scan_weighted",
                       lambda: route_call(stack, pvals, "fused"))


def fold_against_f64(name, ts, WWY, pc, d_phase, nbins, max_nbp, k_max,
                     wrap, chunk):
    """K-SF on the float32 columns ``WWY`` (n, cols), ``chunk`` periods a
    launch as the staged route launches it, against the plain fold of the
    same columns in float64 on the float32 run's bins: each prefix row
    within :data:`F32_FOLD_TOL` of its column's sum |x|; the count prefix
    and the bins equal to the plain version's in float32, whose rows are
    measured against the float64 fold beside K-SF's (on nearly constant
    weights torch's float32 cumsum on the card drifts past that bar,
    ROADMAP C).  Returns K-SF's max |error| against the float64 fold and
    each launch's (arguments, result)."""
    import torch
    from lightkurve_tpu_torch.ops.bls_staged_fold import (staged_fold,
                                                          staged_fold_plain)
    scale = WWY.double().abs().sum(0).clamp(
        min=torch.finfo(torch.float64).tiny)
    share = {"K-SF": 0.0, "plain": 0.0}
    err, launches = 0.0, []
    for i in range(0, pc.shape[0], chunk):
        fold = (ts, WWY, pc[i:i + chunk], d_phase, nbins, max_nbp, k_max,
                wrap)
        got, plain = staged_fold(*fold), staged_fold_plain(*fold)
        if not (torch.equal(got[1], plain[1])
                and torch.equal(got[2], plain[2])):
            raise AssertionError(f"{name}: count prefix or bins differ")
        exact = staged_fold_plain(ts, WWY.double(), *fold[2:])[0]
        for who, rows in (("K-SF", got[0]), ("plain", plain[0])):
            d = (rows.double() - exact).abs()
            share[who] = max(share[who], float((d / scale).max()))
            if who == "K-SF":
                err = max(err, float(d.max()))
        launches.append((fold, got))
    log(f"  {name} against the float64 fold: max |prefix error| {err:.3g}, "
        f"{share['K-SF']:.3g} of a column's sum |x| (bar {F32_FOLD_TOL:g}); "
        f"the plain version's float32 rows {share['plain']:.3g}")
    if share["K-SF"] > F32_FOLD_TOL:
        raise AssertionError(f"{name}: prefix rows off the float64 fold "
                             "past the bar")
    return err, launches


def check_pixel_kernels(flat, pvals, label="pixels"):
    """The kernels of phase 13 (a)'s call 4 against their plain versions
    on the inputs the entry point gives them there (:func:`entry_scan_args`
    of the flattened corrected stack at ``pvals``, its longest
    :data:`PIX_KERNEL_PERIODS` periods), at the float32 bars: K-WF in one
    launch (:func:`compare`); K-SF against the float64 fold
    (:func:`fold_against_f64`) and K-W on the K-SF rows (:func:`compare`)
    8 periods a launch, as the staged route launches them (``label`` names
    the search in the log).  Returns each kernel's max |error|."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused_weighted as bfw
    from lightkurve_tpu_torch.ops import bls_window
    args, kw = entry_scan_args(flat, pvals)
    ts, W, WY, pc, k_durs, dvals, d_phase, nbins, max_nbp, lik = args
    log(f"{label}, call 4 kernels: B={W.shape[1]} N={W.shape[0]} "
        f"P={pc.shape[0]} (periods {float(pc[0]):.4f}-{float(pc[-1]):.4f} "
        f"d, {max_nbp} bins, fold sized for {nbins}) {W.dtype}")
    errs = {}
    got, want = bfw.fused_scan_weighted(*args, **kw), \
        bfw.fused_scan_weighted_plain(*args, **kw)
    errs["K-WF"] = compare(f"K-WF {label} call 4", got, want, False)[0]
    del got, want
    WWY = torch.cat([W, WY], dim=1)
    total = WWY.sum(0)
    errs["K-SF"], folds = fold_against_f64(
        f"K-SF {label} call 4", ts, WWY, pc, d_phase, nbins, max_nbp,
        max(k_durs), kw["wrap"], kw["chunk"])
    scans, plains = [], []
    for fold, (csum, _, nbp) in folds:
        scan = (csum, nbp, fold[2], total, k_durs, dvals, d_phase, lik)
        scans.append(bls_window.window_scan(*scan))
        plains.append(bls_window.window_scan_plain(*scan))
    del folds
    errs["K-W"] = compare(f"K-W {label} call 4", *(
        {f: torch.cat([p[f] for p in parts]) for f in parts[0]}
        for parts in (scans, plains)), False)[0]
    torch.cuda.empty_cache()
    return errs


def check_pixels_f64(px, card, n=PIX_F64_TARGETS):
    """The card's float32 ``pld_correct`` of :data:`PIX_F64_TARGETS`
    targets (from the whole batch) against the port on the CPU in float64
    on the same float32 pixels: each target's corrected flux within
    :data:`PIX_F64_RTOL` of its median flux, equal masks; and the
    targets' CDPP (``estimate_cdpp_batch``) within 1%."""
    import torch
    from lightkurve_tpu_torch.batch import TPFStack
    st = px["stack"]
    cpu = TPFStack(flux=st.flux[:n].cpu().double(),
                   flux_err=st.flux_err[:n].cpu().double(),
                   time=st.time[:n].cpu().double(),
                   aperture=st.aperture[:n].cpu(), meta=st.meta[:n])
    want = cpu.pld_correct(**PIX_PLD)
    got = px["corrected"]
    m = want.mask.numpy()
    if not np.array_equal(got.mask[:n].cpu().numpy(), m):
        raise AssertionError("pixels f64: masks differ")
    g = got.flux[:n].cpu().double().numpy()
    w = want.flux.numpy()
    gap = max(float(np.abs(g[i] - w[i])[m[i]].max() / np.median(w[i][m[i]]))
              for i in range(n))
    cdpp32 = got._replace(flux=got.flux[:n], flux_err=got.flux_err[:n],
                          mask=got.mask[:n], time=got.time[:n]
                          ).estimate_cdpp_batch()
    cdpp64 = want.estimate_cdpp_batch()
    ratio = np.abs(cdpp32 / cdpp64 - 1).max()
    log(f"pixels: {n} targets, the card's float32 pld_correct against the "
        f"CPU's float64 on the same pixels: largest corrected-flux "
        f"difference {gap:.3g} of a target's median flux (bar "
        f"{PIX_F64_RTOL:g}; "
        f"the transit is {FLATTEN_DEPTH:g}); CDPP ratio within {ratio:.3g} "
        f"[{card}]")
    if gap > PIX_F64_RTOL or ratio > 0.01:
        raise AssertionError("pixels: float32 pld_correct differs from "
                             "float64 past the bar")
    return dict(gap=gap, cdpp=ratio)


def tess_tpfs(n=PIX_FILES, seed=PIX_SEED + 1, device="cuda"):
    """:data:`PIX_FILES` TESS target pixel files of :func:`pixel_sector`
    (brighter stars, made on ``device``) as the port's
    ``TessTargetPixelFile``: SPOC's columns
    (TIME, CADENCENO, FLUX, FLUX_ERR, FLUX_BKG, FLUX_BKG_ERR, QUALITY,
    POS_CORR1/2), the aperture extension (bit 2: the pipeline aperture,
    bit 4: background pixels beyond 4 px), a TAN WCS.  Returns them and
    the injected periods."""
    import torch
    from lightkurve_tpu_torch.targetpixelfile import TessTargetPixelFile
    stack, truth = pixel_sector(n, seed, device, flux_range=PIX_FILE_FLUX)
    flux, err = stack.flux.cpu().numpy(), stack.flux_err.cpu().numpy()
    ap = stack.aperture.cpu().numpy()
    del stack
    if device != "cpu":
        torch.cuda.empty_cache()
    H, W = PIX_SHAPE
    yy, xx = np.mgrid[:H, :W]
    far = np.hypot(xx - (W - 1) / 2, yy - (H - 1) / 2) > 4.0
    tpfs = []
    for i in range(n):
        cols = {"TIME": truth["time"],
                "CADENCENO": np.arange(LONG_N, dtype=np.int32),
                "FLUX": flux[i], "FLUX_ERR": err[i],
                "FLUX_BKG": np.full(flux[i].shape, truth["bkg"][i],
                                    np.float32),
                "FLUX_BKG_ERR": np.full(flux[i].shape, 0.1, np.float32),
                "QUALITY": np.zeros(LONG_N, np.int32),
                "POS_CORR1": truth["dcol"].astype(np.float32),
                "POS_CORR2": truth["drow"].astype(np.float32)}
        meta = {"TELESCOP": "TESS", "MISSION": "TESS", "ORIGIN": "NASA/Ames",
                "CREATOR": "TargetPixelExporterPipelineModule",
                "OBJECT": f"TIC {i}", "TICID": i, "SECTOR": 99,
                "CAMERA": 1, "CCD": 1, "RA_OBJ": 80.0, "DEC_OBJ": -70.0}
        header = {"BJDREFI": 2457000, "1CRV5P": 1000, "2CRV5P": 500,
                  "1CRPX5": (W + 1) / 2, "2CRPX5": (H + 1) / 2,
                  "1CRVL5": 80.0, "2CRVL5": -70.0, "1CDLT5": -21 / 3600,
                  "2CDLT5": 21 / 3600, "11PC5": 1.0, "12PC5": 0.0,
                  "21PC5": 0.0, "22PC5": 1.0, "1CTYP5": "RA---TAN",
                  "2CTYP5": "DEC--TAN"}
        bits = (1 + 2 * ap[i] + 4 * far).astype(np.int32)
        tpfs.append(TessTargetPixelFile._from_arrays(
            cols, meta, ext_header=header, aperture=bits,
            quality_bitmask="none"))
    return tpfs, truth["p_inj"]


def write_tess_tpfs(directory):
    """:func:`tess_tpfs` written by the port's ``to_fits``, one per file;
    returns the paths, the injected periods and the writes' seconds."""
    tpfs, p_inj = tess_tpfs()
    os.makedirs(directory, exist_ok=True)
    t0 = time.perf_counter()
    paths = []
    for i, tpf in enumerate(tpfs):
        path = os.path.join(directory, f"tess-s0099-{i:016d}_tp.fits")
        tpf.to_fits(path, overwrite=True)
        paths.append(path)
    return paths, p_inj, time.perf_counter() - t0


def k2_arrays(n_files=K2_FILES, seed=PIX_SEED + 2):
    """K2-like Kepler pixel data: 3,500 long cadences (71.5 d) x 8 x 8;
    the roll drifts the star along an arc and a thruster firing every
    ~6 h snaps it back; a 5-px aperture loses flux as the star moves; a
    slow stellar variation; photon noise of a 29.4-min exposure.  Returns
    per file (columns, aperture bits)."""
    rng = np.random.default_rng(seed)
    t = 2000.0 + np.arange(K2_N) * K2_CADENCE_D
    H, W = K2_SHAPE
    yy, xx = np.mgrid[:H, :W]
    out = []
    for i in range(n_files):
        period = K2_FIRING_D * rng.uniform(0.9, 1.1)
        phase = np.mod(t - t[0], period) / period
        dcol = 0.5 * phase + 0.01 * rng.standard_normal(K2_N)
        drow = 0.25 * phase ** 1.3 + 0.01 * rng.standard_normal(K2_N)
        star = 10 ** rng.uniform(4.3, 4.8)
        c0, r0 = 3.3 + rng.uniform(-0.2, 0.2), 3.6 + rng.uniform(-0.2, 0.2)
        sig = rng.uniform(0.9, 1.2)
        var = 1 + 0.002 * np.sin(2 * np.pi * t / rng.uniform(5, 15))
        psf = np.exp(-((xx - c0 - dcol[:, None, None]) ** 2
                       + (yy - r0 - drow[:, None, None]) ** 2)
                     / (2 * sig ** 2)) / (2 * np.pi * sig ** 2)
        img = star * var[:, None, None] * psf + 20.0
        exposure = K2_CADENCE_D * 86400
        e = np.sqrt(img / exposure)
        img = img + e * rng.standard_normal(img.shape)
        ap = np.hypot(xx - c0, yy - r0) <= 1.3
        cols = {"TIME": t, "CADENCENO": np.arange(K2_N, dtype=np.int32),
                "FLUX": img.astype(np.float32), "FLUX_ERR": e.astype(
                    np.float32), "QUALITY": np.zeros(K2_N, np.int32),
                "POS_CORR1": dcol.astype(np.float32),
                "POS_CORR2": drow.astype(np.float32)}
        out.append((cols, (1 + 2 * ap).astype(np.int32)))
    return out


def write_k2_tpfs(directory):
    """:func:`k2_arrays` written by the port's ``to_fits`` as K2 target
    pixel files; returns the paths and the seconds the writes took."""
    from lightkurve_tpu_torch.targetpixelfile import KeplerTargetPixelFile
    os.makedirs(directory, exist_ok=True)
    t0 = time.perf_counter()
    paths = []
    for i, (cols, bits) in enumerate(k2_arrays()):
        meta = {"TELESCOP": "Kepler", "MISSION": "K2", "OBJECT": f"EPIC {i}",
                "CREATOR": "TargetPixelExporterPipelineModule",
                "KEPLERID": i, "CAMPAIGN": 99, "CHANNEL": 42}
        header = {"BJDREFI": 2454833, "1CRV5P": 300, "2CRV5P": 600}
        tpf = KeplerTargetPixelFile._from_arrays(cols, meta,
                                                 ext_header=header,
                                                 aperture=bits,
                                                 quality_bitmask="none")
        path = os.path.join(directory, f"ktwo2{i:08d}-c99_lpd-targ.fits")
        tpf.to_fits(path, overwrite=True)
        paths.append(path)
    return paths, time.perf_counter() - t0


def tess_file_chain(tpf):
    """One TESS TPF: photometry with the pipeline aperture and with a
    threshold mask, centroids both ways, the background, then
    ``PLDCorrector(tpf).correct()`` at its defaults, ``flatten`` and the
    BLS periodogram; returns the pieces and each step's seconds."""
    from lightkurve_tpu_torch.correctors import PLDCorrector
    lc, phot_s = sync_timed(lambda: tpf.to_lightcurve())
    thr = tpf.create_threshold_mask()
    lc_thr = tpf.to_lightcurve(aperture_mask=thr)
    cm = tpf.estimate_centroids(method="moments")
    cq = tpf.estimate_centroids(method="quadratic")
    bkg = tpf.estimate_background()
    pld = PLDCorrector(tpf)
    clc, pld_s = sync_timed(pld.correct)
    flat = clc.flatten(window_length=FLATTEN_KW["window_length"])
    grid, bls_s = sync_timed(lambda: flat.to_periodogram("bls"))
    return dict(lc=lc, lc_thr=lc_thr, cm=cm, cq=cq, bkg=bkg, pld=pld,
                clc=clc, grid=grid, phot_s=phot_s, pld_s=pld_s, bls_s=bls_s)


def k2_file_chain(tpf):
    """One K2 TPF: photometry, the SFF corrector through
    ``to_corrector("sff")``, a RegressionCorrector with a spline design
    matrix, and the SFF correction's over-fitting metric; returns the
    pieces and the correctors' seconds."""
    from lightkurve_tpu_torch.correctors import (RegressionCorrector,
                                                 create_spline_matrix)
    lc = tpf.to_lightcurve().remove_nans()
    sff = lc.to_corrector("sff")
    slc, sff_s = sync_timed(lambda: sff.correct(windows=20))
    # the B-spline basis sums to one, so it carries the offset
    dm = create_spline_matrix(lc.time.value, n_knots=30)
    reg = RegressionCorrector(lc)
    rlc, reg_s = sync_timed(lambda: reg.correct(dm))
    overfit, over_s = sync_timed(lambda: sff.compute_overfit_metric(
        n_samples=3, seed=1))
    return dict(lc=lc, sff=sff, slc=slc, reg=reg, rlc=rlc, overfit=overfit,
                sff_s=sff_s, reg_s=reg_s, over_s=over_s)


def phase_pixels_files(tmp, card):
    """Phase 13 (b), single files, float32 on the card: the TESS files by
    ``read`` through :func:`tess_file_chain` (the BLS peak from 1 d up
    within 1% of the injected period), the collection's ``TPFStack``
    photometry against each file's ``to_lightcurve``, the K2 files
    through :func:`k2_file_chain` (SFF lowers the CDPP of the raw curve);
    on :data:`PIX_F64_FILES` files of each kind the card's float32
    against the CPU's float64.  No BLS kernel may launch here.  Returns
    the times."""
    import torch
    from lightkurve_tpu_torch import config
    from lightkurve_tpu_torch.correctors import PLDCorrector
    from lightkurve_tpu_torch.io.read import read, read_tpf_collection
    paths, p_inj, write_s = write_tess_tpfs(os.path.join(tmp, "tpf"))
    k2_paths, k2_write_s = write_k2_tpfs(os.path.join(tmp, "k2"))
    tpfs, read_s = sync_timed(lambda: [read(p) for p in paths])
    k2s, k2_read_s = sync_timed(lambda: [read(p) for p in k2_paths])
    n_files = len(paths) + len(k2_paths)
    log(f"pixels, files: wrote {len(paths)} TESS TPFs ({LONG_N} x "
        f"{PIX_SHAPE[0]}x{PIX_SHAPE[1]}) in {write_s:.3f}s and {K2_FILES} K2 "
        f"({K2_N} x {K2_SHAPE[0]}x{K2_SHAPE[1]}) in {k2_write_s:.3f}s; read "
        f"them in {read_s:.3f}s ({len(paths) / read_s:.6g} files/s) and "
        f"{k2_read_s:.3f}s ({K2_FILES / k2_read_s:.6g} files/s) [{card}]")
    if {type(t).__name__ for t in tpfs} != {"TessTargetPixelFile"} or {
            type(t).__name__ for t in k2s} != {"KeplerTargetPixelFile"}:
        raise AssertionError("pixels: read gave the wrong TPF classes")
    start_sweep()
    times = {k: [] for k in ("phot_s", "pld_s", "bls_s", "sff_s", "reg_s",
                             "over_s")}
    outs = []
    for i, tpf in enumerate(tpfs):
        out = tess_file_chain(tpf)
        outs.append(out)
        for k in ("phot_s", "pld_s", "bls_s"):
            times[k].append(out[k])
        g = out["grid"]
        g = g[g.period.value >= LC_MIN_PERIOD]
        period = float(g.period_at_max_power.value)
        problems = []
        if abs(period - p_inj[i]) / p_inj[i] >= RECOVERY_RTOL:
            problems.append(f"BLS peak {period:.5f} d, injected "
                            f"{p_inj[i]:.5f} d")
        for name in ("lc", "lc_thr", "clc"):
            if np.isfinite(out[name].flux.value).sum() < 0.9 * LONG_N:
                problems.append(f"{name} mostly non-finite")
        for c in (*out["cm"], *out["cq"]):
            if np.nanmax(np.abs(c.value - np.nanmedian(c.value))) > 1.0:
                problems.append("centroids wander by more than a pixel")
        if problems:
            raise AssertionError(f"pixels, TESS file {i}: "
                                 + "; ".join(problems))
    coll = read_tpf_collection(paths)
    stack = coll.to_stack(aperture_mask="pipeline")
    lcs = stack.extract_aperture_photometry()
    worst = 0.0
    for i, out in enumerate(outs):
        want = out["lc"].flux.value
        m = lcs.mask[i].cpu().numpy()
        if not np.array_equal(m, np.isfinite(want)):
            raise AssertionError("pixels: the stack's photometry masks "
                                 "differ from the files'")
        got = lcs.flux[i].cpu().numpy()[m].astype(float)
        worst = max(worst, float(np.max(np.abs(got - want[m])
                                        / np.abs(want[m]))))
    log(f"pixels: TargetPixelFileCollection -> TPFStack -> "
        f"extract_aperture_photometry against each file's to_lightcurve: "
        f"largest relative difference {worst:.3g} (bar 1e-6, float32)")
    if worst > 1e-6:
        raise AssertionError("pixels: the stack's photometry differs from "
                             "the files'")
    k2_outs = []
    for i, tpf in enumerate(k2s):
        out = k2_file_chain(tpf)
        k2_outs.append(out)
        for k in ("sff_s", "reg_s", "over_s"):
            times[k].append(out[k])
        raw = out["lc"].normalize().estimate_cdpp().value
        sff = out["slc"].normalize().estimate_cdpp().value
        reg = out["rlc"].normalize().estimate_cdpp().value
        log(f"pixels, K2 file {i}: CDPP raw {raw:.2f} ppm, SFF {sff:.2f}, "
            f"spline regression {reg:.2f}; overfit metric "
            f"{out['overfit']:.4f}; {len(out['sff'].window_points)} windows")
        if not sff < raw or not np.isfinite(reg) or not (
                0 <= out["overfit"] <= 1):
            raise AssertionError(f"pixels, K2 file {i}: SFF did not lower "
                                 "the CDPP, or a result is not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"pixels, files (medians): TESS to_lightcurve "
        f"{med['phot_s'] * 1e3:.1f} ms, PLDCorrector.correct "
        f"{med['pld_s'] * 1e3:.1f} ms, BLS periodogram "
        f"{med['bls_s'] * 1e3:.1f} ms; K2 SFF {med['sff_s'] * 1e3:.1f} ms, "
        f"spline regression {med['reg_s'] * 1e3:.1f} ms, overfit metric "
        f"{med['over_s'] * 1e3:.1f} ms; {peak:.3f} GiB peak device memory "
        f"[{card}]")
    # float64 on the CPU, the same files
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = "cpu", torch.float64
    try:
        f64 = [(o["clc"], PLDCorrector(t).correct()) for o, t in
               zip(outs[:PIX_F64_FILES], tpfs)]
        k64 = []
        for o, t in zip(k2_outs[:PIX_F64_FILES], k2s):
            sff64 = t.to_lightcurve().remove_nans().to_corrector("sff")
            k64.append((o["slc"], sff64.correct(windows=20)))
            if not np.array_equal(o["sff"].window_points,
                                  sff64.window_points):
                raise AssertionError("pixels, files: float32 SFF windows "
                                     "differ from float64's")
            log(f"  SFF arclength, card float32 against CPU float64: "
                f"{np.max(np.abs(o['sff'].arclength - sff64.arclength)):.3g}"
                f" px at most")
    finally:
        config.default_device, config.default_dtype = prev
    gaps = {}
    for kind, pairs in (("PLD", f64), ("SFF", k64)):
        g = []
        for got, want in pairs:
            w, v = want.flux.value, got.flux.value
            g.append(float(np.nanmax(np.abs(v - w)) / np.nanmedian(
                np.abs(w))))
        gaps[kind] = max(g)
    log(f"pixels, files: the card's float32 against the CPU's float64 on "
        f"{PIX_F64_FILES} files each: PLD corrected flux {gaps['PLD']:.3g}, "
        f"SFF {gaps['SFF']:.3g} of the median flux (bar "
        f"{PIX_F64_RTOL:g}) [{card}]")
    if max(gaps.values()) > PIX_F64_RTOL:
        raise AssertionError("pixels, files: float32 correctors differ "
                             "from float64 past the bar")
    return dict(med, files_per_s=len(paths) / read_s, write_s=write_s,
                gaps=gaps, n_files=n_files)


# ---------------------------------------------------------------------------
# phase 14 (a): CBV cotrending of a TESS CCD's targets, then the search
# ---------------------------------------------------------------------------
#: one CCD's CBVs and 256 of its two-minute targets on phase 10's sector
CBV_B = 256
CBV_SEED = 2035
CBV_SECTOR, CBV_CAMERA, CBV_CCD = 99, 2, 4
#: vectors per set, as SPOC writes them: single-scale, each of three
#: multiscale bands, spike
CBV_SINGLE, CBV_BAND, CBV_SPIKE = 16, 8, 8
#: the CBV file spans the light curves' cadences and the downlink gap's
#: 720 (flagged GAP); its cadence numbers start here
CBV_CADENCE0 = 10_000
CBV_GAP = (LONG_N // 2, LONG_N // 2 + 720)
#: each target's SAP flux carries a mix of single-scale vectors 1-8 and of
#: the spike vectors, each peaking at 0.1-1% of the flux
CBV_MIX = 8
CBV_SYSTEMATIC = (0.001, 0.01)
#: the per-target correction (the upstream tutorials' call)
CBV_CORRECT = dict(cbv_type=["SingleScale", "Spike"],
                   cbv_indices=[np.arange(1, 9), "ALL"], alpha=1e-4)
#: targets timed on a second pass; through correct() (alpha optimised,
#: neighbours' SAP flux for the under-fitting metric), correct_elasticnet,
#: interpolated CBVs, and float64 on the CPU
CBV_TIMED = 16
CBV_OPTIMISED = 4
CBV_NEIGHBOURS = 50
CBV_ELASTICNET = 4
CBV_INTERPOLATED = 4
CBV_F64 = 2
#: interpolated against aligned CBVs, and the card against the CPU's
#: float64: corrected flux within this share of the median flux
CBV_RTOL = 1e-6


def cbv_grid():
    """The CBV file's cadence numbers and times (BTJD): phase 10's sector
    with its downlink gap's cadences in place, and the light curves'
    cadences among them (the gap's left out)."""
    from lightkurve_tpu_torch.tools import make_sector as ms
    n = LONG_N + CBV_GAP[1] - CBV_GAP[0]
    t = np.arange(n) * (2.0 / 60 / 24) + ms.T_OFFSET + 1500.0
    cad = CBV_CADENCE0 + np.arange(n)
    lc = np.ones(n, bool)
    lc[CBV_GAP[0]:CBV_GAP[1]] = False
    return cad, t, lc


def cbv_vectors(t, seed=CBV_SEED):
    """The CCD's vectors on the CBV grid ``t`` (zero in the gap): 16
    single-scale and 8 per band, smooth, each set orthonormal (random
    mixes of sinusoids of 0.3-13 d for the single scale, 5-30 d, 1-5 d and
    0.2-1 d for bands 1-3, and a linear drift), and 8 sparse spike vectors
    of unit norm (a few cadences each, as momentum dumps)."""
    rng = np.random.default_rng(seed)
    _, _, lc = cbv_grid()

    def smooth(k, periods):
        p = np.exp(rng.uniform(*np.log(periods), (k, 4)))
        phase = rng.uniform(0, 2 * np.pi, (k, 4))
        raw = np.sin(2 * np.pi * t[None, :, None] / p[:, None]
                     + phase[:, None]).sum(-1)
        raw[0] += np.linspace(-1, 1, t.size)
        raw[:, ~lc] = 0.0
        q, _ = np.linalg.qr(raw.T)
        return q.T

    spikes = np.zeros((CBV_SPIKE, t.size))
    where = np.flatnonzero(lc)
    for i in range(CBV_SPIKE):
        at = rng.choice(where, 12, replace=False)
        spikes[i, at] = rng.standard_normal(12)
    spikes /= np.linalg.norm(spikes, axis=1, keepdims=True)
    return {"single": smooth(CBV_SINGLE, (0.3, 13.0)),
            "bands": [smooth(CBV_BAND, b) for b in ((5.0, 30.0), (1.0, 5.0),
                                                     (0.2, 1.0))],
            "spike": spikes}


def write_cbv_file(directory, vectors):
    """The CCD's CBV file in SPOC's layout (float32 vectors; TIME, CADENCENO
    and GAP), named as the archive names it, so the loaders' pattern
    finds it."""
    from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                              PrimaryHDU, write_fits)
    cad, t, lc = cbv_grid()
    tag = f"{CBV_CAMERA}.{CBV_CCD}"

    def table(name, vecs):
        cols = {"TIME": t, "CADENCENO": cad.astype(np.int32),
                "GAP": (~lc).astype(np.uint8)}
        cols.update({f"VECTOR_{i}": v.astype(np.float32)
                     for i, v in enumerate(vecs, 1)})
        return BinTableHDU(data=cols, header=Header({"EXTNAME": name}))

    hdus = [PrimaryHDU(header=Header({
        "TELESCOP": "TESS", "SECTOR": CBV_SECTOR, "CAMERA": CBV_CAMERA,
        "CCD": CBV_CCD})), table(f"CBV.single-scale.{tag}", vectors["single"])]
    hdus += [table(f"CBV.multiscale-band-{b}.{tag}", v)
             for b, v in enumerate(vectors["bands"], 1)]
    hdus.append(table(f"CBV.spike.{tag}", vectors["spike"]))
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"tess2020-s{CBV_SECTOR:04d}-{CBV_CAMERA}-"
                                   f"{CBV_CCD}-0195-s_cbv.fits")
    write_fits(HDUList(hdus), path, overwrite=True)
    return path


def cbv_targets(vectors, B=CBV_B, seed=CBV_SEED + 1):
    """The CCD's targets as host arrays on the light curves' cadences:
    star flux 10^3.5-10^5 e/s (phase 13's), photon noise of a two-minute
    exposure, phase 10's 400-ppm transits (periods 1.2-8.5 d), 3% NaN
    cadences; the SAP flux also carries each target's mix of the
    systematics.  Returns the arrays and the truth (periods, expected SNR
    of the transit)."""
    rng = np.random.default_rng(seed)
    cad, t, lc = cbv_grid()
    t = t[lc]
    N = t.size
    star = 10 ** rng.uniform(*PIX_FLUX, B)
    sigma = np.sqrt(star / PIX_EXPOSURE_S)
    p_inj = rng.uniform(1.2, 8.5, B)
    transit = np.ones((B, N))
    inject_transits(transit, t, p_inj, rng, FLATTEN_DEPTH)
    clean = star[:, None] * transit + sigma[:, None] * rng.standard_normal(
        (B, N))
    mix = np.concatenate([vectors["single"][:CBV_MIX], vectors["spike"]])[
        :, lc]
    coef = rng.uniform(-1, 1, (B, len(mix)))
    coef *= (rng.uniform(*CBV_SYSTEMATIC, (B, len(mix))) * star[:, None]
             / np.abs(mix).max(1))
    coef[:, CBV_MIX:] *= rng.random((B, CBV_SPIKE)) < 0.5
    sap = clean + coef @ mix
    nan = rng.random((B, N)) < PIX_NAN_SHARE
    n_in = ((transit < 1) & ~nan).sum(1)
    snr = FLATTEN_DEPTH * star * np.sqrt(n_in) / sigma
    return (dict(time=t, cadenceno=cad[lc], sap=np.where(nan, np.nan, sap),
                 pdcsap=np.where(nan, np.nan, clean), sigma=sigma),
            dict(p_inj=p_inj, snr=snr))


def cbv_target_name(i):
    """The SPOC-style file name of CBV target ``i`` (TIC ``i``)."""
    return f"tess2020-s{CBV_SECTOR:04d}-{i:016d}-0195-s_lc.fits"


def write_cbv_targets(directory, arrays):
    """The targets as SPOC-style TESS light-curve files (TIME, CADENCENO,
    SAP_FLUX, PDCSAP_FLUX and their errors in e-/s, QUALITY; SECTOR,
    CAMERA and CCD in the header).  Returns the paths."""
    from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                              PrimaryHDU, write_fits)
    os.makedirs(directory, exist_ok=True)
    th = Header({"EXTNAME": "LIGHTCURVE", "BJDREFI": 2457000, "BJDREFF": 0.0,
                 "TIMESYS": "TDB", "TUNIT1": "BJD - 2457000",
                 "TUNIT3": "e-/s", "TUNIT4": "e-/s", "TUNIT5": "e-/s",
                 "TUNIT6": "e-/s"})
    N = arrays["time"].size
    paths = []
    for i in range(len(arrays["sap"])):
        path = os.path.join(directory, cbv_target_name(i))
        ph = Header({"TELESCOP": "TESS", "MISSION": "TESS",
                     "ORIGIN": "NASA/Ames",
                     "CREATOR": "LightCurveExporterPipelineModule",
                     "OBJECT": f"TIC {i}", "TICID": i, "SECTOR": CBV_SECTOR,
                     "CAMERA": CBV_CAMERA, "CCD": CBV_CCD})
        err = np.full(N, arrays["sigma"][i], np.float32)
        cols = {"TIME": arrays["time"],
                "CADENCENO": arrays["cadenceno"].astype(np.int32),
                "SAP_FLUX": arrays["sap"][i].astype(np.float32),
                "SAP_FLUX_ERR": err,
                "PDCSAP_FLUX": arrays["pdcsap"][i].astype(np.float32),
                "PDCSAP_FLUX_ERR": err,
                "QUALITY": np.zeros(N, np.int32)}
        write_fits(HDUList([PrimaryHDU(header=ph),
                            BinTableHDU(data=cols, header=th)]), path,
                   overwrite=True)
        paths.append(path)
    return paths


def on_file_cadences(lc, corrected):
    """``corrected`` (the corrector's light curve: ``lc`` less its NaN
    cadences) back on all of ``lc``'s cadences, NaN where ``lc`` has no
    flux, normalised: every target then shares one time grid in
    ``to_stack()``."""
    from lightkurve_tpu_torch.units import Quantity
    out = lc.copy()
    flux = np.full(len(lc), np.nan)
    flux[np.isin(np.asarray(lc["cadenceno"]),
                 np.asarray(corrected["cadenceno"]))] = \
        corrected.flux.value
    out.flux = Quantity(flux, lc.flux.unit)
    return out.normalize()


def cbv_neighbour_flux(corrector, others):
    """The under-fitting metric's ``neighbor_flux``: each of ``others``
    (light curves of the same CCD) normalised less one, on the corrector's
    cadences (NaN where the neighbour has no flux), as the reference's
    archive branch prepares them."""
    cad = np.asarray(corrector.lc["cadenceno"])
    out = []
    for lc in others:
        f = lc.flux.value / np.nanmedian(lc.flux.value) - 1.0
        mine = np.asarray(lc["cadenceno"])
        row = np.full(cad.size, np.nan)
        common, ia, ib = np.intersect1d(cad, mine, return_indices=True)
        row[ia] = f[ib]
        out.append(row)
    return out


def cbv_correct(path, cbv_dir, **init):
    """One target's correction as a user runs it: ``read`` of the SAP
    flux, ``to_corrector("cbv")`` and ``correct_gaussian_prior``
    (:data:`CBV_CORRECT`).  Returns the raw curve, the corrector and the
    corrected curve."""
    from lightkurve_tpu_torch.io.read import read
    lc = read(path, flux_column="sap_flux")
    corrector = lc.to_corrector("cbv", cbv_dir=cbv_dir, **init)
    return lc, corrector, corrector.correct_gaussian_prior(**CBV_CORRECT)


def phase_cbv_targets(tmp, card):
    """Phase 14 (a), the per-target part (no kernel may launch): the CBV
    file and 256 target files written; every target through
    :func:`cbv_correct` (a second pass over :data:`CBV_TIMED` timed);
    ``correct()`` with its alpha optimisation on :data:`CBV_OPTIMISED`
    targets (their neighbours' SAP flux for the under-fitting metric;
    seconds, alpha and both scores logged), ``correct_elasticnet`` on
    :data:`CBV_ELASTICNET` (seconds and FISTA iterations), interpolated
    CBVs on :data:`CBV_INTERPOLATED` (equal to the aligned result within
    :data:`CBV_RTOL` of the median flux), and :data:`CBV_F64` targets
    against float64 on the CPU.  Returns the corrected and raw curves on
    the files' cadences, the truth and the numbers."""
    import torch
    from lightkurve_tpu_torch import config
    from lightkurve_tpu_torch.io.read import read
    vectors = cbv_vectors(cbv_grid()[1])
    cbv_dir = os.path.join(tmp, "cbv")
    t0 = time.perf_counter()
    write_cbv_file(cbv_dir, vectors)
    arrays, truth = cbv_targets(vectors)
    paths = write_cbv_targets(os.path.join(tmp, "cbv_lc"), arrays)
    write_s = time.perf_counter() - t0
    start_sweep()
    t0 = time.perf_counter()
    raws, corrected = [], []
    for p in paths:
        lc, corrector, out = cbv_correct(p, cbv_dir)
        raws.append(lc)
        corrected.append(on_file_cadences(lc, out))
        if len(raws) == 1:
            n_sets = len(corrector.cbvs)
            n_cols = len(corrector.design_matrix_collection.columns)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _, per_target = sync_timed(lambda: [cbv_correct(p, cbv_dir)
                                        for p in paths[:CBV_TIMED]])
    per_target /= CBV_TIMED
    if not all(np.isfinite(c.flux.value).sum() > 0.9 * len(c)
               for c in corrected):
        raise AssertionError("cbv: corrected flux mostly non-finite")
    log(f"cbv: wrote the CCD's CBV file ({CBV_SINGLE} single-scale, 3 x "
        f"{CBV_BAND} band, {CBV_SPIKE} spike vectors x {cbv_grid()[1].size} "
        f"cadences) and {CBV_B} target files in {write_s:.3f}s; read -> "
        f"to_corrector('cbv') -> correct_gaussian_prior ({n_cols} "
        f"columns) of all {CBV_B} in {first_s:.3f}s, "
        f"{per_target * 1e3:.1f} ms a target on a second pass over "
        f"{CBV_TIMED} ({1 / per_target:.6g} targets/s); "
        f"{n_sets} CBV sets loaded a target [{card}]")
    opt = []
    for i in range(CBV_OPTIMISED):
        others = [raws[j] for j in range(CBV_B) if j != i][:CBV_NEIGHBOURS]
        lc, corrector, _ = cbv_correct(paths[i], cbv_dir)
        nb = cbv_neighbour_flux(corrector, others)
        t0 = time.perf_counter()
        corrector.correct(cbv_type=CBV_CORRECT["cbv_type"],
                          cbv_indices=CBV_CORRECT["cbv_indices"],
                          neighbor_flux=nb, verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        opt.append(secs)
        log(f"cbv: correct() of target {i}: alpha {corrector.alpha:.6g}, "
            f"over-fitting {corrector.over_fitting_score:.4f}, "
            f"under-fitting {corrector.under_fitting_score:.4f} (targets "
            f"0.5), {secs:.3f}s [{card}]")
        if not (0 <= corrector.over_fitting_score <= 1
                and 0 <= corrector.under_fitting_score <= 1):
            raise AssertionError("cbv: correct() scores out of [0, 1]")
    en = []
    for i in range(CBV_ELASTICNET):
        _, corrector, _ = cbv_correct(paths[i], cbv_dir)
        t0 = time.perf_counter()
        out = corrector.correct_elasticnet(
            cbv_type=CBV_CORRECT["cbv_type"],
            cbv_indices=CBV_CORRECT["cbv_indices"], alpha=1e-4)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        en.append((secs, corrector.fista_iterations))
        if not np.isfinite(out.flux.value).all():
            raise AssertionError("cbv: correct_elasticnet not finite")
    log("cbv: correct_elasticnet (alpha 1e-4, l1_ratio 0.01): " + ", ".join(
        f"{s:.3f}s {it} FISTA iterations" for s, it in en) + f" [{card}]")
    worst = 0.0
    for i in range(CBV_INTERPOLATED):
        _, _, aligned = cbv_correct(paths[i], cbv_dir)
        _, _, interp = cbv_correct(paths[i], cbv_dir, interpolate_cbvs=True)
        gap = np.max(np.abs(interp.flux.value - aligned.flux.value)) / \
            np.median(aligned.flux.value)
        worst = max(worst, float(gap))
    log(f"cbv: interpolated (PCHIP at the CBVs' own nodes) against aligned "
        f"CBVs on {CBV_INTERPOLATED} targets: {worst:.3g} of the median "
        f"flux (bar {CBV_RTOL:g})")
    if worst > CBV_RTOL:
        raise AssertionError("cbv: interpolated CBVs differ from aligned")
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = "cpu", torch.float64
    try:
        f64 = [cbv_correct(p, cbv_dir)[2] for p in paths[:CBV_F64]]
    finally:
        config.default_device, config.default_dtype = prev
    f64_gap = max(
        float(np.max(np.abs(on_file_cadences(raws[i], w).flux.value
                            - corrected[i].flux.value)[
            np.isfinite(corrected[i].flux.value)]))
        for i, w in enumerate(f64))
    log(f"cbv: {CBV_F64} targets, the card (float32 configuration) against "
        f"the CPU's float64: corrected flux within {f64_gap:.3g} of the "
        f"median flux (bar {CBV_RTOL:g}) [{card}]")
    if f64_gap > CBV_RTOL:
        raise AssertionError("cbv: the card's correction differs from the "
                             "CPU's float64")
    return dict(corrected=corrected, raw=[r.normalize() for r in raws],
                truth=truth, per_target_s=per_target, first_s=first_s,
                correct_s=opt, elasticnet=en, interp_gap=worst,
                f64_gap=f64_gap)


def cbv_search(lcs, truth, card, tag):
    """``LightCurveCollection(lcs).to_stack()`` on the card (one time grid),
    ``flatten`` and ``bls_search`` over 1-9 d in four calls; the recovery
    of all and of the transits of expected SNR >= :data:`PIX_SNR`."""
    import torch
    from lightkurve_tpu_torch.collections import LightCurveCollection
    stack = LightCurveCollection(lcs).to_stack()
    if torch.unique(stack.time, dim=0).shape[0] != 1:
        raise AssertionError(f"cbv, {tag}: the stack has several time grids")
    flat, best, secs = pixel_search(stack)
    share = recovery(best["period"], truth["p_inj"])
    bright = truth["snr"] >= PIX_SNR
    share_bright = recovery(best["period"][bright], truth["p_inj"][bright])
    log(f"cbv, {tag}: to_stack -> flatten -> bls_search B={len(lcs)} "
        f"P={LONG_GRID[2]} in 4 calls: {secs:.3f}s "
        f"({len(lcs) * LONG_GRID[2] / secs:.6g} curve-period evals/s); "
        f"recovered {share:.4f} of all, {share_bright:.4f} of the "
        f"{int(bright.sum())} of expected SNR >= {PIX_SNR:g}; "
        f"{recovery_bands(best, truth)} [{card}]")
    return dict(flat=flat, seconds=secs, recovered=share,
                recovered_bright=share_bright,
                routes=expected_launches(flat, np.linspace(*LONG_GRID), 1024,
                                         launch_periods=16))


def check_weighted_kernels(label, flat, pvals):
    """K-WF against its plain version on the inputs the entry point gives
    it at call 4 of a weighted search of ``flat`` (:func:`entry_scan_args`,
    its longest :data:`PIX_KERNEL_PERIODS` periods ``pvals``), at the
    float32 bars (:func:`compare`): phase 14 (a)'s corrected search and
    phase 15 (b)'s.  Then K-SF on the same float32 columns (the staged
    route's fold, which the route rule does not take there) against the
    float64 fold (:func:`fold_against_f64`).  Returns each kernel's max
    |error|."""
    import torch
    from lightkurve_tpu_torch.ops import bls_fused_weighted as bfw
    args, kw = entry_scan_args(flat, pvals)
    ts, W, WY, pc, k_durs, dvals, d_phase, nbins, max_nbp, lik = args
    log(f"{label}, call 4 kernels: B={W.shape[1]} N={W.shape[0]} "
        f"P={pc.shape[0]} (periods {float(pc[0]):.4f}-{float(pc[-1]):.4f} "
        f"d, {max_nbp} bins, fold sized for {nbins}) {W.dtype}")
    got, want = bfw.fused_scan_weighted(*args, **kw), \
        bfw.fused_scan_weighted_plain(*args, **kw)
    errs = {"K-WF": compare(f"K-WF {label} call 4", got, want, False)[0]}
    del got, want
    errs["K-SF"], _ = fold_against_f64(
        f"K-SF {label} call 4", ts, torch.cat([W, WY], dim=1), pc, d_phase,
        nbins, max_nbp, max(k_durs), kw["wrap"], kw["chunk"])
    torch.cuda.empty_cache()
    return errs


def phase_cbv_search(cbv, card):
    """Phase 14 (a), the search of the CBV-corrected curves: recovery of
    :data:`PIX_RECOVERY_SHARE` of the transits of expected SNR >=
    :data:`PIX_SNR`."""
    out = cbv_search(cbv["corrected"], cbv["truth"], card, "corrected")
    if out["recovered_bright"] < PIX_RECOVERY_SHARE:
        raise AssertionError(f"cbv: recovery {out['recovered_bright']} of "
                             f"the detectable transits < "
                             f"{PIX_RECOVERY_SHARE}")
    return out


def phase_cbv_raw(cbv, corrected, card):
    """Phase 14 (a), the same search of the uncorrected SAP flux, whose
    recovery the corrected search must not fall below."""
    out = cbv_search(cbv["raw"], cbv["truth"], card, "uncorrected SAP")
    if corrected["recovered"] < out["recovered"] or \
            corrected["recovered_bright"] < out["recovered_bright"]:
        raise AssertionError("cbv: the corrected search recovers fewer "
                             "transits than the uncorrected one")
    return out


# ---------------------------------------------------------------------------
# phase 14 (b): asteroseismology of Kepler stars on the card
# ---------------------------------------------------------------------------
#: 32 red giants (KEPSEISMIC files, the whole mission in long cadence) and
#: 4 solar-like stars (one quarter of short cadence), made from these seeds
SEIS_GIANTS = 32
SEIS_DWARFS = 4
SEIS_SEED = 2034
#: cadences: Kepler's long (29.4244 min) and short (58.85 s) cadence
SEIS_LC_MIN = 29.4244
SEIS_SC_S = 58.85
#: the mission (1,470 d, a gap of 6-11 d at each quarter's end, 1% of
#: cadences lost at random: ~65,000 cadences) and one quarter (90 d, two
#: 1-d monthly downlinks: ~130,000)
SEIS_MISSION_DAYS = 1470.0
SEIS_QUARTER_DAYS = 91.875
SEIS_QUARTER_GAP_DAYS = (6.0, 11.0)
SEIS_SC_DAYS = 90.0
#: numax (uHz, log-uniform) of the giants and of the solar-like stars
SEIS_GIANT_NUMAX = (30.0, 220.0)
SEIS_DWARF_NUMAX = (1500.0, 3500.0)
#: Delta-nu within this share of 0.294 numax^0.772 (Stello et al. 2009),
#: the relation estimate_deltanu_acf2d centres its +-25% window on
SEIS_DNU_SPREAD = 0.10
#: the expected SNR of a radial mode at numax over the background
SEIS_SNR = (5.0, 20.0)
#: recovery: numax within 5%, Delta-nu within 2% of the injected values
SEIS_NUMAX_RTOL = 0.05
SEIS_DNU_RTOL = 0.02
#: the share lightkurve_tpu reaches on these stars on the CPU in float64
#: (tools/seismology_reference_rate.py): the bar of the port's share
SEIS_REFERENCE_SHARE = 15 / 36
#: stars held in float32 on the card against float64 on the CPU; where
#: their numax falls on different grid points, the float64 smoothed metric
#: at the two may differ by at most this share of its largest value (the
#: float32 spectrum's rounding, a sum over 65,000-130,000 cadences, then
#: the ACF's over ~3,000 lags)
SEIS_F64_GIANTS = 2
SEIS_F64_DWARFS = 1
SEIS_F32_METRIC_TOL = 1e-3


def seismic_star(seed, dwarf=False, days=None, granulation=1.0):
    """One synthetic solar-like oscillator as host arrays (time in days
    from the first cadence, relative flux, its error) and its truth.

    The time series is drawn in the frequency domain on a regular grid
    (one inverse real FFT): a white-noise floor, one Harvey granulation
    profile of knee 0.3 numax, and l = 0, 1, 2 modes (visibilities 1, 1.5,
    0.6; the asymptotic relation with epsilon = 0.6 + 0.5 log10 dnu, d01 =
    0.025 dnu, d02 = 0.12 dnu) as Lorentzians of width ``gamma`` under a
    Gaussian envelope of FWHM 0.66 numax^0.88 (giants; Mosser et al.
    2010) or 0.25 numax (solar-like stars, the estimator's own rule),
    each frequency bin a complex Gaussian of the model's power (the
    chi-squared scatter of stochastic excitation).  Then the gaps are
    cut: quarterly ones and 1% random losses (giants), two downlinks
    (solar-like stars).  ``days`` shortens the series; ``granulation``
    scales the granulation's power (0: white noise alone)."""
    rng = np.random.default_rng(seed)
    if dwarf:
        dt = SEIS_SC_S / 86400.0
        days = days or SEIS_SC_DAYS
        numax = np.exp(rng.uniform(*np.log(SEIS_DWARF_NUMAX)))
        fwhm = 0.25 * numax
        gamma = rng.uniform(1.0, 2.0)
        white_ppm = rng.uniform(60.0, 120.0)
    else:
        dt = SEIS_LC_MIN / 1440.0
        days = days or SEIS_MISSION_DAYS
        numax = np.exp(rng.uniform(*np.log(SEIS_GIANT_NUMAX)))
        fwhm = 0.66 * numax ** 0.88
        gamma = rng.uniform(0.08, 0.2)
        white_ppm = rng.uniform(30.0, 80.0)
    n = int(days / dt)
    dnu = 0.294 * numax ** 0.772 * rng.uniform(1 - SEIS_DNU_SPREAD,
                                               1 + SEIS_DNU_SPREAD)
    nu = np.arange(n // 2 + 1) / (n * dt * 86400.0) * 1e6       # uHz
    nyq = nu[-1]
    white = white_ppm ** 2 / nyq                     # ppm^2 / uHz
    knee = 0.3 * numax
    gran = granulation * rng.uniform(1.0, 3.0) * white * (
        1 + (1 / 0.3) ** 4)
    bkg = gran / (1 + (nu / knee) ** 4) + white
    snr = rng.uniform(*SEIS_SNR)
    height = (snr - 1) * (gran / (1 + (numax / knee) ** 4) + white)
    eps = np.clip(0.6 + 0.5 * np.log10(dnu), 0.5, 1.5)
    sig = fwhm / (2 * np.sqrt(2 * np.log(2)))
    power = bkg.copy()
    df = nu[1]
    half = int(50 * gamma / df) + 1
    for order in range(int((numax - 4 * sig) / dnu) - 1,
                       int((numax + 4 * sig) / dnu) + 2):
        for f, vis in ((dnu * (order + eps), 1.0),
                       (dnu * (order + 0.5 + eps) - 0.025 * dnu, 1.5),
                       (dnu * (order + eps) - 0.12 * dnu, 0.6)):
            if not 0 < f < nyq:
                continue
            h = height * vis * np.exp(-0.5 * ((f - numax) / sig) ** 2)
            k = int(f / df)
            sl = slice(max(k - half, 1), min(k + half, nu.size))
            power[sl] += h / (1 + 4 * ((nu[sl] - f) / gamma) ** 2)
    amp = n * np.sqrt(power * df / 4)
    spec = amp * (rng.standard_normal(nu.size)
                  + 1j * rng.standard_normal(nu.size))
    spec[0] = 0.0
    x = np.fft.irfft(spec, n)                        # ppm
    t = np.arange(n) * dt
    keep = np.ones(n, bool)
    if dwarf:
        for start in (30.0, 60.0):
            keep &= ~((t >= start) & (t < start + 1.0))
    else:
        for q in np.arange(SEIS_QUARTER_DAYS, days, SEIS_QUARTER_DAYS):
            keep &= ~((t >= q) & (t < q + rng.uniform(
                *SEIS_QUARTER_GAP_DAYS)))
        keep &= rng.random(n) >= 0.01
    truth = dict(numax=numax, deltanu=dnu, snr=snr, gamma=gamma,
                 teff=rng.uniform(5500, 6200) if dwarf
                 else rng.uniform(4500, 5100))
    return (t[keep], 1.0 + 1e-6 * x[keep],
            np.full(int(keep.sum()), white_ppm * 1e-6), truth)


def write_seismic_stars(directory, giants=SEIS_GIANTS, dwarfs=SEIS_DWARFS):
    """The giants as KEPSEISMIC files (ORIGIN "CEA & SSI", times in MJD,
    relative FLUX and FLUX_ERR) and the solar-like stars as Kepler
    short-cadence light-curve files (BKJD, SAP and PDCSAP flux in e-/s),
    written with the port's FITS writer.  Returns the paths and truths."""
    from lightkurve_tpu_torch.io.fits import (BinTableHDU, HDUList, Header,
                                              PrimaryHDU, write_fits)
    os.makedirs(directory, exist_ok=True)
    paths, truths = [], []
    for i in range(giants + dwarfs):
        dwarf = i >= giants
        t, f, fe, truth = seismic_star(SEIS_SEED + i, dwarf)
        kic = 1_000_000 + i
        if dwarf:
            f0 = 1e6
            path = os.path.join(directory, f"kplr{kic:09d}-2010_slc.fits")
            h0 = {"TELESCOP": "Kepler", "MISSION": "Kepler",
                  "CREATOR": "FluxExporter2PipelineModule",
                  "ORIGIN": "NASA/Ames", "OBJECT": f"KIC {kic}",
                  "KEPLERID": kic, "QUARTER": 5, "OBSMODE": "short cadence"}
            cols = {"TIME": 350.0 + t,
                    "CADENCENO": np.arange(t.size, dtype=np.int32),
                    "SAP_FLUX": (f0 * f).astype(np.float32),
                    "SAP_FLUX_ERR": (f0 * fe).astype(np.float32),
                    "PDCSAP_FLUX": (f0 * f).astype(np.float32),
                    "PDCSAP_FLUX_ERR": (f0 * fe).astype(np.float32),
                    "SAP_QUALITY": np.zeros(t.size, np.int32)}
            th = {"EXTNAME": "LIGHTCURVE", "BJDREFI": 2454833,
                  "BJDREFF": 0.0, "TIMESYS": "TDB", "TUNIT3": "e-/s",
                  "TUNIT4": "e-/s", "TUNIT5": "e-/s", "TUNIT6": "e-/s"}
        else:
            path = os.path.join(
                directory, f"hlsp_kepseismic_kepler_phot_kplr{kic:09d}-"
                "20d_kepler_v1_cor-filt-inp.fits")
            h0 = {"TELESCOP": "Kepler", "ORIGIN": "CEA & SSI",
                  "OBJECT": f"KIC {kic}", "KEPLERID": kic}
            cols = {"TIME": 54964.5 + t, "FLUX": f, "FLUX_ERR": fe}
            th = {"EXTNAME": "LIGHTCURVE", "MJDREF": 0.0}
        write_fits(HDUList([PrimaryHDU(header=Header(h0)),
                            BinTableHDU(data=cols, header=Header(th))]),
                   path, overwrite=True)
        paths.append(path)
        truths.append(truth)
    return paths, truths


def seismology_chain(lc, teff):
    """One star through the port's public chain: ``normalize``, the PSD
    periodogram to Nyquist, ``flatten``, ``to_seismology``, numax, Delta-nu
    and the three scaling relations at ``teff``.  Returns the results."""
    pg = lc.normalize().to_periodogram(normalization="psd")
    snr = pg.flatten()
    seis = snr.to_seismology()
    numax = seis.estimate_numax()
    deltanu = seis.estimate_deltanu()
    return dict(pg=snr, seis=seis, numax=float(numax.value),
                deltanu=float(deltanu.value),
                radius=float(seis.estimate_radius(teff=teff).value),
                mass=float(seis.estimate_mass(teff=teff).value),
                logg=float(seis.estimate_logg(teff=teff).value))


def seismology_recovered(outs, truths):
    """Per star: numax within :data:`SEIS_NUMAX_RTOL` and Delta-nu within
    :data:`SEIS_DNU_RTOL` of the injected values."""
    return np.array([abs(o["numax"] / t["numax"] - 1) < SEIS_NUMAX_RTOL
                     and abs(o["deltanu"] / t["deltanu"] - 1) < SEIS_DNU_RTOL
                     for o, t in zip(outs, truths)])


def phase_seismology(tmp, card):
    """Phase 14 (b), no kernel may launch: the stars of
    :func:`write_seismic_stars` through :func:`seismology_chain` on the
    card in float32 (each timed on a second call: ``read``, the
    periodogram, its ``flatten`` and the estimators); the share recovered
    (:func:`seismology_recovered`) at least lightkurve_tpu's on the CPU
    (:data:`SEIS_REFERENCE_SHARE`); :data:`SEIS_F64_GIANTS` giants and
    :data:`SEIS_F64_DWARFS` solar-like stars against float64 on the CPU
    (numax on the same grid point, or else the smoothed metric's gap
    between the two points within :data:`SEIS_F32_METRIC_TOL`; Delta-nu
    within one lag bin).  Returns the numbers."""
    import torch
    from lightkurve_tpu_torch import config
    from lightkurve_tpu_torch.io.read import read
    paths, truths = write_seismic_stars(os.path.join(tmp, "seis"))
    outs, times = [], {"read": [], "chain": []}
    start_sweep()
    for path, truth in zip(paths, truths):
        read(path)
        lc, read_s = sync_timed(lambda: read(path))
        seismology_chain(lc, truth["teff"])
        out, chain_s = sync_timed(lambda: seismology_chain(lc,
                                                           truth["teff"]))
        outs.append(out)
        times["read"].append(read_s)
        times["chain"].append(chain_s)
        if not all(np.isfinite(out[k]) for k in ("numax", "deltanu",
                                                  "radius", "mass", "logg")):
            raise AssertionError(f"seismology: non-finite result, {path}")
    ok = seismology_recovered(outs, truths)
    g = SEIS_GIANTS
    med = {k: (float(np.median(v[:g])), float(np.median(v[g:])))
           for k, v in times.items()}
    total = sum(times["read"]) + sum(times["chain"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    nf = [len(o["pg"].frequency) for o in outs]
    log(f"seismology: {g} KEPSEISMIC giants ({int(np.median(nf[:g]))} "
        f"frequencies to Nyquist) and {SEIS_DWARFS} short-cadence stars "
        f"({int(np.median(nf[g:]))}): "
        f"recovered {ok.mean():.4f} (giants {ok[:g].mean():.4f}, "
        f"solar-like {ok[g:].mean():.4f}; numax within "
        f"{SEIS_NUMAX_RTOL:g}, Delta-nu within {SEIS_DNU_RTOL:g}; bar "
        f"{SEIS_REFERENCE_SHARE:.4f}, lightkurve_tpu on the CPU in "
        f"float64); per star (medians, second call) read "
        f"{med['read'][0] * 1e3:.1f} / {med['read'][1] * 1e3:.1f} ms, chain "
        f"{med['chain'][0] * 1e3:.1f} / {med['chain'][1] * 1e3:.1f} ms "
        f"(giant / solar-like); {len(outs) / total:.6g} stars/s; "
        f"{peak:.3f} GiB peak device memory [{card}]")
    numax_err = [o["numax"] / t["numax"] - 1 for o, t in zip(outs, truths)]
    log("  numax error per star: " + " ".join(f"{e:+.3f}" for e in numax_err))
    if ok.mean() < SEIS_REFERENCE_SHARE:
        raise AssertionError(f"seismology: recovered {ok.mean()} < the "
                             f"reference's {SEIS_REFERENCE_SHARE}")
    picks = list(range(SEIS_F64_GIANTS)) + list(range(g, g + SEIS_F64_DWARFS))
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = "cpu", torch.float64
    try:
        f64 = [seismology_chain(read(paths[i]), truths[i]["teff"])
               for i in picks]
    finally:
        config.default_device, config.default_dtype = prev
    worst = dict(metric=0.0, gap=0.0, deltanu_bins=0.0, power=0.0)
    for i, want in zip(picks, f64):
        got = outs[i]
        d32 = got["seis"].numax.diagnostics
        d64 = want["seis"].numax.diagnostics
        m32, m64 = d32["metric_smooth"], d64["metric_smooth"]
        a32, a64 = int(np.argmax(m32)), int(np.argmax(m64))
        scale = np.abs(m64).max()
        gap = abs(m64[a64] - m64[a32]) / scale
        metric_err = np.abs(m32 - m64).max() / scale
        fs = np.median(np.diff(got["pg"].frequency.value))
        dnu_bins = abs(got["deltanu"] - want["deltanu"]) / fs
        p32, p64 = got["pg"].power.value, want["pg"].power.value
        power_err = float(np.max(np.abs(p32 - p64)) / np.max(p64))
        worst["metric"] = max(worst["metric"], float(metric_err))
        worst["gap"] = max(worst["gap"], float(gap))
        worst["deltanu_bins"] = max(worst["deltanu_bins"], float(dnu_bins))
        worst["power"] = max(worst["power"], power_err)
        log(f"  star {i}: float32 card numax {got['numax']:.4f}, float64 "
            f"CPU {want['numax']:.4f} (metric within {metric_err:.3g} of its "
            f"largest value; the two argmaxes {gap:.3g} apart); Delta-nu "
            f"{got['deltanu']:.6f} against {want['deltanu']:.6f} "
            f"({dnu_bins:.3g} lag bins); SNR spectrum within {power_err:.3g} "
            f"of its peak")
        if gap > SEIS_F32_METRIC_TOL or dnu_bins > 1:
            raise AssertionError(f"seismology: star {i}'s float32 numax or "
                                 "Delta-nu differs from float64 past the "
                                 "bar")
    return dict(recovered=float(ok.mean()), giants=float(ok[:g].mean()),
                dwarfs=float(ok[g:].mean()), stars_per_s=len(outs) / total,
                med=med, f64=worst)


def phase_cbv_seismology(tmp, card, sweep, runs):
    """Phase 14, each part a path of its own: (a) the per-target CBV
    corrections (no kernel may launch), the search of the corrected
    curves and of the uncorrected SAP flux (their launches as the route
    rule gives them, through ``sweep``), K-WF against its plain version
    and K-SF against the float64 fold on the corrected search's call 4;
    (b) the seismology
    of the Kepler stars (no kernel may launch).  Adds the paths' launches
    to ``runs``; returns the numbers and the kernels' errors."""
    import torch
    t0 = time.time()
    cbv, runs["CBV, per target (phase 14)"] = drive(
        "CBV, per target (phase 14)", phase_cbv_targets, tmp, card,
        forbid=tuple(kernel_table()))
    found = sweep("CBV -> search (phase 14)", phase_cbv_search, cbv, card)
    raw = sweep("CBV, uncorrected -> search (phase 14)", phase_cbv_raw, cbv,
                found, card)
    call4 = np.linspace(*LONG_GRID)[3072:]
    errs = check_weighted_kernels("cbv", found.pop("flat"),
                                  call4[-PIX_KERNEL_PERIODS:])
    raw.pop("flat")
    numbers = dict(per_target_s=cbv["per_target_s"],
                   correct_s=cbv["correct_s"], elasticnet=cbv["elasticnet"],
                   search_s=found["seconds"],
                   recovered=found["recovered"],
                   recovered_bright=found["recovered_bright"],
                   raw_recovered=raw["recovered"],
                   raw_recovered_bright=raw["recovered_bright"])
    del cbv, found, raw
    torch.cuda.empty_cache()
    seis, runs["seismology (phase 14)"] = drive(
        "seismology (phase 14)", phase_seismology, tmp, card,
        forbid=tuple(kernel_table()))
    numbers["seismology"] = seis
    torch.cuda.empty_cache()
    log(f"phase 14: {time.time() - t0:.1f}s")
    return numbers, errs


# ---------------------------------------------------------------------------
# phase 15: PRF photometry on the card, then the search
# ---------------------------------------------------------------------------
#: bench.py's two-star 9 x 9 GaussianPRF scene (its ``_c_prf`` cell) at one
#: TESS sector of two-minute images, 20 LM iterations, noise of 2 e/s
PRF_TRUTH = np.array([2.83, 3.12, 5000.0, 6.17, 5.88, 3000.0, 40.0])
PRF_NOISE = 2.0
PRF_ITERS = 20
PRF_SEED = 2036
#: the scene's bars (bench.py's prf_two_star_flux_ok and the reference's
#: two-star test): each star's median flux, its position and the background
PRF_FLUX_RTOL = 0.05
PRF_POS_ATOL = 0.05
PRF_BKG_RTOL = 0.2
#: cadences of the card's fit (float64, ROADMAP C4) held against the same
#: fit on the CPU on the same float32 images, and the bar: the scene's
#: fitted parameters relative to themselves, the files' PRF flux relative
#: to its median
PRF_F64_CADENCES = 2048
PRF_F64_RTOL = 1e-12
#: the calibration-file PRF against the Gaussian it was made from
PRF_KEPLER_RTOL = 1e-4
PRF_SIGMA_KEPLER = 1.5 / 2.3548


def prf_scene_model():
    """The bench's two-star scene model (the port's classes)."""
    from lightkurve_tpu_torch.prf import (BackgroundPrior, GaussianPRF,
                                          GaussianPrior, StarPrior, TPFModel,
                                          UniformPrior)
    prf = GaussianPRF(shape=(9, 9), column=0, row=0)
    stars = [StarPrior(col=GaussianPrior(2.8, 0.5),
                       row=GaussianPrior(3.1, 0.5),
                       flux=UniformPrior(0.0, 2e4)),
             StarPrior(col=GaussianPrior(6.2, 0.5),
                       row=GaussianPrior(5.9, 0.5),
                       flux=UniformPrior(0.0, 2e4))]
    return TPFModel(star_priors=stars, prfmodel=prf,
                    background_prior=BackgroundPrior(
                        flux=UniformPrior(0.0, 100.0)))


def prf_scene(card, n=LONG_N):
    """Phase 15 (a): the scene's images at ``n`` cadences (made in float64
    on the host, the truth plus Gaussian noise) as a float32 cube on the
    card, fitted there by ``PRFPhotometry.run`` (20 iterations, in float64
    as ROADMAP C4 has it; the second run timed by
    ``diagnostics.KernelTimer``); the medians against the truth; the first
    :data:`PRF_F64_CADENCES` against the same fit on the CPU on the same
    float32 images.  Returns the numbers."""
    import torch
    from lightkurve_tpu_torch import diagnostics
    from lightkurve_tpu_torch.prf import PRFPhotometry
    model = prf_scene_model()
    img = model.predict_from_array(torch.as_tensor(PRF_TRUTH)).numpy()
    rng = np.random.default_rng(PRF_SEED)
    cube = torch.as_tensor(img[None] + PRF_NOISE * rng.standard_normal(
        (n,) + img.shape), device="cuda").float()
    phot = PRFPhotometry(model)
    phot.run(cube, n_iter=PRF_ITERS)
    with diagnostics.KernelTimer("prf scene, second run"):
        fitted = phot.run(cube, n_iter=PRF_ITERS)
    secs = diagnostics.report()["prf scene, second run"]["max_s"]
    med = np.median(fitted.astype(float), axis=0)
    t = PRF_TRUTH
    flux = [abs(med[i] - t[i]) / t[i] for i in (2, 5)]
    pos = [abs(med[i] - t[i]) for i in (0, 1, 3, 4)]
    bkg = abs(med[6] - t[6]) / t[6]
    cpu = PRFPhotometry(model).run(cube[:PRF_F64_CADENCES].cpu().double(),
                                   n_iter=PRF_ITERS)
    gap = float(np.max(np.abs(fitted[:PRF_F64_CADENCES] - cpu)
                       / np.abs(cpu)))
    log(f"PRF scene: {n} cadences x 9x9, 2 stars + background, "
        f"{PRF_ITERS} iterations, float32 images: second run "
        f"{secs * 1e3:.3f} ms "
        f"({n / secs:.6g} cadence-fits/s); median fluxes off the truth by "
        f"{flux[0]:.3g}, {flux[1]:.3g} (bar {PRF_FLUX_RTOL:g}), positions by "
        f"{max(pos):.3g} px (bar {PRF_POS_ATOL:g}), background by {bkg:.3g} "
        f"(bar {PRF_BKG_RTOL:g}); {PRF_F64_CADENCES} cadences, the card's "
        f"float64 fit against the CPU's: {gap:.3g} relative at most (bar "
        f"{PRF_F64_RTOL:g}); "
        f"losses finite {bool(np.isfinite(phot.losses).all())} [{card}]")
    if max(flux) > PRF_FLUX_RTOL or max(pos) > PRF_POS_ATOL or \
            bkg > PRF_BKG_RTOL:
        raise AssertionError("PRF scene: the fit missed the truth")
    if gap > PRF_F64_RTOL or not np.isfinite(phot.losses).all():
        raise AssertionError("PRF scene: the card's fit differs from the "
                             "CPU's past the bar, or a loss is not finite")
    return dict(seconds=secs, rate=n / secs, flux=max(flux), pos=max(pos),
                bkg=bkg, f64_gap=gap)


def prf_lightcurve(tpf):
    """``extract_prf_photometry()`` of a TESS TPF as a light curve on its
    time axis, the flux of cadences whose image is all NaN set to NaN (the
    reference fits those as zero images)."""
    from lightkurve_tpu_torch.lightcurve import TessLightCurve
    lc = tpf.extract_prf_photometry().to_lightcurve(time=tpf.time.value)
    empty = np.isnan(tpf.flux.value).all(axis=(1, 2))
    return TessLightCurve(time=lc.time.value,
                          flux=np.where(empty, np.nan, lc.flux.value),
                          meta=dict(tpf.meta))


def prf_files(tmp, card):
    """Phase 15 (b): phase 13 (b)'s TESS files written by ``to_fits``, each
    through ``read`` and :func:`prf_lightcurve` (a second pass timed per
    file by ``diagnostics.KernelTimer``); ``to_lightcurve(method="prf")``'s
    time axis ``arange(n)``; the first :data:`PRF_F64_CADENCES` cadences of
    :data:`PIX_F64_FILES` files against the same fit on the CPU.  No BLS
    kernel may launch here.  Returns the light curves, the injected
    periods and the numbers."""
    import torch
    from lightkurve_tpu_torch import config, diagnostics
    from lightkurve_tpu_torch.io.read import read
    paths, p_inj, _ = write_tess_tpfs(os.path.join(tmp, "prf_tess"))
    tpfs = [read(p) for p in paths]
    lcs = [prf_lightcurve(tpf) for tpf in tpfs]
    per_file = []
    for i, tpf in enumerate(tpfs):
        name = f"prf file {i}"
        with diagnostics.KernelTimer(name):
            lcs[i] = prf_lightcurve(tpf)
        per_file.append(diagnostics.report()[name]["max_s"])
    for i, lc in enumerate(lcs):
        ok = np.isfinite(lc.flux.value)
        if ok.sum() < 0.9 * LONG_N or np.median(lc.flux.value[ok]) <= 0:
            raise AssertionError(f"PRF file {i}: flux mostly non-finite or "
                                 "not positive")
    arange = tpfs[0].to_lightcurve(method="prf")
    if not np.array_equal(arange.time.value,
                          np.arange(len(tpfs[0].time), dtype=float)):
        raise AssertionError("PRF: to_lightcurve(method='prf')'s time axis "
                             "is not arange(n)")
    cads = np.arange(PRF_F64_CADENCES)
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = "cpu", torch.float64
    try:
        f64 = [tpf.extract_prf_photometry(cadences=cads).opt_params[:, 2]
               for tpf in tpfs[:PIX_F64_FILES]]
    finally:
        config.default_device, config.default_dtype = prev
    gap = 0.0
    for tpf, lc, want in zip(tpfs, lcs, f64):
        empty = np.isnan(tpf.flux.value[cads]).all(axis=(1, 2))
        got = lc.flux.value[cads]
        gap = max(gap, float(np.max(np.abs(got - want)[~empty])
                             / np.median(want[~empty])))
    med_ms = float(np.median(per_file)) * 1e3
    log(f"PRF files: {len(paths)} TESS TPFs ({LONG_N} x {PIX_SHAPE[0]}x"
        f"{PIX_SHAPE[1]}) through read -> extract_prf_photometry (GaussianPRF, "
        f"one star and the background) -> to_lightcurve: second pass "
        f"{med_ms:.3f} ms a file (median; {min(per_file) * 1e3:.3f}-"
        f"{max(per_file) * 1e3:.3f}); to_lightcurve(method='prf') on "
        f"arange(n); {PIX_F64_FILES} files' first {PRF_F64_CADENCES} cadences, "
        f"the card's float64 fit against the CPU's: {gap:.3g} of the median "
        f"flux (bar "
        f"{PRF_F64_RTOL:g}) [{card}]")
    if gap > PRF_F64_RTOL:
        raise AssertionError("PRF files: the card's fit differs from the "
                             "CPU's past the bar")
    return dict(lcs=lcs, p_inj=p_inj, per_file_ms=med_ms, f64_gap=gap)


def prf_search(files, card):
    """Phase 15 (b), the search: ``LightCurveCollection(lcs).to_stack()``
    on the card, ``flatten`` and ``bls_search`` over 1-9 d in four calls
    (:func:`pixel_search`); the injected period within 1% on every file.
    Returns the numbers and the flattened stack."""
    from lightkurve_tpu_torch.collections import LightCurveCollection
    stack = LightCurveCollection(files["lcs"]).to_stack()
    flat, best, secs = pixel_search(stack)
    share = recovery(best["period"], files["p_inj"])
    log(f"PRF -> search: to_stack -> flatten -> bls_search B={len(stack)} "
        f"P={LONG_GRID[2]} in 4 calls: {secs:.3f}s; recovered {share:.4f} "
        f"(periods {np.round(best['period'], 4).tolist()}, injected "
        f"{np.round(files['p_inj'], 4).tolist()}) [{card}]")
    if share < 1.0:
        raise AssertionError("PRF -> search: an injected period was missed")
    return dict(flat=flat, seconds=secs, recovered=share,
                routes=expected_launches(flat, np.linspace(*LONG_GRID), 1024,
                                         launch_periods=16))


def write_kepler_prf(directory, channel):
    """A ``kplrMM.O_*_prf.fits`` calibration file of ``channel`` whose five
    images (four corners and the centre) are the supersampled Gaussian of
    ``GaussianPRF(sigma=1.5/2.3548, oversample=50)``, written by the port's
    FITS writer."""
    from lightkurve_tpu_torch.io.fits import (HDUList, Header, ImageHDU,
                                              PrimaryHDU)
    from lightkurve_tpu_torch.prf import GaussianPRF
    from lightkurve_tpu_torch.utils import channel_to_module_output
    img = GaussianPRF((1, 1), sigma=PRF_SIGMA_KEPLER, oversample=50
                      ).supersampled_prf.astype(">f4")
    hdus = [PrimaryHDU(header=Header({"SIMPLE": True}))]
    for crval1, crval2 in ((12, 20), (12, 1044), (1111, 20), (1111, 1044),
                           (550, 532)):
        hdus.append(ImageHDU(data=img, header=Header(
            {"CRVAL1P": crval1, "CRVAL2P": crval2})))
    module, output = channel_to_module_output(channel)
    os.makedirs(directory, exist_ok=True)
    HDUList(hdus).writeto(os.path.join(
        directory, f"kplr{module:02}.{output}_2011265_prf.fits"),
        overwrite=True)


def prf_kepler(tmp, card):
    """Phase 15 (c): phase 13 (b)'s K2 files through ``prf_lightcurve()``
    (``SimpleKeplerPRF`` of the CHANNEL keyword; a second pass timed), then
    one file's fit with the ``KeplerPRF`` of a calibration file
    (:func:`write_kepler_prf`) against the same fit with the Gaussian it
    was made from.  No BLS kernel may launch here."""
    from lightkurve_tpu_torch import diagnostics
    from lightkurve_tpu_torch.io.read import read
    from lightkurve_tpu_torch.prf import GaussianPRF, SimpleKeplerPRF
    paths, _ = write_k2_tpfs(os.path.join(tmp, "prf_k2"))
    tpfs = [read(p) for p in paths]
    for tpf in tpfs:
        tpf.prf_lightcurve()
    per_file = []
    for i, tpf in enumerate(tpfs):
        name = f"prf k2 file {i}"
        with diagnostics.KernelTimer(name):
            lc = tpf.prf_lightcurve()
        per_file.append(diagnostics.report()[name]["max_s"])
        if type(tpf.get_model().prfmodel) is not SimpleKeplerPRF or \
                lc.meta["CHANNEL"] != tpf.channel or \
                not np.isfinite(lc.flux.value).all() or \
                not np.array_equal(lc.time.value, tpf.time.value):
            raise AssertionError(f"PRF, K2 file {i}: the light curve's PRF, "
                                 "meta, time or flux is wrong")
    cal = os.path.join(tmp, "prf_cal")
    tpf = tpfs[0]
    write_kepler_prf(cal, tpf.channel)
    kepler = tpf.extract_prf_photometry(
        prf=tpf.get_prf_model(prf_dir=cal)).opt_params[:, 2]
    gauss = tpf.extract_prf_photometry(prf=GaussianPRF(
        shape=tpf.shape[1:], column=tpf.column, row=tpf.row,
        sigma=PRF_SIGMA_KEPLER, oversample=50)).opt_params[:, 2]
    gap = float(np.max(np.abs(kepler - gauss) / np.abs(gauss)))
    med_ms = float(np.median(per_file)) * 1e3
    log(f"PRF, K2 files: {len(paths)} files ({K2_N} x {K2_SHAPE[0]}x"
        f"{K2_SHAPE[1]}) through prf_lightcurve(): {med_ms:.3f} ms a file "
        f"(median, second pass); KeplerPRF from a calibration file against "
        f"its Gaussian: flux within {gap:.3g} relative (bar "
        f"{PRF_KEPLER_RTOL:g}) [{card}]")
    if gap > PRF_KEPLER_RTOL:
        raise AssertionError("PRF: the calibration-file fit differs from the "
                             "Gaussian's")
    return dict(per_file_ms=med_ms, kepler_gap=gap)


def phase_prf(tmp, card, sweep, runs):
    """Phase 15, each part a path of its own: (a) the bench's scene at a
    sector's length, (b) the TESS files' PRF photometry (no kernel may
    launch) and its search (the launches the route rule gives, through
    ``sweep``) with K-WF and K-SF against their plain versions on its call
    4 (:func:`check_weighted_kernels`), (c) the K2 files and the
    calibration-file PRF (no kernel may launch).  Adds the paths' launches
    to ``runs``; returns the numbers and the kernels' errors."""
    import torch
    t0 = time.time()
    out = {}
    out["scene"], runs["PRF, scene (phase 15)"] = drive(
        "PRF, scene (phase 15)", prf_scene, card,
        forbid=tuple(kernel_table()))
    files, runs["PRF, TESS files (phase 15)"] = drive(
        "PRF, TESS files (phase 15)", prf_files, tmp, card,
        forbid=tuple(kernel_table()))
    out["search"] = sweep("PRF -> search (phase 15)", prf_search, files,
                          card)
    call4 = np.linspace(*LONG_GRID)[3072:]
    errs = check_weighted_kernels("prf", out["search"].pop("flat"),
                                  call4[-PIX_KERNEL_PERIODS:])
    out["files"] = {k: files[k] for k in ("per_file_ms", "f64_gap")}
    del files
    out["kepler"], runs["PRF, K2 files (phase 15)"] = drive(
        "PRF, K2 files (phase 15)", prf_kepler, tmp, card,
        forbid=tuple(kernel_table()))
    torch.cuda.empty_cache()
    log(f"phase 15: {time.time() - t0:.1f}s")
    return out, errs


# ---------------------------------------------------------------------------
# phase 16: the archive search and the explorers on the card
# ---------------------------------------------------------------------------
#: the archive's targets, each observed in two consecutive sectors
ARC_B = 512
ARC_SEED = 2037
#: the sectors with their SPOC file-name stamps and release numbers; the
#: second starts SECTOR_DAYS after the first (phase 6's times)
ARC_SECTORS = ((14, "2019198215352", "0150"), (15, "2019226182529", "0151"))
#: TIC ids of 9 digits, spread over the catalogue
ARC_TIC0, ARC_TIC_STEP = 141_000_000, 104_729
#: injected transit periods (d): at least three transits in two sectors
ARC_PERIODS = (1.2, 17.0)
#: targets also searched through a recorded MAST transport
ARC_MAST = 16
#: TESScut: the sector's FFIs, their size and the cutout's
ARC_FFIS = 64
ARC_FFI_SHAPE = (256, 256)
ARC_CUTOUT = 11
#: the card's float32 cutout photometry against the CPU's float64
ARC_CUTOUT_RTOL = 1e-6
#: the BLS explorer's base grid (``interact_bls(html=...)``'s least) and
#: the smaller page held against the CPU's float64 run
ARC_BLS_RESOLUTION = 20_000
ARC_SMALL_PAGE = dict(resolution=2000, refine_peaks=2)
#: the explorer's power: float32 on the card within this share of the
#: peak of float64 (C3), float64 on the card within the CPU tests' share
#: of the CPU's; both plus one unit in the last printed digit
ARC_PAGE_F32_RTOL = 1e-5
ARC_PAGE_F64_RTOL = 1e-9
#: the sky page's catalogue: sources placed through the TPF's own WCS
ARC_SKY_SOURCES = 25
#: the echelle page's SNR spectrum, float32 on the card, within this share
#: of the float64 page's peak (1.96e-4 in three runs on an H100); the
#: control, the float64 spectrum one frequency bin off, must read above it
ARC_ECHELLE_RTOL = 5e-4
#: PERF.md section 2's limits: search -> download_all -> stitch targets/s
#: and the seconds to write one stitched curve's BLS explorer
ARC_TARGETS_PER_S = 25.0
ARC_PAGE_SECONDS = 2.0


def archive_tics(B=ARC_B):
    return ARC_TIC0 + ARC_TIC_STEP * np.arange(B)


def archive_name(tic, sector, kind="lc"):
    """SPOC's file name of a target's light curve (``kind="lc"``) or
    pixel file (``"tp"``) in one of :data:`ARC_SECTORS`."""
    stamp, release = next((st, rel) for sec, st, rel in ARC_SECTORS
                          if sec == sector)
    return f"tess{stamp}-s{sector:04d}-{int(tic):016d}-{release}-s_{kind}.fits"


@contextlib.contextmanager
def archive_env(tmp):
    """``HOME``, ``XDG_CONFIG_HOME``, ``XDG_CACHE_HOME`` and
    ``LIGHTKURVE_CACHE_DIR`` inside ``tmp``, no archive or MAST variables
    and no configured cache directory inside the block; restored after."""
    from lightkurve_tpu_torch.config import conf
    homes = ("HOME", "XDG_CONFIG_HOME", "XDG_CACHE_HOME",
             "LIGHTKURVE_CACHE_DIR")
    unset = ("LIGHTKURVE_TPU_ARCHIVE", "LIGHTKURVE_TPU_MAST_FIXTURES",
             "LIGHTKURVE_TPU_MAST_HTTP")
    saved = {k: os.environ.get(k) for k in homes + unset}
    saved_cache = conf.cache_dir
    for k in unset:
        os.environ.pop(k, None)
    for k in homes:
        os.environ[k] = os.path.join(tmp, "env", k.lower())
        os.makedirs(os.environ[k], exist_ok=True)
    conf.cache_dir = None
    try:
        yield
    finally:
        conf.cache_dir = saved_cache
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def port_on(device, dtype):
    """The single-curve classes' device and dtype inside the block."""
    from lightkurve_tpu_torch import config
    prev = (config.default_device, config.default_dtype)
    config.default_device, config.default_dtype = device, dtype
    try:
        yield
    finally:
        config.default_device, config.default_dtype = prev


@contextlib.contextmanager
def bls_devices(seen):
    """Append the device of every per-curve binned BLS result (the BLS
    explorer's precompute) to ``seen`` inside the block."""
    from lightkurve_tpu_torch.ops import bls
    real = bls.bls_power_binned

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out["power"].device.type)
        return out

    bls.bls_power_binned = spy
    try:
        yield
    finally:
        bls.bls_power_binned = real


def archive_files(tmp, card, B=ARC_B):
    """Phase 16's archive: :data:`ARC_B` targets in the two
    :data:`ARC_SECTORS`, phase 10's data (:func:`flatten_arrays`) over
    phase 6's two-sector times with transits of 1.2-17 d, written by
    :func:`write_lc_sector` under SPOC's names (1,024 light-curve files),
    and :func:`tess_tpfs`'s 8 pixel files under the first 8 targets'
    SPOC names.  Returns the directory, each target's two paths (sector
    order), the TIC ids, the injected periods and the pixel files."""
    arrays, p_inj, _ = flatten_arrays(B, ARC_SEED, periods=ARC_PERIODS,
                                      t=sector_times(2))
    tics = archive_tics(B)
    directory = os.path.join(tmp, "archive")
    t0 = time.perf_counter()
    by_sector = []
    for k, (sector, _, _) in enumerate(ARC_SECTORS):
        part = tuple(a[:, k * LONG_N:(k + 1) * LONG_N] for a in arrays)
        by_sector.append(write_lc_sector(
            directory, part, names=[archive_name(tic, sector)
                                    for tic in tics],
            tics=tics, sector=sector))
    lc_s = time.perf_counter() - t0
    tpfs, _ = tess_tpfs()
    t0 = time.perf_counter()
    tpf_paths = []
    for tic, tpf in zip(tics, tpfs):
        tpf.meta.update(OBJECT=f"TIC {tic}", TICID=int(tic),
                        SECTOR=ARC_SECTORS[0][0])
        path = os.path.join(directory, archive_name(tic, ARC_SECTORS[0][0],
                                                    "tp"))
        tpf.to_fits(path, overwrite=True)
        tpf_paths.append(path)
    log(f"archive: wrote {2 * B} SPOC-named light-curve files (2 "
        f"sectors x {B} targets x {LONG_N} cadences) in {lc_s:.3f}s and "
        f"{len(tpf_paths)} pixel files in {time.perf_counter() - t0:.3f}s "
        f"[{card}]")
    return dict(dir=directory, paths=list(zip(*by_sector)), tics=tics,
                p_inj=p_inj, tpf_paths=tpf_paths)


def archive_target(tic, directory):
    """One target's ``search_lightcurve(f"TIC {tic}", author="SPOC",
    exptime=120, archive_dir=...)``."""
    from lightkurve_tpu_torch.search import search_lightcurve
    return search_lightcurve(f"TIC {tic}", author="SPOC", exptime=120,
                             archive_dir=directory)


def archive_pass(files):
    """Every target's search -> ``download_all()`` -> ``stitch()``;
    returns (result, stitched curve) per target."""
    out = []
    for tic in files["tics"]:
        result = archive_target(tic, files["dir"])
        out.append((result, result.download_all().stitch()))
    return out


def archive_search(files, card, chunk_periods=1024):
    """Phase 16 (a): every target through :func:`archive_pass` twice (the
    second pass timed: targets/s and files/s), each result the target's
    two files in sector order; ``LightCurveCollection(stitched)
    .to_stack()`` on the card in float32 (one time grid; timed), bit-equal
    to the stack of ``read_lc_collection`` of the same 1,024 paths
    stitched per target; ``flatten`` (:data:`FLATTEN_KW`) and
    ``bls_search`` over :data:`TWO_SECTOR_GRID` in four calls; recovery of
    :data:`RECOVERY_SHARE`.  Returns the numbers, the routes the rule
    gives, the flattened stack, the second pass's results and the
    winners."""
    import torch
    from lightkurve_tpu_torch.collections import LightCurveCollection
    from lightkurve_tpu_torch.io.read import read_lc_collection
    B = len(files["tics"])
    t0 = time.perf_counter()
    first = archive_pass(files)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = archive_pass(files)
    warm_s = time.perf_counter() - t0
    for (result, lc), (_, lc1), paths in zip(second, first, files["paths"]):
        if [r["path"] for r in result.table] != list(paths) or \
                not np.array_equal(lc.flux.value, lc1.flux.value,
                                   equal_nan=True):
            raise AssertionError(f"archive: the search of {paths[0]} did "
                                 "not give its two sectors in order, or "
                                 "the two passes differ")
    stitched = [lc for _, lc in second]
    log(f"archive: search -> download_all -> stitch of {B} targets (2 "
        f"files each): {warm_s:.3f}s on the second pass, "
        f"{B / warm_s:.6g} targets/s (limit {ARC_TARGETS_PER_S:g}), "
        f"{2 * B / warm_s:.6g} files/s; first pass {cold_s:.3f}s [{card}]")
    start_sweep()
    stack, stack_s = sync_timed(
        lambda: LightCurveCollection(stitched).to_stack())
    n = len(stitched[0])
    if (stack.shape != (B, n) or stack.device.type != "cuda"
            or stack.flux.dtype != torch.float32
            or not bool(torch.all(stack.time == stack.time[0:1]))):
        raise AssertionError("archive: to_stack() is not one float32 time "
                             "grid on the card")
    t0 = time.perf_counter()
    coll = read_lc_collection([p for pair in files["paths"] for p in pair])
    direct = LightCurveCollection([
        LightCurveCollection([coll[2 * i], coll[2 * i + 1]]).stitch()
        for i in range(B)]).to_stack()
    direct_s = time.perf_counter() - t0
    same = {f: bool(torch.equal(getattr(stack, f), getattr(direct, f)))
            for f in ("time", "flux", "flux_err", "mask")}
    log(f"archive: to_stack() {stack_s:.3f}s, shape {stack.shape}; against "
        f"read_lc_collection of the same {2 * B} paths stitched per target "
        f"({direct_s:.3f}s): bit-equal {same} [{card}]")
    if not all(same.values()):
        raise AssertionError("archive: the searched stack differs from the "
                             "direct read's")
    del direct, coll
    start_sweep()
    flat, flatten_s = sync_timed(lambda: stack.flatten(**FLATTEN_KW))
    periods = np.linspace(*TWO_SECTOR_GRID)
    routes = expected_launches(flat, periods, chunk_periods,
                               launch_periods=16)
    start_sweep()
    t0 = time.perf_counter()
    best = lc_search(flat, periods, chunk_periods)
    search_s = time.perf_counter() - t0
    share = recovery(best["period"], files["p_inj"])
    rate = B * len(periods) / search_s
    missed = np.flatnonzero(np.abs(best["period"] - files["p_inj"])
                            / files["p_inj"] >= RECOVERY_RTOL)
    log(f"archive: stack.flatten (window 901) {flatten_s:.3f}s; bls_search "
        f"B={B} N={n} P={len(periods)} in {len(periods) // chunk_periods} "
        f"calls {search_s:.3f}s ({rate:.6g} curve-period evals/s); "
        f"recovered {share:.4f}; missed (injected -> found, d): "
        + ", ".join(f"{files['p_inj'][i]:.4f} -> {best['period'][i]:.4f}"
                    for i in missed[:12])
        + f"; {peak_memory()} [{card}]")
    if share < RECOVERY_SHARE:
        raise AssertionError(f"archive recovery {share} < {RECOVERY_SHARE}")
    if B / warm_s < ARC_TARGETS_PER_S:
        raise AssertionError(f"archive: {B / warm_s} targets/s < "
                             f"{ARC_TARGETS_PER_S}")
    return dict(cold_s=cold_s, seconds=warm_s, targets_per_s=B / warm_s,
                files_per_s=2 * B / warm_s, stack_s=stack_s,
                flatten_s=flatten_s, search_s=search_s, rate=rate,
                recovered=share, routes=routes, flat=flat, results=second,
                best=best)


def archive_mast(tmp, files, results, card):
    """Phase 16 (b): :data:`ARC_MAST` targets through a
    ``RecordedMASTTransport`` whose fixture lists their two products as
    MAST's observations and products tables: each search's rows (file,
    target, mission, author, exptime, sector) equal the archive scan's,
    and its ``download_all()`` (into a download directory) the same
    curves bit for bit.  No kernel may launch."""
    from lightkurve_tpu_torch.mast import RecordedMASTTransport
    from lightkurve_tpu_torch.search import search_lightcurve
    observations, products = [], []
    for i, tic in enumerate(files["tics"][:ARC_MAST]):
        for (sector, _, _), path in zip(ARC_SECTORS, files["paths"][i]):
            obs_id = f"tess_s{sector:04d}_{tic}"
            name = os.path.basename(path)
            observations.append({
                "obs_id": obs_id, "target_name": str(tic),
                "s_ra": 80.0 + 0.01 * i, "s_dec": -70.0, "project": "TESS",
                "provenance_name": "SPOC", "t_exptime": 120,
                "sequence_number": sector, "dataproduct_type": "timeseries",
                "description": f"TESS Sector {sector}"})
            products.append({"obs_id": obs_id, "productFilename": name,
                             "description": "Light curves",
                             "dataURI": f"mast:TESS/product/{name}",
                             "local_path": path})
    transport = RecordedMASTTransport({"observations": observations,
                                       "products": products})
    keys = ("productFilename", "target_name", "mission", "author",
            "sequence_number")
    t0 = time.perf_counter()
    for i, tic in enumerate(files["tics"][:ARC_MAST]):
        got = search_lightcurve(f"TIC {tic}", author="SPOC", exptime=120,
                                transport=transport)
        want = results[i][0]
        rows = [tuple(r[k] for k in keys) + (float(r["exptime"]),)
                for r in got.table]
        if rows != [tuple(r[k] for k in keys) + (float(r["exptime"]),)
                    for r in want.table]:
            raise AssertionError(f"archive, MAST: TIC {tic}'s rows differ "
                                 "from the archive scan's")
        for a, b in zip(got.download_all(download_dir=os.path.join(
                tmp, "mast_download")), want.download_all()):
            if not all(np.array_equal(getattr(a, c).value,
                                      getattr(b, c).value, equal_nan=True)
                       for c in ("time", "flux", "flux_err")):
                raise AssertionError(f"archive, MAST: TIC {tic}'s download "
                                     "differs from the archive scan's")
    secs = time.perf_counter() - t0
    log(f"archive, MAST: {ARC_MAST} targets through the recorded "
        f"transport ({len(observations)} observations, {len(products)} "
        f"products): rows and download_all equal to the archive scan's; "
        f"{secs:.3f}s [{card}]")
    return dict(seconds=secs)


def archive_tesscut(tmp, files, card):
    """Phase 16 (c): :data:`ARC_FFIS` FFIs of 256 x 256 float32 with a TAN
    WCS (a star at the first target's position, 0.5%-deep dips) as the
    transport's ``ffi_sectors``; ``search_tesscut`` ->
    ``download(cutout_size=11)`` -> ``to_lightcurve()``: the cube equals
    the same 11 x 11 cut taken from the images on the host, and the card's
    float32 photometry the CPU's float64 within :data:`ARC_CUTOUT_RTOL`.
    No kernel may launch."""
    import torch
    from lightkurve_tpu_torch.io.fits import (HDUList, Header, ImageHDU,
                                              PrimaryHDU, write_fits)
    from lightkurve_tpu_torch.mast import RecordedMASTTransport
    from lightkurve_tpu_torch.search import search_tesscut
    rng = np.random.default_rng(ARC_SEED + 1)
    tic, (ra, dec) = int(files["tics"][0]), (80.0, -70.0)
    sector = ARC_SECTORS[0][0]
    H, W = ARC_FFI_SHAPE
    col, row = 130, 117                  # the target's pixel (0-based)
    yy, xx = np.mgrid[:H, :W]
    psf = np.exp(-((xx - col - 0.2) ** 2 + (yy - row + 0.1) ** 2) / 2.2)
    directory = os.path.join(tmp, "ffi")
    os.makedirs(directory, exist_ok=True)
    paths, images = [], []
    t0 = time.perf_counter()
    for i in range(ARC_FFIS):
        star = 5e4 * (1 - 0.005 * (i % 16 < 2))
        img = (100.0 + star / (2.2 * np.pi) * psf
               + 3.0 * rng.standard_normal((H, W))).astype(np.float32)
        header = Header({"TELESCOP": "TESS", "TIME": 1683.36 + i / 48,
                         "CADENCENO": i, "SECTOR": sector, "CAMERA": 1,
                         "CCD": 1, "CRPIX1": col + 1.0, "CRPIX2": row + 1.0,
                         "CRVAL1": ra, "CRVAL2": dec, "CDELT1": -21 / 3600,
                         "CDELT2": 21 / 3600, "CTYPE1": "RA---TAN",
                         "CTYPE2": "DEC--TAN"})
        path = os.path.join(directory, f"tess2019199-s{sector:04d}-1-1-"
                            f"{i:04d}_ffic.fits")
        write_fits(HDUList([PrimaryHDU(), ImageHDU(data=img,
                                                   header=header)]), path)
        paths.append(path)
        images.append(img)
    write_s = time.perf_counter() - t0
    transport = RecordedMASTTransport({
        "resolver": {f"tic {tic}": [ra, dec]},
        "observations": [{
            "obs_id": f"tess_ffi_s{sector:04d}",
            "target_name": f"TESS FFI: Camera 1 CCD 1 Sector {sector}",
            "s_ra": ra, "s_dec": dec, "project": "TESS",
            "provenance_name": "SPOC", "t_exptime": 1800,
            "sequence_number": sector, "dataproduct_type": "image",
            "t_min": 58683.86, "description": "TESS FFI"}],
        "products": [], "ffi_sectors": {str(sector): paths}})
    result = search_tesscut(f"TIC {tic}", sector=sector, transport=transport)
    if len(result) != 1 or result.table[0]["author"] != "TESScut":
        raise AssertionError("archive, TESScut: search_tesscut found "
                             f"{len(result)} cutouts")
    tpf, cut_s = sync_timed(lambda: result.download(cutout_size=ARC_CUTOUT))
    half = ARC_CUTOUT // 2
    want = np.stack(images)[:, row - half:row + half + 1,
                            col - half:col + half + 1].astype(np.float64)
    same = np.array_equal(np.asarray(tpf.flux.value), want)
    lc, phot_s = sync_timed(tpf.to_lightcurve)
    with port_on("cpu", torch.float64):
        lc64 = tpf.to_lightcurve()
    f32, f64 = np.asarray(lc.flux.value), np.asarray(lc64.flux.value)
    err = float(np.max(np.abs(f32 - f64) / np.abs(f64)))
    log(f"archive, TESScut: {ARC_FFIS} FFIs of {H} x {W} (written in "
        f"{write_s:.3f}s); search_tesscut -> download(cutout_size="
        f"{ARC_CUTOUT}) {cut_s:.3f}s, shape {tpf.shape}, equal to the host "
        f"cut: {same}; to_lightcurve() on the card {phot_s * 1e3:.1f} ms, "
        f"float32 within {err:.3g} of the CPU's float64 (bar "
        f"{ARC_CUTOUT_RTOL:g}) [{card}]")
    if not same or tpf.shape != (ARC_FFIS, ARC_CUTOUT, ARC_CUTOUT) or \
            err > ARC_CUTOUT_RTOL:
        raise AssertionError("archive, TESScut: the cutout or its "
                             "photometry differs")
    return dict(download_s=cut_s, phot_ms=phot_s * 1e3, err=err)


def page_parts(path):
    """A page's text outside its ``const D = {...};`` and ``D`` parsed."""
    html = open(path).read()
    m = re.search(r"const D = (\{.*?\});\n", html, re.S)
    blob = re.sub(r"([,{])([A-Za-z_][A-Za-z0-9_]*):", r'\1"\2":', m.group(1))
    return html[:m.start()] + html[m.end():], json.loads(blob)


def printed_unit(x, sig):
    """One unit in the last of ``sig`` printed significant digits of x."""
    x = np.abs(np.asarray(x, float))
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.floor(np.log10(np.where(x > 0, x, 1.0)))
    return 10.0 ** (e - sig + 1)


def page_values(v):
    return np.array([np.nan if u is None else u for u in v], float)


#: significant digits of the pages' arrays (``interact_html._js_array``)
PAGE_SIG = {"p": 9, "t0": 9, "t": 10}


def compare_bls_pages(tag, got, want, rtol, n_base):
    """Two BLS explorer pages of one curve: the same text outside ``D``;
    on the periods both pages hold (at least the ``n_base`` of the base
    grid; the refined grids follow each page's peaks), the power within
    ``rtol`` of the peak plus one printed unit; the same ``best`` period,
    or one whose power ties to that bar, and there the same duration; the
    embedded curve equal.  Returns the power's error over the peak."""
    og, dg = page_parts(got)
    ow, dw = page_parts(want)
    pg, pw = page_values(dg["p"]), page_values(dw["p"])
    common, ig, iw = np.intersect1d(pg, pw, return_indices=True)
    a, b = page_values(dg["power"])[ig], page_values(dw["power"])[iw]
    peak = np.nanmax(page_values(dw["power"]))
    unit = np.maximum(printed_unit(a, 6), printed_unit(b, 6))
    over = np.abs(a - b) - (rtol * peak + unit)
    nan_same = np.array_equal(np.isnan(a), np.isnan(b))
    worst = float(np.nanmax(np.abs(a - b)) / peak)
    bg, bw = dg["best"], dw["best"]
    pbg, pbw = dg["power"][bg], dw["power"][bw]
    tie = abs(pbg - pbw) <= rtol * peak + max(printed_unit(pbw, 6),
                                              printed_unit(pbg, 6))
    same = pg[bg] == pw[bw]
    log(f"{tag}: {len(common)} of {len(pg)} periods common; power within "
        f"{worst:.3g} of the peak (bar {rtol:g} + one printed digit); best "
        f"{pg[bg]:.9g} d (power {pbg}) against {pw[bw]:.9g} d ({pbw}): "
        f"{'same' if same else 'tie' if tie else 'DIFFERENT'}")
    if (og != ow or len(common) < n_base or not nan_same
            or np.nanmax(over) > 0 or not (same or tie)
            or (same and dg["dur"][bg] != dw["dur"][bw])
            or dg["t"] != dw["t"] or dg["f"] != dw["f"]):
        raise AssertionError(f"{tag}: the pages differ past the bar")
    return worst


def compare_pages(tag, got, want, rtol, what="card page"):
    """A pixel, sky or echelle page (``what`` names it in the log)
    against the same page written on the CPU in float64: the text outside ``D`` equal but the slider's numbers
    (within ``rtol`` relative); in ``D`` every number within ``rtol`` of
    its array's largest value plus one printed unit, the rest equal."""
    og, dg = page_parts(got)
    ow, dw = page_parts(want)
    attr = r'((?:min|max|step|value)=")([-+0-9.e]+)(")'
    ng = [float(m[1]) for m in re.findall(attr, og)]
    nw = [float(m[1]) for m in re.findall(attr, ow)]
    worst = 0.0
    ok = (re.sub(attr, r"\1#\3", og) == re.sub(attr, r"\1#\3", ow)
          and len(ng) == len(nw) and dg.keys() == dw.keys()
          and all(abs(x - y) <= rtol * abs(y) for x, y in zip(ng, nw)))

    def close(x, y, sig):
        nonlocal worst
        a, b = page_values(x), page_values(y)
        if a.shape != b.shape or not np.array_equal(np.isnan(a),
                                                    np.isnan(b)):
            return False
        if not b.size or np.isnan(b).all():
            return True
        scale = np.nanmax(np.abs(b))
        err = np.abs(a - b)
        worst = max(worst, float(np.nanmax(err) / scale) if scale else 0.0)
        return bool(np.all(np.isnan(b) | (err <= rtol * scale + np.maximum(
            printed_unit(a, sig), printed_unit(b, sig)))))

    for k, w in dw.items():
        g = dg.get(k)
        if k in ("pix",):
            ok = ok and len(g) == len(w) and all(
                close(x, y, 6) for x, y in zip(g, w))
        elif isinstance(w, list) and w and all(
                isinstance(v, (int, float)) or v is None for v in w) and \
                k not in ("shape", "init", "pipeline", "threshold", "aper"):
            ok = ok and close(g, w, PAGE_SIG.get(k, 6))
        elif isinstance(w, float):
            ok = ok and abs(g - w) <= rtol * abs(w)
        else:
            ok = ok and g == w
    log(f"{tag}: {what} against the CPU's float64 page: numbers within "
        f"{worst:.3g} of their array's largest (bar {rtol:g} + one printed "
        f"digit), the rest equal: {ok}")
    if not ok:
        raise AssertionError(f"{tag}: the pages differ past the bar")
    return worst


def sky_catalog(tpf, n=ARC_SKY_SOURCES, seed=ARC_SEED + 2):
    """``n`` sources on and around the TPF's stamp, placed through its own
    WCS, with magnitudes 9-18, Gaia-like ids and proper motions on half."""
    rng = np.random.default_rng(seed)
    h, w = tpf.shape[1:]
    ra, dec = tpf.wcs.pixel_to_world(rng.uniform(-1.2, w + 0.3, n),
                                     rng.uniform(-1.2, h + 0.3, n))
    moving = np.arange(n) % 2 == 0
    return {"ra": np.asarray(ra), "dec": np.asarray(dec),
            "mag": np.round(rng.uniform(9, 18, n), 2),
            "id": [f"Gaia DR3 {4_600_000_000 + 7919 * i}" for i in range(n)],
            "pmra": np.where(moving, rng.normal(0, 30, n), 0.0),
            "pmdec": np.where(moving, rng.normal(0, 30, n), 0.0)}


def archive_pages(tmp, files, stitched, card):
    """Phase 16 (d), the explorers, each written on the card and held
    against a float64 run: ``interact_bls(html=...)`` on one stitched
    curve (20,000 base periods, refined grids at up to 8 peaks; the second
    call timed) against the card's own float64 page, and a page at
    :data:`ARC_SMALL_PAGE` in float32 and float64 on the card against the
    CPU's float64 (:func:`compare_bls_pages`; every precompute must run on
    the card); ``interact(html=...)`` and ``interact_sky(html=...,
    catalog=...)`` on one of the archive's pixel files (found by
    ``search_targetpixelfile``; the catalogue of :func:`sky_catalog`), and
    ``Seismology.interact_echelle(html=...)`` on one of phase 14's
    KEPSEISMIC giants, against the same pages written on the CPU in
    float64 (:func:`compare_pages`); ``demo_sky_catalog()`` opened.  No
    kernel may launch.  Returns each page's seconds and errors."""
    import csv
    import torch
    from lightkurve_tpu_torch.interact_html import (demo_sky_catalog,
                                                    export_interact_bls_html)
    from lightkurve_tpu_torch.io.read import read
    from lightkurve_tpu_torch.search import search_targetpixelfile
    pages = os.path.join(tmp, "pages")
    os.makedirs(pages, exist_ok=True)

    def page(name):
        return os.path.join(pages, name + ".html")

    out = {}
    lc = stitched
    seen = []
    with bls_devices(seen):
        lc.interact_bls(html=page("bls_warm"))
        _, out["bls_s"] = sync_timed(
            lambda: lc.interact_bls(html=page("bls32")))
        with port_on("cuda", torch.float64):
            _, out["bls64_s"] = sync_timed(
                lambda: lc.interact_bls(html=page("bls64")))
        export_interact_bls_html(lc, page("small32"), **ARC_SMALL_PAGE)
        with port_on("cuda", torch.float64):
            export_interact_bls_html(lc, page("small64"), **ARC_SMALL_PAGE)
    if set(seen) != {"cuda"} or len(seen) != 10:
        raise AssertionError(f"archive, explorers: a BLS precompute ran off "
                             f"the card ({seen})")
    with port_on("cpu", torch.float64):
        _, cpu_s = sync_timed(lambda: export_interact_bls_html(
            lc, page("small_cpu"), **ARC_SMALL_PAGE))
    n_periods = len(page_parts(page("bls32"))[1]["p"])
    log(f"archive, BLS explorer: one stitched curve ({len(lc)} cadences), "
        f"{n_periods} periods: {out['bls_s']:.3f}s on the card in float32 "
        f"(second call; limit {ARC_PAGE_SECONDS:g}), {out['bls64_s']:.3f}s "
        f"in float64; the {ARC_SMALL_PAGE} page on the CPU in float64 "
        f"{cpu_s:.3f}s [{card}]")
    if out["bls_s"] > ARC_PAGE_SECONDS:
        raise AssertionError(f"archive: the BLS explorer took "
                             f"{out['bls_s']}s > {ARC_PAGE_SECONDS}s")
    out["bls_err"] = compare_bls_pages(
        "archive, BLS explorer, card float32 vs card float64", page("bls32"),
        page("bls64"), ARC_PAGE_F32_RTOL, ARC_BLS_RESOLUTION)
    out["small_err"] = compare_bls_pages(
        "archive, small BLS explorer, card float32 vs CPU float64",
        page("small32"), page("small_cpu"), ARC_PAGE_F32_RTOL,
        ARC_SMALL_PAGE["resolution"])
    out["small64_err"] = compare_bls_pages(
        "archive, small BLS explorer, card float64 vs CPU float64",
        page("small64"), page("small_cpu"), ARC_PAGE_F64_RTOL,
        ARC_SMALL_PAGE["resolution"])

    tic = int(files["tics"][0])
    result = search_targetpixelfile(f"TIC {tic}", archive_dir=files["dir"])
    if [r["path"] for r in result.table] != files["tpf_paths"][:1]:
        raise AssertionError("archive: search_targetpixelfile did not find "
                             "the target's pixel file")
    tpf = result.download()
    catalog = sky_catalog(tpf)
    _, out["pixel_s"] = sync_timed(lambda: tpf.interact(html=page("pix")))
    _, out["sky_s"] = sync_timed(lambda: tpf.interact_sky(
        html=page("sky"), catalog=catalog))
    demo = demo_sky_catalog()
    with open(demo, newline="") as f:
        n_demo = len(list(csv.DictReader(f)))
    tpf.interact_sky(html=page("sky_demo"), catalog=demo)
    giant_path, giant = (v[0] for v in write_seismic_stars(
        os.path.join(tmp, "arc_seis"), giants=1, dwarfs=0))
    seis = seismology_chain(read(giant_path), giant["teff"])["seis"]
    _, out["echelle_s"] = sync_timed(
        lambda: seis.interact_echelle(html=page("ech")))
    with port_on("cpu", torch.float64):
        tpf64 = read(files["tpf_paths"][0])
        tpf64.interact(html=page("pix64"))
        tpf64.interact_sky(html=page("sky64"), catalog=catalog)
        seis64 = seismology_chain(read(giant_path), giant["teff"])["seis"]
        seis64.interact_echelle(html=page("ech64"))
    n_src = len(page_parts(page("sky"))[1]["src"])
    log(f"archive, explorers: pixel page {out['pixel_s']:.3f}s "
        f"({tpf.shape}), sky page {out['sky_s']:.3f}s ({n_src} of "
        f"{ARC_SKY_SOURCES} sources drawn; the demo catalogue's {n_demo} "
        f"read), echelle page {out['echelle_s']:.3f}s (giant, "
        f"{len(seis.periodogram.frequency)} frequencies) [{card}]")
    if n_demo != 25 or n_src < 10:
        raise AssertionError("archive: the sky pages lack their sources")
    host = "host page of the float32 run"
    out["pixel_err"] = compare_pages("archive, pixel page", page("pix"),
                                     page("pix64"), 0.0, host)
    out["sky_err"] = compare_pages("archive, sky page", page("sky"),
                                   page("sky64"), 0.0, host)
    out["echelle_err"] = compare_pages("archive, echelle page", page("ech"),
                                       page("ech64"), ARC_ECHELLE_RTOL)
    p64 = page_values(page_parts(page("ech64"))[1]["p"])
    control = float(np.nanmax(np.abs(p64[1:] - p64[:-1]))
                    / np.nanmax(np.abs(p64)))
    log(f"archive, echelle page: control, the float64 spectrum one bin "
        f"off, reads {control:.3g} of its largest (bar "
        f"{ARC_ECHELLE_RTOL:g})")
    if control <= ARC_ECHELLE_RTOL:
        raise AssertionError("archive: the echelle bar does not tell a "
                             "one-bin shift from the float64 page")
    return out


def phase_archive(tmp, card, sweep, runs):
    """Phase 16, each part a path of its own, inside :func:`archive_env`:
    the archive's files (no kernel may launch), (a) the search -> stack ->
    BLS path (the launches the route rule gives, through ``sweep``) with
    K-WF and K-SF against their plain versions on its call 4
    (:func:`check_weighted_kernels`), (b) the MAST chain, (c) TESScut and
    (d) the explorers (no kernel may launch in b-d).  Adds the paths'
    launches to ``runs``; returns the numbers (and, under ``"phase18"``,
    the files, each target's search and stitched curve, and the winners,
    which phase 18 compares with) and the kernels' errors."""
    import torch
    t0 = time.time()
    none = tuple(kernel_table())
    out = {}
    with archive_env(tmp):
        files, runs["archive, files (phase 16)"] = drive(
            "archive, files (phase 16)", archive_files, tmp, card,
            forbid=none)
        out["search"] = sweep("archive -> search (phase 16)", archive_search,
                              files, card)
        call4 = np.linspace(*TWO_SECTOR_GRID)[3072:]
        errs = check_weighted_kernels("archive", out["search"].pop("flat"),
                                      call4[-PIX_KERNEL_PERIODS:])
        results = out["search"].pop("results")
        out["phase18"] = dict(files=files, results=results,
                              best=out["search"].pop("best"),
                              targets_per_s=out["search"]["targets_per_s"])
        out["mast"], runs["archive, MAST chain (phase 16)"] = drive(
            "archive, MAST chain (phase 16)", archive_mast, tmp, files,
            results, card, forbid=none)
        out["tesscut"], runs["archive, TESScut (phase 16)"] = drive(
            "archive, TESScut (phase 16)", archive_tesscut, tmp, files, card,
            forbid=none)
        out["pages"], runs["archive, explorers (phase 16)"] = drive(
            "archive, explorers (phase 16)", archive_pages, tmp, files,
            results[0][1], card, forbid=none)
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    log(f"phase 16: {out['seconds']:.1f}s")
    return out, errs


# ---------------------------------------------------------------------------
# phase 18: the archive over HTTP, then the search; the under-fitting
# metric's neighbours from the archive; the plots and exports
# ---------------------------------------------------------------------------
#: requests to the local Mashup server (counted from its start, 1-based)
#: answered with HTTP 503, all in (a)'s first pass over
#: :data:`HTTP_RETRY_TARGETS` targets (four requests a target: the
#: observation query, the product list, two downloads): a download of
#: target 0, target 2's product list, a download of target 9; each retried
#: by the transport after its backoff
HTTP_FAIL = (3, 10, 40)
HTTP_RETRY_TARGETS = 16
#: phase 14's targets whose correct() fetches its neighbours over HTTP
HTTP_CBV_TARGETS = (1, 2, 3, 4)
#: the under-fitting metric's cone (arcsec) for a TESS target, and the
#: neighbours it keeps (reference defaults, CBVCorrector.under_fitting_metric)
HTTP_CBV_RADIUS = 5000.0
HTTP_CBV_NEIGHBOURS = 50
#: the override of np.random.default_rng(None) in both correct() calls (the
#: over-fitting metric's noise)
HTTP_CBV_SEED = 2038


class MashupArchive:
    """A local stand-in for MAST over HTTP, for phase 18: a stdlib
    ``ThreadingHTTPServer`` on 127.0.0.1 (a free port) that speaks the
    Mashup protocol (``POST`` of ``request=<json>``: ``Mast.Name.Lookup``,
    ``Mast.Caom.Filtered``, ``Mast.Caom.Filtered.Position``,
    ``Mast.Caom.Products``) over observation and product tables and serves
    ``GET ...?uri=<dataURI>`` from the files on disk, as MAST's
    ``Download/file`` route does.  Requests whose ordinal is in ``fail``
    get a 503.  ``downloads`` lists every file served.  A context manager:
    the server thread stops on exit."""

    def __init__(self, observations, products, resolver, files, fail=()):
        import threading
        self.observations = observations
        self.by_target = {}
        for r in observations:
            self.by_target.setdefault(str(r["target_name"]), []).append(r)
        self.products = {}
        for p in products:
            self.products.setdefault(str(p["parent_obsid"]), []).append(p)
        self.resolver = {k.lower(): v for k, v in resolver.items()}
        self.files = files
        self.fail = set(fail)
        self.count = 0
        self.failed = 0
        self.downloads = []
        self.lock = threading.Lock()

    def _serve(self, request):
        service, params = request["service"], request.get("params", {})
        if service == "Mast.Name.Lookup":
            key = str(params["input"]).lower().strip()
            if key not in self.resolver:
                return {"status": "COMPLETE", "resolvedCoordinate": []}
            ra, dec = self.resolver[key]
            return {"status": "COMPLETE",
                    "resolvedCoordinate": [{"ra": ra, "decl": dec}]}
        if service == "Mast.Caom.Products":
            rows = []
            for oid in str(params["obsid"]).split(","):
                rows += [dict(p) for p in self.products.get(oid.strip(), [])]
            return {"status": "COMPLETE", "data": rows}
        if service not in ("Mast.Caom.Filtered",
                           "Mast.Caom.Filtered.Position"):
            return {"status": "ERROR", "msg": f"unknown service {service}"}
        filters = params.get("filters", [])
        named = [f["values"] for f in filters
                 if f["paramName"] == "target_name"]
        rows = (self.by_target.get(str(named[0][0]), []) if named
                else self.observations)
        if service.endswith("Position"):
            ra0, dec0, radius = (float(x) for x in
                                 params["position"].split(","))
            cosd = np.cos(np.deg2rad(dec0))
            rows = [r for r in rows if np.hypot(
                (r["s_ra"] - ra0) * cosd, r["s_dec"] - dec0) <= radius]
        for f in filters:
            name, values = f["paramName"], f["values"]
            if values and isinstance(values[0], dict):
                lo, hi = values[0]["min"], values[0]["max"]
                rows = [r for r in rows if lo <= float(r[name]) <= hi]
            else:
                opts = {str(v).lower() for v in values}
                rows = [r for r in rows if str(r.get(name, "")).lower()
                        in opts]
        return {"status": "COMPLETE", "data": [dict(r) for r in rows]}

    def __enter__(self):
        import http.server
        import threading
        import urllib.parse
        archive = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _next(self):
                with archive.lock:
                    archive.count += 1
                    if archive.count in archive.fail:
                        archive.failed += 1
                        return False
                return True

            def _send(self, payload, kind):
                self.send_response(200)
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if not self._next():
                    self.send_error(503, "busy")
                    return
                text = urllib.parse.unquote(body.decode())
                request = json.loads(text[len("request="):])
                self._send(json.dumps(archive._serve(request)).encode(),
                           "application/json")

            def do_GET(self):
                if not self._next():
                    self.send_error(503, "busy")
                    return
                uri = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)["uri"][0]
                name = uri.rsplit("/", 1)[-1]
                with open(archive.files[name], "rb") as f:
                    payload = f.read()
                with archive.lock:
                    archive.downloads.append(name)
                self._send(payload, "application/octet-stream")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        base = f"http://127.0.0.1:{self.server.server_port}"
        self.mashup_url = base + "/api/v0/invoke"
        self.download_url = base + "/api/v0.1/Download/file"
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()

    def transport(self):
        """The port's HTTP transport pointed at this server."""
        from lightkurve_tpu_torch.mast_http import HTTPMASTTransport
        return HTTPMASTTransport(mashup_url=self.mashup_url,
                                 download_url=self.download_url)


def http_tables(files, cbv_paths):
    """Phase 18's archive tables: phase 16's 512 targets x 2 sectors (the
    search's) near RA 200, Dec +30, and phase 14's 256 CBV targets
    scattered within 0.5 degrees of RA 80, Dec -70 (the under-fitting
    metric's cone), each observation a numeric CAOM ``obsid``, each
    product's ``dataURI`` its file name; the resolver knows each CBV
    target by its TIC id alone and as ``TIC <id>``.  Returns
    (observations, products, resolver, file paths by name)."""
    observations, products, resolver, paths = [], [], {}, {}

    def add(tic, sector, path, ra, dec):
        oid = 10_000 + len(observations)
        name = os.path.basename(path)
        observations.append({
            "obsid": oid, "obs_id": f"tess_s{sector:04d}_{tic}",
            "target_name": str(tic), "s_ra": ra, "s_dec": dec,
            "project": "TESS", "provenance_name": "SPOC", "t_exptime": 120,
            "sequence_number": sector, "dataproduct_type": "timeseries",
            "description": f"TESS Sector {sector}", "obs_collection": "TESS"})
        products.append({"parent_obsid": oid, "productFilename": name,
                         "description": "Light curves",
                         "dataURI": f"mast:TESS/product/{name}"})
        paths[name] = path

    for i, (tic, pair) in enumerate(zip(files["tics"], files["paths"])):
        for (sector, _, _), path in zip(ARC_SECTORS, pair):
            add(tic, sector, path, 200.0 + 0.01 * i, 30.0)
    rng = np.random.default_rng(ARC_SEED + 18)
    for i, path in enumerate(cbv_paths):
        ra = 80.0 + rng.uniform(-0.5, 0.5) / np.cos(np.deg2rad(70.0))
        dec = -70.0 + rng.uniform(-0.5, 0.5)
        add(i, CBV_SECTOR, path, ra, dec)
        resolver[str(i)] = resolver[f"tic {i}"] = (ra, dec)
    return observations, products, resolver, paths


def http_pass(transport, tics, download_dir):
    """Each target of ``tics`` through ``search_lightcurve(..., author=
    "SPOC", exptime=120, transport=...)`` -> ``download_all(download_dir=
    ...)`` -> ``stitch()``; returns (result, stitched curve) per target
    and the seconds."""
    from lightkurve_tpu_torch.search import search_lightcurve
    out = []
    t0 = time.perf_counter()
    for tic in tics:
        result = search_lightcurve(f"TIC {tic}", author="SPOC", exptime=120,
                                   transport=transport)
        lcs = result.download_all(download_dir=download_dir)
        if lcs is None or len(lcs) != len(ARC_SECTORS):
            raise AssertionError(f"http: TIC {tic}: not every file "
                                 "downloaded")
        out.append((result, lcs.stitch()))
    return out, time.perf_counter() - t0


def http_search(tmp, archive, arc, card, chunk_periods=1024):
    """Phase 18 (a): phase 16's targets searched, downloaded and stitched
    over HTTP (:func:`http_pass`), each pass into a fresh download
    directory: first :data:`HTTP_RETRY_TARGETS` of them with
    :data:`HTTP_FAIL`'s 503s, which the transport retries, then all 512,
    timed (targets/s, beside phase 16's).  Each search's rows and each
    stitched curve equal phase 16's; ``to_stack()`` -> flatten ->
    ``bls_search`` over 1-18 d in four calls (K-WF x4 by the route rule),
    the winners bit-equal to phase 16 (a)'s.  Returns the numbers, the
    routes and the flattened stack."""
    from lightkurve_tpu_torch.collections import LightCurveCollection
    files = arc["files"]
    transport = archive.transport()
    first, first_s = http_pass(transport, files["tics"][:HTTP_RETRY_TARGETS],
                               os.path.join(tmp, "http_download_1"))
    if archive.failed != len(HTTP_FAIL):
        raise AssertionError(f"http: the server failed {archive.failed} "
                             f"requests, not {len(HTTP_FAIL)}")
    n_requests = archive.count
    second, warm_s = http_pass(transport, files["tics"],
                               os.path.join(tmp, "http_download_2"))
    keys = ("productFilename", "target_name", "mission", "author",
            "sequence_number")
    for k, (want, want_lc) in enumerate(arc["results"]):
        for result, lc in [second[k]] + first[k:k + 1]:
            if [tuple(r[key] for key in keys) for r in result.table] != \
                    [tuple(r[key] for key in keys) for r in want.table]:
                raise AssertionError("http: a search's rows differ from the "
                                     "archive scan's")
            for c in ("time", "flux", "flux_err"):
                if not np.array_equal(getattr(lc, c).value,
                                      getattr(want_lc, c).value,
                                      equal_nan=True):
                    raise AssertionError(f"http: a stitched curve's {c} "
                                         "differs from phase 16's")
    B = len(files["tics"])
    rate = B / warm_s
    log(f"http: search -> download_all -> stitch of {B} targets ({2 * B} "
        f"files) over HTTP from 127.0.0.1, into a fresh directory: "
        f"{warm_s:.3f}s, {rate:.6g} targets/s (logged against "
        f"{ARC_TARGETS_PER_S:g}, not enforced: the server shares this "
        f"process; {2 * B / warm_s:.6g} files/s; phase "
        f"16's archive scan {arc['targets_per_s']:.6g} targets/s); the "
        f"first {HTTP_RETRY_TARGETS} before it {first_s:.3f}s with "
        f"{archive.failed} requests of {n_requests} answered 503 and "
        f"retried; rows and stitched curves equal to phase 16's [{card}]")
    start_sweep()
    stack, stack_s = sync_timed(
        lambda: LightCurveCollection([lc for _, lc in second]).to_stack())
    flat, flatten_s = sync_timed(lambda: stack.flatten(**FLATTEN_KW))
    periods = np.linspace(*TWO_SECTOR_GRID)
    routes = expected_launches(flat, periods, chunk_periods,
                               launch_periods=16)
    start_sweep()
    t0 = time.perf_counter()
    best = lc_search(flat, periods, chunk_periods)
    search_s = time.perf_counter() - t0
    same = {f: bool(np.array_equal(best[f], arc["best"][f], equal_nan=True))
            for f in best}
    log(f"http: to_stack() {stack_s:.3f}s, flatten {flatten_s:.3f}s, "
        f"bls_search B={B} P={len(periods)} in "
        f"{len(periods) // chunk_periods} calls {search_s:.3f}s; winners "
        f"against phase 16's: bit-equal {same}; {peak_memory()} [{card}]")
    if not all(same.values()):
        raise AssertionError("http: the winners differ from phase 16's")
    return dict(first_s=first_s, seconds=warm_s, targets_per_s=rate,
                files_per_s=2 * B / warm_s, requests=n_requests,
                failed=archive.failed, stack_s=stack_s, flatten_s=flatten_s,
                search_s=search_s, routes=routes, flat=flat)


@contextlib.contextmanager
def ambient_transport(transport):
    """``mast.default_transport()`` gives ``transport`` inside the block,
    as ``$LIGHTKURVE_TPU_MAST_HTTP=1`` gives the live client: the route by
    which ``CBVCorrector.correct()`` reaches the archive."""
    from lightkurve_tpu_torch import mast
    real = mast.default_transport
    mast.default_transport = lambda: transport
    try:
        yield
    finally:
        mast.default_transport = real


@contextlib.contextmanager
def seeded_default_rng(seed):
    """``np.random.default_rng(None)`` (the over-fitting metric's noise)
    seeded with ``seed`` inside the block."""
    real = np.random.default_rng
    np.random.default_rng = lambda s=None: real(seed if s is None else s)
    try:
        yield
    finally:
        np.random.default_rng = real


def cone_neighbour_flux(corrector, rows, tic, local):
    """The under-fitting metric's ``neighbor_flux`` made by hand from the
    cone search's rows: each neighbour's local file read as the metric
    reads it (SAP flux, the default quality mask), NaNs removed,
    normalised less one, on the corrected curve's cadence numbers (NaN
    where it has none), in the search's order."""
    from lightkurve_tpu_torch.io.read import read
    cad = np.asarray(corrector.corrected_lc.remove_nans()["cadenceno"])
    out = []
    for r in rows:
        if str(r["target_name"]) == str(tic):
            continue
        lc = read(local[r["productFilename"]], flux_column="sap_flux",
                  quality_bitmask="default").remove_nans().normalize() - 1.0
        row = np.full(cad.size, np.nan)
        _, ia, ib = np.intersect1d(cad, np.asarray(lc["cadenceno"]),
                                   return_indices=True)
        row[ia] = lc.flux.value[ib]
        out.append(row)
    return out


def http_cbv(tmp, archive, local, card):
    """Phase 18 (b): :data:`HTTP_CBV_TARGETS` of phase 14's CBV targets
    through ``correct()`` (its alpha search) twice, under one seed of the
    over-fitting metric's noise: with ``neighbor_flux`` made by hand from
    the local files of the neighbours the cone search over HTTP returns,
    and with no ``neighbor_flux``, the metric fetching them through the
    HTTP transport (the ambient one) into a fresh cache directory.  The
    under-fitting and over-fitting scores and alpha equal, and the files
    the server served in the second call those of the cone's rows.  No
    kernel may launch.  Returns the seconds."""
    import torch
    from lightkurve_tpu_torch.search import search_lightcurve
    cbv_dir = os.path.join(tmp, "cbv")
    transport = archive.transport()
    kw = dict(cbv_type=CBV_CORRECT["cbv_type"],
              cbv_indices=CBV_CORRECT["cbv_indices"], verbose=False)
    out = []
    for tic in HTTP_CBV_TARGETS:
        path = local[cbv_target_name(tic)]
        rows = search_lightcurve(str(tic), radius=HTTP_CBV_RADIUS,
                                 mission="TESS",
                                 limit=HTTP_CBV_NEIGHBOURS + 1,
                                 author=("Kepler", "K2", "SPOC"),
                                 transport=transport).table
        _, given, _ = cbv_correct(path, cbv_dir)
        nb = cone_neighbour_flux(given, rows, tic, local)
        t0 = time.perf_counter()
        with seeded_default_rng(HTTP_CBV_SEED):
            given.correct(neighbor_flux=nb, **kw)
        given_s = time.perf_counter() - t0
        _, fetched, _ = cbv_correct(path, cbv_dir)
        os.environ["LIGHTKURVE_CACHE_DIR"] = os.path.join(
            tmp, f"http_cache_{tic}")
        served = len(archive.downloads)
        t0 = time.perf_counter()
        with seeded_default_rng(HTTP_CBV_SEED), ambient_transport(transport):
            fetched.correct(**kw)
        torch.cuda.synchronize()
        fetched_s = time.perf_counter() - t0
        names = sorted(archive.downloads[served:])
        scores = [tuple(float(x) for x in (c.alpha, c.under_fitting_score,
                                           c.over_fitting_score))
                  for c in (given, fetched)]
        log(f"http, cbv: TIC {tic}: correct() with the {len(nb)} cone "
            f"neighbours' flux given {given_s:.3f}s, fetched over HTTP "
            f"{fetched_s:.3f}s ({len(names)} files served); alpha, under- "
            f"and over-fitting scores {scores[0]} and {scores[1]} [{card}]")
        if scores[0] != scores[1]:
            raise AssertionError(f"http, cbv: TIC {tic}: the fetched "
                                 "neighbours give another correction")
        if names != sorted(r["productFilename"] for r in rows) or \
                len(nb) != HTTP_CBV_NEIGHBOURS:
            raise AssertionError(f"http, cbv: TIC {tic}: the files fetched "
                                 "are not the cone search's")
        out.append((given_s, fetched_s))
    return out


def http_plots(tmp, card):
    """Phase 18 (c): the plots (matplotlib) and the exports and the SkyBot
    query (pandas) on this machine, each package on its own.  Where one is
    missing, its calls must raise ``ImportError`` naming it, as the JAX
    package's lazy imports do.  Where matplotlib is installed: a PRF
    photometry of the bench's scene, its model's image and a one-curve BLS
    periodogram made on the card in float64, plotted under Agg and held
    against the same made on the CPU (each array within 1e-6 of its
    largest).  Where pandas is installed: the SkyBot query of a curve
    with one 50-sigma outlier (its mask by ``remove_outliers(sigma=10)``
    on the card, a recorded response) and ``to_pandas()`` of the curve
    flattened on the card, against the same on the CPU, float64 both
    (frames equal; the flux within 1e-9).  Returns what was missing."""
    import importlib.util
    import torch
    from lightkurve_tpu_torch import LightCurve
    missing = [m for m in ("matplotlib", "pandas")
               if importlib.util.find_spec(m) is None]
    rng = np.random.default_rng(ARC_SEED + 19)
    t = 2459000.0 + np.arange(2000) * (2.0 / 60 / 24)
    flux = 1 + 1e-3 * rng.standard_normal(t.size)
    flux[np.mod(t, 3.3) < 0.1] -= 4e-3
    flux[777] += 0.05
    lc = LightCurve(time=t, flux=flux, flux_err=np.full(t.size, 1e-3))
    lc.meta.update(RA=84.2, DEC=-72.2, MISSION="TESS")
    skybot = ("# Flag: 1\n# Count: 1\n# Num | Name | RA(h) | DE(deg) | "
              "Class | Mv | Err(arcsec) | d(arcsec)\n 138846 | 2000 VJ61 | "
              "5.61 | -72.23 | MB>Outer | 16.6 | 0.1 | 21.0\n")

    def sso():
        return lc.query_solar_system_objects(
            sigma=10, return_mask=True, fetch=lambda url: skybot)

    calls = {"matplotlib": [("LightCurve.plot", lc.plot)],
             "pandas": [("LightCurve.to_pandas", lc.to_pandas),
                        ("LightCurve.query_solar_system_objects", sso)]}
    for pkg in missing:
        log(f"http, plots: {pkg} is not installed on this machine, so its "
            f"calls are not run here: they must raise ImportError naming "
            f"it (the CPU tests hold them against lightkurve_tpu's)")
        for name, call in calls[pkg]:
            try:
                call()
            except ImportError as exc:
                if pkg not in str(exc):
                    raise AssertionError(f"{name}: ImportError without "
                                         f"{pkg}: {exc}")
                log(f"http, plots: {name} raises ImportError without {pkg} "
                    f"({exc})")
            else:
                raise AssertionError(f"{name} ran without {pkg}")
    if "pandas" not in missing:
        got = {}
        for device in ("cuda", "cpu"):
            with port_on(device, torch.float64):
                got[device] = (sso(), lc.flatten(
                    window_length=101).to_pandas())
        (a, mask_a), frame_a = got["cuda"]
        (b, mask_b), frame_b = got["cpu"]
        if not (a.equals(b) and np.array_equal(mask_a, mask_b)
                and mask_a.sum() == 1 and mask_a[777]):
            raise AssertionError("http, exports: the card's SkyBot query "
                                 "differs from the CPU's")
        if list(frame_a.columns) != list(frame_b.columns) or \
                not np.array_equal(frame_a.index, frame_b.index) or \
                np.nanmax(np.abs(frame_a["flux"].to_numpy(float)
                                 - frame_b["flux"].to_numpy(float))) > 1e-9:
            raise AssertionError("http, exports: the card's to_pandas() "
                                 "differs from the CPU's")
        log(f"http, exports: the SkyBot query (outlier mask on the card) and "
            f"to_pandas() of the card's flatten equal the CPU's (float64 "
            f"both) [{card}]")
    if "matplotlib" not in missing:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from lightkurve_tpu_torch.prf import GaussianPRF, PRFPhotometry

        def data(ax):
            out = [line.get_xydata() for line in ax.get_lines()]
            out += [np.ma.filled(np.ma.asarray(im.get_array(), float),
                                 np.nan) for im in ax.get_images()]
            return out

        img = prf_scene_model().predict_from_array(
            torch.as_tensor(PRF_TRUTH)).numpy()
        cube = img[None] + PRF_NOISE * rng.standard_normal((16,) + img.shape)
        made = {}
        for device in ("cuda", "cpu"):
            with port_on(device, torch.float64):
                model = prf_scene_model()
                phot = PRFPhotometry(model)
                phot.run(cube, n_iter=5)
                pg = lc.to_periodogram("bls", period=np.linspace(1, 5, 500),
                                       duration=[0.05, 0.1])
                made[device] = dict(
                    prf=GaussianPRF(shape=(9, 9)).plot(), model=model.plot(),
                    results=phot.plot_results()[0], pg=pg.plot())
        for key in made["cpu"]:
            for x, y in zip(data(made["cuda"][key]), data(made["cpu"][key])):
                if x.shape != y.shape or np.nanmax(np.abs(x - y)) > \
                        1e-6 * np.nanmax(np.abs(y)):
                    raise AssertionError(f"http, plots: the card's {key} "
                                         "plot differs from the CPU's")
        plt.close("all")
        log(f"http, plots: the card's PRF, scene model, fit results and BLS "
            f"periodogram plots equal the CPU's [{card}]")
    return dict(missing=missing)


def phase_http(tmp, card, sweep, runs, arc):
    """Phase 18, inside :func:`archive_env`, each part a path of its own,
    with a :class:`MashupArchive` serving phase 16's files and phase 14's
    CBV targets: (a) the search -> download -> stitch -> stack -> BLS
    path over HTTP (the launches the route rule gives, through
    ``sweep``), then its call 4 on both routes (:func:`pixel_routes`) and
    K-WF, K-SF and K-W against their plain versions there
    (:func:`check_pixel_kernels`); (b) ``correct()`` with the neighbours
    fetched over HTTP; (c) the plots and exports (no kernel may launch in
    b or c).  Adds the paths' launches to ``runs``; returns the numbers
    and the kernels' errors."""
    import torch
    t0 = time.time()
    none = tuple(kernel_table())
    cbv_paths = [os.path.join(tmp, "cbv_lc", cbv_target_name(i))
                 for i in range(CBV_B)]
    observations, products, resolver, local = http_tables(arc["files"],
                                                          cbv_paths)
    out = {}
    with archive_env(tmp), MashupArchive(observations, products, resolver,
                                         local, fail=HTTP_FAIL) as archive:
        log(f"http: a Mashup server on {archive.mashup_url} with "
            f"{len(observations)} observations, {len(products)} products")
        out["search"] = sweep("archive over HTTP -> search (phase 18)",
                              http_search, tmp, archive, arc, card)
        flat = out["search"].pop("flat")
        call4 = np.linspace(*TWO_SECTOR_GRID)[3072:]
        runs.update(pixel_routes(flat, call4, "archive over HTTP", 18))
        errs = check_pixel_kernels(flat, call4[-PIX_KERNEL_PERIODS:],
                                   "archive over HTTP")
        del flat
        torch.cuda.empty_cache()
        out["cbv"], runs["CBV neighbours over HTTP (phase 18)"] = drive(
            "CBV neighbours over HTTP (phase 18)", http_cbv, tmp, archive,
            local, card, forbid=none)
    out["plots"], runs["plots and exports (phase 18)"] = drive(
        "plots and exports (phase 18)", http_plots, tmp, card, forbid=none)
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    log(f"phase 18: {out['seconds']:.1f}s")
    return out, errs


# ---------------------------------------------------------------------------
# phase 19: the port's drivers, the bench and the north-star search
# ---------------------------------------------------------------------------
#: the bench's longest periods at which phase 19 holds K-F and K-WF
BENCH_KERNEL_PERIODS = 256
#: the north-star run's --max-seconds (its watchdog adds 300 s)
NS_MAX_SECONDS = 900


def bench_call_launches(periods, curves, uniform):
    """What the route rule gives one of the bench's calls
    (``bench.bls_call``) in float32: uniform calls one per 128-row tile
    group of the periods (``bucket=True``), weighted ones one for all."""
    import torch
    from lightkurve_tpu_torch.ops.bls import _bucket_periods
    from lightkurve_tpu_torch.parallel.checkpoint import _k_max
    p = np.asarray(periods).astype(np.float32)
    d_phase = float(DURATIONS.astype(np.float32).min()) / OVERSAMPLE
    groups = ([idx for idx, _ in _bucket_periods(
        p, d_phase, _k_max(DURATIONS, d_phase))[0]] if uniform
        else [np.arange(len(p))])
    return route_launches([p[idx] for idx in groups], curves, not uniform,
                          torch.float32, torch.device("cuda"), 8)


def add_launches(total, more, times=1):
    for k, v in more.items():
        total[k] += times * v
    return total


def bench_expected_launches(B, N, P):
    """The launches of ``bench.run()`` at B curves, N cadences and P
    periods by the route rule: the primary's warm-up and timed calls;
    bls_cliff's uniform, weighted and ragged cases (a warm-up and a timed
    call each) over a quarter of the periods; bls_bucketed's two sweeps of
    that quarter, one call per time grid of B/4 curves."""
    import torch
    from lightkurve_tpu_torch import bench
    periods = bench.primary_inputs(1, N, P)["periods"]
    quarter = periods[:max(P // 4, bench.CLIFF_MIN_P)]
    want = dict.fromkeys(kernel_table(), 0)
    add_launches(want, bench_call_launches(periods, B, True),
                 1 + bench.PRIMARY_REPS)
    add_launches(want, bench_call_launches(quarter, B, True), 2)
    add_launches(want, bench_call_launches(quarter, B, False), 2)
    add_launches(want, bench_call_launches(quarter, bench.CLIFF_RAGGED,
                                           False), 2)
    grid = route_launches([quarter.astype(np.float32)], B // 4, False,
                          torch.float32, torch.device("cuda"), 8)
    return add_launches(want, grid, 4 * 2)


def phase_bench():
    """Phase 19 (a): ``bench.run()`` at its full default shape (raises if
    a companion failed).  Fails unless the primary found the injected
    period and the PRF fit the two stars; prints the bench's JSON line.
    Returns the line and the launches the route rule gives."""
    from lightkurve_tpu_torch import bench
    t0 = time.time()
    line = bench.run()
    d = line["detail"]
    errors = [k for k in d if k.endswith("_error")]
    if errors or not d["recovered_period_ok"] or not d[
            "prf_two_star_flux_ok"]:
        raise AssertionError(f"bench: errors {errors}, recovered "
                             f"{d['recovered_period_ok']}, PRF two stars "
                             f"{d['prf_two_star_flux_ok']}")
    log(f"bench: {line['value']:.6g} {line['unit']} (B={d['B']} "
        f"N={d['N']} P={d['P']}, best of {d['step_times_all_reps']} s; "
        f"vs_baseline {line['vs_baseline']:.6g}, K-F mfu {d['bls_mfu']}, "
        f"membw {d['bls_membw_frac']}); {time.time() - t0:.1f}s")
    print(json.dumps(line), flush=True)
    return dict(line=line, routes=bench_expected_launches(d["B"], d["N"],
                                                         d["P"]))


def check_bench_kernels():
    """K-F and K-WF against their plain versions on the inputs the bench's
    calls give them at its primary's :data:`BENCH_KERNEL_PERIODS` longest
    periods: the primary's (uniform) and bls_cliff's weighted case's,
    caught before the scan (:func:`caught_scan`).  Returns each kernel's
    max |power error|."""
    import torch
    from lightkurve_tpu_torch import bench
    from lightkurve_tpu_torch.ops import bls_fused as bf
    from lightkurve_tpu_torch.ops import bls_fused_weighted as bfw
    ctx = bench.make_context()
    pvals = ctx.periods[-BENCH_KERNEL_PERIODS:]
    dy_var = bench.weighted_dy(ctx)
    errs = {}
    for key, scan, kern, plain, dy, uniform in (
            ("K-F", "fused_scan_uniform", bf.fused_scan_uniform,
             bf.fused_scan_uniform_plain, ctx.dy, True),
            ("K-WF", "fused_scan_weighted", bfw.fused_scan_weighted,
             bfw.fused_scan_weighted_plain, dy_var, False)):
        args, kw = caught_scan(scan, lambda: bench.bls_call(
            ctx, ctx.flux, dy, pvals, uniform))
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        errs[key] = compare(f"{key} bench, {len(pvals)} longest periods",
                            got, want, False)[0]
        del got, want, args, kw
    torch.cuda.empty_cache()
    return errs


def phase_northstar(tmp):
    """Phase 19 (b): the north-star search at its full shape through its
    entry point, ``northstar_run.main``: the sector's 10,240 files written
    by ``make_sector.ensure_sector`` first (timed), then five batches of
    2048 x 100,000 periods in fits mode.  Fails unless it recovers
    RECOVERY_SHARE of the injected periods; prints the record's rates.
    Returns the record and the launches the route rule gives (one fused
    launch a chunk)."""
    import torch
    from lightkurve_tpu_torch.tools import make_sector as ms
    from lightkurve_tpu_torch.tools import northstar_run as ns
    sector, state = os.path.join(tmp, "ns_sector"), os.path.join(tmp,
                                                                 "ns_state")
    t0 = time.time()
    paths = ms.ensure_sector(sector, ns.N_CURVES_TOTAL // ms.BATCH,
                             verbose=False)
    write_s = time.time() - t0
    log(f"north-star: wrote {len(paths)} FITS files in {write_s:.1f}s")
    code = ns.main(["--sector-dir", sector, "--state-dir", state,
                    "--max-seconds", str(NS_MAX_SECONDS)])
    path = os.path.join(state, "NORTHSTAR.json")
    if code or not os.path.exists(path):
        raise AssertionError(f"north-star: exit {code}, no record")
    with open(path) as f:
        record = json.load(f)
    keys = ("curve_period_evals_per_sec_per_chip",
            "steady_state_evals_per_sec_per_chip", "wall_clock_s",
            "load_wait_s", "hbm_growth_bytes", "recovery_rate",
            "batch_seconds", "load_wait_seconds",
            "hbm_live_bytes_per_batch", "native_fits_loader", "card")
    summary = {k: record[k] for k in keys}
    summary["sector_write_s"] = write_s
    log(f"north-star: {record['curves']} curves x {record['period_grid']} "
        f"periods: {summary}")
    print(json.dumps({"northstar": summary}), flush=True)
    if record["recovery_rate"] < RECOVERY_SHARE:
        raise AssertionError(f"north-star recovery {record['recovery_rate']}"
                             f" < {RECOVERY_SHARE}")
    t = ms.time_grid()
    periods = np.linspace(1.0, (t[-1] - t[0]) / 3, ns.P_GRID)
    chunks = [periods[lo:lo + ns.CHUNK_PERIODS]
              for lo in range(0, ns.P_GRID, ns.CHUNK_PERIODS)]
    batches = record["curves"] // ns.RUN_BATCH
    want = add_launches(dict.fromkeys(kernel_table(), 0), route_launches(
        chunks, ns.RUN_BATCH, False, torch.float32, torch.device("cuda"), 8,
        ns.CHUNK_PERIODS), batches)
    if want["K-F"] != 8 * batches or sum(want.values()) != want["K-F"]:
        raise AssertionError(f"north-star: the route rule gives {want}, "
                             "not 8 K-F launches a batch")
    return dict(record=record, write_s=write_s, routes=want)


def phase_drivers(tmp, sweep):
    """Phase 19: (a) the bench (:func:`phase_bench`) and (b) the north-star
    search (:func:`phase_northstar`), each a path whose launches must be
    the route rule's (``sweep``); then K-F and K-WF against their plain
    versions on the bench's inputs (:func:`check_bench_kernels`).  Returns
    the numbers and the kernels' errors."""
    import torch
    t0 = time.time()
    out = {"bench": sweep("bench (phase 19 a)", phase_bench)}
    torch.cuda.empty_cache()
    errs = check_bench_kernels()
    out["northstar"] = sweep("north-star search (phase 19 b)",
                             phase_northstar, tmp)
    out["seconds"] = time.time() - t0
    log(f"phase 19: {out['seconds']:.1f}s")
    return out, errs


# ---------------------------------------------------------------------------
# phase 17: the multi-rank slice, four gloo ranks on the one card
# ---------------------------------------------------------------------------
MR_RANKS = 4
MR_PARTS = ("a", "b", "c", "d")
#: (b)'s batch, which the four ranks do not divide, and its Lomb-Scargle
#: frequencies (the bench's LS shape)
MR_RAGGED_B = 2049
#: the reference dry run's bars for a sharded search and Lomb-Scargle
#: against the unsharded call (__graft_entry__.py:215-219, :231-234)
MR_BLS_RTOL = 1e-6
MR_LS_RTOL, MR_LS_ATOL = 1e-5, 1e-8
#: (c): the longest periods of the two-sector sweep's chunk 4 (the staged
#: route at 2048 curves)
MR_STAGED_PERIODS = 256
#: (d): targets, and the sharded PLD's largest gap from the unsharded one
#: in float32 ulps of each corrected value: both solves run in float64 (C4)
#: on batches of other sizes and differ by their rounding, and the result
#: is rounded once to float32, so a value may round the other way (the
#: bar first set, 1e-9 of the median flux, lay below float32's resolution)
MR_PLD_B = 128
MR_PLD_ULPS = 1
#: the staged route's periods per launch in a sharded call (the entry
#: point's default chunk, which sharded_bls keeps)
MR_LAUNCH_PERIODS = 16


@contextlib.contextmanager
def first_call(module, name, seen):
    """Keep, in ``seen[name]``, the arguments of the first call of
    ``module.name`` inside the block; every call still runs, and counts."""
    orig = getattr(module, name)

    def keep(*args, **kw):
        seen.setdefault(name, (args, kw))
        return orig(*args, **kw)

    setattr(module, name, keep)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def counted(fn):
    """``fn()`` on this rank with every launch and plain-call count set to
    0 just before it and read just after: (result, launches, plain calls,
    seconds to the end of its device work)."""
    import torch
    from lightkurve_tpu_torch.parallel.launch import (kernel_counts,
                                                       reset_kernel_counts)
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, calls = kernel_counts()
    return out, launches, calls, secs


def ragged_sector(B=MR_RAGGED_B):
    """Phase 3's sector kind in memory: B curves of
    ``make_sector.batch_flux`` on its time grid (8,192 two-minute
    cadences), one dy per curve; returns the times, the float32 fluxes and
    dy as host arrays."""
    from lightkurve_tpu_torch.tools import make_sector as ms
    t = ms.time_grid()
    flux = np.concatenate([ms.batch_flux(ib, t)[0]
                           for ib in range(-(-B // ms.BATCH))])[:B]
    return t, flux.astype(np.float32), np.full(flux.shape, ms.NOISE,
                                               np.float32)


def multirank_a(directory, out, lead):
    """Part (a) on this rank: phase 10's sector, ``sharded_flatten`` on a
    2x2 mesh, then ``SweepRunner(mesh=...)`` over :data:`LONG_GRID` in four
    chunks, uninterrupted and killed after two chunks then resumed
    (``parallel.dryrun.mesh_sweep``).  Rank 0 saves the trend for the
    parent and holds its first K-WF call against the plain version."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.config import numpy_dtype
    from lightkurve_tpu_torch.ops import bls
    from lightkurve_tpu_torch.ops import bls_fused_weighted as bfw
    from lightkurve_tpu_torch.parallel.dryrun import mesh_sweep
    from lightkurve_tpu_torch.parallel.grid import make_mesh, sharded_flatten
    mesh = make_mesh(2, 2)
    arrays, _, _ = flatten_arrays(2048)
    stack = LightCurveStack.from_numpy(*arrays, device=mesh.device,
                                       dtype=torch.float32)
    del arrays
    periods = np.linspace(*LONG_GRID)
    chunk = 1024

    def run():
        t0 = time.perf_counter()
        with torch_default_tf32():
            trend, _ = sharded_flatten(stack.time, stack.flux, stack.mask,
                                       mesh=mesh, **FLATTEN_KW)
        torch.cuda.synchronize()
        flatten_s = time.perf_counter() - t0
        flat = stack._replace(flux=stack.flux / trend,
                              flux_err=stack.flux_err / trend)
        sweep = mesh_sweep(flat, periods, DURATIONS, directory, mesh,
                           tag="flatten_search", chunk_periods=chunk,
                           method="shared", async_save=True)
        return trend, flat, sweep, flatten_s

    seen = {}
    with first_call(bls, "fused_scan_weighted", seen):
        (trend, flat, sweep, flatten_s), *counts = counted(run)
    gi = mesh.coordinate[1]
    half = chunk // mesh.shape["grid"]
    blocks = [c[gi * half:(gi + 1) * half] for c in (
        periods[lo:lo + chunk].astype(numpy_dtype(torch.float32))
        for lo in range(0, len(periods), chunk))]
    # the uninterrupted sweep's four chunks, then the killed and resumed
    # runs' two each
    out["want"]["a"] = route_launches(
        blocks * 2, -(-len(stack) // mesh.shape["targets"]),
        not is_uniform(flat), flat.flux.dtype, flat.device,
        MR_LAUNCH_PERIODS)
    out["launches"]["a"], out["calls"]["a"], out["seconds"]["a"] = counts
    out["a"] = dict(uninterrupted=sweep["uninterrupted"],
                    resumed=sweep["resumed"],
                    chunk_seconds=sweep["chunk_seconds"],
                    gather_seconds=sweep["gather_seconds"],
                    flatten_s=flatten_s)
    if lead:
        np.save(os.path.join(directory, "trend.npy"), trend.cpu().numpy())
        if "fused_scan_weighted" not in seen:
            raise AssertionError("multi-rank (a): rank 0 never called K-WF")
        args, kw = seen.pop("fused_scan_weighted")
        log(f"multi-rank (a) rank 0, first K-WF call: B={args[1].shape[1]} "
            f"N={args[1].shape[0]} P={args[3].shape[0]}")
        out["errs"]["K-WF"] = compare(
            "K-WF multi-rank (a) rank 0", bfw.fused_scan_weighted(
                *args, **kw), bfw.fused_scan_weighted_plain(*args, **kw),
            False)[0]
    del stack, flat, trend, seen


def multirank_b(out, lead):
    """Part (b) on this rank: a 4x1 mesh over :func:`ragged_sector`'s 2049
    uniform curves, ``sharded_bls`` over 4,096 periods and
    ``sharded_lombscargle`` at the bench's 16,384 frequencies; rank 0 holds
    both against the unsharded calls (the reference dry run's bars) and
    its K-F call against the plain version."""
    import torch
    from lightkurve_tpu_torch.ops import bls
    from lightkurve_tpu_torch.ops import bls_fused as bfu
    from lightkurve_tpu_torch.ops.lombscargle import lombscargle_fast
    from lightkurve_tpu_torch.parallel.grid import (make_mesh, sharded_bls,
                                                    sharded_lombscargle)
    mesh = make_mesh(MR_RANKS, 1)
    t, flux_np, dy = ragged_sector()
    y = torch.as_tensor(flux_np, device=mesh.device)
    times = torch.as_tensor(np.tile(t, (len(flux_np), 1)),
                            dtype=torch.float32, device=mesh.device)
    grid = np.linspace(1.0, (t[-1] - t[0]) / 3, 4096).astype(np.float32)
    durs = DURATIONS.astype(np.float32)
    df = 60.0 / LS_BENCH_NF / float(t[-1] - t[0] + 1)

    def run():
        # dy as a host array: the search reads the uniform regime from it
        res = sharded_bls(times, y, dy, grid, durs, oversample=OVERSAMPLE,
                          mesh=mesh)
        ls = sharded_lombscargle(t, y, dy, 0.05, df, LS_BENCH_NF, mesh=mesh)
        return res, ls

    seen = {}
    with first_call(bls, "fused_scan_uniform", seen):
        (res, ls), *counts = counted(run)
    out["launches"]["b"], out["calls"]["b"], out["seconds"]["b"] = counts
    out["want"]["b"] = route_launches(
        [grid], -(-MR_RAGGED_B // MR_RANKS), False, torch.float32,
        mesh.device, MR_LAUNCH_PERIODS)
    if not lead:
        return
    ref = bls.bls_power_shared_batch(times[0], y, dy, grid, durs,
                                     oversample=OVERSAMPLE)
    got_p, want_p = res["power"].cpu().numpy(), ref["power"].cpu().numpy()
    same = all(torch.equal(res[k], ref[k]) for k in ref)
    log(f"multi-rank (b): sharded_bls B={MR_RAGGED_B} over {MR_RANKS} "
        f"ranks against the unsharded call: max |power gap| "
        f"{float(np.abs(got_p - want_p).max()):.3g} "
        f"({'equal bits' if same else 'not bit-equal'}; bar rtol = atol = "
        f"{MR_BLS_RTOL:g})")
    np.testing.assert_allclose(got_p, want_p, rtol=MR_BLS_RTOL,
                               atol=MR_BLS_RTOL,
                               err_msg="multi-rank (b): sharded BLS")
    ls_ref = lombscargle_fast(t, y, 0.05, df, LS_BENCH_NF, dy=dy,
                              normalization="psd")
    gap = float(((ls - ls_ref).abs() / ls_ref.abs()).max())
    log(f"multi-rank (b): sharded_lombscargle Nf={LS_BENCH_NF} against "
        f"the unsharded call: max relative gap {gap:.3g} "
        f"({'equal bits' if torch.equal(ls, ls_ref) else 'not bit-equal'};"
        f" bar rtol {MR_LS_RTOL:g}, atol {MR_LS_ATOL:g})")
    np.testing.assert_allclose(ls.cpu().numpy(), ls_ref.cpu().numpy(),
                               rtol=MR_LS_RTOL, atol=MR_LS_ATOL,
                               err_msg="multi-rank (b): sharded LS")
    args, kw = seen["fused_scan_uniform"]
    out["errs"]["K-F"] = compare(
        "K-F multi-rank (b) rank 0", bfu.fused_scan_uniform(*args, **kw),
        bfu.fused_scan_uniform_plain(*args, **kw), False)[0]


def multirank_c(out, lead):
    """Part (c) on this rank: a 1x4 mesh over the two-sector stack (2048 x
    38,880), ``sharded_bls`` over the :data:`MR_STAGED_PERIODS` longest
    periods of its chunk 4 (the staged route: K-SF and K-U); rank 0 holds
    the winners against the unsharded call (C2), K-SF against the float64
    fold and K-U against its plain version on its first calls' inputs."""
    import torch
    from lightkurve_tpu_torch.ops import bls, bls_window
    from lightkurve_tpu_torch.parallel.grid import make_mesh, sharded_bls
    mesh = make_mesh(1, MR_RANKS)
    stack, _ = long_sector_stack(2048, n_sectors=2, p_max=17.0)
    periods = np.linspace(*TWO_SECTOR_GRID)[-MR_STAGED_PERIODS:].astype(
        np.float32)
    durs = DURATIONS.astype(np.float32)

    def run():
        return sharded_bls(stack.time, stack.flux, stack.flux_err, periods,
                           durs, oversample=OVERSAMPLE, mesh=mesh,
                           uniform_weights=True)

    seen = {}
    with first_call(bls, "staged_fold", seen), \
            first_call(bls, "window_scan_uniform", seen):
        res, *counts = counted(run)
    out["launches"]["c"], out["calls"]["c"], out["seconds"]["c"] = counts
    gi, per = mesh.coordinate[1], MR_STAGED_PERIODS // MR_RANKS
    out["want"]["c"] = route_launches(
        [periods[gi * per:(gi + 1) * per]], len(stack), False,
        torch.float32, mesh.device, MR_LAUNCH_PERIODS)
    if not lead:
        return
    ref = bls.bls_power_shared_batch(stack.time[0], stack.flux,
                                     stack.flux_err, periods, durs,
                                     oversample=OVERSAMPLE,
                                     uniform_weights=True)
    route_gaps("multi-rank (c) sharded vs unsharded",
               {k: v.cpu().numpy() for k, v in res.items()},
               {k: v.cpu().numpy() for k, v in ref.items()},
               stack.shape[1])
    del ref, res
    (ts, Yc, pc, d_phase, nbins, max_nbp, k_max, wrap), _ = seen[
        "staged_fold"]
    out["errs"]["K-SF"], _ = fold_against_f64(
        "K-SF multi-rank (c) rank 0", ts, Yc, pc, d_phase, nbins, max_nbp,
        k_max, wrap, MR_LAUNCH_PERIODS)
    args, kw = seen["window_scan_uniform"]
    out["errs"]["K-U"] = compare(
        "K-U multi-rank (c) rank 0", bls_window.window_scan_uniform(
            *args, **kw), bls_window.window_scan_uniform_plain(*args, **kw),
        False)[0]


def multirank_d(out, lead):
    """Part (d) on this rank: a 4x1 mesh over :data:`MR_PLD_B` of phase 13's
    pixel targets, ``sharded_pld_photometry`` (32 targets a rank); rank 0
    holds it against the unsharded ``pld_correct``: equal masks, every
    corrected flux and error within :data:`MR_PLD_ULPS` float32 ulps of
    the unsharded value."""
    import torch
    from lightkurve_tpu_torch.parallel.grid import (make_mesh,
                                                    sharded_pld_photometry)
    mesh = make_mesh(MR_RANKS, 1)
    tpf, _ = pixel_sector(MR_PLD_B, PIX_SEED, mesh.device)
    (f, e, m), *counts = counted(
        lambda: sharded_pld_photometry(tpf, mesh=mesh, **PIX_PLD))
    out["launches"]["d"], out["calls"]["d"], out["seconds"]["d"] = counts
    out["want"]["d"] = dict.fromkeys(kernel_table(), 0)
    if not lead:
        return
    ref = tpf.pld_correct(**PIX_PLD)
    scale = float(ref.flux.double().abs().median())

    def ulps(got, want):
        want = want.cpu().numpy()
        return float(np.max(np.abs(got.cpu().numpy() - want)
                            / np.spacing(np.abs(want))))

    gap = float((f.double() - ref.flux.double()).abs().max()) / scale
    flux_ulps, err_ulps = ulps(f, ref.flux), ulps(e, ref.flux_err)
    differ = int((f != ref.flux).sum())
    log(f"multi-rank (d): sharded_pld_photometry of {MR_PLD_B} targets x "
        f"{f.shape[1]} cadences against pld_correct: {differ} of "
        f"{f.numel()} corrected values differ, by at most {flux_ulps:g} "
        f"float32 ulps (bar {MR_PLD_ULPS}; largest gap {gap:.3g} of the "
        f"median flux), flux_err by {err_ulps:g} ulps, masks "
        f"{'equal' if torch.equal(m, ref.mask) else 'DIFFERENT'}")
    if max(flux_ulps, err_ulps) > MR_PLD_ULPS or not torch.equal(
            m, ref.mask):
        raise AssertionError("multi-rank (d): sharded PLD differs")


def multirank_rank(directory):
    """One of phase 17's ranks (every rank runs it, ``directory`` shared):
    parts (a)-(d), each with this rank's launch and plain-call counts set
    to 0 just before it and read just after (:func:`counted`), and the
    launches the route rule gives this rank's shard; rank 0 also holds
    the kernels against their plain versions and the sharded calls
    against the unsharded ones.  Returns this rank's numbers."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    lead = dist.get_rank() == 0
    out = {k: {} for k in ("launches", "calls", "want", "seconds", "errs")}
    multirank_a(directory, out, lead)
    torch.cuda.empty_cache()
    multirank_b(out, lead)
    torch.cuda.empty_cache()
    multirank_c(out, lead)
    torch.cuda.empty_cache()
    multirank_d(out, lead)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def check_multirank_sweep(directory, reports):
    """Part (a) in the parent: every rank holds the same states, the
    resumed state equals the uninterrupted one bit for bit, the trend's
    largest gap from the unsharded flatten of the same arrays is logged,
    and the unsharded sweep of the same flattened flux gives the same
    winning period on >= 99.9% of curves with every power gap within C2's
    bound; recovery >= 99%.  Returns (a)'s numbers."""
    import torch
    from lightkurve_tpu_torch.batch import LightCurveStack
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from lightkurve_tpu_torch.parallel.checkpoint import _FIELDS
    parts = [r["result"]["a"] for r in reports]
    a = parts[0]
    for f in _FIELDS:
        for p in parts:
            for run in ("uninterrupted", "resumed"):
                if not np.array_equal(p[run][f], a[run][f], equal_nan=True):
                    raise AssertionError(f"multi-rank (a): ranks hold "
                                         f"different {run} {f}")
        if not np.array_equal(a["resumed"][f], a["uninterrupted"][f],
                              equal_nan=True):
            raise AssertionError(f"multi-rank (a): kill/resume mismatch in "
                                 f"{f}")
    arrays, p_inj, _ = flatten_arrays(2048)
    stack = LightCurveStack.from_numpy(*arrays, device="cuda",
                                       dtype=torch.float32)
    del arrays
    with torch_default_tf32():
        _, whole = stack.flatten(return_trend=True, **FLATTEN_KW)
    trend = torch.as_tensor(np.load(os.path.join(directory, "trend.npy")),
                            device="cuda")
    gap = float(((trend - whole.flux).abs() / whole.flux.abs()).max())
    bits = "equal bits" if torch.equal(trend, whole.flux) else "not bit-equal"
    log(f"multi-rank (a): sharded trend against the unsharded flatten of "
        f"the same arrays: largest relative gap {gap:.3g} ({bits})")
    del whole
    flat = stack._replace(flux=stack.flux / trend,
                          flux_err=stack.flux_err / trend)
    periods = np.linspace(*LONG_GRID)
    ref = SweepRunner(flat, periods, DURATIONS,
                      os.path.join(directory, "unsharded.npz"),
                      chunk_periods=1024, method="shared").run()
    got = a["uninterrupted"]
    share = float((got["period"] == ref["period"]).mean())
    log(f"multi-rank (a): winners against the unsharded sweep of the same "
        f"flattened flux: the same period on {share:.6f} of "
        f"{len(stack)} curves (bar {F32_WINNER_SHARE})")
    if share < F32_WINNER_SHARE:
        raise AssertionError("multi-rank (a): winners differ from the "
                             "unsharded sweep")
    route_gaps("multi-rank (a) sharded vs unsharded", got, ref,
               stack.shape[1], keys=("period", "duration", "transit_time"))
    rec = recovery(got["period"], p_inj)
    sweep_s = max(sum(p["chunk_seconds"]) for p in parts)
    rate = len(stack) * len(periods) / sweep_s
    log(f"multi-rank (a): flatten {max(p['flatten_s'] for p in parts):.3f}s"
        f" (slowest rank), sweep {sweep_s:.3f}s on the slowest rank "
        f"({rate:.6g} curve-period evals/s; phase 10 unsharded: see its "
        f"line); recovered {rec:.4f}")
    for r, p in enumerate(parts):
        log(f"multi-rank (a) rank {r}: chunk seconds "
            f"{[round(x, 4) for x in p['chunk_seconds']]}, gather seconds "
            f"{[round(x, 4) for x in p['gather_seconds']]} (share "
            f"{sum(p['gather_seconds']) / sum(p['chunk_seconds']):.3f})")
    if rec < RECOVERY_SHARE:
        raise AssertionError(f"multi-rank (a) recovery {rec} < "
                             f"{RECOVERY_SHARE}")
    return dict(rate=rate, recovered=rec, sweep_s=sweep_s,
                gather_share=max(sum(p["gather_seconds"])
                                 / sum(p["chunk_seconds"]) for p in parts))


def phase_multirank(tmp, runs):
    """Phase 17: four gloo ranks on the one card
    (``parallel.launch.run_ranks``; the kernels were built by phase 1, so
    the ranks only load them): :func:`multirank_rank`'s parts (a)-(d),
    each rank's part a path of its own whose launches must be what the
    route rule gives its shard and whose plain versions must not run;
    (a)'s checks against the unsharded path in the parent
    (:func:`check_multirank_sweep`); then (e) ``dryrun_multichip(4)`` at
    the reference's sizes, each rank a path of its own.  Adds the paths'
    launches to ``runs``; returns the numbers and the kernels' errors."""
    import torch
    from lightkurve_tpu_torch.parallel.dryrun import dryrun_multichip
    from lightkurve_tpu_torch.parallel.launch import run_ranks
    t_phase = time.time()
    torch.cuda.empty_cache()
    directory = os.path.join(tmp, "multirank")
    os.makedirs(directory)
    reports = run_ranks(MR_RANKS, multirank_rank, directory, timeout=600)
    ranks_s = time.time() - t_phase
    errs = {}
    for r, rep in enumerate(reports):
        res = rep["result"]
        for part in MR_PARTS:
            path = f"multi-rank (phase 17 {part}) rank {r}"
            launches, calls = res["launches"][part], res["calls"][part]
            log(f"{path}: launches {launches}; plain calls {calls}; "
                f"{res['seconds'][part]:.2f}s")
            if any(calls.values()):
                raise AssertionError(f"{path} ran a plain version")
            check_routes(path, res["want"][part], launches)
            runs[path] = launches
        for k, e in res["errs"].items():
            errs[k] = max(errs.get(k, 0.0), e)
    log("multi-rank: peak device memory by rank "
        f"{[round(r['result']['peak_gib'], 3) for r in reports]} GiB")
    out = {"a": check_multirank_sweep(directory, reports)}
    t0 = time.time()
    dry = dryrun_multichip(MR_RANKS)
    for r, rep in enumerate(dry):
        path = f"multi-rank dry run (phase 17 e) rank {r}"
        log(f"{path}: launches {rep['launches']}; plain calls "
            f"{rep['calls']}")
        if any(rep["calls"].values()) or not any(rep["launches"].values()):
            raise AssertionError(f"{path}: a plain version ran, or no "
                                 "kernel launched")
        runs[path] = rep["launches"]
    out["dryrun_s"] = time.time() - t0
    out["ranks_s"] = ranks_s
    out["seconds"] = time.time() - t_phase
    log(f"phase 17: {out['seconds']:.1f}s (ranks (a)-(d) {ranks_s:.1f}s, "
        f"dry run {out['dryrun_s']:.1f}s)")
    torch.cuda.empty_cache()
    return out, errs


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
    from lightkurve_tpu_torch.roofline import (bound_fused, bound_staged_fold,
                                               bound_uniform, bound_weighted,
                                               bound_weighted_fused)
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
    phase 10's search of its flattened sector; phase 10's flatten and
    phase 11's default ``to_periodogram`` call of its raw sector and its
    one-curve fastchi2 call; phase 12's BLS periodogram of one flattened
    curve of that sector (the reference's default grid); phase 13's
    ``pld_correct`` of its 512 targets and ``PLDCorrector.correct()`` of
    one of its TESS files; phase 14's ``correct_gaussian_prior`` and
    ``correct()`` of one CBV target and one giant's seismology chain;
    phase 15's ``extract_prf_photometry`` of one TESS file (device time
    by kind of op); phase 16's search -> ``download_all`` -> ``stitch`` of
    one target of its archive and ``interact_bls(html=...)`` of that
    stitched curve (launches and device time by kind of op); and
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
    from lightkurve_tpu_torch.collections import LightCurveCollection
    from lightkurve_tpu_torch.correctors import PLDCorrector
    from lightkurve_tpu_torch.io.read import read
    from lightkurve_tpu_torch.ops.lombscargle import lombscargle_fastchi2
    from lightkurve_tpu_torch.parallel.checkpoint import SweepRunner
    from lightkurve_tpu_torch.tools import make_sector as ms
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
    one = LightCurveCollection([sector[0]])
    bls_curve = one[0].normalize().remove_outliers().flatten(
        window_length=FLATTEN_KW["window_length"])
    pixels = pixel_sector(PIX_B, PIX_SEED, "cuda")[0]
    tess_file = tess_tpfs(1)[0][0]
    cbv_dir = os.path.join(tmp, "cbv")
    vectors = cbv_vectors(cbv_grid()[1])
    write_cbv_file(cbv_dir, vectors)
    cbv_paths = write_cbv_targets(os.path.join(tmp, "cbv_lc"), cbv_targets(
        vectors, B=CBV_NEIGHBOURS + 1)[0])
    _, cbv_one, _ = cbv_correct(cbv_paths[0], cbv_dir)
    cbv_nb = cbv_neighbour_flux(cbv_one, [
        read(p, flux_column="sap_flux") for p in cbv_paths[1:]])
    giant_path, giant = (v[0] for v in write_seismic_stars(
        os.path.join(tmp, "seis"), giants=1, dwarfs=0))
    giant_lc = read(giant_path)
    archive = archive_files(tmp, card_line())
    archive_lc = archive_target(archive["tics"][0],
                                archive["dir"]).download_all().stitch()
    t8, y8, dy8 = bench_ls_inputs(1)
    curve = LightCurveStack.from_numpy(
        t8[None], y8.cpu().numpy(), dy8.cpu().numpy(),
        np.ones(y8.shape, bool), device="cuda", dtype=torch.float32)
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
             ("to_periodogram, phase 11", sector, (), "periodogram"),
             ("fastchi2, phase 11", curve, (), "fastchi2"),
             ("BLS periodogram, one curve, phase 12", one.to_stack(), (),
              "bls_periodogram"),
             ("flatten -> search, chunk 4", flat,
              np.linspace(*LONG_GRID)[3072:], "auto"),
             ("pld_correct, phase 13", pixels, (), "pld_correct"),
             ("PLDCorrector.correct, one TESS file, phase 13", tess_file,
              (), "pld_corrector"),
             ("CBV correct_gaussian_prior, one target, phase 14",
              cbv_paths[0], (), "cbv_gaussian"),
             ("CBV correct() with the alpha search, one target, phase 14",
              cbv_paths[0], (), "cbv_correct"),
             ("seismology chain, one KEPSEISMIC giant, phase 14", giant_lc,
              (), "seismology"),
             ("extract_prf_photometry, one TESS file, phase 15", tess_file,
              (), "prf"),
             ("search -> download_all -> stitch, one target, phase 16",
              archive, (), "archive"),
             ("interact_bls(html=...), one stitched curve, phase 16",
              archive_lc, (), "explorer"))
    for i, (name, stack, periods, impl) in enumerate(cells):
        def chunk(tag):
            if impl == "flatten":
                stack.flatten(**FLATTEN_KW)
            elif impl == "periodogram":
                stack.to_periodogram()
            elif impl == "fastchi2":
                lombscargle_fastchi2(t8, stack.flux[0], *fastchi2_grid(t8),
                                     FASTCHI2_NF, nterms=FASTCHI2_NTERMS)
            elif impl == "bls_periodogram":
                bls_curve.to_periodogram("bls")
            elif impl == "pld_correct":
                stack.pld_correct(**PIX_PLD)
            elif impl == "pld_corrector":
                PLDCorrector(stack).correct()
            elif impl == "cbv_gaussian":
                cbv_correct(stack, cbv_dir)
            elif impl == "cbv_correct":
                cbv_correct(stack, cbv_dir)[1].correct(
                    cbv_type=CBV_CORRECT["cbv_type"],
                    cbv_indices=CBV_CORRECT["cbv_indices"],
                    neighbor_flux=cbv_nb, verbose=False)
            elif impl == "seismology":
                seismology_chain(stack, giant["teff"])
            elif impl == "prf":
                stack.extract_prf_photometry()
            elif impl == "archive":
                archive_target(stack["tics"][0],
                               stack["dir"]).download_all().stitch()
            elif impl == "explorer":
                stack.interact_bls(html=os.path.join(tmp, f"profile_{tag}"
                                                          ".html"))
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
        kinds = ("periodogram", "fastchi2", "bls_periodogram", "pld_correct",
                 "pld_corrector", "cbv_gaussian", "cbv_correct",
                 "seismology", "prf", "archive", "explorer")
        shape = (f"pixels {tuple(stack.flux.shape)}"
                 if impl in ("pld_correct", "pld_corrector", "prf")
                 else f"one target, {LONG_N} cadences"
                 if impl.startswith("cbv")
                 else f"{len(stack)} cadences" if impl in ("seismology",
                                                           "explorer")
                 else f"one target of {len(stack['tics'])}, 2 files of "
                      f"{LONG_N} cadences" if impl == "archive"
                 else f"B={len(stack)} N={stack.shape[1]} P={len(periods)}")
        log(f"profile {name}: {shape}: device "
            f"{device / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms of "
            f"{wall / 1e3:.3f} ms wall, idle {1 - busy / wall:.4f}; "
            f"{peak_memory()}")
        for k, (us, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            log(f"  {us / 1e3:10.3f} ms {us / device:.4f} x{cnt} {k[:100]}")
        if impl in kinds:
            log(f"  {sum(n for _, n in by_name.values())} launches; by op: "
                + ", ".join(
                f"{k} {us / 1e3:.3f} ms {us / max(device, 1e-9):.4f}"
                for k, us in op_kinds(by_name).items()))
        elif impl != "flatten":
            log("  bounds over the chunk's launches: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in
                chunk_bounds(stack, periods, impl).items()))


def op_kinds(by_name):
    """Device time (us) of a trace's kernels summed by kind: sorts (cub's
    radix sorts), scatters and gathers (``index_add_``, indexing: the
    ``scatter`` kind), FFTs (cuFFT), dense solver
    kernels (QR, SVD, Cholesky, LU: cuSOLVER, MAGMA), matrix products
    (cuBLAS, CUTLASS), reductions, and elementwise ops with copies and the
    rest."""
    kinds = {"sort": 0.0, "scatter": 0.0, "fft": 0.0, "reduction": 0.0,
             "matmul": 0.0, "solver": 0.0, "elementwise": 0.0}
    solver = ("geqrf", "orgqr", "ormqr", "larf", "gesvd", "svd", "potrf",
              "potrs", "getrf", "getrs", "trsm", "trsv", "cusolver", "magma",
              "syevd", "jacobi", "householder", "geqr", "lu_")
    for name, (us, _) in by_name.items():
        low = name.lower()
        kind = ("sort" if "radixsort" in low
                else "scatter" if "index" in low or "scatter" in low
                else "fft" if "fft" in low or "radix" in low
                else "solver" if any(s in low for s in solver)
                else "matmul" if any(s in low for s in (
                    "gemm", "gemv", "xmma", "cutlass", "cublas", "dot_kernel"))
                else "reduction" if "reduce" in low
                else "elementwise")
        kinds[kind] += us
    return kinds


def kernel_table():
    """Each kernel's wrapper (which counts launches) and plain version
    (which counts calls)."""
    from lightkurve_tpu_torch.parallel.launch import kernel_counters
    return kernel_counters()


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


def card_clocks():
    """The card's SM clock, its maximum, power draw and temperature, as
    ``nvidia-smi`` reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


#: ``--cells``: two-sector sweeps a process (its first pays the process's
#: first staged work)
CELLS_SWEEPS = 3


def repeat_cells():
    """``--cells``: phase 11's sector and bench-shape rates and its
    row-order gaps (unchecked, so a version without the float64 sums
    reports its own), then phase 6's two-sector sweep CELLS_SWEEPS times,
    each from a fresh checkpoint, with its launches of the uniform sweep's
    kernels and the card's clocks after it.  Fails if a sweep resumed or
    did not launch both staged kernels.  Prints one JSON line."""
    import torch
    import lightkurve_tpu_torch
    # the uniform sweep's kernels by the wrapper names every version of the
    # port has had (kernel_table needs parallel.launch, which an older
    # checkout lacks)
    from lightkurve_tpu_torch.ops import bls_fused, bls_staged_fold, bls_window
    kernels = {"K-F": bls_fused.fused_scan_uniform,
               "K-SF": bls_staged_fold.staged_fold,
               "K-U": bls_window.window_scan_uniform}
    out = dict(port=os.path.dirname(os.path.dirname(os.path.abspath(
        lightkurve_tpu_torch.__file__))), card=card_line())
    out["ls_sector_rate"] = ls_sector()["rate"]
    out["ls_bench_rate"] = ls_bench_shape()["rate"]
    out["ls_rows"] = ls_rows(check=False)
    torch.cuda.empty_cache()
    stack, p_inj = long_sector_stack(dtype=torch.float32, n_sectors=2,
                                     p_max=17.0)
    periods = np.linspace(*TWO_SECTOR_GRID)
    out["two_sectors"] = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(CELLS_SWEEPS):
            for kern in kernels.values():
                kern.launches = 0
            run = timed_sweep(f"two sectors, run {i}", stack, periods, p_inj,
                              os.path.join(tmp, f"two_{i}.npz"))
            run["launches"] = {k: kern.launches
                               for k, kern in kernels.items()}
            run["clocks"] = card_clocks()
            log(f"two sectors, run {i}: launches {run['launches']}; "
                f"SM clock, max, power, temperature: {run['clocks']}")
            if not (run["launches"]["K-SF"] and run["launches"]["K-U"]):
                raise AssertionError(f"two sectors, run {i}: no staged "
                                     "launch")
            out["two_sectors"].append(run)
    print(json.dumps(out), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one sweep chunk per regime instead "
                             "of the checks")
    parser.add_argument("--ls-f64", action="store_true",
                        help="only phase 11's float64 card-against-CPU "
                             "check, cold in this process (no kernels)")
    parser.add_argument("--cells", action="store_true",
                        help="only phase 11's rates and row order and "
                             "repeated two-sector sweeps, one JSON line")
    parser.add_argument("--port", metavar="DIR",
                        help="with --cells: import lightkurve_tpu_torch "
                             "from this checkout")
    args = parser.parse_args()
    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
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
    if args.ls_f64:
        ls_f64_cold()
        return 0
    phase_build()
    if args.cells:
        repeat_cells()
        return 0
    if args.profile:
        with tempfile.TemporaryDirectory() as tmp, archive_env(tmp):
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
        card = card_line()
        lcs = sweep("LightCurve API (phase 12)", phase_lc_stack, tmp, card)
        check_lc_stack_against_numpy(lcs)
        lcs_numbers = {k: lcs[k] for k in ("files_per_s", "rate")}
        single, _ = drive("LightCurve API, single curves (phase 12)",
                          phase_lc_single, lcs, card,
                          forbid=tuple(kernel_table()))
        del lcs
        torch.cuda.empty_cache()
        px_numbers, files = phase_pixels(tmp, card, sweep, runs)
        px_errs = px_numbers.pop("errs")
        p14, p14_errs = phase_cbv_seismology(tmp, card, sweep, runs)
        prf, prf_errs = phase_prf(tmp, card, sweep, runs)
        arc, arc_errs = phase_archive(tmp, card, sweep, runs)
        h18, h18_errs = phase_http(tmp, card, sweep, runs,
                                   arc.pop("phase18"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        p19, p19_errs = phase_drivers(tmp, sweep)
    torch.cuda.empty_cache()
    ls = phase_ls()
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
    for key, e in (*px_errs.items(), *p14_errs.items(), *prf_errs.items(),
                   *arc_errs.items(), *h18_errs.items(), *p19_errs.items()):
        errs[key] = max(errs[key], e)
    phase_routes()
    with tempfile.TemporaryDirectory() as tmp:
        mr, mr_errs = phase_multirank(tmp, runs)
    for key, e in mr_errs.items():
        errs[key] = max(errs[key], e)
    ns = p19["northstar"]["record"]
    log(f"main paths: uniform {uni['rate']:.6g}, weighted "
        f"{wei['rate']:.6g}, long sector {lng['rate']:.6g}, two sectors "
        f"{two['rate']:.6g}, mixed grids {mix['rate']:.6g}, flatten -> "
        f"search {flt['rate']:.6g} curve-period evals/s (flatten "
        f"{flt['flatten_s']:.3f}s); LightCurve API: read "
        f"{lcs_numbers['files_per_s']:.6g} files/s, search "
        f"{lcs_numbers['rate']:.6g} curve-period evals/s, per curve BLS "
        f"{single['bls_s'] * 1e3:.1f} ms; pixels: photometry + PLD "
        f"{PIX_B / (px_numbers['phot_s'] + px_numbers['pld_s']):.6g} "
        f"targets/s, TPF read {files['files_per_s']:.6g} files/s; CBV "
        f"{1 / p14['per_target_s']:.6g} targets/s, search after CBV "
        f"recovered {p14['recovered_bright']:.4f} of SNR >= {PIX_SNR:g}; "
        f"seismology {p14['seismology']['stars_per_s']:.6g} stars/s, "
        f"recovered {p14['seismology']['recovered']:.4f}; PRF scene "
        f"{prf['scene']['rate']:.6g} cadence-fits/s, TESS file "
        f"{prf['files']['per_file_ms']:.3f} ms, search after PRF recovered "
        f"{prf['search']['recovered']:.4f}, K2 file "
        f"{prf['kepler']['per_file_ms']:.3f} ms; archive: search -> "
        f"download_all -> stitch {arc['search']['targets_per_s']:.6g} "
        f"targets/s ({arc['search']['files_per_s']:.6g} files/s), to_stack "
        f"{arc['search']['stack_s']:.3f}s, search "
        f"{arc['search']['rate']:.6g} curve-period evals/s, recovered "
        f"{arc['search']['recovered']:.4f}, BLS explorer "
        f"{arc['pages']['bls_s']:.3f}s, phase 16 {arc['seconds']:.1f}s; "
        f"archive over HTTP: search -> download_all -> stitch "
        f"{h18['search']['targets_per_s']:.6g} targets/s, CBV correct() "
        f"with fetched neighbours "
        f"{max(f for _, f in h18['cbv']):.3f}s at most, phase 18 "
        f"{h18['seconds']:.1f}s; "
        f"bench {p19['bench']['line']['value']:.6g} curve-period evals/s; "
        f"north-star {ns['curve_period_evals_per_sec_per_chip']:.6g} "
        f"(steady {ns['steady_state_evals_per_sec_per_chip']:.6g}) "
        f"curve-period evals/s, wall {ns['wall_clock_s']:.3f}s, load wait "
        f"{ns['load_wait_s']:.3f}s, recovered {ns['recovery_rate']:.4f}, "
        f"phase 19 {p19['seconds']:.1f}s; "
        f"LS sector "
        f"{ls['sector']['rate']:.6g}, "
        f"LS bench shape {ls['bench']['rate']:.6g} curve-frequency "
        f"evals/s; per-curve fast "
        f"{pcv['fast']['seconds']:.3f}s, exact "
        f"{pcv['exact']['seconds']:.3f}s; multi-rank (phase 17, "
        f"{MR_RANKS} ranks on one card): flatten -> sharded sweep "
        f"{mr['a']['rate']:.6g} curve-period evals/s, gather share "
        f"{mr['a']['gather_share']:.3f}, recovered "
        f"{mr['a']['recovered']:.4f}, phase 17 {mr['seconds']:.1f}s; "
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
