"""The north-star search at its own size: 10,240 TESS-like curves x a
10^5-period BLS grid on one card.

Counterpart of the repository's ``tools/northstar_run.py``.

    python -m lightkurve_tpu_torch.tools.northstar_run [--batches N]
        [--state-dir DIR] [--sector-dir DIR] [--mode fits|synthetic]
        [--max-seconds S] [--record PATH] [--device cpu]

End to end by default (``--mode fits``): the curves are read from the
10,240 files of a synthetic TESS sector on disk (:mod:`.make_sector`,
written first if missing, before the clock starts) through
``StreamingStackLoader`` in :data:`DTYPE` (float32) on the card -- the
C++ column reader, pinned host stacks, and the copy of batch k+1 on a side
stream while batch k is searched -- in :data:`RUN_BATCH`-curve batches, each searched by
``SweepRunner(method="shared", async_save=True)`` over :data:`P_GRID`
periods in [1 d, baseline/3] in chunks of :data:`CHUNK_PERIODS` (one fused
kernel launch, K-F, per chunk on an H100).  The kernel library's build (a
no-op once built) starts on a background thread before the first batch is
read (``prewarm_shared_sweep``).  ``--mode synthetic`` builds the same
batches in memory instead (A/B against the loader), on ``--device``.

Resumable: each batch has a SweepRunner checkpoint under ``--state-dir``
and the run a manifest, so a run stopped by ``--max-seconds`` (checked
between rounds of :data:`CHUNKS_PER_CHECK` chunks) goes on where it
stopped when started again with the same directory.  A manifest of another
mode or batch size, or one without ``mode`` or ``run_batch``, is refused.
A watchdog thread ends the process with code 3 if the run has not
returned ``--max-seconds`` + 300 s after it started (a hung device call
never reaches the check); the state on disk stays resumable.

When every batch is done the record (the JAX driver's fields) goes to
``--record`` (default ``<state-dir>/NORTHSTAR.json``), keeping every
complete run under ``runs`` and the best at the top level, and the run's
manifest and checkpoints move to ``<state-dir>/done/``, so the next start
is a fresh run.  The record's ``vs_north_star_per_chip`` is the rate over
``bench.NORTH_STAR_RATE``, the one-card limit.  ``hbm_live_bytes_per_batch``
holds the allocated device bytes after each batch; the loader holds the
next batch on the card meanwhile (but after the last), so
``hbm_growth_bytes`` compares the bytes outside the loader's batches
(``hbm_loader_bytes_per_batch``), first batch against last: a buffer kept
from batch to batch shows there.
"""
import argparse
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from . import make_sector

N_CURVES_TOTAL = 10_240
#: curves per SweepRunner batch; a multiple of the sector's file batch
RUN_BATCH = int(os.environ.get("LK_NS_BATCH", 2048))
P_GRID = 100_000
#: periods per chunk: one kernel launch each
CHUNK_PERIODS = int(os.environ.get("LK_NS_CHUNK", 12_500))
#: chunks between two checks of --max-seconds
CHUNKS_PER_CHECK = 4
DURATIONS = np.array([0.05, 0.10, 0.15, 0.20, 0.25, 0.33])
#: the stacks' dtype
DTYPE = torch.float32
#: the default directories: inside the checkout, git-ignored
DEFAULT_STATE_DIR = os.path.join(os.path.dirname(make_sector.DEFAULT_DIR),
                                 "state")
#: the watchdog's margin over --max-seconds
WATCHDOG_MARGIN_S = 300.0


def _now():
    return time.time()


def make_batch(ib):
    """Synthetic file batch ``ib`` (in-memory mode): times, flux and the
    injected periods."""
    t = make_sector.time_grid()
    flux, p_inj = make_sector.batch_flux(ib, t)
    return t, flux, p_inj


def _steady_state_fields(manifest):
    from ..bench import NORTH_STAR_RATE
    secs = [x for x in manifest.get("batch_seconds", []) if x and x > 0]
    if not secs:
        return {"batch_seconds_median": None,
                "steady_state_evals_per_sec_per_chip": None,
                "steady_state_vs_north_star": None}
    med = float(np.median(secs))
    rate = manifest["run_batch"] * P_GRID / med
    return {"batch_seconds_median": med,
            "steady_state_evals_per_sec_per_chip": rate,
            "steady_state_vs_north_star": rate / NORTH_STAR_RATE}


def _stack_bytes(stack):
    return sum(x.numel() * x.element_size() for x in
               (stack.time, stack.flux, stack.flux_err, stack.mask))


def _stack_iter(mode, start_batch, n_batches, paths, device):
    """Yield (ib, stack) with the host pipeline of ``mode``: fits mode
    streams ``paths`` through the loader, synthetic mode builds each batch
    in memory."""
    from ..batch import LightCurveStack
    from ..io.pipeline import StreamingStackLoader
    R = RUN_BATCH // make_sector.BATCH     # file batches per runner batch
    if mode == "fits":
        loader = StreamingStackLoader(
            paths[start_batch * RUN_BATCH:n_batches * RUN_BATCH],
            batch_size=RUN_BATCH, prefetch=2, time_column="TIME",
            flux_column="PDCSAP_FLUX", flux_err_column="PDCSAP_FLUX_ERR",
            length=make_sector.N, dtype=DTYPE, device=device)
        for k, stack in enumerate(loader):
            yield start_batch + k, stack
        return
    for ib in range(start_batch, n_batches):
        parts = [make_batch(g) for g in range(ib * R, (ib + 1) * R)]
        flux = np.concatenate([p[1] for p in parts])
        yield ib, LightCurveStack.from_numpy(
            np.broadcast_to(parts[0][0], flux.shape), flux,
            np.full(flux.shape, make_sector.NOISE), np.ones(flux.shape, bool),
            device=device, dtype=DTYPE)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=None,
                    help=f"runner batches (default {N_CURVES_TOTAL} curves "
                         f"in batches of {RUN_BATCH})")
    ap.add_argument("--state-dir", default=DEFAULT_STATE_DIR)
    ap.add_argument("--sector-dir", default=make_sector.DEFAULT_DIR)
    ap.add_argument("--mode", choices=("fits", "synthetic"), default="fits")
    ap.add_argument("--max-seconds", type=float, default=500.0,
                    help="stop cleanly after this much wall-clock")
    ap.add_argument("--record", default=None,
                    help="the record's path (default "
                         "<state-dir>/NORTHSTAR.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.batches is None:
        args.batches = N_CURVES_TOTAL // RUN_BATCH
    if args.record is None:
        args.record = os.path.join(args.state_dir, "NORTHSTAR.json")
    return args


def _load_manifest(path, args):
    manifest = {"batches_done": 0, "wall_s": 0.0, "recovered": 0,
                "curves": 0, "batch_seconds": [], "mode": args.mode,
                "run_batch": RUN_BATCH}
    if not os.path.exists(path):
        return manifest
    with open(path) as f:
        old = json.load(f)
    for key, want in (("mode", args.mode), ("run_batch", RUN_BATCH)):
        if key not in old:
            raise SystemExit(f"state dir {args.state_dir} holds a manifest "
                             f"without {key!r}; pass a fresh --state-dir")
        if old[key] != want:
            raise SystemExit(f"state dir {args.state_dir} holds a "
                             f"{key}={old[key]!r} run, not {want!r}; pass a "
                             "fresh --state-dir")
    return old


def main(argv=None):
    args = parse_args(argv)
    # a hung device call never returns to the max-seconds check: a timer
    # thread ends the process, with the state on disk resumable
    def _bail():
        print(f"watchdog: no clean exit after "
              f"{args.max_seconds + WATCHDOG_MARGIN_S:.0f}s (a device call "
              "hung?); the state is resumable: run again to continue",
              flush=True)
        os._exit(3)

    timer = threading.Timer(args.max_seconds + WATCHDOG_MARGIN_S, _bail)
    timer.daemon = True
    timer.start()
    try:
        run(args)
    finally:
        timer.cancel()
    return 0


def run(args):
    """The search of ``args`` (:func:`parse_args`); returns the record,
    or None where ``--max-seconds`` stopped it first."""
    from ..config import resolve_device
    from ..diagnostics import hbm_stats
    from ..parallel.checkpoint import SweepRunner, prewarm_shared_sweep
    if RUN_BATCH % make_sector.BATCH:
        raise SystemExit(f"LK_NS_BATCH={RUN_BATCH} must be a multiple of "
                         f"the sector's file batch {make_sector.BATCH}")
    device = resolve_device(args.device)
    os.makedirs(args.state_dir, exist_ok=True)
    manifest_path = os.path.join(args.state_dir, "manifest.json")
    manifest = _load_manifest(manifest_path, args)
    R = RUN_BATCH // make_sector.BATCH
    paths = None
    if args.mode == "fits":             # data set-up: before the clock
        paths = make_sector.ensure_sector(args.sector_dir, args.batches * R,
                                          verbose=False)
    t0_all = _now()
    t_ref = make_sector.time_grid()
    baseline = t_ref[-1] - t_ref[0]
    periods = np.linspace(1.0, baseline / 3, P_GRID)
    print(f"grid: {P_GRID} periods in [1.0, {baseline / 3:.3f}] d; "
          f"{args.batches} batches x {RUN_BATCH} curves x {make_sector.N} "
          f"cadences; mode={args.mode}; {device}", flush=True)

    def save_manifest():
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)

    t_pw = _now()
    for fut in prewarm_shared_sweep(device):
        fut.add_done_callback(lambda _: print(
            f"prewarm: kernel library ready after {_now() - t_pw:.1f}s",
            flush=True))

    stacks = _stack_iter(args.mode, manifest["batches_done"], args.batches,
                         paths, device)
    try:
        while manifest["batches_done"] < args.batches:
            # the hand-off from the loader is timed: when the host parse
            # falls behind, the stall is wall time the user waits for
            t_ld = _now()
            try:
                ib, stack = next(stacks)
            except StopIteration:
                break
            dt_ld = _now() - t_ld
            if _now() - t0_all > args.max_seconds:
                print("max-seconds reached; resumable state saved",
                      flush=True)
                save_manifest()
                return None
            assert ib == manifest["batches_done"]
            p_inj = np.concatenate([make_sector.batch_truth(g)[0]
                                    for g in range(ib * R, (ib + 1) * R)])
            runner = SweepRunner(
                stack, periods, DURATIONS,
                os.path.join(args.state_dir, f"batch{ib:03d}.npz"),
                chunk_periods=CHUNK_PERIODS, method="shared",
                async_save=True)
            resumed_mid_batch = runner.next_chunk > 0
            tb = _now()
            best = runner.state
            while not runner.done:
                if _now() - t0_all > args.max_seconds:
                    runner.flush_saves()
                    print(f"batch {ib}: paused at chunk {runner.next_chunk}/"
                          f"{runner.n_chunks}", flush=True)
                    save_manifest()
                    return None
                best = runner.run(max_chunks=CHUNKS_PER_CHECK)
            dt_b = _now() - tb
            rec = np.abs(best["period"] - p_inj) / p_inj < 0.01
            manifest["batches_done"] += 1
            manifest["wall_s"] += dt_b + dt_ld
            manifest["load_wait_s"] = manifest.get("load_wait_s", 0.0) + dt_ld
            manifest.setdefault("load_wait_seconds", []).append(dt_ld)
            if not resumed_mid_batch:
                # a resumed batch times only its remaining chunks
                manifest.setdefault("batch_seconds", []).append(dt_b)
            manifest["recovered"] += int(rec.sum())
            manifest["curves"] += RUN_BATCH
            # live device bytes after the batch, with this batch's stack
            # held; the loader holds the next batch on the card too (but
            # after the last): hbm_growth_bytes compares the rest
            held = 1 + (args.mode == "fits" and ib + 1 < args.batches)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            hbm_now = hbm_stats(device)
            manifest.setdefault("hbm_live_bytes", []).append(
                int(hbm_now.get("allocated_bytes.all.current", 0)))
            manifest.setdefault("hbm_loader_bytes", []).append(
                held * _stack_bytes(stack) if hbm_now else 0)
            save_manifest()
            print(f"batch {ib}: {dt_b:.3f}s  {RUN_BATCH * P_GRID / dt_b:.6g} "
                  f"curve-period/s  recovered {int(rec.sum())}/{RUN_BATCH}  "
                  f"load wait {dt_ld:.3f}s  live device bytes "
                  f"{manifest['hbm_live_bytes'][-1]}", flush=True)
            del runner, stack
    finally:
        stacks.close()
    if manifest["batches_done"] < args.batches:
        return None
    record = _merge_record(_result(args, manifest, device), args.record)
    _archive(args.state_dir)
    return record


def _result(args, manifest, device):
    """The record of a complete run: the JAX driver's fields."""
    from ..bench import NORTH_STAR_RATE, card_line, device_name
    from ..diagnostics import hbm_stats
    from ..io import native
    wall = manifest["wall_s"]
    rate = manifest["curves"] * P_GRID / wall
    live, loader = (manifest.get("hbm_live_bytes", []),
                    manifest.get("hbm_loader_bytes", []))
    outside = [a - b for a, b in zip(live, loader)]
    return {
        "curves": manifest["curves"],
        "period_grid": P_GRID,
        "cadences": make_sector.N,
        "run_batch": RUN_BATCH,
        "chunk_periods": CHUNK_PERIODS,
        "data_source": ("fits_files" if args.mode == "fits"
                        else "synthetic_memory"),
        "wall_clock_s": wall,
        "curve_period_evals_per_sec_per_chip": rate,
        "vs_north_star_per_chip": rate / NORTH_STAR_RATE,
        "recovery_rate": manifest["recovered"] / manifest["curves"],
        # the wall includes the first batch's set-up; the median of the
        # batches not resumed mid-way is the steady rate
        **_steady_state_fields(manifest),
        "batch_seconds": manifest.get("batch_seconds", [])[:40],
        # the seconds the sweep waited on the loader (in the wall)
        "load_wait_s": manifest.get("load_wait_s", 0.0),
        "load_wait_seconds": manifest.get("load_wait_seconds", [])[:40],
        "native_fits_loader": bool(native.available()),
        "hbm": hbm_stats(device),
        "hbm_live_bytes_per_batch": live[:40],
        "hbm_loader_bytes_per_batch": loader[:40],
        "hbm_growth_bytes": (outside[-1] - outside[0]
                             if len(outside) >= 2 else 0),
        "device": device_name(device),
        "card": card_line(device),
        "note": ("measured end to end through StreamingStackLoader (C++ "
                 "FITS reader, pinned host stacks, side-stream copies) + "
                 "SweepRunner (method='shared', device-side winner "
                 "reduction, asynchronous per-chunk checkpoints); the "
                 "north-star rate is one card's: 2e4 curves x 1e5 periods "
                 "in ten minutes" if args.mode == "fits" else
                 "measured end to end through SweepRunner on in-memory "
                 "synthetic batches (A/B mode)"),
    }


def _run_summary(result):
    """The comparable core of one complete run."""
    keys = ("wall_clock_s", "curve_period_evals_per_sec_per_chip",
            "vs_north_star_per_chip", "steady_state_vs_north_star",
            "load_wait_s", "recovery_rate", "data_source",
            "native_fits_loader")
    return {k: result.get(k) for k in keys if k in result}


def _merge_record(result, out):
    """Write the record at ``out``: every complete run under ``runs``, the
    best fits-mode run (else the best run) in full at the top level, and
    the spread of the runs' rates.  Returns the record."""
    runs, incumbent = [], None
    if os.path.exists(out):
        with open(out) as f:
            incumbent = json.load(f)
        runs = incumbent.pop("runs", [])
        incumbent.pop("spread_end_to_end_vs", None)
        incumbent.pop("n_runs", None)
    runs.append(_run_summary(result))
    candidates = [c for c in (incumbent, result)
                  if c and c.get("data_source") == "fits_files"] or [
        c for c in (incumbent, result) if c]
    best = max(candidates,
               key=lambda c: c.get("vs_north_star_per_chip") or 0.0)
    vs = sorted(r.get("vs_north_star_per_chip") or 0.0 for r in runs
                if r.get("data_source", "fits_files") == "fits_files")
    record = dict(best, runs=runs, n_runs=len(runs))
    if vs:
        record["spread_end_to_end_vs"] = {
            "best": vs[-1], "median": float(np.median(vs)), "worst": vs[0]}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(_run_summary(result)), flush=True)
    kept = ("promoted to the top level" if best is result
            else "recorded (the best run stays at the top level)")
    print(f"wrote {out}: this run {kept}; n_runs={len(runs)}", flush=True)
    return record


def _archive(state_dir):
    """Move a finished run's manifest and checkpoints to
    ``<state_dir>/done/`` (replacing an older run's), so the next start
    is a fresh run."""
    done = os.path.join(state_dir, "done")
    shutil.rmtree(done, ignore_errors=True)
    os.makedirs(done)
    for name in os.listdir(state_dir):
        if name == "manifest.json" or (name.startswith("batch")
                                       and name.endswith(".npz")):
            shutil.move(os.path.join(state_dir, name),
                        os.path.join(done, name))


if __name__ == "__main__":
    raise SystemExit(main())
