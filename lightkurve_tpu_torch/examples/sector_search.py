"""From a sector's light-curve files to transit candidates, on the card.

Counterpart of the repository's ``examples/sector_search.py``:

    FITS files --StreamingStackLoader--> (B, N) stacks on the card
        --LightCurveStack.flatten (ops.detrend.flatten_batch)--> detrended
        --bls_search (ops.bls.bls_power_shared_batch)--> (B, P) powers
        --parallel.grid.best_candidates--> each target's best period

    python -m lightkurve_tpu_torch.examples.sector_search [--device cpu]
        [FILE ...]

With no files it writes a synthetic demo sector (:data:`N_TARGETS`
targets, :data:`N_PLANETS` of them with a transit) to a temporary
directory and checks that the transits' periods come back.
"""
import argparse
import glob
import os
import tempfile
import time

import numpy as np

N_TARGETS = 32
N_CADENCES = 2048
N_PLANETS = 4
#: targets per stack
BATCH = 32
#: the searched grid: (first, last, count) periods in days, and durations
PERIODS = (1.0, 5.0, 512)
DURATIONS = np.array([0.05, 0.1, 0.15])


def make_demo_sector(directory, seed=0):
    """Write a mini-sector of 10-minute curves with mild systematics and
    a transit in the first :data:`N_PLANETS`; returns the paths and the
    injected periods by target index."""
    from ..lightcurve import LightCurve
    rng = np.random.default_rng(seed)
    t = np.arange(N_CADENCES) * (10.0 / 60 / 24)
    injected, paths = {}, []
    for i in range(N_TARGETS):
        f = 1.0 + 3e-4 * rng.standard_normal(N_CADENCES)
        f += 2e-4 * np.sin(2 * np.pi * t / 3.7)
        if i < N_PLANETS:
            period = float(rng.uniform(1.2, 4.0))
            ph = np.mod(t - 0.3 + period / 2, period) - period / 2
            f[np.abs(ph) < 0.04] -= 2.5e-3
            injected[i] = period
        lc = LightCurve(time=t, flux=f, flux_err=np.full(N_CADENCES, 3e-4))
        p = os.path.join(directory, f"target{i:04d}.fits")
        lc.to_fits(path=p, overwrite=True, flux_column_name="PDCSAP_FLUX")
        paths.append(p)
    return paths, injected


def search(paths, device=None, dtype=None):
    """Each file's best period and its SNR: a list of (path, period,
    power), streamed in stacks of :data:`BATCH` on ``device`` (default the
    card; ``"cpu"`` for the plain versions)."""
    from ..io.pipeline import StreamingStackLoader
    from ..parallel.grid import best_candidates
    loader = StreamingStackLoader(paths, batch_size=min(BATCH, len(paths)),
                                  prefetch=2, dtype=dtype, device=device)
    periods = np.linspace(*PERIODS)
    rows = []
    for stack in loader:
        flat = stack.flatten()
        out = flat.bls_search(periods, DURATIONS, objective="snr")
        per, pw = best_candidates(out["power"], periods, k=1)
        for j, meta in enumerate(stack.meta):
            if meta.get("PADDING"):
                continue
            rows.append((meta.get("FILENAME", f"row{j}"), float(per[j, 0]),
                         float(pw[j, 0])))
    return rows


def report(rows, seconds, injected):
    """Print the rate, the top candidates and, for a demo sector, the
    injected planets; returns how many of those came back (the period or
    twice it, within 5%)."""
    n_periods = PERIODS[2]
    print(f"searched {len(rows)} targets x {n_periods} periods in "
          f"{seconds:.1f}s ({len(rows) * n_periods / seconds:,.0f} "
          "curve-period evals/s)")
    print("\ntop candidates (file, period [d], SNR):")
    for name, period, snr in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"  {os.path.basename(name):>18s}  P={period:7.3f}  "
              f"snr={snr:8.1f}")
    ok = 0
    if injected:
        print("\ninjected-planet check:")
        byfile = {os.path.basename(r[0]): r for r in rows}
        for i, p_true in injected.items():
            p_rec = byfile[f"target{i:04d}.fits"][1]
            ratio = max(p_rec, p_true) / min(p_rec, p_true)
            hit = min(abs(ratio - k) for k in (1, 2)) < 0.05
            ok += hit
            print(f"  target{i:04d}: injected {p_true:.3f}, recovered "
                  f"{p_rec:.3f} {'OK' if hit else 'MISS'}")
        print(f"{ok}/{len(injected)} recovered")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*", help="light-curve FITS files")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="lk_sector_") as tmp:
        if args.files:
            paths = sorted(sum((glob.glob(a) for a in args.files), []))
            injected = {}
        else:
            print("no files given: writing a synthetic demo sector")
            paths, injected = make_demo_sector(tmp)
        print(f"{len(paths)} targets")
        t0 = time.time()
        rows = search(paths, device=args.device)
        ok = report(rows, time.time() - t0, injected)
    return 0 if ok == len(injected) else 1


if __name__ == "__main__":
    raise SystemExit(main())
