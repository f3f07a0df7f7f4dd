"""A transit search over curves that do not share one time grid, on the
card.

Counterpart of the repository's ``examples/multi_sector_sweep.py``.
Archive batches mix cadence grids: each TESS sector (or Kepler quarter)
has its own time stamps.  ``SweepRunner(method="shared")`` groups the
rows by time grid, runs one shared-grid search per group (the fused
kernels on the card) and puts the winners back in row order.

    python -m lightkurve_tpu_torch.examples.multi_sector_sweep [--device cpu]

runs a demo of :data:`B` curves on four epoch-shifted sector grids, each
with the same injected planet, and checks that every curve finds it.
"""
import argparse
import os
import tempfile

import numpy as np

B, N, P = 64, 1024, 4096
P_TRUE, T0_TRUE, DEPTH = 1.93, 0.4, 3e-3
#: the searched grid (first and last period in days) and durations
GRID = (1.0, 2.4)
DURATIONS = np.array([0.05, 0.10, 0.15])


def demo_arrays(seed=42):
    """(times, flux) of the demo, (B, N) each: a 10-minute cadence, four
    sectors at the same cadence and different epochs, interleaved so the
    grouping has to regroup them."""
    rng = np.random.default_rng(seed)
    base = np.arange(N) * (10.0 / 60 / 24)
    times = np.empty((B, N), np.float64)
    for g in range(4):
        times[g::4] = base + 13.7 * g
    flux = 1.0 + 2e-4 * rng.standard_normal((B, N))
    ph = np.mod(times - T0_TRUE + P_TRUE / 2, P_TRUE) - P_TRUE / 2
    flux[np.abs(ph) < 0.05] -= DEPTH
    return times, flux


def sweep(times, flux, device=None, dtype=None):
    """Every curve's winners (SweepRunner's state: period, power, ...)
    over :data:`P` periods in one chunk, on ``device`` (default the card;
    ``"cpu"`` for the plain versions) in ``dtype`` (default float32)."""
    from ..batch import LightCurveStack
    from ..parallel.checkpoint import SweepRunner
    stack = LightCurveStack.from_numpy(
        times, flux, np.full(flux.shape, 2e-4), np.ones(flux.shape, bool),
        device=device, dtype=dtype)
    periods = np.linspace(*GRID, P)
    with tempfile.TemporaryDirectory() as td:
        runner = SweepRunner(stack, periods, DURATIONS,
                             os.path.join(td, "sweep.npz"), chunk_periods=P,
                             method="shared", async_save=True)
        return runner.run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    best = sweep(*demo_arrays(), device=args.device)
    rec = np.abs(best["period"] - P_TRUE) / P_TRUE < 0.01
    print(f"recovered {int(rec.sum())}/{B} (median best period "
          f"{np.median(best['period']):.4f}, true {P_TRUE})")
    if not rec.all():
        print("the grouped sweep missed the injection")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
