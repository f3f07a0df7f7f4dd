"""A synthetic TESS sector on disk for the north-star search.

Counterpart of the repository's ``tools/make_sector.py``, written with the
port's FITS writer (``lightkurve_tpu_torch.io.fits``).  Each file is a
SPOC-style light curve (a TIME/PDCSAP_FLUX/PDCSAP_FLUX_ERR/QUALITY binary
table), so the search walks the real host pipeline: the C++ column reader,
padded host stacks and the double-buffered copy to the card
(``io/pipeline.py``).

Batch ``ib`` of :data:`BATCH` curves draws from ``default_rng(1000 + ib)``:
the same seed rule, so the same arrays, as the JAX package's generator,
and the injected periods need no headers (:func:`batch_truth`).

    python -m lightkurve_tpu_torch.tools.make_sector [--dir DIR] [--batches N]
"""
import argparse
import os

import numpy as np

N = 8192                     # TESS 2-min cadences (~11.4 d)
BATCH = 512
SECTOR = 99
NOISE = 2e-4
DEPTH = 3e-3
#: one shared time grid for the whole sector (a real sector's 2-min
#: targets share cadence midtimes); the offset keeps bins off knife edges
T_OFFSET = 0.0011
#: the default directory: inside the checkout, git-ignored
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "northstar_torch", "sector")


def time_grid():
    return np.arange(N) * (2.0 / 60 / 24) + T_OFFSET


def batch_truth(ib):
    """(p_inj, t0_inj) for batch ``ib``, drawn as :func:`batch_flux`
    draws them."""
    rng = np.random.default_rng(1000 + ib)
    rng.standard_normal((BATCH, N))          # burn the noise draws
    p_inj = rng.uniform(1.2, 3.5, BATCH)
    t0_inj = rng.uniform(0, p_inj)
    return p_inj, t0_inj


def batch_flux(ib, t):
    """(flux (BATCH, N), p_inj) of batch ``ib`` on the times ``t``: white
    noise around 1 and one box transit of :data:`DEPTH` per curve."""
    rng = np.random.default_rng(1000 + ib)
    flux = 1.0 + NOISE * rng.standard_normal((BATCH, N))
    p_inj = rng.uniform(1.2, 3.5, BATCH)
    t0_inj = rng.uniform(0, p_inj)
    for i in range(BATCH):
        ph = np.mod(t - t0_inj[i] + p_inj[i] / 2, p_inj[i]) - p_inj[i] / 2
        flux[i, np.abs(ph) < 0.05] -= DEPTH
    return flux, p_inj


def file_path(directory, g):
    return os.path.join(
        directory, f"tess-synth-s{SECTOR:04d}-{g:016d}-s_lc.fits")


def ensure_sector(directory, batches, verbose=True):
    """Write the files of the first ``batches`` batches that are missing
    from ``directory``; returns the ordered path list."""
    from ..io.fits import (BinTableHDU, HDUList, Header, PrimaryHDU,
                           write_fits)
    os.makedirs(directory, exist_ok=True)
    t = time_grid()
    quality = np.zeros(N, dtype=np.int32)
    paths = []
    for ib in range(batches):
        batch_paths = [file_path(directory, ib * BATCH + i)
                       for i in range(BATCH)]
        paths += batch_paths
        if all(os.path.exists(p) for p in batch_paths):
            continue
        flux, p_inj = batch_flux(ib, t)
        for i, p in enumerate(batch_paths):
            g = ib * BATCH + i
            ph = Header({"TELESCOP": "TESS", "ORIGIN": "lightkurve_tpu",
                         "CREATOR": "make_sector.py",
                         "OBJECT": f"SYNTH {g}", "TICID": g,
                         "SECTOR": SECTOR, "MISSION": "TESS",
                         "TRUTHP": float(p_inj[i])})
            table = BinTableHDU(data={
                "TIME": t,
                "PDCSAP_FLUX": flux[i].astype(np.float32),
                "PDCSAP_FLUX_ERR": np.full(N, NOISE, dtype=np.float32),
                "QUALITY": quality,
            }, header=Header({"EXTNAME": "LIGHTCURVE",
                              "BJDREFI": 2457000, "BJDREFF": 0.0,
                              "TIMESYS": "TDB", "TUNIT2": "e-/s",
                              "TUNIT3": "e-/s"}))
            write_fits(HDUList([PrimaryHDU(header=ph), table]), p,
                       overwrite=True)
        if verbose:
            print(f"sector batch {ib}: wrote {BATCH} files", flush=True)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--batches", type=int, default=20)
    args = ap.parse_args(argv)
    paths = ensure_sector(args.dir, args.batches)
    size = sum(os.path.getsize(p) for p in paths[:BATCH]) * args.batches
    print(f"{len(paths)} files in {args.dir} (~{size/1e9:.2f} GB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
