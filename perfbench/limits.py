"""The readings that the limits of a cell's numbers are set from.

    python3 -m perfbench.limits --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 4 5 6] [--seconds S]

For each ``--seeds`` seed it runs the cell as a run does (set-up, a window
of ``--seconds``, the check) in this one process, and prints the numbers
compared.  For each ``--control-seeds`` seed it runs the control in the
program's place: the plain reference computed in TF32 (float32 arithmetic,
every product's inputs rounded to a 10-bit mantissa), on the same inputs
and the same sample, judged by the same comparison (the traffic kind's
module, ``perfbench/kinds/<kind>.py``, does it in its ``control``).
One JSON line per reading: ``{"cell", "seed", "side", "checks": {name:
value}}``.  Not part of a run: the benchmark's runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from . import drivers, harness
from .reference import TF32

__all__ = ["control_checks", "main"]


def control_checks(cell, seed, device="cuda", prec=TF32):
    """The numbers the cell's check gives the control (the reference in
    ``prec``) put in the program's place, on the inputs and the sample of
    run ``seed``; the traffic kind's ``control`` does the putting."""
    run = harness.Run(cell=cell)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        drv = drivers.make(cell, seed, device, run, tmp)
        drivers.load_kind(cell.root, cell.traffic["kind"]).control(drv,
                                                                   prec)
        return drv.check()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        run, checks, *_ = harness.run_cell(cell, seed, args.seconds, False,
                                           device=device)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "side": "program", "steps": int(_[2].attempted),
                          "checks": {n: v for n, v, _l in checks}}),
              flush=True)
        if device == "cuda":
            torch.cuda.empty_cache()
    for seed in args.control_seeds:
        checks = control_checks(cell, seed, device)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "side": "control",
                          "checks": {n: v for n, v, _l in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
