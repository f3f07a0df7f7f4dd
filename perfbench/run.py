"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits non-zero, printing no result, where CUDA is missing or has fewer
cards than the cell asks for, where the program cannot be imported, or
where a JAX module (``jax``, ``jaxlib``, ``flax``, ``lightkurve_tpu``) is
loaded once the window has closed.  The last lines of standard error are
the numbers compared, each beside its limit; the last line of standard
output is the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_data", "cache")


def _cache_env():
    """Kernel and build caches at fixed directories inside the checkout;
    the program's own build directory is inside it already."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(v):
    return v if isinstance(v, float) and math.isfinite(v) else None


def main(argv=None):
    args = _parse(argv)
    _cache_env()
    import torch
    from perfbench import harness
    cell = harness.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    run, checks, info, breakdown, drv = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda",
        t_start=T_START)
    bad = harness.jax_modules()
    if bad:
        print(f"perfbench: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = harness.result_line(run, checks, info, breakdown, drv,
                               bool(args.trace))
    for name, c in line["checks"].items():
        c["value"] = _finite(c["value"])
    spans = {k: [len(v), round(sum(b - a for a, b in v), 6)]
             for k, v in run.spans.records.items()}
    setup = {k: round(v, 3) for k, v in run.setup_spans.items()}
    print(f"perfbench: {cell.name} seed {args.seed}: setup_s "
          f"{run.setup_s:.3f} {setup}, window_s {run.window_s:.3f}, attempted "
          f"{drv.attempted}, steps s [min, median, max] "
          f"{[round(f(run.step_s), 4) for f in (min, statistics.median, max)]}"
          f", counters {run.counters}, spans [count, s] "
          f"{spans}, host {run.host}", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
