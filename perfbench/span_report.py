"""A traced run of one cell, read through the program's own spans.

    python3 -m perfbench.span_report --workload <cell> --seed <n> \\
        --seconds <s> [--out FILE]

Runs the cell as ``perfbench.run --trace 1`` does, then prints one JSON
line: the window's rate (``search_evals_per_s`` from the traced window,
for the cost of tracing against an untraced run of the same seed), the
per-layer metrics, the window's device-idle seconds per innermost
program span and ``outside`` (``diagnostics.idle_by_span``) beside the
idle time of the trace, the ten longest idle gaps with the program spans
they fall in, and the checks that the program's spans share the trace's
clock: every program span of the window inside the benchmark's
``pb:window`` range and every ``flatten`` span inside a ``pb:flatten``
range, each within 1 ms, and no ``lk:`` range among the device's
activity.  Where the program records no spans (a checkout from before it
had them) only the rate and the metrics are given.
"""
import argparse
import json
import os
import sys

from perfbench import harness, program_spans

SLACK_NS = 1_000_000


def _inside(s, ranges):
    return any(a - SLACK_NS <= s.start_ns and s.end_ns <= b + SLACK_NS
               for a, b in ranges)


def report(run):
    tr = run.trace
    lo, hi = tr.window_ns
    out = {"window_s": tr.window_s, "busy_s": tr.busy_s,
           "idle_s": tr.window_s - tr.busy_s,
           "device_idle_frac": tr.idle_fraction(),
           "lk_ranges_on_device": sorted(k for k in tr.ops
                                         if k.startswith("lk:"))}
    spans = program_spans.window_spans(run)
    if spans is None:
        return out
    from lightkurve_tpu_torch import diagnostics
    idle = diagnostics.idle_by_span(tr.busy_union, tr.window_ns, spans)
    out["idle_by_span_s"] = {k: v * 1e-9 for k, v in
                             sorted(idle.items(), key=lambda kv: -kv[1])}
    out["idle_by_span_total_s"] = sum(idle.values()) * 1e-9
    edges = [lo] + [v for iv in tr.busy_union for v in iv] + [hi]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    out["idle_gaps"] = []
    for a, b in gaps[:10]:
        parts = diagnostics.idle_by_span([], (a, b), spans)
        out["idle_gaps"].append(
            [(b - a) * 1e-9, {k: v * 1e-9 for k, v in sorted(
                parts.items(), key=lambda kv: -kv[1]) if v}])
    window = tr.spans.get("window", []) or [(lo, hi)]
    out["spans_in_window"] = len(spans)
    out["spans_outside_pb_window"] = sum(not _inside(s, window)
                                         for s in spans)
    flat = [s for s in spans if s.name == "flatten"]
    out["flatten_spans"] = len(flat)
    out["flatten_outside_pb_flatten"] = sum(
        not _inside(s, tr.spans.get("flatten", [])) for s in flat)
    out["counters"] = diagnostics.counters()
    out["dropped"] = diagnostics.dropped()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also append the line to this file")
    args = ap.parse_args(argv)
    import torch
    cell = harness.load_cell(args.workload)
    run, checks, info, _, drv = harness.run_cell(
        cell, args.seed, args.seconds, True, device=args.device)
    work = run.counters.get("curve_periods", 0)
    line = {"workload": cell.name, "seed": args.seed,
            "device": info.get("kind"),
            "torch": torch.__version__,
            "correct": all(v <= lim for _, v, lim in checks),
            "traced_search_evals_per_s": work / run.window_s,
            "metrics": {k: v["value"] for k, v in harness.read_metrics(
                run, cell.per_layer).items()},
            **report(run)}
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
