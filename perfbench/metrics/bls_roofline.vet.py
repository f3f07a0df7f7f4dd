"""bls_roofline.vet: the least time of the window's searches (the
benchmark's own count, :mod:`perfbench.roofline`) over the device's busy
time inside the program's ``bls.curve`` spans (``ops.bls.
bls_power_binned``, one a vet), in percent."""
from perfbench.program_spans import idle_ns_in, window_spans
from perfbench.roofline import least_seconds


def read(run):
    spans = window_spans(run)
    if not spans or not run.searches:
        return None
    lo, hi = run.trace.window_ns
    ivs = [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans
           if s.name == "bls.curve"]
    if not ivs:
        return None
    # the spans of one thread, one after another: no two overlap
    busy = sum(b - a for a, b in ivs) - idle_ns_in(run, ivs)
    if busy <= 0:
        return None
    least = sum(least_seconds(b, o)[0] for b, o in run.searches)
    return 100.0 * least / (busy * 1e-9)
