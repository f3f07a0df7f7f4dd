"""bls_roofline.sweep: the least time of the window's searches (the
benchmark's own count, :mod:`perfbench.roofline`) over the device's busy
time inside the spans around ``SweepRunner.run``, in percent."""
from perfbench.roofline import least_seconds


def read(run):
    if run.trace is None or not run.searches:
        return None
    busy = run.trace.busy_in("sweep")
    if busy <= 0:
        return None
    least = sum(least_seconds(b, o)[0] for b, o in run.searches)
    return 100.0 * least / busy
