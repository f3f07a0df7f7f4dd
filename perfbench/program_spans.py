"""The program's own spans and counters (``lightkurve_tpu_torch.
diagnostics``) read against a traced window.

The program records its spans on the clock of the profiler's events
while a profiler records, so they meet the window and the device's busy
intervals of :class:`perfbench.trace.TraceSummary` directly.  Every
function returns ``None`` where there is no trace, or where the program
records no spans (a checkout from before it had them).
"""
from __future__ import annotations

__all__ = ["all_spans", "window_spans", "idle_ns_in", "per_span_idle_ms",
           "counts_under"]


def all_spans():
    """Every span the program recorded in this process, or ``None``."""
    from lightkurve_tpu_torch import diagnostics
    read = getattr(diagnostics, "spans", None)
    return None if read is None else read()


def window_spans(run):
    """The program's closed spans that overlap the run's traced window."""
    if run.trace is None:
        return None
    spans = all_spans()
    if spans is None:
        return None
    lo, hi = run.trace.window_ns
    return [s for s in spans if s.end_ns is not None
            and s.start_ns < hi and s.end_ns > lo]


def _union(intervals, lo, hi):
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_ns_in(run, intervals):
    """Device-idle ns of the window inside the union of ``intervals``."""
    lo, hi = run.trace.window_ns
    spans = _union(intervals, lo, hi)
    total = sum(b - a for a, b in spans)
    busy, j = 0, 0
    for a, b in run.trace.busy_union:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            busy += max(0, min(b, spans[k][1]) - max(a, spans[k][0]))
            k += 1
    return total - busy


def per_span_idle_ms(run, name, also=()):
    """Device-idle ms inside the window's ``name`` spans and its top-level
    spans named in ``also``, over the number of ``name`` spans."""
    spans = window_spans(run)
    if not spans:
        return None
    n = sum(s.name == name for s in spans)
    if not n:
        return None
    ivs = [(s.start_ns, s.end_ns) for s in spans if s.name == name
           or (s.name in also and s.parent == -1)]
    return idle_ns_in(run, ivs) * 1e-6 / n


def counts_under(run, name, counter):
    """Counter ``counter`` added inside the window's ``name`` spans (at
    any depth), over the number of those spans."""
    spans = window_spans(run)
    if not spans:
        return None
    every = all_spans()
    roots = {s.index for s in spans if s.name == name}
    if not roots:
        return None
    total = 0
    for s in spans:
        if counter not in s.counts:
            continue
        i = s.index
        while i != -1 and i not in roots:
            i = every[i].parent
        if i != -1:
            total += s.counts[counter]
    return total / len(roots)
