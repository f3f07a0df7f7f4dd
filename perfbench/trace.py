"""The benchmark's spans and its reading of a ``torch.profiler`` trace.

Spans are the benchmark's own: host-clock intervals around its calls into
the program's layers, named after the layer.  In a traced run each span
is also a ``record_function`` range (``pb:<name>``), so that the trace
places it on the same clock as the device's activity.

From the trace (the arithmetic of ``chip_smoke.py --profile``, copied):
the device is busy where any device activity (kernel, copy, set) runs,
taken as the union of their intervals inside the traced window; idle is
the rest of the window.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

__all__ = ["Spans", "TraceSummary", "summarize"]

PREFIX = "pb:"


class Spans:
    """Named host-clock intervals (``time.perf_counter`` seconds)."""

    def __init__(self):
        self.records = defaultdict(list)
        self.annotate = False

    def clear(self):
        self.records.clear()

    @contextlib.contextmanager
    def span(self, name):
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function(PREFIX + name)
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records[name].append((t0, time.perf_counter()))

    def durations(self, name):
        return [b - a for a, b in self.records.get(name, ())]

    def total(self, name):
        return sum(self.durations(name))


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def _overlap(union, spans):
    """Length of the union's intersection with the (merged) spans."""
    total, j = 0, 0
    spans = _union(spans)
    for lo, hi in union:
        while j < len(spans) and spans[j][1] <= lo:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < hi:
            total += max(0, min(hi, spans[k][1]) - max(lo, spans[k][0]))
            k += 1
    return total


class TraceSummary:
    """The device's activity in a traced window, in seconds."""

    def __init__(self, window, busy, ops, spans):
        self.window_ns = window            # (start, end) on the trace clock
        self.busy_union = busy             # merged device intervals
        self.ops = ops                     # {name: device ns}
        self.spans = spans                 # {name: [(start, end)]}

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self):
        return sum(hi - lo for lo, hi in self.busy_union) * 1e-9

    def idle_fraction(self):
        w = self.window_s
        return None if w <= 0 else 1.0 - self.busy_s / w

    def busy_in(self, span):
        """Device-busy seconds inside the benchmark's ``span`` ranges."""
        return _overlap(self.busy_union, self.spans.get(span, [])) * 1e-9

    def device_ops(self, top=10):
        ranked = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, top=10):
        """The longest idle gaps of the window, each named by the
        innermost benchmark span the host was in at the gap's middle."""
        lo, hi = self.window_ns
        edges = [lo] + [v for iv in self.busy_union for v in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid, label, width = (a + b) / 2, "outside spans", None
            for name, ivs in self.spans.items():
                for s, e in ivs:
                    if s <= mid <= e and (width is None or e - s < width):
                        label, width = name, e - s
            out.append([label, (b - a) * 1e-9])
        return out


def _events(prof):
    """(name, start ns, end ns, on device) of every event of a finished
    profiler, read from its Kineto results (no event tree is built)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), start, start + e.duration_ns(),
               e.device_type() == DeviceType.CUDA)


def summarize(prof, window_span="window"):
    """A :class:`TraceSummary` of a finished profiler whose window is the
    ``pb:<window_span>`` range."""
    device, spans, ops = [], defaultdict(list), defaultdict(int)
    for name, start, end, on_device in _events(prof):
        if name.startswith(PREFIX):
            # a benchmark span; the trace also mirrors it on the device's
            # timeline as an annotation, which is no device work
            if not on_device:
                spans[name[len(PREFIX):]].append((start, end))
        elif on_device:
            device.append((start, end))
            ops[name] += end - start
    windows = spans.pop(window_span, None)
    if not windows:
        raise RuntimeError("the trace holds no window range")
    lo, hi = windows[0]
    clipped = [(max(a, lo), min(b, hi)) for a, b in device
               if b > lo and a < hi]
    return TraceSummary((lo, hi), _union(clipped), dict(ops), dict(spans))
