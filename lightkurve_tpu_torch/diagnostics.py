"""Tracing and profiling.

Counterpart of ``lightkurve_tpu/diagnostics.py``:

- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (Perfetto and ``chrome://tracing`` read it) into a
  directory;
- :func:`span` / :func:`count` — the program's own spans and counters,
  kept in one registry (:func:`spans`, :func:`counters`, :func:`reset`);
- :class:`KernelTimer` / :func:`timed` — wall-clock counters per named
  region, ended by a device synchronisation, kept in the same registry
  and tabled by :func:`report`;
- :func:`annotate` — name a region so that it shows up in traces;
- :func:`idle_by_span` / :func:`busy_intervals` — a profiled window's
  device-idle time put down to the program's spans;
- :func:`hbm_stats` — the card's memory counters.

**Recording.**  Spans and counters are recorded while a
``torch.profiler`` is recording, or after :func:`enable` (until
:func:`disable`); nothing else turns them on.  Off, a span is one flag
check and costs no allocation.  A span records its name, attributes,
start and end (``time.time_ns()``, the clock of the profiler's events),
the index of its parent (the innermost span open on the same thread when
it began, -1 for none) and its thread, and opens a
``record_function``-style range ``lk:<name>`` of function scope: the
Chrome trace shows it, and, unlike a user-scope range, the profiler puts
no copy of it on the device's timeline, so device activity stays device
work.  A counter adds to its total and to the innermost open span of its
thread.  The registry keeps at most :data:`MAX_SPANS` spans, then counts
the ones it drops (:func:`dropped`).

**Reading a trace of the card.**  Profile a region, then put its idle
time down to the program's steps::

    from torch.profiler import ProfilerActivity, profile
    diagnostics.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        runner.run()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    idle = diagnostics.idle_by_span(diagnostics.busy_intervals(prof),
                                    (t0, t1), diagnostics.spans())

``idle`` maps each innermost span name (of the thread that opened the
outermost span) to the device-idle nanoseconds while it was the
innermost one open, and ``"outside"`` to the idle with no span open; the
values add up to the window's idle time.
"""
from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time
from collections import defaultdict
from functools import wraps

import torch

from . import config

log = logging.getLogger(__name__)

__all__ = ["trace", "timed", "annotate", "report", "reset",
           "KernelTimer", "hbm_stats", "span", "count", "set_attrs",
           "enable", "disable", "recording", "spans", "counters", "dropped",
           "idle_by_span", "busy_intervals", "Span", "MAX_SPANS"]

#: the most spans the registry keeps; later ones are dropped and counted
MAX_SPANS = 1_000_000

# a range of function scope: shown in the trace, not mirrored on the
# device's timeline (a user-scope ``record_function`` is)
_FastRange = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span: ``name``, ``attrs``, ``start_ns``/``end_ns``
    (``time.time_ns()``; ``end_ns`` is ``None`` while open), ``parent``
    (index in :func:`spans`, -1 for none), ``thread`` (its
    ``threading.get_ident()``), ``counts`` (the counters added while it
    was the innermost open span)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "thread",
                 "counts", "index")

    def __init__(self, name, attrs, parent, thread, index):
        self.name, self.attrs = name, attrs
        self.parent, self.thread, self.index = parent, thread, index
        self.start_ns = self.end_ns = None
        self.counts = {}

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, "
                f"{self.start_ns}-{self.end_ns}, {self.attrs})")


class _Registry:
    """Spans, counters and timer entries of one process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self):
        with self.lock:
            self.spans = []
            self.totals = defaultdict(int)
            self.timers = defaultdict(
                lambda: {"calls": 0, "total_s": 0.0, "max_s": 0.0})
            self.dropped = 0

    def stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name, attrs):
        """A new span under this thread's innermost open one, or ``None``
        past the cap (then ``None`` stands on the thread's stack for it,
        so that nothing inside it is put down to its parent)."""
        st = self.stack()
        rec = None
        with self.lock:
            if len(self.spans) >= MAX_SPANS:
                self.dropped += 1
            else:
                rec = Span(name, attrs, st[-1].index if st and st[-1]
                           else -1, threading.get_ident(), len(self.spans))
                self.spans.append(rec)
        st.append(rec)
        return rec

    def add(self, name, n):
        st = self.stack()
        with self.lock:
            self.totals[name] += n
            if st and st[-1] is not None:
                c = st[-1].counts
                c[name] = c.get(name, 0) + n

    def time(self, name, dt):
        with self.lock:
            e = self.timers[name]
            e["calls"] += 1
            e["total_s"] += dt
            e["max_s"] = max(e["max_s"], dt)


_REG = _Registry()
_explicit = False


def enable():
    """Record spans and counters from now on, with or without a profiler.
    Returns whether :func:`enable` was in force already."""
    global _explicit
    was, _explicit = _explicit, True
    return was


def disable():
    """Undo :func:`enable`; a recording profiler still turns recording on."""
    global _explicit
    _explicit = False


def recording():
    """Whether spans and counters are recorded now."""
    return _explicit or _profiling()


class _Off:
    """The span of a process that is not recording: nothing at all."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "label", "user", "rec", "rng")

    def __init__(self, name, attrs, label, user):
        self.name, self.attrs, self.label, self.user = (name, attrs, label,
                                                        user)

    def __enter__(self):
        self.rec = rec = _REG.open(self.name, self.attrs)
        if self.user:
            self.rng = torch.profiler.record_function(self.label)
        elif _FastRange is not None and rec is not None:
            self.rng = _FastRange(self.label)
        else:
            self.rng = None
        if rec is not None:
            rec.start_ns = time.time_ns()
        if self.rng is not None:
            self.rng.__enter__()
        return rec

    def __exit__(self, *exc):
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        rec = self.rec
        if rec is not None:
            rec.end_ns = time.time_ns()
        st = _REG.stack()
        if st and st[-1] is rec:
            st.pop()
        return False


def span(name, **attrs):
    """Context manager: a span ``name`` with attributes ``attrs`` (host
    values), recorded while :func:`recording`; yields its :class:`Span`
    (``None`` when not recording or past the cap)."""
    if not (_explicit or _profiling()):
        return _OFF
    return _On(name, attrs, "lk:" + name, False)


def count(name, n=1):
    """Add ``n`` to counter ``name`` and to the innermost open span of
    this thread, while :func:`recording`."""
    if _explicit or _profiling():
        _REG.add(name, n)


def set_attrs(**attrs):
    """Add host values to the attributes of this thread's innermost open
    span, while :func:`recording`."""
    if _explicit or _profiling():
        st = _REG.stack()
        if st and st[-1] is not None:
            st[-1].attrs.update(attrs)


def spans():
    """The recorded spans, in the order they began (a list of
    :class:`Span`; a span's ``parent`` indexes it)."""
    with _REG.lock:
        return list(_REG.spans)


def counters():
    """Each counter's total: ``{name: n}``."""
    with _REG.lock:
        return dict(_REG.totals)


def dropped():
    """Spans not kept because the registry held :data:`MAX_SPANS`."""
    return _REG.dropped


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(logdir=None, device=None):
    """Profile the block: CPU activity, and the card's when ``device``
    (:func:`config.resolve_device`) is a CUDA device.  Yields the
    ``torch.profiler.profile`` (its ``key_averages()`` and ``events()``);
    on exit writes ``trace_<pid>_<ns>.json`` into ``logdir`` (default: a
    directory in the system's temporary directory)."""
    from torch.profiler import ProfilerActivity, profile
    device = config.resolve_device(device)
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(),
                              "lightkurve_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync(device)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("Profile trace written to %s", path)


def annotate(name):
    """Named region that appears in traces under ``name`` (a user-scope
    ``record_function``), and a span ``name`` while :func:`recording`."""
    if not (_explicit or _profiling()):
        return torch.profiler.record_function(name)
    return _On(name, {}, name, True)


class KernelTimer:
    """Wall-clock timer of a block, ended by a synchronisation of
    ``device`` (:func:`config.resolve_device`) so that the card's work
    counts; adds the time to the registry's table under ``name``, and is
    a span ``name`` there while :func:`recording`."""

    def __init__(self, name, device=None):
        self.name = name
        self.device = config.resolve_device(device)

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        _REG.time(self.name, time.perf_counter() - self._t0)
        self._span.__exit__(*exc)


def timed(name=None, device=None):
    """Decorator: time a function to the end of its work on ``device``
    (:func:`config.resolve_device`, resolved at each call), as
    :class:`KernelTimer` does."""
    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            with KernelTimer(label, device):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def report(sort_by="total_s"):
    """Return (and log) the timers' table."""
    with _REG.lock:
        rows = sorted(((k, dict(v)) for k, v in _REG.timers.items()),
                      key=lambda kv: -kv[1][sort_by])
    lines = [f"{'kernel':<40s} {'calls':>6s} {'total[s]':>10s} "
             f"{'mean[ms]':>10s} {'max[ms]':>10s}"]
    for name, e in rows:
        mean_ms = 1e3 * e["total_s"] / max(e["calls"], 1)
        lines.append(f"{name:<40s} {e['calls']:>6d} {e['total_s']:>10.3f} "
                     f"{mean_ms:>10.2f} {1e3 * e['max_s']:>10.2f}")
    text = "\n".join(lines)
    log.info("Kernel timing report:\n%s", text)
    return dict(rows)


def reset():
    """Empty the registry: spans, counters, the timers' table and the
    drop count.  Call it with no span open."""
    _REG.clear()


def _merged(intervals, lo, hi):
    """The union of ``intervals`` clipped to [lo, hi), sorted."""
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


def _innermost_segments(recs, lo, hi):
    """[(start, end, name)] covering [lo, hi): the innermost of the
    (nested, one thread's) spans ``recs`` open there, ``"outside"`` where
    none is; an open span runs to ``hi``."""
    depth = {}
    for r in recs:
        depth[r.index] = depth.get(r.parent, -1) + 1
    events = []
    for r in recs:
        end = hi if r.end_ns is None else r.end_ns
        d = depth[r.index]
        events.append((r.start_ns, 1, d, r.name))
        events.append((end, 0, -d, r.name))
    # at one instant: ends before starts, inner ends and outer starts first
    events.sort(key=lambda e: e[:3])
    out, stack, t = [], [], lo
    for when, is_start, _, name in events:
        when = min(max(when, lo), hi)
        if when > t:
            out.append((t, when, stack[-1] if stack else "outside"))
            t = when
        if is_start:
            stack.append(name)
        elif stack:
            stack.pop()
    if hi > t:
        out.append((t, hi, stack[-1] if stack else "outside"))
    return out


def idle_by_span(busy, window, spans):
    """The device-idle nanoseconds of ``window`` put down to the program's
    spans.

    busy : iterable of (start, end) device-busy intervals in ns on the
        trace clock (``time.time_ns()``; :func:`busy_intervals`); they
        may overlap.
    window : (start, end) ns.
    spans : recorded :class:`Span` s (:func:`spans`); those of the thread
        that opened the earliest top-level span in the window count.

    Returns ``{name: ns}``: for each idle interval of the window, each
    part of it is given to the innermost of that thread's spans open
    there, or to ``"outside"`` where none is.  The values add up to the
    window's idle time."""
    lo, hi = int(window[0]), int(window[1])
    idle, t = [], lo
    for a, b in _merged(busy, lo, hi):
        if a > t:
            idle.append((t, a))
        t = b
    if hi > t:
        idle.append((t, hi))
    inside = [r for r in spans if r.start_ns is not None
              and r.start_ns < hi and (r.end_ns is None or r.end_ns > lo)]
    top = [r for r in inside if r.parent == -1]
    thread = min(top, key=lambda r: r.start_ns).thread if top else None
    segs = _innermost_segments([r for r in inside if r.thread == thread],
                               lo, hi)
    out = defaultdict(int)
    out["outside"] = 0
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            out[name] += min(b, e) - max(a, s)
            k += 1
    return dict(out)


def busy_intervals(prof):
    """The device's activity of a finished ``torch.profiler.profile`` as
    (start, end) ns on the trace clock: every kernel, copy and set on a
    CUDA device; the profiler's copies of user-scope ranges on the
    device's timeline (annotations, no device work) left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((start, start + e.duration_ns()))
    return out


def hbm_stats(device=None):
    """The card's memory telemetry: the byte counters of
    ``torch.cuda.memory_stats`` (the caching allocator's current, peak,
    allocated and freed bytes) and ``free_bytes``/``total_bytes`` of
    ``torch.cuda.mem_get_info``.  ``{}`` for the CPU, and where the
    counters cannot be read; never raises."""
    try:
        device = config.resolve_device(device)
        if device.type != "cuda":
            return {}
        out = {k: int(v) for k, v in torch.cuda.memory_stats(device).items()
               if "bytes" in k and isinstance(v, (int, float))}
        free, total = torch.cuda.mem_get_info(device)
        out.update(free_bytes=int(free), total_bytes=int(total))
        return out
    except (RuntimeError, AssertionError) as err:
        log.warning("hbm_stats: no memory counters (%s)", err)
        return {}
