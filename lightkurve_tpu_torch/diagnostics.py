"""Tracing and profiling.

Counterpart of ``lightkurve_tpu/diagnostics.py``:

- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace (Perfetto and ``chrome://tracing`` read it) into a
  directory;
- :class:`KernelTimer` / :func:`timed` — wall-clock counters per named
  region, ended by a device synchronisation, aggregated in one registry
  that :func:`report` returns;
- :func:`annotate` — name a region so that it shows up in traces;
- :func:`hbm_stats` — the card's memory counters.
"""
from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from collections import defaultdict
from functools import wraps

import torch

from . import config

log = logging.getLogger(__name__)

__all__ = ["trace", "timed", "annotate", "report", "reset",
           "KernelTimer", "hbm_stats"]

_REGISTRY = defaultdict(lambda: {"calls": 0, "total_s": 0.0, "max_s": 0.0})


def _record(name, dt):
    entry = _REGISTRY[name]
    entry["calls"] += 1
    entry["total_s"] += dt
    entry["max_s"] = max(entry["max_s"], dt)


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


@contextlib.contextmanager
def annotate(name):
    """Named region that appears in traces."""
    with torch.profiler.record_function(name):
        yield


class KernelTimer:
    """Wall-clock timer of a block, ended by a synchronisation of
    ``device`` (:func:`config.resolve_device`) so that the card's work
    counts; adds the time to the registry under ``name``."""

    def __init__(self, name, device=None):
        self.name = name
        self.device = config.resolve_device(device)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        _record(self.name, time.perf_counter() - self._t0)


def timed(name=None, device=None):
    """Decorator: time a function to the end of its work on ``device``
    (:func:`config.resolve_device`, resolved at each call)."""
    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            dev = config.resolve_device(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(dev)
            _record(label, time.perf_counter() - t0)
            return out

        return wrapper

    return deco


def report(sort_by="total_s"):
    """Return (and log) the timing table."""
    rows = sorted(_REGISTRY.items(), key=lambda kv: -kv[1][sort_by])
    lines = [f"{'kernel':<40s} {'calls':>6s} {'total[s]':>10s} "
             f"{'mean[ms]':>10s} {'max[ms]':>10s}"]
    for name, e in rows:
        mean_ms = 1e3 * e["total_s"] / max(e["calls"], 1)
        lines.append(f"{name:<40s} {e['calls']:>6d} {e['total_s']:>10.3f} "
                     f"{mean_ms:>10.2f} {1e3 * e['max_s']:>10.2f}")
    text = "\n".join(lines)
    log.info("Kernel timing report:\n%s", text)
    return dict(_REGISTRY)


def reset():
    _REGISTRY.clear()


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
