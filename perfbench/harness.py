"""One run of one cell: set-up, the measured window, the check, the line.

The harness knows no cell, configuration, traffic mix or metric by name.
It reads ``BENCHMARK.json`` and finds the cell's configuration file, its
traffic file ``perfbench/workloads/<cell>.json``, the driver of the
traffic's ``kind`` in ``perfbench/kinds/<kind>.py`` and each metric's
reader ``perfbench/metrics/<metric>.py``, all under the root it is given.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

from .trace import Spans, summarize

__all__ = ["ROOT", "Cell", "Run", "load_cell", "run_cell", "reader",
           "jax_modules", "result_line"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that may not be loaded when a result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "lightkurve_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    spans: Spans = field(default_factory=Spans)
    counters: dict = field(default_factory=dict)
    latencies: list = field(default_factory=list)
    searches: list = field(default_factory=list)
    trace: object = None
    setup_spans: dict = field(default_factory=dict)
    step_s: list = field(default_factory=list)
    host: dict = field(default_factory=dict)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, its traffic and its metrics."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(root, "perfbench", "workloads",
                                      name + ".json"))
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                root=root)


def reader(root, metric):
    """The ``read`` function of metric ``metric``'s file,
    ``<root>/perfbench/metrics/<metric>.py``."""
    path = os.path.join(root, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run, metrics):
    """{name: {"value", "unit"}} of the metrics whose readers found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(run.cell.root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def jax_modules():
    """The loaded modules whose top-level name is forbidden, compared
    whole (``lightkurve_tpu_torch`` is not ``lightkurve_tpu``)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def _host_now():
    """The process's host counters: its page faults, context switches and
    CPU seconds (``getrusage``), its resident bytes (``/proc/self/statm``,
    None where there is none) and the garbage collector's collections of
    each generation."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * resource.getpagesize()
    except OSError:
        rss = None
    return {"minflt": ru.ru_minflt, "majflt": ru.ru_majflt,
            "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw,
            "utime_s": ru.ru_utime, "stime_s": ru.ru_stime, "rss": rss,
            "gc": [g["collections"] for g in gc.get_stats()]}


def host_figures(before, after):
    """What the window cost the host process, from two :func:`_host_now`
    readings: printed beside a run's result, never a metric."""
    out = {k: round(after[k] - before[k], 3) if isinstance(after[k], float)
           else after[k] - before[k]
           for k in ("minflt", "majflt", "nvcsw", "nivcsw", "utime_s",
                     "stime_s")}
    out["rss_growth"] = (None if before["rss"] is None
                         else after["rss"] - before["rss"])
    out["gc"] = [b - a for a, b in zip(before["gc"], after["gc"])]
    return out


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None):
    """Set the cell up, run its window of ``seconds``, check its outputs.

    Returns ``(run, checks, device_info, breakdown, driver)``; ``checks``
    is a list of ``(name, value, limit)``.  ``t_start`` is when the run began
    (the process start, for ``setup_s``)."""
    import torch
    from . import drivers
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell=cell)
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        drv = drivers.make(cell, seed, device, run, tmp)
        drv.setup()
        _sync(device)
        run.setup_s = time.perf_counter() - t_start
        run.setup_spans = {k: run.spans.total(k) for k in run.spans.records}
        run.spans.clear()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            run.spans.annotate = True
        host0 = _host_now()
        with run.spans.span("window"):
            w0 = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                drv.step()
                t1 = time.perf_counter()
                run.step_s.append(t1 - t0)
                if t1 - w0 >= seconds:
                    break
            _sync(device)
            run.window_s = time.perf_counter() - w0
        run.host = host_figures(host0, _host_now())
        if prof is not None:
            prof.__exit__(None, None, None)
            run.spans.annotate = False
            run.trace = summarize(prof)
            del prof
        info = _device_info(device, cell.chips)
        if run.trace is not None:
            info["busy_s"] = run.trace.busy_s
            info["window_s"] = run.trace.window_s
        drv.release()
        checks = drv.check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    breakdown = None
    if run.trace is not None:
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
    return run, checks, info, breakdown, drv


def _device_info(device, chips):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def result_line(run, checks, info, breakdown, drv, trace):
    """The result's JSON object; ``checks`` last."""
    metrics = read_metrics(run, run.cell.per_layer if trace
                           else run.cell.end_to_end)
    line = {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": int(drv.attempted), "failed": int(drv.failed),
            "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line
