"""Run a function on the ranks of a gloo process group, one process each.

:func:`run_ranks` spawns ``n_ranks`` processes (the ``spawn`` start
method), joins them into a gloo process group through a ``file://`` store
in a temporary directory, puts each on its device (``cuda:(rank %
devices)`` for a CUDA device: ranks of one card share it), runs the
function, and sends back each rank's result and the launch counts of the
BLS kernels' wrappers and their plain versions over that call.  The multi-
rank tests, :func:`~lightkurve_tpu_torch.parallel.dryrun.dryrun_multichip`
and ``chip_smoke.py`` use it.  gloo runs several ranks on one card, which
NCCL refuses.

A spawned process imports the module that defines its function, so the
function lives in a module that imports neither jax nor a test module.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch

__all__ = ["run_ranks", "kernel_counters", "kernel_counts",
           "reset_kernel_counts"]

#: each BLS kernel's wrapper (counts launches) and plain version (counts
#: calls), by module of ``lightkurve_tpu_torch.ops``
KERNEL_COUNTERS = {
    "K-F": ("bls_fused", "fused_scan_uniform", "fused_scan_uniform_plain"),
    "K-WF": ("bls_fused_weighted", "fused_scan_weighted",
             "fused_scan_weighted_plain"),
    "K-W": ("bls_window", "window_scan", "window_scan_plain"),
    "K-U": ("bls_window", "window_scan_uniform",
            "window_scan_uniform_plain"),
    "K-SF": ("bls_staged_fold", "staged_fold", "staged_fold_plain"),
    "K-PC": ("bls_curve", "curve_scan", "curve_scan_plain"),
}

#: seconds a rank waits in a collective before it fails, and the parent
#: for the ranks to finish, unless the caller gives ``timeout``
DEFAULT_TIMEOUT = 900.0
#: seconds the parent waits for the other ranks' reports once one failed,
#: before it stops them (they may be waiting for the failed one)
FAIL_GRACE = 5.0


def kernel_counters():
    """Each BLS kernel's wrapper (whose ``launches`` counts its launches)
    and plain version (whose ``calls`` counts its calls), by name."""
    import importlib
    out = {}
    for key, (mod, kern, plain) in KERNEL_COUNTERS.items():
        m = importlib.import_module(f"lightkurve_tpu_torch.ops.{mod}")
        out[key] = (getattr(m, kern), getattr(m, plain))
    return out


def kernel_counts():
    """(launches, plain calls) of each kernel in this process, by name."""
    c = kernel_counters()
    return ({k: kern.launches for k, (kern, _) in c.items()},
            {k: plain.calls for k, (_, plain) in c.items()})


def reset_kernel_counts():
    """Set every launch and plain-call count of this process to 0."""
    for kern, plain in kernel_counters().values():
        kern.launches = 0
        plain.calls = 0


def _to_host(obj):
    """``obj`` with every tensor (in dicts, lists and tuples) as a numpy
    array, so it can leave the rank."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


# a rank function for the multi-rank tests: it lives here, not in a test
# module, because a spawned rank re-imports its target's module
def _call_all(calls):
    """Run ``calls`` in order on this rank: each ``(fn, args, kwargs,
    mesh_shape)``; a call with a ``mesh_shape`` (nt, ng) gets
    ``mesh=make_mesh(nt, ng)``.  Returns each call's result on the host
    (:func:`_to_host`)."""
    from .grid import make_mesh
    out = []
    for fn, args, kwargs, mesh_shape in calls:
        kwargs = dict(kwargs)
        if mesh_shape is not None:
            kwargs["mesh"] = make_mesh(*mesh_shape)
        out.append(_to_host(fn(*args, **kwargs)))
    return out


def _rank_main(rank, n_ranks, store, device_type, timeout, fn, args,
               results):
    """One rank: join the group, run ``fn(*args)``, report to ``results``
    (rank, ok, result or traceback, launches, plain calls)."""
    import torch.distributed as dist
    from .. import config
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n_ranks))
    config.default_device = device_type
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout))
        try:
            reset_kernel_counts()
            value = fn(*args)
            launches, calls = kernel_counts()
            results.put((rank, True, _to_host(value), launches, calls))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc(), None, None))
        raise


def run_ranks(n_ranks, fn, *args, device=None, timeout=DEFAULT_TIMEOUT):
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks of a gloo group on
    ``device`` (its type; default :data:`config.default_device`, which
    raises without CUDA).  ``fn`` must be importable by name from a module
    that imports no test module.

    Returns a list by rank of dicts: ``result`` (the return value, tensors
    as numpy arrays), ``launches`` and ``calls`` (each kernel's launches
    and plain calls over ``fn``).  Raises if any rank fails, with every
    failed rank's traceback; the others are then stopped."""
    import multiprocessing
    from ..config import resolve_device
    device_type = resolve_device(device).type
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    reports, failed = {}, {}
    with tempfile.TemporaryDirectory(prefix="lk-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, n_ranks, store, device_type, timeout, fn, args, results),
            daemon=True) for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            first_failure = None
            while len(reports) + len(failed) < n_ranks:
                now = time.monotonic()
                if now > deadline or (first_failure is not None
                                      and now > first_failure + FAIL_GRACE):
                    break
                try:
                    rank, ok, value, launches, calls = results.get(
                        timeout=0.5)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if (not p.is_alive() and r not in reports
                                and r not in failed):
                            # a rank that died without a report (a signal)
                            failed[r] = f"exited with code {p.exitcode}"
                    if failed and first_failure is None:
                        first_failure = time.monotonic()
                    continue
                if ok:
                    reports[rank] = dict(result=value, launches=launches,
                                         calls=calls)
                else:
                    failed[rank] = value
                    if first_failure is None:
                        first_failure = time.monotonic()
        finally:
            for p in procs:
                p.join(timeout=FAIL_GRACE if not failed else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join()
            results.close()
    missing = [r for r in range(n_ranks) if r not in reports]
    if failed or missing:
        detail = "\n".join(f"--- rank {r} ---\n{failed.get(r, 'no report')}"
                           for r in missing)
        raise RuntimeError(f"{len(missing)} of {n_ranks} ranks failed:\n"
                           f"{detail}")
    return [reports[r] for r in range(n_ranks)]
